"""Wall-clock timers that fence outstanding device work.

Port of ``deepspeed_tpu/utils/timer.py::SynchronizedWallClockTimer``:
PyTorch launches CUDA work asynchronously, so every start/stop calls
``torch.cuda.synchronize()`` on the timer's CUDA device before reading
the host clock. A timer bound to the CPU has nothing to fence.
"""
import time

import torch


def _device_synchronize(device):
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timers whose start/stop sync outstanding device work on
    ``device`` (a ``torch.device``; None or a CPU device = no fence)."""

    class Timer:
        def __init__(self, name, device=None):
            self.name_ = name
            self.device = device
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.time()

        def start(self):
            assert not self.started_, "timer has already been started"
            _device_synchronize(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False):
            assert self.started_, "timer is not started"
            _device_synchronize(self.device)
            if reset:
                self.elapsed_ = time.time() - self.start_time
            else:
                self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]
