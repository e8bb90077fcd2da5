"""Wall-clock timers that fence outstanding device work.

Port of ``deepspeed_tpu/utils/timer.py`` (``SynchronizedWallClockTimer``,
``ThroughputTimer``): PyTorch launches CUDA work asynchronously, so every
start/stop calls ``torch.cuda.synchronize()`` on the timer's CUDA device
before reading the host clock. A timer bound to the CPU has nothing to
fence.
"""
import time

import torch

from .logging import logger


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

    @staticmethod
    def memory_usage(device=None):
        """``"mem (GB) | allocated: a | peak: b"`` of a CUDA device (the
        current one by default); "unavailable" without CUDA."""
        if not torch.cuda.is_available():
            return "mem (GB) | unavailable"
        alloc = torch.cuda.memory_allocated(device) / 1024 ** 3
        peak = torch.cuda.max_memory_allocated(device) / 1024 ** 3
        return "mem (GB) | allocated: {:.2f} | peak: {:.2f}".format(alloc,
                                                                   peak)


class ThroughputTimer:
    """Samples/sec tracker around train steps (the JAX package's
    ``ThroughputTimer``, reference timer.py:97): from step ``start_step``
    on, ``start``/``stop`` fence ``device``'s work and add the step's wall
    time; every ``steps_per_output`` steps it logs the rate."""

    def __init__(self, batch_size, num_workers, start_step=2,
                 steps_per_output=50, monitor_memory=False, logging_fn=None,
                 device=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = batch_size if batch_size else 1
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False
        self.device = None if device is None else torch.device(device)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.total_step_count >= self.start_step:
            _device_synchronize(self.device)
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count > self.start_step:
            _device_synchronize(self.device)
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if self.local_step_count % self.steps_per_output == 0:
                if report_speed:
                    self.logging(
                        "{}/{}, SamplesPerSec={}".format(
                            self.epoch_count, self.local_step_count,
                            self.avg_samples_per_sec()))
                if self.monitor_memory:
                    self.logging(SynchronizedWallClockTimer.memory_usage(
                        self.device))

    def avg_samples_per_sec(self):
        if self.total_step_count > self.start_step:
            samples_per_step = self.batch_size * self.num_workers
            total_step_offset = self.total_step_count - self.start_step
            avg_time_per_step = self.total_elapsed_time / total_step_offset
            return samples_per_step / avg_time_per_step
        return float("-inf")
