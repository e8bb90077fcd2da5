"""The ZeRO-Offload optimizer step: the host Adam over the fp32 master and
moments in host memory, the gradients down and the compute-dtype weights
up in chunks.

Port of the JAX package's classic offload step
(``deepspeed_tpu/runtime/executor/offload.py:37-147``, ``run_offload_apply``;
the segment executor it runs on is not ported). The engine does the
device part first, as the device-state step does: the overflow flag and
the sum of squares over the data group, the unscale and the clip, on the
owned part of the fp32 accumulator. :meth:`HostOffload.step` then runs,
for each work chunk of at most ``min(sub_group_size, OFFLOAD_CHUNK)``
elements (``transfer.flat_chunks``):

1. the chunk of gradients device to host, into a pinned staging buffer,
   on a side CUDA stream;
2. the host Adam (``ops/adam/cpu_adam.py``, ``csrc/cpu_adam.cpp``) over
   the chunk of the master and moments; the fused variant writes the
   updated weights in bf16 into a second pinned staging buffer (fp16 is
   rounded by torch);
3. the weights host to device into the rank's compute-dtype parameters,
   in ``stage3_prefetch_bucket_size`` buckets of whole leaves
   (``transfer.H2DBatcher``), on another side stream.

With ``overlap`` the copies run ahead of and behind the host Adam in a
window of :data:`WINDOW` chunks (a chunk's gradients land while the one
before it is stepped; its weights go up while the next one is); without,
each chunk's copies and Adam run one after another. Every chunk is
elementwise on disjoint ranges, so both orders, and any chunk size, give
the same bits. The engine then all-gathers the updated pieces below
stage 3 (``FlatPartition.gather_params``); at stage 3 only the persistent
unit is gathered.

Only the staging buffers are pinned (``2 * WINDOW`` chunks); the master
and moments, 12 bytes an element of the owned part, stay pageable.
"""
import time
from contextlib import nullcontext

import torch

from ...ops.adam.cpu_adam import cpu_adam, threads_for, usable_cores
from ...ops.adam.fused_adam import bias_corrections, f32
from .transfer import H2DBatcher, flat_chunks, staging

OFFLOAD_CHUNK = 1 << 26         # elements: 256 MB of fp32 gradients
WINDOW = 2                      # chunks in flight each way


class HostOffload:
    """The host step over one ``FlatPartition`` whose master and moments
    live in host memory (``offload=True``)."""

    def __init__(self, flat, sub_group_size, bucket_elems, overlap=True,
                 host_ranks=1):
        if flat.compute_dtype not in (torch.bfloat16, torch.float16):
            raise ValueError("cpu_offload needs bf16 or fp16 compute, got "
                             "{}".format(flat.compute_dtype))
        self.flat = flat
        self.overlap = overlap
        self.chunks = flat_chunks(flat.part_numel, sub_group_size,
                                  OFFLOAD_CHUNK)
        self.cuts = [int(off) for off, n in flat.segments.tolist() if n]
        self.bucket_elems = int(bucket_elems)
        self.work_chunks = len(self.chunks)
        self.h2d_batches = 0
        self.torn_step = None
        self.last_times = {}
        self._stage = None
        # the ranks that share this host split its cores between them
        self.host_ranks = max(1, int(host_ranks))

    def threads(self, n):
        """The host Adam's pool threads for a chunk of ``n`` elements."""
        k = threads_for(n)
        return k if self.host_ranks == 1 else \
            max(1, min(k, usable_cores() // self.host_ranks))

    def host_bytes(self):
        """Bytes of host memory the master and moments take, and the
        pinned staging."""
        flat = self.flat
        state = sum(t.numel() * t.element_size()
                    for t in (flat.master, flat.exp_avg, flat.exp_avg_sq))
        size = max(b - a for a, b in self.chunks) if self.chunks else 0
        pinned = WINDOW * size * (4 + flat.params.element_size())
        return {"master_and_moments": state, "pinned_staging": pinned}

    def _buffers(self):
        if self._stage is None:
            flat = self.flat
            size = max(b - a for a, b in self.chunks)
            self._stage = (
                [staging(size, torch.float32, flat.device)
                 for _ in range(WINDOW)],
                [staging(size, flat.compute_dtype, flat.device)
                 for _ in range(WINDOW)])
        return self._stage

    def step(self, grads, hyper, step, bias_correction=True,
             adam_w_mode=True):
        """Adam step ``step`` (the count after it) of the host master and
        moments from ``grads`` (the owned part of the accumulator, fp32,
        on the device, already unscaled and clipped); the updated weights
        land in the owned part of the compute-dtype parameters. ``hyper``
        holds lr, beta1, beta2, eps and weight_decay."""
        flat = self.flat
        h = {k: f32(v) for k, v in hyper.items()}
        bc1, bc2 = bias_corrections(h["beta1"], h["beta2"], step,
                                    bias_correction)
        g_stage, p_stage = self._buffers()
        fused = flat.compute_dtype == torch.bfloat16
        dst = flat.own_params()
        cuda = flat.device.type == "cuda"
        d2h = torch.cuda.Stream(flat.device) if cuda else None
        h2d = torch.cuda.Stream(flat.device) if cuda else None
        if cuda:
            # the gradients are final on the compute stream
            d2h.wait_stream(torch.cuda.current_stream(flat.device))
        got = [None] * WINDOW           # D2H done events, per slot
        sent = [None] * WINDOW          # H2D done events, per slot
        batcher = H2DBatcher(self.bucket_elems, self.cuts)
        times = {"d2h_wait_ms": 0.0, "adam_ms": 0.0, "h2d_ms": 0.0}
        t_start = time.perf_counter()

        def fetch(j):
            a, b = self.chunks[j]
            slot = j % WINDOW
            with torch.cuda.stream(d2h) if cuda else nullcontext():
                g_stage[slot][:b - a].copy_(grads[a:b], non_blocking=cuda)
                if cuda:
                    got[slot] = torch.cuda.Event()
                    got[slot].record(d2h)

        def wait(events, slot, key):
            if events[slot] is not None:
                t0 = time.perf_counter()
                events[slot].synchronize()
                times[key] += 1e3 * (time.perf_counter() - t0)
                events[slot] = None

        self.torn_step = step
        n = len(self.chunks)
        ahead = WINDOW if self.overlap else 1
        for j in range(min(ahead, n)):
            fetch(j)
        for j, (a, b) in enumerate(self.chunks):
            slot = j % WINDOW
            wait(got, slot, "d2h_wait_ms")
            wait(sent, slot, "h2d_ms")          # the staging is free again
            t0 = time.perf_counter()
            p16 = p_stage[slot][:b - a]
            cpu_adam(flat.master[a:b], g_stage[slot][:b - a],
                     flat.exp_avg[a:b], flat.exp_avg_sq[a:b],
                     p_bf16=p16 if fused else None, bc1=bc1, bc2=bc2,
                     adam_w_mode=adam_w_mode, threads=self.threads(b - a),
                     **h)
            if not fused:
                p16.copy_(flat.master[a:b])
            times["adam_ms"] += 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            with torch.cuda.stream(h2d) if cuda else nullcontext():
                batcher.upload(dst, p16, a, b)
                if cuda:
                    sent[slot] = torch.cuda.Event()
                    sent[slot].record(h2d)
            times["h2d_ms"] += 1e3 * (time.perf_counter() - t0)
            if not self.overlap:
                wait(sent, slot, "h2d_ms")
            if j + ahead < n:
                fetch(j + ahead)
        for slot in range(WINDOW):
            wait(sent, slot, "h2d_ms")
        if cuda:
            torch.cuda.current_stream(flat.device).wait_stream(h2d)
        self.torn_step = None
        times["host_step_ms"] = 1e3 * (time.perf_counter() - t_start)
        self.last_times = times
        self.h2d_batches = batcher.batches

