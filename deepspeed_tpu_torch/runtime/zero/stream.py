"""Streamed ZeRO-3 parameter offload: train a model larger than the
card's memory on one card.

Port of ``deepspeed_tpu/runtime/zero/stream.py::StreamedOffloadRunner``
and of the part of ``deepspeed_tpu/runtime/executor/stream.py`` it runs
on (``run_streamed_micro``, ``run_streamed_apply``, ``_slot_adam``);
reference: ZeRO-3 Offload's parameter offload
(``deepspeed/runtime/zero/stage3.py:2281``,
``partition_parameters.py:341``). The general segment executor is not
ported: the interleave is written here with CUDA streams and events.

* The fp32 master, the Adam moments, the compute-dtype parameters and the
  fp32 gradient accumulator live in HOST memory (``FlatPartition`` with
  ``streamed``: classic offload's whole layout at one rank, so every
  checkpoint path works unchanged); the parameters are pinned.
* No parameter has a resident device copy. Each micro-step uploads them
  one LAYER GROUP at a time (``transfer.H2DBatcher``, buckets of whole
  leaves) on a side stream, double-buffered: group k+1's upload rides
  the copy engine while group k computes. The compute stream waits on
  the upload's event, and the buffer is recorded on the compute stream,
  so the allocator reuses it only after the compute that reads it; the
  host waits for group k-1's compute before it allocates group k+1, so
  about two groups of parameters are live.
* The forward runs segment by segment (embed -> block groups -> head)
  without autograd, keeping only the group-boundary activations; the
  head runs under autograd and gives the loss and its input's gradient;
  the backward re-uploads each group in reverse (the last group's upload
  is kept from the forward) and recomputes its forward under autograd
  (the streaming analogue of activation checkpointing), then the
  embedding.
* Each segment's gradients leave the device as ONE packed fp32 buffer
  ``[grads..., finite, sumsq]`` (async D2H on a second side stream into
  one of two pinned staging buffers), and are added into the host
  accumulator's per-leaf ranges in the JAX plan's order (head, groups in
  reverse, embed); the tied ``wte`` sums both contributions. A staging
  buffer is reused only after its copy's event has completed and it has
  been added.
* The apply step is the host Adam (``ops/adam/cpu_adam.py`` over
  ``csrc/cpu_adam.cpp``), chunked by ``sub_group_size``, with classic
  offload's overflow skip; it writes the updated bf16 parameters straight
  into the pinned host copy.

The norm: the JAX runner takes the sum of the segments' device sums of
squares when one micro-step made the gradients and no leaf is shared,
else it recomputes every slot's squares over the host buffers in
float64. The port takes the device sums over the unshared leaves always,
and over the host buffers (float64) only the shared leaves' squares (one
micro-step) or every leaf's (more): the same terms, summed in another
order.

Device memory: about two layer groups of parameters (current and
prefetched; ``stage3_max_live_parameters`` sizes the groups,
:func:`plan_groups`) + the larger of the embed and head segments + the
boundary activations + one group's recompute + one segment's packed
gradients, whatever the model's size.
"""
import math
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from ...ops.adam.cpu_adam import cpu_adam
from ...ops.adam.fused_adam import bias_corrections, f32
from ...utils.logging import log_dist, logger
from .partition import _numel, _padded
from .transfer import H2DBatcher, flat_chunks

STAGING_SLOTS = 2               # pinned gradient staging buffers
APPLY_CHUNK = 1 << 26           # host Adam work chunk cap (elements)
NORM_CHUNK = 1 << 24            # host float64 norm chunk (elements)


def _processes():
    return dist.get_world_size() if dist.is_initialized() else 1


def plan_groups(block_elems, terminal, budget):
    """The JAX runner's ``_plan_groups`` (a copy): layer groups
    ``[(start, stop), ...]`` sized so ~2 groups (live + prefetched) plus
    the larger terminal segment fit ``budget`` elements (None: 1e9)."""
    if budget is None:
        budget = 10 ** 9
    per_group = max((budget - terminal) // 2, 1)
    groups, start, acc = [], 0, 0
    for i, n in enumerate(block_elems):
        if i > start and acc + n > per_group:
            groups.append((start, i))
            start, acc = i, 0
        acc += n
    groups.append((start, len(block_elems)))
    return groups


class _Segment:
    """One streamed segment's leaves in the flat layout: the ranges it
    uploads (and whose gradients it packs), each leaf's place in the
    segment's device buffer, and which of its leaves another segment
    shares."""

    def __init__(self, flat, trees, shared):
        index = {name: i for i, name in enumerate(flat.names)}
        order = []
        for tree in trees:
            order += [name for name in tree.values() if name not in order]
        extents = sorted((flat.offsets[index[n]],
                          flat.offsets[index[n]] +
                          _padded(_numel(flat.shapes[index[n]])))
                         for n in order)
        merged = []
        for a, b in extents:
            if merged and merged[-1][1] == a:
                merged[-1][1] = b
            else:
                merged.append([a, b])
        self.ranges, at = [], 0         # (layout lo, hi, buffer offset)
        for a, b in merged:
            self.ranges.append((a, b, at))
            at += b - a
        self.total = at

        def where(name):
            off = flat.offsets[index[name]]
            for lo, hi, d in self.ranges:
                if lo <= off < hi:
                    return d + off - lo
            raise KeyError(name)

        self.place = {name: (where(name), flat.shapes[index[name]])
                      for name in order}
        self.names = order
        self.trees = trees
        self.numel = sum(_numel(flat.shapes[index[n]]) for n in order)
        self.unshared = [(self.place[n][0], self.place[n][0] +
                          _numel(self.place[n][1]))
                         for n in order if n not in shared]

    def views(self, buf, leaf=False):
        """Per tree, ``{key: view of buf}``; with ``leaf`` each view a
        fresh autograd leaf. Also the views in ``names`` order."""
        made = {}
        for name in self.names:
            off, shape = self.place[name]
            t = buf[off:off + _numel(shape)].view(shape)
            made[name] = t.detach().requires_grad_() if leaf else t
        return ([{k: made[n] for k, n in tree.items()} for tree in
                 self.trees], [made[n] for n in self.names])


class StreamedOffloadRunner:
    """Drives the streamed train and eval steps for one engine (the
    engine's ``stream_runner``). The host state is the engine's
    ``FlatPartition`` (``flat.master`` / ``exp_avg`` / ``exp_avg_sq``,
    ``params`` pinned, ``acc``); a checkpoint load replaces their values
    in place, so nothing needs rebinding."""

    def __init__(self, engine):
        self.engine = engine
        module = engine.module
        self.spec = getattr(module, "stream_spec", None)
        if self.spec is None:
            raise ValueError(
                "zero_optimization.cpu_offload_params needs a model with "
                "a stream_spec (runtime/model.py StreamSpec); {} does "
                "not expose one".format(type(module).__name__))
        if _processes() > 1:
            raise NotImplementedError(
                "streamed parameter offload is single-process (multi-"
                "process runs keep classic cpu_offload)")
        self.flat = flat = engine.flat
        self.device = engine.device
        self.cdtype = engine.compute_dtype
        self.cuda = self.device.type == "cuda"
        self.phase_times = {}
        self._micro_finites, self._micro_sumsqs = [], []
        self._micros_in_step = 0
        self._step_upload_batches = 0
        self._step_upload_elems = 0
        self._segment_upload_bytes_peak = 0
        zc = engine._config.zero_config
        self.bucket_elems = int(zc.prefetch_bucket_size)
        self.sub_group_size = int(zc.sub_group_size)
        self.budget = zc.max_live_parameters
        self._batcher = H2DBatcher(self.bucket_elems, flat.offsets)
        embed, blocks, head = self.spec.split({n: n for n in flat.names})
        seen = {}
        for tree in [embed, head] + blocks:
            for name in set(tree.values()):
                seen[name] = seen.get(name, 0) + 1
        self.shared = {n for n, k in seen.items() if k > 1}
        self.n_layers = len(blocks)
        self._blocks = blocks
        self.embed = _Segment(flat, [embed], self.shared)
        self.head = _Segment(flat, [head], self.shared)
        index = {name: i for i, name in enumerate(flat.names)}
        block_elems = [sum(_numel(flat.shapes[index[n]])
                           for n in set(b.values())) for b in blocks]
        terminal = max(self.embed.numel, self.head.numel)
        self.groups = plan_groups(block_elems, terminal, self.budget)
        self.segments = [_Segment(flat, blocks[a:b], self.shared)
                         for a, b in self.groups]
        budget = 10 ** 9 if self.budget is None else self.budget
        min_live = 2 * max(block_elems or [0]) + terminal
        if budget < min_live:
            logger.warning(
                "stage3_max_live_parameters=%d is below the streamed "
                "minimum for this model (~%d: two 1-layer groups + the "
                "largest terminal segment); streaming proceeds at that "
                "minimum", budget, min_live)
        log_dist("streamed offload: {} layers in {} groups (budget {:,} "
                 "elements, terminal {:,})".format(
                     self.n_layers, len(self.groups), budget, terminal),
                 ranks=[0])
        self._shared_ranges = flat.owned_ranges(
            sorted(index[n] for n in self.shared))
        biggest = max([self.embed.total, self.head.total] +
                      [seg.total for seg in self.segments])
        pin = self.cuda
        self._staging = [torch.empty(biggest + 2, dtype=torch.float32,
                                     pin_memory=pin)
                         for _ in range(STAGING_SLOTS)]
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)
        self._fetches = deque()
        self._slot = 0
        self._done = []         # compute-done events, in issue order
        self._events = []       # (phase key, start, end) device timings

    # ------------------------------------------------------------ timing
    def _bill(self, key, seconds):
        self.phase_times[key] = self.phase_times.get(key, 0.0) + seconds

    def _mark(self, stream=None):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream if stream is not None else
                  torch.cuda.current_stream(self.device))
        return ev

    def _span(self, key, start, end):
        if self.cuda:
            self._events.append((key, start, end))
        else:
            self._bill(key, end - start)

    def _settle_events(self):
        """Bill the device spans of the finished step (every event has
        completed: the caller synchronised)."""
        for key, start, end in self._events:
            self._bill(key, start.elapsed_time(end) / 1e3)
        self._events = []

    # ----------------------------------------------------------- uploads
    def _throttle(self):
        """Wait for the compute before the last one issued, so its
        parameters' buffer is free before another is allocated."""
        if self.cuda and len(self._done) >= 2:
            t0 = time.perf_counter()
            self._done[-2].synchronize()
            self._bill("h2d_wait_s", time.perf_counter() - t0)

    def _upload(self, seg):
        """Queue ``seg``'s parameters for upload into a new device buffer
        (on the upload stream when on CUDA); returns the pending upload."""
        host = self.flat.params
        before = self._batcher.batches
        if self.cuda:
            # the buffer is the upload stream's: the allocator hands it out
            # only once every stream recorded on it is past its last use
            with torch.cuda.stream(self.h2d):
                buf = torch.empty(seg.total, dtype=self.cdtype,
                                  device=self.device)
                start = self._mark(self.h2d)
                for lo, hi, d in seg.ranges:
                    self._batcher.upload(buf, host[lo:hi], lo, hi,
                                         base=lo - d)
                end = self._mark(self.h2d)
            self._span("h2d_s", start, end)
            ready = end
        else:
            t0 = time.perf_counter()
            buf = torch.empty(seg.total, dtype=self.cdtype,
                              device=self.device)
            for lo, hi, d in seg.ranges:
                self._batcher.upload(buf, host[lo:hi], lo, hi, base=lo - d)
            self._bill("h2d_s", time.perf_counter() - t0)
            ready = None
        self._step_upload_batches += self._batcher.batches - before
        self._step_upload_elems += seg.total
        self._segment_upload_bytes_peak = max(
            self._segment_upload_bytes_peak,
            seg.total * self.flat.params.element_size())
        return buf, ready

    def _ready(self, pending):
        """The uploaded buffer, safe to read on the compute stream."""
        buf, ready = pending
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            buf.record_stream(stream)
        return buf

    def _compute(self, key, fn):
        start = self._mark()
        out = fn()
        end = self._mark()
        self._span(key, start, end)
        if self.cuda:
            self._done.append(end)
        return out

    # --------------------------------------------------------- gradients
    def _pack(self, seg, grads, inv_scale):
        """One fp32 device buffer ``[grads..., finite, sumsq]`` (padding
        zero; sumsq over the unshared leaves, unscaled)."""
        packed = torch.zeros(seg.total + 2, dtype=torch.float32,
                             device=self.device)
        for name, g in zip(seg.names, grads):
            if g is not None:
                off, shape = seg.place[name]
                packed[off:off + _numel(shape)].copy_(g.reshape(-1))
        body = packed[:seg.total]
        packed[seg.total] = torch.isfinite(body).all().float()
        sumsq = torch.zeros((), dtype=torch.float32, device=self.device)
        for a, b in seg.unshared:
            g32 = body[a:b] * f32(inv_scale)
            sumsq = sumsq + (g32 * g32).sum()
        packed[seg.total + 1] = sumsq
        return packed

    def _fetch(self, seg, packed):
        """Queue the packed gradients' copy to a pinned staging buffer;
        the oldest fetch is added first when both buffers are taken."""
        if len(self._fetches) == STAGING_SLOTS:
            self._resolve_one()
        staging = self._staging[self._slot]
        self._slot = (self._slot + 1) % STAGING_SLOTS
        dst = staging[:seg.total + 2]
        if self.cuda:
            self.d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.d2h):
                start = self._mark(self.d2h)
                dst.copy_(packed, non_blocking=True)
                end = self._mark(self.d2h)
            packed.record_stream(self.d2h)
            self._span("d2h_grads_s", start, end)
        else:
            t0 = time.perf_counter()
            dst.copy_(packed)
            self._bill("d2h_grads_s", time.perf_counter() - t0)
            end = None
        self._fetches.append((seg, dst, end))

    def _resolve_one(self):
        seg, dst, end = self._fetches.popleft()
        t0 = time.perf_counter()
        if end is not None:
            end.synchronize()
        t1 = time.perf_counter()
        acc = self.flat.acc
        for lo, hi, d in seg.ranges:
            acc[lo:hi].add_(dst[d:d + hi - lo])
        self._finite = self._finite and bool(dst[seg.total] > 0.5)
        self._sumsq += float(dst[seg.total + 1])
        self._bill("d2h_wait_s", t1 - t0)
        self._bill("host_accumulate_s", time.perf_counter() - t1)

    def _resolve_all(self):
        while self._fetches:
            self._resolve_one()

    # -------------------------------------------------------- segments
    def _embed_out(self, buf, batch, train):
        (tree,), _ = self.embed.views(buf)
        return self.spec.embed_apply(tree, batch, None, train)

    def _group_out(self, g, buf, x, seeds, train, leaf=False):
        trees, leaves = self.segments[g].views(buf, leaf=leaf)
        start, _ = self.groups[g]
        for i, tree in enumerate(trees):
            x = self.spec.block_apply(
                tree, x, seeds[start + i] if seeds else None, train)
        return x, leaves

    def _head_grad(self, buf, x, batch, scale, inv_scale, train):
        (tree,), leaves = self.head.views(buf, leaf=True)
        xi = x.detach().requires_grad_()
        with torch.enable_grad():
            loss = self.spec.head_apply(tree, xi, batch, None, train)
            grads = torch.autograd.grad(loss.float() * scale, [xi] + leaves,
                                        allow_unused=True)
        return loss.detach(), grads[0], self._pack(self.head, grads[1:],
                                                   inv_scale)

    def _group_grad(self, g, buf, x_in, dx, seeds, inv_scale, train):
        xi = x_in.detach().requires_grad_()
        with torch.enable_grad():
            y, leaves = self._group_out(g, buf, xi, seeds, train, leaf=True)
            grads = torch.autograd.grad(y, [xi] + leaves, dx,
                                        allow_unused=True)
        return grads[0], self._pack(self.segments[g], grads[1:], inv_scale)

    def _embed_grad(self, buf, batch, dx, inv_scale, train):
        (tree,), leaves = self.embed.views(buf, leaf=True)
        with torch.enable_grad():
            x = self.spec.embed_apply(tree, batch, None, train)
            grads = torch.autograd.grad(x, leaves, dx, allow_unused=True)
        return self._pack(self.embed, grads, inv_scale)

    # -------------------------------------------------------------- steps
    def layer_seeds(self, generator):
        """The layers' dropout seeds of one micro-step, drawn from
        ``generator`` as the model's training forward draws them (None
        without dropout)."""
        config = getattr(self.engine.module, "config", None)
        if generator is None or getattr(config, "dropout", 0.0) <= 0.0:
            return None
        return torch.randint(0, 2 ** 62, (self.n_layers,),
                             generator=generator).tolist()

    def micro_step(self, batch, seeds=None, train=True):
        """One streamed micro-step: forward + backward with the gradients
        added into the host accumulator. ``seeds``: the layers' dropout
        seeds (or None). Returns the (unscaled) loss, a device scalar."""
        eng = self.engine
        scale = float(eng.scaler.cur_scale) / eng.gradient_accumulation_steps()
        inv_scale = 1.0 / float(eng.scaler.cur_scale)
        G = len(self.groups)
        segs = self.segments
        self._finite, self._sumsq = True, 0.0
        self._done = []
        with torch.no_grad():
            pending = self._upload(self.embed)
            buf = self._ready(pending)
            pending = self._upload(segs[0] if G else self.head)
            x = self._compute("compute_fwd_s", lambda: self._embed_out(
                buf, batch, train))
            acts, kept = [x], None
            for g in range(G):
                buf = self._ready(pending)
                x = self._compute("compute_fwd_s", lambda: self._group_out(
                    g, buf, acts[-1], seeds, train)[0])
                acts.append(x)
                if g == G - 1:
                    kept = buf
                self._throttle()
                pending = self._upload(segs[g + 1] if g + 1 < G
                                       else self.head)
            buf = self._ready(pending)
            loss, dx, packed = self._compute(
                "compute_bwd_s", lambda: self._head_grad(
                    buf, acts[G], batch, scale, inv_scale, train))
            self._throttle()
            pending = self._upload(segs[G - 2] if G >= 2 else self.embed)
            self._fetch(self.head, packed)
            for g in reversed(range(G)):
                if g == G - 1:
                    buf, kept = kept, None
                else:
                    buf = self._ready(pending)
                dx, packed = self._compute(
                    "compute_bwd_s", lambda: self._group_grad(
                        g, buf, acts[g], dx, seeds, inv_scale, train))
                acts[g + 1] = None
                if g < G - 1:
                    self._throttle()
                    pending = self._upload(segs[g - 1] if g >= 1
                                           else self.embed)
                self._fetch(segs[g], packed)
            buf = self._ready(pending)
            packed = self._compute("compute_bwd_s", lambda: self._embed_grad(
                buf, batch, dx, inv_scale, train))
            del buf, acts
            self._fetch(self.embed, packed)
            self._resolve_all()
        self._settle_events()
        self._micro_finites.append(self._finite)
        self._micro_sumsqs.append(self._sumsq)
        self._micros_in_step += 1
        return loss

    def _host_sumsq(self, ranges, inv_scale):
        """The float64 sum of squares of ``acc * inv_scale`` over
        ``ranges`` of the host accumulator, in chunks (not finite when
        any element is not)."""
        acc, total = self.flat.acc, 0.0
        for a, b in ranges:
            for lo in range(a, b, NORM_CHUNK):
                part = acc[lo:min(lo + NORM_CHUNK, b)].double()
                total += float(torch.dot(part, part))
        return total * inv_scale * inv_scale

    def apply_step(self):
        """The host Adam over the accumulated gradients, chunked by
        ``sub_group_size``, with classic offload's overflow skip. Returns
        the metrics dict; the caller updates the loss scaler."""
        eng, flat = self.engine, self.flat
        if self.cuda:
            # no upload of the host parameters is still in flight
            self.h2d.synchronize()
        cur_scale = float(eng.scaler.cur_scale)
        inv_scale = 1.0 / cur_scale
        clip = eng.gradient_clipping()
        finite = all(self._micro_finites) if self._micro_finites else False
        t0 = time.perf_counter()
        if finite and self._micros_in_step == 1:
            # the unshared leaves' sums came with the gradients
            sumsq = sum(self._micro_sumsqs) + \
                self._host_sumsq(self._shared_ranges, inv_scale)
        elif finite:
            sumsq = self._host_sumsq([(0, flat.numel)], inv_scale)
        else:
            sumsq = float("nan")
        self._bill("host_norm_s", time.perf_counter() - t0)
        overflow = (not finite) or not math.isfinite(sumsq)
        grad_norm = 0.0
        if not overflow:
            grad_norm = float(np.sqrt(sumsq))
            coef = inv_scale
            if clip > 0 and grad_norm > clip:
                coef *= clip / (grad_norm + 1e-6)
            flat.step += 1
            opt = eng.optimizer
            h = {k: f32(v) for k, v in opt.hyperparams().items()}
            bc1, bc2 = bias_corrections(
                h["beta1"], h["beta2"], flat.step,
                getattr(opt, "bias_correction", True))
            fused = flat.compute_dtype == torch.bfloat16
            adam_w = getattr(opt, "adam_w_mode", True)
            t0 = time.perf_counter()
            for a, b in flat_chunks(flat.numel, self.sub_group_size,
                                    APPLY_CHUNK):
                g = flat.acc[a:b]
                g.mul_(f32(coef))
                cpu_adam(flat.master[a:b], g, flat.exp_avg[a:b],
                         flat.exp_avg_sq[a:b],
                         p_bf16=flat.params[a:b] if fused else None,
                         bc1=bc1, bc2=bc2, adam_w_mode=adam_w, **h)
                if not fused:
                    flat.params[a:b].copy_(flat.master[a:b])
            self._bill("host_adam_s", time.perf_counter() - t0)
        self.zero_grads()
        return {"overflow": overflow, "grad_norm": grad_norm,
                "loss_scale": cur_scale}

    def zero_grads(self):
        self.flat.acc.zero_()
        self._micro_finites, self._micro_sumsqs = [], []
        self._micros_in_step = 0

    def eval_loss(self, batch):
        """The streamed forward-only loss (dropout off). The phase clocks
        and the upload counters are left as they were: an eval between
        optimizer steps does not leak into the next step's."""
        saved = (dict(self.phase_times), self._step_upload_batches,
                 self._step_upload_elems, self._segment_upload_bytes_peak)
        try:
            return self._eval_loss(batch)
        finally:
            (self.phase_times, self._step_upload_batches,
             self._step_upload_elems,
             self._segment_upload_bytes_peak) = saved
            self._events = []

    def _eval_loss(self, batch):
        G = len(self.groups)
        self._done = []
        with torch.no_grad():
            buf = self._ready(self._upload(self.embed))
            pending = self._upload(self.segments[0] if G else self.head)
            x = self._compute("compute_fwd_s", lambda: self._embed_out(
                buf, batch, False))
            for g in range(G):
                buf = self._ready(pending)
                x = self._compute("compute_fwd_s", lambda: self._group_out(
                    g, buf, x, None, False)[0])
                self._throttle()
                pending = self._upload(self.segments[g + 1] if g + 1 < G
                                       else self.head)
            buf = self._ready(pending)
            (tree,), _ = self.head.views(buf)
            return self.spec.head_apply(tree, x, batch, None, False)

    # ---------------------------------------------------------- telemetry
    def transfer_snapshot(self):
        """Per-step upload and overlap stats (the JAX runner's keys; the
        general executor's ``plan_segments`` / ``per_kind`` are 0 and
        empty here). Read-only: :meth:`reset_step_counters` opens the next
        window."""
        phases = getattr(self.engine, "offload_phase_times", None) or {}
        compute = sum(phases.get(k, 0.0) for k in
                      ("compute_fwd_s", "compute_bwd_s", "host_adam_s"))
        waits = sum(phases.get(k, 0.0) for k in
                    ("h2d_wait_s", "d2h_wait_s"))
        batches = self._step_upload_batches
        bucket = self.bucket_elems
        return {
            "plan_segments": 0, "per_kind": {},
            "upload_batches": batches,
            "upload_elems": self._step_upload_elems,
            "upload_bytes": self._step_upload_elems *
            self.flat.params.element_size(),
            "segment_upload_bytes_peak": self._segment_upload_bytes_peak,
            "bucket_elems": bucket,
            "bucket_occupancy": round(
                self._step_upload_elems / (batches * bucket), 4)
            if batches and bucket else None,
            "overlap_efficiency": round(compute / (compute + waits), 4)
            if (compute + waits) > 0 else None,
            "groups": len(self.groups),
            # one process: no tensor-parallel binding under streaming
            "collective_matmul": False,
        }

    def reset_step_counters(self):
        self._step_upload_batches = 0
        self._step_upload_elems = 0
        self._segment_upload_bytes_peak = 0
