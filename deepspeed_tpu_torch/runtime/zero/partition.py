"""ZeRO stages 0-2 as flat-buffer partitions.

Port of ``deepspeed_tpu/runtime/zero/partition.py::ZeroShardingPlan``,
re-expressed for PyTorch. The JAX package shards each leaf of the train
state over the mesh's ``data`` axis (stage 1: master + optimizer state;
stage 2: + gradients). Here the state is a few flat buffers:

* one fp32 master buffer, the gradient accumulator (fp32, or bf16 with
  ``data_types.grad_accum_dtype``) and the optimizer moments
  (``exp_avg`` / ``exp_avg_sq``, Adam's, LAMB's or SGD's; fp32, or bf16
  with ``optimizer.params.moments_dtype``, as the JAX package's
  ``adam_init`` stores them): the optimizer works on each whole, with one
  kernel launch (Adam) or one per pass (LAMB's stage 1 and apply);
* the compute-dtype parameters: one flat buffer of which every
  ``nn.Parameter`` of the module is a view (at fp32 compute and a whole
  master it is the master buffer itself);
* the compute-dtype gradients: one flat buffer of which every
  parameter's ``.grad`` is a view, so autograd accumulates into it in
  place (a tied weight sums both uses there) and one ``add_`` (or one
  reduce-scatter) folds a micro-step into the accumulator.

Each parameter starts at a multiple of :data:`ALIGN` elements (padding
stays zero in every buffer: Adam and LAMB map p = g = m = v = 0 to zeros,
so padding adds nothing to a LAMB norm either).

Data parallelism over a ``group`` of ``dp_world`` ranks: the buffers'
length is padded to a multiple of ``dp_world * ALIGN`` and rank r owns
``[lo, hi) = [r * P, (r + 1) * P)``, P = numel / dp_world. From stage 1 the
master and both moments hold only the owned range; from stage 2 the
accumulator too (the engine reduce-scatters each micro-step's gradients
into it). The compute-dtype ``params`` and ``grads`` stay whole: the
forward reads every parameter and autograd writes every gradient.
:meth:`refresh_params` all-gathers the updated owned ranges into
``params`` (the reference's stage-1/2 parameter all-gather,
``stage1.py:624-708``). At stage 0, or one rank, the owned range is the
whole buffer and nothing is gathered.

``segments`` is the segment table of the owned range, one ``(offset,
numel)`` per parameter (per JAX leaf), offsets relative to ``lo`` and
each parameter clipped to the range (0 elements where the rank holds
none of it), so entry i names the same leaf on every rank: LAMB takes one
trust ratio per segment from its sums over the data group.

Under tensor parallelism each rank's module holds its own shards, and each
rank keeps one such set of buffers over them. The parameters every rank
holds whole (``replicated``: layer norms, ``wpe``, the proj biases) are
laid out first, so ``[0, replicated_end)`` is one slice the engine
all-reduces over the ring and counts once in the global norm; in the
owned range that slice is ``[0, own_replicated_end)``. Model ranks at one
data coordinate hold the same layout and so own the same range.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ...utils.distributed import all_gather, all_gather_into, reduce_scatter

ALIGN = 64      # elements: 128-byte aligned bf16 views, 256-byte fp32


class FlatPartition:
    """The flat buffers of one module's parameters and their views, and
    this rank's share of them over a data-parallel ``group``."""

    def __init__(self, module, device, compute_dtype,
                 accum_dtype=torch.float32, replicated=(),
                 moments_dtype=torch.float32, group=None, stage=0):
        self.device, self.compute_dtype = device, compute_dtype
        self.group = group
        self.dp_world = dist.get_world_size(group) if group is not None \
            else 1
        self.dp_rank = dist.get_rank(group) if group is not None else 0
        self.names, self.shapes, self.offsets = [], [], []
        params = []
        total = 0
        named = list(module.named_parameters())
        replicated = set(replicated)
        named = [(n, p) for n, p in named if n in replicated] + \
            [(n, p) for n, p in named if n not in replicated]
        self.replicated_end = 0
        for name, p in named:
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            self.offsets.append(total)
            params.append(p)
            total += -(-p.numel() // ALIGN) * ALIGN
            if name in replicated:
                self.replicated_end = total
        unit = ALIGN * self.dp_world
        total = -(-total // unit) * unit
        self.numel = total
        self.sharded = self.dp_world > 1 and stage >= 1
        self.part_numel = total // self.dp_world if self.sharded else total
        self.lo = self.dp_rank * self.part_numel if self.sharded else 0
        self.hi = self.lo + self.part_numel
        self.own_replicated_end = min(max(self.replicated_end - self.lo, 0),
                                      self.part_numel)
        # (n_params, 2) int64 on the device, built once
        self.segments = torch.tensor(
            [self._clip(off, p.numel())
             for off, p in zip(self.offsets, params)],
            dtype=torch.int64, device=device).reshape(-1, 2)
        self.mixed = compute_dtype != torch.float32
        whole = torch.zeros(total, dtype=torch.float32, device=device)
        for p, off in zip(params, self.offsets):
            whole[off:off + p.numel()].copy_(p.detach().reshape(-1))
        self.master = whole[self.lo:self.hi].clone() if self.sharded \
            else whole
        self.params = whole.to(compute_dtype) if self.mixed else whole
        del whole
        self.grads = torch.zeros(total, dtype=compute_dtype, device=device)
        self.grads_sharded = self.sharded and stage >= 2
        self.acc = torch.zeros(self.part_numel if self.grads_sharded
                               else total, dtype=accum_dtype, device=device)
        self.exp_avg = torch.zeros(self.part_numel, dtype=moments_dtype,
                                   device=device)
        self.exp_avg_sq = torch.zeros(self.part_numel, dtype=moments_dtype,
                                      device=device)
        self.step = 0
        for p, off, shape in zip(params, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            p.data = self.params[off:off + n].view(shape)
            p.grad = self.grads[off:off + n].view(shape)
        self._module_params = params

    def _clip(self, off, n):
        """A parameter's ``(offset, numel)`` in the owned range, offsets
        relative to ``lo``."""
        a = min(max(off, self.lo), self.hi)
        b = min(max(off + n, self.lo), self.hi)
        return a - self.lo, b - a

    def state_bytes(self):
        """Bytes this rank holds of master, moments and accumulator."""
        return {name: t.numel() * t.element_size() for name, t in (
            ("master", self.master), ("exp_avg", self.exp_avg),
            ("exp_avg_sq", self.exp_avg_sq), ("acc", self.acc))}

    # ------------------------------------------------------------ updates

    def own(self, flat):
        """The owned range of a whole buffer (a partition-sized one as it
        is)."""
        return flat if flat.numel() == self.part_numel else \
            flat[self.lo:self.hi]

    def fold_grads(self):
        """acc += grads (one add), then zero the compute-dtype grads. At
        stage 2 over a group the grads are first reduce-scattered over it
        in the accumulator's dtype, the dtype every stage sums in (one
        collective a micro-step, the reference's IPG bucket
        reduce-scatter), and the owned slice of the sum is added."""
        if self.grads_sharded:
            with record_function("zero.reduce_scatter"):
                part = reduce_scatter(self.grads.to(self.acc.dtype),
                                      self.group)
            self.acc.add_(part)
        else:
            self.acc.add_(self.grads)
        self.grads.zero_()

    def refresh_params(self):
        """master -> compute-dtype params: the owned range cast, then (when
        partitioned) every rank's range all-gathered into the whole
        buffer. A no-op at fp32 compute when the params are views of the
        whole master."""
        if self.sharded:
            own = self.params[self.lo:self.hi]
            own.copy_(self.master)
            with record_function("zero.all_gather"):
                all_gather_into(self.params, own, self.group)
        elif self.mixed:
            self.params.copy_(self.master)

    def check_views(self):
        """True while every parameter and ``.grad`` still views the flat
        buffers (autograd accumulated in place)."""
        return all(
            p.data_ptr() == self.params[off:].data_ptr() and
            p.grad is not None and
            p.grad.data_ptr() == self.grads[off:].data_ptr()
            for p, off in zip(self._module_params, self.offsets))

    # ------------------------------------------------------- JAX-shaped

    def whole(self, flat):
        """A buffer over the whole layout: a partition-sized one gathered
        over the data group (every rank of it must call), a whole one as
        it is."""
        if self.sharded and flat.numel() == self.part_numel:
            return all_gather(flat.detach(), self.group)
        return flat

    def tree_of(self, flat, keep_dtype=False):
        """A flat buffer (whole, or this rank's partition: then gathered
        over the data group, every rank must call) -> ``{dotted name:
        fp32 CPU tensor}`` (the ``state_dict`` naming of the module; a bf16
        buffer's values are exact in fp32), or in the buffer's own dtype
        with ``keep_dtype``."""
        host = self.whole(flat).detach()
        host = host.cpu() if keep_dtype else host.float().cpu()
        out = {}
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            out[name] = host[off:off + n].reshape(shape).clone()
        return out

    def load(self, flat, state):
        """``{dotted name: tensor}`` (whole tensors) -> into a flat buffer,
        whole or this rank's partition (each parameter sliced to the
        owned range), cast to its dtype: values a bf16 buffer can hold
        load bit for bit."""
        lo, hi = (self.lo, self.hi) if flat.numel() == self.part_numel \
            else (0, self.numel)
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            a, b = max(off, lo), min(off + n, hi)
            if a < b:
                src = torch.as_tensor(state[name]).reshape(-1)[a - off:
                                                                b - off]
                flat[a - lo:b - lo].copy_(src.to(flat.dtype))
