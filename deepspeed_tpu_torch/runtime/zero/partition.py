"""ZeRO stages 0-2 as flat-buffer partitions.

Port of ``deepspeed_tpu/runtime/zero/partition.py::ZeroShardingPlan``,
re-expressed for PyTorch. The JAX package shards each leaf of the train
state over the mesh's ``data`` axis (stage 1: master + optimizer state;
stage 2: + gradients). Here the state is a few flat buffers:

* one fp32 master buffer, the fp32 gradient accumulator and the fp32
  optimizer moments (``exp_avg`` / ``exp_avg_sq``, Adam's or LAMB's):
  the optimizer works on each whole, with one kernel launch (Adam) or
  one per pass (LAMB's stage 1 and apply);
* the compute-dtype parameters: one flat buffer of which every
  ``nn.Parameter`` of the module is a view (at fp32 compute it is the
  master buffer itself);
* the compute-dtype gradients: one flat buffer of which every
  parameter's ``.grad`` is a view, so autograd accumulates into it in
  place (a tied weight sums both uses there) and one ``add_`` folds a
  micro-step into the accumulator.

Each parameter starts at a multiple of :data:`ALIGN` elements (padding
stays zero in every buffer: Adam and LAMB map p = g = m = v = 0 to zeros,
so padding adds nothing to a LAMB norm either). ``segments`` is the
segment table, one ``(offset, numel)`` per parameter (per JAX leaf):
LAMB takes one trust ratio per segment. This slice
runs world size 1, where a rank's partition is the whole buffer; a
larger world raises ``NotImplementedError``: slicing each buffer into
per-rank ranges comes with the multi-GPU ZeRO slice, over
``torch.distributed``.
"""
import numpy as np
import torch

ALIGN = 64      # elements: 128-byte aligned bf16 views, 256-byte fp32


class FlatPartition:
    """The flat buffers of one module's parameters and their views."""

    def __init__(self, module, device, compute_dtype, world_size=1,
                 accum_dtype=torch.float32):
        if world_size != 1:
            raise NotImplementedError(
                "ZeRO over {} ranks is not ported yet: partitions across "
                "GPUs come with the multi-GPU ZeRO slice "
                "(torch.distributed)".format(world_size))
        self.device, self.compute_dtype = device, compute_dtype
        self.names, self.shapes, self.offsets = [], [], []
        params = []
        total = 0
        for name, p in module.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
            self.offsets.append(total)
            params.append(p)
            total += -(-p.numel() // ALIGN) * ALIGN
        self.numel = total
        # (n_params, 2) int64 on the device, built once
        self.segments = torch.tensor(
            [[off, p.numel()] for off, p in zip(self.offsets, params)],
            dtype=torch.int64, device=device).reshape(-1, 2)
        self.master = torch.zeros(total, dtype=torch.float32, device=device)
        for p, off in zip(params, self.offsets):
            self.master[off:off + p.numel()].copy_(p.detach().reshape(-1))
        self.mixed = compute_dtype != torch.float32
        self.params = self.master.to(compute_dtype) if self.mixed \
            else self.master
        self.grads = torch.zeros(total, dtype=compute_dtype, device=device)
        self.acc = torch.zeros(total, dtype=accum_dtype, device=device)
        self.exp_avg = torch.zeros(total, dtype=torch.float32, device=device)
        self.exp_avg_sq = torch.zeros(total, dtype=torch.float32,
                                      device=device)
        self.step = 0
        for p, off, shape in zip(params, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            p.data = self.params[off:off + n].view(shape)
            p.grad = self.grads[off:off + n].view(shape)
        self._module_params = params

    # ------------------------------------------------------------ updates

    def fold_grads(self):
        """acc += grads (one add), then zero the compute-dtype grads."""
        self.acc.add_(self.grads)
        self.grads.zero_()

    def refresh_params(self):
        """master -> compute-dtype params (a no-op at fp32 compute, where
        the params are views of the master buffer)."""
        if self.mixed:
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

    def tree_of(self, flat):
        """A flat buffer -> ``{dotted name: fp32 CPU tensor}`` (the
        ``state_dict`` naming of the module)."""
        host = flat.detach().float().cpu()
        out = {}
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            out[name] = host[off:off + n].reshape(shape).clone()
        return out

    def load(self, flat, state):
        """``{dotted name: tensor}`` -> into a flat buffer."""
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            n = int(np.prod(shape)) if shape else 1
            flat[off:off + n].copy_(
                torch.as_tensor(state[name]).reshape(-1).to(flat.dtype))
