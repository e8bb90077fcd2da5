"""Collective matmul: tensor-parallel GEMMs with the all-gather or the
reduce-scatter decomposed into ring hops.

Port of ``deepspeed_tpu/parallel/collective_matmul.py`` (the TP half; the
ZeRO-3 ring gather waits for the stage-3 slice). The JAX package calls its
fused ops per device inside ``shard_map`` and lets GSPMD reshard global
arrays at the boundary; here every rank calls them on its own shards:

* :func:`tp_column_matmul` (qkv, fc): x (b, s_loc, d), this rank's rows
  of the sequence-sharded residual stream; w (d, f_loc), its column shard.
  Returns (b, s, f_loc): ``allgather(x, dim=-2) @ w``;
* :func:`tp_row_matmul` (attention proj, mlp proj): x (b, s, f_loc); w
  (f_loc, d), its row shard. Returns (b, s_loc, d): this rank's rows of
  ``psum(x @ w)``.

Both are ``torch.autograd.Function``s whose backwards are the JAX
package's duals: column dx = matmul_rs(dy, w^T) and dw = gather_contract(x,
dy); row dx = ag_matmul(dy, w^T) and dw = gather_contract(dy, x,
rot_is_lhs=False). Backend ``"pallas"`` runs each ring step's product in
the CUDA kernels of ``ops/ring_gemm`` (their plain versions on CPU
tensors); ``"ppermute"`` runs the same loops with ``torch.matmul``
products, the numerics oracle. On a ring of one rank both are the plain
matmul, as in the JAX package.
"""
from dataclasses import dataclass

import torch

from ..ops.ring_gemm import ag_matmul, gather_contract, matmul_rs
from ..utils.distributed import all_gather, all_reduce_, reduce_scatter
from .ring import ring_context
from .topology import MODEL_AXIS

# wire dtype policy names (comm.collective_matmul.dtype)
DTYPE_COMPUTE = "compute"     # rotate in the input dtype (bit-exact wire)
DTYPE_BF16 = "bf16"           # cast payload to bf16 for the hop (lossy)

BACKEND_PPERMUTE = "ppermute"
BACKEND_PALLAS = "pallas"


def _wire_dtype(policy):
    return torch.bfloat16 if policy == DTYPE_BF16 else None


@dataclass(frozen=True)
class CollectiveMatmulBinding:
    """What a model needs to run its TP matmuls on the ring: the process
    group of the ring (the mesh's ``model`` group), the axis name, and the
    decomposition knobs. The engine attaches one to the model config when
    the mesh carries a ``model`` axis > 1."""
    group: object
    axis: str = MODEL_AXIS
    chunks: int = 1
    dtype: str = DTYPE_COMPUTE
    backend: str = BACKEND_PPERMUTE

    @property
    def size(self):
        return ring_context(self.group)[0]

    @property
    def rank(self):
        return ring_context(self.group)[1]


def _kernel_live(group, backend):
    """Whether the ring steps run in the CUDA kernels: backend "pallas" on
    a real ring (n > 1). Any leading dims fold into the batch
    (:func:`_as_rank3`), so every TP-site input takes the kernels."""
    return backend == BACKEND_PALLAS and ring_context(group)[0] > 1


def _as_rank3(x):
    """[..., s, d] -> (prod(...), s, d): the ring loops are rank 3."""
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def _ag(x, w, group, chunks, wire, backend):
    y = ag_matmul(_as_rank3(x), w, group, wire, chunks,
                  use_kernel=_kernel_live(group, backend))
    return y.reshape(tuple(x.shape[:-2]) + tuple(y.shape[-2:]))


def _rs(x, w, group, chunks, wire, backend):
    y = matmul_rs(_as_rank3(x), w, group, wire, chunks,
                  use_kernel=_kernel_live(group, backend))
    return y.reshape(tuple(x.shape[:-2]) + tuple(y.shape[-2:]))


def _gc(rot, fixed, group, chunks, wire, rot_is_lhs, backend):
    return gather_contract(_as_rank3(rot), _as_rank3(fixed), group, wire,
                           chunks, rot_is_lhs,
                           use_kernel=_kernel_live(group, backend))


class AllgatherMatmul(torch.autograd.Function):
    """Column-parallel ring GEMM, ``allgather(x, dim=-2) @ w``; backward
    dx = matmul_rs(dy, w^T), dw = gather_contract(x, dy)."""

    @staticmethod
    def forward(ctx, x, w, binding):
        ctx.save_for_backward(x, w)
        ctx.binding = binding
        b = binding
        return _ag(x, w, b.group, int(b.chunks), _wire_dtype(b.dtype),
                   b.backend)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        b = ctx.binding
        wire = _wire_dtype(b.dtype)
        dy = dy.contiguous()
        dx = _rs(dy, w.t(), b.group, int(b.chunks), wire, b.backend)
        dw = _gc(x, dy, b.group, int(b.chunks), wire, True, b.backend)
        return dx.to(x.dtype), dw.to(w.dtype), None


class MatmulReducescatter(torch.autograd.Function):
    """Row-parallel ring GEMM, ``reduce_scatter(psum_partial(x @ w),
    dim=-2)``; backward dx = ag_matmul(dy, w^T), dw = gather_contract(dy,
    x, rot_is_lhs=False)."""

    @staticmethod
    def forward(ctx, x, w, binding):
        ctx.save_for_backward(x, w)
        ctx.binding = binding
        b = binding
        return _rs(x, w, b.group, int(b.chunks), _wire_dtype(b.dtype),
                   b.backend)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        b = ctx.binding
        wire = _wire_dtype(b.dtype)
        dy = dy.contiguous()
        dx = _ag(dy, w.t(), b.group, int(b.chunks), wire, b.backend)
        dw = _gc(dy, x, b.group, int(b.chunks), wire, False, b.backend)
        return dx.to(x.dtype), dw.to(w.dtype), None


def allgather_matmul(x, w, binding):
    return AllgatherMatmul.apply(x, w, binding)


def matmul_reducescatter(x, w, binding):
    return MatmulReducescatter.apply(x, w, binding)


def _tp_live(binding, x, w, kind):
    """Whether the ring op runs: a binding on a ring of more than one
    rank. The shards cannot be multiplied without their collective, so a
    shape the ring cannot take raises instead of falling back."""
    if binding is None or binding.size <= 1:
        return False
    if x.ndim < 2 or w.ndim != 2:
        raise ValueError(
            "tp_{}_matmul: need x rank >= 2 / w rank 2, got {} / {}".format(
                kind, x.ndim, w.ndim))
    n = binding.size
    if kind == "row" and x.shape[-2] % n:
        raise ValueError(
            "tp_row_matmul: seq {} must divide the '{}' ring size {}".format(
                x.shape[-2], binding.axis, n))
    return True


def tp_column_matmul(x, w, binding):
    """``allgather(x, dim=-2) @ w`` over the binding's ring when it is
    live; the plain matmul otherwise (a ring of one). x (..., s_loc, d);
    w (d, f_loc)."""
    if not _tp_live(binding, x, w, "column"):
        return x @ w
    return allgather_matmul(x, w, binding)


def tp_row_matmul(x, w, binding):
    """This rank's rows of ``psum(x @ w)`` over the binding's ring when it
    is live; the plain matmul otherwise. x (..., s, f_loc); w (f_loc,
    d). The output leaves sequence-sharded: (..., s / n, d)."""
    if not _tp_live(binding, x, w, "row"):
        return x @ w
    return matmul_reducescatter(x, w, binding)


# ------------------------------------ the TP collectives outside the ring


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return all_gather(w, group, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.group, dim=0), None


def gather_rows(w, group):
    """Every rank's row shard of ``w`` concatenated in rank order (the
    vocabulary-sharded ``wte`` made whole for the embedding and the tied
    head); the gradient reduce-scatters back to the shards."""
    return _GatherRows.apply(w, group)


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        # every rank holds the same sum and back-propagates the same seed
        # into its own term: the gradient of its input is grad itself
        return grad, None


def sum_across(x, group):
    """The sum of ``x`` over the ranks of ``group``, the same on each;
    each rank's gradient flows to its own term only."""
    return _SumAcross.apply(x, group)
