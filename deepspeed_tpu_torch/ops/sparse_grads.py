"""Sparse embedding-gradient exchange (the reference's CSR path).

Port of ``deepspeed_tpu/ops/sparse_grads.py::sparse_embedding_lookup``
(the reference's ``sparse_allreduce_bucket``, ``engine.py:1285-1341``):
the lookup's backward all-gathers each data-parallel rank's ``(ids,
rows)`` over the data group (the CSR payload: a step touches at most
batch * seq rows of the (vocab, d) table) and scatter-adds them into a
dense (vocab, d) gradient in fp32, cast to the table's dtype. Duplicate
ids, within a rank and across ranks, add.

Scaling: each rank's rows are derivatives of its own loss, the mean over
its rows, so the gathered sum is ``dp_world`` times the gradient of the
global mean. The densified gradient is therefore divided by ``dp_world``:
the engine then sums every gradient over the data group and divides by
``dp_world`` once, and the table gets the global mean's gradient, as the
JAX engine's. Under tensor parallelism the table is the gathered one and
its gradient goes back through the ring's reduce-scatter as before.

No wire is saved in this port: GPT-2 ties ``wte`` into the LM head, so
the head's dense gradient of the same table still goes through the
engine's reduction of the whole flat gradient buffer (as under GSPMD in
the JAX package), and the exchange comes on top of it.
"""
import torch
from torch.profiler import record_function

from ..parallel.topology import DATA_AXIS
from ..utils.distributed import all_gather


def sparse_embedding_lookup(wte, ids, mesh=None, axis=DATA_AXIS):
    """``wte[ids]`` with the sparse gradient exchange over the ``axis``
    group of ``mesh`` (the port's ``ProcessMesh``); ``ids`` are this
    rank's rows. Falls back to the plain lookup (a dense gradient) with no
    mesh or a trivial axis. The JAX function also falls back when the
    global batch does not divide over the axis: here every rank passes
    its own rows (the engine takes the same count on every rank), so the
    global batch always divides."""
    world = int(mesh.shape.get(axis, 1)) if mesh is not None else 1
    if world <= 1:
        return wte[ids]
    return _SparseLookup.apply(wte, ids, mesh.get_group(axis), world)


class _SparseLookup(torch.autograd.Function):
    """The lookup whose backward exchanges ``(ids, rows)`` over a group."""

    @staticmethod
    def forward(ctx, wte, ids, group, world):
        ctx.save_for_backward(ids)
        ctx.group, ctx.world = group, world
        ctx.table = (wte.shape, wte.dtype)
        return wte[ids]

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        (vocab, d), dtype = ctx.table
        with record_function("sparse_grads.all_gather"):
            ids_g = all_gather(ids.reshape(-1).contiguous(), ctx.group)
            rows_g = all_gather(dout.reshape(-1, d).contiguous(), ctx.group)
        dense = torch.zeros((vocab, d), dtype=torch.float32,
                            device=dout.device)
        dense.index_add_(0, ids_g.long(), rows_g.float())
        dense.div_(ctx.world)
        return dense.to(dtype), None, None, None
