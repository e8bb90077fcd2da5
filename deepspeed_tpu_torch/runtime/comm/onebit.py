"""1-bit sign + scale compressed collectives over ``torch.distributed``.

Port of ``deepspeed_tpu/runtime/comm/onebit.py`` (the reference's
``NcclBackend.compressed_allreduce``, its two phases as a real
reduce-scatter / all-gather pair):

* :func:`onebit_reduce_scatter_local`, the WORKER phase: add the worker
  error, take one scale ``||x|| / sqrt(n)`` over the real lanes, pack the
  sign bits, ``all_to_all`` the sign chunks (and all-gather the scalar
  scales), unpack and average this rank's chunk over the workers;
* :func:`onebit_all_gather_local`, the SERVER phase: add the server error
  to the averaged chunk, compress it with a fresh scale, all-gather the
  sign bytes (and scales) back to every rank;
* :func:`compressed_allreduce_local`, the two composed.

Each is a function of this rank's buffer and a process group (the JAX
bodies run inside ``shard_map``; the rank is the group's). Pad lanes
carry zero value AND zero error (:func:`masked_compress`): a rank's
chunk's real-lane count and mask depend on where the chunk starts. The
buffers stay in their dtype (a bf16 buffer gets a bf16 scale); the
exchanges add the bytes they hand to ``torch.distributed`` to
``quantize.WIRE``.
"""
import numpy as np
import torch

from ...utils.distributed import all_gather, all_to_all
from .quantize import (WIRE, group_rank, group_size, pack_signs,
                       sign_scale, unpack_signs)


def onebit_padded_size(n, world_size):
    """Lanes the 1-bit exchange needs: a multiple of ``8 * world`` so every
    rank's chunk packs to whole sign bytes."""
    mult = 8 * int(world_size)
    return ((int(n) + mult - 1) // mult) * mult


def masked_compress(x, mask, count):
    """Sign + scale quantize the lanes ``mask`` selects (1.0 / 0.0;
    ``count`` real lanes). Returns ``(packed signs, scale, decompressed,
    error residual)``, all in ``x``'s dtype; pad lanes decompress to 0 and
    carry zero error."""
    mask = mask.to(x.dtype)
    masked = x * mask
    scale = sign_scale(masked, count)
    packed = pack_signs(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    signs = torch.where(x >= 0, one, -one)
    decompressed = scale * signs * mask
    return packed, scale, decompressed, (x - decompressed) * mask


def _real_mask(n, real_size, device, start=0):
    return (torch.arange(n, device=device) + start < real_size).to(
        torch.float32)


def _gather_scale(scale, group):
    """Every rank's 0-dim ``scale``, as a ``(world,)`` tensor."""
    world = group_size(group)
    if world == 1:
        return scale.reshape(1)
    WIRE.add((world - 1) * scale.element_size())
    return all_gather(scale.reshape(1), group)


def onebit_reduce_scatter_local(x, worker_error, group, real_size=None):
    """The worker phase over ``group``: ``x`` this rank's flat buffer (size
    a multiple of ``8 * world``; lanes >= ``real_size`` padding). Returns
    ``(chunk_mean, chunk_mask, chunk_count, new_worker_error)``: this
    rank's chunk of the worker average (masked to its real lanes, without
    the server error), the chunk's real-lane mask and count, and this
    rank's new residual."""
    n = x.numel()
    world = group_size(group)
    chunk = n // world
    if real_size is None:
        real_size = n
    mask = _real_mask(n, real_size, x.device)
    corrected = x + worker_error
    packed, scale, _, new_worker_error = masked_compress(
        corrected, mask, np.float32(real_size))
    rows = packed.reshape(world, chunk // 8)
    recv = rows
    if world > 1:
        WIRE.add((world - 1) * rows.shape[1])
        recv = all_to_all(rows, group)
    scales = _gather_scale(scale, group)
    start = group_rank(group) * chunk
    chunk_mask = _real_mask(chunk, real_size, x.device, start)
    chunk_count = np.float32(min(max(int(real_size) - start, 0), chunk))
    per_worker = torch.stack([unpack_signs(recv[i], scales[i])
                              for i in range(world)])
    # the mean in fp32 (XLA multiplies by the reciprocal of the constant
    # count), in the workers' dtype (as jnp.mean), then masked by the fp32
    # mask (the product promotes as in the JAX body)
    chunk_mean = (per_worker.float().sum(dim=0) *
                  float(np.float32(1.0) / np.float32(world))).to(
                      per_worker.dtype)
    return (chunk_mean * chunk_mask, chunk_mask, chunk_count,
            new_worker_error)


def onebit_all_gather_local(server_chunk, server_error, group, chunk_mask,
                            chunk_count):
    """The server phase over ``group``: compress this rank's averaged
    chunk plus its server error, all-gather the sign bytes and scales,
    unpack. Returns ``(full, new_server_error)``: ``full`` the chunks in
    rank order (other chunks' pad lanes not masked here)."""
    world = group_size(group)
    server_in = server_chunk + server_error
    packed, scale, _, new_server_error = masked_compress(
        server_in, chunk_mask, chunk_count)
    gathered = packed.reshape(1, -1)
    if world > 1:
        WIRE.add((world - 1) * packed.numel())
        gathered = all_gather(packed, group).reshape(world, -1)
    scales = _gather_scale(scale, group)
    full = torch.cat([unpack_signs(gathered[i], scales[i])
                      for i in range(world)])
    return full, new_server_error


def compressed_allreduce_local(x, worker_error, server_error, group,
                               real_size=None):
    """Both phases: ``x`` this rank's flat buffer (size a multiple of ``8 *
    world``; lanes >= ``real_size`` padding). Returns ``(averaged buffer,
    new worker error, new server error)`` in the inputs' shapes (the
    server error is 1/world of the buffer)."""
    n = x.numel()
    if real_size is None:
        real_size = n
    chunk_mean, chunk_mask, chunk_count, new_worker_error = \
        onebit_reduce_scatter_local(x, worker_error, group, real_size)
    result, new_server_error = onebit_all_gather_local(
        chunk_mean, server_error, group, chunk_mask, chunk_count)
    mask = _real_mask(n, real_size, x.device)
    return result * mask, new_worker_error, new_server_error
