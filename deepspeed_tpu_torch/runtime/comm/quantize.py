"""Blockwise int8 codec, the 1-bit sign helpers, the fused flat layout and
the in-collective int8 exchange over ``torch.distributed``.

Port of ``deepspeed_tpu/runtime/comm/quantize.py`` (the flat codec, the
sign helpers, ``FusedFlatLayout``, ``qc_padded_size`` and the EQuARX
exchange bodies, the shape-preserving codec of ZeRO++'s weight gather
and the all-to-all quantized reduce-scatter). The JAX package runs each
exchange body inside ``shard_map`` over a mesh axis; here each is a
function of this rank's local tensor and a process group, and the rank
is the group's. ``qwz_gather``, the JAX package's GSPMD form of the
quantized weight gather, is ZeRO-3's gather of a unit here
(``runtime/zero/zeropp.py``).

Rules kept from the JAX package, so that the two give the same bits:

* lane i of a packed sign byte is bit i, and ``x >= 0`` packs as 1;
* a block's scale is ``absmax / 127`` (as the compiled JAX program
  computes it: times the fp32 reciprocal of 127) cast to the storage
  dtype BEFORE the divide (``max(scale, 1e-30)``), and ``q =
  clip(round(x / s), -127, 127)``: ``torch.round`` and ``jnp.round`` both
  round half to even;
* a bf16 input gets bf16 scales; the arithmetic runs in fp32.

Every division by a value is a division by a tensor: on CUDA a division
by a Python scalar becomes a multiplication by its reciprocal, which
rounds otherwise. XLA fuses the ring hop's dequantize-and-add into one
fused multiply-add; the port does the same (:func:`fma`: exact on the
CPU, ``addcmul``'s contracted FMA on CUDA). The norm in
:func:`sign_scale` is accumulated in fp64 and XLA's in fp32, so a scale
can differ from the JAX package's in its last bits.

The exchanges (:func:`ring_reduce_scatter_inline`,
:func:`quantized_all_gather_local`, :func:`quantized_all_reduce_local`,
:func:`hierarchical_all_reduce_local`) add to :data:`WIRE` the bytes
this rank hands to ``torch.distributed`` for other ranks: a ring hop
its payload, an all-gather ``(w - 1)`` times its part, an all-to-all
all but its own chunk: the quantities ``wire.py``'s formulas price. ZeRO
stage 3's unit collectives add to it too (``kind`` "allgather" and
"reduce", :attr:`WireTally.by_kind`).
"""
import numpy as np
import torch
import torch.distributed as dist

from ...parallel.ring import ring_perm, ring_rotate_start
from ...utils.distributed import all_gather, all_to_all

DEFAULT_BLOCK_SIZE = 256

_QMAX = 127.0
# XLA compiles ``absmax / 127`` to a product with the fp32 reciprocal
_INV_QMAX = float(np.float32(1.0) / np.float32(_QMAX))


class WireTally:
    """Bytes and collective calls this rank handed to ``torch.distributed``
    for other ranks in the compressed exchanges, since the last
    :meth:`reset`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.bytes = 0
        self.calls = 0
        self.by_kind = {}

    def add(self, nbytes, kind="exchange"):
        self.bytes += int(nbytes)
        self.calls += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + int(nbytes)


WIRE = WireTally()


_SCALARS = {}


def _scalar(value, like):
    """``value`` as a 0-dim fp32 tensor on ``like``'s device (a true
    division operand), made once per value and device."""
    key = (float(np.float32(value)), str(like.device))
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(key[0], dtype=torch.float32,
                                         device=like.device)
    return t


def group_size(group):
    return dist.get_world_size(group) if group is not None else 1


def group_rank(group):
    return dist.get_rank(group) if group is not None else 0


def fma(a, b, c):
    """``a * b + c`` over fp32 tensors, rounded once. On CUDA
    ``torch.addcmul`` (the compiler contracts its product and sum into one
    FMA); on the CPU exactly: the product is exact in fp64, and the fp64
    sum, rounded to odd with TwoSum's error, rounds correctly to fp32."""
    if a.is_cuda:
        return torch.addcmul(c, a, b)
    prod = a.double() * b.double()
    c64 = c.double()
    s = prod + c64
    back = s - c64
    err = (c64 - (s - back)) + (prod - back)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


# --------------------------------------------------------------- sign helpers
_BIT_SHIFTS = tuple(range(8))


def pack_signs(x):
    """Sign bits of ``x`` (size divisible by 8) packed 8 lanes a byte,
    lane i as bit i; ``x >= 0`` is 1."""
    bits = (x >= 0).to(torch.uint8).reshape(-1, 8)
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=x.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def unpack_signs(packed, scale):
    """uint8 bytes -> +-scale values in the scale's dtype."""
    scale = torch.as_tensor(scale)
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8,
                          device=packed.device)
    bits = (packed.reshape(-1, 1) >> shifts) & 1
    signs = (2 * bits.to(scale.dtype) - 1).reshape(-1)
    return scale.to(packed.device) * signs


def sign_scale(masked, count):
    """The 1-bit codec's one scale ``||x|| / sqrt(n)`` over the real lanes
    (``count``), in the input's dtype. The norm of the fp32 values is
    accumulated in fp64 and rounded once: an fp32 ``vector_norm`` on the
    CPU drifts by percents over 10^8 lanes, and the card's and the CPU's
    sums then agree to the last bit but rarely."""
    norm = torch.linalg.vector_norm(masked.float(),
                                    dtype=torch.float64).float()
    denom = np.sqrt(np.maximum(np.float32(count), np.float32(1.0)),
                    dtype=np.float32)
    return (norm / _scalar(denom, norm)).to(masked.dtype)


# ----------------------------------------------------------------- flat codec
def _block_count(n, block_size):
    return -(-n // block_size)


def _quantize_blocks(blocks, dtype):
    """Per-block (last dim) symmetric int8: ``(q int8, scales[..., 1] in
    dtype)``."""
    blocks = blocks.float()
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scales = (absmax * _INV_QMAX).to(dtype)
    safe = torch.clamp(scales.float(), min=1e-30)
    q = torch.clamp(torch.round(blocks / safe), -_QMAX, _QMAX).to(torch.int8)
    return q, scales


def quantize_blockwise(x, block_size=DEFAULT_BLOCK_SIZE):
    """Flat buffer -> ``(q (nblocks, block_size) int8, scales (nblocks,))``,
    zero-padded past ``x``'s size, scales in ``x``'s dtype."""
    flat = x.reshape(-1)
    n = flat.numel()
    padded = _block_count(n, block_size) * block_size
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    q, scales = _quantize_blocks(flat.reshape(-1, block_size), x.dtype)
    return q, scales.reshape(-1)


def dequantize_blockwise(q, scales, size=None, dtype=None):
    """Inverse of :func:`quantize_blockwise`: ``size`` lanes (all by
    default) in ``dtype`` (the scales' by default)."""
    dtype = scales.dtype if dtype is None else dtype
    out = (q.float() * scales.float()[:, None]).reshape(-1)
    if size is not None and size != out.numel():
        out = out[:size]
    return out.to(dtype)


def quantize_dequantize(x, block_size=DEFAULT_BLOCK_SIZE):
    """Round trip through the flat codec, ``x``'s shape and dtype."""
    q, scales = quantize_blockwise(x, block_size)
    return dequantize_blockwise(q, scales, x.numel(), x.dtype).reshape(
        x.shape)


def quantize_with_error_feedback(x, err, block_size=DEFAULT_BLOCK_SIZE,
                                 scale=1.0):
    """Quantize ``x + err * scale``; returns ``(dequantized in x's dtype,
    new error = (corrected - dequantized) / scale)``."""
    scale = torch.as_tensor(np.float32(scale), device=x.device)
    corrected = fma(err.float(), scale, x.float())
    q, scales = quantize_blockwise(corrected, block_size)
    n = corrected.numel()
    qd = dequantize_blockwise(q, scales, n, torch.float32)
    # corrected - q * s in one rounding (XLA fuses the dequantize in)
    padded = q.numel()
    rest = torch.nn.functional.pad(corrected.reshape(-1), (0, padded - n))
    resid = fma(-q.float(), scales.float()[:, None],
                rest.reshape(q.shape)).reshape(-1)[:n]
    return qd.to(x.dtype).reshape(x.shape), (resid / scale).reshape(
        x.shape)


# ------------------------------------------------- shape-preserving codec
def _lastdim_block(last, block_size):
    """Largest divisor of ``last`` that is <= ``block_size``: the block
    that tiles a last dimension with no ragged tail."""
    block = min(int(block_size), int(last))
    while last % block:
        block -= 1
    return block


def quantize_param(x, block_size=DEFAULT_BLOCK_SIZE):
    """Shape-preserving codec: ``q`` is int8 of ``x``'s shape, the scales
    have shape ``x.shape[:-1] + (nblocks,)``, blocks tiling the LAST
    dimension (``_lastdim_block``). A 0-dim input is one lane."""
    if x.dim() == 0:
        x = x.reshape(1)
    block = _lastdim_block(x.shape[-1], block_size)
    blocks = x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // block, block))
    q, scales = _quantize_blocks(blocks, x.dtype)
    return q.reshape(x.shape), scales.squeeze(-1)


def dequantize_param(q, scales, dtype):
    """Inverse of :func:`quantize_param`, in ``dtype``."""
    nblocks = scales.shape[-1]
    block = q.shape[-1] // nblocks
    blocks = q.reshape(tuple(q.shape[:-1]) + (nblocks, block))
    out = blocks.float() * scales.float()[..., None]
    return out.reshape(q.shape).to(dtype)


# -------------------------------------------------- fused flat layout
class FusedFlatLayout:
    """One fused flat fp32 buffer over a model's leaves: ``leaves`` are
    ``(name, shape)`` in the JAX package's tree-flatten order (sorted
    keys, lists in order), concatenated row-major with no gaps and padded
    to ``padded_size_fn(numel)``. The layout both compressed exchanges
    ride (the int8 gradient exchange, ``qc_padded_size``; OneBitAdam's
    momentum, ``onebit_padded_size``), as ``FusedFlatLayout`` of the JAX
    package."""

    def __init__(self, leaves, padded_size_fn):
        self.names, self.leaf_meta = [], []
        off = 0
        for name, shape in leaves:
            shape = tuple(int(s) for s in shape)
            n = int(np.prod(shape)) if shape else 1
            self.names.append(name)
            self.leaf_meta.append((off, n, shape))
            off += n
        self.numel = off
        self.padded = int(padded_size_fn(off))

    def bridge(self, offsets):
        """The :class:`FlatBridge` from a flat buffer whose leaf ``name``
        starts at ``offsets[name]`` (the engine's ``FlatPartition``: leaves
        in ``named_parameters`` order, each at a multiple of its ALIGN)."""
        return FlatBridge(self, offsets)


class FlatBridge:
    """The copy between the engine's flat layout and a
    :class:`FusedFlatLayout`: each leaf is one contiguous range in both,
    so ``to_fused`` is one ``cat`` of the leaves' views into the fused
    buffer (pad lanes zeroed) and ``from_fused`` one ``_foreach_copy_``
    back (the engine layout's alignment gaps untouched). Lane for lane the
    fused buffer is the JAX package's ``FusedFlatLayout.flatten``."""

    def __init__(self, layout, offsets):
        self.layout = layout
        self._src = [(offsets[name], n) for name, (_, n, _) in
                     zip(layout.names, layout.leaf_meta)]
        self._sizes = [n for _, n in self._src]

    def views(self, buf):
        return [buf[off:off + n] for off, n in self._src]

    def to_fused(self, buf, out=None):
        """A whole engine-layout buffer -> the ``(padded,)`` fp32 fused
        buffer (``out`` when given)."""
        layout = self.layout
        if out is None:
            out = torch.empty(layout.padded, dtype=torch.float32,
                              device=buf.device)
        views = self.views(buf)
        if buf.dtype == torch.float32:
            torch.cat(views, out=out[:layout.numel])
        else:
            out[:layout.numel].copy_(torch.cat(views))
        out[layout.numel:].zero_()
        return out

    def from_fused(self, fused, buf):
        """The fused buffer's leaves copied (cast to ``buf``'s dtype) into
        their ranges of the whole engine-layout buffer ``buf``."""
        parts = list(fused[:self.layout.numel].split(self._sizes))
        if fused.dtype != buf.dtype:
            parts = [p.to(buf.dtype) for p in parts]
        torch._foreach_copy_(self.views(buf), parts)
        return buf


# ---------------------------------------------------- in-collective mode
def qc_padded_size(n, world_size, block_size=DEFAULT_BLOCK_SIZE):
    """Lanes the in-collective exchange needs: a multiple of ``world *
    block_size`` (``world``: the product of the group sizes across
    levels)."""
    mult = int(world_size) * int(block_size)
    return ((int(n) + mult - 1) // mult) * mult


def quantized_all_gather_local(x, group, block_size=DEFAULT_BLOCK_SIZE):
    """Quantize this rank's flat part, all-gather the int8 blocks and the
    scales over ``group``, dequantize: the ``(world * n,)`` buffer in
    ``x``'s dtype, in rank order."""
    n = x.numel()
    world = group_size(group)
    q, scales = quantize_blockwise(x, block_size)
    if world == 1:
        return dequantize_blockwise(q, scales, n, x.dtype)
    WIRE.add((world - 1) * q.numel() * q.element_size())
    WIRE.add((world - 1) * scales.numel() * scales.element_size())
    qg = all_gather(q, group).reshape(world, -1, q.shape[-1])
    sg = all_gather(scales, group).reshape(world, -1)
    return torch.cat([dequantize_blockwise(qg[i], sg[i], n, x.dtype)
                      for i in range(world)])


def quantized_reduce_scatter_local(x, group, block_size=DEFAULT_BLOCK_SIZE,
                                   error=None):
    """The qgZ quantized reduce-scatter over ``group``: ``x`` is this
    rank's ``(world * chunk,)`` partials, chunk w destined to rank w. Each
    chunk is quantized with its own block grid (after adding ``error``,
    the persistent feedback, when given), the int8 chunks and their scales
    cross in one ``all_to_all`` each, and every rank dequantizes what it
    received and sums it over the senders in rank order, in fp32 (each
    sender's dequantize-and-add one fused multiply-add, as XLA fuses it).
    Returns ``(this rank's summed chunk in x's dtype, new error in fp32 or
    None)``."""
    world = group_size(group)
    chunk = x.numel() // world
    corrected = x.reshape(-1) if error is None else \
        x.reshape(-1) + error.to(x.dtype).reshape(-1)
    rows = corrected.reshape(world, chunk)
    parts = [quantize_blockwise(rows[w], block_size) for w in range(world)]
    q = torch.stack([p[0] for p in parts])
    scales = torch.stack([p[1] for p in parts])
    padded = q.shape[1] * q.shape[2]

    def lanes(v):
        return torch.nn.functional.pad(v.float(), (0, padded - chunk)) \
            .reshape(q.shape[1:])

    new_error = None
    if error is not None:
        # corrected - q * s in one rounding (XLA fuses the dequantize in)
        new_error = torch.cat([
            fma(-q[w].float(), scales[w].float()[:, None],
                lanes(rows[w])).reshape(-1)[:chunk] for w in range(world)])
    if world > 1:
        WIRE.add((world - 1) * q[0].numel() * q.element_size())
        WIRE.add((world - 1) * scales[0].numel() * scales.element_size())
        q = all_to_all(q, group)
        scales = all_to_all(scales, group)
    total = q[0].float() * scales[0].float()[:, None]
    for w in range(1, world):
        total = fma(q[w].float(), scales[w].float()[:, None], total)
    return total.reshape(-1)[:chunk].to(x.dtype), new_error


def ring_reduce_scatter_inline(x, group, block_size=DEFAULT_BLOCK_SIZE):
    """EQuARX in-collective ring reduce-scatter over ``group``: ``x`` is
    this rank's ``(world * chunk,)`` partials (chunk a multiple of
    ``block_size``), chunk c destined to rank c. Each of the ``world - 1``
    hops sends one quantized chunk (int8 blocks, then their scales) to
    the next rank; the receiver dequantizes to fp32, adds its own fp32
    chunk and requantizes for the next hop. The partial for chunk c
    starts at rank c + 1 and ends, summed, at rank c. Returns this rank's
    fp32 chunk."""
    world = group_size(group)
    chunk = x.numel() // world
    local = x.float().reshape(world, chunk)
    if world == 1:
        return local[0]
    rank = group_rank(group)
    perm = ring_perm(world)
    acc = local[(rank - 1) % world]
    for s in range(world - 1):
        q, scales = quantize_blockwise(acc, block_size)
        WIRE.add(q.numel() * q.element_size())
        WIRE.add(scales.numel() * scales.element_size())
        hop_q = ring_rotate_start(q, group, perm)
        hop_s = ring_rotate_start(scales, group, perm)
        # dequantize and add the local chunk in one rounding (XLA's fusion)
        own = local[(rank - 2 - s) % world].reshape(-1, block_size)
        acc = fma(hop_q.wait().float(), hop_s.wait().float()[:, None],
                  own).reshape(-1)
    return acc


def quantized_all_reduce_local(x, group, block_size=DEFAULT_BLOCK_SIZE):
    """Flat in-collective all-reduce SUM: the ring reduce-scatter, then the
    int8 all-gather. ``x``: ``(n,)`` partials, n a multiple of ``world *
    block_size``. Returns the ``(n,)`` fp32 sum (every rank the same
    bits)."""
    chunk = ring_reduce_scatter_inline(x, group, block_size)
    if group_size(group) == 1:
        return chunk
    return quantized_all_gather_local(chunk, group, block_size)


def hierarchical_all_reduce_local(x, shard_group, replica_group,
                                  block_size=DEFAULT_BLOCK_SIZE):
    """Two-level in-collective all-reduce SUM over a factored data group:
    the ring reduce-scatter over ``shard_group``, the ring reduce-scatter
    and int8 all-gather of that 1/shard chunk over ``replica_group``, then
    the int8 all-gather over ``shard_group``. ``x``: ``(n,)``, n a
    multiple of ``shard * replica * block_size``."""
    chunk_s = ring_reduce_scatter_inline(x, shard_group, block_size)
    if group_size(replica_group) > 1:
        chunk_r = ring_reduce_scatter_inline(chunk_s, replica_group,
                                             block_size)
        chunk_s = quantized_all_gather_local(chunk_r, replica_group,
                                             block_size)
    if group_size(shard_group) > 1:
        return quantized_all_gather_local(chunk_s, shard_group, block_size)
    return chunk_s


class QuantizedCollectives:
    """Blockwise-int8 collectives over a mesh's data group, or its
    factored ``(data_replica, data_shard)`` groups when the mesh was
    factored (``parallel/topology.py::factor_data_axis``). Each rank
    passes its own row: ``all_gather(x)`` -> ``(world * n,)``;
    ``reduce_scatter(x)``: ``(world * chunk,)`` partials -> this rank's
    ``(chunk,)`` sum through the all-to-all exchange;
    ``all_reduce(x)`` -> the ``(n,)`` sum through the in-collective ring
    (two levels on a factored mesh)."""

    def __init__(self, mesh, block_size=DEFAULT_BLOCK_SIZE):
        from ...parallel.topology import (DATA_AXIS, DATA_REPLICA_AXIS,
                                          DATA_SHARD_AXIS)
        self.mesh = mesh
        self.block_size = int(block_size)
        self.group = mesh.get_group(DATA_AXIS)
        self.world_size = int(mesh.shape.get(DATA_AXIS, 1))
        self.hierarchical = DATA_SHARD_AXIS in mesh.shape
        if self.hierarchical:
            self.shard_group = mesh.get_group(DATA_SHARD_AXIS)
            self.replica_group = mesh.get_group(DATA_REPLICA_AXIS)

    def all_gather(self, x):
        return quantized_all_gather_local(x.reshape(-1), self.group,
                                          self.block_size)

    def reduce_scatter(self, x):
        assert x.numel() % self.world_size == 0, (x.numel(),
                                                  self.world_size)
        out, _ = quantized_reduce_scatter_local(x.reshape(-1), self.group,
                                                self.block_size)
        return out

    def all_reduce(self, x):
        """In-collective quantized SUM of this rank's ``(n,)`` row; n a
        multiple of ``world * block_size`` (``qc_padded_size``)."""
        n = x.numel()
        assert n % (self.world_size * self.block_size) == 0, \
            (n, self.world_size, self.block_size)
        if self.hierarchical:
            return hierarchical_all_reduce_local(
                x.reshape(-1), self.shard_group, self.replica_group,
                self.block_size)
        return quantized_all_reduce_local(x.reshape(-1), self.group,
                                          self.block_size)
