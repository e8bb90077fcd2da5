"""Wire bytes of the compressed exchanges, per device and per call.

The formulas of ``deepspeed_tpu/runtime/comm/wire.py``
(``quantized_allreduce_bytes``, ``onebit_exchange_bytes``, ``_payload``):
pure arithmetic, against which the bytes the port hands to
``torch.distributed`` (``quantize.WIRE``) are held. Ring pricing: an
all-gather or all-to-all moves ``payload * (g - 1) / g`` bytes a device, a
ring hop its whole payload.
"""
from .onebit import onebit_padded_size
from .quantize import DEFAULT_BLOCK_SIZE, qc_padded_size

_FP32_BYTES = 4


def _ring_factor(group):
    return (group - 1) / group if group > 1 else 0.0


def quantized_allreduce_bytes(numel, world, block_size=DEFAULT_BLOCK_SIZE,
                              levels=None, scale_itemsize=_FP32_BYTES,
                              min_component=0):
    """Per-device wire bytes of ONE in-collective quantized all-reduce
    (``quantized_all_reduce_local`` / ``hierarchical_all_reduce_local``):
    a ring reduce-scatter whose every hop moves one int8 chunk and its
    block scales, then an int8 all-gather with the scales.
    ``levels=(shard, replica)`` prices the two-level form: the full
    payload over the shard group, the 1/shard chunk over the replica
    group. ``min_component`` drops components below a threshold (the JAX
    package's HLO census)."""
    padded = qc_padded_size(numel, world, block_size)

    def keep(b):
        return int(b) if b >= min_component else 0

    def level(n, g):
        if g <= 1:
            return 0
        chunk = n // g
        nblocks = chunk // block_size
        total = (g - 1) * (keep(chunk) + keep(nblocks * scale_itemsize))
        total += keep((g - 1) * chunk)
        total += keep((g - 1) * nblocks * scale_itemsize)
        return total

    if levels:
        shard, replica = levels
        assert shard * replica == world, (levels, world)
        return level(padded, shard) + level(padded // shard, replica)
    return level(padded, world)


def onebit_exchange_bytes(numel, world, scale_itemsize=_FP32_BYTES,
                          min_component=0, itemsize_bits=1):
    """Per-device wire bytes of ONE compressed momentum all-reduce: the
    worker ``all_to_all`` of packed sign chunks and the scalar-scale
    all-gather, then the server sign all-gather and its scales.
    ``itemsize_bits=32`` prices the same exchange uncompressed."""
    padded = onebit_padded_size(numel, world)
    ring = _ring_factor(world)
    payload = padded * itemsize_bits // 8

    def keep(b):
        return int(b) if b >= min_component else 0

    total = 0
    total += keep(int(round(payload * ring)))
    total += keep(int(round(world * scale_itemsize * ring)))
    total += keep(int(round(payload * ring)))
    total += keep(int(round(world * scale_itemsize * ring)))
    return total


def _payload(numel, itemsize, quantized, scale_itemsize, block_size):
    """Bytes of one buffer of ``numel`` lanes: ``itemsize`` each, or 1 a
    lane plus one scale a ``block_size`` block when ``quantized``."""
    if not quantized:
        return numel * itemsize
    nblocks = -(-numel // block_size)
    return numel * 1 + nblocks * scale_itemsize
