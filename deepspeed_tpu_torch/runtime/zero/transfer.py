"""Chunked host transfers for ZeRO-Offload.

Port of ``deepspeed_tpu/runtime/zero/transfer.py``: the now-live
``sub_group_size`` cuts the offload step into work chunks
(:func:`chunk_rows`, a copy of the JAX function, and :func:`flat_chunks`,
its form over the port's flat owned part), and the now-live
``stage3_prefetch_bucket_size`` packs the uploads (:class:`H2DBatcher`).

The JAX batcher concatenates queued leaves into one host array a bucket
and uploads it with one ``device_put``. The port's host buffers are
already flat, and a work chunk's bf16 weights lie contiguous in a pinned
staging buffer in the same order as the device range they go to, so
packing is free: a bucket is a run of whole leaves (a leaf larger than
the bucket alone), copied with one ``non_blocking`` host-to-device copy
on the upload stream. ``batches`` counts the copies, as the JAX
batcher's ``batches`` counts its ``device_put`` calls. The streamed
parameter offload
(``runtime/zero/stream.py``) uploads a layer group's ranges of the host
parameters into one device buffer through the same buckets (``base``:
the layout offset the buffer's element 0 stands for).
"""
import numpy as np
import torch


def chunk_rows(shape, sub_group_size):
    """Row-range chunks of a shard covering at most ``sub_group_size``
    elements each — the now-live ``sub_group_size``: the element chunk
    size of the offload shard pipeline's D2H -> host-Adam work items
    (reference stage3.py sub-group-partitioned optimizer step). Returns
    ``[(row_start, row_stop), ...]``; ``[(0, rows)]`` when one chunk
    suffices. Scalars and tiny shards are a single chunk."""
    if not shape:
        return [(0, 1)]
    rows = int(shape[0])
    row_elems = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
        else 1
    total = rows * row_elems
    if total <= sub_group_size or rows <= 1:
        return [(0, rows)]
    rows_per = max(1, int(sub_group_size // max(row_elems, 1)))
    return [(r, min(r + rows_per, rows)) for r in range(0, rows, rows_per)]


def flat_chunks(numel, sub_group_size, cap):
    """``[(lo, hi), ...]`` covering ``[0, numel)`` in chunks of at most
    ``min(sub_group_size, cap)`` elements (``cap`` bounds the pinned
    staging a chunk needs when ``sub_group_size`` is left at its
    default)."""
    size = max(1, min(int(sub_group_size), int(cap)))
    return [(lo, min(lo + size, numel)) for lo in range(0, numel, size)]


class H2DBatcher:
    """Upload ranges of a host staging buffer into a device buffer in
    buckets of whole leaves.

    ``cuts`` are the offsets (in the device buffer's coordinates) where
    leaves start; :meth:`upload` sends ``src`` (the staging for device
    range ``[lo, hi)``) as runs of consecutive leaf pieces of at most
    ``bucket_elems`` elements, each one copy (``non_blocking`` on CUDA,
    issued on the current stream)."""

    def __init__(self, bucket_elems, cuts):
        self.bucket_elems = max(int(bucket_elems), 1)
        self.cuts = np.asarray(sorted(set(int(c) for c in cuts)),
                               dtype=np.int64)
        self.batches = 0        # copies issued

    def buckets(self, lo, hi):
        """The ``[(a, b), ...]`` copies of device range ``[lo, hi)``."""
        inner = self.cuts[(self.cuts > lo) & (self.cuts < hi)].tolist()
        edges = [lo] + inner + [hi]
        out, start = [], lo
        for a, b in zip(edges[:-1], edges[1:]):
            if b - start > self.bucket_elems and a > start:
                out.append((start, a))
                start = a
        out.append((start, hi))
        return out

    def upload(self, dst, src, lo, hi, base=0):
        """``dst[lo - base:hi - base] = src[:hi - lo]`` in buckets."""
        non_blocking = dst.device.type == "cuda"
        for a, b in self.buckets(lo, hi):
            dst[a - base:b - base].copy_(src[a - lo:b - lo],
                                         non_blocking=non_blocking)
            self.batches += 1


def staging(numel, dtype, device):
    """A host staging buffer of ``numel`` elements: pinned when the
    transfers go to a CUDA ``device`` (the only host memory the offload
    path pins), pageable otherwise."""
    return torch.empty(numel, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")
