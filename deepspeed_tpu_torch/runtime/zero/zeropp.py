"""ZeRO++ on the flat stage-3 partition: the quantized weight gather
(qwZ), the secondary partition's gather (hpZ), the ring gather and the
quantized gradient codec (qgZ).

The JAX engine runs these on whole leaves: ``qwz_gather`` quantizes each
data-sharded leaf with the shape-preserving codec (blocks of
``_lastdim_block(last, 256)`` lanes tiling its last dimension), the ring
gather (``parallel/collective_matmul.py::zero3_ring_gather``) quantizes
each rank's shard of it, and qgZ runs ``quantize_with_error_feedback`` on
each leaf's flattened gradient (blocks of 256 from the leaf's start).
Here a rank holds a flat piece of a unit, and a piece boundary can fall
inside a block, where no rank sees the whole block. :class:`PieceCodec`
keeps the JAX blocks all the same: every rank takes the absmax of each
block its piece touches, the partial absmax of the blocks at its piece's
ends crosses the group in one small all-gather (two values a contiguous
range), and each shared block's absmax is the max of its parts, which is
the whole block's (a max is exact in any order). Scales, int8 lanes and
dequantized values are then the JAX codec's, bit for bit.

:class:`UnitGather` is the gather of one unit's pieces: one all-gather
(the default), the int8 lanes and their scales packed in one buffer
(qwZ), or a ring of one-hop rotations of either (``zero_gather``), the
next unit's ring posted before the current unit's function runs
(``runtime/zero/stage3.py``). Under hpZ a rank's secondary piece is the
concatenation of its replica group's primary pieces, so the gather runs
over the shard group and one transpose puts the pieces in unit order.
"""
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ...parallel.ring import ring_context, ring_rotate_start
from ...utils.distributed import GLOO, all_gather, all_gather_into
from ..comm.quantize import (_INV_QMAX, _QMAX, DEFAULT_BLOCK_SIZE, WIRE,
                             _lastdim_block, _scalar, fma)


class BlockGrid:
    """The quantization blocks over a flat range of ``n`` lanes:
    ``leaves`` is ``[(offset, numel, block)]`` with ascending offsets
    relative to the range, the first at 0. Each leaf is cut into blocks of
    ``block`` lanes from its start (its last block shorter when ``block``
    does not divide ``numel``); the lanes after a leaf up to the next one
    (alignment gaps, the range's padding: zeros in every buffer) join its
    last block, so the blocks are contiguous runs covering the range and
    each block's absmax is the leaf block's."""

    def __init__(self, leaves, n):
        starts = [np.arange(off, off + numel, block, dtype=np.int64)
                  for off, numel, block in leaves]
        self.starts = np.concatenate(starts + [np.array([n], np.int64)])
        if self.starts[0] != 0:
            raise ValueError("the first leaf must start the range")

    def touched(self, lo, hi):
        """``(first block, lengths of the blocks [lo, hi) touches, each
        clipped to it)``."""
        g0 = int(np.searchsorted(self.starts, lo, side="right")) - 1
        g1 = int(np.searchsorted(self.starts, hi, side="left"))
        return g0, np.diff(np.clip(self.starts[g0:g1 + 1], lo, hi))


class PieceCodec:
    """The blocked int8 codec over the pieces of a flat range that the
    ranks of a group hold: ``pieces[i]`` is rank i's list of contiguous
    ``(lo, hi)`` ranges of the range, in the order its piece holds them.
    See the module docstring for the shared blocks."""

    def __init__(self, grid, pieces, rank, device):
        self.world, self.rank = len(pieces), rank
        ids, counts, lengths = [], [], []
        for ranges in pieces:
            own_ids, own_lengths = [], []
            for lo, hi in ranges:
                g0, lens = grid.touched(lo, hi)
                own_ids += [g0, g0 + len(lens) - 1]
                own_lengths.append(lens)
            ids.append(own_ids)
            lens = np.concatenate(own_lengths)
            lengths.append(lens)
            counts.append(len(lens))
        self.counts = counts
        self.max_count = max(counts)
        owners = {}
        for r, own in enumerate(ids):
            for b in own:
                owners.setdefault(b, set()).add(r)
        self.shared = any(len(v) > 1 for v in owners.values())
        flat_ids = np.array([b for own in ids for b in own], np.int64)
        mine = np.array(ids[rank], np.int64)
        # my range ends' positions among my touched blocks, and which of
        # the gathered ends name the same block
        ends = np.cumsum([0] + [len(grid.touched(lo, hi)[1])
                                for lo, hi in pieces[rank]])
        self._end_pos = torch.as_tensor(
            np.stack([ends[:-1], ends[1:] - 1], axis=1).reshape(-1),
            device=device)
        self._same = torch.as_tensor(mine[:, None] == flat_ids[None, :],
                                     device=device)
        self.lengths = torch.as_tensor(lengths[rank], device=device)
        self.all_lengths = torch.as_tensor(np.concatenate(lengths),
                                           device=device)
        # the expansions' sizes, given so that no expansion waits for the
        # device to count them
        self.numel = int(lengths[rank].sum())
        self.all_numel = int(sum(int(lens.sum()) for lens in lengths))

    def absmax(self, x, group):
        """The fp32 absmax of each block this rank's piece ``x`` touches,
        those at its ranges' ends over the group. (A scatter of each lane
        into its block: ``segment_reduce`` would wait for the device.)"""
        blocks = torch.arange(len(self.lengths), device=x.device)
        a = torch.zeros(len(self.lengths), dtype=torch.float32,
                        device=x.device).scatter_reduce_(
            0, self._expand(blocks), x.float().abs(), "amax")
        if self.shared and self.world > 1:
            ends = a[self._end_pos]
            WIRE.add((self.world - 1) * ends.numel() * ends.element_size(),
                     kind="allgather")
            got = all_gather(ends, group)
            full = torch.where(self._same, got[None, :],
                               torch.zeros((), device=got.device))
            a[self._end_pos] = full.amax(dim=1)
        return a

    def _expand(self, per_block):
        return per_block.repeat_interleave(self.lengths,
                                           output_size=self.numel)

    def quantize(self, x, group):
        """This rank's piece -> ``(q int8, scales in x's dtype)``, the
        scale cast before the divide, as ``_quantize_blocks``."""
        scales = (self.absmax(x, group) * _INV_QMAX).to(x.dtype)
        safe = self._expand(torch.clamp(scales.float(), min=1e-30))
        q = torch.clamp(torch.round(x.float() / safe), -_QMAX, _QMAX)
        return q.to(torch.int8), scales

    def pack(self, q, scales):
        """``q`` and ``scales`` in one uint8 buffer, the scales padded to
        the group's largest count (every rank's buffer one size)."""
        n = q.numel()
        es = scales.element_size()
        buf = torch.zeros(n + self.max_count * es, dtype=torch.uint8,
                          device=q.device)
        buf[:n] = q.view(torch.uint8)
        buf[n:n + scales.numel() * es] = scales.contiguous().view(
            torch.uint8)
        return buf

    def unpack(self, rows, n, dtype):
        """Every rank's packed buffer of ``n`` lanes and their scales in
        ``dtype``, ``rows`` ``(world, ...)`` in group order -> the
        dequantized ``(world * n,)`` lanes in ``dtype``."""
        es = torch.empty((), dtype=dtype).element_size()
        q = rows[:, :n].reshape(-1).view(torch.int8)
        scales = torch.cat([rows[r, n:n + c * es].view(dtype)
                            for r, c in enumerate(self.counts)])
        per_lane = scales.float().repeat_interleave(
            self.all_lengths, output_size=self.all_numel)
        return (q.float() * per_lane).to(dtype)

    def error_feedback(self, x, err, scale, group):
        """``quantize_with_error_feedback`` of this rank's piece ``x`` of
        the range: ``corrected = x + err * scale`` quantized with fp32
        scales; returns ``(dequantized in x's dtype, (corrected -
        dequantized) / scale)``, both rounded as the JAX program does."""
        scale = _scalar(scale, x)
        corrected = fma(err.float(), scale, x.float())
        scales = self.absmax(corrected, group) * _INV_QMAX
        safe = self._expand(torch.clamp(scales, min=1e-30))
        q = torch.clamp(torch.round(corrected / safe), -_QMAX, _QMAX)
        per_lane = self._expand(scales)
        resid = fma(-q, per_lane, corrected)
        return (q * per_lane).to(x.dtype), resid / scale


def qwz_block(shape, block_size=DEFAULT_BLOCK_SIZE):
    """The block ``qwz_gather`` tiles a leaf's last dimension with."""
    return _lastdim_block(shape[-1] if shape else 1, block_size)


def ring_block(shape, ways, block_size=DEFAULT_BLOCK_SIZE):
    """The block the JAX ring gather's qwZ tiles a leaf with: it quantizes
    each rank's shard, and the plan shards the first dimension ``ways``
    divides, so a leaf sharded along its last dimension is tiled by the
    shard's ``last / ways``."""
    if not shape:
        return 1
    dim = next((i for i, n in enumerate(shape) if n % ways == 0), -1)
    last = shape[-1] // ways if dim == len(shape) - 1 else shape[-1]
    return _lastdim_block(last, block_size)


def unit_grid(flat, u, block_fn):
    """The :class:`BlockGrid` of unit ``u``: each leaf's block is
    ``block_fn(shape)``."""
    _, start, n, leaves = flat.units[u]
    return BlockGrid([(flat.offsets[i] - start,
                       int(np.prod(flat.shapes[i])) if flat.shapes[i] else 1,
                       block_fn(flat.shapes[i])) for i in leaves], n)


class _Pending:
    """One unit's gather in flight; :meth:`finish` gives the full
    compute-dtype buffer in unit order."""

    def __init__(self, gatherer, u, rows, hops, ring):
        self.g, self.u, self.rows = gatherer, u, rows
        self.hops, self.ring = hops, ring
        self.event = None

    def finish(self):
        g = self.g
        if self.event is not None:
            stream = torch.cuda.current_stream(self.rows.device)
            stream.wait_event(self.event)
            self.rows.record_stream(stream)
        elif self.ring is not None:
            g._ring_rest(self)
        return g._unpack(self.u, self.rows)


class UnitGather:
    """The gather of a stage-3 partition's units (see the module
    docstring): ``quantized`` (qwZ: the unit's data-sharded leaves, never
    the persistent unit) and ``ring`` (the ring gather's ``chunks``, or
    None for one all-gather). :meth:`start` begins unit ``u``'s gather and
    returns a handle whose ``finish()`` gives the full buffer."""

    def __init__(self, flat, quantized=False, ring=None,
                 block_size=DEFAULT_BLOCK_SIZE):
        # a proxy: the partition holds this object, and a reference cycle
        # would keep a dropped engine's buffers until the next collection
        self.flat = weakref.proxy(flat)
        self.quantized = bool(quantized)
        self.ring = None if ring is None else max(int(ring), 1)
        self.block_size = int(block_size)
        self.group = flat.gather_group
        self.n, self.idx, self.perm = ring_context(self.group)
        self._codecs = {}
        self._stream = None
        if self.ring is not None and flat.device.type == "cuda" and \
                dist.get_backend(self.group) != GLOO:
            # the ring runs on its own stream: the compute stream waits
            # for it only where the unit is used
            self._stream = torch.cuda.Stream(device=flat.device)

    def _quantizes(self, u):
        return self.quantized and u != self.flat.persist_unit

    def codec(self, u):
        """Unit ``u``'s :class:`PieceCodec` over the gather group (made
        once): the JAX qwZ blocks, or the ring branch's."""
        c = self._codecs.get(u)
        if c is None:
            flat = self.flat
            if self.ring is not None:
                def block_fn(shape):
                    return ring_block(shape, self.n, self.block_size)
            else:
                def block_fn(shape):
                    return qwz_block(shape, self.block_size)
            pieces = [flat.secondary_ranges(u, s) for s in range(self.n)]
            c = self._codecs[u] = PieceCodec(unit_grid(flat, u, block_fn),
                                             pieces, self.idx, flat.device)
        return c

    def _payload(self, u):
        piece = self.flat.secondary_piece(u)
        if not self._quantizes(u):
            return piece
        q, scales = self.codec(u).quantize(piece, self.group)
        return self.codec(u).pack(q, scales)

    def _unpack(self, u, rows):
        flat = self.flat
        n_sec = flat.secondary_numel(u)
        if self._quantizes(u):
            lanes = self.codec(u).unpack(rows, n_sec, flat.compute_dtype)
        else:
            lanes = rows.reshape(-1)
        return flat.unit_order(u, lanes)

    def start(self, u):
        payload = self._payload(u) if self._stream is None else None
        if self.ring is None:
            rows = torch.empty((self.n,) + tuple(payload.shape),
                               dtype=payload.dtype, device=payload.device)
            WIRE.add((self.n - 1) * payload.numel() *
                     payload.element_size(), kind="allgather")
            all_gather_into(rows.view(-1), payload, self.group)
            return _Pending(self, u, rows, None, None)
        if self._stream is not None:
            return self._ring_on_stream(u)
        return self._ring_begin(u, payload)

    def _ring_begin(self, u, payload):
        rows = torch.empty((self.n,) + tuple(payload.shape),
                           dtype=payload.dtype, device=payload.device)
        rows[self.idx] = payload
        pend = _Pending(self, u, rows, 1, None)
        if self.n > 1:
            WIRE.add(payload.numel() * payload.element_size(),
                     kind="allgather")
            pend.ring = ring_rotate_start(payload, self.group, self.perm,
                                          self.ring)
        return pend

    def _ring_rest(self, pend):
        """The remaining hops: each arrival lands in its rank's row and
        goes on to the next rank (``zero3_ring_gather``'s loop)."""
        t, hop = pend.hops, pend.ring
        while hop is not None:
            cur = hop.wait()
            pend.rows[(self.idx - t) % self.n] = cur
            t += 1
            hop = None
            if t < self.n:
                WIRE.add(cur.numel() * cur.element_size(), kind="allgather")
                hop = ring_rotate_start(cur, self.group, self.perm,
                                        self.ring)
        pend.hops, pend.ring = t, None

    def _ring_on_stream(self, u):
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.flat.device))
        with torch.cuda.stream(stream):
            pend = self._ring_begin(u, self._payload(u))
            self._ring_rest(pend)
            pend.event = torch.cuda.Event()
            pend.event.record(stream)
        return pend


class GradCodec:
    """qgZ over a partition's reduce-scattered gradient pieces: for each
    of the partition's reduce ranges (stage 3: a unit; stages 0-2: the
    whole layout) the flat codec's blocks of 256 from each leaf's start,
    over the data group's primary pieces (:class:`PieceCodec`)."""

    def __init__(self, flat, block_size=DEFAULT_BLOCK_SIZE):
        self.flat = weakref.proxy(flat)
        self.block_size = int(block_size)
        self._codecs = {}

    def codec(self, u):
        c = self._codecs.get(u)
        if c is None:
            flat = self.flat
            n = flat.dp_world if flat.grads_sharded or flat.stage3 else 1
            rank = flat.dp_rank if n > 1 else 0
            grid = unit_grid(flat, u, lambda shape: self.block_size)
            _, start, size, _ = flat.units[u]
            part = size // n
            pieces = [[(r * part, (r + 1) * part)] for r in range(n)]
            c = self._codecs[u] = PieceCodec(grid, pieces, rank,
                                             flat.device)
        return c

    def apply(self, u, piece, err, scale):
        """This rank's summed gradient ``piece`` of reduce range ``u``
        through the codec with its error buffer ``err`` (updated in
        place); returns the dequantized piece in the compute dtype."""
        out, new_err = self.codec(u).error_feedback(
            piece.to(self.flat.compute_dtype), err, scale, self.flat.group)
        err.copy_(new_err)
        return out
