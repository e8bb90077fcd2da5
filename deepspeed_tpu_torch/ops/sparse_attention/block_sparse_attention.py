"""Block-sparse attention over a layout: the CUDA kernels, their wrappers,
their plain versions, and the autograd op built on them.

Port of ``deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py``.
The layout is a ``(heads, nb, nb)`` 0/1 matrix from ``sparsity_config.py``:
entry ``[h, qi, ki]`` says that query block ``qi`` of head ``h`` attends to
key block ``ki``. q, k and v are ``(b, h, s, d)`` with ``s = nb * block``,
read through their strides (the ``(b, h, s, d)`` views of one QKV
projection need no copy); ``out`` is returned as a ``(b, h, s, d)`` view of
a contiguous ``(b, s, h, d)`` tensor, so ``out.transpose(1, 2).reshape(b,
s, h * d)`` is free; ``lse`` and ``delta`` are ``(b, h, s)`` fp32. ``kpm``
is an optional additive fp32 ``(b, s)`` key bias, ``bias`` an optional
additive fp32 ``(s, s)`` score bias; neither receives a gradient.

* :func:`block_sparse_fwd`, :func:`block_sparse_bwd_dq` and
  :func:`block_sparse_bwd_dkdv` launch the three kernels of
  ``csrc/block_sparse_attention.cu`` on CUDA tensors and add one to their
  ``.launches`` where they do. On CPU tensors each returns its plain
  version; on a CUDA tensor it launches the kernel or raises. The one trio
  stands for both TPU implementations: the packed-heads pair (``_fwd_pk`` /
  ``_bwd_pk``, shared layouts) and the per-head pair (``_fwd`` / ``_bwd``):
  the layout tables have one head for a shared layout and ``h`` heads
  otherwise.
* :func:`block_sparse_fwd_reference`, :func:`block_sparse_bwd_dq_reference`
  and :func:`block_sparse_bwd_dkdv_reference` are the plain PyTorch
  versions. They never build an ``(s, s)`` tensor: they gather the active
  blocks of each tile's walk, in chunks of tiles, and round where the
  kernels round (the forward walks the same 64-key steps with the same
  online softmax).
* :func:`make_block_sparse_attention` returns ``attn(q, k, v, kpm=None,
  bias=None)`` with the JAX function's contract, a
  ``torch.autograd.Function`` that saves ``(q, k, v, kpm, bias, out,
  lse)`` as the JAX ``fwd_rule`` does.

The kernels' walk (:class:`LayoutTables`): the rows of one side (query
tokens for the forward and dq, key tokens for dk/dv) are cut into tiles of
64 tokens, each tile a group of layout blocks (or half a block at block
128). A tile walks the union of its blocks' active blocks on the other
side, 64 tokens (dk/dv: 64 or 32 queries) per step, masking the pairs the
layout does not hold. Blocks are grouped either in sequence order or in
order of population, whichever gives fewer steps in all (the ``fixed``
layout's forward keeps sequence order; its transposed walk groups the
global columns together). Tiles launch longest walk first.
"""
import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_sparse_attention.cu"

NEG_INF = -1e30
TILE = 64                       # tokens per tile and per forward/dq step
HEAD_DIMS = (32, 64, 128)       # d_head values the kernels are built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# elements per gathered fp32 operand in one chunk of the plain versions
PLAIN_CHUNK_ELEMS = 1 << 26


# ------------------------------------------------------ index builders


def build_block_index(layout):
    """Per (head, q-block) active k-block index lists, padded to the max
    row population. Returns (counts[H, nb], indices[H, nb, max_n])."""
    layout = np.asarray(layout)
    heads, nbq, nbk = layout.shape
    counts = layout.sum(axis=-1).astype(np.int32)
    max_n = max(int(counts.max()), 1)
    indices = np.zeros((heads, nbq, max_n), dtype=np.int32)
    for h in range(heads):
        for qi in range(nbq):
            active = np.nonzero(layout[h, qi])[0]
            indices[h, qi, :len(active)] = active
    return counts, indices


def build_pair_index(layout):
    """Each head's active (row-block, col-block) pairs, sorted by row.
    Empty rows contribute one masked dummy pair; heads with fewer pairs
    pad with masked repeats of their last pair.

    Returns (rows[H, P], cols[H, P], valid[H, P]) int32 arrays."""
    layout = np.asarray(layout)
    heads, nbq, nbk = layout.shape
    per_head = []
    for h in range(heads):
        pairs = []
        for qi in range(nbq):
            active = np.nonzero(layout[h, qi])[0]
            if len(active) == 0:
                pairs.append((qi, 0, 0))
            else:
                pairs.extend((qi, int(ki), 1) for ki in active)
        per_head.append(pairs)
    P = max(len(p) for p in per_head)
    rows = np.zeros((heads, P), dtype=np.int32)
    cols = np.zeros((heads, P), dtype=np.int32)
    valid = np.zeros((heads, P), dtype=np.int32)
    for h, pairs in enumerate(per_head):
        arr = np.asarray(pairs, dtype=np.int32)
        n = len(pairs)
        rows[h, :n], cols[h, :n], valid[h, :n] = arr.T
        if n < P:
            rows[h, n:] = arr[-1, 0]
            cols[h, n:] = arr[-1, 1]
    return rows, cols, valid


def build_group_index(layout, pack):
    """:func:`build_pair_index` with each row's active k-blocks packed
    into groups of ``pack``; slots past a row's population repeat its last
    column with ``valid`` 0, empty rows get one all-invalid group.

    Returns (rows[H, P], cols[H, P, pack], valid[H, P, pack]) int32."""
    layout = np.asarray(layout)
    heads, nbq, nbk = layout.shape
    per_head = []
    for h in range(heads):
        groups = []
        for qi in range(nbq):
            active = np.nonzero(layout[h, qi])[0]
            if len(active) == 0:
                groups.append((qi, [0] * pack, [0] * pack))
                continue
            for s0 in range(0, len(active), pack):
                chunk = active[s0:s0 + pack].tolist()
                val = [1] * len(chunk)
                while len(chunk) < pack:
                    chunk.append(chunk[-1])
                    val.append(0)
                groups.append((qi, chunk, val))
        per_head.append(groups)
    P = max(len(g) for g in per_head)
    rows = np.zeros((heads, P), dtype=np.int32)
    cols = np.zeros((heads, P, pack), dtype=np.int32)
    valid = np.zeros((heads, P, pack), dtype=np.int32)
    for h, groups in enumerate(per_head):
        for p, (qi, cs, vs) in enumerate(groups):
            rows[h, p] = qi
            cols[h, p] = cs
            valid[h, p] = vs
        for p in range(len(groups), P):
            rows[h, p] = rows[h, len(groups) - 1]
            cols[h, p] = cols[h, len(groups) - 1]
    return rows, cols, valid


# --------------------------------------------------------- the walks


class Walk:
    """One side's tiles and their walks over the other side, per layout
    head (numpy, int32):

    * ``units`` (H_l, n_tiles, TILE // unit): each tile's anchor units
      (``unit = gcd(block, TILE)`` tokens; -1 = none);
    * ``ptr`` (H_l, n_tiles + 1) and ``idx``: tile ``t`` of head ``h``
      walks blocks ``idx[ptr[h, t]:ptr[h, t + 1]]``, ascending;
    * ``order`` (H_l, n_tiles): tiles by decreasing walk length."""

    def __init__(self, lay, block):
        heads, nb, _ = lay.shape
        self.unit = unit = math.gcd(block, TILE)
        per_tile = TILE // unit
        per_block = block // unit
        n_units = nb * per_block
        self.n_tiles = n_tiles = -(-n_units // per_tile)
        unit_block = np.arange(n_units) // per_block
        units, walks = [], []
        for h in range(heads):
            rows = lay[h]
            pops = rows.sum(1)[unit_block]
            first = np.where(pops > 0, rows.argmax(1)[unit_block], nb)
            best = None
            for cand in (np.arange(n_units),
                         np.lexsort((np.arange(n_units), first, -pops))):
                grid = np.full(n_tiles * per_tile, -1, np.int64)
                grid[:n_units] = cand
                grid = grid.reshape(n_tiles, per_tile)
                tile_walks = [np.nonzero(rows[unit_block[g[g >= 0]]].any(0))[0]
                              for g in grid]
                cost = sum(-(-len(w) * block // TILE) for w in tile_walks)
                if best is None or cost < best[0]:
                    best = (cost, grid, tile_walks)
            units.append(best[1])
            walks.append(best[2])
        self.units = np.stack(units).astype(np.int32)
        lengths = np.array([[len(w) for w in ws] for ws in walks], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths.reshape(-1))])
        self.ptr = np.stack([offsets[h * n_tiles:(h + 1) * n_tiles + 1]
                             for h in range(heads)]).astype(np.int32)
        self.idx = np.concatenate([w for ws in walks for w in ws] +
                                  [np.zeros(0, np.int64)]).astype(np.int32)
        self.order = np.argsort(-lengths, axis=1, kind="stable").astype(
            np.int32)
        self.lengths = lengths

    def anchor_positions(self, h):
        """(n_tiles, TILE) token position of each tile row, -1 = none."""
        u = self.units[h].astype(np.int64)
        r = np.arange(TILE)
        slot = u[:, r // self.unit]
        return np.where(slot >= 0, slot * self.unit + r % self.unit, -1)

    def walk(self, h, t):
        return self.idx[self.ptr[h, t]:self.ptr[h, t + 1]]


class LayoutTables:
    """A layout's host tables and their copies per device: one layout head
    when every head shares the layout, else one per head; the forward walk
    (query tiles over key blocks) and the transposed walk (key tiles over
    query blocks)."""

    def __init__(self, layout, block):
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError("layout must be (heads, nb, nb); got {}".format(
                layout.shape))
        self.heads, self.nb, _ = layout.shape
        self.block = int(block)
        self.seq = self.nb * self.block
        self.shared = bool((layout == layout[:1]).all())
        lay = (layout[:1] if self.shared else layout) != 0
        self.layout = lay
        self.layout_heads = lay.shape[0]
        self.fwd = Walk(lay, self.block)
        self.bwd = Walk(lay.transpose(0, 2, 1), self.block)
        # active block pairs summed over heads: the work the walks need
        self.n_active = int(lay.sum()) * (self.heads if self.shared else 1)
        self._device = {}

    def on(self, device):
        """The tables as int32 / uint8 tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._device:
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self._device[key] = {
                "layout": t(self.layout.astype(np.uint8)),
                "fwd": [t(a) for a in (self.fwd.units, self.fwd.ptr,
                                       self.fwd.idx, self.fwd.order)],
                "bwd": [t(a) for a in (self.bwd.units, self.bwd.ptr,
                                       self.bwd.idx, self.bwd.order)]}
        return self._device[key]

    def head_groups(self):
        """(layout head, head slice) pairs covering every head."""
        if self.shared:
            return [(0, slice(0, self.heads))]
        return [(h, slice(h, h + 1)) for h in range(self.heads)]


# ------------------------------------------------------------- kernels


class _Params(ctypes.Structure):
    """``SparseParams`` of ``csrc/block_sparse_attention.cu``, field for
    field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "dout", "kpm", "bias", "lse_in", "delta", "out",
        "lse", "dq", "dk", "dv", "layout", "units", "ptr", "idx", "order")] + \
        [(name, ctypes.c_int64) for name in (
            "q_sb", "q_sh", "q_ss", "k_sb", "k_sh", "k_ss", "v_sb", "v_sh",
            "v_ss", "do_sb", "do_sh", "do_ss", "o_sb", "o_sh", "o_ss",
            "kpm_sb", "bias_ss")] + \
        [(name, ctypes.c_int) for name in (
            "b", "s", "h", "block", "unit", "nb", "n_tiles", "layout_heads",
            "causal")] + [("scale", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    for name in ("block_sparse_fwd_launch", "block_sparse_bwd_dq_launch",
                 "block_sparse_bwd_dkdv_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.block_sparse_error_string.argtypes = [ctypes.c_int]
    lib.block_sparse_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, params, dtype, d_head, device):
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(ctypes.byref(params), _DTYPE_CODES[dtype],
                             d_head, stream)
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            name, err, lib.block_sparse_error_string(err).decode()))


def _check(name, tables, q, k, v, kpm, bias, extra=()):
    """Validate the operands against the layout; returns (b, h, s, d)."""
    if q.dim() != 4:
        raise ValueError("{}: q, k, v must be (b, h, s, d); got {}".format(
            name, tuple(q.shape)))
    b, h, s, d = q.shape
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError("{}: unsupported device {}".format(name, device))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError("{}: dtype {} is not one of {}".format(
            name, q.dtype, sorted(str(t) for t in _DTYPE_CODES)))
    for label, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError("{}: {} is {} {} on {}; q is {} {} on {}".format(
                name, label, tuple(t.shape), t.dtype, t.device,
                tuple(q.shape), q.dtype, device))
    if s != tables.seq or h != tables.heads:
        raise ValueError(
            "{}: seq {} and heads {} must match the layout's {} blocks of {} "
            "tokens ({}) and {} heads".format(name, s, h, tables.nb,
                                              tables.block, tables.seq,
                                              tables.heads))
    for label, t, shape in (("kpm", kpm, (b, s)), ("bias", bias, (s, s))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != device):
            raise ValueError("{}: {} must be fp32 {} on {}; got {} {} on {}"
                             .format(name, label, shape, device,
                                     tuple(t.shape), t.dtype, t.device))
    if device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError("{}: the kernels take d_head in {}; got {}"
                             .format(name, HEAD_DIMS, d))
        if tables.block % 16:
            raise ValueError("{}: the kernels take blocks that are "
                             "multiples of 16; got {}".format(name,
                                                              tables.block))
        for label, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
            if t.stride(3) != 1:
                raise ValueError("{}: {} needs unit stride on d_head".format(
                    name, label))
        for label, t in (("kpm", kpm), ("bias", bias)):
            if t is not None and t.stride(1) != 1:
                raise ValueError("{}: {} needs unit stride on its last dim"
                                 .format(name, label))
    return b, h, s, d


def _check_rows(name, label, t, b, h, s, device):
    if t.shape != (b, h, s) or t.dtype != torch.float32 or \
            t.device != device or not t.is_contiguous():
        raise ValueError("{}: {} must be a contiguous fp32 {} on {}; got {} "
                         "{} on {}".format(name, label, (b, h, s), device,
                                           tuple(t.shape), t.dtype,
                                           t.device))


def _scale_of(sm_scale, d):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _bshd(like):
    """A contiguous (b, s, h, d) tensor viewed as (b, h, s, d)."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _params(tables, walk, q, k, v, kpm, bias, causal, scale, out_like):
    b, h, s, d = q.shape
    dev = tables.on(q.device)
    units, ptr, idx, order = dev[walk]
    p = _Params()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.kpm = None if kpm is None else kpm.data_ptr()
    p.bias = None if bias is None else bias.data_ptr()
    p.layout = dev["layout"].data_ptr()
    p.units, p.ptr, p.idx, p.order = (units.data_ptr(), ptr.data_ptr(),
                                      idx.data_ptr(), order.data_ptr())
    p.q_sb, p.q_sh, p.q_ss = q.stride(0), q.stride(1), q.stride(2)
    p.k_sb, p.k_sh, p.k_ss = k.stride(0), k.stride(1), k.stride(2)
    p.v_sb, p.v_sh, p.v_ss = v.stride(0), v.stride(1), v.stride(2)
    p.o_sb, p.o_sh, p.o_ss = (out_like.stride(0), out_like.stride(1),
                              out_like.stride(2))
    p.kpm_sb = 0 if kpm is None else kpm.stride(0)
    p.bias_ss = 0 if bias is None else bias.stride(0)
    w = getattr(tables, walk)
    p.b, p.s, p.h, p.block, p.unit, p.nb = b, s, h, tables.block, w.unit, \
        tables.nb
    p.n_tiles, p.layout_heads = w.n_tiles, tables.layout_heads
    p.causal, p.scale = int(bool(causal)), scale
    return p


def _bwd_params(tables, walk, q, k, v, kpm, bias, dout, lse, delta, causal,
                scale, out_like):
    p = _params(tables, walk, q, k, v, kpm, bias, causal, scale, out_like)
    p.dout, p.lse_in, p.delta = dout.data_ptr(), lse.data_ptr(), \
        delta.data_ptr()
    p.do_sb, p.do_sh, p.do_ss = dout.stride(0), dout.stride(1), \
        dout.stride(2)
    return p


# ------------------------------------------------------------- wrappers


def block_sparse_fwd(q, k, v, kpm=None, bias=None, *, tables, causal=False,
                     sm_scale=None):
    """Block-sparse forward -> ``(out (b, h, s, d) in q's dtype, a view of
    a contiguous (b, s, h, d) tensor; lse (b, h, s) fp32)``. On CUDA the
    kernel runs on the current stream, without a synchronise."""
    b, h, s, d = _check("block_sparse_fwd", tables, q, k, v, kpm, bias)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        return block_sparse_fwd_reference(q, k, v, kpm, bias, tables=tables,
                                          causal=causal, sm_scale=scale)
    out = _bshd(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    p = _params(tables, "fwd", q, k, v, kpm, bias, causal, scale, out)
    p.out, p.lse = out.data_ptr(), lse.data_ptr()
    _launch("block_sparse_fwd_launch", p, q.dtype, d, q.device)
    block_sparse_fwd.launches += 1
    return out, lse


block_sparse_fwd.launches = 0


def _bwd_check(name, tables, q, k, v, kpm, bias, dout, lse, delta):
    b, h, s, d = _check(name, tables, q, k, v, kpm, bias,
                        extra=(("dout", dout),))
    _check_rows(name, "lse", lse, b, h, s, q.device)
    _check_rows(name, "delta", delta, b, h, s, q.device)
    return d


def block_sparse_bwd_dq(q, k, v, kpm, bias, dout, lse, delta, *, tables,
                        causal=False, sm_scale=None):
    """dq of block-sparse attention, (b, h, s, d) in q's dtype (a view of a
    contiguous (b, s, h, d) tensor)."""
    d = _bwd_check("block_sparse_bwd_dq", tables, q, k, v, kpm, bias, dout,
                   lse, delta)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        return block_sparse_bwd_dq_reference(
            q, k, v, kpm, bias, dout, lse, delta, tables=tables,
            causal=causal, sm_scale=scale)
    dq = _bshd(q)
    if dq.numel() == 0:
        return dq
    p = _bwd_params(tables, "fwd", q, k, v, kpm, bias, dout, lse, delta,
                    causal, scale, dq)
    p.dq = dq.data_ptr()
    _launch("block_sparse_bwd_dq_launch", p, q.dtype, d, q.device)
    block_sparse_bwd_dq.launches += 1
    return dq


block_sparse_bwd_dq.launches = 0


def block_sparse_bwd_dkdv(q, k, v, kpm, bias, dout, lse, delta, *, tables,
                          causal=False, sm_scale=None):
    """(dk, dv) of block-sparse attention, each (b, h, s, d) in q's dtype,
    by the transposed walk."""
    d = _bwd_check("block_sparse_bwd_dkdv", tables, q, k, v, kpm, bias,
                   dout, lse, delta)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        return block_sparse_bwd_dkdv_reference(
            q, k, v, kpm, bias, dout, lse, delta, tables=tables,
            causal=causal, sm_scale=scale)
    dk, dv = _bshd(q), _bshd(q)
    if dk.numel() == 0:
        return dk, dv
    p = _bwd_params(tables, "bwd", q, k, v, kpm, bias, dout, lse, delta,
                    causal, scale, dk)
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _launch("block_sparse_bwd_dkdv_launch", p, q.dtype, d, q.device)
    block_sparse_bwd_dkdv.launches += 1
    return dk, dv


block_sparse_bwd_dkdv.launches = 0


def attention_delta(out, dout):
    """delta = rowsum(dout * out) in fp32 -> contiguous (b, h, s), a plain
    torch op outside the kernels (the JAX package computes it outside its
    kernels too)."""
    return (dout.float() * out.float()).sum(-1).contiguous()


# ------------------------------------------------------- plain versions


def _chunks(walk, h, other_block, width):
    """Tiles of layout head ``h`` in launch order (longest walk first, so
    a chunk pads little), cut into chunks whose gathered operands stay
    under PLAIN_CHUNK_ELEMS: yields (anchor positions (T, TILE), walk
    positions (T, n)), -1 marking padding."""
    order = walk.order[h]
    pos = walk.anchor_positions(h)
    i = 0
    while i < len(order):
        longest = max(int(walk.lengths[h, order[i]]) * other_block, 1)
        n_t = max(1, PLAIN_CHUNK_ELEMS // (longest * width))
        tiles = order[i:i + n_t]
        i += n_t
        keys = np.full((len(tiles), longest), -1, np.int64)
        for j, t in enumerate(tiles):
            blocks = walk.walk(h, t).astype(np.int64)
            keys[j, :len(blocks) * other_block] = (
                blocks[:, None] * other_block +
                np.arange(other_block)[None, :]).reshape(-1)
        yield pos[tiles], keys


def _gather(x, heads, positions):
    """x (b, h, s, d) -> fp32 (b, hg, *positions.shape, d), zero rows where
    a position is -1."""
    idx = positions.clamp(min=0)
    g = x[:, heads][:, :, idx].float()
    return g * (positions >= 0)[..., None].to(g.dtype)


def _masks(tables, h, rows, cols, causal):
    """(T, R, C) bool: the layout holds the pair, both positions are real
    and, when causal, the key is not after the query; ``rows`` are query
    positions (T, R), ``cols`` key positions (T, C)."""
    lay = torch.from_numpy(tables.layout[h]).to(rows.device)
    rb = (rows.clamp(min=0) // tables.block)[:, :, None]
    cb = (cols.clamp(min=0) // tables.block)[:, None, :]
    keep = lay[rb, cb] & (rows >= 0)[:, :, None] & (cols >= 0)[:, None, :]
    if causal:
        keep = keep & (rows[:, :, None] >= cols[:, None, :])
    return keep


def _score_terms(kpm, bias, rows, cols):
    """The additive score terms, each broadcastable to (b, hg, T, R, C):
    kpm per key, then bias per (query, key) — added in that order, as the
    kernels add them."""
    terms = []
    if kpm is not None:
        terms.append(kpm[:, cols.clamp(min=0)][:, None, :, None, :])
    if bias is not None:
        terms.append(bias[rows.clamp(min=0)[:, :, None],
                          cols.clamp(min=0)[:, None, :]][None, None])
    return terms


def block_sparse_fwd_reference(q, k, v, kpm=None, bias=None, *, tables,
                               causal=False, sm_scale=None):
    """The plain PyTorch forward: each query tile's walk in the kernel's
    64-key steps with its online softmax (probabilities rounded to V's
    dtype before P.V). Any device."""
    b, h, s, d = q.shape
    scale = _scale_of(sm_scale, d)
    dev = q.device
    out = torch.zeros((b, h, s, d), device=dev)
    lse = torch.full((b, h, s), NEG_INF, device=dev)
    walk = tables.fwd
    for hl, heads in tables.head_groups():
        hg = heads.stop - heads.start
        for rows_np, keys_np in _chunks(walk, hl, tables.block,
                                               b * hg * d):
            rows = torch.from_numpy(rows_np).to(dev)
            keys = torch.from_numpy(keys_np).to(dev)
            qg = _gather(q, heads, rows)                 # (b, hg, T, 64, d)
            kg, vg = _gather(k, heads, keys), _gather(v, heads, keys)
            keep = _masks(tables, hl, rows, keys, causal)
            terms = _score_terms(kpm, bias, rows, keys)
            T = rows.shape[0]
            m = torch.full((b, hg, T, TILE, 1), NEG_INF, device=dev)
            l = torch.zeros((b, hg, T, TILE, 1), device=dev)
            acc = torch.zeros((b, hg, T, TILE, d), device=dev)
            for c0 in range(0, keys.shape[1], TILE):
                c1 = c0 + TILE
                sc = (qg @ kg[:, :, :, c0:c1].transpose(-1, -2)) * scale
                for term in terms:
                    sc = sc + term[..., c0:c1]
                sc = torch.where(keep[:, :, c0:c1], sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.where(m_new <= NEG_INF, 0.0, torch.exp(sc - m_new))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(v.dtype).float() @ vg[:, :, :,
                                                              c0:c1]
                m = m_new
            l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
            o = acc / l_safe
            ls = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
            valid = rows >= 0
            r = rows[valid]
            out[:, heads, r] = o[:, :, valid]
            lse[:, heads, r] = ls[:, :, valid]
    o = _bshd(q)
    o.copy_(out)
    return o, lse


def _probs_ds(q, k, v, kpm, bias, dout, lse, delta, tables, hl, heads,
              qrows, keys, causal, scale, transposed):
    """p (fp32) and ds (rounded to q's dtype) for query positions ``qrows``
    (T, Q) and key positions ``keys`` (T, K), both (b, hg, T, Q, K), or
    (b, hg, T, K, Q) when ``transposed``; plus the gathered q, k, dout."""
    qg, dog = _gather(q, heads, qrows), _gather(dout, heads, qrows)
    kg, vg = _gather(k, heads, keys), _gather(v, heads, keys)
    lse_g = lse[:, heads][:, :, qrows.clamp(min=0)]
    del_g = delta[:, heads][:, :, qrows.clamp(min=0)]
    keep = _masks(tables, hl, qrows, keys, causal)
    sc = (qg @ kg.transpose(-1, -2)) * scale       # (b, hg, T, Q, K)
    for term in _score_terms(kpm, bias, qrows, keys):
        sc = sc + term
    sc = torch.where(keep, sc, NEG_INF)
    p = torch.where(lse_g[..., None] <= NEG_INF, 0.0,
                    torch.exp(sc - lse_g[..., None]))
    dp = dog @ vg.transpose(-1, -2)
    ds = (p * (dp - del_g[..., None]) * scale).to(q.dtype).float()
    if transposed:
        p, ds = p.transpose(-1, -2), ds.transpose(-1, -2)
    return p, ds, qg, kg, dog


def block_sparse_bwd_dq_reference(q, k, v, kpm, bias, dout, lse, delta, *,
                                  tables, causal=False, sm_scale=None):
    """The plain PyTorch dq: ds (rounded) . k over each query tile's walk,
    accumulated in fp32."""
    b, h, s, d = q.shape
    scale = _scale_of(sm_scale, d)
    dq = torch.zeros((b, h, s, d), device=q.device)
    for hl, heads in tables.head_groups():
        hg = heads.stop - heads.start
        for rows_np, keys_np in _chunks(tables.fwd, hl, tables.block,
                                               b * hg * max(d, TILE)):
            rows = torch.from_numpy(rows_np).to(q.device)
            keys = torch.from_numpy(keys_np).to(q.device)
            _, ds, _, kg, _ = _probs_ds(q, k, v, kpm, bias, dout, lse, delta,
                                        tables, hl, heads, rows, keys,
                                        causal, scale, False)
            valid = rows >= 0
            dq[:, heads, rows[valid]] = (ds @ kg)[:, :, valid]
    out = _bshd(q)
    out.copy_(dq)
    return out


def block_sparse_bwd_dkdv_reference(q, k, v, kpm, bias, dout, lse, delta, *,
                                    tables, causal=False, sm_scale=None):
    """The plain PyTorch (dk, dv): ds^T . q and p (rounded)^T . dout over
    each key tile's transposed walk."""
    b, h, s, d = q.shape
    scale = _scale_of(sm_scale, d)
    dk = torch.zeros((b, h, s, d), device=q.device)
    dv = torch.zeros((b, h, s, d), device=q.device)
    for hl, heads in tables.head_groups():
        hg = heads.stop - heads.start
        for keys_np, rows_np in _chunks(tables.bwd, hl, tables.block,
                                               b * hg * max(d, TILE)):
            keys = torch.from_numpy(keys_np).to(q.device)
            rows = torch.from_numpy(rows_np).to(q.device)
            p, ds, qg, _, dog = _probs_ds(q, k, v, kpm, bias, dout, lse,
                                          delta, tables, hl, heads, rows,
                                          keys, causal, scale, True)
            valid = keys >= 0
            dk[:, heads, keys[valid]] = (ds @ qg)[:, :, valid]
            dv[:, heads, keys[valid]] = (p.to(dout.dtype).float() @
                                         dog)[:, :, valid]
    outs = _bshd(q), _bshd(q)
    outs[0].copy_(dk)
    outs[1].copy_(dv)
    return outs


# ------------------------------------------------------------- autograd


class _BlockSparseAttention(torch.autograd.Function):
    """Residuals ``(q, k, v, kpm, bias, out, lse)``, as the JAX
    ``fwd_rule``; kpm and bias get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kpm, bias, tables, causal, sm_scale):
        out, lse = block_sparse_fwd(q, k, v, kpm, bias, tables=tables,
                                    causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, kpm, bias, out, lse)
        ctx.meta = (tables, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kpm, bias, out, lse = ctx.saved_tensors
        tables, causal, sm_scale = ctx.meta
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        delta = attention_delta(out, dout)
        kw = dict(tables=tables, causal=causal, sm_scale=sm_scale)
        dq = block_sparse_bwd_dq(q, k, v, kpm, bias, dout, lse, delta, **kw)
        dk, dv = block_sparse_bwd_dkdv(q, k, v, kpm, bias, dout, lse, delta,
                                       **kw)
        return dq, dk, dv, None, None, None, None, None


def make_block_sparse_attention(layout, block, causal=False, sm_scale=None,
                                has_kpm=False, has_bias=False, pack=None):
    """``attn(q, k, v, kpm=None, bias=None) -> out`` for a fixed layout.

    q/k/v: (batch, heads, seq, d_head) with seq = ``layout.shape[1] *
    block``; ``kpm`` an additive (batch, seq) fp32 key bias and ``bias``
    an additive (seq, seq) fp32 score bias, each read only when its
    ``has_*`` flag is set. Gradients flow to q/k/v only. ``pack`` (a TPU
    execution shape) is accepted and ignored. The returned function
    carries its :class:`LayoutTables` as ``tables``."""
    del pack
    tables = LayoutTables(layout, block)

    def attn(q, k, v, kpm=None, bias=None):
        if has_kpm and kpm is None or has_bias and bias is None:
            raise ValueError("this attention was built with has_kpm={} "
                             "has_bias={}: pass those operands".format(
                                 has_kpm, has_bias))
        kpm = kpm.detach().float().contiguous() if has_kpm else None
        bias = bias.detach().float().contiguous() if has_bias else None
        return _BlockSparseAttention.apply(q, k, v, kpm, bias, tables,
                                           causal, sm_scale)

    attn.tables = tables
    return attn
