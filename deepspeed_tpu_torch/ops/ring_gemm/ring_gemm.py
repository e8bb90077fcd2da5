"""Ring GEMMs: the collective-matmul loops, their per-step CUDA kernels and
the plain versions.

Port of ``deepspeed_tpu/ops/pallas/ring_gemm.py``. Each TPU kernel there
is one rank's whole ring loop: it starts the next chunk's remote copy,
multiplies the chunk it holds, and waits for the copy after the product.
Here the loop is Python over ``torch.distributed`` hops
(``parallel/ring.py``), the same shape step for step, and each step's
product is a launch of a hand-written CUDA kernel
(``csrc/ring_gemm.cu``):

* :func:`ag_matmul` — ``allgather(x, dim=-2) @ w``: step t multiplies the
  chunk from ring position ``(my - t) % n`` into its block of the output
  (:func:`ring_ag_gemm`);
* :func:`matmul_rs` — ``reduce_scatter(psum_partial(x @ w), dim=-2)``:
  step t adds the partial of block ``(my - 1 - t) % n`` to the
  accumulator that arrived, in the kernel's epilogue
  (:func:`ring_rs_gemm_add`), and sends the sum on;
* :func:`gather_contract` — the dW accumulation both backwards share:
  the rotating operand's chunks contract against the matching block of
  the fixed one into an fp32 sum (:func:`ring_gc_gemm_acc`), cast once at
  the end.

Like the TPU kernels, each loop keeps one receive slot per ring step (no
buffer is rewritten while a send may still read it), casts only rotated
payloads to the wire dtype (the local chunk multiplies uncast), and, in
the reduce-scatter, rounds each partial to the output dtype before the
add. ``use_kernel=False`` runs the same loop with each step's plain
version (``torch.matmul`` products): that is the ``"ppermute"`` backend
and the numerics oracle. On CPU tensors the kernel wrappers run their
plain versions; on CUDA tensors they launch the kernel or raise.
"""
import ctypes
import functools
from pathlib import Path

import torch

from .. import cuda_build
from ...parallel.ring import ring_context, ring_rotate_start

SOURCE = Path(__file__).resolve().parent / "csrc" / "ring_gemm.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# below this many 128 x 128 output tiles the fp32 dW kernel takes 64 x 64
# tiles (the H100 has 132 SMs)
_SMALL_TILE_BELOW = 132
GC_TILE = 128          # the bf16 dW kernel's output tile edge (kGcBM)
GC_K_STEP = 64         # its k step (kGcBK): split lengths are multiples
GC_MIN_SPLIT_K = 1024  # the shortest run of K a split is given
H100_SMS = 132


def gc_plan(M, N, K, sm_count=H100_SMS):
    """The bf16 dW kernel's launch plan for an (M, N) output over K rows:
    ``{"tiles": 128 x 128 output tiles, "splits": runs of K, "k_split":
    rows a run (a multiple of GC_K_STEP; the last run takes the rest)}``.

    One block a tile and split. Where the tiles alone leave more than a
    tenth of the SMs idle, K is split until the grid covers ``sm_count``
    SMs, each split keeping at least GC_MIN_SPLIT_K rows, so the fp32
    partials each split writes and the last one reads (``splits * M * N *
    4`` bytes each way) stay small beside the product's operands. At
    gpt2_medium TP 2 (K = 8192): qkv dW (1024, 1536) 96 tiles -> 2 splits;
    fc and mlp proj dW 128 tiles -> 1; attn proj dW (512, 1024) 32 tiles
    -> 5."""
    tiles = _ceil_div(M, GC_TILE) * _ceil_div(N, GC_TILE)
    splits = 1
    if 10 * tiles < 9 * sm_count:
        splits = max(1, min(_ceil_div(sm_count, tiles), K // GC_MIN_SPLIT_K))
    k_split = _ceil_div(_ceil_div(K, splits), GC_K_STEP) * GC_K_STEP
    return {"tiles": tiles, "splits": _ceil_div(K, k_split),
            "k_split": k_split}


def _ceil_div(a, b):
    return -(-a // b)


def build():
    """Compile the kernel library (reused when already built from this
    source); returns the :class:`cuda_build.BuildRecord`."""
    return cuda_build.build(SOURCE)


_OPERAND = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int] * 2


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    sizes = [ctypes.c_int] * 3
    lib.ring_ag_gemm_launch.argtypes = [ctypes.c_int] + _OPERAND + sizes + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.ring_rs_gemm_add_launch.argtypes = [ctypes.c_int] + _OPERAND + \
        sizes + [ctypes.c_void_p] * 3
    lib.ring_gc_gemm_acc_launch.argtypes = [ctypes.c_int] + _OPERAND + \
        sizes + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    for fn in (lib.ring_ag_gemm_launch, lib.ring_rs_gemm_add_launch,
               lib.ring_gc_gemm_acc_launch):
        fn.restype = ctypes.c_int
    lib.ring_gemm_error_string.argtypes = [ctypes.c_int]
    lib.ring_gemm_error_string.restype = ctypes.c_char_p
    if (lib.ring_gc_tile(), lib.ring_gc_k_step()) != (GC_TILE, GC_K_STEP):
        raise RuntimeError("ring_gemm.cu's dW tile and k step are {}, the "
                           "wrapper's {}".format(
                               (lib.ring_gc_tile(), lib.ring_gc_k_step()),
                               (GC_TILE, GC_K_STEP)))
    return lib


# ------------------------------------------------------------ operands


def _vec_ok(t, offset, strides, extent):
    """16-byte loads along the unit-stride index: the start address and
    every row offset are multiples of 16 bytes, and so is the extent."""
    per = 16 // t.element_size()
    addr = t.data_ptr() + offset * t.element_size()
    return int(addr % 16 == 0 and extent % per == 0 and
               all(s % per == 0 for s in strides))


def _rows(t, offset, rpb, sb, sr, kcontig, extent):
    """The C operand tuple (pointer, rows per batch, batch stride, row
    stride, kcontig, vec) of ``t`` from element ``offset``."""
    strides = (sr,) if rpb == _INT_MAX else (sb, sr)
    return (t.data_ptr() + offset * t.element_size(), rpb, sb, sr,
            int(kcontig), _vec_ok(t, offset, strides, extent))


def _matrix_rows(t, kcontig, extent):
    """A contiguous (rows, extent) matrix whose unit-stride index is the
    K index (``kcontig``) or the M/N one."""
    return _rows(t, 0, _INT_MAX, 0, t.shape[-1], kcontig, extent)


def _weight_operand(w, name):
    """B(k, n) = w[k, n] of a 2D weight or of a transposed view of one:
    either stride may be the unit one."""
    K, N = w.shape
    if w.stride(1) == 1:
        return _rows(w, 0, _INT_MAX, 0, w.stride(0), False, N)
    if w.stride(0) == 1:
        return _rows(w, 0, _INT_MAX, 0, w.stride(1), True, K)
    raise ValueError("{}: w must have a unit stride on one dim (a matrix or "
                     "its transpose), got strides {}".format(
                         name, tuple(w.stride())))


def _check_cuda(name, tensors):
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise ValueError("{}: dtype {} not supported (fp32 or bf16)".format(
            name, dtype))
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(
                "{}: every operand must be {} on {}; got {} on {}".format(
                    name, dtype, dev, t.dtype, t.device))
    if dev.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(name, dev))


def _contig(name, **tensors):
    for key, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError("{}: {} must be contiguous".format(name, key))


def _raise_if(err, name):
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {} ({})"
                           .format(name, err, _library()
                                   .ring_gemm_error_string(err).decode()))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# -------------------------------------------------------- step kernels


def ring_ag_gemm(cur, w, out, blk):
    """One all-gather-matmul step: ``out[:, blk*s_loc:(blk+1)*s_loc] =
    cur @ w`` (fp32 sums, one rounding to the output dtype). cur (b,
    s_loc, d) contiguous; w (d, f), a matrix or a transposed view; out
    (b, n*s_loc, f) contiguous, written in place."""
    b, s_loc, d = cur.shape
    f = w.shape[1]
    if w.shape[0] != d or out.shape[0] != b or out.shape[2] != f or \
            out.shape[1] % s_loc or not 0 <= blk < out.shape[1] // s_loc:
        raise ValueError("ring_ag_gemm: shapes cur {} w {} out {} blk {}"
                         .format(tuple(cur.shape), tuple(w.shape),
                                 tuple(out.shape), blk))
    if cur.device.type == "cpu":
        return ring_ag_gemm_reference(cur, w, out, blk)
    _check_cuda("ring_ag_gemm", (cur, w, out))
    _contig("ring_ag_gemm", cur=cur, out=out)
    S = out.shape[1]
    M = b * s_loc
    a_op = _matrix_rows(cur, True, d)
    b_op = _weight_operand(w, "ring_ag_gemm")
    err = _library().ring_ag_gemm_launch(
        _DTYPES[cur.dtype], *a_op, *b_op, M, f, d,
        out.data_ptr() + blk * s_loc * f * out.element_size(), s_loc,
        S * f, f, _stream(cur))
    _raise_if(err, "ring_ag_gemm")
    ring_ag_gemm.launches += 1
    return out


ring_ag_gemm.launches = 0


def ring_ag_gemm_reference(cur, w, out, blk):
    """The plain version: a ``torch.matmul`` into the output block."""
    s_loc = cur.shape[1]
    out[:, blk * s_loc:(blk + 1) * s_loc] = torch.matmul(cur, w)
    return out


def ring_rs_gemm_add(x, w, blk, n, out, recv=None):
    """One matmul-reduce-scatter step: ``out = recv + (x[:, blk] @
    w).to(out.dtype)`` (the partial rounds before the add; no ``recv`` on
    the first step). x (b, n*s_loc, f) contiguous; w (f, d), a matrix or a
    transposed view; out and recv (b, s_loc, d) contiguous, and ``out``
    may be ``recv`` (the ring loop adds in place into the arrived slot)."""
    b, s, f = x.shape
    d = w.shape[1]
    if s % n or w.shape[0] != f or not 0 <= blk < n or \
            tuple(out.shape) != (b, s // n, d) or \
            (recv is not None and tuple(recv.shape) != tuple(out.shape)):
        raise ValueError("ring_rs_gemm_add: shapes x {} w {} out {} blk {} "
                         "n {}".format(tuple(x.shape), tuple(w.shape),
                                       tuple(out.shape), blk, n))
    if x.device.type == "cpu":
        return ring_rs_gemm_add_reference(x, w, blk, n, out, recv)
    _check_cuda("ring_rs_gemm_add",
                (x, w, out) + (() if recv is None else (recv,)))
    _contig("ring_rs_gemm_add", x=x, out=out, recv=recv)
    s_loc = s // n
    a_op = _rows(x, blk * s_loc * f, s_loc, s * f, f, True, f)
    b_op = _weight_operand(w, "ring_rs_gemm_add")
    err = _library().ring_rs_gemm_add_launch(
        _DTYPES[x.dtype], *a_op, *b_op, b * s_loc, d, f, out.data_ptr(),
        None if recv is None else recv.data_ptr(), _stream(x))
    _raise_if(err, "ring_rs_gemm_add")
    ring_rs_gemm_add.launches += 1
    return out


ring_rs_gemm_add.launches = 0


def ring_rs_gemm_add_reference(x, w, blk, n, out, recv=None):
    """The plain version: the block's ``torch.matmul`` in the input dtype,
    then the add in that dtype."""
    s_loc = x.shape[1] // n
    part = torch.matmul(x[:, blk * s_loc:(blk + 1) * s_loc], w)
    out.copy_(part if recv is None else recv + part)
    return out


def ring_gc_gemm_acc(cur, fixed, blk, acc, first, out=None, rot_is_lhs=True):
    """One gather-contract step: ``acc += cur^T @ fixed[:, blk]`` over the
    (b, s_loc) rows, in fp32 (``acc =`` on the first step), or its
    transpose when ``rot_is_lhs`` is False; with ``out`` given, also
    ``out = acc.to(out.dtype)`` (the last step). cur (b, s_loc, a) and
    fixed (b, n*s_loc, c) contiguous; acc fp32 (a, c) or (c, a). bf16
    runs the Hopper kernel on :func:`gc_plan`'s tiles and splits (the
    workspace of a split K allocated here); fp32 the FMA tiles."""
    b, s_loc, a = cur.shape
    c = fixed.shape[2]
    shape = (a, c) if rot_is_lhs else (c, a)
    if fixed.shape[0] != b or fixed.shape[1] % s_loc or \
            not 0 <= blk < fixed.shape[1] // s_loc or \
            tuple(acc.shape) != shape or acc.dtype != torch.float32 or \
            (out is not None and tuple(out.shape) != shape):
        raise ValueError("ring_gc_gemm_acc: shapes cur {} fixed {} acc {} "
                         "{} blk {}".format(tuple(cur.shape),
                                            tuple(fixed.shape),
                                            tuple(acc.shape), acc.dtype, blk))
    if cur.device.type == "cpu":
        return ring_gc_gemm_acc_reference(cur, fixed, blk, acc, first, out,
                                          rot_is_lhs)
    _check_cuda("ring_gc_gemm_acc",
                (cur, fixed) + (() if out is None else (out,)))
    if acc.device != cur.device:
        raise ValueError("ring_gc_gemm_acc: acc must be on {}".format(
            cur.device))
    _contig("ring_gc_gemm_acc", cur=cur, fixed=fixed, acc=acc, out=out)
    S = fixed.shape[1]
    rot = _matrix_rows(cur, False, a)                 # (k rows, a contig)
    fix = _rows(fixed, blk * s_loc * c, s_loc, S * c, c, False, c)
    a_op, b_op = (rot, fix) if rot_is_lhs else (fix, rot)
    M, N = shape
    K = b * s_loc
    plan = gc_plan(M, N, K, _sm_count(cur.device))
    ws = tickets = None
    if cur.dtype == torch.bfloat16 and plan["splits"] > 1:
        ws = torch.empty((plan["splits"], M, N), dtype=torch.float32,
                         device=cur.device)
        tickets = torch.empty(plan["tiles"], dtype=torch.int32,
                              device=cur.device)
    err = _library().ring_gc_gemm_acc_launch(
        _DTYPES[cur.dtype], *a_op, *b_op, M, N, K, acc.data_ptr(),
        int(bool(first)), None if out is None else out.data_ptr(),
        int(plan["tiles"] < _SMALL_TILE_BELOW), plan["splits"],
        plan["k_split"], _ptr(ws), _ptr(tickets), _stream(cur))
    _raise_if(err, "ring_gc_gemm_acc")
    ring_gc_gemm_acc.launches += 1
    return acc


ring_gc_gemm_acc.launches = 0


def ring_gc_gemm_acc_reference(cur, fixed, blk, acc, first, out=None,
                               rot_is_lhs=True):
    """The plain version: the block's product as an fp32 ``torch.matmul``
    of the (exactly widened) inputs, summed into ``acc``."""
    s_loc, a = cur.shape[1], cur.shape[2]
    fb = fixed[:, blk * s_loc:(blk + 1) * s_loc]
    rot2 = cur.reshape(-1, a).float()
    fix2 = fb.reshape(-1, fb.shape[-1]).float()
    term = rot2.t() @ fix2 if rot_is_lhs else fix2.t() @ rot2
    if first:
        acc.copy_(term)
    else:
        acc.add_(term)
    if out is not None:
        out.copy_(acc)
    return acc


# -------------------------------------------------------- the ring loops


def _result_dtype(a, b):
    return torch.promote_types(a.dtype, b.dtype)


def ag_matmul(x, w, group, wire_dtype=None, chunks=1, use_kernel=True):
    """Ring ``allgather(x, dim=-2) @ w`` (the TPU kernel's loop). x (b,
    s_loc, d), this rank's ring shard; w (d, f_loc). Returns (b, n*s_loc,
    f_loc). Step t starts the hop of the chunk it holds, multiplies it
    into block ``(my - t) % n``, then waits for the hop."""
    n, my, perm = ring_context(group)
    b, s_loc, d = x.shape
    x = x.contiguous()
    w = w.to(_result_dtype(x, w))
    x = x.to(w.dtype)
    out = torch.empty((b, n * s_loc, w.shape[1]), dtype=w.dtype,
                      device=x.device)
    step = ring_ag_gemm if use_kernel else ring_ag_gemm_reference
    wire = wire_dtype or x.dtype
    slots = [x if wire == x.dtype else x.to(wire)] + \
        [torch.empty_like(x, dtype=wire) for _ in range(n - 1)]
    cur = x
    for t in range(n):
        hop = ring_rotate_start(slots[t], group, perm, chunks,
                                out=slots[t + 1]) if t + 1 < n else None
        step(cur, w, out, (my - t) % n)
        if hop is not None:
            # the local chunk multiplied uncast; arrivals cast back
            cur = hop.wait().to(x.dtype).contiguous()
    return out


def matmul_rs(x, w, group, wire_dtype=None, chunks=1, use_kernel=True):
    """Ring ``reduce_scatter(psum_partial(x @ w), dim=-2)`` (the TPU
    kernel's loop). x (b, n*s_loc, f_loc), full-length partials; w (f_loc,
    d). Returns (b, s_loc, d), this rank's shard of the sum. Step t adds
    the partial of block ``(my - 1 - t) % n`` to the accumulator that
    arrived and sends the sum on."""
    n, my, perm = ring_context(group)
    b, s, f = x.shape
    if s % n:
        raise ValueError("matmul_rs: sequence {} does not divide the ring "
                         "size {}".format(s, n))
    s_loc = s // n
    w = w.to(_result_dtype(x, w))
    x = x.to(w.dtype).contiguous()
    d = w.shape[1]
    out_dtype = w.dtype
    wire = wire_dtype or out_dtype
    shape = (b, s_loc, d)
    slots = [torch.empty(shape, dtype=wire, device=x.device)
             for _ in range(n)]
    step = ring_rs_gemm_add if use_kernel else ring_rs_gemm_add_reference
    recv, hop = None, None
    for t in range(n):
        last = t + 1 == n
        # the payload is the kernel's output when no cast intervenes
        acc = slots[t] if not last and wire == out_dtype else \
            torch.empty(shape, dtype=out_dtype, device=x.device)
        if hop is not None:
            recv = hop.wait().to(out_dtype)
        step(x, w, (my - 1 - t) % n, n, acc, recv)
        if not last:
            if acc is not slots[t]:
                slots[t].copy_(acc)
            hop = ring_rotate_start(slots[t], group, perm, chunks,
                                    out=slots[t + 1])
    return acc


def gather_contract(rot, fixed, group, wire_dtype=None, chunks=1,
                    rot_is_lhs=True, use_kernel=True):
    """The dW accumulation both backwards share (the TPU kernel's loop):
    ``sum_j block_j(allgather(rot))^T-contract fixed[block_j]``. rot (b,
    s_loc, a), the rotating shard; fixed (b, n*s_loc, c). Returns (a, c)
    (``rot_is_lhs``) else (c, a), in their result dtype, summed in
    fp32."""
    n, my, perm = ring_context(group)
    a, c = rot.shape[-1], fixed.shape[-1]
    out_dtype = _result_dtype(rot, fixed)
    rot = rot.to(out_dtype).contiguous()
    fixed = fixed.to(out_dtype).contiguous()
    shape = (a, c) if rot_is_lhs else (c, a)
    acc = torch.empty(shape, dtype=torch.float32, device=rot.device)
    out = None if out_dtype == torch.float32 else \
        torch.empty(shape, dtype=out_dtype, device=rot.device)
    wire = wire_dtype or rot.dtype
    slots = [rot if wire == rot.dtype else rot.to(wire)] + \
        [torch.empty_like(rot, dtype=wire) for _ in range(n - 1)]
    step = ring_gc_gemm_acc if use_kernel else ring_gc_gemm_acc_reference
    cur = rot
    for t in range(n):
        hop = ring_rotate_start(slots[t], group, perm, chunks,
                                out=slots[t + 1]) if t + 1 < n else None
        step(cur, fixed, (my - t) % n, acc, t == 0,
             out if t + 1 == n else None, rot_is_lhs)
        if hop is not None:
            cur = hop.wait().to(rot.dtype).contiguous()
    return acc if out is None else out
