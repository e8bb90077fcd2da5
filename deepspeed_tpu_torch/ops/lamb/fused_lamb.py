"""LAMB: the CUDA kernels, their wrappers, their plain versions, and the
optimizer handle.

Port of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (``lamb_init``,
``lamb_update``, ``FusedLamb``) and of the TPU kernel
``ops/lamb/pallas_lamb.py::_lamb_stage1_flat`` with the stage 2 that
``fused_lamb_shard`` runs in XLA ops.

LAMB's trust ratio ``clip(|p| / |u|, min_coeff, max_coeff)`` is taken per
parameter (per JAX leaf). The port steps a whole flat fp32 partition at
once: a :class:`LambPlan` cuts each segment of it (one ``(offset, numel)``
per parameter, ``FlatPartition.segments``) into chunks of
:data:`CHUNK` elements, one CUDA block each.

* :func:`fused_lamb` (stage 1) returns the per-segment trust ratios and
  each segment's ``(|p|^2, |u|^2)``, and updates fp32 ``m`` and ``v`` in
  place: on CUDA tensors it launches
  ``csrc/fused_lamb.cu``'s ``lamb_stage1_kernel`` (one launch for the whole
  partition) and adds one to ``fused_lamb.launches``;
  :func:`fused_lamb_apply` applies ``p -= (lr * ratio) * u`` with its own
  kernel and count. On CPU tensors each runs its plain version.
* bf16 moments (``moments_dtype``, as the JAX package's ``lamb_init``): u
  must come from the fp32 m' and v', as ``lamb_update``'s XLA leaf takes
  it, not from their bf16 roundings. So stage 1 leaves bf16 ``m`` and
  ``v`` untouched, and the apply takes ``g`` (and ``beta1``, ``beta2``),
  makes m' and v' again from the old moments with the same operations,
  updates ``p`` and stores m' and v' rounded to bf16 (nearest even).
* :func:`fused_lamb_reference` / :func:`fused_lamb_apply_reference` are the
  plain PyTorch versions: the kernels' operations in the kernels' order,
  each rounding once in fp32, and the kernels' summation order for the
  norms (:func:`_chunk_partials`, :func:`_segment_total`), so the card gives
  the same bits both ways.
* :func:`lamb_init` / :func:`lamb_update` are the pytree (dict of tensors)
  forms, as in the JAX package; :class:`FusedLamb` holds the mutable
  hyperparameters and the backend choice, and the engine drives it over its
  flat buffers (:meth:`FusedLamb.step_flat`). Under tensor parallelism a
  rank holds a shard of some parameters: the step all-reduces those
  segments' sums over the ring and takes their ratios from the whole
  leaf's norms (:func:`ring_ratios`), as the reference's GSPMD psum does.
  Over a data group with the state partitioned (ZeRO stages 1-2) a rank
  steps its range of the buffer, with every segment clipped to it: the
  step all-reduces every segment's sums over the data group first, in
  one collective (:func:`dp_ratios`), then the sharded ones over the
  ring.

The norms sum up to 10^8 squares in another order than the JAX package (per
leaf padded to (rows, 128), or XLA's reduce), so the trust ratio may differ
from it in the last bits; the CPU tests state the bound.
"""
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build
from ..adam.fused_adam import (aligned, bias_corrections, check_buffers,
                               f32, moments_dtype_of, _tree_map)
from ...utils.distributed import all_reduce_

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_lamb.cu"

CHUNK = 8192                 # elements per CUDA block (kChunk in the source)
THREADS = 256                # threads per block (kThreads)
ROUNDS = CHUNK // (4 * THREADS)


def build():
    """Compile the kernel library (reused when already built from this
    source); returns the :class:`cuda_build.BuildRecord`."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    if lib.fused_lamb_chunk() != CHUNK:
        raise RuntimeError("fused_lamb.cu cuts chunks of {} elements, the "
                           "wrapper {}".format(lib.fused_lamb_chunk(), CHUNK))
    ptr, i64, i32, flt = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    lib.fused_lamb_launch.argtypes = [ptr] * 5 + [i64, ptr, i64] + \
        [ptr] * 4 + [i32] * 2 + [flt] * 8 + [i32, ptr]
    lib.fused_lamb_launch.restype = i32
    lib.fused_lamb_apply_launch.argtypes = [ptr] * 5 + [i64, ptr] + \
        [i32] * 2 + [flt] * 7 + [i32, ptr]
    lib.fused_lamb_apply_launch.restype = i32
    lib.fused_lamb_error_string.argtypes = [i32]
    lib.fused_lamb_error_string.restype = ctypes.c_char_p
    return lib


class LambPlan:
    """The chunk table of a flat buffer's segments, built once.

    ``segments``: ``(offset, numel)`` pairs (an (n, 2) int64 tensor or any
    sequence of pairs), one per parameter, in buffer order and not
    overlapping. Each segment is cut into chunks of at most :data:`CHUNK`
    elements; a segment of 0 elements gets none. On ``device`` the plan
    holds ``chunks`` ((n_chunks, 3) int64: start, length, segment),
    ``seg_first`` ((n_seg + 1,) int64: each segment's first chunk) and the
    kernel's scratch (per-chunk partials, per-segment tickets)."""

    def __init__(self, segments, device):
        seg = torch.as_tensor(segments, dtype=torch.int64).cpu().numpy()
        seg = seg.reshape(-1, 2)
        ends = seg[:, 0] + seg[:, 1]
        if (seg < 0).any() or (seg[1:, 0] < ends[:-1]).any():
            raise ValueError("LambPlan: segments must be (offset, numel) "
                             "pairs in buffer order that do not overlap")
        self.device = torch.device(device)
        self.offsets, self.numels = seg[:, 0].copy(), seg[:, 1].copy()
        per = -(-self.numels // CHUNK)
        first = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
        ids = np.repeat(np.arange(len(seg)), per)
        k = np.arange(first[-1]) - first[ids]
        rows = np.stack([self.offsets[ids] + k * CHUNK,
                         np.minimum(CHUNK, self.numels[ids] - k * CHUNK),
                         ids], axis=1).astype(np.int64)
        self.n_seg, self.n_chunks = len(seg), int(first[-1])
        self.aligned = bool((rows[:, 0] % 4 == 0).all())
        self.chunks = torch.from_numpy(rows).to(self.device)
        self.seg_first = torch.from_numpy(first).to(self.device)
        self.partials = torch.empty((self.n_chunks, 2), dtype=torch.float32,
                                    device=self.device)
        self.tickets = torch.zeros(self.n_seg, dtype=torch.int32,
                                   device=self.device)
        self._sharded = None

    def sharded_index(self, start):
        """The indices (int64, on the plan's device) of the segments
        whose offset is at or past ``start`` (or, given a sequence, those
        segment indices: ZeRO-3's units interleave the leaves every model
        rank holds whole with the sharded ones), built on first use."""
        key = tuple(start) if isinstance(start, (tuple, list)) else start
        if self._sharded is None or self._sharded[0] != key:
            idx = np.asarray(key, dtype=np.int64) if isinstance(key, tuple) \
                else np.flatnonzero(self.offsets >= key)
            self._sharded = (key, torch.from_numpy(idx).to(self.device))
        return self._sharded[1]

    def extent(self):
        """One past the last element any segment covers."""
        return int((self.offsets + self.numels).max()) if self.n_seg else 0


def _check(p, plan, fp32, moments):
    check_buffers("fused_lamb", p, [("p", p)] + fp32, moments)
    if plan.device != p.device:
        raise ValueError("fused_lamb: the plan lives on {}, the buffers on {}"
                         .format(plan.device, p.device))
    if plan.extent() > p.numel():
        raise ValueError("fused_lamb: the segments reach element {}, past "
                         "the buffers' {}".format(plan.extent(), p.numel()))


def _scalars(**kw):
    return {k: f32(v) for k, v in kw.items()}


def _raise_if(err, lib, name):
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {} ({})"
                           .format(name, err,
                                   lib.fused_lamb_error_string(err).decode()))


def _vectorized(plan, *tensors):
    return int(plan.aligned) & aligned(tensors)


def fused_lamb(p, g, m, v, plan, *, beta1, beta2, eps, weight_decay, bc1,
               bc2, max_coeff=10.0, min_coeff=0.01, eps_inside_sqrt=False):
    """LAMB stage 1 over the segments of flat fp32 ``p``, ``g`` and fp32 or
    bf16 ``m``, ``v``: fp32 moments updated in place (bf16 ones untouched:
    the apply stores them); returns the (n_seg,) fp32 trust ratios and the
    (n_seg, 2) fp32 sums ``(|p|^2, |u|^2)`` they were taken from (zeros for
    a segment of no element). On CUDA the kernel runs on the current
    stream, without a synchronise."""
    _check(p, plan, [("g", g)], [("m", m), ("v", v)])
    sc = _scalars(beta1=beta1, beta2=beta2, eps=eps,
                  weight_decay=weight_decay, bc1=bc1, bc2=bc2,
                  max_coeff=max_coeff, min_coeff=min_coeff)
    if p.device.type == "cpu":
        return fused_lamb_reference(p, g, m, v, plan,
                                    eps_inside_sqrt=eps_inside_sqrt, **sc)
    ratio = torch.ones(plan.n_seg, dtype=torch.float32, device=p.device)
    sums = torch.zeros((plan.n_seg, 2), dtype=torch.float32, device=p.device)
    if plan.n_chunks == 0:
        return ratio, sums
    lib = _library()
    err = lib.fused_lamb_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        plan.chunks.data_ptr(), plan.n_chunks, plan.seg_first.data_ptr(),
        plan.n_seg, plan.partials.data_ptr(), plan.tickets.data_ptr(),
        ratio.data_ptr(), sums.data_ptr(), _vectorized(plan, p, g, m, v),
        int(m.dtype == torch.bfloat16), sc["beta1"],
        sc["beta2"], sc["eps"], sc["weight_decay"], sc["bc1"], sc["bc2"],
        sc["max_coeff"], sc["min_coeff"], int(bool(eps_inside_sqrt)),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_if(err, lib, "fused_lamb")
    fused_lamb.launches += 1
    return ratio, sums


fused_lamb.launches = 0


def fused_lamb_apply(p, m, v, ratio, plan, *, lr, eps, weight_decay, bc1,
                     bc2, eps_inside_sqrt=False, g=None, beta1=None,
                     beta2=None):
    """``p -= (lr * ratio[segment]) * u`` in place over every segment. fp32
    moments: u from ``p`` and stage 1's ``m``, ``v``. bf16 moments: ``g``,
    ``beta1`` and ``beta2`` are required; m' and v' are made from the old
    ``m``, ``v`` and ``g`` as stage 1 made them, u from those, and m', v'
    stored (rounded to bf16)."""
    recompute = m.dtype == torch.bfloat16
    if recompute and (g is None or beta1 is None or beta2 is None):
        raise ValueError("fused_lamb_apply: bf16 moments need g, beta1 and "
                         "beta2 (the apply makes m' and v')")
    _check(p, plan, [("g", g)] if recompute else [], [("m", m), ("v", v)])
    if ratio.shape != (plan.n_seg,) or ratio.dtype != torch.float32 or \
            ratio.device != p.device:
        raise ValueError("fused_lamb_apply: ratio must be fp32 ({},) on {}"
                         .format(plan.n_seg, p.device))
    sc = _scalars(lr=lr, eps=eps, weight_decay=weight_decay, bc1=bc1,
                  bc2=bc2, beta1=beta1 or 0.0, beta2=beta2 or 0.0)
    if p.device.type == "cpu":
        return fused_lamb_apply_reference(p, m, v, ratio, plan,
                                          eps_inside_sqrt=eps_inside_sqrt,
                                          g=g, **sc)
    if plan.n_chunks == 0:
        return p
    ratio = ratio.contiguous()
    lib = _library()
    used = (p, g, m, v) if recompute else (p, m, v)
    err = lib.fused_lamb_apply_launch(
        p.data_ptr(), g.data_ptr() if recompute else None, m.data_ptr(),
        v.data_ptr(), plan.chunks.data_ptr(), plan.n_chunks,
        ratio.data_ptr(), _vectorized(plan, *used), int(recompute),
        sc["lr"], sc["beta1"], sc["beta2"], sc["eps"], sc["weight_decay"],
        sc["bc1"], sc["bc2"], int(bool(eps_inside_sqrt)),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_if(err, lib, "fused_lamb_apply")
    fused_lamb_apply.launches += 1
    return p


fused_lamb_apply.launches = 0


# ------------------------------------------------------- plain versions


def _direction(p, m, v, *, eps, weight_decay, bc1, bc2, eps_inside_sqrt):
    """u = (m / bc1) / denom + weight_decay * p, one fp32 rounding each.
    Divisions by 0-dim tensors: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which can differ in the last bit."""
    bc1, bc2 = (torch.tensor(bc, dtype=torch.float32, device=p.device)
                for bc in (bc1, bc2))
    vh = v / bc2
    denom = torch.sqrt(vh + eps) if eps_inside_sqrt else torch.sqrt(vh) + eps
    return (m / bc1) / denom + weight_decay * p


def _block_tree(x):
    """The kernel's shared-memory tree over the last dim (THREADS wide):
    s[t] += s[t + w] for w = THREADS / 2, ..., 1 -> the sums."""
    w = THREADS // 2
    while w:
        x = x[..., :w] + x[..., w:2 * w]
        w //= 2
    return x[..., 0]


def _chunk_partials(sq):
    """One segment's squares (n,) -> its chunks' partial sums, each summed
    in the kernel's order: thread t adds elements 4 * (r * THREADS + t) + j
    of its chunk in (r, j) order, then the block tree. Zeros pad the last
    chunk; adding +0 to a sum of squares changes no bit."""
    nc = -(-sq.numel() // CHUNK)
    x = F.pad(sq, (0, nc * CHUNK - sq.numel())).view(nc, ROUNDS, THREADS, 4)
    acc = torch.zeros((nc, THREADS), dtype=torch.float32, device=sq.device)
    for r in range(ROUNDS):
        for j in range(4):
            acc = acc + x[:, r, :, j]
    return _block_tree(acc)


def _segment_total(parts):
    """A segment's chunk partials -> the total in the closing block's order:
    thread t adds chunks t, t + THREADS, ... in order, then the tree."""
    rows = -(-parts.numel() // THREADS)
    x = F.pad(parts, (0, rows * THREADS - parts.numel())).view(rows, THREADS)
    acc = torch.zeros(THREADS, dtype=torch.float32, device=parts.device)
    for r in range(rows):
        acc = acc + x[r]
    return _block_tree(acc)


def _moments(g, m, v, beta1, beta2):
    """(m', v') in fp32 from fp32 or bf16 ``m``, ``v`` (widened exactly):
    the kernels' operations, one fp32 rounding each."""
    one = np.float32(1.0)
    return (f32(beta1) * m.float() + f32(one - np.float32(beta1)) * g,
            f32(beta2) * v.float() + f32(one - np.float32(beta2)) * (g * g))


def fused_lamb_reference(p, g, m, v, plan, *, beta1, beta2, eps,
                         weight_decay, bc1, bc2, max_coeff=10.0,
                         min_coeff=0.01, eps_inside_sqrt=False):
    """The plain PyTorch stage 1: fp32 ``m`` and ``v`` updated in place
    (bf16 ones untouched); returns the trust ratios and the per-segment
    sums, as :func:`fused_lamb`. Any device."""
    m_new, v_new = _moments(g, m, v, beta1, beta2)
    if m.dtype == torch.float32:
        m_new, v_new = m.copy_(m_new), v.copy_(v_new)
    sums = torch.zeros((plan.n_seg, 2), dtype=torch.float32, device=p.device)
    for i, (off, n) in enumerate(zip(plan.offsets.tolist(),
                                     plan.numels.tolist())):
        if n == 0:
            continue
        sl = slice(off, off + n)
        u = _direction(p[sl], m_new[sl], v_new[sl], eps=eps,
                       weight_decay=weight_decay, bc1=bc1, bc2=bc2,
                       eps_inside_sqrt=eps_inside_sqrt)
        sums[i, 0] = _segment_total(_chunk_partials(p[sl] * p[sl]))
        sums[i, 1] = _segment_total(_chunk_partials(u * u))
    return trust_ratios(sums, max_coeff, min_coeff), sums


def trust_ratios(sums, max_coeff, min_coeff):
    """(n_seg, 2) sums ``(|p|^2, |u|^2)`` -> the (n_seg,) fp32 ratios
    ``clip(|p| / |u|, min_coeff, max_coeff)`` where both norms are > 0,
    else 1: the kernel's closing operations, each rounded once in fp32."""
    p_norm, u_norm = torch.sqrt(sums[:, 0]), torch.sqrt(sums[:, 1])
    return torch.where(
        (p_norm > 0) & (u_norm > 0),
        torch.clamp(p_norm / u_norm, f32(min_coeff), f32(max_coeff)),
        torch.ones_like(p_norm))


def ring_ratios(ratio, sums, plan, group, sharded_from, max_coeff,
                min_coeff):
    """The trust ratios of a tensor-parallel rank's step: the segments at
    or past offset ``sharded_from`` hold this rank's shard of a leaf, so
    their sums are all-reduced over ``group`` (one collective) and their
    ratios recomputed from the whole leaf's norms; the segments before it
    (whole on every rank) keep their own."""
    sharded = plan.sharded_index(sharded_from)
    if sharded.numel() == 0:
        return ratio
    whole = all_reduce_(sums.index_select(0, sharded), group)
    return ratio.index_copy(0, sharded,
                            trust_ratios(whole, max_coeff, min_coeff))


def dp_ratios(sums, group, max_coeff, min_coeff):
    """The trust ratios of a data-parallel rank's step over its range of
    the buffer: every segment's sums ``(|p|^2, |u|^2)`` all-reduced over
    ``group`` (one collective; a segment the rank holds none of adds
    zeros), the ratios taken from the whole segments' norms. Returns the
    ratios and the reduced sums."""
    sums = all_reduce_(sums, group)
    return trust_ratios(sums, max_coeff, min_coeff), sums


def fused_lamb_apply_reference(p, m, v, ratio, plan, *, lr, eps,
                               weight_decay, bc1, bc2,
                               eps_inside_sqrt=False, g=None, beta1=None,
                               beta2=None):
    """The plain PyTorch apply, in place on ``p`` (and on bf16 ``m``, ``v``,
    made m' and v' from ``g`` as :func:`fused_lamb_apply` does). Any
    device."""
    m_new, v_new = m, v
    if m.dtype == torch.bfloat16:
        m_new, v_new = _moments(g, m, v, beta1, beta2)
    scale = f32(lr) * ratio
    for i, (off, n) in enumerate(zip(plan.offsets.tolist(),
                                     plan.numels.tolist())):
        sl = slice(off, off + n)
        u = _direction(p[sl], m_new[sl], v_new[sl], eps=eps,
                       weight_decay=weight_decay, bc1=bc1, bc2=bc2,
                       eps_inside_sqrt=eps_inside_sqrt)
        p[sl] = p[sl] - scale[i] * u
    if m.dtype == torch.bfloat16:
        m.copy_(m_new)
        v.copy_(v_new)
    return p


# ------------------------------------------------------------ pytree form


def lamb_init(params, moments_dtype=torch.float32):
    """``{"step": 0, "exp_avg": zeros, "exp_avg_sq": zeros}`` over a dict
    (or nested dict/list) of fp32 tensors, the JAX names; the moments in
    ``moments_dtype`` (fp32 or bf16)."""
    zeros = lambda t: torch.zeros_like(t, dtype=moments_dtype)
    return {"step": 0, "exp_avg": _tree_map(zeros, params),
            "exp_avg_sq": _tree_map(zeros, params)}


def _step(p, g, m, v, plan, use_kernel, lr, eps_inside_sqrt, group=None,
          sharded_from=0, dp_group=None, **sc):
    stage1, apply = (fused_lamb, fused_lamb_apply) if use_kernel else \
        (fused_lamb_reference, fused_lamb_apply_reference)
    ratio, sums = stage1(p, g, m, v, plan, eps_inside_sqrt=eps_inside_sqrt,
                         **sc)
    # the data reduction first (each leaf of this rank's model shard whole),
    # then the ring's (each sharded leaf whole)
    if dp_group is not None:
        ratio, sums = dp_ratios(sums, dp_group, sc["max_coeff"],
                                sc["min_coeff"])
    if group is not None:
        ratio = ring_ratios(ratio, sums, plan, group, sharded_from,
                            sc["max_coeff"], sc["min_coeff"])
    apply(p, m, v, ratio, plan, lr=lr, eps_inside_sqrt=eps_inside_sqrt, g=g,
          **{k: sc[k] for k in ("eps", "weight_decay", "bc1", "bc2",
                                "beta1", "beta2")})
    return ratio


def lamb_update(grads, state, params, lr, beta1, beta2, eps, weight_decay,
                bias_correction=True, max_coeff=10.0, min_coeff=0.01,
                eps_inside_sqrt=False, use_kernel=False):
    """One LAMB step over a tree of contiguous fp32 tensors (the moments
    fp32 or bf16), in place, one trust ratio per leaf. Returns ``(params, state)`` with
    ``state["step"]`` advanced. ``use_kernel`` routes each leaf through the
    kernels' wrappers, otherwise the plain versions."""
    step = state["step"] + 1
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction)
    sc = dict(beta1=f32(beta1), beta2=f32(beta2), eps=f32(eps),
              weight_decay=f32(weight_decay), bc1=bc1, bc2=bc2,
              max_coeff=max_coeff, min_coeff=min_coeff)

    def leaf(p, g, m, v):
        flat = [t.view(-1) for t in (p, m, v)]
        plan = LambPlan([(0, p.numel())], p.device)
        _step(flat[0], g.float().contiguous().view(-1), flat[1], flat[2],
              plan, use_kernel, f32(lr), eps_inside_sqrt, **sc)

    _tree_map(leaf, params, grads, state["exp_avg"], state["exp_avg_sq"])
    return params, dict(state, step=step)


class FusedLamb:
    """Optimizer handle with mutable hyperparameters (read at each step),
    as ``deepspeed_tpu.ops.lamb.FusedLamb``. ``use_kernel``: True the
    kernels' wrappers (the kernels on CUDA tensors, their plain versions
    on CPU tensors), False the plain versions.
    ``moments_dtype``: the moments' storage, fp32 (default) or bf16, the
    JAX handle's spellings. ``max_grad_norm`` is kept for the engine, which
    clips before the step."""

    name = "lamb"
    supports_zero = True

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, eps_inside_sqrt=False, weight_decay=0.0,
                 max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01,
                 amsgrad=False, use_kernel=True, moments_dtype=None):
        if amsgrad:
            raise RuntimeError(
                "FusedLamb does not support the AMSGrad variant.")
        self.moments_dtype = moments_dtype_of(moments_dtype)
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.use_kernel = use_kernel
        self._plan = None

    def init_state(self, params):
        return lamb_init(params, self.moments_dtype)

    def hyperparams(self):
        return {"lr": float(self.lr), "beta1": float(self.betas[0]),
                "beta2": float(self.betas[1]), "eps": float(self.eps),
                "weight_decay": float(self.weight_decay)}

    def plan_for(self, segments, device):
        """The :class:`LambPlan` of ``segments``, built on first use and
        kept while the same segment table comes back."""
        if self._plan is None or self._plan[0] is not segments:
            self._plan = (segments, LambPlan(segments, device))
        return self._plan[1]

    def step_flat(self, p, g, m, v, step, segments, group=None,
                  sharded_from=0, dp_group=None):
        """One step over flat fp32 buffers at optimizer step ``step`` (the
        count after this update), one trust ratio per ``(offset, numel)``
        of ``segments`` (``FlatPartition.segments``; the plan built from it
        is kept while the same table comes back). ``group``: a
        tensor-parallel ring of more than one rank, whose segments at or
        past offset ``sharded_from`` (``FlatPartition.replicated_end``) are
        shards of a leaf (:func:`ring_ratios`); None where the rank holds
        every leaf whole. ``dp_group``: the data group over which the
        buffers are partitioned (``p`` is this rank's range and
        ``segments`` are clipped to it, :func:`dp_ratios`); None where
        the rank steps the whole buffer."""
        h = {k: f32(val) for k, val in self.hyperparams().items()}
        bc1, bc2 = bias_corrections(h["beta1"], h["beta2"], step,
                                    self.bias_correction)
        _step(p, g, m, v, self.plan_for(segments, p.device), self.use_kernel,
              h["lr"], self.eps_inside_sqrt, beta1=h["beta1"],
              beta2=h["beta2"], eps=h["eps"], weight_decay=h["weight_decay"],
              bc1=bc1, bc2=bc2, max_coeff=self.max_coeff,
              min_coeff=self.min_coeff, group=group,
              sharded_from=sharded_from, dp_group=dp_group)
