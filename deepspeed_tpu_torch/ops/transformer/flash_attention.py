"""Packed flash attention: the CUDA kernels, their wrappers, their plain
versions, and the autograd ops built on them.

Port of ``deepspeed_tpu/ops/transformer/flash_attention.py``'s packed
path. The operands keep the model's natural layout: q, k and v are
``(b, s, h * d)`` rows (usually three column blocks of one ``(b, s, 3 * h
* d)`` QKV projection, read through their strides, never copied or
transposed to ``(b, h, s, d)``); ``lse`` and ``delta`` are ``(b, s, h)``
fp32; ``bias`` is an optional ``(b, s)`` (or ``(b, 1, s)``) fp32 additive
score per key.

* :func:`flash_fwd` launches ``csrc/flash_attention.cu``'s forward on
  CUDA tensors (the TPU's ``_fwd_packed``); :func:`flash_bwd_dkdv` and
  :func:`flash_bwd_dq` launch the two backward kernels (the TPU's
  ``_bwd_fused_packed`` / ``_bwd_split_packed``: the same dq, dk, dv, here
  without atomics so dq is deterministic). Each adds one to its
  ``.launches`` where it launches. On CPU tensors each returns its plain
  version; on a CUDA tensor it launches the kernel or raises.
* :func:`flash_fwd_reference`, :func:`flash_bwd_dq_reference` and
  :func:`flash_bwd_dkdv_reference` are the plain PyTorch versions, rounding
  at the kernels' points: the forward walks the same 64-key tiles with the
  same online softmax (probabilities rounded to V's dtype before the P.V
  product), the backward rounds ``ds`` and ``p`` to the input dtype.
* :func:`fused_ln_qkv_attention` (LN + QKV projection + causal flash
  attention, saving ``(x, ln_scale, ln_bias, qkv_w, qkv_b, out, lse)`` and
  recomputing LN + QKV in the backward) and :func:`flash_attention_bshd`
  (``(b, s, h, d)`` operands with an optional key ``mask_bias``) are
  ``torch.autograd.Function`` s over them.
* :func:`flash_attention` is the JAX package's 3D API (``(b * h, s, d)``
  operands, the TPU's ``_fwd`` / ``_bwd``): the same kernels, each of the
  ``b * h`` rows one batch entry of one head.
"""
import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import cuda_build
from .fused_ops import fused_layer_norm

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

NEG_INF = -1e30
BLOCK = 64                       # the kernels' query and key tile
HEAD_DIMS = (32, 64, 128)        # d_head values the kernels are built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def build():
    """Compile the kernel library (reused when already built from this
    source); returns the :class:`cuda_build.BuildRecord`."""
    return cuda_build.build(SOURCE)


class _Params(ctypes.Structure):
    """``FlashParams`` of ``csrc/flash_attention.cu``, field for field."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("bias", ctypes.c_void_p),
        ("dout", ctypes.c_void_p), ("lse_in", ctypes.c_void_p),
        ("delta", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("lse", ctypes.c_void_p), ("dq", ctypes.c_void_p),
        ("dk", ctypes.c_void_p), ("dv", ctypes.c_void_p),
        ("qkv_sb", ctypes.c_int64), ("qkv_ss", ctypes.c_int64),
        ("bias_sb", ctypes.c_int64),
        ("out_sb", ctypes.c_int64), ("out_ss", ctypes.c_int64),
        ("grad_sb", ctypes.c_int64), ("grad_ss", ctypes.c_int64),
        ("b", ctypes.c_int), ("s", ctypes.c_int), ("h", ctypes.c_int),
        ("causal", ctypes.c_int), ("scale", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded kernel library with its C signatures declared; built and
    loaded once per process."""
    lib = cuda_build.load(SOURCE)
    for name in ("flash_fwd_launch", "flash_bwd_dq_launch",
                 "flash_bwd_dkdv_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, params, dtype, d_head, device):
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(ctypes.byref(params), _DTYPE_CODES[dtype],
                             d_head, stream)
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            name, err, lib.flash_error_string(err).decode()))


def _check(name, q, k, v, num_heads, extra=()):
    """Validate the packed operands (and ``extra``: (label, tensor) pairs
    that must share q's device, dtype and shape). Returns (b, s, h, d)."""
    if q.dim() != 3:
        raise ValueError("{}: q, k, v must be packed (b, s, h * d); got {}"
                         .format(name, tuple(q.shape)))
    b, s, hd = q.shape
    if num_heads <= 0 or hd % num_heads:
        raise ValueError("{}: width {} is not a multiple of num_heads {}"
                         .format(name, hd, num_heads))
    d = hd // num_heads
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError("{}: unsupported device {}".format(name, device))
    if q.dtype not in _DTYPE_CODES:
        raise ValueError("{}: dtype {} is not one of {}".format(
            name, q.dtype, sorted(str(t) for t in _DTYPE_CODES)))
    for label, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                "{}: {} is {} {} on {}; q is {} {} on {}".format(
                    name, label, tuple(t.shape), t.dtype, t.device,
                    tuple(q.shape), q.dtype, device))
    if device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError("{}: the kernel takes d_head in {}; got {}"
                             .format(name, HEAD_DIMS, d))
        if k.stride() != q.stride() or v.stride() != q.stride() or \
                q.stride(2) != 1:
            raise ValueError(
                "{}: q, k and v must share one stride with unit stride on "
                "the last dim; got {}, {}, {}".format(
                    name, q.stride(), k.stride(), v.stride()))
    return b, s, num_heads, d


def _bias_2d(name, bias, b, s, device):
    """``None`` or the (b, s) / (b, 1, s) fp32 key bias as a (b, s) view
    with unit stride along the keys."""
    if bias is None:
        return None
    if bias.dim() == 3 and bias.shape[1] == 1:
        bias = bias[:, 0]
    if bias.shape != (b, s) or bias.dtype != torch.float32 or \
            bias.device != device:
        raise ValueError("{}: bias must be fp32 (b, s) = {} on {}; got {} {} "
                         "on {}".format(name, (b, s), device,
                                        tuple(bias.shape), bias.dtype,
                                        bias.device))
    if bias.stride(1) != 1:
        bias = bias.contiguous()
    return bias


def _check_rows(name, label, t, b, s, h, d):
    """An fp32 (b, s, h) contiguous lse / delta."""
    if t.shape != (b, s, h) or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError("{}: {} must be a contiguous fp32 {}; got {} {}"
                         .format(name, label, (b, s, h), tuple(t.shape),
                                 t.dtype))


def _grad_out(name, given, like, labels):
    """Output buffers for dq / dk / dv: the given views (sharing one stride
    with unit stride last) or fresh contiguous tensors."""
    if given is None:
        return [torch.empty(like.shape, dtype=like.dtype, device=like.device)
                for _ in labels]
    for label, t in zip(labels, given):
        if t.shape != like.shape or t.dtype != like.dtype or \
                t.device != like.device or t.stride() != given[0].stride() \
                or t.stride(2) != 1:
            raise ValueError("{}: {} output must be {} {} with the other "
                             "outputs' stride".format(name, label,
                                                      tuple(like.shape),
                                                      like.dtype))
    return list(given)


def _scale_of(sm_scale, d):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _params(q, k, v, bias, b, s, h, causal, scale):
    p = _Params()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.bias = _ptr(bias)
    p.bias_sb = bias.stride(0) if bias is not None else 0
    p.qkv_sb, p.qkv_ss = q.stride(0), q.stride(1)
    p.b, p.s, p.h, p.causal, p.scale = b, s, h, int(bool(causal)), scale
    return p


# ------------------------------------------------------------- wrappers


def flash_fwd(q, k, v, bias=None, *, num_heads, causal=True, sm_scale=None):
    """Packed flash-attention forward -> ``(out (b, s, h * d) in q's dtype,
    lse (b, s, h) fp32)``, both allocated here and contiguous. On CUDA the
    kernel runs on the current stream, without a synchronise."""
    b, s, h, d = _check("flash_fwd", q, k, v, num_heads)
    bias = _bias_2d("flash_fwd", bias, b, s, q.device)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, bias, num_heads=num_heads,
                                   causal=causal, sm_scale=scale)
    out = torch.empty((b, s, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    p = _params(q, k, v, bias, b, s, h, causal, scale)
    p.out, p.lse = out.data_ptr(), lse.data_ptr()
    p.out_sb, p.out_ss = out.stride(0), out.stride(1)
    _launch("flash_fwd_launch", p, q.dtype, d, q.device)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _bwd_args(name, q, k, v, bias, dout, lse, delta, num_heads):
    b, s, h, d = _check(name, q, k, v, num_heads, extra=(("dout", dout),))
    _check_rows(name, "lse", lse, b, s, h, d)
    _check_rows(name, "delta", delta, b, s, h, d)
    if q.device.type == "cuda" and dout.stride(2) != 1:
        raise ValueError("{}: dout needs unit stride on the last dim"
                         .format(name))
    return b, s, h, d, _bias_2d(name, bias, b, s, q.device)


def _bwd_params(q, k, v, bias, dout, lse, delta, b, s, h, causal, scale,
                grads):
    p = _params(q, k, v, bias, b, s, h, causal, scale)
    p.dout, p.lse_in, p.delta = dout.data_ptr(), lse.data_ptr(), \
        delta.data_ptr()
    p.out_sb, p.out_ss = dout.stride(0), dout.stride(1)
    p.grad_sb, p.grad_ss = grads[0].stride(0), grads[0].stride(1)
    return p


def flash_bwd_dkdv(q, k, v, bias, dout, lse, delta, *, num_heads,
                   causal=True, sm_scale=None, dk=None, dv=None):
    """dk and dv of packed flash attention -> ``(dk, dv)`` in q's dtype,
    written into ``dk`` / ``dv`` when given (views sharing one stride, e.g.
    column blocks of one (b, s, 3 * h * d) buffer)."""
    b, s, h, d, bias = _bwd_args("flash_bwd_dkdv", q, k, v, bias, dout, lse,
                                 delta, num_heads)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        got = flash_bwd_dkdv_reference(q, k, v, bias, dout, lse, delta,
                                       num_heads=num_heads, causal=causal,
                                       sm_scale=scale)
        return _store(got, (dk, dv))
    dk, dv = _grad_out("flash_bwd_dkdv", None if dk is None else (dk, dv),
                       q, ("dk", "dv"))
    if q.numel() == 0:
        return dk, dv
    p = _bwd_params(q, k, v, bias, dout, lse, delta, b, s, h, causal, scale,
                    (dk, dv))
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _launch("flash_bwd_dkdv_launch", p, q.dtype, d, q.device)
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, *, num_heads, causal=True,
                 sm_scale=None, dq=None):
    """dq of packed flash attention in q's dtype, written into ``dq`` when
    given."""
    b, s, h, d, bias = _bwd_args("flash_bwd_dq", q, k, v, bias, dout, lse,
                                 delta, num_heads)
    scale = _scale_of(sm_scale, d)
    if q.device.type == "cpu":
        got = flash_bwd_dq_reference(q, k, v, bias, dout, lse, delta,
                                     num_heads=num_heads, causal=causal,
                                     sm_scale=scale)
        return _store((got,), (dq,))[0]
    (dq,) = _grad_out("flash_bwd_dq", None if dq is None else (dq,), q,
                      ("dq",))
    if q.numel() == 0:
        return dq
    p = _bwd_params(q, k, v, bias, dout, lse, delta, b, s, h, causal, scale,
                    (dq,))
    p.dq = dq.data_ptr()
    _launch("flash_bwd_dq_launch", p, q.dtype, d, q.device)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def _store(values, outs):
    """Copy plain-version results into caller-given output views."""
    return tuple(val if out is None else out.copy_(val)
                 for val, out in zip(values, outs))


def attention_delta(out, dout, num_heads):
    """delta = rowsum(dout * out) per head -> (b, s, h) fp32, a plain torch
    op outside the kernels (XLA computes it outside the TPU kernels too)."""
    b, s, hd = out.shape
    return (dout.float().reshape(b, s, num_heads, hd // num_heads) *
            out.float().reshape(b, s, num_heads, hd // num_heads)).sum(-1)


def flash_bwd(q, k, v, bias, out, dout, lse, *, num_heads, causal=True,
              sm_scale=None, dq=None, dk=None, dv=None):
    """(dq, dk, dv) of packed flash attention: delta, then the dk/dv kernel,
    then the dq kernel (their plain versions on CPU tensors)."""
    delta = attention_delta(out, dout, num_heads)
    kw = dict(num_heads=num_heads, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_bwd_dkdv(q, k, v, bias, dout, lse, delta, dk=dk, dv=dv,
                            **kw)
    dq = flash_bwd_dq(q, k, v, bias, dout, lse, delta, dq=dq, **kw)
    return dq, dk, dv


# ------------------------------------------------------- plain versions


def _heads(t, h):
    """(b, s, h * d) -> (b, h, s, d) fp32 (a copy)."""
    b, s, hd = t.shape
    return t.reshape(b, s, h, hd // h).permute(0, 2, 1, 3).float()


def _packed(t, dtype):
    """(b, h, s, d) -> contiguous (b, s, h * d) in ``dtype``."""
    b, h, s, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * d).to(dtype).contiguous()


def flash_fwd_reference(q, k, v, bias=None, *, num_heads, causal=True,
                        sm_scale=None, block=BLOCK, trace=None):
    """The plain PyTorch forward: the kernel's online softmax over key
    tiles of ``block``, all rows at once. Any device. ``trace``: a list
    that gets, per key tile, copies of its scores S, probabilities P, the
    running row sums l and the running P.V (``acc``)."""
    b, s, hd = q.shape
    h, d = num_heads, hd // num_heads
    scale = _scale_of(sm_scale, d)
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    bias = None if bias is None else (bias[:, 0] if bias.dim() == 3
                                      else bias).float()
    m = torch.full((b, h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, block):
        kb, vb = kh[:, :, k0:k0 + block], vh[:, :, k0:k0 + block]
        sc = (qh @ kb.transpose(-1, -2)) * scale
        if bias is not None:
            sc = sc + bias[:, None, None, k0:k0 + block]
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            sc = torch.where(q_pos >= k_pos[None, :], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vb
        m = m_new
        if trace is not None:
            trace.append({"S": sc.clone(), "P": p.clone(), "l": l.clone(),
                          "PV": acc.clone()})
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = _packed(acc / l_safe, q.dtype)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1).contiguous()
    return out, lse


def _bwd_terms(q, k, v, bias, dout, lse, delta, h, causal, scale):
    """p (masked probabilities, fp32) and ds (rounded to q's dtype), dense
    (b, h, s, s), as ``_bwd_head_terms`` computes them per tile."""
    b, s, _ = q.shape
    qh, kh, vh, gh = _heads(q, h), _heads(k, h), _heads(v, h), \
        _heads(dout, h)
    sc = (qh @ kh.transpose(-1, -2)) * scale
    if bias is not None:
        sc = sc + (bias[:, 0] if bias.dim() == 3 else bias).float()[
            :, None, None, :]
    lse_h = lse.permute(0, 2, 1)[..., None]
    delta_h = delta.permute(0, 2, 1)[..., None]
    p = torch.exp(sc - lse_h)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = gh @ vh.transpose(-1, -2)
    ds = (p * (dp - delta_h) * scale).to(q.dtype)
    return qh, kh, gh, p, ds


def flash_bwd_dq_reference(q, k, v, bias, dout, lse, delta, *, num_heads,
                           causal=True, sm_scale=None):
    """The plain PyTorch dq: ds (rounded) . k, accumulated in fp32."""
    scale = _scale_of(sm_scale, q.shape[-1] // num_heads)
    _, kh, _, _, ds = _bwd_terms(q, k, v, bias, dout, lse, delta, num_heads,
                                 causal, scale)
    return _packed(ds.float() @ kh, q.dtype)


def flash_bwd_dkdv_reference(q, k, v, bias, dout, lse, delta, *, num_heads,
                             causal=True, sm_scale=None):
    """The plain PyTorch (dk, dv): ds^T . q and p (rounded)^T . dout."""
    scale = _scale_of(sm_scale, q.shape[-1] // num_heads)
    qh, _, gh, p, ds = _bwd_terms(q, k, v, bias, dout, lse, delta, num_heads,
                                  causal, scale)
    dk = ds.float().transpose(-1, -2) @ qh
    dv = p.to(dout.dtype).float().transpose(-1, -2) @ gh
    return _packed(dk, q.dtype), _packed(dv, q.dtype)


# ------------------------------------------------------------ autograd ops


def _lnqkv(x, ln_scale, ln_bias, qkv_w, qkv_b, eps):
    """Block input -> the (b, s, 3 * h * d) QKV projection of its LN."""
    ln = fused_layer_norm(x, ln_scale, ln_bias, eps)
    return ln @ qkv_w.to(ln.dtype) + qkv_b.to(ln.dtype)


class _FusedLnQkvAttention(torch.autograd.Function):
    """LN + QKV + causal flash attention, with the JAX op's residuals
    (x, ln_scale, ln_bias, qkv_w, qkv_b, out, lse): the backward recomputes
    LN + QKV under ``enable_grad`` and pulls the LN/GEMM cotangents through
    ``torch.autograd.grad``, as ``_fused_lnqkv_attn_bwd`` does with
    ``jax.vjp``. The flash kernels write dq/dk/dv straight into one
    (b, s, 3 * h * d) buffer, the QKV output's gradient."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, num_heads, eps,
                causal):
        hd = x.shape[-1]
        qkv = _lnqkv(x, ln_scale, ln_bias, qkv_w, qkv_b, eps)
        q, k, v = qkv.split(hd, dim=-1)
        out, lse = flash_fwd(q, k, v, num_heads=num_heads, causal=causal)
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, out, lse)
        ctx.num_heads, ctx.eps, ctx.causal = num_heads, eps, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        x, ln_scale, ln_bias, qkv_w, qkv_b, out, lse = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in zip(
            (x, ln_scale, ln_bias, qkv_w, qkv_b), ctx.needs_input_grad[:5])]
        with torch.enable_grad():
            qkv = _lnqkv(*inputs, ctx.eps)
        hd = x.shape[-1]
        q, k, v = qkv.detach().split(hd, dim=-1)
        dqkv = torch.empty_like(qkv)
        dq, dk, dv = dqkv.split(hd, dim=-1)
        flash_bwd(q, k, v, None, out, dout.contiguous(), lse,
                  num_heads=ctx.num_heads, causal=ctx.causal, dq=dq, dk=dk,
                  dv=dv)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(qkv, wanted, dqkv)) if wanted \
            else iter(())
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None, None)


def fused_ln_qkv_attention(x, ln_scale, ln_bias, qkv_w, qkv_b, num_heads,
                           eps=1e-5, causal=True):
    """x: (b, s, d_model) -> the attention context (b, s, d_model), causal,
    sm_scale 1/sqrt(d_head), through the flash kernels (their plain
    versions for CPU tensors)."""
    return _FusedLnQkvAttention.apply(x, ln_scale, ln_bias, qkv_w, qkv_b,
                                      num_heads, eps, causal)


class _FlashBSHD(torch.autograd.Function):
    """Flash attention over (b, s, h, d) operands viewed as packed rows;
    the key bias is a constant (no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, causal):
        b, s, h, d = q.shape
        pack = lambda t: t.reshape(b, s, h * d)
        qp, kp, vp = pack(q), pack(k), pack(v)
        if kp.stride() != qp.stride() or vp.stride() != qp.stride():
            qp, kp, vp = qp.contiguous(), kp.contiguous(), vp.contiguous()
        out, lse = flash_fwd(qp, kp, vp, bias, num_heads=h, causal=causal,
                             sm_scale=sm_scale)
        ctx.save_for_backward(qp, kp, vp, bias, out, lse)
        ctx.meta = (h, causal, sm_scale)
        return out.reshape(b, s, h, d)

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, bias, out, lse = ctx.saved_tensors
        h, causal, sm_scale = ctx.meta
        b, s, hd = qp.shape
        dq, dk, dv = flash_bwd(qp, kp, vp, bias, out,
                               dout.reshape(b, s, hd).contiguous(), lse,
                               num_heads=h, causal=causal, sm_scale=sm_scale)
        unpack = lambda t: t.reshape(b, s, h, hd // h)
        return unpack(dq), unpack(dk), unpack(dv), None, None, None


def flash_attention_bshd(q, k, v, sm_scale=None, causal=True,
                         mask_bias=None):
    """q/k/v: (batch, seq, heads, d_head) -> the same layout. Heads are
    never transposed: the operands are viewed as packed (b, s, h * d) rows.
    ``mask_bias``: optional (b, s) additive score bias per KEY (0 keep /
    -1e9 drop, the BERT key-padding mask), treated as a constant."""
    b, s, h, d = q.shape
    bias = None
    if mask_bias is not None:
        bias = mask_bias.detach().float()
        if bias.dim() == 3:
            bias = bias[:, 0]
        bias = bias.contiguous()
    return _FlashBSHD.apply(q, k, v, bias, sm_scale, causal)


DEFAULT_BLOCK_Q = 512            # the JAX package's defaults (TPU tiling)
DEFAULT_BLOCK_K = 512


def flash_attention(q, k, v, sm_scale=None, causal=True,
                    block_q=DEFAULT_BLOCK_Q, interpret=False,
                    block_k=DEFAULT_BLOCK_K):
    """q/k/v: (batch_heads, seq, d_head) -> (batch_heads, seq, d_head), the
    JAX package's ``flash_attention``. The operands are viewed as packed
    (b = batch_heads, s, 1 * d_head) rows on the packed kernels
    (:func:`flash_attention_bshd` with one head), so any ``seq`` works: the
    kernels mask keys at or past it, as the TPU path's padded keys.
    ``block_q``, ``block_k`` and ``interpret`` are the TPU's tiling and
    interpreter switches; they are accepted and ignored (the kernels tile
    by 64, and CPU tensors run the plain versions)."""
    del block_q, block_k, interpret
    if q.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (batch_heads, "
                         "seq, d_head); got {}".format(tuple(q.shape)))
    return flash_attention_bshd(q[:, :, None], k[:, :, None], v[:, :, None],
                                sm_scale, causal)[:, :, 0]
