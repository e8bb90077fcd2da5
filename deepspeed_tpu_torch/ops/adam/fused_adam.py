"""Adam/AdamW: the CUDA kernel, its wrapper, its plain version, and the
optimizer handle.

Port of ``deepspeed_tpu/ops/adam/fused_adam.py`` (``adam_init``,
``adam_update``, ``FusedAdam``) and of the TPU kernel
``ops/adam/pallas_adam.py::_fused_adam_flat``.

* :func:`fused_adam` updates one flat fp32 partition (params, moments) in
  place: on CUDA tensors it launches ``csrc/fused_adam.cu`` (one launch for
  the whole buffer) and adds one to ``fused_adam.launches``; on CPU tensors
  it runs :func:`fused_adam_reference`.
* :func:`fused_adam_reference` is the plain PyTorch version: the kernel's
  operations in the kernel's order, each rounding once in fp32.
* :func:`adam_init` / :func:`adam_update` are the pytree (dict of tensors)
  forms, as in the JAX package; :class:`FusedAdam` holds the mutable
  hyperparameters and the backend choice (``use_kernel``: the kernel or the
  plain version), and the engine drives it over its flat buffers.

The bias corrections ``bc = 1 - beta ** step`` are taken in fp32
(:func:`bias_corrections`), as ``adam_update`` does with ``jnp.power`` on
f32, and every scalar reaches the arithmetic as an fp32 value.
"""
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_adam.cu"


def build():
    """Compile the kernel library (reused when already built from this
    source); returns the :class:`cuda_build.BuildRecord`."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    fn = lib.fused_adam_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int] + \
        [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_adam_error_string.argtypes = [ctypes.c_int]
    lib.fused_adam_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def f32(x):
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


def bias_corrections(beta1, beta2, step, bias_correction=True):
    """(bc1, bc2) = (1 - beta1 ** step, 1 - beta2 ** step) in fp32."""
    if not bias_correction:
        return 1.0, 1.0
    one, n = np.float32(1.0), np.float32(step)
    return (f32(one - np.power(np.float32(beta1), n)),
            f32(one - np.power(np.float32(beta2), n)))


def fma_f32(a, b, c):
    """``a * b + c`` over fp32 tensors ``b``, ``c`` and a scalar ``a``
    (taken in fp32, as the kernel receives it), rounded once to fp32 (the
    kernel's ``__fmaf_rn``). The product is exact in fp64; the sum is
    rounded to odd on fp64's 53 bits (TwoSum gives its exact error), which
    makes the final rounding to fp32's 24 bits correct."""
    prod = f32(a) * b.double()
    c64 = c.double()
    s = prod + c64
    back = s - c64
    err = (c64 - (s - back)) + (prod - back)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def _check(p, g, m, v):
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.device != p.device or \
                t.numel() != p.numel() or not t.is_contiguous():
            raise ValueError(
                "fused_adam: {} must be a contiguous fp32 tensor of {} "
                "elements on {}; got {} {} on {}".format(
                    name, p.numel(), p.device, t.numel(), t.dtype, t.device))
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError("fused_adam: unsupported device {}".format(p.device))


def fused_adam(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
               adam_w_mode=True):
    """One Adam step over flat fp32 ``p``, ``m``, ``v`` (updated in place)
    with gradient ``g``. Scalars are rounded to fp32. On CUDA the kernel
    runs on the current stream, without a synchronise."""
    _check(p, g, m, v)
    sc = dict(lr=f32(lr), beta1=f32(beta1), beta2=f32(beta2), eps=f32(eps),
              weight_decay=f32(weight_decay), bc1=f32(bc1), bc2=f32(bc2))
    if p.device.type == "cpu":
        return fused_adam_reference(p, g, m, v, adam_w_mode=adam_w_mode,
                                    **sc)
    n = p.numel()
    if n == 0:
        return p, m, v
    vectorized = int(all(t.data_ptr() % 16 == 0 for t in (p, g, m, v)))
    lib = _library()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.fused_adam_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
        vectorized, sc["lr"], sc["beta1"], sc["beta2"], sc["eps"],
        sc["weight_decay"], sc["bc1"], sc["bc2"], int(bool(adam_w_mode)),
        _num_sms(p.device.index if p.device.index is not None
                 else torch.cuda.current_device()), stream)
    if err != 0:
        raise RuntimeError("fused_adam kernel launch failed: CUDA error {} "
                           "({})".format(err, lib.fused_adam_error_string(err)
                                         .decode()))
    fused_adam.launches += 1
    return p, m, v


fused_adam.launches = 0


def fused_adam_reference(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                         bc1, bc2, adam_w_mode=True):
    """The plain PyTorch version, in place: the TPU kernel's operations in
    its order, one fp32 rounding each. Any device."""
    one = np.float32(1.0)
    om1 = f32(one - np.float32(beta1))
    om2 = f32(one - np.float32(beta2))
    if not adam_w_mode:
        g = fma_f32(weight_decay, p, g)
    m.copy_(beta1 * m + om1 * g)
    v.copy_(beta2 * v + om2 * (g * g))
    # true divisions: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal instead, which can differ in the last bit
    bc1, bc2 = (torch.tensor(bc, dtype=torch.float32, device=p.device)
                for bc in (bc1, bc2))
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode:
        update = update + weight_decay * p
    p.copy_(p - lr * update)
    return p, m, v


# ------------------------------------------------------------ pytree form


def adam_init(params):
    """``{"step": 0, "exp_avg": zeros, "exp_avg_sq": zeros}`` over a dict
    (or nested dict/list) of fp32 tensors, the JAX names."""
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
    return {"step": 0, "exp_avg": _tree_map(zeros, params),
            "exp_avg_sq": _tree_map(zeros, params)}


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def adam_update(grads, state, params, lr, beta1, beta2, eps, weight_decay,
                bias_correction=True, adam_w_mode=True, use_kernel=False):
    """One Adam step over a tree of fp32 tensors, in place. Returns
    ``(params, state)`` with ``state["step"]`` advanced. ``use_kernel``
    routes each leaf through :func:`fused_adam` (the CUDA kernel on CUDA
    tensors), otherwise :func:`fused_adam_reference`."""
    step = state["step"] + 1
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction)
    fn = fused_adam if use_kernel else fused_adam_reference
    sc = dict(lr=f32(lr), beta1=f32(beta1), beta2=f32(beta2), eps=f32(eps),
              weight_decay=f32(weight_decay), bc1=bc1, bc2=bc2,
              adam_w_mode=adam_w_mode)
    _tree_map(lambda p, g, m, v: fn(p, g.float().contiguous(), m, v, **sc),
              params, grads, state["exp_avg"], state["exp_avg_sq"])
    return params, dict(state, step=step)


class FusedAdam:
    """Optimizer handle with mutable hyperparameters (read at each step),
    as ``deepspeed_tpu.ops.adam.FusedAdam``. ``use_kernel``: True the
    kernel's wrapper (the kernel on CUDA tensors, its plain version on CPU
    tensors), False the plain version. The moments are fp32, the kernel's
    storage."""

    name = "adam"
    supports_zero = True

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0, amsgrad=False,
                 use_kernel=True, moments_dtype=None):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        if moments_dtype is not None and str(moments_dtype).lower() not in (
                "fp32", "float32", "torch.float32"):
            raise NotImplementedError(
                "optimizer.params.moments_dtype={!r}: bf16 moment storage "
                "is not ported yet (the Adam kernel keeps fp32 moments); it "
                "comes with the optimizer-state slice".format(moments_dtype))
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.use_kernel = use_kernel

    def hyperparams(self):
        return {"lr": float(self.lr), "beta1": float(self.betas[0]),
                "beta2": float(self.betas[1]), "eps": float(self.eps),
                "weight_decay": float(self.weight_decay)}

    def step_flat(self, p, g, m, v, step, segments=None, group=None,
                  sharded_from=0):
        """One step over flat fp32 buffers at optimizer step ``step`` (the
        count after this update). Adam is elementwise: the segment table
        (``FlatPartition.segments``) and the tensor-parallel layout
        (``group``, ``sharded_from``) do not matter to it."""
        h = {k: f32(val) for k, val in self.hyperparams().items()}
        bc1, bc2 = bias_corrections(h["beta1"], h["beta2"], step,
                                    self.bias_correction)
        fn = fused_adam if self.use_kernel else fused_adam_reference
        fn(p, g, m, v, bc1=bc1, bc2=bc2, adam_w_mode=self.adam_w_mode, **h)
