"""The host Adam: the repo's ``csrc/cpu_adam.cpp`` built with
``host_build.py``, bound with ``ctypes``, and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/adam/cpu_adam_native.py`` and
``ops/op_builder/cpu_adam.py``: the same C interface
(``ds_cpu_adam_step``, ``ds_cpu_adam_step_bf16_copy``,
``ds_cpu_adam_num_threads``) and argument types. ZeRO-Offload runs it on
the fp32 master and moments in host memory.

* :func:`cpu_adam` updates contiguous fp32 CPU tensors in place by their
  ``data_ptr()``; given ``p_bf16`` it runs the fused variant, which also
  writes the updated parameters rounded to bf16 (nearest even, a NaN
  stays a quiet NaN: ``cpu_adam.cpp:91-101``). A source that does not
  build, or a library that does not load, raises
  :class:`host_build.HostBuildError`: nothing falls back to another
  implementation.
* Threads: where the library was built with OpenMP
  (``ds_cpu_adam_num_threads() > 1``) one call covers the buffer and its
  loops use every core. Where the compiler has no OpenMP library the
  loops run on one thread, so :func:`cpu_adam` cuts the buffer into one
  piece a usable core and runs the pieces on a thread pool (``ctypes``
  releases the GIL during the call). The update is elementwise, so the
  bits do not depend on the cut.
* :func:`cpu_adam_reference` is the plain version: the C++ loop's
  operations in its order, each rounding once in fp32 (the C++ takes
  ``sqrt(v) * (1 / sqrt(bc2)) + eps``), and the same bf16 rounding. A
  compiler that contracts ``a * b + c`` into one FMA (``-march=native``,
  as the JAX package's builder passes, or an ISA with FMA in its
  baseline) rounds fewer times: the two then agree to a few ulps, not
  bit for bit.
"""
import ctypes
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import host_build

SOURCE = Path(__file__).resolve().parents[3] / "csrc" / "cpu_adam.cpp"

_STEP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
    [ctypes.c_float] * 7 + [ctypes.c_int]
# (name, restype, argtypes) of the C interface
SIGNATURES = [
    ("ds_cpu_adam_step", None, _STEP_ARGS),
    ("ds_cpu_adam_step_bf16_copy", None,
     _STEP_ARGS[:4] + [ctypes.c_void_p] + _STEP_ARGS[4:]),
    ("ds_cpu_adam_num_threads", ctypes.c_int, []),
]
ALIGN = 16                      # elements a thread's piece starts on


def build(source=SOURCE):
    """Compile the op (reused when already built from these bytes);
    returns the ``cuda_build.BuildRecord``."""
    return host_build.build(source)


@functools.lru_cache(maxsize=None)
def load(source=SOURCE):
    """The loaded, bound library; built and loaded once per process."""
    lib = host_build.load(source)
    for name, restype, argtypes in SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def openmp_threads():
    """The OpenMP threads one call of the built library uses (1 where it
    was built without OpenMP)."""
    return int(load().ds_cpu_adam_num_threads())


def usable_cores():
    """The cores this process may run on (affinity aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


_POOL = {}
_POOL_LOCK = threading.Lock()


def _pool(threads):
    with _POOL_LOCK:
        pool = _POOL.get(threads)
        if pool is None:
            pool = _POOL[threads] = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="cpu-adam")
        return pool


def threads_for(n):
    """How many pool threads :func:`cpu_adam` splits ``n`` elements over:
    1 where OpenMP threads the library's loops, else one a usable core,
    no piece under 64K elements."""
    if openmp_threads() > 1:
        return 1
    return max(1, min(usable_cores(), n // (1 << 16)))


def _check(p, g, m, v, p_bf16):
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device.type != "cpu" or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.numel() != p.numel():
            raise ValueError(
                "cpu_adam: {} must be a contiguous fp32 CPU tensor of {} "
                "elements, got {} {} on {}".format(
                    name, p.numel(), t.dtype, tuple(t.shape), t.device))
    if p_bf16 is not None and (
            p_bf16.device.type != "cpu" or p_bf16.dtype != torch.bfloat16 or
            not p_bf16.is_contiguous() or p_bf16.numel() != p.numel()):
        raise ValueError("cpu_adam: p_bf16 must be a contiguous bf16 CPU "
                         "tensor of {} elements".format(p.numel()))


def cpu_adam(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, bc1, bc2,
             adam_w_mode=True, p_bf16=None, threads=None):
    """One Adam step in place over contiguous fp32 CPU tensors ``p``,
    ``m``, ``v`` with gradient ``g`` (read only); ``bc1``/``bc2`` are the
    bias-correction denominators ``1 - beta ** step`` (1.0 without bias
    correction). With ``p_bf16`` the updated ``p`` is also written there
    in bf16. ``threads`` overrides :func:`threads_for`. Adds one to
    ``cpu_adam.calls``."""
    _check(p, g, m, v, p_bf16)
    lib = load()
    n = p.numel()
    scalars = [float(x) for x in (lr, beta1, beta2, eps, weight_decay,
                                  bc1, bc2)] + [int(bool(adam_w_mode))]
    ptrs = [t.data_ptr() for t in (p, g, m, v)]
    half = p_bf16.data_ptr() if p_bf16 is not None else None

    def run(lo, hi):
        at = [x + 4 * lo for x in ptrs]
        if half is None:
            lib.ds_cpu_adam_step(*at, hi - lo, *scalars)
        else:
            lib.ds_cpu_adam_step_bf16_copy(*at, half + 2 * lo, hi - lo,
                                           *scalars)

    k = threads if threads is not None else threads_for(n)
    if k <= 1 or n < 2 * ALIGN:
        run(0, n)
    else:
        step = -(-n // k // ALIGN) * ALIGN
        bounds = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
        list(_pool(k).map(lambda b: run(*b), bounds))
    cpu_adam.calls += 1
    return p


cpu_adam.calls = 0


def _f32(x):
    return np.float32(x)


def bf16_round(x):
    """fp32 -> bf16 as ``cpu_adam.cpp`` rounds: to nearest even, and a NaN
    to a quiet NaN keeping its sign and high payload bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    out = torch.where(nan, (bits >> 16) | 0x0040, rounded) & 0xFFFF
    out = torch.where(out >= 0x8000, out - 0x10000, out)
    return out.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def cpu_adam_reference(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                       bc1, bc2, adam_w_mode=True, p_bf16=None):
    """The plain PyTorch version of :func:`cpu_adam`, in place, each
    operation of the C++ loop rounded to fp32 in its order."""
    lr, beta1, beta2, eps, wd = (_f32(x) for x in (lr, beta1, beta2, eps,
                                                   weight_decay))
    one = _f32(1.0)
    omb1, omb2 = one - beta1, one - beta2
    inv_bc1 = one / _f32(bc1)
    inv_bc2_sqrt = one / np.sqrt(_f32(bc2))
    gi = g if adam_w_mode else g + float(wd) * p
    mi = float(beta1) * m + float(omb1) * gi
    vi = float(beta2) * v + (float(omb2) * gi) * gi
    # sqrt correctly rounded, as ``std::sqrt`` (torch's fp32 CPU sqrt is
    # not): through fp64, whose rounding back to fp32 is exact for sqrt
    denom = torch.sqrt(vi.double()).float() * float(inv_bc2_sqrt) + \
        float(eps)
    if adam_w_mode:
        update = (mi * float(inv_bc1)) / denom + float(wd) * p
        p.sub_(float(lr) * update)
    else:
        p.sub_((float(lr) * (mi * float(inv_bc1))) / denom)
    m.copy_(mi)
    v.copy_(vi)
    if p_bf16 is not None:
        p_bf16.copy_(bf16_round(p))
    return p
