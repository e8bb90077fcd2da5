#!/usr/bin/env python3
"""Measurements behind the designs of the bf16 flash backward and the dW
ring GEMM (``ring_gc_gemm_acc``) on one H100; not a test and on no path
of the package.

    python3 probes/kernel_probe.py SECTION [SECTION ...]

from the root of the repository, on a machine with the card. Each section
prints one JSON line:

* ``s_order``: the flash backward's tensor-core S and dP (``s_tc.cu``,
  the kernels' mma.sync chain) against cuBLAS's fp32 products, which the
  plain versions use, at four heads of the train shape's data: how often
  they are equal, their largest difference in units of 2^-24 |a| |b| (the
  kernels' bound takes 6), and how many bf16(P) and bf16(dS) roundings
  that difference flips;
* ``cublas_order``: whether cuBLAS's fp32 S is the ascending sequential
  sum over d (the order the kernels' re-sum repeats);
* ``flash_parts``: the dk/dv and dq kernels at the train shape as built
  and with their exact-rounding work switched off in patched copies
  (results wrong, time only): no re-sum (flagged pairs left as they are),
  no check, no row norms;
* ``flash_flags``: pairs flagged for the re-sum per warp tile at the train
  shape (a patched copy counts them);
* ``gc_variants``: the dW kernel at the four TP 2 sites with other k
  steps, stage counts and warp layouts (patched copies);
* ``fp16_backward``: the fp16 backward (the FMA kernels) against its plain
  versions with a key bias, at short and long sequences.

Patched copies are written under ``probes/_build/`` (git-ignored).
"""
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import cuda_build  # noqa: E402
from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402

PATCHED = ROOT / "probes" / "_build"
DEV = torch.device("cuda", 0)


def _flush():
    return torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)


def _patched(module, name, replacements):
    """Point ``module``'s kernel source at a copy with ``replacements``
    (pairs of text) applied; None when one of them is not in the source."""
    text = Path(module.SOURCE).read_text()
    for old, _ in replacements:
        if old not in text:
            return None
    for old, new in replacements:
        text = text.replace(old, new)
    PATCHED.mkdir(parents=True, exist_ok=True)
    path = PATCHED / "{}_{}.cu".format(Path(module.SOURCE).stem, name)
    path.write_text(text)
    return path


def _with_source(module, path, fn):
    original = module.SOURCE
    module.SOURCE = path
    module._library.cache_clear()
    try:
        return fn()
    finally:
        module.SOURCE = original
        module._library.cache_clear()


def _train_backward_args():
    q, k, v, dout = cs.flash_case(DEV)
    h = cs.FLASH_SHAPE["h"]
    kw = dict(num_heads=h, causal=True)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.attention_delta(out, dout, h)
    return (q, k, v, None, dout, lse, delta), kw


def s_order():
    lib = cuda_build.load(ROOT / "probes" / "s_tc.cu")
    lib.s_tc_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    q, k, v, dout = cs.flash_case(DEV)
    d, s = cs.FLASH_SHAPE["d"], cs.FLASH_SHAPE["s"]
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, num_heads=cs.FLASH_SHAPE["h"])
    delta = fa.attention_delta(out, dout, cs.FLASH_SHAPE["h"])
    mask = torch.ones(s, s, dtype=torch.bool, device=DEV).tril()
    equal, worst, p_flips, ds_flips, pairs = [], 0.0, 0, 0, 0
    for bi, hi in ((0, 0), (3, 5), (9, 11), (15, 15)):
        part = lambda t: t[bi, :, hi * d:(hi + 1) * d].contiguous()
        Q, K, V, G = part(q), part(k), part(v), part(dout)
        prods = {}
        for name, (a, b) in (("S", (Q, K)), ("dP", (G, V))):
            tc = torch.empty(s, s, device=DEV)
            assert lib.s_tc_launch(a.data_ptr(), b.data_ptr(), tc.data_ptr(),
                                   s) == 0
            ref = a.float() @ b.float().T
            torch.cuda.synchronize()
            unit = 2.0 ** -24 * a.float().norm(dim=1)[:, None] * \
                b.float().norm(dim=1)[None, :]
            worst = max(worst, float(((tc - ref).abs() / unit).max()))
            equal.append(float((tc == ref).float().mean()))
            prods[name] = (tc, ref)
        L = lse[bi, :, hi][:, None]
        dl = delta[bi, :, hi][:, None]
        terms = []
        for i in (0, 1):
            S, dP = prods["S"][i], prods["dP"][i]
            P = torch.where(mask, torch.exp(S * scale - L), 0.0)
            terms.append((P.bfloat16(), (P * (dP - dl) * scale).bfloat16()))
        p_flips += int((terms[0][0] != terms[1][0]).sum())
        ds_flips += int((terms[0][1] != terms[1][1]).sum())
        pairs += int(mask.sum())
    return {"equal_share": equal, "max_diff_in_2^-24|a||b|": worst,
            "p_flips": p_flips, "ds_flips": ds_flips, "pairs": pairs}


def cublas_order():
    q, k, v, dout = cs.flash_case(DEV)
    out = {}
    for name, (a, b) in (("S", (q, k)), ("dP", (dout, v))):
        A = a[3, :, 64:128].float().contiguous()
        B = b[3, :, 64:128].float().contiguous()
        ref = A @ B.T
        acc = torch.zeros_like(ref)
        for i in range(A.shape[1]):       # exact products, ascending d
            acc = acc + A[:, i:i + 1] * B[:, i:i + 1].T
        out[name] = float((acc == ref).float().mean())
    return {"share_equal_to_the_ascending_sum": out}


FLASH_PARTS = {
    "no_resum": [("flags |= 1u << (j * 4 + e);", ";")],
    "no_check": [("flags |= 1u << (j * 4 + e);", ";"),
                 ("if (near_plain_edge(", "if (false && near_plain_edge(")],
    "no_norms": [("flags |= 1u << (j * 4 + e);", ";"),
                 ("if (near_plain_edge(", "if (false && near_plain_edge("),
                 ("  return sqrtf(((acc[0]",
                  "  return 1.f; return sqrtf(((acc[0]")],
}


def flash_parts():
    args, kw = _train_backward_args()
    flush = _flush()

    def timed():
        return {"dkdv_ms": cs.time_ms(lambda: fa.flash_bwd_dkdv(*args, **kw),
                                      flush),
                "dq_ms": cs.time_ms(lambda: fa.flash_bwd_dq(*args, **kw),
                                    flush)}

    res = {"as_built": timed()}
    for name, reps in FLASH_PARTS.items():
        path = _patched(fa, name, reps)
        res[name] = "source changed" if path is None else \
            _with_source(fa, path, timed)
    return res


def flash_flags():
    anchor = "    while (__any_sync(0xffffffffu, flags)) {"
    count = ("    { const unsigned n_flagged = __reduce_add_sync(0xffffffffu, "
             "__popc(flags)); if (lane == 0) { atomicAdd(const_cast<float*>("
             "p.delta), (float)n_flagged); atomicAdd(const_cast<float*>("
             "p.delta) + 1, 1.f); } }\n")
    path = _patched(fa, "count", [(anchor, count + anchor)])
    if path is None:
        return "source changed"

    def run():
        args, kw = _train_backward_args()
        out = {}
        for name, fn in (("dkdv", fa.flash_bwd_dkdv),
                         ("dq", fa.flash_bwd_dq)):
            delta = args[6].clone()
            before = delta.flatten()[:2].clone()
            fn(*args[:6], delta, **kw)
            torch.cuda.synchronize()
            got = delta.flatten()[:2] - before
            out[name] = {"flagged": float(got[0]),
                         "warp_tiles": float(got[1]),
                         "per_warp_tile": float(got[0] / got[1])}
        return out

    return _with_source(fa, path, run)


def gc_variants():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    flush = _flush()
    consts = "constexpr int kGcBM = 128, kGcBN = 128, kGcBK = 64, kGcStages = 3;"
    variants = {
        "as_built": [],
        "4_stages": [(consts, consts.replace("kGcStages = 3", "kGcStages = 4"))],
        "k_step_32_6_stages": [(consts, consts.replace(
            "kGcBK = 64, kGcStages = 3", "kGcBK = 32, kGcStages = 6"))],
        "4_warps_64x64": [("constexpr int kGcWM = 2, kGcWN = 4;",
                           "constexpr int kGcWM = 2, kGcWN = 2;")],
    }
    k_steps = {"k_step_32_6_stages": 32}

    def sites():
        gen = torch.Generator(device=DEV).manual_seed(5)
        row = {}
        for site, k, n, mode in cs.RING_SITES["ring_gc_gemm_acc"]:
            kern, plain, lib, get, flops, nbytes = cs.ring_case(
                "ring_gc_gemm_acc", k, n, mode, DEV, gen)
            kern()
            plain()
            torch.cuda.synchronize()
            (o0, a0), (o1, a1) = get(0), get(1)
            tol = cs.RING_TOL["ring_gc_gemm_acc"]
            ratio = max(cs._ring_err(o0, o1, tol)[1],
                        cs._ring_err(a0, a1, tol, "acc_abs_of_max", 0.0)[1])
            row[site] = {"ms": cs.time_ms(kern, flush),
                         "err_over_tol": ratio}
        row["sum_ms"] = sum(v["ms"] for v in row.values())
        return row

    out = {}
    for name, reps in variants.items():
        path = _patched(rgm, name, reps) if reps else Path(rgm.SOURCE)
        if path is None:
            out[name] = "source changed"
            continue
        step = rgm.GC_K_STEP
        rgm.GC_K_STEP = k_steps.get(name, step)
        try:
            out[name] = _with_source(rgm, path, sites)
        finally:
            rgm.GC_K_STEP = step
    return out


def fp16_backward():
    """The fp16 backward (the FMA kernels) against its plain versions, b 2,
    h 3, a key bias dropping 20% of keys: the largest error over an fp16
    ulp of the plain value plus 1e-6 (the GPU tests' bound; 1 passes)."""
    res = []
    for d in (32, 128):
        for s in (96, 1000):
            for causal in (True, False):
                rng = np.random.RandomState(s + d)
                b, h = 2, 3
                to = lambda a: torch.from_numpy(a).to(DEV, torch.float16)
                qkv = to(rng.randn(b, s, 3 * h * d).astype(np.float32))
                q, k, v = qkv.split(h * d, -1)
                dout = to(rng.randn(b, s, h * d).astype(np.float32))
                bias = rng.randn(b, s).astype(np.float32)
                bias[rng.rand(b, s) < 0.2] = -1e9
                bias[:, 0] = 0.0
                bias = torch.from_numpy(bias).to(DEV)
                kw = dict(num_heads=h, causal=causal)
                out, lse = fa.flash_fwd(q, k, v, bias, **kw)
                delta = fa.attention_delta(out, dout, h)
                args = (q, k, v, bias, dout, lse, delta)
                got = fa.flash_bwd_dkdv(*args, **kw) + \
                    (fa.flash_bwd_dq(*args, **kw),)
                want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
                    (fa.flash_bwd_dq_reference(*args, **kw),)
                eps = torch.finfo(torch.float16).eps
                ratio = {name: float(((g.float() - w.float()).abs() /
                                      (eps * w.float().abs() + 1e-6)).max())
                         for name, g, w in zip(("dk", "dv", "dq"), got, want)}
                res.append({"d": d, "s": s, "causal": causal,
                            "ulp_ratio": ratio})
    return res


SECTIONS = {"s_order": s_order, "cublas_order": cublas_order,
            "flash_parts": flash_parts, "flash_flags": flash_flags,
            "gc_variants": gc_variants, "fp16_backward": fp16_backward}


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: no CUDA device is available")
    names = sys.argv[1:] or list(SECTIONS)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for name in names:
        print(json.dumps({"section": name, "result": SECTIONS[name]()},
                         default=str), flush=True)


if __name__ == "__main__":
    main()
