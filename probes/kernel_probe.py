#!/usr/bin/env python3
"""Measurements behind the designs of the tensor-core flash and block-sparse
kernels, the ring GEMMs (``ring_gc_gemm_acc``, ``ring_ag_gemm``,
``ring_rs_gemm_add``) and the split paged decode kernel on one H100; not a
test and on no path of the package.

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
* ``flash_parts``: the forward, dk/dv and dq kernels at the train shape as
  built and with their exact-rounding work switched off in patched copies
  (results wrong, time only): no re-sum (flagged pairs left as they are;
  the forward's running max from the tensor-core scores), no check, no row
  norms;
* ``flash_flags``: pairs flagged for the re-sum per warp tile at the train
  shape and in the BERT path's mode (non-causal, the padded mask's key
  bias): the forward's running-max candidates and rounding-edge pairs, and
  the backward's (a patched copy counts them);
* ``gc_variants``: the dW kernel at the four TP 2 sites with other k
  steps, stage counts and warp layouts (patched copies);
* ``fp16_backward``: the fp16 backward against its plain versions with a
  key bias, at short and long sequences: the tensor-core kernels as built,
  with no rounding-edge check, and with every pair summed again in the
  plain order (P and dS at the plain bits; the count of pairs whose
  tensor-core P or dS would round otherwise, and of those the check missed);
  and the FMA kernels that fp16 ran before, as they were and with the plain
  versions' order of operations for P and dS;
* ``ag_variants``: ``ring_ag_gemm`` at the four TP 2 sites (both weight
  layouts) beside torch.matmul;
* ``fwd_variants[:names]``: the flash kernels' times at the train shape and
  their worst errors (fp16 cases, bf16 forward) per patched variant of the
  source (FWD_VARIANTS), with ptxas's register counts of the forward;
* ``flash_times``: the flash kernels, ring_ag_gemm, ring_rs_gemm_add, the
  bf16 block-sparse forward, dq and dk/dv (train_sparse shape) and the
  paged decode kernel (the kernel phase's s = 1 case) timed on the
  tree this script sits in (a copy run from a checkout of another commit
  times that commit in the same call: parent, change, change, parent),
  and a digest of the flash kernels' outputs (equal digests: bit-equal);
* ``rs_variants``: ``ring_rs_gemm_add`` at the four TP 2 sites beside
  torch.matmul, with each site's error over its bound;
* ``sparse_parts``: the bf16 block-sparse dq and dk/dv at the train_sparse
  shape (shared and per-head layouts) as built, without the rounding-edge
  check and re-sum, and also without row norms (patched copies);
* ``paged_variants[:names]``: the paged decode kernel at the kernel phase's
  s = 1 case (16 slots at 0-1023 keys) and with every slot at 1024 keys,
  per variant (PAGED_VARIANTS): keys staged a round (64, 128, 256), K
  commit groups a round (1, 2, 4), and the split partials combined by a
  second launch instead of the last block's ticket (a patched copy), each
  with its splits, ms and error against the plain version;
* ``sparse_fwd_parts``: the bf16 block-sparse forward at the train_sparse
  shape (shared and per-head layouts) as built, without the exactness
  check and re-sums, and also without row norms (patched copies), and the
  share of the forward walk's warp-steps that hold a pair.

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
    (pairs of text) applied, the shared ``tc_attention.cuh`` written into
    the copy so its text can be patched too; None when one of them is not
    in the source."""
    text = Path(module.SOURCE).read_text()
    shared = cuda_build.INCLUDE_DIR / "tc_attention.cuh"
    include = '#include "tc_attention.cuh"\n'
    if include in text:
        inline = shared.read_text().replace("#pragma once\n", "").replace(
            '#include "sm90_mma.cuh"\n', "")
        text = text.replace(include, inline)
    for old, _ in replacements:
        if old not in text:
            return None
    for old, new in replacements:
        text = text.replace(old, new)
    PATCHED.mkdir(parents=True, exist_ok=True)
    path = PATCHED / "{}_{}.cu".format(Path(module.SOURCE).stem, name)
    path.write_text(text)
    return path


# device counters a patched copy adds to the flash source, read back
# through ds_probe_read
COUNTERS = ("#include \"sm90_mma.cuh\"\n",
            "#include \"sm90_mma.cuh\"\n__device__ unsigned long long "
            "ds_probe[16];\n")
COUNTERS_READ = """
extern "C" int ds_probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, ds_probe,
                                                sizeof(ds_probe)));
}
extern "C" int ds_probe_zero() {
  static const unsigned long long zeros[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ds_probe, zeros,
                                              sizeof(zeros)));
}
"""


def _counters(zero=False):
    lib = fa._library()
    if zero:
        assert lib.ds_probe_zero() == 0
        return None
    out = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    assert lib.ds_probe_read(out) == 0
    return list(out)


def _count(flags, idx):
    """Source text that adds a warp's flagged pairs to counter idx and one
    warp tile to idx + 1."""
    return ("    {{ const unsigned n_ = __reduce_add_sync(0xffffffffu, "
            "__popc({0})); if (lane == 0) {{ atomicAdd(&ds_probe[{1}], "
            "(unsigned long long)n_); atomicAdd(&ds_probe[{2}], 1ull); }} }}\n"
            .format(flags, idx, idx + 1))


def _patched_counting(name, replacements):
    """A patched flash source with the counters and ``replacements``."""
    path = _patched(fa, name, [COUNTERS] + replacements)
    if path is not None:
        path.write_text(path.read_text() + COUNTERS_READ)
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
    """Share of cuBLAS's fp32 products equal to the ascending sequential sum
    over d: the backward's (s, d) x (d, s) S and dP at the train shape, and
    the forward's per-64-key-block batched S ((b, h, s, d) x (b, h, d, 64),
    as flash_fwd_reference takes it) at d 32, 64 and 128, bf16 and fp16
    inputs."""
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
    gen = torch.Generator(device=DEV).manual_seed(3)
    for dtype in (torch.bfloat16, torch.float16):
        for d in (32, 64, 128):
            A = torch.randn((2, 4, 1000, d), generator=gen, device=DEV,
                            dtype=dtype).float()
            B = torch.randn((2, 4, 64, d), generator=gen, device=DEV,
                            dtype=dtype).float()
            ref = A @ B.transpose(-1, -2)
            acc = torch.zeros_like(ref)
            for i in range(d):
                acc = acc + A[..., i:i + 1] * B[..., i:i + 1].transpose(-1,
                                                                      -2)
            out["S_fwd_block_{}_d{}".format(str(dtype)[6:], d)] = float(
                (acc == ref).float().mean())
    return {"share_equal_to_the_ascending_sum": out}


FWD_MAX_FROM_TC = [
    ("m_new[h2] = fmaxf(m[h2], quad_max(mt[h2]));",
     "m_new[h2] = fmaxf(m[h2], hi[h2]);"),
    ("cand |= live & 1u << (j * 4 + e);", ";")]
FLASH_PARTS = {
    "no_resum": FWD_MAX_FROM_TC + [("flags |= 1u << (j * 4 + e);", ";"),
                                   ("flags |= 1u << bit;", ";")],
    "no_check": FWD_MAX_FROM_TC + [
        ("flags |= 1u << (j * 4 + e);", ";"), ("flags |= 1u << bit;", ";"),
        ("if (near_plain_edge<T>(", "if (false && near_plain_edge<T>("),
        ("if (hi[h2] >= m[h2] && ", "if (false && "),
        ("if ((live >> bit & 1u) && near_edge)", "if (false && near_edge)")],
}
FLASH_PARTS["no_norms"] = FLASH_PARTS["no_check"] + [
    ("  return sqrtf(((acc[0]", "  return 1.f; return sqrtf(((acc[0]")]


def flash_parts():
    args, kw = _train_backward_args()
    q, k, v = args[:3]
    flush = _flush()

    def timed():
        return {"fwd_ms": cs.time_ms(lambda: fa.flash_fwd(q, k, v, **kw),
                                     flush),
                "dkdv_ms": cs.time_ms(lambda: fa.flash_bwd_dkdv(*args, **kw),
                                      flush),
                "dq_ms": cs.time_ms(lambda: fa.flash_bwd_dq(*args, **kw),
                                    flush)}

    res = {"as_built": timed()}
    for name, reps in FLASH_PARTS.items():
        path = _patched(fa, name, reps)
        res[name] = "source changed" if path is None else \
            _with_source(fa, path, timed)
    return res


FLAG_SITES = [("  float mt[2] = {kTcNegInf, kTcNegInf};\n", "cand", 0),
              ("  // each lane sums its own flagged pairs again", "flags", 2),
              ("    resolve_flagged<BQ / 8>(", "flags", 4),
              ("    resolve_flagged<kTcRows / 8>(", "flags", 6)]


def flash_flags():
    """Flagged pairs per warp tile (16 rows x 64 keys for the forward and
    dq, 16 keys x 32 queries for dk/dv) at the train shape (causal, random
    q/k) and in the BERT mode (non-causal, the train_bert batch's key
    bias)."""
    path = _patched_counting("count", [(anchor, _count(var, idx) + anchor)
                                       for anchor, var, idx in FLAG_SITES])
    if path is None:
        return "source changed"

    def mode(args, kw):
        q, k, v = args[:3]
        out = {}
        # the forward's edge count is its flagged pairs less the candidates
        for name, call, idx in (
                ("fwd_max_candidates", lambda: fa.flash_fwd(q, k, v, args[3],
                                                            **kw), 0),
                ("fwd_edges", None, 2),
                ("dkdv", lambda: fa.flash_bwd_dkdv(*args, **kw), 4),
                ("dq", lambda: fa.flash_bwd_dq(*args, **kw), 6)):
            if call is not None:
                _counters(zero=True)
                call()
                got = _counters()
            n = got[idx] - (got[0] if name == "fwd_edges" else 0)
            out[name] = {"flagged": n, "warp_tiles": got[idx + 1],
                         "per_warp_tile": n / max(got[idx + 1], 1)}
        return out

    def run():
        args, kw = _train_backward_args()
        res = {"train": mode(args, kw)}
        from deepspeed_tpu_torch.models import bert
        from deepspeed_tpu_torch.ops.transformer.transformer import \
            _expand_mask
        cfg = bert.config_for("bert_large", max_seq_len=cs.BERT_SEQ)
        keep = torch.from_numpy(cs.bert_batch(cfg, cs.BERT_MICRO, cs.BERT_SEQ,
                                              seed=0)[2][0]).to(DEV)
        bias = _expand_mask(keep, torch.float32)[:, 0, 0, :].contiguous()
        q, k, v, dout = cs.flash_case(DEV, cs.BERT_FLASH_SHAPE, seed=1)
        h = cs.BERT_FLASH_SHAPE["h"]
        kw = dict(num_heads=h, causal=False)
        out, lse = fa.flash_fwd(q, k, v, bias, **kw)
        delta = fa.attention_delta(out, dout, h)
        res["bert"] = mode((q, k, v, bias, dout, lse, delta), kw)
        return res

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


# fp16 through the FMA kernels, as before the tensor-core route took it
FP16_ON_FMA = [("constexpr bool tc = !std::is_same<T, float>::value;",
                "constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;")]
# ... with P and dS in the plain versions' order of fp32 operations (no
# contraction of S scale + bias into one fused multiply-add)
FMA_PLAIN_ORDER = [
    ("expf(sc[i][j] * p.scale + bs[tx * 4 + j] - lse_r[i])",
     "expf(__fsub_rn(__fadd_rn(__fmul_rn(sc[i][j], p.scale), "
     "bs[tx * 4 + j]), lse_r[i]))"),
    ("pr * (dp[i][j] - delta_r[i]) * p.scale",
     "__fmul_rn(__fmul_rn(pr, __fsub_rn(dp[i][j], delta_r[i])), p.scale)"),
    ("expf(st[i][j] * p.scale + bs[ty * 4 + i] - lse_c[j])",
     "expf(__fsub_rn(__fadd_rn(__fmul_rn(st[i][j], p.scale), "
     "bs[ty * 4 + i]), lse_c[j]))"),
    ("pr * (dpt[i][j] - delta_c[j]) * p.scale",
     "__fmul_rn(__fmul_rn(pr, __fsub_rn(dpt[i][j], delta_c[j])), p.scale)")]
# every live pair summed again in the plain order, counting the pairs whose
# tensor-core P or dS rounds otherwise (0, 1: dk/dv's P, dS; 2: dq's dS)
# and those of them the check did not flag (3, 4)
ALL_RESUMMED = [
    ("    uint32_t flags = 0;\n",
     "    uint32_t flags = 0;\n    unsigned long long real_ = 0;\n"),
    ("          if (near_plain_edge<T>(t, eb[h2])) flags |= 1u << (j * 4 + e);",
     "          if (near_plain_edge<T>(t, eb[h2])) real_ |= 1ull << (j * 4 + e);"
     " flags |= 1u << (j * 4 + e);"),
    ("          if (near_plain_edge<T>(t, b)) flags |= 1u << (j * 4 + e);",
     "          if (near_plain_edge<T>(t, b)) real_ |= 1ull << (j * 4 + e);"
     " flags |= 1u << (j * 4 + e);"),
    ("        [&](int j, int e, bool taken, float2 v) {\n",
     "        [&](int j, int e, bool taken, float2 v) {\n"
     "          if (taken) { const bool fp_ = round_to<T>(sc[j][e]) != "
     "round_to<T>(v.x), fd_ = round_to<T>(dp[j][e]) != round_to<T>(v.y); "
     "if (fp_) atomicAdd(&ds_probe[0], 1ull); "
     "if (fd_) atomicAdd(&ds_probe[1], 1ull); "
     "if ((fp_ || fd_) && !(real_ >> (j * 4 + e) & 1ull)) "
     "atomicAdd(&ds_probe[3], 1ull); }\n"),
    ("        [&](int j, int e, bool taken, float v) {\n"
     "          dp[j][e] = taken ? v : dp[j][e];",
     "        [&](int j, int e, bool taken, float v) {\n"
     "          if (taken && round_to<T>(dp[j][e]) != round_to<T>(v)) { "
     "atomicAdd(&ds_probe[2], 1ull); if (!(real_ >> (j * 4 + e) & 1ull)) "
     "atomicAdd(&ds_probe[4], 1ull); }\n"
     "          dp[j][e] = taken ? v : dp[j][e];")]
FP16_VARIANTS = {
    "tc_as_built": None,
    "tc_no_check": [("flags |= 1u << (j * 4 + e);", ";"),
                    ("flags |= 1u << bit;", ";")],
    "tc_all_resummed": ALL_RESUMMED,
    "fma_as_before": FP16_ON_FMA,
    "fma_plain_order": FP16_ON_FMA + FMA_PLAIN_ORDER,
}


def fp16_backward(names=None):
    """The fp16 backward against its plain versions at the cases of
    chip_smoke.py's FP16_CASES (b 2, h 3, d 32 / 128, s 96 / 1000, causal
    or not, a key bias dropping 20% of keys; and d 64, s 333 with q, k
    scaled by 3): the largest error over an fp16 ulp of the plain value
    plus 1e-6 (the GPU tests' bound; 1 passes), per variant of the kernels
    (FP16_VARIANTS). Each variant's forward gives its own out and lse."""
    def cases(counting):
        rows = []
        for b, h, d, s, causal, qk_scale in cs.FP16_CASES:
            q, k, v, dout, bias = cs.fp16_case(DEV, b, h, d, s, qk_scale)
            kw = dict(num_heads=h, causal=causal)
            out, lse = fa.flash_fwd(q, k, v, bias, **kw)
            delta = fa.attention_delta(out, dout, h)
            args = (q, k, v, bias, dout, lse, delta)
            if counting:
                _counters(zero=True)
            got = fa.flash_bwd_dkdv(*args, **kw) + \
                (fa.flash_bwd_dq(*args, **kw),)
            want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
                (fa.flash_bwd_dq_reference(*args, **kw),)
            eps = torch.finfo(torch.float16).eps
            row = {"d": d, "s": s, "causal": causal, "qk_scale": qk_scale,
                   "ulp_ratio": {
                       name: float(((g.float() - w.float()).abs() /
                                    (eps * w.float().abs() + 1e-6)).max())
                       for name, g, w in zip(("dk", "dv", "dq"), got,
                                             want)},
                   "grads": [g.cpu() for g in got]}
            if counting:
                c = _counters()
                row["flips"] = {"dkdv_p": c[0], "dkdv_ds": c[1],
                                "dq_ds": c[2], "missed_by_check_dkdv": c[3],
                                "missed_by_check_dq": c[4]}
            rows.append(row)
        return rows

    res = {}
    for name, reps in FP16_VARIANTS.items():
        if names and name not in names:
            continue
        if reps is None:
            res[name] = cases(False)
            continue
        counting = reps is ALL_RESUMMED
        path = (_patched_counting if counting else
                lambda n, r: _patched(fa, n, r))("fp16_" + name, reps)
        res[name] = "source changed" if path is None else \
            _with_source(fa, path, lambda: cases(counting))
    built = res.get("tc_as_built")
    for name, rows in res.items():
        if isinstance(rows, str) or built is None:
            continue
        for row, ref in zip(rows, built):
            row["bit_equal_to_as_built"] = all(
                torch.equal(a, b) for a, b in zip(row["grads"], ref["grads"]))
    for rows in res.values():
        if not isinstance(rows, str):
            for row in rows:
                del row["grads"]
    return res


TC_PB_FRESH = """        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        sm90::mma16816<T>(t0, af, bf[0], bf[1]);
        sm90::mma16816<T>(t1, af, bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * nd][e] = __fadd_rn(acc[2 * nd][e], t0[e]);
          acc[2 * nd + 1][e] = __fadd_rn(acc[2 * nd + 1][e], t1[e]);
        }
"""
TC_PB_CHAINED = """        sm90::mma16816<T>(acc[2 * nd], af, bf[0], bf[1]);
        sm90::mma16816<T>(acc[2 * nd + 1], af, bf[2], bf[3]);
"""
FWD_VARIANTS = {
    "as_built": [],
    "cand_only": [("flags |= 1u << bit;", ";")],
    "edges_only": FWD_MAX_FROM_TC,
    "cand_only_no_resum": [("  uint32_t flags = cand;",
                            "  uint32_t flags = 0;"),
                           ("flags |= 1u << bit;", ";")],
    "cheap_dot": [("__device__ __forceinline__ float seq_dot(const T* a, "
                   "const T* b) {\n  float s = 0.f;",
                   "__device__ __forceinline__ float seq_dot(const T* a, "
                   "const T* b) {\n  if (a != nullptr) return to_f(a[0]) * "
                   "to_f(b[0]);\n  float s = 0.f;")],
    # dS's check without the edge below a power of two
    "no_far_edge": [(
        "  return (edge_ulps<T>(t.ds) - b.tp) * d1 <= b.ed ||\n"
        "         (kFarEdge<T> - b.tp) * d1 <= b.ed;",
        "  return (edge_ulps<T>(t.ds) - b.tp) * d1 <= b.ed;")],
    "check_only": [("  for (uint32_t f = flags; f != 0u; f &= f - 1u) {",
                    "  if (flags == 0x7fffffffu) pw[0] = 0.f;\n"
                    "  for (uint32_t f = 0; f != 0u; f &= f - 1u) {")],
    "fwd_2_blocks": [("__launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)\n"
                      "    flash_fwd_tc_kernel",
                      "__launch_bounds__(kTcThreads)\n    flash_fwd_tc_kernel")],
    "fwd_4_blocks": [("__launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)\n"
                      "    flash_fwd_tc_kernel",
                      "__launch_bounds__(kTcThreads, D <= 64 ? 4 : 2)\n"
                      "    flash_fwd_tc_kernel")],
    # fp16's products chained through the accumulator, as bf16's are
    "fp16_chained": [(TC_PB_FRESH, TC_PB_CHAINED)],
    # fp16: one partial product a call (a 32- or 64-deep chain from zero),
    # added to acc with rounded adds
    "fp16_partial": [
        ("    sm90::pack_c_to_a<T>(af, p[2 * kk], p[2 * kk + 1]);",
         "    sm90::pack_c_to_a<T>(af, p[2 * kk], p[2 * kk + 1]);\n"
         "    float (&part)[D / 8][4] = part_;"),
        ("  const int mat = lane >> 3, r8 = lane & 7;\n#pragma unroll\n"
         "  for (int kk = 0; kk < K / 16; ++kk) {\n    uint32_t af[4];",
         "  const int mat = lane >> 3, r8 = lane & 7;\n"
         "  float part_[D / 8][4] = {};\n#pragma unroll\n"
         "  for (int kk = 0; kk < K / 16; ++kk) {\n    uint32_t af[4];"),
        (TC_PB_FRESH,
         "        sm90::mma16816<T>(part[2 * nd], af, bf[0], bf[1]);\n"
         "        sm90::mma16816<T>(part[2 * nd + 1], af, bf[2], bf[3]);\n"),
        ("    }\n  }\n}\n\n// 16 rows x D of fp32 accumulators",
         "    }\n  }\n  if constexpr (std::is_same<T, __half>::value) {\n"
         "#pragma unroll\n  for (int j = 0; j < D / 8; ++j)\n"
         "#pragma unroll\n    for (int e = 0; e < 4; ++e) acc[j][e] = "
         "__fadd_rn(acc[j][e], part_[j][e]);\n  }\n}\n\n"
         "// 16 rows x D of fp32 accumulators")],
}


def fwd_variants(names=None):
    """The kernels at the train shape (fwd, dk/dv, dq ms) per variant of the
    source (FWD_VARIANTS; patched copies), with the worst error over
    FP16_CASES (out and the gradients, fp16 ulps + floor) and over the
    train shape's forward (bf16 ulps + 2**-9)."""
    args, kw = _train_backward_args()
    q, k, v = args[:3]
    flush = _flush()

    def measure():
        row = {"fwd_ms": cs.time_ms(lambda: fa.flash_fwd(q, k, v, **kw),
                                    flush),
               "dkdv_ms": cs.time_ms(lambda: fa.flash_bwd_dkdv(*args, **kw),
                                     flush),
               "dq_ms": cs.time_ms(lambda: fa.flash_bwd_dq(*args, **kw),
                                   flush)}
        out, _ = fa.flash_fwd(q, k, v, **kw)
        ref, _ = fa.flash_fwd_reference(q, k, v, **kw)
        row["bf16_train_out_ratio"] = cs._ulp_ratio(out, ref,
                                                    cs.FLASH_TOL["out_atol"])
        try:
            row["fp16_worst"] = cs.phase_flash_fp16()["worst_ulp_ratio"]
        except AssertionError as err:
            row["fp16_worst"] = "over: " + str(err)[-300:]
        return row

    res = {}
    for name, reps in FWD_VARIANTS.items():
        if names and name not in names:
            continue
        path = _patched(fa, "fwd_" + name, reps) if reps else \
            Path(fa.SOURCE)
        if path is None:
            res[name] = "source changed"
            continue
        regs = {kernel: _registers(path, kernel) for kernel in (
            "flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
            "flash_bwd_dq_tc_kernel")}
        res[name] = _with_source(fa, path, measure)
        res[name]["registers"] = regs
    return res


def _registers(path, kernel, logs={}):
    """{template arguments: registers} of ``kernel``'s builds, from ptxas's
    lines in the build log (built once more for its log)."""
    if path not in logs:
        cuda_build.library_path(path).unlink(missing_ok=True)
        logs[path] = cuda_build.build(path).log.splitlines()
    log = logs[path]
    out = {}
    for i, line in enumerate(log):
        if "Compiling entry function" in line and kernel + "I" in line:
            key = line.split(kernel + "I", 1)[1].split("EEEv")[0]
            for later in log[i + 1:i + 6]:
                if "registers" in later:
                    out[key] = later.split("Used", 1)[1].split(",")[0].strip()
    return out


def _flash_digest():
    """sha256 (first 16 hex digits) of the flash kernels' outputs (out, lse,
    dq, dk, dv) at the train shape (bf16, causal) and at a key-bias case
    each of fp16 (d 128, s 1000), bf16 (d 32, s 384) and fp32 (d 64, s
    200): equal digests from two trees mean bit-equal kernels."""
    import hashlib
    digest = hashlib.sha256()
    for dtype, shape, bias in (
            (torch.bfloat16, cs.FLASH_SHAPE, False),
            (torch.float16, dict(b=2, s=1000, h=4, d=128), True),
            (torch.bfloat16, dict(b=2, s=384, h=4, d=32), True),
            (torch.float32, dict(b=2, s=200, h=4, d=64), True)):
        q, k, v, dout = (t.to(dtype) for t in cs.flash_case(DEV, shape,
                                                              seed=3))
        h = shape["h"]
        kb = None
        if bias:
            gen = torch.Generator(device=DEV).manual_seed(1)
            kb = torch.randn((shape["b"], shape["s"]), generator=gen,
                             device=DEV)
            kb[:, -7:] = -1e4
        kw = dict(num_heads=h, causal=not bias)
        out, lse = fa.flash_fwd(q, k, v, kb, **kw)
        args = (q, k, v, kb, dout, lse, fa.attention_delta(out, dout, h))
        for t in (out, lse, fa.flash_bwd_dq(*args, **kw),
                  *fa.flash_bwd_dkdv(*args, **kw)):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
    return digest.hexdigest()[:16]


def flash_times():
    """The three flash kernels at the train shape (bf16, causal) and
    ring_ag_gemm summed over its four TP 2 sites, ms, on the tree this
    script's parent directory holds (run a copy of it from another tree's
    probes/ to time that tree in the same call)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args, kw = _train_backward_args()
    q, k, v = args[:3]
    flush = _flush()
    res = {"tree": str(ROOT),
           "fwd_ms": cs.time_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush),
           "dkdv_ms": cs.time_ms(lambda: fa.flash_bwd_dkdv(*args, **kw),
                                 flush),
           "dq_ms": cs.time_ms(lambda: fa.flash_bwd_dq(*args, **kw), flush)}
    gen = torch.Generator(device=DEV).manual_seed(5)
    for name, key in (("ring_ag_gemm", "ag_ms"), ("ring_rs_gemm_add", "rs_ms")):
        res[key] = sum(
            cs.time_ms(cs.ring_case(name, k_, n, mode, DEV, gen)[0], flush)
            for _, k_, n, mode in cs.RING_SITES[name])
    bsa, sargs, skw = _sparse_backward_args()
    res["sparse_fwd_ms"] = cs.time_ms(
        lambda: bsa.block_sparse_fwd(*sargs[:3], **skw), flush)
    res["sparse_dq_ms"] = cs.time_ms(
        lambda: bsa.block_sparse_bwd_dq(*sargs, **skw), flush)
    res["sparse_dkdv_ms"] = cs.time_ms(
        lambda: bsa.block_sparse_bwd_dkdv(*sargs, **skw), flush)
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    case = cs.paged_case(1, seed=1, device=DEV)
    pargs = (case["q"], case["k_pool"], case["v_pool"], case["page_tables"],
             case["positions"], case["valid_lens"])
    res["paged_ms"] = cs.time_ms(lambda: paged_attention(
        *pargs, layer_idx=0, page_size=case["page_size"]), flush)
    res["flash_digest"] = _flash_digest()
    return res


def ag_variants():
    """ring_ag_gemm at its four TP 2 sites against torch.matmul, per site."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    flush = _flush()
    gen = torch.Generator(device=DEV).manual_seed(5)
    rows = {}
    for site, k, n, mode in cs.RING_SITES["ring_ag_gemm"]:
        kern, plain, lib, get, flops, nbytes = cs.ring_case(
            "ring_ag_gemm", k, n, mode, DEV, gen)
        ms = cs.time_ms(kern, flush)
        rows[site] = {"ms": ms, "matmul_ms": cs.time_ms(lib, flush),
                      "tflops": flops / ms / 1e9}
    rows["sum_ms"] = sum(r["ms"] for r in rows.values())
    return rows


def rs_variants():
    """ring_rs_gemm_add at its four TP 2 sites against torch.matmul, per
    site, and the plain version's outputs against the kernel's (largest
    error over its RING_TOL bound)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    flush = _flush()
    gen = torch.Generator(device=DEV).manual_seed(5)
    rows = {}
    for site, k, n, mode in cs.RING_SITES["ring_rs_gemm_add"]:
        kern, plain, lib, get, flops, nbytes = cs.ring_case(
            "ring_rs_gemm_add", k, n, mode, DEV, gen)
        kern()
        plain()
        _, ratio = cs._ring_err(get(0), get(1), cs.RING_TOL["ring_rs_gemm_add"])
        ms = cs.time_ms(kern, flush)
        rows[site] = {"ms": ms, "matmul_ms": cs.time_ms(lib, flush),
                      "tflops": flops / ms / 1e9, "err_over_bound": ratio}
    rows["sum_ms"] = sum(r["ms"] for r in rows.values())
    return rows


def _sparse_backward_args(section=None):
    """The train_sparse shape's operands, the layout's tables (the train
    config's shared layout by default) and the backward's arguments."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    section = section or cs.SPARSE_TRAIN
    b, s, h, d = (cs.SPARSE_SHAPE[x] for x in "bshd")
    q, k, v, dout = cs.sparse_case(DEV)
    tables = bsa.LayoutTables(cs.sparse_layout(section, h, s),
                              section["block"])
    kw = dict(tables=tables, causal=True)
    out, lse = bsa.block_sparse_fwd(q, k, v, **kw)
    delta = bsa.attention_delta(out, dout)
    return bsa, (q, k, v, None, None, dout, lse, delta), kw


def _warp_step_share(tables, walk, step):
    """Share of (warp, step) pairs of a walk in which the layout holds a
    pair of the warp's 16 anchor rows (one unit, one block): the steps a
    warp does not skip. ``step`` tokens a step (64 for dq, 32 for dk/dv)."""
    w = getattr(tables, walk)
    lay = tables.layout if walk == "fwd" else \
        tables.layout.transpose(0, 2, 1)
    blk = tables.block
    held = total = 0
    for h in range(tables.layout_heads):
        pos = w.anchor_positions(h)
        for t in range(w.n_tiles):
            toks = (w.walk(h, t)[:, None] * blk + np.arange(blk)).reshape(-1)
            rows = [pos[t, 16 * i] // blk for i in range(4) if
                    pos[t, 16 * i] >= 0]
            for s0 in range(0, len(toks), step):
                cols = np.unique(toks[s0:s0 + step] // blk)
                total += len(rows)
                held += sum(bool(lay[h, r, cols].any()) for r in rows)
    return held / max(total, 1)


SPARSE_PARTS = {
    "no_check": [("if (near_plain_edge<T>(t, b)) flags |= 1u << (j8 * 4 + e);",
                  ";"),
                 ("if (near_plain_edge<T>(t, b)) flags |= 1u << (j * 4 + e);",
                  ";")],
}
SPARSE_PARTS["no_norms"] = SPARSE_PARTS["no_check"] + [
    ("  return sqrtf(((acc[0]", "  return 1.f; return sqrtf(((acc[0]")]


def sparse_parts():
    """The bf16 block-sparse dq and dk/dv kernels at the train_sparse shape
    (shared and per-head layouts): as built; with the rounding-edge check
    and re-sum switched off in patched copies (results wrong, time only);
    also without the row norms; and the share of warp-steps that hold a
    pair."""
    flush = _flush()
    res = {}
    for lname, section in (("shared", cs.SPARSE_TRAIN),
                           ("per_head", cs.SPARSE_PARITY)):
        bsa, args, kw = _sparse_backward_args(section)
        tables = kw["tables"]

        def timed():
            return {"dq_ms": cs.time_ms(
                lambda: bsa.block_sparse_bwd_dq(*args, **kw), flush),
                    "dkdv_ms": cs.time_ms(
                lambda: bsa.block_sparse_bwd_dkdv(*args, **kw), flush)}

        row = {"as_built": timed(), "tiles": tables.bwd.n_tiles,
               "warp_steps_with_a_pair": {
                   "dq": _warp_step_share(tables, "fwd", 64),
                   "dkdv": _warp_step_share(tables, "bwd", 32)}}
        for name, reps in SPARSE_PARTS.items():
            path = _patched(bsa, name, reps)
            row[name] = "source changed" if path is None else \
                _with_source(bsa, path, timed)
        res[lname] = row
    return res


SPARSE_CHAINED = [
    ("tc_pb_step<T, D, R>(dq", "tc_pb<T, D, R>(dq"),
    ("tc_pb_step<T, D, BQ>(dv", "tc_pb<T, D, BQ>(dv"),
    ("tc_pb_step<T, D, BQ>(dk", "tc_pb<T, D, BQ>(dk")]
SPARSE_ALL_RESUMMED = [
    ("if (near_plain_edge<T>(t, b)) flags |= 1u << (j8 * 4 + e);",
     "flags |= 1u << (j8 * 4 + e);"),
    ("if (near_plain_edge<T>(t, b)) flags |= 1u << (j * 4 + e);",
     "flags |= 1u << (j * 4 + e);")]
SPARSE_ACCUMULATION = {
    "as_built": [], "chained": SPARSE_CHAINED,
    "as_built_all_resummed": SPARSE_ALL_RESUMMED,
    "chained_all_resummed": SPARSE_CHAINED + SPARSE_ALL_RESUMMED}
# long transposed walks: (ds_config section, heads, seq, d, key bias)
SPARSE_LONG_CASES = {
    "bslongformer_b128_d128_kpm": (
        {"mode": "bslongformer", "global_block_indices": [0],
         "block": 128}, 4, 1536, 128, True),
    "fixed_s4096": ({"mode": "fixed", "num_local_blocks": 4,
                     "num_global_blocks": 1, "attention": "unidirectional",
                     "block": 16}, 2, 4096, 64, False)}


def sparse_accumulation():
    """The bf16 block-sparse dq, dk, dv against their plain versions
    (largest |kernel - plain| / (2^-7 |plain| + 1e-6): at most 1 within
    one bf16 ulp) at two cases of long transposed walks, causal, b 2,
    numpy-seeded data (a key bias with 20% of keys at -1e4 where named),
    per patched variant: as built (each step's product from zero, added
    with a rounded fp32 add), chained through the tensor cores'
    accumulator as the flash kernels at bf16, and each with every pair's
    P and dS summed again in the plain order."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    torch.backends.cuda.matmul.allow_tf32 = False

    def ratio(got, want):
        want = want.float()
        return float(((got.float() - want).abs() /
                      (2 ** -7 * want.abs() + 1e-6)).max())

    def cases():
        out = {}
        for name, (section, h, s, d, kpm) in SPARSE_LONG_CASES.items():
            rng = np.random.RandomState(0)
            tables = bsa.LayoutTables(cs.sparse_layout(section, h, s),
                                      section["block"])
            to = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEV)
            qkv = to(rng.randn(2, s, 3 * h * d)).to(torch.bfloat16)
            q, k, v = (t.reshape(2, s, h, d).transpose(1, 2)
                       for t in qkv.split(h * d, dim=-1))
            dout = to(rng.randn(2, h, s, d)).to(torch.bfloat16)
            bias = None
            if kpm:
                a = rng.randn(2, s)
                a[rng.rand(2, s) < 0.2] = -1e4
                bias = to(a)
            kw = dict(tables=tables, causal=True)
            o, lse = bsa.block_sparse_fwd(q, k, v, bias, None, **kw)
            delta = bsa.attention_delta(o, dout)
            args = (q, k, v, bias, None, dout, lse, delta)
            got = (bsa.block_sparse_bwd_dq(*args, **kw),
                   *bsa.block_sparse_bwd_dkdv(*args, **kw))
            ref = (bsa.block_sparse_bwd_dq_reference(*args, **kw),
                   *bsa.block_sparse_bwd_dkdv_reference(*args, **kw))
            out[name] = {g: ratio(a, b) for g, a, b in
                         zip(("dq", "dk", "dv"), got, ref)}
        return out

    res = {}
    for name, reps in SPARSE_ACCUMULATION.items():
        path = _patched(bsa, "acc_" + name, reps) if reps else None
        if reps and path is None:
            res[name] = "source changed"
            continue
        res[name] = _with_source(bsa, path, cases) if path else cases()
    return res


def _paged_module():
    import importlib
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.paged_attention.paged_attention")


# a second launch combines the split partials (the ticket never fires)
PAGED_TWO_LAUNCHES = [
    ("  if (tid == 0) last_block = atomicAdd(ticket, 1) == n_live - 1;",
     "  if (tid == 0) last_block = 0;"),
    ("template <typename T, int QG>\ncudaError_t launch_qg(",
     "__global__ void __launch_bounds__(kThreads)\n"
     "    paged_combine_kernel(const PagedParams p) {\n"
     "  const int head = blockIdx.x, slot = blockIdx.y;\n"
     "  const int live = p.positions[slot] + p.valid_lens[slot] - 1;\n"
     "  const int n_keys = min(max(live + 1, 0), p.max_pages * "
     "p.page_size);\n"
     "  const int run = p.chunk * p.rounds;\n"
     "  const int n_live = max(1, (n_keys + run - 1) / run);\n"
     "  if (n_live > 1) combine_splits(p, slot, head, n_live);\n}\n\n"
     "template <typename T, int QG>\ncudaError_t launch_qg("),
    ("  paged_attention_kernel<T, QG><<<grid, kThreads, smem, stream>>>(p);\n",
     "  paged_attention_kernel<T, QG><<<grid, kThreads, smem, stream>>>(p);\n"
     "  if (p.splits > 1)\n    paged_combine_kernel<<<dim3(p.h, p.b), "
     "kThreads, 0, stream>>>(p);\n")]
PAGED_K_GROUPS = "constexpr int kKGroups = 2;"
# name: (STAGE_BYTES, patch): the keys a round follow STAGE_BYTES (64 / 128
# / 256 at bf16, d_head 64)
PAGED_VARIANTS = {
    "as_built": (None, None),
    "chunk64": (16 * 1024, None),
    "chunk256": (64 * 1024, None),
    "stages1": (None, [(PAGED_K_GROUPS, PAGED_K_GROUPS.replace("2", "1"))]),
    "stages4": (None, [(PAGED_K_GROUPS, PAGED_K_GROUPS.replace("2", "4"))]),
    "two_launches": (None, PAGED_TWO_LAUNCHES)}


def paged_variants(names=None):
    """The paged decode kernel per variant (PAGED_VARIANTS) at the kernel
    phase's s = 1 case and with every slot at 1024 live keys: splits, ms
    and the largest error against the plain version."""
    pam = _paged_module()
    flush = _flush()
    cases = {"kernel_case": cs.paged_case(1, seed=1, device=DEV),
             "all_1024": cs.paged_case(1, seed=1, device=DEV, live=1024)}
    res = {}
    for name, (stage_bytes, reps) in PAGED_VARIANTS.items():
        if names and name not in names:
            continue
        path = _patched(pam, name, reps) if reps else None
        if reps and path is None:
            res[name] = "source changed"
            continue
        saved = pam.STAGE_BYTES
        pam.STAGE_BYTES = stage_bytes or pam.STAGE_BYTES

        def measure():
            row = {}
            for cname, case in cases.items():
                args = (case["q"], case["k_pool"], case["v_pool"],
                        case["page_tables"], case["positions"],
                        case["valid_lens"])
                kw = dict(layer_idx=0, page_size=case["page_size"])
                got = pam.paged_attention(*args, **kw)
                want = pam.paged_attention_reference(*args, **kw)
                row[cname] = {
                    "ms": cs.time_ms(lambda: pam.paged_attention(*args, **kw),
                                     flush),
                    "max_abs_err": float((got - want).abs().max()),
                    "plan": pam.launch_plan(
                        2, case["q"].shape[-1],
                        case["page_tables"].shape[1] * case["page_size"])}
            return row
        try:
            res[name] = _with_source(pam, path, measure) if path else \
                measure()
        finally:
            pam.STAGE_BYTES = saved
    return res


SPARSE_FWD_PARTS = {"no_check": FLASH_PARTS["no_check"],
                    "no_norms": FLASH_PARTS["no_norms"]}


def sparse_fwd_parts():
    """The bf16 block-sparse forward at the train_sparse shape (shared and
    per-head layouts): as built; with the exactness check and re-sums
    switched off in patched copies (results wrong, time only); also
    without the row norms; and the share of warp-steps (16 rows x 64 keys)
    that hold a pair."""
    flush = _flush()
    res = {}
    for lname, section in (("shared", cs.SPARSE_TRAIN),
                           ("per_head", cs.SPARSE_PARITY)):
        bsa, args, kw = _sparse_backward_args(section)
        q, k, v = args[:3]

        def timed():
            return {"fwd_ms": cs.time_ms(
                lambda: bsa.block_sparse_fwd(q, k, v, **kw), flush)}

        row = {"as_built": timed(), "warp_steps_with_a_pair":
               _warp_step_share(kw["tables"], "fwd", 64)}
        for name, reps in SPARSE_FWD_PARTS.items():
            path = _patched(bsa, "fwd_" + name, reps)
            row[name] = "source changed" if path is None else \
                _with_source(bsa, path, timed)
        res[lname] = row
    return res


SECTIONS = {"s_order": s_order, "cublas_order": cublas_order,
            "flash_parts": flash_parts, "flash_flags": flash_flags,
            "gc_variants": gc_variants, "fp16_backward": fp16_backward,
            "ag_variants": ag_variants, "fwd_variants": fwd_variants,
            "flash_times": flash_times, "rs_variants": rs_variants,
            "sparse_parts": sparse_parts,
            "sparse_accumulation": sparse_accumulation,
            "paged_variants": paged_variants,
            "sparse_fwd_parts": sparse_fwd_parts}


def main():
    """SECTION[:a,b] runs a section on the named variants only (the
    sections taking ``names``)."""
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: no CUDA device is available")
    names = sys.argv[1:] or list(SECTIONS)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for arg in names:
        name, _, only = arg.partition(":")
        fn = SECTIONS[name]
        result = fn(only.split(",")) if only else fn()
        print(json.dumps({"section": name, "result": result}, default=str),
              flush=True)


if __name__ == "__main__":
    main()
