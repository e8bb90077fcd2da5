#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
with no ``ok`` line):

1. device  — the card's name and power limit from ``nvidia-smi``;
2. build   — every kernel source of the paths built with nvcc from the
   checkout, all builds started together;
3. kernel  — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its time, the plain version's, the least time
   the card could take (``bound_ms``) and a PyTorch library call's where
   one exists: paged attention (the serve path's decode shape, two runs
   bit-identical, its splits, and timed with every slot at 64, 512 and
   1024 live keys beside SDPA and the bound), the flash
   forward, dk/dv and dq kernels (b 16, s 1024, h 16, d 64, bf16, causal,
   q/k/v strided column blocks of one QKV tensor; two runs of each
   bit-identical), the same three in the
   BERT path's mode (``flash_bert``: b 32, s 512, h 16, d 64, bf16,
   non-causal, the fp32 key bias of the train_bert batch's padded mask,
   also timed without the bias) and Adam (one flat fp32 buffer of
   GPT-2-350M's size);
4. train   — the training main path: ``initialize(...).train_batch(...)``
   on GPT-2-350M (``gpt2_medium``) at full width and depth, seq 1024,
   bf16, ZeRO-2, Adam with fp32 moments, the flash and Adam kernels
   chosen by "auto"; every kernel's launch count set to 0 just before the
   timed steps and read just after; then a torch.profiler window;
5. train-parity — fp32 loss trajectories with the kernels and with the
   plain versions, at gpt2_medium width with 2 layers;
6. block_sparse_attention kernel phase — the three block-sparse kernels
   against their plain versions at the long-context train shape (b 2,
   s 8192, h 16, d 64, bf16, causal), over the train config's shared
   ``fixed`` layout and the parity config's per-head layout (the forward
   and the two backward kernels also bit for bit over two runs; the fp16
   forward, on the same tensor-core kernel, within one fp16 ulp of its
   plain version plus eps / 4), timed beside their
   bounds, ``flex_attention`` (torch.compile, same block mask) and
   ``scaled_dot_product_attention`` with the layout as a dense mask;
7. train_sparse — the long-context main path: ``initialize(...)
   .train_batch(...)`` on gpt2_medium at full width and depth, seq 8192,
   micro batch 2, with the ds_config ``sparse_attention`` section (the
   documented ``fixed`` layout, unidirectional); counts set to 0 just
   before the timed steps and read just after; a torch.profiler window;
8. train_sparse_parity — fp32 loss trajectories through the block-sparse
   kernels and through their plain versions, a per-head layout, at
   gpt2_medium width with 2 layers, seq 2048;
9. serve   — the serving main path: ``init_inference(...).generate(...)``
   serving 48 requests with gpt2_medium at full width and depth, bf16,
   from the paged KV cache, counts set to 0 just before and read just
   after; then a few all-slot decode steps under torch.profiler;
10. parity — fp32 greedy streams identical for the slot layout, the paged
   layout's plain read path and the paged kernel, on the card;
11. flash3d — the JAX package's 3D flash API (``flash_attention``, (b * h,
   s, d) operands) at (32 * 16, 512, 64) bf16, causal and not: the same
   op through its autograd against direct kernel calls, the kernels
   against their plain versions, timed; then ``flash_fp32_repeats``: the
   fp32 key-mask case of the GPU tests (b 2, s 96, h 2, d 32) 60 times,
   every run bit-identical, the worst element against the CPU run printed,
   and each run's out against a float64 evaluation;
   then ``flash_fp16``: the fp16 forward, dk/dv and dq (tensor cores)
   against their plain versions at probes/kernel_probe.py fp16_backward's
   cases (d 32 / 128, s 96 / 1000, causal or not, a key bias dropping 20%
   of keys) and one whose P and dS fall into fp16's subnormal range, each
   within one fp16 ulp of the plain value plus 1e-6 (eps / 4 for out);
12. lamb — the LAMB stage-1 and apply kernels against their plain
   versions over one flat fp32 buffer of BERT-large's size with its real
   segment table (26 parameters, 336,232,258 elements), the per-segment
   sums (|p|^2, |u|^2) included, timed;
13. train_bert — the BERT main path: ``initialize(...).train_batch(...)``
   on BERT-large at full width and depth, seq 512, micro batch 32, bf16,
   ZeRO-2, LAMB with fp32 moments, remat on, dropout 0, a padded
   key mask (the flash kernels non-causal with a key bias); counts set to
   0 just before the timed steps and read just after; a torch.profiler
   window;
14. train_bert_parity — fp32 loss trajectories with the kernels (flash +
   LAMB) and with the plain versions (einsum attention + plain LAMB), at
   BERT-large width with 2 layers, seq 128, the padded mask;
15. ring_gemm — the three ring-step kernels of the tensor-parallel path
   (all-gather-matmul, matmul-reduce-scatter with the add, the dW
   gather-contract) at gpt2_medium TP 2's shapes (b 16, s 1024, four
   sites each, bf16, transposed weight views as the backward gives
   them) against their plain versions, per element (all three also bit
   for bit over two runs), timed beside their bounds and torch.matmul of
   the same product;
16. train_tp — the tensor-parallel main path: two spawned ranks sharing
   this card (gloo, each hop through host memory), each
   ``initialize(mesh=build_mesh(model=2), ...)`` with the ds_config
   ``comm.collective_matmul`` section (backend "pallas"), gpt2_medium at
   full width and depth, seq 1024, micro 16, bf16, ZeRO-2, Adam; counts
   set to 0 just before the timed steps and read just after, per rank;
17. train_tp_parity — fp32 loss trajectories at gpt2_medium width with 2
   layers: TP 2 through the ring kernels and through the plain ring, and
   the TP 1 engine, from the same init;
18. train_tp_lamb — LAMB at TP 2 (ring and LAMB kernels, rank 0's half of
   every fc kernel scaled x20) against the TP 1 engine, fp32, 2 layers:
   losses and fc masters;

then one ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
``python3 chip_smoke.py --tp-nccl`` (four cards) runs, after the build,
only the NCCL mode: TP 2 and TP 4 with one rank per card, each site's
ring op against the unfused collective + torch.matmul, and the train_tp
step on both backends.
Weights are random, from a seed; nothing is downloaded. Exits non-zero
without a result when CUDA is unavailable.
"""
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
L2_FLUSH_BYTES = 512 * 2 ** 20   # > the 50 MB L2, and covers launch latency
SERVE_LAYERS = 24                # gpt2_medium depth


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush, reps=25):
    """Median device time of one ``fn()`` call by CUDA events, the L2
    cache flushed before each call."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernel case


def paged_case(s, seed, device, live=None):
    """The serving path's paged-attention shapes: 16 slots, 16 heads,
    d_head 64, pages of 16 tokens, the full gpt2_medium pool (1024 usable
    pages + garbage page 0, 24 layers) in bf16, 64 pages per table.
    Lengths spread to 1023 so windows cross page boundaries (``live``:
    every slot at that many keys with its s queries); garbage page
    0 and every unallocated page are NaN. With s > 1 the valid lengths
    are padded (some slots have fewer real queries than s)."""
    import torch
    b, h, dh, ps, max_pages, layers, usable = 16, 16, 64, 16, 64, 24, 1024
    rng = np.random.RandomState(seed)
    positions = np.linspace(0, max_pages * ps - s, b).round().astype(np.int32)
    if live is not None:
        positions = np.full(b, live - s, np.int32)
    valid_lens = np.full(b, s, np.int32)
    if s > 1:
        valid_lens = rng.randint(1, s + 1, size=b).astype(np.int32)
        valid_lens[0] = s
    page_tables = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, usable + 1)))
    for i in range(b):
        need = -(-(int(positions[i]) + s) // ps)
        page_tables[i, :need] = [free.pop() for _ in range(need)]
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (usable + 1, layers, h, ps, dh)
    k_pool = torch.randn(shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
    dead = torch.ones(usable + 1, dtype=torch.bool, device=device)
    dead[torch.from_numpy(page_tables[page_tables > 0]).long().to(device)] = \
        False
    k_pool[dead] = float("nan")
    v_pool[dead] = float("nan")
    q = torch.randn((b, s, h, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    as_dev = lambda a: torch.from_numpy(a).to(device)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool,
                page_tables=as_dev(page_tables), positions=as_dev(positions),
                valid_lens=as_dev(valid_lens), page_size=ps)


def paged_bound_ms(case):
    """Least time for the work this case's data needs: each live K/V row
    read once, q read once, the fp32 context written once; 4 flops per
    (query, live key, d) for QK^T and PV."""
    q = case["q"]
    b, s, h, dh = q.shape
    live = (case["positions"] + case["valid_lens"]).long().cpu().numpy()
    n_keys = int(np.minimum(live, case["page_tables"].shape[1] *
                            case["page_size"]).sum())
    elem = case["k_pool"].element_size()
    nbytes = (2 * n_keys * h * dh * elem + q.numel() * elem +
              q.numel() * 4 + case["page_tables"].numel() * 4 + 2 * b * 4)
    flops = 4 * s * n_keys * h * dh
    return bound_ms(nbytes, flops, FP32_FLOPS_PER_S)


def bound_ms(nbytes, flops, flops_per_s):
    """(ms, "bytes" | "operations"): the larger of the bytes' time at the
    card's memory rate and the operations' time at ``flops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def paged_library_ms(case, flush):
    """Yardstick: scaled_dot_product_attention over the case's rows
    gathered into contiguous memory beforehand (the gather itself is
    excluded), the live window as a boolean mask."""
    import torch
    import torch.nn.functional as F
    device = case["q"].device
    b, _, h, dh = case["q"].shape
    index = case["page_tables"].long()
    rows_of = lambda pool: torch.nan_to_num(pool[:, 0][index]).permute(
        0, 2, 1, 3, 4).reshape(b, h, -1, dh).contiguous()
    k_rows, v_rows = rows_of(case["k_pool"]), rows_of(case["v_pool"])
    live = (case["positions"] + case["valid_lens"] - 1).long()
    mask = (torch.arange(k_rows.shape[2], device=device)[None, :] <=
            live[:, None])[:, None, None, :]
    qh = case["q"].transpose(1, 2).contiguous()
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, k_rows, v_rows, attn_mask=mask), flush)


def phase_kernel(flush):
    """paged_attention vs paged_attention_reference on the card; two runs
    bit for bit; timed at the decode shape of the path and with every slot
    at 64, 512 and 1024 live keys."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)
    from deepspeed_tpu_torch.ops.paged_attention.paged_attention import \
        launch_plan
    device = torch.device("cuda", 0)
    max_err, checks, repeat_equal = 0.0, [], True
    for s in (1, 4):
        case = paged_case(s, seed=s, device=device)
        for layer in (0, SERVE_LAYERS - 1):
            args = (case["q"], case["k_pool"], case["v_pool"],
                    case["page_tables"], case["positions"],
                    case["valid_lens"])
            kw = dict(layer_idx=layer, page_size=case["page_size"])
            got = paged_attention(*args, **kw)
            again = paged_attention(*args, **kw)
            want = paged_attention_reference(*args, **kw)
            torch.cuda.synchronize()
            repeat_equal = repeat_equal and torch.equal(got, again)
            # valid query rows only: a padded row's reference output reads
            # past the live window by design
            vl = case["valid_lens"].cpu().numpy()
            rows = torch.zeros(got.shape[:2], dtype=torch.bool,
                               device=device)
            for i, n in enumerate(vl):
                rows[i, :n] = True
            g, w = got[rows], want[rows]
            assert not torch.isnan(g).any(), "NaN in a live kernel row"
            assert torch.isfinite(w).all(), "non-finite reference row"
            err = float((g - w).abs().max())
            checks.append({"s": s, "layer": layer, "max_abs_err": err})
            max_err = max(max_err, err)
    assert max_err <= 2e-5, "paged_attention off its plain version by " \
        "{} > 2e-5".format(max_err)
    assert repeat_equal, "two paged_attention runs differ"

    # times at the decode shape of the path (s = 1), then the sweep
    timed = {}
    for name, live in (("kernel_case", None), ("all_64", 64),
                       ("all_512", 512), ("all_1024", 1024)):
        case = paged_case(1, seed=1, device=device, live=live)
        args = (case["q"], case["k_pool"], case["v_pool"],
                case["page_tables"], case["positions"], case["valid_lens"])
        kw = dict(layer_idx=0, page_size=case["page_size"])
        bound = paged_bound_ms(case)
        timed[name] = {
            "kernel_ms": time_ms(lambda: paged_attention(*args, **kw), flush),
            "library_ms": paged_library_ms(case, flush),
            "bound_ms": bound[0], "bound_by": bound[1]}
        if live is None:
            timed[name]["plain_ms"] = time_ms(
                lambda: paged_attention_reference(*args, **kw), flush)
    b, _, h, dh = case["q"].shape
    chunk, rounds, splits = launch_plan(case["q"].element_size(), dh,
                                        case["page_tables"].shape[1] *
                                        case["page_size"])
    row = timed.pop("kernel_case")
    return {"phase": "kernel", "name": "paged_attention", "checks": checks,
            "max_abs_err": max_err, "tolerance": 2e-5,
            "repeat_bit_equal": repeat_equal, **row,
            "sweep_every_slot_at": timed,
            "launch": {"splits": splits, "keys_a_round": chunk,
                       "rounds_a_split": rounds,
                       "blocks": b * h * splits},
            "library_call": "F.scaled_dot_product_attention over pre-gathered "
                            "contiguous rows, gather excluded",
            "shape": {"slots": b, "heads": h, "d_head": dh, "page_size": 16,
                      "max_pages": 64, "pool_dtype": "bf16", "s": 1}}


# ------------------------------------------------ flash attention and Adam


FLASH_SHAPE = dict(b=16, s=1024, h=16, d=64)     # the train path's
BERT_FLASH_SHAPE = dict(b=32, s=512, h=16, d=64)  # the train_bert path's
# Per element, |kernel - plain| <= 2**-7 * |plain| + atol: one bf16 ulp of
# the plain value, plus a floor. The backward kernels round ds at the
# plain version's points, so their floor is ~0; out's floor is one ulp at
# |out| in [0.25, 0.5), where a reordered fp32 sum may round the other way.
FLASH_TOL = {"ulp_rel": 2 ** -7, "out_atol": 2 ** -9, "grad_atol": 1e-6,
             "lse": 1e-4}


def flash_case(device, shape=FLASH_SHAPE, seed=0):
    """A path's attention operands: q, k, v as the column blocks of one
    (b, s, 3 * h * d) bf16 QKV tensor (row stride 3 * h * d), as the
    layers' QKV projections produce them, and an output gradient."""
    import torch
    b, s, h, d = (shape[k] for k in "bshd")
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    dout = torch.randn((b, s, h * d), generator=gen, device=device,
                       dtype=torch.bfloat16)
    return q, k, v, dout


def flash_bound(q, h, mults, tensors, causal=True):
    """Least time for ``mults`` products per (query, key) pair over the
    pairs these inputs need (key <= query when causal, all pairs
    otherwise), at the bf16 tensor-core rate, against each of ``tensors``
    moved once."""
    b, s, hd = q.shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 2 * mults * pairs * (hd // h)
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    return bound_ms(nbytes, flops, BF16_FLOPS_PER_S)


def _ulp_ratio(got, want, atol):
    """max over elements of |got - want| / (2**-7 |want| + atol): at most
    1 when every element is within the per-element bound."""
    want = want.float()
    return float(((got.float() - want).abs() /
                  (FLASH_TOL["ulp_rel"] * want.abs() + atol)).max())


def flash_check_and_time(q, k, v, dout, bias, h, causal, flush):
    """The three flash kernels on packed (b, s, h * d) operands with an
    optional fp32 (b, s) key ``bias``: out, lse, dq, dk, dv held to the
    plain versions at FLASH_TOL, then each kernel timed beside its plain
    version, its bound and SDPA on contiguous (b, h, s, d) copies (the
    bias as a boolean key mask). Returns (errors, rows by kernel name)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    kw = dict(num_heads=h, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, bias, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, bias, **kw)
    delta = fa.attention_delta(out, dout, h)
    args = (q, k, v, bias, dout, lse, delta)
    dk, dv = fa.flash_bwd_dkdv(*args, **kw)
    dq = fa.flash_bwd_dq(*args, **kw)
    again = fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
    fwd_again = fa.flash_fwd(q, k, v, bias, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(*args, **kw)
    ref_dq = fa.flash_bwd_dq_reference(*args, **kw)
    torch.cuda.synchronize()
    abs_err = lambda a, b: float((a.float() - b.float()).abs().max())
    pairs = {"out": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk),
             "dv": (dv, ref_dv)}
    errs = {"lse": abs_err(lse, ref_lse)}
    for name, (got, want) in pairs.items():
        atol = FLASH_TOL["out_atol" if name == "out" else "grad_atol"]
        errs[name + "_abs"] = abs_err(got, want)
        errs[name + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
    errs["bwd_repeat_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(again, (dk, dv, dq)))
    errs["fwd_repeat_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(fwd_again, (out, lse)))
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t.float()).all(), "non-finite kernel output"
    assert errs["lse"] <= FLASH_TOL["lse"], errs
    assert max(errs[n + "_ulp_ratio"] for n in pairs) <= 1.0, errs
    assert errs["bwd_repeat_bit_equal"], "two backward runs differ"
    assert errs["fwd_repeat_bit_equal"], "two forward runs differ"
    del ref_out, ref_lse, ref_dk, ref_dv, ref_dq, again, fwd_again

    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, bias, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, bias, **kw)),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args, **kw),
                           lambda: fa.flash_bwd_dkdv_reference(*args, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args, **kw),
                         lambda: fa.flash_bwd_dq_reference(*args, **kw)),
    }
    bounds = {
        "flash_fwd": flash_bound(q, h, 2, (q, k, v, bias, out, lse), causal),
        "flash_bwd_dkdv": flash_bound(q, h, 4, (q, k, v, bias, dout, lse,
                                                delta, dk, dv), causal),
        "flash_bwd_dq": flash_bound(q, h, 3, (q, k, v, bias, dout, lse,
                                              delta, dq), causal),
    }
    # yardstick: scaled_dot_product_attention on pre-transposed contiguous
    # (b, h, s, d) copies (the transposes excluded); its backward is its
    # forward + backward minus its forward, and computes dq, dk, dv at once
    heads = lambda t: t.reshape(t.shape[0], t.shape[1], h, -1).transpose(
        1, 2).contiguous()
    qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
    doh = heads(dout)
    keep = None if bias is None else (bias == 0)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep,
                                                  is_causal=causal)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa, flush)
    lib_fwd_bwd = time_ms(
        lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), flush)
    library = {"flash_fwd": lib_fwd,
               "flash_bwd_dkdv": lib_fwd_bwd - lib_fwd,
               "flash_bwd_dq": lib_fwd_bwd - lib_fwd}
    rows = {}
    for name, (kernel, plain) in times.items():
        rows[name] = {"kernel_ms": time_ms(kernel, flush),
                      "plain_ms": time_ms(plain, flush, reps=5),
                      "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1],
                      "library_ms": library[name]}
    return errs, rows


def phase_flash(flush):
    """The three flash kernels at the GPT-2 train path's shape (causal, no
    bias) against their plain versions, timed."""
    import torch
    h = FLASH_SHAPE["h"]
    q, k, v, dout = flash_case(torch.device("cuda", 0))
    errs, rows = flash_check_and_time(q, k, v, dout, None, h, True, flush)
    return {"phase": "kernel", "name": "flash_attention", "errors": errs,
            "tolerance": FLASH_TOL, "kernels": rows,
            "library_call": "F.scaled_dot_product_attention(is_causal=True) "
                            "on contiguous (b, h, s, d) copies; the "
                            "backward's time covers dq, dk and dv together",
            "shape": dict(FLASH_SHAPE, dtype="bf16", causal=True,
                          qkv_row_stride=3 * h * FLASH_SHAPE["d"])}


def phase_flash_bert(flush):
    """The three flash kernels in the BERT path's mode: non-causal with
    the fp32 (b, s) key bias the layer makes (``_expand_mask``) from the
    train_bert batch's padded mask, at BERT-large's attention shape, q/k/v
    strided as the layer's QKV projection gives them; held to the plain
    versions at FLASH_TOL and timed, then timed again without the bias at
    the same shape, so the bias's cost is a measured difference."""
    import torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer.transformer import _expand_mask
    device = torch.device("cuda", 0)
    h = BERT_FLASH_SHAPE["h"]
    cfg = bert.config_for("bert_large", max_seq_len=BERT_SEQ)
    keep = torch.from_numpy(bert_batch(cfg, BERT_MICRO, BERT_SEQ,
                                       seed=0)[2][0]).to(device)
    bias = _expand_mask(keep, torch.float32)[:, 0, 0, :].contiguous()
    q, k, v, dout = flash_case(device, BERT_FLASH_SHAPE, seed=1)
    errs, rows = flash_check_and_time(q, k, v, dout, bias, h, False, flush)
    kw = dict(num_heads=h, causal=False)
    out, lse = fa.flash_fwd(q, k, v, None, **kw)
    args = (q, k, v, None, dout, lse, fa.attention_delta(out, dout, h))
    no_bias = {"flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, None, **kw),
                                    flush),
               "flash_bwd_dkdv": time_ms(lambda: fa.flash_bwd_dkdv(*args,
                                                                   **kw),
                                         flush),
               "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args, **kw),
                                       flush)}
    for name, ms in no_bias.items():
        rows[name]["kernel_ms_without_bias"] = ms
    return {"phase": "flash_bert", "name": "flash_attention (BERT mode)",
            "errors": errs, "tolerance": FLASH_TOL, "kernels": rows,
            "valid_keys": int(keep.sum()), "keys": keep.numel(),
            "library_call": "F.scaled_dot_product_attention with the keep "
                            "mask as a boolean (b, 1, 1, s) attn_mask on "
                            "contiguous (b, h, s, d) copies; the backward's "
                            "time covers dq, dk and dv together",
            "shape": dict(BERT_FLASH_SHAPE, dtype="bf16", causal=False,
                          key_bias="fp32 (b, s), 0 / -1e9",
                          qkv_row_stride=3 * h * BERT_FLASH_SHAPE["d"])}


def _worst(got, want):
    """The element where |got - want| is largest: its index and both
    values, and the relative error max |got - want| / max |want|."""
    diff = (got.double() - want.double()).abs()
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    return {"index": [int(i) for i in at], "gpu": float(got[at]),
            "cpu": float(want[at]),
            "rel_err": float(diff.max() / want.double().abs().max())}


def _cpu_model():
    """The host CPU's model name (the CPU side of a parity check runs
    there)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def phase_flash_fp32_repeats(repeats=60):
    """The fp32 key-mask case of tests/test_torch_cuda.py::
    test_flash_attention_bshd_mask_bias_grads_match_plain (b 2, s 96, h 2,
    d 32, 25% of keys masked by -1e9), forward and backward through the
    kernels ``repeats`` times and on the CPU (the plain versions) 5 times:
    every GPU run bit-identical to the first, every CPU run too, and the
    worst element of each output against the CPU run printed with both
    sides' values, and each run's out against a float64 evaluation, batch
    by batch (the distinct values over the GPU runs, one a CPU run); held
    to the test's 1e-5."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention_bshd
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 96, 2, 32
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    mask = np.where(rng.rand(b, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0

    def run(dev):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays[:3])
        out = flash_attention_bshd(q, k, v, causal=False,
                                   mask_bias=torch.from_numpy(mask).to(dev))
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    gpu = [run(torch.device("cuda", 0)) for _ in range(repeats)]
    cpu = [run(torch.device("cpu")) for _ in range(5)]
    names = ("out", "dq", "dk", "dv")
    gpu_varies = {n: sum(not torch.equal(r[i], gpu[0][i]) for r in gpu[1:])
                  for i, n in enumerate(names)}
    cpu_varies = {n: sum(not torch.equal(r[i], cpu[0][i]) for r in cpu[1:])
                  for i, n in enumerate(names)}
    worst = {n: max((_worst(r[i], cpu[0][i]) for r in gpu),
                    key=lambda w: w["rel_err"])
             for i, n in enumerate(names)}
    rel = max(w["rel_err"] for w in worst.values())
    # out in float64, to tell which side a run that differs has left
    q, k, v = (a.astype(np.float64) for a in arrays[:3])
    sc = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d) + \
        mask.astype(np.float64)[:, None, None, :]
    pr = np.exp(sc - sc.max(-1, keepdims=True))
    exact = torch.from_numpy(np.einsum("bhqk,bkhd->bqhd",
                                       pr / pr.sum(-1, keepdims=True), v))
    def per_batch(out):
        return tuple(float(e) for e in
                     (out.double() - exact).abs().amax(dim=(1, 2, 3)))

    out_vs_float64 = {"gpu_runs": sorted({per_batch(r[0]) for r in gpu}),
                      "cpu_runs": [per_batch(r[0]) for r in cpu]}
    result = {"phase": "flash_fp32_repeats", "repeats": repeats,
              "shape": {"b": b, "s": s, "h": h, "d": d, "dtype": "fp32",
                        "key_mask": "25% of keys -1e9"},
              "gpu_runs_differing_from_the_first": gpu_varies,
              "cpu_runs_differing_from_the_first": cpu_varies,
              "worst_vs_cpu": worst, "max_rel_err": rel, "tolerance": 1e-5,
              "out_max_abs_err_vs_float64": out_vs_float64,
              "cpu": {"model": _cpu_model(),
                      "capability": torch.backends.cpu.get_cpu_capability(),
                      "threads": torch.get_num_threads()}}
    assert not any(gpu_varies.values()), result
    assert not any(cpu_varies.values()), result
    assert rel <= 1e-5, result
    return result


# The fp16 cases (b, h, d, s, causal, q and k scale): probes/kernel_probe.py
# fp16_backward's, and one with q and k scaled by 3 so that P and dS fall
# into fp16's subnormal range and below its rounding to 0 (2**-25).
FP16_CASES = [(2, 3, d, s, causal, 1.0) for d in (32, 128) for s in (96, 1000)
              for causal in (True, False)] + \
    [(2, 2, 64, 333, causal, 3.0) for causal in (True, False)]


def fp16_case(device, b, h, d, s, qk_scale=1.0):
    """fp16 q, k, v (column blocks of one QKV tensor), dout and a key bias
    dropping 20% of keys (-1e9) and shifting the others, from numpy's
    generator seeded with s + d (the probe's and the GPU tests' recipe)."""
    import torch
    rng = np.random.RandomState(s + d)
    to = lambda a: torch.from_numpy(a).to(device, torch.float16)
    qkv = to(rng.randn(b, s, 3 * h * d).astype(np.float32))
    q, k, v = qkv.split(h * d, -1)
    dout = to(rng.randn(b, s, h * d).astype(np.float32))
    bias = rng.randn(b, s).astype(np.float32)
    bias[rng.rand(b, s) < 0.2] = -1e9
    bias[:, 0] = 0.0
    q.mul_(qk_scale)    # in place: q, k, v stay column blocks of one tensor
    k.mul_(qk_scale)
    return q, k, v, dout, torch.from_numpy(bias).to(device)


def phase_flash_fp16():
    """fp16 on the tensor-core kernels: forward, dk/dv and dq against their
    plain versions at FP16_CASES, each output per element within one fp16
    ulp of the plain value plus 1e-6 (the gradients) or eps / 4 (out), lse
    within 1e-4, with the share of the pairs whose P or dS is an fp16
    subnormal."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    device = torch.device("cuda", 0)
    eps = torch.finfo(torch.float16).eps
    ratio = lambda got, want, atol: float(
        ((got.float() - want.float()).abs() /
         (eps * want.float().abs() + atol)).max())
    cases, worst = [], 0.0
    for b, h, d, s, causal, qk_scale in FP16_CASES:
        q, k, v, dout, bias = fp16_case(device, b, h, d, s, qk_scale)
        kw = dict(num_heads=h, causal=causal)
        out, lse = fa.flash_fwd(q, k, v, bias, **kw)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, bias, **kw)
        delta = fa.attention_delta(out, dout, h)
        args = (q, k, v, bias, dout, lse, delta)
        got = fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
        want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
            (fa.flash_bwd_dq_reference(*args, **kw),)
        _, _, _, p, ds = fa._bwd_terms(q, k, v, bias, dout, lse, delta, h,
                                       causal, d ** -0.5)
        torch.cuda.synchronize()
        sub = lambda t: float(((t != 0) & (t.float().abs() < 2 ** -14))
                              .float().mean())
        row = {"b": b, "h": h, "d": d, "s": s, "causal": causal,
               "qk_scale": qk_scale, "lse_abs": float((lse - ref_lse).abs()
                                                     .max()),
               "out_ulp_ratio": ratio(out, ref_out, eps / 4),
               "subnormal_share": {"p": sub(p.half()), "ds": sub(ds)}}
        for name, g, w in zip(("dk", "dv", "dq"), got, want):
            assert torch.isfinite(g.float()).all(), (row, name)
            row[name + "_ulp_ratio"] = ratio(g, w, 1e-6)
        cases.append(row)
        worst = max(worst, row["out_ulp_ratio"], row["dk_ulp_ratio"],
                    row["dv_ulp_ratio"], row["dq_ulp_ratio"])
        assert row["lse_abs"] <= FLASH_TOL["lse"], row
        del p, ds, got, want
    result = {"phase": "flash_fp16", "cases": cases, "worst_ulp_ratio": worst,
              "bound": "one fp16 ulp of the plain value + 1e-6 (dq, dk, dv) "
                       "or + eps / 4 (out); lse 1e-4"}
    assert worst <= 1.0, result
    return result


def phase_flash3d(flush):
    """Rows 5/6: the JAX package's 3D API, (b * h, s, d) operands on the
    packed kernels with one head, at BERT-large's attention shape, causal
    and not. The 3D op (forward, then its backward through autograd)
    equals direct kernel calls bit for bit; the kernels hold to their
    plain versions at FLASH_TOL; each timed, with SDPA on the same memory
    viewed (b, h, s, d) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    device = torch.device("cuda", 0)
    b, h, s, d = 32, 16, 512, 64
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, dout = (torch.randn((b * h, s, d), generator=gen, device=device,
                                 dtype=torch.bfloat16) for _ in range(4))
    modes = {}
    for causal in (True, False):
        kw = dict(num_heads=1, causal=causal)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out3 = fa.flash_attention(qq, kk, vv, causal=causal)
        out3.backward(dout)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        dq, dk, dv = fa.flash_bwd(q, k, v, None, out, dout, lse, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in (
            (out3.detach(), out), (qq.grad, dq), (kk.grad, dk),
            (vv.grad, dv)))
        assert same, "the 3D op differs from direct kernel calls"
        delta = fa.attention_delta(out, dout, 1)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
        ref_dq = fa.flash_bwd_dq_reference(q, k, v, None, dout, lse, delta,
                                           **kw)
        ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(q, k, v, None, dout,
                                                     lse, delta, **kw)
        abs_err = lambda a, b_: float((a.float() - b_.float()).abs().max())
        pairs = {"out": (out, ref_out), "dq": (dq, ref_dq),
                 "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
        errs = {"lse": abs_err(lse, ref_lse)}
        for name, (got, want) in pairs.items():
            atol = FLASH_TOL["out_atol" if name == "out" else "grad_atol"]
            errs[name + "_abs"] = abs_err(got, want)
            errs[name + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
        for t in (out, lse, dq, dk, dv):
            assert torch.isfinite(t.float()).all(), "non-finite kernel output"
        assert errs["lse"] <= FLASH_TOL["lse"], errs
        assert max(errs[n + "_ulp_ratio"] for n in pairs) <= 1.0, errs
        del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, qq, kk, vv, out3

        pairs_n = b * h * (s * (s + 1) // 2 if causal else s * s)
        nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=causal), flush)
        plain_fwd = time_ms(lambda: fa.flash_fwd_reference(q, k, v, **kw),
                            flush, reps=5)
        dkdv_ms = time_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, None, dout, lse, delta, **kw), flush)
        dq_ms = time_ms(lambda: fa.flash_bwd_dq(
            q, k, v, None, dout, lse, delta, **kw), flush)
        plain_bwd = time_ms(lambda: (
            fa.flash_bwd_dkdv_reference(q, k, v, None, dout, lse, delta, **kw),
            fa.flash_bwd_dq_reference(q, k, v, None, dout, lse, delta, **kw)),
            flush, reps=5)
        view = lambda t: t.view(b, h, s, d)
        qh, kh, vh = (view(t).detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=causal)
        with torch.no_grad():
            lib_fwd = time_ms(sdpa, flush)
        lib_both = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qh, kh, vh), view(dout)), flush)
        modes["causal" if causal else "non_causal"] = {
            "errors": errs, "same_as_direct_calls": same,
            "fwd": {"kernel_ms": fwd_ms, "plain_ms": plain_fwd,
                    "library_ms": lib_fwd,
                    "bound": bound_ms(nbytes(q, k, v, out, lse),
                                      2 * 2 * pairs_n * d, BF16_FLOPS_PER_S)},
            "bwd": {"kernel_ms": dkdv_ms + dq_ms, "dkdv_ms": dkdv_ms,
                    "dq_ms": dq_ms, "plain_ms": plain_bwd,
                    "library_ms": lib_both - lib_fwd,
                    "bound": bound_ms(nbytes(q, k, v, dout, lse, delta, dq,
                                             dk, dv),
                                      2 * 5 * pairs_n * d, BF16_FLOPS_PER_S)}}
        del out, lse, dq, dk, dv, delta
    return {"phase": "flash3d", "name": "flash_attention (3D)",
            "shape": {"batch_heads": b * h, "seq": s, "d_head": d,
                      "dtype": "bf16"},
            "tolerance": FLASH_TOL, "modes": modes,
            "library_call": "F.scaled_dot_product_attention on the same "
                            "memory viewed (b, h, s, d); backward = fwd+bwd "
                            "minus fwd, dq, dk, dv together"}


def phase_adam(flush):
    """The Adam kernel against its plain version over one flat fp32
    buffer of GPT-2-350M's parameter count, timed; bit-exact."""
    import torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.adam.fused_adam import (
        bias_corrections, fused_adam, fused_adam_reference)
    device = torch.device("cuda", 0)
    n = gpt2.num_params(gpt2.config_for("gpt2_medium"))
    gen = torch.Generator(device=device).manual_seed(3)
    new = lambda: torch.randn(n, generator=gen, device=device)
    g = new()
    p, m, v = new(), new() * 1e-2, new().abs_() * 1e-4
    copies = [[t.clone() for t in (p, m, v)] for _ in range(2)]
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              bc1=bc1, bc2=bc2)
    fused_adam(copies[0][0], g, copies[0][1], copies[0][2], **kw)
    fused_adam_reference(copies[1][0], g, copies[1][1], copies[1][2], **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(*copies))
    assert err == 0.0, "fused_adam off its plain version by {}".format(err)
    del copies
    kernel_ms = time_ms(lambda: fused_adam(p, g, m, v, **kw), flush)
    plain_ms = time_ms(lambda: fused_adam_reference(p, g, m, v, **kw),
                       flush, reps=5)
    step = torch.tensor(7.0, device=device)
    library_ms = time_ms(lambda: torch._fused_adam_(
        [p], [g], [m], [v], [], [step], lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), flush)
    b_ms, b_by = bound_ms(7 * 4 * n, 18 * n, FP32_FLOPS_PER_S)
    return {"phase": "kernel", "name": "fused_adam", "elements": n,
            "max_abs_err": err, "tolerance": 0.0, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library_call": "torch._fused_adam_ over the same flat tensors"}


# ------------------------------------------------------------ training path


TRAIN_MICRO, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 16, 1024, 2, 10
TRAIN_REMAT = False       # the peak stays well under 70 GB without it
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                             "fused_kernel": "auto"}},
    "transformer": {"flash_attention": "auto"},
    "steps_per_print": 10 ** 9,
}


def phase_train(launch_counters):
    """The training main path: gpt2_medium at full width and depth, seq
    1024, bf16, ZeRO-2, Adam with fp32 moments, through the port's
    initialize(...).train_batch(...) on one fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT)
    assert cfg.n_layers == 24 and cfg.d_model == 1024
    t0 = time.perf_counter()
    model = gpt2.make_gpt2_model(config=cfg, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=TRAIN_CONFIG)
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert engine.flash_attention_backend == "pallas", \
        engine.flash_attention_backend
    assert engine.fused_optimizer_kernel == "pallas", \
        engine.fused_optimizer_kernel
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, TRAIN_MICRO, TRAIN_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    assert launches["fused_adam"] == TRAIN_STEPS, launches
    assert engine.flat.check_views()
    step_s = wall / TRAIN_STEPS
    tokens = TRAIN_MICRO * TRAIN_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        TRAIN_SEQ                                      # bench.py's formula
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch, kernel_groups=FLASH_GROUPS)
    return {"phase": "train", "model": "gpt2_medium", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "seq": TRAIN_SEQ,
            "micro_batch": TRAIN_MICRO, "dtype": "bf16", "zero_stage": 2,
            "moments": "fp32", "remat": TRAIN_REMAT, "params": n_params,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "mfu": mfu, "mfu_peak": "989 TFLOP/s dense bf16",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


# the flash kernels' device names (profile groups of the train phases)
FLASH_GROUPS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")


def train_profile(engine, batch, steps=2, span_names=(), kernel_groups=()):
    """Where a training step's time goes: ``steps`` train_batch calls
    under torch.profiler (device busy share, launches per step and the
    costliest kernels). ``span_names``: record_function spans whose host
    time a step is reported; ``kernel_groups``: substrings of kernel
    names whose device time a step is summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device activity only: a record_function span (the hop spans, gloo's
    # own) also has a device-side event covering what it launched, which
    # the profiler marks as a user annotation and which is no work
    device = lambda e: e.device_type == torch.autograd.DeviceType.CUDA \
        and not e.is_user_annotation
    averages = prof.key_averages()
    kernels = [e for e in averages if device(e)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # idle time between consecutive device activities, and the host's
    # time blocked on a full launch queue (the device is then the limit)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if device(e))
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    blocked = sum(e.self_cpu_time_total for e in averages
                  if e.key == "Command Buffer Full")
    extra = {}
    if span_names:
        extra["host_ms_per_step_in_spans"] = {
            name: sum(e.cpu_time_total for e in averages if e.key == name) *
            1e-3 / steps for name in span_names}
    if kernel_groups:
        by_group = {
            g: sum(e.self_device_time_total for e in kernels if g in e.key) *
            1e-3 / steps for g in kernel_groups}
        extra["kernel_ms_per_step_by_group"] = by_group
        extra["groups_share_of_step"] = sum(by_group.values()) * 1e-3 / \
            (wall / steps)
    return {"steps": steps, "wall_s_per_step": wall / steps, **extra,
            "device_busy_s_per_step": busy_us * 1e-6 / steps,
            "device_busy_share": busy_us * 1e-6 / wall,
            "device_gaps_ms_per_step": sum(gaps) * 1e-3 / steps,
            "device_gaps_over_200us_ms_per_step":
                sum(g for g in gaps if g > 200) * 1e-3 / steps,
            "host_blocked_on_full_queue_ms_per_step": blocked * 1e-3 / steps,
            "kernel_launches_per_step": sum(e.count for e in kernels) /
            steps,
            "top_kernels": [{"name": e.key[:80],
                             "ms_per_step": e.self_device_time_total * 1e-3 /
                             steps,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def phase_train_parity(steps=5, tol=1e-4):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, TF32
    off: the kernels ("pallas", "pallas") against the plain versions
    ("xla", "xla"), from the same init."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    runs = {}
    for backend in ("pallas", "xla"):
        cfg = gpt2.config_for("gpt2_medium", n_layers=2,
                              max_seq_len=TRAIN_SEQ, loss_chunk=128,
                              remat=False)
        model = gpt2.make_gpt2_model(config=cfg, seed=1)
        engine = deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-4, "fused_kernel": backend}},
            "transformer": {"flash_attention": backend},
            "steps_per_print": 10 ** 9})[0]
        assert engine.flash_attention_backend == backend
        runs[backend] = [float(engine.train_batch(batch=(ids, ids)))
                         for _ in range(steps)]
        del engine, model
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["pallas"],
                                                  runs["xla"]))
    assert rel <= tol, (rel, runs)
    return {"phase": "train_parity", "layers": 2, "d_model": 1024,
            "dtype": "fp32", "steps": steps, "losses": runs,
            "max_rel_diff": rel, "tolerance": tol}


# ------------------------------------------- block-sparse attention (slice 3)


SPARSE_SOURCE = \
    "deepspeed_tpu_torch/ops/sparse_attention/csrc/block_sparse_attention.cu"
# the documented ds_config section (docs/_pages/config-json.md), causal
SPARSE_TRAIN = {"mode": "fixed", "block": 16,
                "different_layout_per_head": False, "num_local_blocks": 4,
                "num_global_blocks": 1, "attention": "unidirectional",
                "horizontal_global_attention": False,
                "num_different_global_patterns": 1}
SPARSE_PARITY = dict(SPARSE_TRAIN, different_layout_per_head=True,
                     num_different_global_patterns=4)
SPARSE_SHAPE = dict(b=2, s=8192, h=16, d=64)    # the train_sparse path's
SPARSE_MICRO, SPARSE_SEQ = 2, 8192
SPARSE_REMAT = False      # the peak stays under 70 GB without it
SPARSE_NAMES = ("block_sparse_fwd", "block_sparse_bwd_dq",
                "block_sparse_bwd_dkdv")


def sparse_layout(section, heads, seq):
    from deepspeed_tpu_torch.ops.sparse_attention import (
        sparsity_config_from_dict)
    return sparsity_config_from_dict(dict(section), heads).make_layout(seq)


def mean_keys_per_query(layout, block):
    """k-bar: keys a query attends under the layout and the causal rule,
    averaged over queries and heads."""
    lay = np.asarray(layout, bool)
    nb = lay.shape[1]
    qb, kb = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    per_pair = np.where(qb > kb, block * block,
                        np.where(qb == kb, block * (block + 1) // 2, 0))
    return float((lay * per_pair[None]).sum() / (lay.shape[0] * nb * block))


def sparse_case(device, seed=0):
    """The train_sparse path's attention operands: q, k, v the (b, h, s,
    d) views of one (b, s, 3 * h * d) bf16 QKV tensor, and an output
    gradient in the (b, h, s, d) view of (b, s, h, d) memory."""
    import torch
    b, s, h, d = (SPARSE_SHAPE[k] for k in "bshd")
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=device,
                      dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device=device,
                       dtype=torch.bfloat16).transpose(1, 2)
    return q, k, v, dout


def sparse_library(q, k, v, dout, layout, block, flush):
    """Yardsticks, never on the port's path: flex_attention under
    torch.compile with a BlockMask from the layout and the causal rule (it
    skips the same inactive blocks), and scaled_dot_product_attention with
    the layout expanded to a dense boolean mask. Each: forward ms and
    backward ms (forward + backward minus forward, dq, dk, dv together)."""
    import torch
    import torch.nn.functional as F
    b, h, s, d = q.shape
    qh, kh, vh = (t.contiguous().requires_grad_() for t in (q, k, v))
    doh = dout.contiguous()
    lay = torch.from_numpy(np.asarray(layout, bool)).to(q.device)
    one = lay.shape[0] == 1

    def timed(fn):
        with torch.no_grad():
            fwd = time_ms(fn, flush)
        both = time_ms(lambda: torch.autograd.grad(fn(), (qh, kh, vh), doh),
                       flush)
        return fwd, both - fwd

    out = {}
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def mask_mod(bi, hi, qi, ki):
            hl = 0 if one else hi
            return lay[hl, qi // block, ki // block] & (qi >= ki)

        mask = create_block_mask(mask_mod, B=None, H=None if one else h,
                                 Q_LEN=s, KV_LEN=s, device=q.device)
        flex = torch.compile(flex_attention)
        out["flex"] = timed(lambda: flex(qh, kh, vh, block_mask=mask))
        out["flex_error"] = None
    except Exception as exc:   # a yardstick only: the kernels' checks decide
        out["flex"] = (None, None)
        out["flex_error"] = "{}: {}".format(type(exc).__name__, exc)[:400]
    dense = (lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
             & torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril())[None]
    out["sdpa"] = timed(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=dense))
    del dense
    return out


def phase_sparse(flush):
    """The three block-sparse kernels against their plain versions at the
    train_sparse shape, for the train config's shared layout (the path of
    the TPU's packed-heads rows) and the parity config's per-head layout
    (its per-head rows), timed."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    device = torch.device("cuda", 0)
    b, s, h, d = (SPARSE_SHAPE[k] for k in "bshd")
    q, k, v, dout = sparse_case(device)
    layouts = {}
    for name, section in (("shared", SPARSE_TRAIN),
                          ("per_head", SPARSE_PARITY)):
        layout = sparse_layout(section, h, s)
        tables = bsa.LayoutTables(layout, section["block"])
        kw = dict(tables=tables, causal=True)
        out, lse = bsa.block_sparse_fwd(q, k, v, **kw)
        delta = bsa.attention_delta(out, dout)
        args = (q, k, v, None, None, dout, lse, delta)
        dq = bsa.block_sparse_bwd_dq(*args, **kw)
        dk, dv = bsa.block_sparse_bwd_dkdv(*args, **kw)
        again = (bsa.block_sparse_bwd_dq(*args, **kw),
                 *bsa.block_sparse_bwd_dkdv(*args, **kw))
        fwd_again = bsa.block_sparse_fwd(q, k, v, **kw)
        ref_out, ref_lse = bsa.block_sparse_fwd_reference(q, k, v, **kw)
        ref_dq = bsa.block_sparse_bwd_dq_reference(*args, **kw)
        ref_dk, ref_dv = bsa.block_sparse_bwd_dkdv_reference(*args, **kw)
        torch.cuda.synchronize()
        abs_err = lambda a, b: float((a.float() - b.float()).abs().max())
        pairs = {"out": (out, ref_out), "dq": (dq, ref_dq),
                 "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
        errs = {"lse": abs_err(lse, ref_lse)}
        for g, (got, want) in pairs.items():
            atol = FLASH_TOL["out_atol" if g == "out" else "grad_atol"]
            errs[g + "_abs"] = abs_err(got, want)
            errs[g + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
        for t in (out, lse, dq, dk, dv):
            assert torch.isfinite(t.float()).all(), "non-finite kernel output"
        errs["bwd_repeat_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
        errs["fwd_repeat_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(fwd_again, (out, lse)))
        assert errs["lse"] <= FLASH_TOL["lse"], (name, errs)
        assert max(errs[g + "_ulp_ratio"] for g in pairs) <= 1.0, (name, errs)
        assert errs["bwd_repeat_bit_equal"], (name, "two backward runs differ")
        assert errs["fwd_repeat_bit_equal"], (name, "two forward runs differ")
        # fp16 runs the same tensor-core forward: one fp16 ulp of the plain
        # value plus eps / 4, as flash_fp16 holds the flash forward
        q16, k16, v16 = (t.to(torch.float16) for t in (q, k, v))
        out16, lse16 = bsa.block_sparse_fwd(q16, k16, v16, **kw)
        ref16, ref_lse16 = bsa.block_sparse_fwd_reference(q16, k16, v16, **kw)
        torch.cuda.synchronize()
        eps16 = torch.finfo(torch.float16).eps
        errs["fp16_out_ulp_ratio"] = float(
            ((out16.float() - ref16.float()).abs() /
             (eps16 * ref16.float().abs() + eps16 / 4)).max())
        errs["fp16_lse"] = abs_err(lse16, ref_lse16)
        assert errs["fp16_out_ulp_ratio"] <= 1.0, (name, errs)
        assert errs["fp16_lse"] <= FLASH_TOL["lse"], (name, errs)
        del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, again, fwd_again
        del q16, k16, v16, out16, lse16, ref16, ref_lse16

        times = {
            "block_sparse_fwd": (
                lambda: bsa.block_sparse_fwd(q, k, v, **kw),
                lambda: bsa.block_sparse_fwd_reference(q, k, v, **kw)),
            "block_sparse_bwd_dq": (
                lambda: bsa.block_sparse_bwd_dq(*args, **kw),
                lambda: bsa.block_sparse_bwd_dq_reference(*args, **kw)),
            "block_sparse_bwd_dkdv": (
                lambda: bsa.block_sparse_bwd_dkdv(*args, **kw),
                lambda: bsa.block_sparse_bwd_dkdv_reference(*args, **kw)),
        }
        # operations over active pairs only (the JAX _sparse_cost count):
        # 2 * mults * b * n_active * block^2 * d; bytes: each input once,
        # each output once
        nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        blk = section["block"]
        work = lambda mults: 2 * mults * b * tables.n_active * blk * blk * d
        bounds = {
            "block_sparse_fwd": bound_ms(nbytes(q, k, v, out, lse), work(2),
                                         BF16_FLOPS_PER_S),
            "block_sparse_bwd_dq": bound_ms(
                nbytes(q, k, v, dout, lse, delta, dq), work(3),
                BF16_FLOPS_PER_S),
            "block_sparse_bwd_dkdv": bound_ms(
                nbytes(q, k, v, dout, lse, delta, dk, dv), work(4),
                BF16_FLOPS_PER_S),
        }
        lib = sparse_library(q, k, v, dout, layout, blk, flush)
        library = {"block_sparse_fwd": lib["flex"][0],
                   "block_sparse_bwd_dq": lib["flex"][1],
                   "block_sparse_bwd_dkdv": lib["flex"][1]}
        dense_library = {"block_sparse_fwd": lib["sdpa"][0],
                         "block_sparse_bwd_dq": lib["sdpa"][1],
                         "block_sparse_bwd_dkdv": lib["sdpa"][1]}
        rows = {}
        for kname, (kernel, plain) in times.items():
            rows[kname] = {"kernel_ms": time_ms(kernel, flush),
                           "plain_ms": time_ms(plain, flush, reps=5),
                           "bound_ms": bounds[kname][0],
                           "bound_by": bounds[kname][1],
                           "library_ms": library[kname],
                           "dense_library_ms": dense_library[kname]}
        nb = tables.nb
        layouts[name] = {
            "section": section, "shared": tables.shared,
            "active_pairs_per_head": tables.n_active // h,
            "density_of_causal": tables.n_active / h / (nb * (nb + 1) // 2),
            "walk_steps_per_head": {
                walk: int((-(-getattr(tables, walk).lengths * blk //
                             64)).sum()) // tables.layout_heads
                for walk in ("fwd", "bwd")},
            "errors": errs, "kernels": rows,
            "flex_error": lib["flex_error"]}
        del out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return {"phase": "kernel", "name": "block_sparse_attention",
            "tolerance": FLASH_TOL, "layouts": layouts,
            "library_call": "flex_attention (torch.compile) with a BlockMask "
                            "of the layout and the causal rule; "
                            "dense_library: scaled_dot_product_attention "
                            "with the layout as a dense bool mask; "
                            "backward times cover dq, dk and dv together",
            "shape": dict(SPARSE_SHAPE, dtype="bf16", causal=True,
                          qkv="(b, h, s, d) views of one (b, s, 3hd) "
                              "tensor")}


def phase_train_sparse(launch_counters):
    """The long-context main path: gpt2_medium at full width and depth,
    seq 8192, micro batch 2, bf16, ZeRO-2, Adam with fp32 moments, the
    ds_config sparse_attention section, through initialize(...)
    .train_batch(...) on one fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    ds = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=SPARSE_MICRO,
              sparse_attention=dict(SPARSE_TRAIN))
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=SPARSE_SEQ,
                          loss_chunk=128, remat=SPARSE_REMAT,
                          sparse_attention=dict(SPARSE_TRAIN))
    assert cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
    t0 = time.perf_counter()
    model = gpt2.make_gpt2_model(config=cfg, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config_params=ds)
    init_s = time.perf_counter() - t0
    # the model consumes the engine's parsed section: the two agree
    assert engine.sparse_attention_config() == SPARSE_TRAIN
    assert cfg.sparse_attention == engine.sparse_attention_config()
    assert engine.device.type == "cuda"
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, SPARSE_MICRO, SPARSE_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for name in SPARSE_NAMES:
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == 0, launches
    assert launches["fused_adam"] == TRAIN_STEPS, launches
    assert engine.flat.check_views()
    layout = sparse_layout(SPARSE_TRAIN, cfg.n_heads, SPARSE_SEQ)
    block = SPARSE_TRAIN["block"]
    nb = SPARSE_SEQ // block
    active = int(np.asarray(layout[0]).sum())
    k_bar = mean_keys_per_query(layout, block)
    step_s = wall / TRAIN_STEPS
    tokens = SPARSE_MICRO * SPARSE_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        k_bar
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch)
    return {"phase": "train_sparse", "model": "gpt2_medium",
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "seq": SPARSE_SEQ,
            "micro_batch": SPARSE_MICRO, "dtype": "bf16", "zero_stage": 2,
            "moments": "fp32", "remat": SPARSE_REMAT, "params": n_params,
            "sparse_attention": SPARSE_TRAIN,
            "active_block_pairs_per_head": active,
            "density_of_causal": active / (nb * (nb + 1) // 2),
            "mean_keys_per_query": k_bar,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "mfu": mfu,
            "mfu_formula": "tokens/s * (6 N + 12 L d k_bar) / 989e12, "
                           "k_bar = mean keys a query attends under the "
                           "layout (bench.py's formula with s -> k_bar)",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


def phase_train_sparse_parity(steps=5, tol=1e-4, seq=2048):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, seq
    2048, a per-head layout (the TPU's per-head rows), TF32 off: through
    the block-sparse kernels, and through their plain versions (the
    wrappers' names swapped for the plain functions here, for the
    comparison only)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50304, size=(1, 2, seq)).astype(np.int64)
    kernels = {n: getattr(bsa, n) for n in SPARSE_NAMES}
    plains = {n: getattr(bsa, n + "_reference") for n in SPARSE_NAMES}
    runs, launches = {}, {}
    for route, fns in (("kernels", kernels), ("plain", plains)):
        for counter in kernels.values():
            counter.launches = 0
        for n, fn in fns.items():
            setattr(bsa, n, fn)
        try:
            cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=seq,
                                  loss_chunk=128, remat=False,
                                  sparse_attention=dict(SPARSE_PARITY))
            model = gpt2.make_gpt2_model(config=cfg, seed=1)
            engine = deepspeed_tpu_torch.initialize(model=model, config_params={
                "train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                "sparse_attention": dict(SPARSE_PARITY),
                "steps_per_print": 10 ** 9})[0]
            runs[route] = [float(engine.train_batch(batch=(ids, ids)))
                           for _ in range(steps)]
        finally:
            for n, fn in kernels.items():
                setattr(bsa, n, fn)
        launches[route] = {n: c.launches for n, c in kernels.items()}
        del engine, model
        torch.cuda.empty_cache()
    assert all(v == 2 * steps for v in launches["kernels"].values()), launches
    assert all(v == 0 for v in launches["plain"].values()), launches
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["kernels"],
                                                  runs["plain"]))
    assert rel <= tol, (rel, runs)
    assert runs["kernels"][-1] < runs["kernels"][0], runs
    return {"phase": "train_sparse_parity", "layers": 2, "d_model": 1024,
            "seq": seq, "dtype": "fp32", "sparse_attention": SPARSE_PARITY,
            "steps": steps, "losses": runs, "launches": launches,
            "max_rel_diff": rel, "tolerance": tol}


# --------------------------------------------- BERT + LAMB (slice 4)


LAMB_SOURCE = "deepspeed_tpu_torch/ops/lamb/csrc/fused_lamb.cu"
LAMB_NAMES = ("fused_lamb", "fused_lamb_apply")
# BERT-large leaves that init_params fills with zeros (biases, LN shifts):
# at step 1 their trust ratio takes the 1.0 branch
ZERO_INIT = ("bias", "qkvb", "attn_ob", "attn_nb", "inter_b", "output_b",
             "norm_b")
BERT_MICRO, BERT_SEQ, BERT_REMAT = 32, 512, True
# tests/perf/bert_bench.py:19-40 with fp32 moments (bf16_state=False)
BERT_CONFIG = {
    "train_micro_batch_size_per_gpu": BERT_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Lamb", "params": {"lr": 2e-3,
                                             "fused_kernel": "auto"}},
    "transformer": {"flash_attention": "auto"},
    "steps_per_print": 10 ** 9,
}


def bert_segments(cfg):
    """(segments, zero-init segment indices, buffer length) of a BERT
    model's flat partition, laid out as FlatPartition lays it out."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    segments, zero, total = [], [], 0
    for name, p in bert.BertModel(cfg, device="meta").named_parameters():
        if name.endswith(ZERO_INIT):
            zero.append(len(segments))
        segments.append((total, p.numel()))
        total += -(-p.numel() // ALIGN) * ALIGN
    return segments, zero, total


def _fp32_steps(got, want):
    """Largest distance in fp32 representable steps (0 = bit-equal)."""
    import torch
    line = lambda t: torch.where(t.view(torch.int32) < 0,
                                 -(t.view(torch.int32) & 0x7FFFFFFF),
                                 t.view(torch.int32)).long()
    return int((line(got) - line(want)).abs().max())


def phase_lamb(flush):
    """The two LAMB kernels against their plain versions over one flat
    fp32 buffer of BERT-large's size and segment table, step 7; m, v, the
    trust ratios and the per-segment sums (|p|^2, |u|^2) bit-equal (the
    sums also within 1e-5 of a float64 sum of each segment), p within one
    ulp, two kernel runs bit-identical; timed."""
    import torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.adam.fused_adam import bias_corrections
    from deepspeed_tpu_torch.ops.lamb import (
        LambPlan, fused_lamb, fused_lamb_apply, fused_lamb_apply_reference,
        fused_lamb_reference)
    device = torch.device("cuda", 0)
    cfg = bert.config_for("bert_large")
    segments, zero, total = bert_segments(cfg)
    n = sum(numel for _, numel in segments)
    assert n == bert.num_params(cfg) and len(segments) == 26
    covered = torch.zeros(total, dtype=torch.bool, device=device)
    for i, (off, numel) in enumerate(segments):
        covered[off:off + numel] = i not in zero
    gen = torch.Generator(device=device).manual_seed(7)
    new = lambda scale: torch.randn(total, generator=gen, device=device) * \
        scale * covered
    p, g, m = new(0.02), new(1e-3), new(1e-4)
    v = new(1e-4) ** 2
    for i in zero:                   # zero params, live gradients
        off, numel = segments[i]
        g[off:off + numel] = torch.randn(numel, generator=gen,
                                         device=device) * 1e-3
    plan = LambPlan(segments, device)
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01, bc1=bc1,
              bc2=bc2)
    kw = dict(lr=2e-3, eps=1e-8, weight_decay=0.01, bc1=bc1, bc2=bc2)
    sides, ratios, sums = [], [], []
    for route in ("kernel", "kernel", "plain"):
        pp, mm, vv = p.clone(), m.clone(), v.clone()
        if route == "kernel":
            r, sq = fused_lamb(pp, g, mm, vv, plan, **sc)
            fused_lamb_apply(pp, mm, vv, r, plan, **kw)
        else:
            r, sq = fused_lamb_reference(pp, g, mm, vv, plan, **sc)
            fused_lamb_apply_reference(pp, mm, vv, r, plan, **kw)
        sides.append((pp, mm, vv))
        ratios.append(r)
        sums.append(sq)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(sides[0], sides[1])) \
        and torch.equal(sums[0], sums[1])
    m_equal = torch.equal(sides[0][1], sides[2][1])
    v_equal = torch.equal(sides[0][2], sides[2][2])
    ratio_equal = torch.equal(ratios[0], ratios[2])
    sums_equal = torch.equal(sums[0], sums[2])
    p_sq = torch.stack([(p[off:off + numel].double() ** 2).sum()
                        for off, numel in segments])
    sums_rel = float(((sums[0][:, 0].double() - p_sq).abs() /
                      p_sq.clamp_min(1e-30)).max())
    assert sums_equal, "the kernel's per-segment sums differ from plain"
    assert sums_rel <= 1e-5, sums_rel
    p_steps = _fp32_steps(sides[0][0], sides[2][0])
    err = max(float((a - b).abs().max()) for a, b in zip(sides[0], sides[2]))
    assert repeat, "two runs of the LAMB kernels differ"
    assert m_equal and v_equal, "m or v off the plain version"
    assert ratio_equal, (ratios[0], ratios[2])
    assert p_steps <= 1, "p off the plain version by {} ulp".format(p_steps)
    assert torch.isfinite(sides[0][0]).all()
    ones = int((ratios[0] == 1.0).sum())
    assert ones >= len(zero), (ones, len(zero))
    del sides
    torch.cuda.empty_cache()
    ratio = ratios[0]
    del sums
    stage1_ms = time_ms(lambda: fused_lamb(p, g, m, v, plan, **sc), flush)
    apply_ms = time_ms(lambda: fused_lamb_apply(p, m, v, ratio, plan, **kw),
                       flush)
    plain_stage1 = time_ms(lambda: fused_lamb_reference(p, g, m, v, plan,
                                                        **sc), flush, reps=5)
    plain_apply = time_ms(lambda: fused_lamb_apply_reference(
        p, m, v, ratio, plan, **kw), flush, reps=5)
    # bytes: stage 1 reads p, g, m, v and writes m, v; the apply reads p,
    # m, v and writes p (partials and ratios are < 0.1% more); operations:
    # ~20 fp32 a element for stage 1 (the TPU kernel's own count), ~10 for
    # the apply
    return {"phase": "lamb", "elements": n, "buffer": total,
            "segments": len(segments), "chunks": plan.n_chunks,
            "zero_init_segments": len(zero), "ratio_one_segments": ones,
            "bit_equal": {"m": m_equal, "v": v_equal, "ratio": ratio_equal,
                          "sums": sums_equal, "repeat": repeat},
            "p_sq_rel_err_vs_float64": sums_rel,
            "p_max_ulp": p_steps, "max_abs_err": err,
            "tolerance": "m, v, ratio, sums bit-equal; p <= 1 ulp; "
                         "|p|^2 sums 1e-5 of float64",
            "kernels": {
                "fused_lamb": dict(
                    kernel_ms=stage1_ms, plain_ms=plain_stage1,
                    library_ms=None, max_abs_err=err,
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        24 * n, 20 * n, FP32_FLOPS_PER_S)))),
                "fused_lamb_apply": dict(
                    kernel_ms=apply_ms, plain_ms=plain_apply,
                    library_ms=None, max_abs_err=err,
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        16 * n, 10 * n, FP32_FLOPS_PER_S))))},
            "step_bound_ms": bound_ms(40 * n, 30 * n, FP32_FLOPS_PER_S)[0],
            "library_call": None}


def bert_batch(cfg, micro, seq, seed):
    """One pretraining batch, stacked (1, micro, ...): random ids, zero
    token types, a keep mask of ones up to a seeded valid length in
    [3/4 seq, seq] and zeros after, MLM labels at a seeded 15% of the valid
    positions (-100 elsewhere), random NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(micro, seq)).astype(np.int64)
    valid = rng.randint(3 * seq // 4, seq + 1, size=(micro,))
    mask = (np.arange(seq)[None, :] < valid[:, None]).astype(np.int64)
    pick = (rng.rand(micro, seq) < 0.15) & (mask == 1)
    mlm = np.where(pick, ids, -100).astype(np.int64)
    nsp = rng.randint(0, 2, size=(micro,)).astype(np.int64)
    return tuple(a[None] for a in (ids, np.zeros_like(ids), mask, mlm, nsp))


def phase_train_bert(launch_counters):
    """The BERT main path: BERT-large at full width and depth, seq 512,
    micro batch 32, bf16, ZeRO-2, LAMB with fp32 moments, remat on,
    dropout 0, the padded mask, through initialize(...).train_batch(...)
    on one fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.lamb import FusedLamb
    cfg = bert.config_for("bert_large", max_seq_len=BERT_SEQ, dropout=0.0,
                          attn_dropout=0.0, remat=BERT_REMAT)
    assert cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
    t0 = time.perf_counter()
    model = bert.make_bert_model(config=cfg, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=BERT_CONFIG)
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert isinstance(engine.optimizer, FusedLamb)
    assert engine.fused_optimizer_kernel == "pallas"
    assert engine.flash_attention_backend == "pallas"
    assert engine.flat.segments.shape == (26, 2)
    batch = bert_batch(cfg, BERT_MICRO, BERT_SEQ, seed=0)
    mask = batch[2][0]
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    fwd_per_step = cfg.n_layers * (2 if BERT_REMAT else 1)
    assert launches["flash_fwd"] == fwd_per_step * TRAIN_STEPS, launches
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    for name in LAMB_NAMES:
        assert launches[name] == TRAIN_STEPS, launches
    assert launches["fused_adam"] == 0, launches
    assert engine.flat.check_views()
    step_s = wall / TRAIN_STEPS
    tokens = BERT_MICRO * BERT_SEQ
    n_params = bert.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        BERT_SEQ                              # tests/perf/bert_bench.py:56-59
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch, kernel_groups=FLASH_GROUPS)
    return {"phase": "train_bert", "model": "bert_large",
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "seq": BERT_SEQ, "micro_batch": BERT_MICRO,
            "valid_tokens": int(mask.sum()), "dtype": "bf16",
            "zero_stage": 2, "optimizer": "lamb", "moments": "fp32",
            "remat": BERT_REMAT, "params": n_params,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "samples_per_sec": BERT_MICRO / step_s, "mfu": mfu,
            "mfu_formula": "tokens/s * (6 N + 12 L d s) / 989e12 "
                           "(tests/perf/bert_bench.py)",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


def phase_train_bert_parity(launch_counters, steps=5, tol=1e-4, seq=128):
    """fp32 loss trajectories at BERT-large width with 2 layers, seq 128,
    the padded mask, TF32 off: the kernels (flash "pallas", LAMB "pallas")
    against the plain versions (einsum attention "xla", plain LAMB "xla"),
    from the same init."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    micro = 8
    runs, launches = {}, {}
    for backend in ("pallas", "xla"):
        cfg = bert.config_for("bert_large", n_layers=2, max_seq_len=seq,
                              dropout=0.0, attn_dropout=0.0, remat=True)
        model = bert.make_bert_model(config=cfg, seed=1)
        engine = deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Lamb", "params": {
                "lr": 2e-3, "fused_kernel": backend}},
            "transformer": {"flash_attention": backend},
            "steps_per_print": 10 ** 9})[0]
        assert engine.flash_attention_backend == backend
        batch = bert_batch(cfg, micro, seq, seed=3)
        for counter in launch_counters:
            counter.launches = 0
        runs[backend] = [float(engine.train_batch(batch=batch))
                         for _ in range(steps)]
        launches[backend] = {c.__name__: c.launches for c in launch_counters}
        del engine, model
        torch.cuda.empty_cache()
    want = {"flash_fwd": 2 * 2 * steps, "flash_bwd_dkdv": 2 * steps,
            "flash_bwd_dq": 2 * steps, "fused_lamb": steps,
            "fused_lamb_apply": steps}
    assert launches["pallas"] == want, launches
    assert not any(launches["xla"].values()), launches
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["pallas"],
                                                  runs["xla"]))
    assert rel <= tol, (rel, runs)
    assert runs["pallas"][-1] < runs["pallas"][0], runs
    return {"phase": "train_bert_parity", "layers": 2, "d_model": 1024,
            "seq": seq, "micro_batch": micro, "dtype": "fp32",
            "steps": steps, "losses": runs, "launches": launches,
            "max_rel_diff": rel, "tolerance": tol}


# ----------------------------------------------------------- serving path


SERVE_INFERENCE = {"max_batch_size": 16, "dtype": "bf16",
                   "prefill_buckets": [128, 256, 512],
                   "max_new_tokens": 64, "greedy": True,
                   "kv_layout": "paged", "kv_block_size": 16,
                   "paged_attention_kernel": "auto"}
SERVE_REQUESTS, SERVE_PROMPT_LENS = 48, (64, 180, 400)


def phase_serve(launch_counters):
    """The main path: gpt2_medium at full width and depth, bf16, 48
    requests through the port's init_inference(...).generate(...)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.monitor import ServingMetrics
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
    assert cfg.n_layers == SERVE_LAYERS
    t0 = time.perf_counter()
    model = gpt2.make_gpt2_model(config=cfg, seed=0)
    engine = deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": SERVE_INFERENCE})
    del model
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert engine.paged_attention_kernel == "pallas"
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=SERVE_PROMPT_LENS[i % 3]).tolist()
               for i in range(SERVE_REQUESTS)]
    # warm-up: every prefill bucket and the decode step, off the clock
    engine.generate(prompts[:len(SERVE_PROMPT_LENS)], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    metrics = ServingMetrics()
    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}

    snap = metrics.snapshot()
    assert all(len(o) == SERVE_INFERENCE["max_new_tokens"] for o in outs), \
        "a request returned {} tokens".format(sorted({len(o) for o in outs}))
    assert launches["paged_attention"] == snap["decode_steps"] * SERVE_LAYERS, \
        (launches, snap["decode_steps"])
    assert engine.last_logits is not None and \
        bool(torch.isfinite(engine.last_logits).all()), "non-finite logits"
    entries = (engine.prefix_stats() or {}).get("entries", 0)
    assert engine.allocator.pages_in_use == entries, \
        (engine.allocator.pages_in_use, entries)
    profile = decode_profile(engine, prompts)
    return {"phase": "serve", "model": "gpt2_medium", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "bf16", "requests": len(outs),
            "new_tokens": sum(len(o) for o in outs),
            "engine_init_s": init_s, "wall_s": wall,
            "decode_steps": snap["decode_steps"],
            "decode_s_per_step": metrics.decode_seconds /
            max(snap["decode_steps"], 1),
            "prefill_tokens_per_sec": snap["prefill_tokens_per_sec"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "ttft_p50_s": snap["ttft"]["p50_s"],
            "ttft_p95_s": snap["ttft"]["p95_s"],
            "tpot_p50_s": snap["tpot"]["p50_s"],
            "mean_slot_occupancy": snap["mean_slot_occupancy"],
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "kv_pool_gb": engine.kv.nbytes / 2 ** 30,
            "decode_profile": profile}


def decode_profile(engine, prompts, steps=8):
    """Where a decode step's time goes: ``steps`` scheduler steps with
    every slot decoding, under torch.profiler. Returns the window's wall
    time, the device time summed over its kernels (one stream, so the
    busy time), the busy share and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(engine)
    for prompt in prompts[:engine.num_slots]:
        sched.submit(prompt, max_new_tokens=steps + 2)
    sched.step()                  # admit + prefill every slot + 1 decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"steps": steps, "wall_s_per_step": wall / steps,
            "device_busy_s_per_step": busy_us * 1e-6 / steps,
            "device_busy_share": busy_us * 1e-6 / wall,
            "kernel_launches_per_step": sum(e.count for e in kernels) /
            steps,
            "top_kernels": [{"name": e.key[:80],
                             "us_per_step": e.self_device_time_total / steps,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def phase_parity():
    """fp32 greedy streams: slot == paged plain == paged kernel, at
    gpt2_medium width with 2 layers, TF32 off for matmul and cuDNN."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=1024)
    model = gpt2.make_gpt2_model(config=cfg, seed=1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 64, 130, 300, 5, 250, 33, 480, 90, 16)]
    base = {"max_batch_size": 4, "dtype": "fp32",
            "prefill_buckets": [128, 256, 512], "max_new_tokens": 24,
            "greedy": True}
    paged = dict(base, kv_layout="paged", kv_block_size=16)
    streams = {}
    for name, inference in (("slot", base),
                            ("paged_xla", dict(paged,
                                               paged_attention_kernel="xla")),
                            ("paged_pallas", dict(
                                paged, paged_attention_kernel="pallas"))):
        engine = deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": inference})
        streams[name] = engine.generate(prompts)
        del engine
    assert streams["paged_xla"] == streams["slot"], "paged plain != slot"
    assert streams["paged_pallas"] == streams["slot"], "paged kernel != slot"
    return {"phase": "parity", "layers": 2, "d_model": cfg.d_model,
            "dtype": "fp32", "requests": len(prompts),
            "tokens_per_stream": sum(len(o) for o in streams["slot"]),
            "identical": True}


# ------------------------------------------ tensor-parallel ring GEMMs (slice 5)


RING_SOURCE = "deepspeed_tpu_torch/ops/ring_gemm/csrc/ring_gemm.cu"
RING_NAMES = ("ring_ag_gemm", "ring_rs_gemm_add", "ring_gc_gemm_acc")
TP, TP_B, TP_S, TP_D = 2, 16, 1024, 1024   # the train_tp path: gpt2_medium
# The per-step products at gpt2_medium, TP 2, micro 16, seq 1024 (one ring
# step each; "t" marks a transposed weight view, as the backward passes
# give it): (rows m, inner k, cols n) in the kernel's own terms.
RING_SITES = {
    "ring_ag_gemm": [("qkv", 1024, 1536, ""), ("fc", 1024, 2048, ""),
                     ("attn_proj_dx", 1024, 512, "t"),
                     ("mlp_proj_dx", 1024, 2048, "t")],
    "ring_rs_gemm_add": [("attn_proj", 512, 1024, ""),
                         ("mlp_proj", 2048, 1024, ""),
                         ("qkv_dx", 1536, 1024, "t"),
                         ("fc_dx", 2048, 1024, "t")],
    "ring_gc_gemm_acc": [("qkv_dw", 1024, 1536, "lhs"),
                         ("fc_dw", 1024, 2048, "lhs"),
                         ("attn_proj_dw", 1024, 512, "rhs"),
                         ("mlp_proj_dw", 1024, 2048, "rhs")],
}
# Per element, |kernel - plain| <= rel * |plain| + abs_of_max * max|plain|.
# bf16 outputs: both sides sum in fp32 (cuBLAS's reduced-precision split-K
# reduction switched off) in different orders and round once to bf16, so
# one bf16 ulp (<= 2**-7 relative); the reduce-scatter step rounds twice
# (the partial, then the sum with what arrived), so two; the floor covers
# a rounding flip of values near zero. The dW kernel's fp32 sum over
# K = 8192 rows is held at 2**-16 of its largest entry.
RING_TOL = {"ring_ag_gemm": {"rel": 2 ** -7, "abs_of_max": 2 ** -16},
            "ring_rs_gemm_add": {"rel": 2 ** -6, "abs_of_max": 2 ** -16},
            "ring_gc_gemm_acc": {"rel": 2 ** -7, "abs_of_max": 2 ** -16,
                                 "acc_abs_of_max": 2 ** -16}}


def _ring_err(got, want, tol, key="abs_of_max", rel=None):
    """(max |got - want|, the largest ratio of the error to its bound)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = tol["rel"] if rel is None else rel
    bound = rel * want.abs() + tol[key] * float(want.abs().max())
    return float(err.max()), float((err / bound).max())


def ring_case(name, k, n, mode, device, gen):
    """The operands of one site's ring step (bf16, randn): returns
    (kernel call, plain call, library call, output getter, plain output,
    flops, bytes)."""
    import torch
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    b, s_loc = TP_B, TP_S // TP
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                     dtype=torch.bfloat16)
    el = 2
    if name == "ring_ag_gemm":
        cur = rnd(b, s_loc, k)
        w = rnd(n, k).t() if mode == "t" else rnd(k, n)
        outs = [torch.zeros(b, TP * s_loc, n, device=device,
                            dtype=torch.bfloat16) for _ in range(2)]
        kern = lambda: rg.ring_ag_gemm(cur, w, outs[0], 1)
        plain = lambda: rg.ring_ag_gemm_reference(cur, w, outs[1], 1)
        lib = lambda: torch.matmul(cur, w)
        get = lambda i: outs[i][:, s_loc:]
        m = b * s_loc
        nbytes = (m * k + k * n + m * n) * el
    elif name == "ring_rs_gemm_add":
        x = rnd(b, TP * s_loc, k)
        w = rnd(n, k).t() if mode == "t" else rnd(k, n)
        recv = rnd(b, s_loc, n)
        outs = [torch.empty(b, s_loc, n, device=device,
                            dtype=torch.bfloat16) for _ in range(2)]
        kern = lambda: rg.ring_rs_gemm_add(x, w, 0, TP, outs[0], recv)
        plain = lambda: rg.ring_rs_gemm_add_reference(x, w, 0, TP, outs[1],
                                                      recv)
        lib = lambda: torch.matmul(x[:, :s_loc], w)
        get = lambda i: outs[i]
        m = b * s_loc
        nbytes = (m * k + k * n + 2 * m * n) * el
    else:
        # dW: rot (b, s_loc, a) against fixed[:, blk] (b, s_loc, c), a = k
        # and c = n; "lhs" gives (a, c), "rhs" the (c, a) transpose
        a, c = k, n
        rot = rnd(b, s_loc, a)
        fixed = rnd(b, TP * s_loc, c)
        lhs = mode == "lhs"
        shape = (a, c) if lhs else (c, a)
        acc0 = torch.randn(shape, generator=gen, device=device)
        accs = [acc0.clone(), acc0.clone()]
        outs = [torch.empty(shape, device=device, dtype=torch.bfloat16)
                for _ in range(2)]
        kern = lambda: rg.ring_gc_gemm_acc(rot, fixed, 1, accs[0], False,
                                           outs[0], lhs)
        kern.reset = lambda: accs[0].copy_(acc0)
        plain = lambda: rg.ring_gc_gemm_acc_reference(
            rot, fixed, 1, accs[1], False, outs[1], lhs)
        r2, f2 = rot.reshape(-1, a), fixed[:, s_loc:].reshape(-1, c)
        lib = (lambda: torch.matmul(r2.t(), f2)) if lhs else \
            (lambda: torch.matmul(f2.t(), r2))
        get = lambda i: (outs[i], accs[i])
        m = b * s_loc                       # the contraction length
        nbytes = (m * a + m * c) * el + a * c * (4 + 4 + el)
        return kern, plain, lib, get, 2 * m * a * c, nbytes
    return kern, plain, lib, get, 2 * m * k * n, nbytes


def phase_ring_gemm(flush):
    """The three ring-step kernels at the train_tp path's shapes (bf16)
    against their plain versions, per element, then timed beside their
    bounds and torch.matmul of the same product."""
    import torch
    device = torch.device("cuda", 0)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device=device).manual_seed(5)
    kernels = {}
    try:
        for name, sites in RING_SITES.items():
            tol = RING_TOL[name]
            rows, worst = [], 0.0
            total = dict(kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, flops=0, bytes=0)
            for site, k, n, mode in sites:
                kern, plain, lib, get, flops, nbytes = ring_case(
                    name, k, n, mode, device, gen)
                kern()
                plain()
                torch.cuda.synchronize()
                if name == "ring_gc_gemm_acc":
                    (o0, a0), (o1, a1) = get(0), get(1)
                    err, ratio = _ring_err(o0, o1, tol)
                    acc_err, acc_ratio = _ring_err(a0, a1, tol,
                                                   "acc_abs_of_max", 0.0)
                    ratio = max(ratio, acc_ratio)
                    assert torch.isfinite(o0).all()
                    # the same bits run to run, from the same acc
                    first = (a0.clone(), o0.clone())
                    kern.reset()
                    kern()
                    torch.cuda.synchronize()
                    assert torch.equal(a0, first[0]) and \
                        torch.equal(o0, first[1]), (site, "two runs differ")
                    del first
                else:
                    err, ratio = _ring_err(get(0), get(1), tol)
                    acc_err = None
                    assert torch.isfinite(get(0)).all()
                    if name in ("ring_ag_gemm", "ring_rs_gemm_add"):
                        # the same bits run to run (no split K)
                        first = get(0).clone()
                        kern()
                        torch.cuda.synchronize()
                        assert torch.equal(get(0), first), \
                            (site, "two runs differ")
                        del first
                assert ratio <= 1.0, (name, site, err, ratio)
                worst = max(worst, err)
                b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
                row = {"site": site, "k": k, "n": n, "mode": mode,
                       "max_abs_err": err, "err_over_bound": ratio,
                       "kernel_ms": time_ms(kern, flush),
                       "plain_ms": time_ms(plain, flush, reps=5),
                       "library_ms": time_ms(lib, flush),
                       "bound_ms": b_ms, "bound_by": b_by}
                if acc_err is not None:
                    row["acc_max_abs_err"] = acc_err
                rows.append(row)
                for key in ("kernel_ms", "plain_ms", "bound_ms",
                            "library_ms"):
                    total[key] += row[key]
                total["flops"] += flops
                total["bytes"] += nbytes
            _, by = bound_ms(total["bytes"], total["flops"],
                             BF16_FLOPS_PER_S)
            kernels[name] = dict(total, bound_by=by, max_abs_err=worst,
                                 sites=rows)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"phase": "kernel", "name": "ring_gemm", "tolerance": RING_TOL,
            "kernels": kernels,
            "timing": "each kernel's ms, plain_ms, bound_ms and library_ms "
                      "are sums over its four sites (one ring step of each "
                      "of one layer's sites)",
            "library_call": "torch.matmul of the same bf16 product (the "
                            "unfused path's per-device GEMM)",
            "shape": {"b": TP_B, "s": TP_S, "tp": TP, "d_model": TP_D,
                      "dtype": "bf16"}}


TP_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                             "fused_kernel": "auto"}},
    "transformer": {"flash_attention": "auto"},
    "comm": {"collective_matmul": {"enabled": True, "tensor_parallel": True,
                                   "backend": "pallas"}},
    "steps_per_print": 10 ** 9,
}


def _tp_counters():
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [rg.ring_ag_gemm, rg.ring_rs_gemm_add, rg.ring_gc_gemm_acc,
            fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam]


def tp_train_rank(rank, world, spec):
    """One rank of the tensor-parallel main path: gpt2_medium (depth
    ``spec["layers"]``) through initialize(mesh=build_mesh(model=world))
    .train_batch(...); counts reset just before the timed steps."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT,
                          n_layers=spec["layers"])
    conf = json.loads(json.dumps(TP_CONFIG))
    conf["comm"]["collective_matmul"]["backend"] = spec["backend"]
    t0 = time.perf_counter()
    model = gpt2.make_gpt2_model(config=cfg, seed=0)
    engine = deepspeed_tpu_torch.initialize(
        model=model, mesh=build_mesh(model=world), config_params=conf)[0]
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda" and engine._cm_tp
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, TRAIN_MICRO, TRAIN_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(spec["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _tp_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(spec["steps"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(x) for x in step_losses]
    profile = tp_profile(engine, batch) if spec.get("profile") else None
    return {"rank": rank, "losses": losses, "step_ms": wall * 1e3 /
            spec["steps"], "init_s": init_s, "launches": launches,
            "peak_memory_gb": peak_gb, "transport": engine.comm_transport,
            "device": str(engine.device), "views": engine.flat.check_views(),
            "train_profile": profile}


def tp_profile(engine, batch):
    """One train_tp step under torch.profiler (after the timed steps and
    the counts): this rank's device busy share and gaps, its ring
    kernels' device time, and the host time inside the ring hops (the
    start: staging copies and posting the sends; the wait: the receive
    and its copy in), marked by spans put around the port's hop functions
    for this window only."""
    from torch.profiler import record_function
    from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm
    from deepspeed_tpu_torch.parallel import ring
    start, wait = rgm.ring_rotate_start, ring.RingHop.wait

    def spanned_start(*args, **kwargs):
        with record_function("ring_hop_start"):
            return start(*args, **kwargs)

    def spanned_wait(hop):
        with record_function("ring_hop_wait"):
            return wait(hop)

    rgm.ring_rotate_start, ring.RingHop.wait = spanned_start, spanned_wait
    try:
        return train_profile(engine, batch, steps=1,
                             span_names=("ring_hop_start",
                                         "ring_hop_wait"),
                             kernel_groups=("ring_", "flash_", "Memcpy"))
    finally:
        rgm.ring_rotate_start, ring.RingHop.wait = start, wait


TP_LAYERS, TP_WARMUP, TP_STEPS = 24, 2, 10


def phase_train_tp(world=TP, layers=TP_LAYERS, steps=TP_STEPS,
                   backend="pallas"):
    """The tensor-parallel main path, ``world`` spawned ranks (one card:
    both on it, over gloo through host memory; one card each: NCCL).
    Every ring kernel must launch 4 * world times per layer per step on
    each rank (four sites, world ring steps, forward and backward as
    allgather/reduce-scatter pairs plus the dW gather-contract)."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.distributed import spawn
    spec = {"layers": layers, "warmup": TP_WARMUP, "steps": steps,
            "backend": backend, "profile": True}
    ranks = spawn(tp_train_rank, world, args=(spec,), timeout_s=900)
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          n_layers=layers)
    per_step = {"ring_ag_gemm": 4 * world * layers,
                "ring_rs_gemm_add": 4 * world * layers,
                "ring_gc_gemm_acc": 4 * world * layers,
                "flash_fwd": layers, "flash_bwd_dkdv": layers,
                "flash_bwd_dq": layers, "fused_adam": 1}
    if backend != "pallas":
        per_step.update((n, 0) for n in RING_NAMES)
    for r in ranks:
        losses = r["losses"]
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        assert r["views"], r
        for name, n in per_step.items():
            assert r["launches"][name] == n * steps, (name, r["launches"])
    assert max(abs(a - b) for a, b in zip(ranks[0]["losses"],
                                          ranks[-1]["losses"])) == 0.0
    step_ms = max(r["step_ms"] for r in ranks)
    tokens = TRAIN_MICRO * TRAIN_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * layers * cfg.d_model * \
        TRAIN_SEQ
    return {"phase": "train_tp", "model": "gpt2_medium", "layers": layers,
            "d_model": cfg.d_model, "seq": TRAIN_SEQ,
            "micro_batch": TRAIN_MICRO, "tp": world, "dtype": "bf16",
            "zero_stage": 2, "backend": backend,
            "transport": ranks[0]["transport"],
            "devices": [r["device"] for r in ranks], "steps": steps,
            "step_ms": step_ms, "tokens_per_sec": tokens / step_ms * 1e3,
            "mfu_all_ranks": tokens / step_ms * 1e3 * flops_per_token /
            (BF16_FLOPS_PER_S * len({r["device"] for r in ranks})),
            "launches_per_rank_per_step": per_step,
            "launches": {name: sum(r["launches"][name] for r in ranks)
                         for name in per_step},
            "ranks": ranks}


def _fc_leaves(tree, prefix=""):
    """The ``fc_kernel`` leaves of a JAX-shaped tree, by dotted name."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)} \
            if prefix.endswith("fc_kernel.") else {}
    out = {}
    for key, child in items:
        out.update(_fc_leaves(child, "{}{}.".format(prefix, key)))
    return out


def tp_parity_rank(rank, world, spec):
    """fp32 losses of one TP engine (2 layers at gpt2_medium width); with
    ``spec["optimizer"]`` "Lamb", the left half of every fc kernel's
    columns (rank 0's shard at TP 2) scaled by ``spec["scale_fc"]`` before
    the engine takes the model, and the fc masters returned."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.lamb import fused_lamb
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    optimizer = spec.get("optimizer", "Adam")
    counters = _tp_counters()[:3]
    if optimizer == "Lamb":
        counters.append(fused_lamb)
    for c in counters:
        c.launches = 0
    cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=False)
    conf = {"train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": optimizer,
                          "params": {"lr": spec.get("lr", 1e-4)}},
            "transformer": {"flash_attention": "xla"},
            "steps_per_print": 10 ** 9}
    mesh = None
    if world > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": spec["backend"]}}
        mesh = build_mesh(model=world)
    model = gpt2.make_gpt2_model(config=cfg, seed=1)
    if spec.get("scale_fc"):
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.endswith("fc_kernel"):
                    t[:, :t.shape[1] // 2] *= spec["scale_fc"]
    engine = deepspeed_tpu_torch.initialize(model=model, mesh=mesh,
                                            config_params=conf)[0]
    ids = spec["ids"]
    losses = [float(engine.train_batch(batch=(ids, ids)))
              for _ in range(spec["steps"])]
    out = {"losses": losses,
           "launches": {c.__name__: c.launches for c in counters}}
    if optimizer == "Lamb":
        out["fc"] = _fc_leaves(engine.get_master_params())
    return out


def phase_train_tp_parity(steps=5, tol=1e-5):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, TF32 off,
    plain attention: TP 2 with the ring kernels ("pallas") and with the
    plain ring ("ppermute"), both on the one card over gloo, against the
    port's TP 1 engine from the same init."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    runs = {}
    for backend in ("pallas", "ppermute"):
        ranks = spawn(tp_parity_rank, 2, args=({"backend": backend,
                                                "ids": ids,
                                                "steps": steps},),
                      timeout_s=600)
        assert ranks[0]["losses"] == ranks[1]["losses"]
        live = backend == "pallas"
        for r in ranks:
            assert all((n > 0) == live for n in r["launches"].values()), r
        runs["tp2_" + backend] = ranks[0]["losses"]
    runs["tp1"] = tp_parity_rank(0, 1, {"ids": ids, "steps": steps})[
        "losses"]
    torch.cuda.empty_cache()
    ref = runs["tp1"]
    rel = {name: max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
           for name, losses in runs.items() if name != "tp1"}
    rel["pallas_vs_ppermute"] = max(
        abs(a - b) / abs(b) for a, b in zip(runs["tp2_pallas"],
                                            runs["tp2_ppermute"]))
    assert max(rel.values()) <= tol, (rel, runs)
    return {"phase": "train_tp_parity", "layers": 2, "d_model": 1024,
            "dtype": "fp32", "tp": 2, "steps": steps, "losses": runs,
            "max_rel_diff": rel, "tolerance": tol}


def phase_train_tp_lamb(steps=2, loss_tol=1e-5, master_atol=5e-5,
                        scale=20.0):
    """LAMB under tensor parallelism on the card: fp32, gpt2_medium width
    with 2 layers, TF32 off, plain attention, rank 0's half of every fc
    kernel scaled x20 (shards of unequal norms), TP 2 through the ring and
    LAMB kernels (two gloo ranks on this card) against the TP 1 engine:
    losses and the fc masters, where a ratio taken from one shard's norms
    shows. Tolerances as the CPU test's (tests/test_torch_tp_training.py)."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    spec = {"backend": "pallas", "ids": ids, "steps": steps,
            "optimizer": "Lamb", "lr": 1e-3, "scale_fc": scale}
    ranks = spawn(tp_parity_rank, 2, args=(spec,), timeout_s=600)
    tp1 = tp_parity_rank(0, 1, spec)
    torch.cuda.empty_cache()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for r in ranks:
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
    assert tp1["launches"]["fused_lamb"] == steps, tp1["launches"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                       tp1["losses"]))
    fc_err = max(float(np.abs(ranks[0]["fc"][name] - w).max())
                 for name, w in tp1["fc"].items())
    assert sorted(ranks[0]["fc"]) == sorted(tp1["fc"]) and tp1["fc"]
    assert loss_rel <= loss_tol and fc_err <= master_atol, \
        (loss_rel, fc_err)
    return {"phase": "train_tp_lamb", "layers": 2, "d_model": 1024,
            "dtype": "fp32", "tp": 2, "steps": steps, "fc_scale": scale,
            "losses": {"tp2": ranks[0]["losses"], "tp1": tp1["losses"]},
            "launches_tp2_rank0": ranks[0]["launches"],
            "loss_max_rel_diff": loss_rel, "fc_master_max_abs_diff": fc_err,
            "tolerance": {"loss_rel": loss_tol, "master_atol": master_atol}}


def nccl_rank(rank, world, spec):
    """One rank of the multi-card run: each site's ring op (kernels, and
    the plain ring) against the unfused reference (all_gather_into_tensor
    + torch.matmul, or torch.matmul + reduce_scatter_tensor), by CUDA
    events with a barrier before each timed call; then the TP train step."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    group = dist.group.WORLD
    device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(rank)
    b, s = TP_B, TP_S
    s_loc = s // world
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                     dtype=torch.bfloat16)

    def timed(fn, reps=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def ring_err(got, want):
        # the same products; the sums of the partials round in bf16 in
        # another order (the ring adds one a hop, NCCL its own way)
        err = (got.float() - want.float()).abs()
        bound = 2 ** -5 * want.float().abs() + \
            2 ** -10 * float(want.float().abs().max())
        assert bool((err <= bound).all()), float(err.max())

    ops = {}
    for site, f in (("qkv", 3 * TP_D), ("fc", 4 * TP_D)):
        x, w = rnd(b, s_loc, TP_D), rnd(TP_D, f // world)
        full = torch.empty(b, s, TP_D, device=device, dtype=torch.bfloat16)

        def unfused():
            dist.all_gather_into_tensor(full.view(world * b, s_loc, TP_D),
                                        x)
            return torch.matmul(full.view(world, b, s_loc, TP_D)
                                .transpose(0, 1).reshape(b, s, TP_D), w)
        ring_err(rg.ag_matmul(x, w, group), unfused())
        ops["ag_" + site] = {
            "kernels_ms": timed(lambda: rg.ag_matmul(x, w, group)),
            "plain_ring_ms": timed(lambda: rg.ag_matmul(x, w, group,
                                                        use_kernel=False)),
            "unfused_ms": timed(unfused)}
    for site, f in (("attn_proj", TP_D), ("mlp_proj", 4 * TP_D)):
        x, w = rnd(b, s, f // world), rnd(f // world, TP_D)
        out = torch.empty(b, s_loc, TP_D, device=device,
                          dtype=torch.bfloat16)

        def unfused():
            part = torch.matmul(x, w).view(b, world, s_loc, TP_D) \
                .transpose(0, 1).contiguous()
            dist.reduce_scatter_tensor(out, part.view(world * b, s_loc,
                                                      TP_D))
            return out
        ring_err(rg.matmul_rs(x, w, group), unfused())
        ops["rs_" + site] = {
            "kernels_ms": timed(lambda: rg.matmul_rs(x, w, group)),
            "plain_ring_ms": timed(lambda: rg.matmul_rs(x, w, group,
                                                        use_kernel=False)),
            "unfused_ms": timed(unfused)}
    for site, f in (("qkv_dw", 3 * TP_D), ("fc_dw", 4 * TP_D)):
        x, dy = rnd(b, s_loc, TP_D), rnd(b, s, f // world)
        full = torch.empty(b, s, TP_D, device=device, dtype=torch.bfloat16)

        def unfused():
            dist.all_gather_into_tensor(full.view(world * b, s_loc, TP_D),
                                        x)
            gathered = full.view(world, b, s_loc, TP_D).transpose(0, 1)
            return torch.matmul(gathered.reshape(-1, TP_D).t(),
                                dy.reshape(-1, f // world))
        ring_err(rg.gather_contract(x, dy, group), unfused())
        ops["gc_" + site] = {
            "kernels_ms": timed(lambda: rg.gather_contract(x, dy, group)),
            "plain_ring_ms": timed(lambda: rg.gather_contract(
                x, dy, group, use_kernel=False)),
            "unfused_ms": timed(unfused)}
    torch.cuda.empty_cache()
    train = {backend: tp_train_rank(rank, world, dict(spec,
                                                      backend=backend))
             for backend in ("pallas", "ppermute")}
    return {"rank": rank, "ops": ops, "train": train}


def main_tp_nccl():
    """``--tp-nccl``: tensor parallelism with one rank per card over NCCL
    at TP 2 and TP 4 (needs 4 cards): the ring ops against the unfused
    collective + matmul, and the train_tp step on both backends."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    count = torch.cuda.device_count()
    assert count >= 4, "--tp-nccl needs 4 cards, found {}".format(count)
    spec = {"layers": TP_LAYERS, "warmup": TP_WARMUP, "steps": 5}
    for world in (2, 4):
        ranks = spawn(nccl_rank, world, args=(spec,), timeout_s=900)
        for r in ranks:
            for backend, t in r["train"].items():
                assert t["transport"] == "nccl", t
                assert t["losses"][-1] < t["losses"][0], t
        emit({"phase": "tp_nccl", "tp": world, "transport": "nccl",
              "ops_rank0": ranks[0]["ops"],
              "ops_max_over_ranks": {
                  op: {k: max(r["ops"][op][k] for r in ranks)
                       for k in ranks[0]["ops"][op]}
                  for op in ranks[0]["ops"]},
              "train_step_ms": {
                  backend: max(r["train"][backend]["step_ms"]
                               for r in ranks)
                  for backend in ("pallas", "ppermute")},
              "peak_memory_gb": max(r["train"]["pallas"]["peak_memory_gb"]
                                    for r in ranks),
              "losses": ranks[0]["train"]["pallas"]["losses"],
              "launches_rank0": ranks[0]["train"]["pallas"]["launches"],
              "shape": {"b": TP_B, "s": TP_S, "d_model": TP_D,
                        "layers": TP_LAYERS, "dtype": "bf16"}})


KERNELS = [
    # name, source, the TPU kernel it replaces, the path that launches it
    ("paged_attention",
     "deepspeed_tpu_torch/ops/paged_attention/csrc/paged_attention.cu",
     "deepspeed_tpu/ops/pallas/paged_attention.py:141", "serve"),
    ("flash_fwd",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:518 (_fwd_packed), "
     ":442 (_fwd)", "train"),
    ("flash_bwd_dkdv",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:756 "
     "(_bwd_fused_packed), :897 (_bwd_split_packed, dk/dv call :962), "
     ":471 (_bwd)", "train"),
    ("flash_bwd_dq",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:756 "
     "(_bwd_fused_packed), :897 (_bwd_split_packed, dq call :937), "
     ":471 (_bwd)", "train"),
    ("fused_adam", "deepspeed_tpu_torch/ops/adam/csrc/fused_adam.cu",
     "deepspeed_tpu/ops/adam/pallas_adam.py:45", "train"),
    ("block_sparse_fwd", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:730 "
     "(_fwd_pk), :906 (_fwd)", "train_sparse"),
    ("block_sparse_bwd_dq", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:770 "
     "(_bwd_pk, dq call :792), :943 (_bwd, dq call :959)", "train_sparse"),
    ("block_sparse_bwd_dkdv", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:770 "
     "(_bwd_pk, dk/dv call :823), :943 (_bwd, dk/dv call :988)",
     "train_sparse"),
    ("fused_lamb", LAMB_SOURCE,
     "deepspeed_tpu/ops/lamb/pallas_lamb.py:65 (_lamb_stage1_flat, "
     "pallas_call :74) with stage 2's norms and trust ratio (:120-125)",
     "train_bert"),
    ("fused_lamb_apply", LAMB_SOURCE,
     "deepspeed_tpu/ops/lamb/pallas_lamb.py:127 (stage 2's apply, XLA ops "
     "after the :74 pallas_call)", "train_bert"),
    ("ring_ag_gemm", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:170 (ag_matmul_pallas, "
     "pallas_call :188, body _ag_kernel :145)", "train_tp"),
    ("ring_rs_gemm_add", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:239 (matmul_rs_pallas, "
     "pallas_call :258, body _rs_kernel :208)", "train_tp"),
    ("ring_gc_gemm_acc", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:303 (gather_contract_pallas, "
     "pallas_call :321, body _gc_kernel :279)", "train_tp"),
]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    from deepspeed_tpu_torch.ops import cuda_build
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.lamb import fused_lamb, fused_lamb_apply
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # each kernel's wrapper holds its launch count
    wrappers = {"paged_attention": paged_attention,
                "flash_fwd": fa.flash_fwd, "flash_bwd_dkdv": fa.flash_bwd_dkdv,
                "flash_bwd_dq": fa.flash_bwd_dq, "fused_adam": fused_adam,
                "fused_lamb": fused_lamb, "fused_lamb_apply": fused_lamb_apply}
    wrappers.update((name, getattr(bsa, name)) for name in SPARSE_NAMES)
    wrappers.update((name, getattr(rg, name)) for name in RING_NAMES)
    sources = sorted({src for _, src, _, _ in KERNELS})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        records = list(pool.map(cuda_build.build, sources))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [{"source": src, "seconds": r.seconds,
                       "ptxas": [line.strip() for line in r.log.splitlines()
                                 if "registers" in line or "spill" in line]}
                      for src, r in zip(sources, records)]})
    if "--tp-nccl" in sys.argv[1:]:
        main_tp_nccl()
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel = phase_kernel(flush)
    emit(kernel)
    flash = phase_flash(flush)
    emit(flash)
    torch.cuda.empty_cache()
    flash_bert = phase_flash_bert(flush)
    emit(flash_bert)
    torch.cuda.empty_cache()
    emit(phase_flash3d(flush))
    torch.cuda.empty_cache()
    emit(phase_flash_fp32_repeats())
    emit(phase_flash_fp16())
    torch.cuda.empty_cache()
    adam = phase_adam(flush)
    emit(adam)
    torch.cuda.empty_cache()
    lamb = phase_lamb(flush)
    emit(lamb)
    torch.cuda.empty_cache()
    sparse = phase_sparse(flush)
    emit(sparse)
    torch.cuda.empty_cache()
    ring = phase_ring_gemm(flush)
    emit(ring)
    del flush
    torch.cuda.empty_cache()

    train_counters = [wrappers[name] for name, _, _, path in KERNELS
                      if path == "train"]
    train = phase_train(train_counters)
    emit(train)
    torch.cuda.empty_cache()
    emit(phase_train_parity())
    torch.cuda.empty_cache()

    # the BERT path: every dense-training kernel's count, so Adam is seen
    # not to launch there
    bert_counters = [wrappers[name] for name, _, _, path in KERNELS
                     if path in ("train", "train_bert")]
    train_bert = phase_train_bert(bert_counters)
    emit(train_bert)
    torch.cuda.empty_cache()
    emit(phase_train_bert_parity(
        [wrappers[name] for name in ("flash_fwd", "flash_bwd_dkdv",
                                     "flash_bwd_dq") + LAMB_NAMES]))
    torch.cuda.empty_cache()

    # the long-context path: every training kernel's count, so the flash
    # kernels are seen not to launch there
    train_sparse = phase_train_sparse(
        [wrappers[name] for name, _, _, path in KERNELS
         if path in ("train", "train_sparse")])
    emit(train_sparse)
    torch.cuda.empty_cache()
    emit(phase_train_sparse_parity())
    torch.cuda.empty_cache()

    serve = phase_serve([wrappers["paged_attention"]])
    emit(serve)
    torch.cuda.empty_cache()
    emit(phase_parity())
    torch.cuda.empty_cache()

    # the tensor-parallel path: two ranks on this card (gloo), each with
    # its own counts, reset just before its timed steps
    train_tp = phase_train_tp()
    emit(train_tp)
    emit(phase_train_tp_parity())
    emit(phase_train_tp_lamb())

    measured = {"paged_attention": dict(
        kernel, max_abs_err=kernel["max_abs_err"])}
    # rows at the GPT-2 train shape; the error over both modes (causal,
    # and BERT's non-causal with the key bias)
    grads = {"flash_fwd": ("out",), "flash_bwd_dq": ("dq",),
             "flash_bwd_dkdv": ("dk", "dv")}
    for name, row in flash["kernels"].items():
        err = max(mode["errors"][g + "_abs"] for mode in (flash, flash_bert)
                  for g in grads[name])
        measured[name] = dict(row, max_abs_err=err)
    measured["fused_adam"] = adam
    measured.update(lamb["kernels"])
    # rows at the main path's (shared) layout; the error over both layouts
    grads = {"block_sparse_fwd": ("out",), "block_sparse_bwd_dq": ("dq",),
             "block_sparse_bwd_dkdv": ("dk", "dv")}
    for name in SPARSE_NAMES:
        err = max(lay["errors"][g + "_abs"] for lay in
                  sparse["layouts"].values() for g in grads[name])
        measured[name] = dict(sparse["layouts"]["shared"]["kernels"][name],
                              max_abs_err=err)
    launches = dict(serve["launches"], **train["launches"])
    launches.update((name, train_sparse["launches"][name])
                    for name in SPARSE_NAMES)
    launches.update((name, train_bert["launches"][name])
                    for name in LAMB_NAMES)
    # the ring kernels' rows: sums over one ring step of each of one
    # layer's four sites; launches over both ranks
    measured.update(ring["kernels"])
    launches.update((name, train_tp["launches"][name])
                    for name in RING_NAMES)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["kernel_ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        "library_ms": measured[name]["library_ms"]}
        for name, source, replaces, _ in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
