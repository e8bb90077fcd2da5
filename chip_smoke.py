#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
with no ``ok`` line):

1. device — the card's name and power limit from ``nvidia-smi``;
2. build  — every kernel of the path built with nvcc from the checkout's
   sources, all builds started together;
3. kernel — each kernel against its plain PyTorch version on the card at
   the path's shapes (NaN-poisoned pools), with its time, the plain
   version's, the least time the card could take (``bound_ms``) and a
   PyTorch library call's where one exists;
4. serve  — the main path: ``init_inference(...).generate(...)`` serving
   48 requests with GPT-2-350M (``gpt2_medium``) at full width and depth,
   bf16, from the paged KV cache, with every kernel's launch count set to
   0 just before and read just after; then a few all-slot decode steps
   under torch.profiler (device busy share, costliest kernels);
5. parity — fp32 greedy streams identical for the slot layout, the paged
   layout's plain read path and the paged kernel, on the card;

then one ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
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


def paged_case(s, seed, device):
    """The serving path's paged-attention shapes: 16 slots, 16 heads,
    d_head 64, pages of 16 tokens, the full gpt2_medium pool (1024 usable
    pages + garbage page 0, 24 layers) in bf16, 64 pages per table.
    Lengths spread to 1023 so windows cross page boundaries; garbage page
    0 and every unallocated page are NaN. With s > 1 the valid lengths
    are padded (some slots have fewer real queries than s)."""
    import torch
    b, h, dh, ps, max_pages, layers, usable = 16, 16, 64, 16, 64, 24, 1024
    rng = np.random.RandomState(seed)
    positions = np.linspace(0, max_pages * ps - s, b).round().astype(np.int32)
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel(flush):
    """paged_attention vs paged_attention_reference on the card."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)
    device = torch.device("cuda", 0)
    max_err, checks = 0.0, []
    for s in (1, 4):
        case = paged_case(s, seed=s, device=device)
        for layer in (0, SERVE_LAYERS - 1):
            args = (case["q"], case["k_pool"], case["v_pool"],
                    case["page_tables"], case["positions"],
                    case["valid_lens"])
            kw = dict(layer_idx=layer, page_size=case["page_size"])
            got = paged_attention(*args, **kw)
            want = paged_attention_reference(*args, **kw)
            torch.cuda.synchronize()
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

    # times at the decode shape of the path (s = 1)
    case = paged_case(1, seed=1, device=device)
    args = (case["q"], case["k_pool"], case["v_pool"], case["page_tables"],
            case["positions"], case["valid_lens"])
    kw = dict(layer_idx=0, page_size=case["page_size"])
    kernel_ms = time_ms(lambda: paged_attention(*args, **kw), flush)
    plain_ms = time_ms(lambda: paged_attention_reference(*args, **kw), flush)
    bound_ms, bound_by = paged_bound_ms(case)
    # yardstick: scaled_dot_product_attention over rows gathered into
    # contiguous memory beforehand (the gather itself is excluded)
    b, _, h, dh = case["q"].shape
    index = case["page_tables"].long()
    rows_of = lambda pool: torch.nan_to_num(pool[:, 0][index]).permute(
        0, 2, 1, 3, 4).reshape(b, h, -1, dh).contiguous()
    k_rows, v_rows = rows_of(case["k_pool"]), rows_of(case["v_pool"])
    live = (case["positions"] + case["valid_lens"] - 1).long()
    mask = (torch.arange(k_rows.shape[2], device=device)[None, :] <=
            live[:, None])[:, None, None, :]
    qh = case["q"].transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, k_rows, v_rows, attn_mask=mask), flush)
    return {"phase": "kernel", "name": "paged_attention", "checks": checks,
            "max_abs_err": max_err, "tolerance": 2e-5, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention over pre-gathered "
                            "contiguous rows, gather excluded",
            "shape": {"slots": b, "heads": h, "d_head": dh, "page_size": 16,
                      "max_pages": 64, "pool_dtype": "bf16", "s": 1}}


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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    from deepspeed_tpu_torch.ops import paged_attention as pa_ops
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # every kernel of the path: its wrapper (which holds the launch
    # count) and its build function
    kernels = [{"name": "paged_attention", "route": "cuda",
                "source": "deepspeed_tpu_torch/ops/paged_attention/csrc/"
                          "paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:141",
                "wrapper": paged_attention, "build": pa_ops.build}]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        records = list(pool.map(lambda k: k["build"](), kernels))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{"name": k["name"], "seconds": r.seconds,
                       "ptxas": [line.strip() for line in r.log.splitlines()
                                 if "registers" in line or "spill" in line]}
                      for k, r in zip(kernels, records)]})

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel = phase_kernel(flush)
    del flush
    torch.cuda.empty_cache()
    emit(kernel)

    serve = phase_serve([k["wrapper"] for k in kernels])
    emit(serve)
    torch.cuda.empty_cache()
    emit(phase_parity())

    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": serve["launches"]["paged_attention"],
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["kernel_ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
