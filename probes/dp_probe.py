#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases on their own, after building the
kernels, on a machine with the card:

    python3 probes/dp_probe.py PHASE [PHASE ...]

PHASE is a phase function's name without ``phase_`` (e.g. ``train_dp``,
``train_dp_parity``, ``train_dp_tp_parity``, ``train``, ``kernel``,
``serve_spec``, ``serve_tp``, ``train_example_data``, ``cpu_adam``,
``train_xl_offload``, ``train_offload_parity``, ``train_dp3``,
``train_offload_ckpt``, ``train_pipe``, ``train_pipe_parity``,
``train_comm`` (``train_onebit`` and ``train_qc``, one spawn),
``train_xl_stream``, ``train_stream_parity``, ``train_pipe3`` (its own
four ranks), ``train_zeropp`` (its own two and four ranks); on four
cards ``dp_nccl_zero3``), optionally with integer keyword arguments,
``train_dp:world=1,steps=4``; each prints its JSON line. Two phases of
this file's own, on no path of ``chip_smoke.py``: ``train_pipe3_repeat``
(stage 2 and stage 3 twice each, step by step; ``:deterministic=1``
under PyTorch's deterministic-algorithm warnings) and, on four cards,
``dp_nccl_zeropp`` (dp_nccl_zero3's stage 3 and ZeRO++ legs only;
``:ring=1``: stage 3 and the two ring legs). Not a test and on no path
of the package.
"""
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def phase_train_pipe3_repeat(steps=3, deterministic=0):
    """train_pipe3's four gloo ranks on this card (PP 2 x DP 2, its
    config): stage 2 twice and stage 3 twice from one init, step by step,
    and where stage 3 parts from stage 2 (``pipe_chip.pipe3_repeat_rank``);
    ``deterministic=1`` runs them under PyTorch's deterministic-algorithm
    warnings."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    pc = cs._pipe_chip()
    spec = dict(cs.pipe3_spec(steps=steps), deterministic=bool(deterministic))
    try:
        ranks = spawn(pc.pipe3_repeat_rank, 4, args=(spec,), timeout_s=900)
    finally:
        pc.remove(spec["dir"])
    return {"phase": "train_pipe3_repeat", "steps": steps,
            "deterministic": bool(deterministic), "ranks": ranks}


def phase_dp_nccl_zeropp(world=4, steps=2, ring=0):
    """dp_nccl_zero3 with stage 3 and the ZeRO++ legs only (``ring=1``:
    stage 3 and the ring legs), held to stage 3 as that phase holds them;
    the line is printed before a failed check raises."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    legs = (("stage3", {"stage": 3}, None),) + tuple(
        leg for leg in cs.XL_ZEROPP_LEGS
        if not ring or leg[2] is not None)
    ranks = spawn(cs.nccl_zero3_rank, world,
                  args=({"steps": steps, "legs": legs},), timeout_s=2400)
    failed = cs._nccl_zero3_checks(ranks, [name for name, _, _ in legs])
    cs.emit({"phase": "dp_nccl_zeropp", "model": "gpt2_xl", "data": world,
             "steps": steps, "transport": ranks[0]["transport"],
             "failed": failed, "ranks": ranks})
    assert not failed, failed
    return {"phase": "dp_nccl_zeropp", "checks": "passed"}


def main():
    import torch
    from deepspeed_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        sys.exit("dp_probe: no CUDA device is available")
    import subprocess
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.emit({"phase": "device", "nvidia_smi": smi})
    sources = sorted({src for _, src, _, _ in cs.KERNELS})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for arg in sys.argv[1:]:
        name, _, kw = arg.partition(":")
        kwargs = {k: int(v) for k, v in
                  (item.split("=") for item in kw.split(",") if item)}
        fn = globals().get("phase_" + name) or getattr(cs, "phase_" + name)
        t0 = time.perf_counter()
        if name in ("train", "train_example", "train_ckpt", "train_dp_ckpt",
                    "train_remat", "train_example_data"):
            # the flash kernels' and Adam's counts
            res = fn(cs._dp_counters()[:4], **kwargs)
        elif name in ("serve", "serve_spec", "serve_spec_parity"):
            from deepspeed_tpu_torch.ops.paged_attention import \
                paged_attention
            res = fn([paged_attention], **kwargs)
        elif name == "kernel":
            res = fn(torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda"), **kwargs)
        else:
            res = fn(**kwargs)
        # train_comm gives two lines (train_onebit, train_qc)
        for line in res if isinstance(res, tuple) else (res,):
            line["probe_wall_s"] = time.perf_counter() - t0
            cs.emit(line)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
