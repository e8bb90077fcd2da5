#!/usr/bin/env python3
"""Hunts the fp32 key-mask flake of ``chip_smoke.py``'s
``flash_fp32_repeats``: now and then the CPU plain version's run of the
case lands ~2e-5 off the kernel and off float64. Not a test and on no
path of the package.

    python3 probes/flash_cpu_flake.py [PROCESSES] [--out PATH]

from the root of the repository, on a machine with the card. It starts
PROCESSES (default 3) processes of each kind, one after another:

* ``after``: builds the kernels and runs ``chip_smoke.py``'s phases that
  come before ``flash_fp32_repeats`` in a full run (kernel, flash,
  flash_bert, flash3d), then that phase;
* ``fresh``: runs only ``flash_fp32_repeats``;
* ``cpu_first``: runs the CPU half of the case first (5 runs, no CUDA
  work before it), then the phase.

Each process prints one JSON line: whether the phase passed, its CPU
runs' out against float64, and each CPU run's forward intermediates (S,
P, the row sums l, P.V per key tile) against float64 and against CPU
run 1 (``chip_smoke._trace_report``). ``--out`` also writes the lines to
a file.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def child(kind):
    import numpy as np
    import torch
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import cuda_build
    out = {"kind": kind, "threads": torch.get_num_threads()}
    if kind == "cpu_first":
        arrays, mask = cs.flash_fp32_case()
        traces = [[] for _ in range(5)]
        runs = [cs.flash_fp32_run(arrays, mask, torch.device("cpu"), t)
                for t in traces]
        out["cpu_first_runs_equal"] = all(
            all(torch.equal(a, b) for a, b in zip(r, runs[0]))
            for r in runs)
        out["cpu_first_intermediates"] = cs._trace_report(
            traces, cs._online_float64(arrays, mask))
    if kind == "after":
        for _, src, _, _ in cs.KERNELS:
            cuda_build.build(src)
        flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                            device="cuda")
        for phase in (cs.phase_kernel, cs.phase_flash, cs.phase_flash_bert,
                      cs.phase_flash3d):
            phase(flush)
            torch.cuda.empty_cache()
        del flush
    try:
        res = cs.phase_flash_fp32_repeats()
        out["passed"] = True
    except AssertionError as err:
        res = err.args[0] if err.args and isinstance(err.args[0], dict) \
            else {"error": repr(err)}
        out["passed"] = False
    for key in ("max_rel_err", "cpu_runs_differing_from_the_first",
                "out_max_abs_err_vs_float64", "cpu_intermediates", "error"):
        if key in res:
            out[key] = res[key]
    np.set_printoptions(precision=17)
    print("RESULT " + json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        child(args[1])
        return
    path = None
    if "--out" in args:
        path = args[args.index("--out") + 1]
        args = [a for a in args if a not in ("--out", path)]
    count = int(args[0]) if args else 3
    lines = []
    for _ in range(count):
        for kind in ("after", "fresh", "cpu_first"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", kind],
                capture_output=True, text=True, cwd=ROOT, timeout=900)
            found = [line[7:] for line in proc.stdout.splitlines()
                     if line.startswith("RESULT ")]
            line = found[0] if found else json.dumps(
                {"kind": kind, "returncode": proc.returncode,
                 "stderr": proc.stderr[-2000:]})
            print(line, flush=True)
            lines.append(line)
    if path:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
