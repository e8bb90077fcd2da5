#!/usr/bin/env python3
"""Whether the tensor-parallel test engine's fp32 losses repeat bit for bit
on the CPU: the specs of ``tests/test_torch_tp_training.py`` in gloo ranks
(``tests/torch_tp_workers.py``), with nothing of JAX. Not a test and on no
path of the package.

    python3 probes/tp_determinism.py [SPAWNS [THREADS]]

from the root of the repository. Prints one JSON line a check:

* ``repeats``: SPAWNS spawns of two ranks at THREADS intra-op threads (by
  default the host's count, what the ranks ran before they were made
  single-threaded), each running the kernel backend (``"pallas"``), bf16,
  the plain ring (``"ppermute"``) and the kernel backend again: in how
  many ranks the three fp32 runs' losses are equal, and each rank where
  they are not, with its losses (run several copies at once to load the
  host);
* ``threads``: both backends at 1, 2, 3, 4 and 8 intra-op threads in one
  rank: whether every run's losses equal the first's;
* ``dirty_heap``: both backends four times in one rank, the heap filled
  with NaN (torch and numpy buffers of many sizes, freed) before each
  run after the first: whether every run's losses equal the first's.
"""
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch_tp_workers as workers  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import spawn  # noqa: E402

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)


def _spec(prec, backend="pallas"):
    ids = np.random.RandomState(0).randint(0, 128, size=(1, 2, 32))
    return dict(model=MODEL, seed=0, prec=prec, backend=backend, micro=2,
                ids=ids.astype(np.int64), steps=3, load=None)


def _losses(rank, world, spec):
    return workers.tp_engine(rank, world, [spec])[0]["losses"]


def repeats_body(rank, world, specs, threads):
    import torch
    threads = threads or torch.get_num_threads()
    # tp_engine sets one thread; this sets the count after it
    workers.single_threaded = lambda: torch.set_num_threads(threads)
    return workers.tp_engine(rank, world, specs)


def threads_body(rank, world, counts):
    import torch
    runs = []
    for n in counts:
        for backend in ("pallas", "ppermute"):
            # tp_engine sets one thread; this sets the count after it
            workers.single_threaded = lambda n=n: torch.set_num_threads(n)
            runs.append(_losses(rank, world, _spec("fp32", backend)))
    return runs


def dirty_heap_body(rank, world):
    import torch
    runs = []
    for rep in range(4):
        if rep:
            junk = [torch.full((n,), float("nan")) for n in
                    [7, 100, 1000, 4096, 10000, 33000, 65536, 131072,
                     262144, 1 << 20] * 20]
            junk += [np.full(n, np.nan, np.float32)
                     for n in [1000, 50000, 300000] * 20]
            del junk
        for backend in ("pallas", "ppermute"):
            runs.append(_losses(rank, world, _spec("fp32", backend)))
    return runs


def main():
    spawns = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    threads = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    specs = [_spec("fp32"), _spec("bf16"), _spec("fp32", "ppermute"),
             _spec("fp32")]
    equal, differ = 0, []
    for i in range(spawns):
        ranks = spawn(repeats_body, 2, args=(specs, threads), timeout_s=600)
        for r, rank in enumerate(ranks):
            losses = [rank[j]["losses"] for j in (0, 2, 3)]
            if losses[0] == losses[1] == losses[2]:
                equal += 1
            else:
                differ.append({"spawn": i, "rank": r,
                               "pallas": losses[0], "ppermute": losses[1],
                               "pallas_again": losses[2]})
    print(json.dumps({"check": "repeats", "spawns": spawns,
                      "threads": threads or "default",
                      "ranks_all_equal": equal, "ranks": 2 * spawns,
                      "differ": differ}), flush=True)
    counts = (1, 2, 3, 4, 8)
    for rank in spawn(threads_body, 2, args=(counts,), timeout_s=600):
        print(json.dumps({"check": "threads", "counts": counts,
                          "all_equal": all(r == rank[0] for r in rank)}),
              flush=True)
    for rank in spawn(dirty_heap_body, 2, timeout_s=600):
        print(json.dumps({"check": "dirty_heap",
                          "all_equal": all(r == rank[0] for r in rank)}),
              flush=True)


if __name__ == "__main__":
    main()
