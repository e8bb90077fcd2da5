"""GPT-2 pretraining on the PyTorch/CUDA port: the twin of
``examples/gpt2/pretrain.py`` (reference DeepSpeedExamples/Megatron-LM,
BASELINE configs 2/4/5's shape).

Run (synthetic tokens):
  python -m deepspeed_tpu_torch.examples.gpt2_pretrain --size gpt2_small \
      --deepspeed_config examples/gpt2/ds_config_zero2.json --steps 50
(add ``--device cpu`` without a GPU). The tokens are the JAX example's,
drawn from ``RandomState(0)``; the config's ``scheduler`` section
(WarmupDecayLR) steps the learning rate. ``--n_layers``, ``--d_model``,
``--n_heads`` and ``--vocab_size`` override the size's (a test runs it
tiny).

Run (real tokens via the native mmap dataset + prefetch loader):
  python -m deepspeed_tpu_torch.examples.gpt2_pretrain \
      --data_prefix /path/to/corpus ...
where corpus.bin/.idx were written by
``deepspeed_tpu_torch.runtime.data.IndexedDatasetBuilder`` (or the JAX
package's, the same format). Each step takes the loader's next ``gas x
global micro`` windows of ``seq_len`` tokens, as the JAX example does.
"""
import argparse
import time

import numpy as np

import deepspeed_tpu_torch as deepspeed
from deepspeed_tpu_torch.models import gpt2

OVERRIDES = ("n_layers", "d_model", "n_heads", "vocab_size")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="gpt2_small",
                        choices=sorted(gpt2.SIZES))
    parser.add_argument("--seq_len", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--data_prefix", default=None,
                        help=".bin/.idx token dataset prefix (default: "
                             "synthetic random tokens)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current GPU)")
    for name in OVERRIDES:
        parser.add_argument("--" + name, type=int, default=None,
                            help="override the size's " + name)
    parser = deepspeed.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None):
    """Train as the JAX example does; returns the per-step losses, the
    learning rate each step ran at, each step's wall seconds (the loss
    read back, so the device work is done), the host seconds each batch
    took to come off the loader, and the engine."""
    args = parse_args(argv)
    overrides = {k: getattr(args, k) for k in OVERRIDES
                 if getattr(args, k) is not None}
    model = gpt2.make_gpt2_model(size=args.size, max_seq_len=args.seq_len,
                                 **overrides)
    engine, _, _, _ = deepspeed.initialize(
        args=args, model=model, config_params=args.deepspeed_config,
        device=args.device)

    micro = engine.train_micro_batch_size_per_gpu()
    mb = micro * engine.dp_world_size
    gas = engine.gradient_accumulation_steps()
    # the JAX example's global batch; over a data group each rank trains
    # on its rows of it
    rows = slice(engine.dp_rank * micro, (engine.dp_rank + 1) * micro)
    loader = None
    if args.data_prefix:
        from deepspeed_tpu_torch.runtime.data import (IndexedDataset,
                                                      NativePrefetchLoader)
        loader = NativePrefetchLoader(IndexedDataset(args.data_prefix),
                                      batch_size=gas * mb,
                                      seq_len=args.seq_len)

        def draw():
            return next(loader).reshape(gas, mb, args.seq_len)
    else:
        rs = np.random.RandomState(0)

        def draw():
            return rs.randint(0, model.config.vocab_size,
                              size=(gas, mb, args.seq_len)).astype(np.int32)

    losses, lrs, seconds, load_seconds = [], [], [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        ids = np.ascontiguousarray(draw()[:, rows])
        load_seconds.append(time.perf_counter() - t0)
        lrs.append(engine.get_lr()[0])
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch=(ids, ids.copy())))
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % 10 == 0:
            print("step {} loss {:.4f}".format(step, loss))
    if loader is not None:
        loader.close()
        loader.ds.close()
    return {"losses": losses, "lrs": lrs, "step_seconds": seconds,
            "load_seconds": load_seconds, "engine": engine}


if __name__ == "__main__":
    main()
