"""The port's twins of the repo's examples against the JAX examples, on
the CPU.

``deepspeed_tpu_torch/examples/cifar_train.py`` and ``gpt2_pretrain.py``
read the repo's unchanged JSON configs (``examples/cifar/ds_config.json``:
WarmupLR, fp32; ``examples/gpt2/ds_config_zero2.json``: WarmupDecayLR,
bf16, ZeRO-2, betas (0.9, 0.95), weight decay 0.1, clipping 1.0) and run
a few steps through ``main(argv)`` at a small size. The JAX package is
driven the way each example drives it (``initialize`` with the same
config; the CIFAR example's own ``make_model`` and ``SyntheticCifar``,
imported from the file; GPT-2's loop over RandomState(0) tokens), on 8
virtual CPU devices: the CIFAR global batch of 64 is the config's
``train_batch_size`` in both, and the GPT-2 config's micro batch of 8 is
the port's global batch, so the JAX side takes micro 1 x 8 devices.

Tolerances: the learning rate at every step equal; CIFAR (fp32
compute) losses 1e-5 relative; GPT-2 (bf16 compute) losses 5e-4
relative, the bound of the bf16 engine tests. ``--data_prefix``: a
corpus the test writes, read by the port's native loader and by the JAX
example's, the same batches a step; losses within the same 5e-4.
"""
import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.examples import cifar_train, gpt2_pretrain

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIFAR_CONFIG = os.path.join(ROOT, "examples", "cifar", "ds_config.json")
GPT2_CONFIG = os.path.join(ROOT, "examples", "gpt2", "ds_config_zero2.json")
WORLD = 8


def _jax_cifar_example():
    spec = importlib.util.spec_from_file_location(
        "jax_cifar_example", os.path.join(ROOT, "examples", "cifar",
                                          "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cifar_twin_trains_as_the_jax_example():
    samples = 192                        # 3 steps of the config's 64
    got = cifar_train.main(["--deepspeed_config", CIFAR_CONFIG,
                            "--device", "cpu", "--samples", str(samples),
                            "--epochs", "1"])
    example = _jax_cifar_example()
    args = argparse.Namespace(deepspeed_config=CIFAR_CONFIG)
    engine, _, loader, _ = deepspeed_tpu.initialize(
        args=args, model=example.make_model(),
        training_data=example.SyntheticCifar(n=samples),
        config_params=args.deepspeed_config)
    losses, lrs = [], []
    for x, y in loader:
        lrs.append(engine.get_lr()[0])
        loss = engine(jnp.asarray(x), jnp.asarray(y))
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    assert len(got["losses"]) == len(losses) == 3
    assert got["lrs"] == lrs
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert type(got["engine"].lr_scheduler).__name__ == "WarmupLR"
    assert got["engine"].train_micro_batch_size_per_gpu() == 64


TINY = ["--n_layers", "2", "--d_model", "64", "--n_heads", "2",
        "--vocab_size", "256", "--seq_len", "64"]


def test_gpt2_twin_trains_as_the_jax_example():
    steps = 4
    got = gpt2_pretrain.main(["--deepspeed_config", GPT2_CONFIG,
                              "--device", "cpu", "--steps", str(steps)] +
                             TINY)
    engine = got["engine"]
    assert type(engine.lr_scheduler).__name__ == "WarmupDecayLR"
    assert engine.optimizer.betas == (0.9, 0.95)
    assert engine.gradient_clipping() == 1.0
    assert engine.zero_optimization_stage() == 2
    with open(GPT2_CONFIG) as f:
        config = json.load(f)
    micro = config["train_micro_batch_size_per_gpu"]
    assert engine.train_micro_batch_size_per_gpu() == micro
    config["train_micro_batch_size_per_gpu"] = micro // WORLD
    model = jgpt2.make_gpt2_model(size="gpt2_small", max_seq_len=64,
                                  n_layers=2, d_model=64, n_heads=2,
                                  vocab_size=256)
    j_engine, _, _, _ = deepspeed_tpu.initialize(model=model,
                                                 config_params=config)
    mb = j_engine.train_micro_batch_size_per_gpu() * j_engine.dp_world_size
    gas = j_engine.gradient_accumulation_steps()
    assert mb == micro
    rs = np.random.RandomState(0)
    losses, lrs = [], []
    for _ in range(steps):
        ids = rs.randint(0, 256, size=(gas, mb, 64)).astype(np.int32)
        lrs.append(j_engine.get_lr()[0])
        losses.append(float(j_engine.train_batch(batch=(ids, ids.copy()))))
    assert got["lrs"] == lrs
    np.testing.assert_allclose(got["losses"], losses, rtol=5e-4)


def _write_corpus(prefix, vocab=256, docs=40, seed=5):
    """A seeded corpus of patterned documents (a repeated motif with
    random tokens between), written with the port's builder."""
    from deepspeed_tpu_torch.runtime.data import IndexedDatasetBuilder
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, vocab, size=24)
    builder = IndexedDatasetBuilder(prefix)
    for _ in range(docs):
        n = rng.randint(40, 200)
        doc = rng.randint(0, vocab, size=n)
        doc[: n // 2] = np.resize(motif, n // 2)
        builder.add_doc(doc.astype(np.int32))
    return builder.finalize()


def test_gpt2_twin_trains_from_a_written_corpus(tmp_path):
    """``--data_prefix``: the twin reads the corpus through the native
    loader (gas x global micro windows a step, reshaped as the JAX
    example does) and its per-step losses equal the JAX example's on the
    same files, within the bf16 bound; the batches are the loader's."""
    from deepspeed_tpu.runtime.data import IndexedDataset as JDataset
    from deepspeed_tpu.runtime.data import NativePrefetchLoader as JLoader
    steps = 4
    prefix = _write_corpus(str(tmp_path / "corpus"))
    got = gpt2_pretrain.main(["--deepspeed_config", GPT2_CONFIG,
                              "--device", "cpu", "--steps", str(steps),
                              "--data_prefix", prefix] + TINY)
    assert all(t >= 0 for t in got["load_seconds"])
    with open(GPT2_CONFIG) as f:
        config = json.load(f)
    micro = config["train_micro_batch_size_per_gpu"]
    config["train_micro_batch_size_per_gpu"] = micro // WORLD
    model = jgpt2.make_gpt2_model(size="gpt2_small", max_seq_len=64,
                                  n_layers=2, d_model=64, n_heads=2,
                                  vocab_size=256)
    j_engine, _, _, _ = deepspeed_tpu.initialize(model=model,
                                                 config_params=config)
    mb = j_engine.train_micro_batch_size_per_gpu() * j_engine.dp_world_size
    gas = j_engine.gradient_accumulation_steps()
    loader = JLoader(JDataset(prefix), batch_size=gas * mb, seq_len=64)
    losses, lrs = [], []
    for _ in range(steps):
        ids = next(loader).reshape(gas, mb, 64)
        lrs.append(j_engine.get_lr()[0])
        losses.append(float(j_engine.train_batch(batch=(ids, ids.copy()))))
    loader.close()
    assert got["lrs"] == lrs
    np.testing.assert_allclose(got["losses"], losses, rtol=5e-4)
