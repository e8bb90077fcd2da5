"""The port's single-device training API against the JAX package's
engine, on the CPU: the ds_config ``scheduler`` section, SGD, the client
arguments of ``initialize`` (``optimizer=``, ``lr_scheduler=``,
``training_data=``, ``model_parameters=``) and the throughput timer.

The JAX engine runs on 8 virtual CPU devices, so its global batch is
micro x 8; the port runs at world size 1 with the same global batch.
Tolerances are those of ``tests/test_torch_training.py``: fp32 losses
1e-5 relative and masters 5e-5 absolute; fp16 compute losses 5e-4
relative. Learning rates, overflow flags and schedule counters are
equal (pure Python on both sides).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.adam import FusedAdam as TAdam
from deepspeed_tpu_torch.ops.sgd import SGD as TSGD
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

WORLD = 8
SHAPE = dict(vocab_size=256, max_seq_len=64, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=16)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree)


def _config(micro, **extra):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {
               "lr": 1e-3, "weight_decay": 0.01}},
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


def _both(config_for, steps, ids, seed=2):
    """(engine, lrs, losses, skipped per step) for the JAX engine and the
    port's, each from GPT-2 at ``SHAPE`` with ``seed``."""
    out = []
    for pkg, gpt2, micro, kw in ((deepspeed_tpu, jgpt2, 1, {}),
                                 (deepspeed_tpu_torch, tgpt2, WORLD,
                                  {"device": "cpu"})):
        engine = pkg.initialize(
            model=gpt2.make_gpt2_model(config=gpt2.GPT2Config(**SHAPE),
                                       seed=seed),
            config_params=config_for(micro), **kw)[0]
        lrs, losses, skipped = [], [], []
        for _ in range(steps):
            lrs.append(engine.get_lr()[0])
            losses.append(float(engine.train_batch(batch=(ids, ids))))
            skipped.append(engine.skipped_steps)
        out.append((engine, lrs, losses, skipped))
    return out


def test_scheduler_section_drives_the_engine_as_jax():
    """WarmupDecayLR from the ds_config, 5 fp32 steps: the same learning
    rate at every step, the losses and the masters."""
    sched = {"type": "WarmupDecayLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
        "warmup_num_steps": 3, "total_num_steps": 6}}
    ids = np.random.RandomState(21).randint(
        0, 256, size=(1, WORLD, 64)).astype(np.int32)
    (je, j_lrs, j_losses, _), (te, t_lrs, t_losses, _) = _both(
        lambda micro: _config(micro, scheduler=sched), 5, ids)
    assert isinstance(te.lr_scheduler, tsched.WarmupDecayLR)
    assert t_lrs == j_lrs and len(set(t_lrs)) == 4
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    got = dict(_leaves(te.get_master_params()))
    for name, want in _leaves(je.get_master_params()):
        err = float(np.abs(got[name] - want).max())
        assert err <= 5e-5, (name, err)
    assert te.lr_scheduler.last_batch_iteration == \
        je.lr_scheduler.last_batch_iteration == 4


def test_fp16_overflow_skips_the_schedule_as_jax():
    """fp16 with a loss scale of 2^20: the first steps overflow and are
    skipped (two in the port), and the schedule does not step on them,
    in both engines."""
    sched = {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
        "warmup_num_steps": 4}}
    ids = np.random.RandomState(22).randint(
        0, 256, size=(1, WORLD, 64)).astype(np.int32)
    fp16 = {"enabled": True, "initial_scale_power": 20,
            "loss_scale_window": 1000}
    (je, j_lrs, j_losses, j_skip), (te, t_lrs, t_losses, t_skip) = _both(
        lambda micro: _config(micro, scheduler=sched, fp16=fp16), 5, ids)
    assert te.compute_dtype == torch.float16
    assert t_skip == j_skip and t_skip[-1] >= 1 and t_skip[-1] < 5
    assert t_lrs == j_lrs
    assert te.lr_scheduler.last_batch_iteration == \
        je.lr_scheduler.last_batch_iteration == 4 - t_skip[-1]
    assert te.loss_scale() == float(je.loss_scale())
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-4)


def test_sgd_engine_matches_jax():
    """"type": "SGD" with momentum and weight decay, fp32, 3 steps."""
    sgd = {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9,
                                     "weight_decay": 0.01}}
    ids = np.random.RandomState(23).randint(
        0, 256, size=(1, WORLD, 64)).astype(np.int32)
    (je, _, j_losses, _), (te, _, t_losses, _) = _both(
        lambda micro: _config(micro, optimizer=sgd), 3, ids)
    assert isinstance(te.optimizer, TSGD)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    got = dict(_leaves(te.get_master_params()))
    for name, want in _leaves(je.get_master_params()):
        err = float(np.abs(got[name] - want).max())
        assert err <= 5e-5, (name, err)
    got = dict(_leaves(te.get_optimizer_state()["exp_avg"]))
    for name, want in _leaves(je.state["opt"]["exp_avg"]):
        err = float(np.abs(got[name] - want).max())
        assert err <= 5e-5, (name, err)


class TokenSet:
    """A map-style dataset of (ids, labels) rows."""

    def __init__(self, n, seed):
        self.ids = np.random.RandomState(seed).randint(
            0, 256, size=(n, 64)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.ids[i]


def test_client_optimizer_schedule_and_training_data_as_jax():
    """initialize(optimizer=handle, lr_scheduler=schedule,
    training_data=dataset) in both packages: the returned loader yields
    the JAX loader's batches in the same order over two epochs (the
    shuffle reseeds per epoch), and training on them gives the same
    learning rates and losses."""
    data = TokenSet(40, seed=24)
    engines, loaders, runs = [], [], []
    for pkg, gpt2, adam, sched_mod, micro, kw in (
            (deepspeed_tpu, jgpt2, JAdam, jsched, 1, {}),
            (deepspeed_tpu_torch, tgpt2, TAdam, tsched, WORLD,
             {"device": "cpu"})):
        opt = adam(lr=1e-3, weight_decay=0.01)
        sched = sched_mod.WarmupLR(opt, warmup_min_lr=1e-4,
                                   warmup_max_lr=1e-3, warmup_num_steps=3)
        engine, got_opt, loader, got_sched = pkg.initialize(
            model=gpt2.make_gpt2_model(config=gpt2.GPT2Config(**SHAPE),
                                       seed=3),
            optimizer=opt, lr_scheduler=sched, training_data=data,
            config_params=_config(micro), **kw)
        assert got_opt is opt and got_sched is sched
        engines.append(engine)
        loaders.append(loader)
    j_loader, t_loader = loaders
    assert isinstance(t_loader, DeepSpeedDataLoader)
    assert len(t_loader) == len(j_loader) == 5
    for epoch in range(2):
        j_batches, t_batches = list(j_loader), list(t_loader)
        assert len(t_batches) == 5
        for jb, tb in zip(j_batches, t_batches):
            for a, b in zip(jb, tb):
                assert np.array_equal(a, b), epoch
    for engine, loader in zip(engines, loaders):
        it = iter(RepeatingLoader(loader))
        lrs, losses = [], []
        for _ in range(3):
            lrs.append(engine.get_lr()[0])
            losses.append(float(engine.train_batch(data_iter=it)))
        runs.append((lrs, losses))
    assert runs[1][0] == runs[0][0]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-5)
    assert engines[1].optimizer.lr == engines[0].optimizer.lr


def test_model_parameters_and_throughput_timer():
    """model_parameters= as initial weights (the JAX tree of another
    seed, or a state_dict) or the module's own parameters; the engine
    holds a ThroughputTimer as the JAX engine does."""
    cfg = tgpt2.GPT2Config(**SHAPE)
    other = jax.tree_util.tree_map(np.asarray,
                                   jgpt2.init_params(jgpt2.GPT2Config(
                                       **SHAPE), seed=7))
    model = tgpt2.make_gpt2_model(config=cfg, seed=1)
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=other, config_params=_config(2),
        device="cpu")[0]
    for name, want in _leaves(other):
        got = dict(_leaves(engine.get_master_params()))[name]
        assert np.array_equal(got, want.astype(np.float32)), name
    state = tgpt2.make_gpt2_model(config=cfg, seed=7).state_dict()
    model = tgpt2.make_gpt2_model(config=cfg, seed=1)
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=state, config_params=_config(2),
        device="cpu")[0]
    assert torch.equal(engine.flat.tree_of(engine.flat.master)["wte"],
                       state["wte"])
    model = tgpt2.make_gpt2_model(config=cfg, seed=1)
    before = model.state_dict()["wte"].clone()
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=model.parameters(),
        config_params=_config(2), device="cpu")[0]
    assert torch.equal(engine.flat.tree_of(engine.flat.master)["wte"],
                       before)
    timer = engine.tput_timer
    assert timer.batch_size == 2 and timer.num_workers == 1
    ids = np.zeros((1, 2, 64), np.int64)
    for _ in range(4):
        timer.start()
        engine.train_batch(batch=(ids, ids))
        timer.stop()
    assert timer.avg_samples_per_sec() > 0
