"""Tensor-parallel GPT-2 training in the port, held against the JAX
package's engine on ``build_mesh(model=2)`` with ``comm.collective_matmul``
(backend ``"pallas"``: its ring kernels in interpret mode), and against the
port's own engine without tensor parallelism.

The port's ranks are gloo processes on the CPU (``torch_tp_workers``, no
JAX), spawned once per world size for the module, with a deadline. Each
rank builds the whole seeded model and the engine keeps its shard.

Checks: the losses of 3 steps (1e-5 relative at fp32, 5e-4 at bf16, as
the single-device engine tests: another summation order, and at bf16
other rounding points); the fp32 masters after them (5e-5 absolute, as
there: an Adam step moves an element by up to lr in either direction
when its gradient is rounding noise); the gathered master tree and
optimizer state after loading the JAX engine's, bit for bit; the next
loss from that state; TP 2 and TP 4 against TP 1 in the port (losses
1e-5 relative, masters 5e-5 absolute).
"""
import numpy as np
import pytest

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.distributed import SpawnError, spawn

import torch_tp_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MODEL4 = dict(MODEL, n_heads=4, loss_chunk=8)
STEPS = 3
LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-4}
MASTER_ATOL = 5e-5


def _ids(seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(1, 2, 32)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree)


def _ds(prec, tp, backend="pallas"):
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "steps_per_print": 10 ** 9}
    if tp:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": backend}}
    if prec == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": 2}
    return conf


@pytest.fixture(scope="module")
def jax_runs():
    """prec -> the JAX TP engine's losses, its state after STEPS steps,
    and the loss of one more step."""
    out = {}
    ids = _ids()
    for prec in ("fp32", "bf16"):
        cfg = jgpt2.GPT2Config(**MODEL, use_flash_attention=False)
        eng = JEngine(model=jgpt2.make_gpt2_model(config=cfg),
                      mesh=j_build_mesh(model=2),
                      config_params=_ds(prec, True))
        assert eng._cm_tp
        losses = [float(eng.train_batch(batch=(ids, ids)))
                  for _ in range(STEPS)]
        master = jax.tree_util.tree_map(np.asarray, eng.get_master_params())
        opt = jax.tree_util.tree_map(np.asarray, eng.state["opt"])
        out[prec] = dict(losses=losses, master=master, opt=opt,
                         next_loss=float(eng.train_batch(batch=(ids, ids))))
    return out


def _spec(prec, backend="pallas", model=MODEL, load=None):
    return dict(model=model, seed=0, prec=prec, backend=backend, micro=2,
                ids=_ids().astype(np.int64), steps=STEPS, load=load)


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """world -> per-rank results of workers.tp_engine: at world 2 fp32 and
    bf16 (each then loading the JAX engine's state) and fp32 on the plain
    ring; at world 4 fp32."""
    specs2 = [_spec(p, load=(jax_runs[p]["master"], jax_runs[p]["opt"]))
              for p in ("fp32", "bf16")] + [_spec("fp32", "ppermute")]
    return {2: spawn(workers.tp_engine, 2, args=(specs2,), timeout_s=150),
            4: spawn(workers.tp_engine, 4, args=([_spec("fp32",
                                                        model=MODEL4)],),
                     timeout_s=150)}


def _tp1(model):
    """The port's engine without tensor parallelism, fp32."""
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**model)),
        config_params=_ds("fp32", False), device="cpu")[0]
    ids = _ids().astype(np.int64)
    losses = [float(eng.train_batch(batch=(ids, ids))) for _ in range(STEPS)]
    return losses, eng.get_master_params()


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_tp2_losses_match_the_jax_engine(jax_runs, port_runs, prec):
    i = ("fp32", "bf16").index(prec)
    for rank in port_runs[2]:
        losses = rank[i]["losses"]
        np.testing.assert_allclose(losses, jax_runs[prec]["losses"],
                                   rtol=LOSS_TOL[prec])
        assert losses[-1] < losses[0]
        assert rank[i]["views"] and rank[i]["opt_step"] == STEPS


def test_tp2_masters_match_the_jax_engine(jax_runs, port_runs):
    got = dict(_leaves(port_runs[2][0][0]["master"]))
    want = dict(_leaves(jax_runs["fp32"]["master"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = float(np.abs(got[name] - w).max())
        assert err <= MASTER_ATOL, (name, err)
    # every rank gathers the same tree
    other = dict(_leaves(port_runs[2][1][0]["master"]))
    for name in got:
        assert np.array_equal(got[name], other[name]), name


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_tp2_loads_the_jax_state_bit_for_bit(jax_runs, port_runs, prec):
    i = ("fp32", "bf16").index(prec)
    want = jax_runs[prec]
    for rank in port_runs[2]:
        res = rank[i]
        got = dict(_leaves(res["reloaded"]))
        for name, w in _leaves(want["master"]):
            assert np.array_equal(got[name], w.astype(np.float32)), name
        got = dict(_leaves(res["reloaded_opt"]["exp_avg_sq"]))
        for name, w in _leaves(want["opt"]["exp_avg_sq"]):
            assert np.array_equal(got[name], w.astype(np.float32)), name
        assert int(res["reloaded_opt"]["step"]) == int(want["opt"]["step"])
        np.testing.assert_allclose(res["next_loss"], want["next_loss"],
                                   rtol=LOSS_TOL[prec])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_matches_the_single_rank_engine(port_runs, world):
    res = port_runs[world][0][0 if world == 4 else 2]
    losses, master = _tp1(MODEL4 if world == 4 else MODEL)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    got = dict(_leaves(res["master"]))
    for name, w in _leaves(master):
        err = float(np.abs(got[name] - w).max())
        assert err <= MASTER_ATOL, (name, err)


def test_plain_ring_and_kernel_backend_agree(port_runs):
    """On CPU tensors both backends run the plain products: the losses of
    the two fp32 runs are equal."""
    for rank in port_runs[2]:
        assert rank[0]["losses"] == rank[2]["losses"]


def test_shard_layout_round_trips():
    cfg = tgpt2.GPT2Config(vocab_size=64, max_seq_len=16, n_layers=1,
                           n_heads=4, d_model=16)
    full = tgpt2.make_gpt2_model(config=cfg).state_dict()
    for n in (2, 4):
        shards = [tgpt2.tp_shard_state_dict(full, r, n) for r in range(n)]
        back = tgpt2.tp_gather_state_dicts(shards)
        for name, t in full.items():
            assert back[name].equal(t), name
        qkv = shards[1]["blocks.0.attn.qkv_kernel"]
        d = cfg.d_model
        # rank 1's q, k and v columns, each d/n wide
        want = full["blocks.0.attn.qkv_kernel"].reshape(d, 3, d)[
            :, :, d // n:2 * d // n].reshape(d, -1)
        assert qkv.equal(want)
        model = tgpt2.GPT2Model(cfg, tp_size=n)
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in shards[0].items()}
    for name in full:
        jspec = jgpt2.partition_spec_fn(name, full[name].shape)
        tspec = tgpt2.partition_spec_fn(name, full[name].shape)
        assert (None if jspec is None else tuple(jspec)) == tspec, name


def test_model_axis_without_the_comm_section_raises():
    with pytest.raises(SpawnError,
                       match="NotImplementedError: a model axis of 2"):
        spawn(workers.tp_engine, 2, args=([dict(
            _spec("fp32"), backend=None)],), timeout_s=60)
