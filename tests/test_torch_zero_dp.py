"""ZeRO-1/2 data parallelism in the port, held against the JAX package's
engine on ``build_mesh(data=2 | 4)`` and ``build_mesh(data=2, model=2)``
(``comm.collective_matmul``), and against the port's own engine on one
rank with the same global batch.

The port's ranks are gloo processes on the CPU (``torch_dp_workers``, no
JAX), spawned once per world size for the module, with a deadline and one
thread a rank. Each rank builds the whole seeded model and trains on its
data coordinate's rows of the global batch the JAX engine takes whole.

Checks, with their tolerances:

* GPT-2 (2 layers, d 64) at DP 2 and DP 4 (and DP 2 x TP 2, below):
  the losses of 3 steps within 1e-5 relative at fp32 (stage 0: ZeRO needs
  bf16 or fp16, in both packages) and 5e-4 at bf16 (stages 0, 1 and 2 at
  DP 2 with two micro-steps a step, against one JAX run: its stages
  compute the same thing), as ``tests/test_torch_training.py``: another
  summation order, and at bf16 other rounding points. fp32 masters within
  5e-5 absolute (an Adam step moves an element by up to lr either way
  when its gradient is rounding noise); bf16 masters by how far they
  moved, the difference's norm within 0.25 of the JAX engine's move (the
  key bias, whose exact gradient is 0, within 1e-2), as there;
* on ``tests/unit/test_zero.py``'s model and data, stages 1 and 2 match
  stage 0 at DP 2 at its tolerances (5e-3 relative, 1e-5 absolute), and
  in fact bit for bit (every stage sums in the accumulator's dtype; Adam
  is elementwise and no clipping reads the norm); stage 0's losses match
  the JAX engine's there, its masters as the bf16 masters above;
  ``test_zero_unbalanced_shapes``' model (a leaf straddling the two
  ranks' ranges) trains to finite losses that agree with the JAX
  engine's within 5e-3;
* per-rank sizes: master and both moments hold numel / dp_world elements
  from stage 1 (numel padded to dp_world x 64), the accumulator too from
  stage 2; the compute-dtype params and grads stay whole;
* LAMB at DP 2, bf16, stage 2, rank 0's part of the leaf that straddles
  the two ranges scaled x20: losses and masters against DP 1 and the JAX
  engine as above (a trust ratio from one rank's part is ~14x off);
* DP 2 x TP 2 against the JAX engine on the same mesh, fp32 stage 0 and
  bf16 stage 2, at the tolerances above;
* the JAX engine's state loaded at DP 2 and gathered back bit for bit;
* a batch of another row count than the micro batch raises ValueError;
* gloo: a bf16 all-reduce and reduce-scatter sum in bf16, and the
  all-reduce-and-slice reduce-scatter gives each rank the slice of
  ``reduce_scatter_tensor``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.model import Model
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_dp_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO = 2
STEPS = 3
LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-4}
MASTER_ATOL = 5e-5
MOVED_RTOL = 0.25
KEY_BIAS_ATOL = 1e-2
LAMB_SCALE = 20.0
HIDDEN = 16
ZERO_RTOL, ZERO_ATOL = 5e-3, 1e-5

# (name, data, tp, prec, stage, gas, optimizer, the JAX run it is held
# against: the JAX engine's stages compute the same thing, so the bf16
# DP 2 stages share one; None: held against the port on one rank only)
CASES = [
    ("dp2_fp32", 2, 1, "fp32", 0, 1, "Adam", "dp2_fp32"),
    ("dp2_bf16_s0", 2, 1, "bf16", 0, 2, "Adam", "dp2_bf16_s2"),
    ("dp2_bf16_s1", 2, 1, "bf16", 1, 2, "Adam", "dp2_bf16_s2"),
    ("dp2_bf16_s2", 2, 1, "bf16", 2, 2, "Adam", "dp2_bf16_s2"),
    ("dp2_lamb", 2, 1, "bf16", 2, 1, "Lamb", "dp2_lamb"),
    ("dp4_fp32", 4, 1, "fp32", 0, 1, "Adam", "dp4_fp32"),
    ("dp4_bf16_s2", 4, 1, "bf16", 2, 1, "Adam", None),
    ("dp2tp2_fp32", 2, 2, "fp32", 0, 1, "Adam", "dp2tp2_fp32"),
    ("dp2tp2_bf16_s2", 2, 2, "bf16", 2, 1, "Adam", "dp2tp2_bf16_s2"),
]
BY_NAME = {c[0]: c for c in CASES}


def _ids(gas, rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, size=(gas, rows, 32)).astype(np.int64)


def _ds(prec, stage, gas, optimizer="Adam", micro=MICRO, tp=False):
    conf = {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": optimizer, "params": {"lr": 1e-3}},
            "steps_per_print": 10 ** 9}
    if tp:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "ppermute"}}
    if prec == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": stage}
    return conf


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _tree(tree):
    return dict(_leaves(tree))


def _scaled_leaf_jax(params, name, count, factor):
    """The JAX tree with the first ``count`` elements of the leaf at the
    port's dotted ``name`` scaled by ``factor``."""
    flat = tgpt2.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    t = flat[name].clone()
    t.view(-1)[:count] *= factor
    flat[name] = t
    return tgpt2.params_to_jax(flat)


@pytest.fixture(scope="module")
def jax_runs():
    """case name -> the JAX engine's losses, initial and final master
    trees and optimizer state after STEPS steps, and the next loss."""
    out = {}
    for name, data, tp, prec, stage, gas, opt, ref in CASES:
        if ref != name:
            continue
        ids = _ids(gas, MICRO * data)
        model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
            **MODEL, use_flash_attention=False))
        if name == "dp2_lamb":
            model.params = _scaled_leaf_jax(model.params, *_lamb_scaled(),
                                            LAMB_SCALE)
        eng = JEngine(model=model, mesh=j_build_mesh(
            data=data, model=tp if tp > 1 else None),
            config_params=_ds(prec, stage, gas, opt, tp=tp > 1))
        init = _tree(eng.get_master_params())
        losses = [float(eng.train_batch(batch=(ids, ids)))
                  for _ in range(STEPS)]
        out[name] = dict(
            losses=losses, init=init,
            master=jax.tree_util.tree_map(np.asarray,
                                          eng.get_master_params()),
            opt=jax.tree_util.tree_map(np.asarray, eng.state["opt"]),
            next_loss=float(eng.train_batch(batch=(ids, ids))))
    return out


def _lamb_scaled():
    """The leaf straddling rank 1's range at DP 2 and how many of its
    elements lie in rank 0's range (the port's layout, no JAX)."""
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL))
    sizes = [(n, p.numel()) for n, p in model.named_parameters()]
    numel = sum(-(-n // ALIGN) * ALIGN for _, n in sizes)
    half = -(-numel // (2 * ALIGN)) * 2 * ALIGN // 2
    off = 0
    for name, n in sizes:
        if off < half < off + n:
            return name, half - off
        off += -(-n // ALIGN) * ALIGN
    raise AssertionError("no leaf straddles the two ranges")


def _spec(name, **extra):
    _, data, tp, prec, stage, gas, opt, _ = BY_NAME[name]
    ids = _ids(gas, MICRO * data)
    spec = dict(model=MODEL, seed=0, data=data, tp=tp, prec=prec,
                stage=stage, gas=gas, optimizer=opt, micro=MICRO,
                batch=(ids, ids), steps=STEPS)
    if name == "dp2_lamb":
        spec["scale_half"] = LAMB_SCALE
    spec.update(extra)
    return spec


def _simple_data(data, steps=6):
    """tests/unit/test_zero.py's batches: SimpleDataset(512, 16, seed=11),
    micro 4 a rank, each step's global batch consecutive rows."""
    rng = np.random.RandomState(11)
    x = rng.randn(512, HIDDEN).astype(np.float32)
    w_true = rng.randn(HIDDEN, HIDDEN).astype(np.float32) * 0.1
    y = (x @ w_true).astype(np.float32)
    mb = 4 * data
    idx = np.arange(steps * mb) % 512
    return x[idx].reshape(steps, mb, HIDDEN), y[idx].reshape(steps, mb,
                                                             HIDDEN)


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """world -> per-rank results of workers.dp_engine: at world 2 every
    DP 2 case (the fp32 and bf16 stage-2 ones then loading the JAX
    engine's state; the fp32 one also fed a batch of the global row
    count), stage 1 without clipping again for the bit-for-bit check,
    the simple model at stages 0/1/2 and the unbalanced one; at world 4
    the DP 4 and DP 2 x TP 2 cases."""
    specs2 = []
    for name in ("dp2_fp32", "dp2_bf16_s0", "dp2_bf16_s1", "dp2_bf16_s2",
                 "dp2_lamb"):
        extra = {}
        if name in ("dp2_fp32", "dp2_bf16_s2"):
            extra["load"] = (jax_runs[name]["master"], jax_runs[name]["opt"])
        if name == "dp2_fp32":
            extra["wrong_rows"] = True
        specs2.append(_spec(name, **extra))
    x, y = _simple_data(2)
    for stage in (0, 1, 2):
        specs2.append(dict(simple=True, hidden=HIDDEN, seed=2, data=2,
                           prec="bf16", stage=stage, micro=4, lr=1e-2,
                           steps=1, batch=None, series=(x, y)))
    ux = np.random.RandomState(0).randn(1, 8, 16).astype(np.float32)
    uy = np.random.RandomState(1).randn(1, 8, 16).astype(np.float32)
    specs2.append(dict(unbalanced=True, data=2, prec="bf16", stage=2,
                       micro=4, lr=1e-2, steps=3, batch=(ux, uy)))
    specs4 = [_spec(n) for n in ("dp4_fp32", "dp4_bf16_s2", "dp2tp2_fp32",
                                 "dp2tp2_bf16_s2")]
    return {2: spawn(workers.dp_engine, 2, args=(specs2,), timeout_s=240),
            4: spawn(workers.dp_engine, 4, args=(specs4,), timeout_s=240)}


@pytest.fixture(scope="module")
def simple_jax():
    """The JAX engine on test_zero.py's model and data at DP 2 (stage 0,
    bf16), step by step; and on test_zero_unbalanced_shapes' model."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))
    from simple_model import make_simple_model
    x, y = _simple_data(2)
    eng = JEngine(model=make_simple_model(HIDDEN, seed=2),
                  mesh=j_build_mesh(data=2), config_params=dict(
                      _ds("bf16", 0, 1, micro=4), optimizer={
                          "type": "Adam", "params": {"lr": 1e-2}}))
    losses = []
    for s in range(len(x)):
        loss = eng(x[s], y[s])
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    simple = dict(losses=losses, master=_tree(eng.get_master_params()))
    rng = np.random.RandomState(0)
    params = {"w_odd": (rng.randn(7, 5) * 0.1).astype(np.float32),
              "w_even": (rng.randn(16, 16) * 0.1).astype(np.float32)}
    ux = rng.randn(8, 16).astype(np.float32)
    uy = rng.randn(8, 16).astype(np.float32)

    def apply_fn(params, x, y):
        h = x @ params["w_even"].astype(x.dtype)
        h2 = h[:, :7] @ params["w_odd"].astype(x.dtype)
        return ((h2 - y[:, :5]) ** 2).mean()

    eng = JEngine(model=Model(apply_fn, jax.tree_util.tree_map(
        jax.numpy.asarray, params)), mesh=j_build_mesh(data=2),
        config_params=dict(_ds("bf16", 2, 1, micro=4), optimizer={
            "type": "Adam", "params": {"lr": 1e-2}}))
    ulosses = []
    for _ in range(3):
        loss = eng(ux, uy)
        eng.backward(loss)
        eng.step()
        ulosses.append(float(loss))
    return {"simple": simple, "unbalanced": dict(losses=ulosses,
                                                 batch=(ux[None], uy[None]))}


@pytest.fixture(scope="module")
def port_runs(jax_runs, simple_jax):
    """world -> per-rank results of workers.dp_engine: at world 2 every
    DP 2 case (the fp32 and bf16 stage-2 ones then loading the JAX
    engine's state; the fp32 one also fed the global batch), test_zero's
    model at stages 0/1/2 and the unbalanced model; at world 4 the DP 4
    and DP 2 x TP 2 cases. Then world 2's collectives."""
    specs2 = []
    for name in ("dp2_fp32", "dp2_bf16_s0", "dp2_bf16_s1", "dp2_bf16_s2",
                 "dp2_lamb"):
        extra = {}
        if name in ("dp2_fp32", "dp2_bf16_s2"):
            extra["load"] = (jax_runs[name]["master"], jax_runs[name]["opt"])
        if name == "dp2_fp32":
            extra["wrong_rows"] = True
        specs2.append(_spec(name, **extra))
    series = _simple_data(2)
    for stage in (0, 1, 2):
        specs2.append(dict(simple=True, hidden=HIDDEN, seed=2, data=2,
                           prec="bf16", stage=stage, micro=4, lr=1e-2,
                           series=series))
    specs2.append(dict(unbalanced=True, data=2, prec="bf16", stage=2,
                       micro=4, lr=1e-2, steps=3,
                       batch=simple_jax["unbalanced"]["batch"]))
    specs4 = [_spec(n) for n in ("dp4_fp32", "dp4_bf16_s2", "dp2tp2_fp32",
                                 "dp2tp2_bf16_s2")]
    return {2: spawn(workers.dp_engine, 2, args=(specs2,), timeout_s=240),
            4: spawn(workers.dp_engine, 4, args=(specs4,), timeout_s=240),
            "collectives": spawn(workers.collectives, 2, timeout_s=60)}


def _result(port_runs, name):
    """Per-rank results of a GPT-2 case."""
    world = 2 if name.startswith("dp2_") else 4
    order = {2: ["dp2_fp32", "dp2_bf16_s0", "dp2_bf16_s1", "dp2_bf16_s2",
                 "dp2_lamb"],
             4: ["dp4_fp32", "dp4_bf16_s2", "dp2tp2_fp32",
                 "dp2tp2_bf16_s2"]}[world]
    return [rank[order.index(name)] for rank in port_runs[world]]


def _dp1(name):
    """The port's engine on one rank with the case's global batch."""
    _, data, tp, prec, stage, gas, opt, _ = BY_NAME[name]
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL), seed=0)
    if name == "dp2_lamb":
        label, count = _lamb_scaled()
        with torch.no_grad():
            dict(model.named_parameters())[label].view(-1)[:count] *= \
                LAMB_SCALE
    eng = deepspeed_tpu_torch.initialize(
        model=model, config_params=_ds(prec, stage, gas, opt,
                                       micro=MICRO * data),
        device="cpu")[0]
    ids = _ids(gas, MICRO * data)
    losses = [float(eng.train_batch(batch=(ids, ids))) for _ in range(STEPS)]
    return losses, _tree(eng.get_master_params())


def _check_masters(got, want, init, prec):
    """fp32: every element within MASTER_ATOL; bf16: each leaf's move
    within MOVED_RTOL of the reference's, by norm (the key bias apart)."""
    assert sorted(got) == sorted(want)
    d = MODEL["d_model"]
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        if prec == "fp32":
            err = float(np.abs(got[name] - w).max())
            assert err <= MASTER_ATOL, (name, err)
            continue
        moved, want_moved = got[name] - init[name], w - init[name]
        if name.endswith("qkv_bias"):
            key = slice(d, 2 * d)
            assert np.abs(moved[..., key] - want_moved[..., key]).max() \
                <= KEY_BIAS_ATOL, name
            moved = np.delete(moved, np.s_[d:2 * d], axis=-1)
            want_moved = np.delete(want_moved, np.s_[d:2 * d], axis=-1)
        err = float(np.linalg.norm(moved - want_moved) /
                    np.linalg.norm(want_moved))
        assert err <= MOVED_RTOL, (name, err)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[7]])
def test_dp_matches_the_jax_engine(jax_runs, port_runs, name):
    """Losses (the same on every rank) and the gathered masters against
    the JAX engine on the same mesh and global batch."""
    prec = BY_NAME[name][3]
    want = jax_runs[BY_NAME[name][7]]
    ranks = _result(port_runs, name)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   rtol=LOSS_TOL[prec])
        assert res["losses"] == ranks[0]["losses"]
        assert res["losses"][-1] < res["losses"][0]
        assert res["views"] and res["opt_step"] == STEPS
    _check_masters(_tree(ranks[0]["master"]), _tree(want["master"]),
                   want["init"], prec)
    for res in ranks[1:]:           # every rank gathers the same tree
        other = _tree(res["master"])
        for key, w in _tree(ranks[0]["master"]).items():
            assert np.array_equal(other[key], w), key


@pytest.mark.parametrize("name", ["dp2_fp32", "dp2_bf16_s2", "dp4_fp32",
                                  "dp4_bf16_s2", "dp2_lamb"])
def test_dp_matches_the_single_rank_engine(jax_runs, port_runs, name):
    """DP n against the port's engine on one rank with the global batch
    (LAMB: one rank's part of the straddling leaf x20, so a trust ratio
    from a part would show in both the losses and that leaf)."""
    prec = BY_NAME[name][3]
    losses, master = _dp1(name)
    res = _result(port_runs, name)[0]
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_TOL[prec])
    _check_masters(_tree(res["master"]), master, _port_init(name), prec)


def _port_init(name):
    """The port's initial master tree of a case (scaled for LAMB)."""
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL), seed=0)
    tree = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if name == "dp2_lamb":
        label, count = _lamb_scaled()
        tree[label].view(-1)[:count] *= LAMB_SCALE
    return _tree(tgpt2.params_to_jax(tree))


def test_gpt2_stages_agree(port_runs):
    """At DP 2, bf16, two micro-steps: stage 1 equals stage 0 bit for bit
    (the same sums; Adam is elementwise); stage 2 sums the micro-steps'
    reduced gradients in another order, within the bf16 loss bound."""
    s0, s1, s2 = (_result(port_runs, "dp2_bf16_s" + str(i))[0]
                  for i in range(3))
    assert s1["losses"] == s0["losses"]
    got, want = _tree(s1["master"]), _tree(s0["master"])
    for key, w in want.items():
        assert np.array_equal(got[key], w), key
    np.testing.assert_allclose(s2["losses"], s0["losses"],
                               rtol=LOSS_TOL["bf16"])


def test_lamb_scales_one_ranks_part_of_a_leaf(port_runs):
    label, count = _lamb_scaled()
    for res in _result(port_runs, "dp2_lamb"):
        assert res["scaled"] == label and count > 0
        assert res["lo"] == (0 if res["dp_rank"] == 0 else res["part_numel"])


def test_zero_stage_matches_dp(port_runs, simple_jax):
    """tests/unit/test_zero.py::test_zero_stage_matches_dp in the port at
    DP 2: stages 1 and 2 against stage 0 at its tolerances, and in fact
    bit for bit (every stage sums in the accumulator's dtype, and Adam is
    elementwise); stage 0's losses against the JAX engine's at its
    tolerances."""
    ranks = port_runs[2]
    s0, s1, s2 = (ranks[0][i] for i in (5, 6, 7))
    want = simple_jax["simple"]
    np.testing.assert_allclose(s0["losses"], want["losses"],
                               rtol=ZERO_RTOL, atol=ZERO_ATOL)
    # the masters against the JAX engine's: 6 Adam steps at lr 1e-2 move
    # an element whose gradient is rounding noise by up to 6e-2 either
    # way, so each leaf by how far it moved, as the GPT-2 bf16 cases
    rng = np.random.RandomState(2)
    for i in range(2):
        init = (rng.randn(HIDDEN, HIDDEN) * 0.1).astype(np.float32)
        for leaf, start in (("w", init), ("b", np.zeros(HIDDEN, np.float32))):
            got = s0["master"]["layer_{}_{}".format(i, leaf)] - start
            moved = want["master"]["layer_{}.{}".format(i, leaf)] - start
            err = np.linalg.norm(got - moved) / np.linalg.norm(moved)
            assert err <= MOVED_RTOL, (i, leaf, err)
    for res in (s1, s2):
        np.testing.assert_allclose(res["losses"], s0["losses"],
                                   rtol=ZERO_RTOL, atol=ZERO_ATOL)
        for name, w in s0["params"].items():
            np.testing.assert_allclose(res["params"][name], w,
                                       rtol=ZERO_RTOL, atol=ZERO_ATOL)
    for res in (s1, s2):
        assert res["losses"] == s0["losses"]
        for name, w in s0["master"].items():
            assert np.array_equal(res["master"][name], w), name
    for rank in ranks:
        assert rank[5]["losses"] == s0["losses"]


def test_zero_unbalanced_shapes(port_runs, simple_jax):
    """test_zero_unbalanced_shapes in the port: w_even straddles the two
    ranks' ranges at stage 2; finite losses that agree with the JAX
    engine's."""
    res = port_runs[2][0][8]
    assert np.all(np.isfinite(res["losses"]))
    np.testing.assert_allclose(res["losses"],
                               simple_jax["unbalanced"]["losses"],
                               rtol=ZERO_RTOL)
    assert res["part_numel"] * 2 == res["numel"] and \
        res["lo"] < 64 + 256 and res["hi"] > 64


@pytest.mark.parametrize("name", ["dp2_bf16_s0", "dp2_bf16_s1",
                                  "dp2_bf16_s2", "dp4_bf16_s2",
                                  "dp2tp2_bf16_s2"])
def test_per_rank_state_sizes(port_runs, name):
    """Master and moments over the owned range from stage 1, the
    accumulator too from stage 2; params and grads whole."""
    _, data, tp, _, stage, _, _, _ = BY_NAME[name]
    for res in _result(port_runs, name):
        numel = res["numel"]
        assert numel % (64 * data) == 0
        part = numel // data if stage >= 1 else numel
        assert res["part_numel"] == part
        assert res["hi"] - res["lo"] == part
        assert res["state_bytes"]["master"] == 4 * part
        assert res["state_bytes"]["exp_avg"] == 4 * part
        assert res["state_bytes"]["exp_avg_sq"] == 4 * part
        assert res["state_bytes"]["acc"] == 4 * (part if stage >= 2
                                                 else numel)
        assert res["params_numel"] == res["grads_numel"] == numel
    if stage >= 1:
        los = sorted(r["lo"] for r in _result(port_runs, name))
        # model ranks of one data coordinate own the same range
        assert los == sorted(part * (i // tp) for i in range(data * tp))


@pytest.mark.parametrize("name", ["dp2_fp32", "dp2_bf16_s2"])
def test_dp2_loads_the_jax_state_bit_for_bit(jax_runs, port_runs, name):
    prec = BY_NAME[name][3]
    want = jax_runs[name]
    for res in _result(port_runs, name):
        got = _tree(res["reloaded"])
        for key, w in _leaves(want["master"]):
            assert np.array_equal(got[key], w), key
        for part in ("exp_avg", "exp_avg_sq"):
            got = _tree(res["reloaded_opt"][part])
            for key, w in _leaves(want["opt"][part]):
                assert np.array_equal(got[key], w), (part, key)
        assert int(res["reloaded_opt"]["step"]) == int(want["opt"]["step"])
        np.testing.assert_allclose(res["next_loss"], want["next_loss"],
                                   rtol=LOSS_TOL[prec])


def test_a_batch_of_another_row_count_raises(port_runs):
    for res in _result(port_runs, "dp2_fp32"):
        msg = res["wrong_rows"]
        assert "2 rows" in msg and "got a batch of 4 rows" in msg, msg


def test_gloo_collectives_reduce_in_the_buffers_dtype(port_runs):
    ranks = port_runs["collectives"]
    for key in ("torch.bfloat16", "torch.float32"):
        xs = [r[key]["x"] for r in ranks]
        total = (xs[0] + xs[1]) if key == "torch.float32" else \
            torch.tensor(xs[0] + xs[1]).bfloat16().float().numpy()
        for rank, r in enumerate(ranks):
            assert r[key]["all_reduce_dtype"] == key
            assert r[key]["reduce_scatter_dtype"] == key
            np.testing.assert_array_equal(r[key]["all_reduce"], total)
            np.testing.assert_array_equal(r[key]["reduce_scatter"],
                                          r[key]["reduce_scatter_tensor"])
            np.testing.assert_array_equal(
                r[key]["reduce_scatter"], total[8 * rank:8 * rank + 8])
    for r in ranks:
        np.testing.assert_array_equal(
            r["all_gather_into"], np.concatenate(
                [np.arange(4.0) + 10 * i for i in range(2)]))
