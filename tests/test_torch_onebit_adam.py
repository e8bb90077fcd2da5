"""OneBitAdam and ``comm.quantized_collectives`` through the port's engine
(``deepspeed_tpu_torch.initialize``), held against the JAX engine on
``build_mesh(data=2 | 4)``, and ``tests/unit/test_onebit_adam.py``'s
behaviour tests on the port.

The port's ranks are gloo processes on the CPU (``torch_comm_workers``),
one spawn for each world size with a deadline; each rank trains on its
data coordinate's rows of the global batch the JAX engine takes whole.
GPT-2 with 2 layers, d 64, dropout 0, fp32 at ZeRO stage 0 (the
tutorial's optimizer block: OneBitAdam, betas (0.9, 0.999), weight decay
0.01, ``freeze_step`` 2). Checks, with their tolerances:

* warmup: the losses within 1e-5 relative of the JAX engine's (the
  engine tests' fp32 bound: another summation order);
* frozen (3 steps): the 1-bit exchange re-signs lanes near 0 in one
  package and not the other, so the masters are compared by how far they
  moved: ``||port - jax|| / ||jax - init||`` within ``MOVED_RTOL``; a
  control run (the error rows zeroed before each frozen step, through the
  engine's optimizer state) must exceed it. Lanes whose frozen variance
  is below ``V_FLOOR`` (0.12% of them: the key bias, whose exact gradient
  is 0, and other lanes with rounding-noise gradients) are left out: in
  the frozen regime each moves by ``lr * scale / (sqrt(v) + eps)`` in the
  direction of a sign decided by noise, in both packages alike;
* ``quantized_collectives`` with Adam (flat, DP 2): the losses within
  1e-5 relative (fp32, stage 0); at bf16 stages 1 and 2 equal stage 0 bit
  for bit; ``hierarchical: 2`` at DP 4 with OneBitAdam at stage 2 trains
  through the transition with finite losses;
* checkpoints: a port tag saved mid-frozen resumes in the port bit for
  bit (the quadratic of the JAX tests, stage 2, bf16); a JAX tag loads in
  the port and a port tag in the JAX engine with the state bit for bit
  and the next loss within 1e-5; a JAX DP 4 tag loads at DP 2 as the JAX
  package's ``reshard_state`` folds it, bit for bit, and the port's DP 2
  re-save (no step) restores the four worker rows exactly at DP 4;
* the JAX tests' warmup == exact Adam (2e-5 relative), convergence on the
  quadratic, the overflow reset and the loud rejections, on the port.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.fp16.onebit_adam import OnebitAdam as JOnebitAdam
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_comm_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO = 2
FREEZE = 2
FROZEN_STEPS = 3
LOSS_RTOL = {"fp32": 1e-5, "bf16": 5e-4}
MOVED_RTOL = 0.25
V_FLOOR = 1e-16
OB_PARAMS = {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.01,
             "freeze_step": FREEZE}
QUAD_LR = 1e-2


def _series(steps, data, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, 128, size=(steps, MICRO * data, 32)).astype(np.int64)
    return ids, ids.copy()


def _conf(opt_type="OneBitAdam", params=None, prec="fp32", stage=0,
          comm=None, micro=MICRO):
    conf = {"train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": opt_type,
                          "params": dict(params if params is not None
                                         else OB_PARAMS)},
            "steps_per_print": 10 ** 9}
    if prec == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": stage}
    if comm is not None:
        conf["comm"] = {"quantized_collectives": comm}
    return conf


def _jax_engine(conf, data):
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False))
    return JEngine(model=model, mesh=j_build_mesh(data=data),
                   config_params=conf)


def _jtree(tree):
    return workers._flat_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jstep(eng, series, i):
    return float(eng.train_batch(batch=(series[0][i:i + 1],
                                        series[1][i:i + 1])))


def _jopt(eng):
    return jax.tree_util.tree_map(np.asarray, eng.state["opt"])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("onebit_ckpt"))


@pytest.fixture(scope="module")
def jax_runs(ckpt_dir):
    """The JAX engine's runs before the port's: OneBitAdam at DP 2 (its
    losses, its masters at the start and end, its state, a tag saved
    after the first frozen step), and OneBitAdam at DP 4 saving a tag,
    with what ``reshard_state`` makes of it at DP 2."""
    out = {}
    steps = FREEZE + FROZEN_STEPS
    series = _series(steps, 2)
    eng = _jax_engine(_conf(), 2)
    init = _jtree(eng.get_master_params())
    losses = []
    for i in range(steps):
        losses.append(_jstep(eng, series, i))
        if i == FREEZE:
            eng.save_checkpoint(ckpt_dir, tag="jax_ob")
            saved = {"opt": _jopt(eng),
                     "master": _jtree(eng.get_master_params()),
                     "master_tree": jax.tree_util.tree_map(
                         np.asarray, eng.get_master_params())}
    out["onebit"] = dict(losses=losses, init=init, saved=saved,
                         master=_jtree(eng.get_master_params()),
                         opt=_jopt(eng), engine=eng)
    # a DP 4 engine's tag of a seeded mid-run OneBitAdam state (no step
    # needs compiling: the tag is what is tested)
    eng4 = _jax_engine(_conf(params=dict(OB_PARAMS, freeze_step=0)), 4)
    rng = np.random.RandomState(5)
    numel = eng4.optimizer._layout.numel
    opt = dict(eng4.state["opt"])
    for key in ("exp_avg", "worker_error", "server_error"):
        a = rng.randn(*np.shape(opt[key]["_flat"])).astype(np.float32)
        # pad lanes hold zero value and zero error
        if key == "worker_error":
            a[:, numel:] = 0.0
        else:
            a.reshape(-1)[numel:] = 0.0
        opt[key] = {"_flat": jnp.asarray(a)}
    opt["exp_avg_sq"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.abs(rng.randn(*np.shape(a))).astype(
            np.float32)), opt["exp_avg_sq"])
    opt["step"] = jnp.asarray(3, jnp.int32)
    eng4.state["opt"] = opt
    eng4.save_checkpoint(ckpt_dir, tag="jax_dp4")
    out["dp4"] = _jopt(eng4)
    # what the JAX engine's load at DP 2 makes of it: reshard_state
    jopt = JOnebitAdam(mesh=j_build_mesh(data=2), **OB_PARAMS)
    jopt.init_state(jax.tree_util.tree_map(np.asarray, eng4.state["master"]
                                           if eng4.state.get("master")
                                           is not None
                                           else eng4.state["params"]))
    out["dp4_at_dp2"] = jopt.reshard_state(out["dp4"], 4)
    out["dp4_pristine"] = jopt._reshard_pristine
    return out


def _ob_spec(actions, **extra):
    spec = dict(model=MODEL, seed=0, data=2, config=_conf(),
                series=_series(FREEZE + FROZEN_STEPS, 2), actions=actions)
    spec.update(extra)
    return spec


def _quad_series(steps, out_dim=4, n=32):
    rs = np.random.RandomState(0)
    w_true = rs.randn(16, out_dim).astype(np.float32)
    x = rs.randn(n, 16).astype(np.float32)
    y = x @ w_true
    return (np.repeat(x[None], steps, 0), np.repeat(y[None], steps, 0))


def _quad_spec(opt, steps, actions=None, stage=None, comm=None, data=2,
               out_dim=4):
    conf = {"train_micro_batch_size_per_gpu": 32 // data,
            "optimizer": opt, "steps_per_print": 10 ** 9,
            "bf16": {"enabled": True}}
    if stage is not None:
        conf["zero_optimization"] = {"stage": stage}
    if comm is not None:
        conf["comm"] = {"quantized_collectives": comm}
    return dict(quadratic=True, out_dim=out_dim, data=data, config=conf,
                series=_quad_series(steps, out_dim),
                actions=actions or [("train", steps), ("record", "end")])


def _ob(freeze, **params):
    return {"type": "OneBitAdam",
            "params": dict({"lr": QUAD_LR, "freeze_step": freeze}, **params)}


def _port2_specs(jax_runs, ckpt_dir):
    """Every DP 2 run of the port."""
    d = ckpt_dir
    specs = {
        # first: the DP 4 spawn waits for the tag this one writes
        "dp4_at_dp2": _ob_spec([("load", d, "jax_dp4"), ("record", "loaded"),
                                ("save", d, "port_dp2_from4")],
                               config=_conf(params=dict(OB_PARAMS,
                                                        freeze_step=0))),
        "onebit": _ob_spec([("train", FREEZE), ("record", "warm"),
                            ("train", 1), ("save", d, "port_ob"),
                            ("record", "saved"), ("train", FROZEN_STEPS - 1),
                            ("record", "end")]),
        "control": _ob_spec([("train", FREEZE), ("zero_errors",),
                             ("train", FROZEN_STEPS), ("record", "end")]),
        "from_jax": _ob_spec([("load", d, "jax_ob"), ("record", "loaded"),
                              ("train", FROZEN_STEPS - 1),
                              ("record", "end")]),
        "from_jax_state": _ob_spec([
            ("load_jax", jax_runs["onebit"]["saved"]["master_tree"],
             jax_runs["onebit"]["saved"]["opt"], FREEZE + 1),
            ("record", "loaded"), ("train", FROZEN_STEPS - 1),
            ("record", "end")]),
        "qc_fp32": dict(model=MODEL, seed=0, data=2, series=_series(3, 2),
                        config=_conf("Adam", {"lr": 1e-3},
                                     comm={"enabled": True}),
                        actions=[("train", 3)]),
        **{"qc_bf16_s{}".format(stage): dict(
            model=MODEL, seed=0, data=2, series=_series(3, 2),
            config=_conf("Adam", {"lr": 1e-3}, "bf16", stage,
                         comm={"enabled": True}),
            actions=[("train", 3), ("record", "end")])
           for stage in (0, 1, 2)},
        # tests/unit/test_onebit_adam.py's cases, on the quadratic
        "warm_ob": _quad_spec(_ob(10 ** 6), 8),
        "warm_adam": _quad_spec({"type": "Adam", "params": {
            "lr": QUAD_LR, "adam_w_mode": False}}, 8),
        "conv_ob": _quad_spec(_ob(10), 60),
        "conv_adam": _quad_spec({"type": "Adam", "params": {
            "lr": QUAD_LR, "adam_w_mode": False}}, 60),
        "cont": _quad_spec(_ob(4), 8, stage=2, actions=[
            ("train", 8), ("record", "end")]),
        "saver": _quad_spec(_ob(4), 6, stage=2, actions=[
            ("train", 6), ("save", d, "mid_frozen"), ("record", "saved")]),
        "resumed": _quad_spec(_ob(4), 8, stage=2, actions=[
            ("load", d, "mid_frozen"), ("record", "loaded"), ("train", 2),
            ("record", "end")]),
        "overflow": _quad_spec(_ob(2), 6, actions=[
            ("train", 5), ("record", "before"), ("overflow",),
            ("record", "after")]),
        "qc_adam": _quad_spec({"type": "Adam", "params": {"lr": QUAD_LR}},
                              10, stage=2, out_dim=512,
                              comm={"enabled": True, "block_size": 256}),
        "base_adam": _quad_spec({"type": "Adam", "params": {"lr": QUAD_LR}},
                                10, stage=2, out_dim=512),
        "wd_stage0": _quad_spec(_ob(2, weight_decay=0.01), 4),
        "reject_tp_onebit": dict(
            model=MODEL, data=1, tp=2, expect_error=True,
            config={"train_micro_batch_size_per_gpu": 4, "optimizer": _ob(2),
                    "comm": {"collective_matmul": {"enabled": True}}}),
        "reject_tp_qc": dict(
            model=MODEL, data=1, tp=2, expect_error=True,
            config={"train_micro_batch_size_per_gpu": 4,
                    "comm": {"collective_matmul": {"enabled": True},
                             "quantized_collectives": {"enabled": True}}}),
        "reject_hier": dict(
            quadratic=True, data=2, expect_error=True,
            config={"train_micro_batch_size_per_gpu": 4,
                    "comm": {"quantized_collectives": {
                        "enabled": True, "hierarchical": 3}}}),
    }
    # steps of the same series after "saved" start at index FREEZE + 1
    for name in ("from_jax", "from_jax_state"):
        specs[name]["series"] = tuple(s[FREEZE + 1:]
                                      for s in specs[name]["series"])
    return specs


def _port4_specs(ckpt_dir):
    """The DP 4 runs: OneBitAdam with the hierarchical int8 warmup at stage
    2; then the port's DP 2 re-save of the JAX DP 4 tag, once the DP 2
    spawn has written it, loaded at DP 4."""
    return {
        "hier": _quad_spec(_ob(2), 5, stage=2, data=4, out_dim=512,
                           comm={"enabled": True, "block_size": 16,
                                 "hierarchical": 2},
                           actions=[("train", 5), ("record", "end")]),
        "dp2_at_dp4": dict(model=MODEL, seed=0, data=4,
                           config=_conf(params=dict(OB_PARAMS,
                                                    freeze_step=0)),
                           series=_series(1, 4),
                           actions=[("wait_for", ckpt_dir,
                                     "port_dp2_from4", 240),
                                    ("load", ckpt_dir, "port_dp2_from4"),
                                    ("record", "loaded")]),
    }


@pytest.fixture(scope="module")
def ports(jax_runs, ckpt_dir):
    """The port's DP 2 and DP 4 runs, one spawn each, side by side (the DP
    4 spawn waits for the DP 2 spawn's tag where it needs it), while the
    JAX run of the int8 exchange with Adam compiles."""
    specs = {2: _port2_specs(jax_runs, ckpt_dir), 4: _port4_specs(ckpt_dir)}
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(spawn, workers.engines, w,
                                  args=(list(specs[w].values()),),
                                  timeout_s=300) for w in (2, 4)}
        qc = _jax_engine(_conf("Adam", {"lr": 1e-3},
                               comm={"enabled": True}), 2)
        series = _series(3, 2)
        jax_runs["qc_fp32"] = [_jstep(qc, series, i) for i in range(3)]
        ranks = {w: f.result() for w, f in futures.items()}
    return {w: {n: [r[i] for r in ranks[w]]
                for i, n in enumerate(specs[w])} for w in (2, 4)}


@pytest.fixture(scope="module")
def port2(ports):
    return ports[2]


@pytest.fixture(scope="module")
def port4(ports):
    return ports[4]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _moved_rel(got, want, init, v=None):
    """``||got - want|| / ||want - init||`` over the lanes whose variance
    ``v`` (a tree like the masters) is at least ``V_FLOOR``."""
    num = den = 0.0
    for k in want:
        keep = v[k] >= V_FLOOR if v is not None else slice(None)
        num += float(np.sum(((got[k] - want[k]) ** 2)[keep]))
        den += float(np.sum(((want[k] - init[k]) ** 2)[keep]))
    return np.sqrt(num / den)


def _assert_opt_equal(port_opt, jax_opt, rows=True):
    np.testing.assert_array_equal(
        np.asarray(port_opt["exp_avg"]["_flat"]),
        np.asarray(jax_opt["exp_avg"]["_flat"]))
    for key in ("worker_error", "server_error") if rows else ():
        np.testing.assert_array_equal(
            np.asarray(port_opt[key]["_flat"]),
            np.asarray(jax_opt[key]["_flat"]), err_msg=key)
    pt, jt = workers._flat_tree(port_opt["exp_avg_sq"]), \
        workers._flat_tree(jax_opt["exp_avg_sq"])
    assert set(pt) == set(jt)
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    assert int(port_opt["step"]) == int(jax_opt["step"])


# ---------------------------------------------------- against the JAX engine
def test_onebit_warmup_losses_match_jax(jax_runs, port2):
    want = jax_runs["onebit"]["losses"]
    for rank in port2["onebit"]:
        got = rank["losses"]
        for a, b in zip(got[:FREEZE + 1], want[:FREEZE + 1]):
            assert _rel(a, b) <= LOSS_RTOL["fp32"], (got, want)
        assert rank["mode"] == "stacked"
    assert port2["onebit"][0]["records"]["warm"]["frozen"]
    assert not port2["onebit"][0]["records"]["warm"]["pristine"]


def test_onebit_frozen_masters_match_jax_and_control_breaks(jax_runs,
                                                            port2):
    ref = jax_runs["onebit"]
    v = workers._flat_tree(ref["opt"]["exp_avg_sq"])
    got = port2["onebit"][0]["records"]["end"]["master"]
    moved = _moved_rel(got, ref["master"], ref["init"], v)
    ctrl = _moved_rel(port2["control"][0]["records"]["end"]["master"],
                      ref["master"], ref["init"], v)
    assert moved <= MOVED_RTOL, (moved, ctrl)
    assert ctrl > MOVED_RTOL, (moved, ctrl)
    # the error state is live after the frozen steps, the momentum the
    # same on both ranks
    opt = port2["onebit"][0]["records"]["end"]["opt"]
    assert np.abs(opt["worker_error"]["_flat"]).sum() > 0
    assert np.abs(opt["server_error"]["_flat"]).sum() > 0
    assert opt["worker_error"]["_flat"].shape[0] == 2
    np.testing.assert_array_equal(
        opt["exp_avg"]["_flat"],
        port2["onebit"][1]["records"]["end"]["opt"]["exp_avg"]["_flat"])


def test_quantized_collectives_adam_matches_jax(jax_runs, port2):
    # (port2 makes the JAX run)
    want = jax_runs["qc_fp32"]
    for rank in port2["qc_fp32"]:
        assert rank["mode"] == "exchange"
        for a, b in zip(rank["losses"], want):
            assert _rel(a, b) <= LOSS_RTOL["fp32"], (rank["losses"], want)


@pytest.mark.parametrize("stage", [1, 2])
def test_quantized_collectives_stages_agree_bit_for_bit(port2, stage):
    """Each rank folds its owned part of the same int8 average: stages 1
    and 2 (bf16) give stage 0's losses and masters bit for bit."""
    for r0, rs in zip(port2["qc_bf16_s0"], port2["qc_bf16_s{}".format(
            stage)]):
        assert rs["mode"] == "exchange"
        assert rs["losses"] == r0["losses"]
        for k, v in r0["records"]["end"]["master"].items():
            np.testing.assert_array_equal(rs["records"]["end"]["master"][k],
                                          v, err_msg=k)


# ---------------------------------------------------------------- tags
@pytest.mark.parametrize("how", ["from_jax", "from_jax_state"])
def test_jax_onebit_state_resumes_in_the_port(jax_runs, port2, how):
    """A JAX engine's mid-frozen OneBitAdam state, from its tag or handed
    over as numpy trees (``load_state_from_jax``), resumes in the port:
    the state bit for bit, then the JAX engine's next steps."""
    ref = jax_runs["onebit"]
    for rank in port2[how]:
        loaded = rank["records"]["loaded"]
        _assert_opt_equal(loaded["opt"], ref["saved"]["opt"])
        for k, v in ref["saved"]["master"].items():
            np.testing.assert_array_equal(loaded["master"][k], v)
        assert loaded["frozen"] and loaded["global_steps"] == FREEZE + 1
        for a, b in zip(rank["losses"], ref["losses"][FREEZE + 1:]):
            assert _rel(a, b) <= LOSS_RTOL["fp32"]
        moved = _moved_rel(rank["records"]["end"]["master"],
                           ref["master"], ref["saved"]["master"],
                           workers._flat_tree(ref["opt"]["exp_avg_sq"]))
        assert moved <= MOVED_RTOL, moved


def test_port_onebit_tag_resumes_in_jax(jax_runs, port2, ckpt_dir):
    saved = port2["onebit"][0]["records"]["saved"]
    # the JAX run's engine, its programs compiled, takes the port's state
    eng = jax_runs["onebit"]["engine"]
    eng.load_checkpoint(ckpt_dir, tag="port_ob")
    _assert_opt_equal(saved["opt"], _jopt(eng))
    master = _jtree(eng.get_master_params())
    for k, v in saved["master"].items():
        np.testing.assert_array_equal(master[k], v)
    series = _series(FREEZE + FROZEN_STEPS, 2)
    loss = _jstep(eng, series, FREEZE + 1)
    assert _rel(loss, port2["onebit"][0]["losses"][FREEZE + 1]) <= \
        LOSS_RTOL["fp32"]


def test_transition_and_checkpoint_bit_exact(port2):
    """tests/unit/test_onebit_adam.py's case on the port: a save inside
    the compressed regime restores the error feedback bit for bit and the
    resumed run equals the one that kept going."""
    for r in range(2):
        saved = port2["saver"][r]["records"]["saved"]
        loaded = port2["resumed"][r]["records"]["loaded"]
        for key in ("worker_error", "server_error", "exp_avg"):
            np.testing.assert_array_equal(saved["opt"][key]["_flat"],
                                          loaded["opt"][key]["_flat"],
                                          err_msg=key)
        assert loaded["frozen"]
        cont = port2["cont"][r]["records"]["end"]
        end = port2["resumed"][r]["records"]["end"]
        np.testing.assert_array_equal(cont["master"]["w"],
                                      end["master"]["w"])
        np.testing.assert_array_equal(cont["module"]["w"],
                                      end["module"]["w"])
        np.testing.assert_array_equal(
            cont["opt"]["worker_error"]["_flat"],
            end["opt"]["worker_error"]["_flat"])
        assert port2["cont"][r]["losses"][6:] == port2["resumed"][r]["losses"]


def test_dp4_tag_reshards_to_dp2_and_back(jax_runs, port2, port4):
    """A JAX DP 4 tag loads at DP 2 as the JAX engine's ``reshard_state``
    folds it (bit for bit); the DP 2 re-save carries the
    ``onebit_pristine`` sidecar, and DP 4 restores the four worker rows
    exactly."""
    for rank in port2["dp4_at_dp2"]:
        loaded = rank["records"]["loaded"]
        _assert_opt_equal(loaded["opt"], jax_runs["dp4_at_dp2"])
        pristine = loaded["pristine"]["payload"]
        assert pristine["world"] == 4
        np.testing.assert_array_equal(pristine["rows"],
                                      jax_runs["dp4_pristine"]["rows"])
    want = jax_runs["dp4"]
    for rank in port4["dp2_at_dp4"]:
        got = rank["records"]["loaded"]["opt"]
        np.testing.assert_array_equal(got["worker_error"]["_flat"],
                                      want["worker_error"]["_flat"])
        np.testing.assert_array_equal(got["server_error"]["_flat"],
                                      want["server_error"]["_flat"])
        np.testing.assert_array_equal(got["exp_avg"]["_flat"],
                                      want["exp_avg"]["_flat"])


# --------------------------------- tests/unit/test_onebit_adam.py, ported
def test_warmup_matches_exact_adam(port2):
    lo, la = port2["warm_ob"][0]["losses"], port2["warm_adam"][0]["losses"]
    np.testing.assert_allclose(lo, la, rtol=2e-5)


def test_convergence_vs_uncompressed_adam_on_quadratic(port2):
    lo, la = port2["conv_ob"][0]["losses"], port2["conv_adam"][0]["losses"]
    assert min(lo[-10:]) < 0.7 * lo[0], lo
    assert min(lo[-10:]) < 4.0 * la[-1] + 1.0, (min(lo[-10:]), la[-1])
    werr = port2["conv_ob"][0]["records"]["end"]["opt"]["worker_error"]
    assert werr["_flat"].shape[0] == 2
    assert np.abs(werr["_flat"]).sum() > 0.0


def test_overflow_resets_error_state(port2):
    for rank in port2["overflow"]:
        before, after = rank["records"]["before"], rank["records"]["after"]
        assert np.abs(before["opt"]["worker_error"]["_flat"]).sum() > 0
        assert rank["overflow_skipped"] == 1
        np.testing.assert_array_equal(after["module"]["w"],
                                      before["module"]["w"])
        np.testing.assert_array_equal(after["opt"]["exp_avg"]["_flat"],
                                      before["opt"]["exp_avg"]["_flat"])
        assert not after["opt"]["worker_error"]["_flat"].any()
        assert not after["opt"]["server_error"]["_flat"].any()
        assert after["global_steps"] == before["global_steps"] + 1


def test_engine_hierarchical_qc_composes(port4):
    for rank in port4["hier"]:
        assert rank["mode"] == "stacked"
        assert all(np.isfinite(rank["losses"])), rank["losses"]
        assert rank["records"]["end"]["frozen"]
        assert np.abs(rank["records"]["end"]["opt"]["worker_error"][
            "_flat"]).sum() > 0


def test_qc_exchange_mode_with_plain_adam(port2):
    lq, lb = port2["qc_adam"][0]["losses"], port2["base_adam"][0]["losses"]
    assert port2["qc_adam"][0]["mode"] == "exchange"
    assert abs(lq[-1] - lb[-1]) / max(abs(lb[-1]), 1e-9) < 0.01, \
        (lq[-1], lb[-1])


def test_weight_decay_at_stage_0_accepted(port2):
    assert all(np.isfinite(port2["wd_stage0"][0]["losses"]))


REJECTIONS = {
    "cuda_aware": (_ob(2, cuda_aware=True), None, None, {}, "cuda_aware"),
    "zero3": (_ob(2), 3, None, {}, "not compatible with ZeRO"),
    "clipping": (_ob(2), None, None, {"gradient_clipping": 1.0},
                 "gradient_clipping"),
    "weight_decay_s1": (_ob(2, weight_decay=0.01), 1, None, {},
                        "weight_decay"),
    "qgz": (_ob(2), 2, None, {"zero_quantized_gradients": True},
            "qgZ|quantized_gradients"),
    "qc_cuda_aware": ({"type": "Adam", "params": {"lr": QUAD_LR}}, None,
                      {"enabled": True, "cuda_aware": True}, {},
                      "cuda_aware"),
    "qc_zero3": ({"type": "Adam", "params": {"lr": QUAD_LR}}, 3,
                 {"enabled": True}, {}, "ZeRO stage 3|zero_quantized"),
    "qc_hierarchical_1": ({"type": "Adam", "params": {"lr": QUAD_LR}}, None,
                          {"enabled": True, "hierarchical": 1}, {},
                          "hierarchical"),
    "qc_dtype": ({"type": "Adam", "params": {"lr": QUAD_LR}}, None,
                 {"enabled": True, "dtype": "int4"}, {}, "dtype"),
    "qc_unknown_strict": ({"type": "Adam", "params": {"lr": QUAD_LR}}, None,
                          {"enabled": True, "bogus_key": 1, "strict": True},
                          {}, "NO effect"),
    "qc_strict_dp1": ({"type": "Adam", "params": {"lr": QUAD_LR}}, None,
                      {"enabled": True, "strict": True}, {}, "NO effect"),
    "cpu_offload": (_ob(2), 2, None, {"cpu_offload": True}, "cpu_offload"),
}


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_loud_rejections(name):
    opt, stage, comm, extra, match = REJECTIONS[name]
    conf = {"train_micro_batch_size_per_gpu": 32, "optimizer": opt,
            "bf16": {"enabled": True}}
    zero = {k: v for k, v in extra.items() if k != "gradient_clipping"}
    if stage is not None or zero:
        conf["zero_optimization"] = dict({"stage": stage or 0}, **zero)
    if "gradient_clipping" in extra:
        conf["gradient_clipping"] = extra["gradient_clipping"]
    if comm is not None:
        conf["comm"] = {"quantized_collectives": comm}
    with pytest.raises(ValueError, match=match):
        deepspeed_tpu_torch.initialize(model=workers.Quadratic(),
                                       config_params=conf, device="cpu")


@pytest.mark.parametrize("name,match", [
    ("reject_tp_onebit", "OneBitAdam is not a certified combination with "
                         "the 'model' mesh axis"),
    ("reject_tp_qc", "comm.quantized_collectives is not a certified "
                     "combination with the 'model' mesh axis"),
    ("reject_hier", "hierarchical=3 must divide the data-parallel degree 2")])
def test_mesh_rejections(port2, name, match):
    for rank in port2[name]:
        assert rank["error"] is not None and match in rank["error"], rank


def test_reference_keys_warn_as_in_jax():
    """``max_coeff`` / ``min_coeff`` warn and are ignored;
    ``comm_backend_name`` warns unless it names the data group's own
    backend (one rank: no group, so any name warns)."""
    import logging
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("DeepSpeedTPUTorch")
    logger.addHandler(handler)
    try:
        opt = OnebitAdam(lr=1e-3, max_coeff=0.3, min_coeff=0.01,
                         comm_backend_name="nccl")
        assert any("max_coeff/min_coeff" in m for m in seen), seen
        opt.configure_comm(None)
        assert any("comm_backend_name='nccl' reinterpreted" in m
                   for m in seen), seen
        assert opt.world_size == 1 and opt.frozen_at(opt.freeze_step)
        assert not opt.frozen_at(opt.freeze_step - 1)
    finally:
        logger.removeHandler(handler)
