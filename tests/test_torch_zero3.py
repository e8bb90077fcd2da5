"""ZeRO stage 3 in the port: the compute-dtype parameters partitioned by
gather unit over the data group (``runtime/zero/partition.py``), each
unit gathered around its use (``runtime/zero/stage3.py``), held to stage
2 and to the JAX package's engine at stage 3.

The port's ranks are two gloo processes on the CPU
(``torch_zero3_workers.zero_engine``, one spawn for the module, one
thread a rank), each training on its rows of a global batch, on tiny
GPT-2 (2 layers, d 64, vocabulary 128, seq 32, bf16, Adam, micro 2, two
micro-steps a step, 3 steps; no clipping, so no decision reads the
norm, whose summation order the layouts change). Checks, with their
tolerances:

* stage 3 (persistence threshold 1000: the embedding, both blocks'
  kernels and ``wpe`` partitioned, the biases and layer norms kept whole)
  equals stage 2 bit for bit: the losses, the gathered masters and the
  first moments. Every stage sums in the accumulator's dtype and stage
  3's units run stage 2's operations; the tied ``wte`` (the embedding
  and the chunked loss head, which borrows the embedding unit) reaches
  the accumulator as one reduce-scatter of both contributions' sum. So
  do stage 3 with ``remat`` on and ``loss_chunk`` 16 against stage 2
  with the same, stage 3 against stage 2 with ``cpu_offload`` on both,
  and a model built inside ``zero.Init`` against one built whole;
* against the JAX engine at stage 3 on ``build_mesh(data=2)``:
  losses within 5e-4 relative, masters by how far they moved (the
  difference's norm within 0.25 of the JAX engine's move; the key third
  of each qkv bias, whose exact gradient is 0, elementwise within 1e-2),
  as ``test_torch_zero_dp.py``;
* the offload run's tag (each rank's zero file holds its pieces as
  ``offload_shards``, the JAX engine's partitioned-offload format)
  resumes on one rank: master and moments bit for bit;
* each rank keeps about half the compute-dtype parameter bytes (its
  pieces of each unit, plus the persistent leaves whole) and no gathered
  unit between steps; the master, moments and accumulator hold the
  rank's pieces;
* the persistent leaves and the live budget's demotions are the JAX
  ``ZeroShardingPlan``'s for the same tree (host logic, in process);
* at one rank (in process) stage 3 is stage 2's layout with no unit
  calls, with and without ``cpu_offload``, bit for bit.
"""
import numpy as np
import pytest

import jax

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.zero.partition import ZeroShardingPlan
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.zero.partition import (jax_path,
                                                        stage3_persistence)
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_zero3_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO, GAS, STEPS = 2, 2, 3
THRESHOLD = 1000
LOSS_RTOL = 5e-4
MOVED_RTOL = 0.25
KEY_BIAS_ATOL = 1e-2


def _ids():
    return np.random.RandomState(0).randint(
        0, 128, size=(GAS, MICRO * 2, 32)).astype(np.int64)


def _spec(name, zero, **extra):
    spec = dict(name=name, data=2, model=dict(MODEL), seed=0, micro=MICRO,
                gas=GAS, steps=STEPS, batch=(_ids(), _ids()), zero=zero)
    spec.update(extra)
    return spec


S3 = {"stage": 3, "stage3_param_persistence_threshold": THRESHOLD}
REMAT = dict(MODEL, remat=True, loss_chunk=16)
SPECS = [
    _spec("s2", {"stage": 2}),
    _spec("s3", S3),
    _spec("s2_remat", {"stage": 2}, model=REMAT),
    _spec("s3_remat", S3, model=REMAT),
    _spec("s2_offload", {"stage": 2, "cpu_offload": True}),
    _spec("s3_offload", dict(S3, cpu_offload=True)),
    _spec("s3_init", S3,
          init={"param_persistence_threshold": THRESHOLD}),
]


@pytest.fixture(scope="module")
def offload_tag(tmp_path_factory):
    return str(tmp_path_factory.mktemp("zero3_offload_tag"))


@pytest.fixture(scope="module")
def runs(offload_tag):
    specs = [dict(s, save=offload_tag) if s["name"] == "s3_offload" else s
             for s in SPECS]
    ranks = spawn(workers.zero_engine, 2, args=(specs,), timeout_s=240)
    return [{spec["name"]: res for spec, res in zip(SPECS, rank)}
            for rank in ranks]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_named(tree[key], prefix + key + "."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, child in enumerate(tree):
            out.update(_named(child, prefix + str(i) + "."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("got,want", [
    ("s3", "s2"), ("s3_remat", "s2_remat"), ("s3_offload", "s2_offload"),
    ("s3_init", "s3")])
def test_stage3_equals_stage2_bit_for_bit(runs, got, want):
    for rank in runs:
        a, b = rank[got], rank[want]
        assert a["losses"] == b["losses"]
        for key in ("master", "exp_avg"):
            x, y = _named(a[key]), _named(b[key])
            for name in y:
                np.testing.assert_array_equal(x[name], y[name],
                                              err_msg=(key, name))
        assert a["step"] == b["step"] == STEPS
    assert runs[0][got]["losses"] == runs[1][got]["losses"]


def test_tied_wte_gets_both_grad_contributions(runs):
    # wte lies in the partitioned embedding unit, which the loss head
    # borrows; both uses' gradients reached its master, as at stage 2
    for rank in runs:
        s3 = rank["s3"]
        assert "wte" not in s3["persistent"]
        assert [u for u, _ in s3["units"]][:2] == ["persistent", "embed"]
        np.testing.assert_array_equal(_named(s3["master"])["wte"],
                                      _named(rank["s2"]["master"])["wte"])


@pytest.fixture(scope="module")
def jax_stage3():
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False))
    eng = JEngine(model=model, mesh=j_build_mesh(data=2), config_params={
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "zero_optimization": S3, "steps_per_print": 10 ** 9})
    init = _named(eng.get_master_params())
    losses = [float(eng.train_batch(batch=(_ids(), _ids())))
              for _ in range(STEPS)]
    return dict(init=init, losses=losses,
                master=_named(eng.get_master_params()))


def _check_masters(got, want, init):
    """``test_torch_zero_dp.py``'s bf16 rule: each leaf's move within
    MOVED_RTOL of the reference's, by norm; the key third of a qkv bias
    elementwise within KEY_BIAS_ATOL."""
    d = MODEL["d_model"]
    for name, w in want.items():
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


def test_stage3_matches_the_jax_engine(runs, jax_stage3):
    want = jax_stage3
    for rank in runs:
        got = rank["s3"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        _check_masters(_named(got["master"]), want["master"], want["init"])


def test_each_rank_holds_half_the_parameters(runs):
    for rank in runs:
        s2, s3 = rank["s2"], rank["s3"]
        units = dict(s3["units"])
        persistent = units["persistent"]
        assert s3["part_numel"] == sum(n // 2 for _, n in s3["units"])
        # bf16 pieces of every unit + the persistent unit gathered whole
        assert s3["param_bytes"] == 2 * (s3["part_numel"] + persistent)
        assert s3["param_bytes"] < 0.55 * s2["param_bytes"]
        for key in ("master", "exp_avg", "exp_avg_sq", "acc"):
            assert s3["state_bytes"][key] == 4 * s3["part_numel"]
        # between steps no unit stays gathered; leaves view the buffers
        assert s3["views"] and s3["gathers"] > 0
        assert s3["master_device"] == "cpu"
        assert rank["s3_offload"]["offload_chunks"] == 1


@pytest.mark.parametrize("threshold,budget", [
    (THRESHOLD, None), (0, None), (10 ** 9, None), (10 ** 9, 50_000),
    (10 ** 9, 10 ** 9), (100, 5_000)])
def test_persistence_and_live_budget_match_the_jax_plan(threshold, budget):
    cfg = dict(MODEL, vocab_size=256, max_seq_len=64)
    params = jgpt2.init_params(jgpt2.GPT2Config(**cfg), seed=0)
    plan = ZeroShardingPlan(j_build_mesh(data=2), stage=3,
                            param_persistence_threshold=threshold,
                            max_live_parameters=budget)
    persistent_numel, demoted = plan.configure_live_budget(params)
    want = sorted(
        jax.tree_util.keystr(kp, simple=True, separator="/")
        for kp, leaf in jax.tree_util.tree_leaves_with_path(params)
        if not plan.param_is_data_sharded(
            jax.tree_util.keystr(kp, simple=True, separator="/"),
            np.shape(leaf)))
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**cfg))
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    keep, got_demoted, got_numel = stage3_persistence(shapes, threshold, 2,
                                                      budget)
    assert sorted(jax_path(n) for n in keep) == want
    assert tuple(got_demoted) == tuple(demoted)
    assert got_numel == persistent_numel


def test_dp2_offload_tag_resumes_on_one_rank(runs, offload_tag):
    import deepspeed_tpu_torch
    spec = next(s for s in SPECS if s["name"] == "s3_offload")
    engine = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL),
                                    seed=1),
        config_params=workers.zero_config(dict(spec, micro=2 * MICRO)),
        device="cpu")[0]
    engine.load_checkpoint(offload_tag, tag="t")
    want = runs[0]["s3_offload"]
    opt = engine.get_optimizer_state()
    assert int(opt["step"]) == want["step"] == STEPS
    for key, got in (("master", engine.get_master_params()),
                     ("exp_avg", opt["exp_avg"])):
        got, ref = _named(got), _named(want[key])
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name],
                                          err_msg=(key, name))


@pytest.mark.parametrize("offload", [False, True])
def test_stage3_at_one_rank_is_stage2(offload):
    """At one rank the JAX plan keeps every leaf whole (no data degree to
    shard over): stage 3 builds stage 2's layout, makes no unit calls
    (so nothing is gathered or recomputed) and gives stage 2's bits."""
    import deepspeed_tpu_torch
    ids = np.random.RandomState(0).randint(0, 128, size=(GAS, MICRO, 32))
    runs = {}
    for stage in (2, 3):
        zero = dict(S3, stage=stage, cpu_offload=offload)
        engine = deepspeed_tpu_torch.initialize(
            model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**REMAT),
                                        seed=0),
            config_params=workers.zero_config(dict(micro=MICRO, gas=GAS,
                                                   zero=zero)),
            device="cpu")[0]
        assert engine.zero3 is None and not engine.flat.stage3
        assert engine.flat.check_views()
        losses = [float(engine.train_batch(batch=(ids, ids)))
                  for _ in range(STEPS)]
        runs[stage] = (losses, _named(engine.get_master_params()))
    assert runs[3][0] == runs[2][0]
    for name, want in runs[2][1].items():
        np.testing.assert_array_equal(runs[3][1][name], want, err_msg=name)
