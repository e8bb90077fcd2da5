"""Checkpoints in the port, held against the JAX package's tags and its
checkpoint tests, on the CPU.

* The port's ``utils/retry.py`` and ``utils/fault_injection.py`` are
  copies: every class and function has the original's source, and
  ``tests/unit/test_retry.py``'s cases give the same results with both.
* JAX -> port: a tag the JAX engine saved (GPT-2, 2 layers, d 64) after 2
  steps loads into the port at the same layout: the fp32 masters bit for
  bit, the moments bit for bit (bf16 ones by their 16-bit patterns), the
  optimizer step, and the next step's loss against the JAX engine that
  saved and kept going, within 1e-5 relative at fp32 and 5e-4 at bf16
  (the engine tests' bounds: another summation order, other rounding
  points at bf16). Adam and LAMB, fp32 and bf16 moments, DP 1 and DP 2,
  TP 1 and TP 2 (gloo ranks, ``torch_ckpt_workers``).
* Port -> JAX, one step only: the JAX engine casts every optimizer leaf
  to fp32 when it loads (``deepspeed_tpu/runtime/engine.py:3394-3398``),
  so past one step it no longer follows the run it resumed from. Each
  package's ``verify_tag`` accepts the other's tags; a port bf16 leaf
  unpickles in JAX as an ``ml_dtypes.bfloat16`` array.
* Port -> port: the resumed engine equals the one that saved and kept
  going, bit for bit (losses and masters; sync and async saves, ZeRO-2
  and fp32); elastic: saved at DP 2, loaded at DP 1 and at DP 1 x TP 2
  with the masters and moments bit for bit; saved at TP 2, loaded at
  DP 1.
* Without ``ml_dtypes`` (a subprocess where it cannot be imported) a JAX
  bf16 tag loads bit for bit; a pickle that needs a module the process
  lacks raises ``CheckpointEnvironmentError`` and does not fall back.
* ``tests/unit/test_checkpoint_faults.py``'s cases in the port (a GPT-2
  of 2 layers, d 64, in place of its linear model): kills at every write
  and read point, bit-rot, the newest complete tag, truncation, transient
  IO, retention, the ``latest`` pointer's edge cases, explicit tags.
* The ``checkpoint`` section parses as in the JAX package.
"""
import inspect
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime import checkpointing as jckpt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.utils import fault_injection as jfault
from deepspeed_tpu.utils import retry as jretry
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.utils import fault_injection as tfault
from deepspeed_tpu_torch.utils import retry as tretry
from deepspeed_tpu_torch.utils.distributed import spawn
from deepspeed_tpu_torch.utils.fault_injection import (SimulatedKill,
                                                       inject_faults)

import torch_ckpt_workers as workers
from torch_dp_workers import train_config

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO = 2
LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-4}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------- the copied utilities


@pytest.mark.parametrize("pair", [(jretry, tretry), (jfault, tfault)],
                         ids=["retry", "fault_injection"])
def test_copies_have_the_originals_source(pair):
    original, copy = pair
    names = [n for n, obj in vars(original).items()
             if (inspect.isfunction(obj) or inspect.isclass(obj)) and
             obj.__module__ == original.__name__]
    assert names
    for name in names:
        assert inspect.getsource(getattr(copy, name)) == \
            inspect.getsource(getattr(original, name)), name


class _Flaky:
    def __init__(self, failures, exc=OSError):
        self.failures, self.exc, self.calls = failures, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc("transient {}".format(self.calls))
        return "ok"


def _retry_case(mod, case):
    """One of tests/unit/test_retry.py's cases on ``mod``: what it
    observes, as plain values."""
    import random
    policy = mod.RetryPolicy(retries=3, backoff_seconds=0.1,
                             max_backoff_seconds=1.0, jitter=0.0)
    if case == "succeeds_after_transient_failures":
        fn, sleeps = _Flaky(2), []
        return (mod.retry_call(fn, policy=policy, sleep=sleeps.append),
                fn.calls, sleeps)
    if case == "exhausted_budget_reraises_last_error":
        fn = _Flaky(10)
        with pytest.raises(OSError) as err:
            mod.retry_call(fn, policy=policy, sleep=lambda _: None)
        return str(err.value), fn.calls
    if case == "zero_retries_tries_exactly_once":
        fn = _Flaky(1)
        with pytest.raises(OSError):
            mod.retry_call(fn, policy=mod.NO_RETRY)
        return fn.calls
    if case == "non_matching_exceptions_propagate_immediately":
        fn = _Flaky(5, exc=ValueError)
        with pytest.raises(ValueError):
            mod.retry_call(fn, policy=policy, sleep=lambda _: None)
        return fn.calls
    if case == "backoff_caps_at_max":
        return mod.backoff_delays(mod.RetryPolicy(
            retries=6, backoff_seconds=0.1, max_backoff_seconds=0.5,
            jitter=0.0))
    if case == "jitter_is_bounded_and_deterministic_with_seeded_rng":
        jittered = mod.RetryPolicy(retries=4, backoff_seconds=0.1,
                                   max_backoff_seconds=1.0, jitter=0.25)
        a = mod.backoff_delays(jittered, rng=random.Random(7))
        assert a == mod.backoff_delays(jittered, rng=random.Random(7))
        for delay, base in zip(a, [0.1, 0.2, 0.4, 0.8]):
            assert base <= delay <= base * 1.25
        return a
    if case == "on_retry_observes_each_attempt":
        seen = []
        mod.retry_call(_Flaky(2), policy=policy,
                       on_retry=lambda attempt, exc, delay:
                       seen.append(attempt), sleep=lambda _: None)
        return seen
    if case == "retryable_decorator_passes_arguments":
        calls = {"n": 0}

        @mod.retryable(policy=policy._replace(backoff_seconds=0.0))
        def flaky_add(a, b):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient")
            return a + b
        return flaky_add(2, 3), calls["n"]
    raise ValueError(case)


RETRY_CASES = ["succeeds_after_transient_failures",
               "exhausted_budget_reraises_last_error",
               "zero_retries_tries_exactly_once",
               "non_matching_exceptions_propagate_immediately",
               "backoff_caps_at_max",
               "jitter_is_bounded_and_deterministic_with_seeded_rng",
               "on_retry_observes_each_attempt",
               "retryable_decorator_passes_arguments"]
RETRY_WANT = {
    "succeeds_after_transient_failures": ("ok", 3, [0.1, 0.2]),
    "exhausted_budget_reraises_last_error": ("transient 4", 4),
    "zero_retries_tries_exactly_once": 1,
    "non_matching_exceptions_propagate_immediately": 1,
    "backoff_caps_at_max": [0.1, 0.2, 0.4, 0.5, 0.5, 0.5],
    "on_retry_observes_each_attempt": [0, 1],
    "retryable_decorator_passes_arguments": (5, 2),
}


@pytest.mark.parametrize("case", RETRY_CASES)
def test_retry_copy_matches_the_original_on_its_cases(case):
    got, want = _retry_case(tretry, case), _retry_case(jretry, case)
    assert got == want
    if case in RETRY_WANT:
        assert got == pytest.approx(RETRY_WANT[case]) \
            if case in ("succeeds_after_transient_failures",
                        "backoff_caps_at_max") else got == RETRY_WANT[case]


def test_fault_injector_copy_hooks_the_ports_checkpoint_module(tmp_path):
    """The copy's context manager installs into the port's IO layer, and
    the same plan gives the same event log as the original's."""
    logs = []
    for fault, mod in ((jfault, jckpt), (tfault, ckpt)):
        with fault.inject_faults(fail_substr="x", n_failures=1,
                                 corrupt_substr="x") as fi:
            assert mod._FAULT_INJECTOR is fi
            mod.save_state_dict(str(tmp_path / fault.__name__ / "x.pt"),
                                {"a": np.arange(8)})
        assert mod._FAULT_INJECTOR is None
        logs.append([(e, os.path.basename(p)) for e, p in fi.events])
    assert logs[0] == logs[1] == [("write_fail", "x.pt"),
                                  ("written", "x.pt"), ("flipped", "x.pt")]


# ------------------------------------------------------ tags across engines


def _ids(rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, size=(1, rows, 32)).astype(np.int64)


def _spec(data, tp, prec, stage, optimizer, moments, actions=(), seed=0):
    ids = _ids(MICRO * data)
    spec = dict(model=MODEL, seed=seed, data=data, tp=tp, prec=prec,
                stage=stage, optimizer=optimizer, micro=MICRO,
                batch=(ids, ids), actions=list(actions))
    if moments == "bf16":
        spec["moments"] = "bf16"
    return spec


def _jax_conf(spec):
    conf = train_config(spec)
    if spec["tp"] > 1:
        conf["comm"]["collective_matmul"]["backend"] = "ppermute"
    return conf


def _jax_engine(spec):
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False))
    return JEngine(model=model, mesh=j_build_mesh(
        data=spec["data"], model=spec["tp"] if spec["tp"] > 1 else None),
        config_params=_jax_conf(spec))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree)


def _bits(tree):
    """name -> array, bf16 leaves (ml_dtypes) as their int16 patterns."""
    return {k: v.view(np.int16) if v.dtype.name == "bfloat16" else v
            for k, v in _leaves(tree)}


def _port_record(engine):
    return workers.state_bits(engine)


def _assert_same_state(got, want, what=""):
    """Masters and moments bit for bit (bf16 by their patterns)."""
    for part in ("master", "exp_avg", "exp_avg_sq"):
        assert sorted(got[part]) == sorted(want[part]), part
        for name, w in want[part].items():
            g = got[part][name]
            assert g.dtype == w.dtype and np.array_equal(g, w), \
                (what, part, name)
    assert int(got["step"]) == int(want["step"]), what


# name: (data, tp, prec, ZeRO stage, optimizer, moments)
JAX_TAGS = {
    "dp1_adam_bf16m": (1, 1, "bf16", 2, "Adam", "bf16"),
    "dp1_lamb_bf16m": (1, 1, "bf16", 2, "Lamb", "bf16"),
    "dp2_adam_bf16m": (2, 1, "bf16", 2, "Adam", "bf16"),
    "tp2_fp32": (1, 2, "fp32", 0, "Adam", "fp32"),
    "tp2_lamb_fp32m": (1, 2, "bf16", 2, "Lamb", "fp32"),
}
# tags the port writes at world 2 (spawned), and one in this process
PORT_TAGS = {
    "dp2_adam_bf16m": (2, 1, "bf16", 2, "Adam", "bf16"),
    "tp2_adam_bf16m": (1, 2, "bf16", 2, "Adam", "bf16"),
}
SAVED_AFTER = 2       # steps before the save


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tags"))


@pytest.fixture(scope="module")
def jax_tags(ckpt_root):
    """name -> the JAX engine's tag dir (tag "t" after SAVED_AFTER steps),
    its state at the save (masters, moments by their bits, step) and the
    next step's loss."""
    out = {}
    for name, case in JAX_TAGS.items():
        spec = _spec(*case)
        eng = _jax_engine(spec)
        ids = spec["batch"][0]
        for _ in range(SAVED_AFTER):
            eng.train_batch(batch=(ids, ids))
        path = os.path.join(ckpt_root, "jax_" + name)
        eng.save_checkpoint(path, tag="t")
        opt = jax.tree_util.tree_map(np.asarray, eng.state["opt"])
        out[name] = dict(
            dir=path, spec=spec,
            state={"master": _bits(jax.tree_util.tree_map(
                       np.asarray, eng.get_master_params())),
                   "exp_avg": _bits(opt["exp_avg"]),
                   "exp_avg_sq": _bits(opt["exp_avg_sq"]),
                   "step": int(opt["step"])},
            next_loss=float(eng.train_batch(batch=(ids, ids))))
    return out


@pytest.fixture(scope="module")
def world2(jax_tags, ckpt_root):
    """One spawn of two gloo ranks: the JAX tags of world 2 loaded (record,
    then a step), the port's DP 2 and TP 2 tags written (2 steps, save,
    record, a step), and the DP 2 tag loaded at DP 1 x TP 2. name ->
    per-rank results."""
    loads = [n for n, c in JAX_TAGS.items() if c[0] * c[1] == 2]
    specs, names = [], []
    for name in loads:
        specs.append(_spec(*JAX_TAGS[name], seed=5, actions=[
            ("load", jax_tags[name]["dir"], "t"), ("record",),
            ("train", 1)]))
        names.append("load_jax_" + name)
    for name, case in PORT_TAGS.items():
        specs.append(_spec(*case, actions=[
            ("train", SAVED_AFTER),
            ("save", os.path.join(ckpt_root, "port_" + name), "t"),
            ("record",), ("train", 1)]))
        names.append("port_" + name)
    specs.append(_spec(*PORT_TAGS["tp2_adam_bf16m"], seed=5, actions=[
        ("load", os.path.join(ckpt_root, "port_dp2_adam_bf16m"), "t"),
        ("record",), ("train", 1)]))
    names.append("dp2_at_tp2")
    ranks = spawn(workers.ckpt_engine, 2, args=(specs,), timeout_s=240)
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


def _port_engine(case, seed=0, extra=None):
    spec = _spec(*case, seed=seed)
    conf = train_config(spec)
    conf.update(extra or {})
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL),
                                  seed=seed)
    engine = deepspeed_tpu_torch.initialize(model=model, config_params=conf,
                                            device="cpu")[0]
    return engine, spec["batch"]


@pytest.mark.parametrize("name", [n for n, c in JAX_TAGS.items()
                                  if c[0] * c[1] == 1])
def test_jax_tag_resumes_in_the_port(jax_tags, name):
    want = jax_tags[name]
    ok, why = ckpt.verify_tag(want["dir"], "t")
    assert ok, why
    engine, batch = _port_engine(JAX_TAGS[name], seed=5)
    path, client = engine.load_checkpoint(want["dir"])
    assert path.endswith("mp_rank_00_model_states.pt") and client == {}
    assert engine.global_steps == SAVED_AFTER
    _assert_same_state(_port_record(engine), want["state"], name)
    loss = float(engine.train_batch(batch=batch))
    prec = JAX_TAGS[name][2]
    assert abs(loss - want["next_loss"]) <= \
        LOSS_TOL[prec] * abs(want["next_loss"]), (loss, want["next_loss"])


@pytest.mark.parametrize("name", [n for n, c in JAX_TAGS.items()
                                  if c[0] * c[1] == 2])
def test_jax_tag_resumes_in_the_port_at_world_2(jax_tags, world2, name):
    want = jax_tags[name]
    prec = JAX_TAGS[name][2]
    for res in world2["load_jax_" + name]:
        assert res["paths"][0] is not None
        _assert_same_state(res["records"][0], want["state"], name)
        assert abs(res["losses"][0] - want["next_loss"]) <= \
            LOSS_TOL[prec] * abs(want["next_loss"])


def test_elastic_dp2_tag_at_dp1_tp2(world2):
    """Saved at DP 2, loaded at DP 1 x TP 2: masters and moments bit for
    bit, the next loss within the bf16 bound of the saving run's."""
    saved = world2["port_dp2_adam_bf16m"][0]
    for res in world2["dp2_at_tp2"]:
        _assert_same_state(res["records"][0], saved["records"][0])
        assert abs(res["losses"][0] - saved["losses"][-1]) <= \
            LOSS_TOL["bf16"] * abs(saved["losses"][-1])


@pytest.mark.parametrize("name", sorted(PORT_TAGS))
def test_world2_port_tag_resumes_at_dp1(world2, ckpt_root, name):
    """Saved at DP 2 (every rank its zero file) or TP 2 (the qkv columns
    as three boxes a rank), loaded at one rank."""
    saved = world2["port_" + name][0]
    tag_dir = os.path.join(ckpt_root, "port_" + name)
    files = sorted(os.listdir(os.path.join(tag_dir, "t")))
    assert files == ["manifest.json", "mp_rank_00_model_states.pt",
                     "zero_pp_rank_0_mp_rank_00_optim_states.pt",
                     "zero_pp_rank_1_mp_rank_00_optim_states.pt"]
    engine, _ = _port_engine((1, 1) + PORT_TAGS[name][2:], seed=5)
    engine.load_checkpoint(tag_dir, tag="t")
    _assert_same_state(_port_record(engine), saved["records"][0], name)
    ids = _ids(MICRO * PORT_TAGS[name][0])
    loss = float(engine.train_batch(batch=(ids, ids)))
    assert abs(loss - saved["losses"][-1]) <= \
        LOSS_TOL["bf16"] * abs(saved["losses"][-1])


def _jax_resume(tag_dir, spec):
    """The JAX engine on ``spec``'s layout loads ``tag_dir`` and takes one
    step: (its master tree as bits, the step's loss)."""
    ok, why = jckpt.verify_tag(tag_dir, "t")
    assert ok, why
    eng = _jax_engine(spec)
    path, _ = eng.load_checkpoint(tag_dir)
    assert path is not None
    master = _bits(jax.tree_util.tree_map(np.asarray,
                                          eng.get_master_params()))
    ids = spec["batch"][0]
    return master, float(eng.train_batch(batch=(ids, ids)))


@pytest.mark.parametrize("name", sorted(PORT_TAGS))
def test_port_world2_tag_resumes_in_jax_for_one_step(world2, ckpt_root,
                                                     name):
    saved = world2["port_" + name][0]
    master, loss = _jax_resume(os.path.join(ckpt_root, "port_" + name),
                               _spec(*PORT_TAGS[name]))
    for key, want in saved["records"][0]["master"].items():
        assert np.array_equal(master[key], want), key
    assert abs(loss - saved["losses"][-1]) <= \
        LOSS_TOL["bf16"] * abs(saved["losses"][-1])


BENCH_EXTRA = {"data_types": {"grad_accum_dtype": "bf16"}}


def test_port_tag_resumes_in_jax_for_one_step(tmp_path):
    """bench.py's first-rung settings at a tiny width (bf16, ZeRO-2, bf16
    moments and accumulator): the JAX engine reads the port's tag, its bf16
    leaves as ml_dtypes arrays, and takes the step the port took."""
    case = (1, 1, "bf16", 2, "Adam", "bf16")
    engine, batch = _port_engine(case, extra=BENCH_EXTRA)
    for _ in range(SAVED_AFTER):
        engine.train_batch(batch=batch)
    engine.save_checkpoint(str(tmp_path), tag="t")
    saved = _port_record(engine)
    want = float(engine.train_batch(batch=batch))
    with open(ckpt.model_ckpt_name(str(tmp_path), "t"), "rb") as f:
        sd = pickle.load(f)
    assert sd["module"]["wte"].dtype.name == "bfloat16"
    assert sd["optimizer"] is None and sd["master"] is None
    with open(ckpt.zero_ckpt_name(str(tmp_path), "t"), "rb") as f:
        shards = pickle.load(f)["device_shards"]
    assert shards["opt"]["exp_avg"][0][1][0][1].dtype.name == "bfloat16"
    spec = _spec(*case)
    spec_conf = dict(_jax_conf(spec), **BENCH_EXTRA)
    eng = JEngine(model=jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False)), mesh=j_build_mesh(data=1),
        config_params=spec_conf)
    assert eng.load_checkpoint(str(tmp_path))[0] is not None
    master = _bits(jax.tree_util.tree_map(np.asarray,
                                          eng.get_master_params()))
    for key, w in saved["master"].items():
        assert np.array_equal(master[key], w), key
    ids = batch[0]
    loss = float(eng.train_batch(batch=(ids, ids)))
    assert abs(loss - want) <= LOSS_TOL["bf16"] * abs(want), (loss, want)


RESUME_CASES = {
    "zero2_bf16m": ((1, 1, "bf16", 2, "Adam", "bf16"), BENCH_EXTRA, False),
    "zero2_async": ((1, 1, "bf16", 2, "Adam", "fp32"), {}, True),
    "fp32_lamb_schedule": ((1, 1, "fp32", 0, "Lamb", "fp32"), {
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
            "warmup_num_steps": 6}}}, False),
}


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_port_resume_equals_the_run_that_kept_going(tmp_path, name):
    case, extra, async_save = RESUME_CASES[name]
    engine, batch = _port_engine(case, extra=extra)
    for _ in range(SAVED_AFTER):
        engine.train_batch(batch=batch)
    engine.save_checkpoint(str(tmp_path), client_state={"epoch": 3},
                           async_save=async_save)
    kept = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    kept_state = _port_record(engine)
    engine.wait_pending_writes()
    assert ckpt.read_latest(str(tmp_path)) == "global_step2"
    other, _ = _port_engine(case, seed=5, extra=extra)
    path, client = other.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3} and other.global_steps == SAVED_AFTER
    resumed = [float(other.train_batch(batch=batch)) for _ in range(2)]
    assert resumed == kept
    _assert_same_state(_port_record(other), kept_state, name)
    assert other.get_lr() == engine.get_lr()


def test_tp2_port_tag_boxes_cover_every_leaf_once(world2, ckpt_root):
    """A TP 2 rank's qkv columns are three boxes, one each of q, k and
    v; the leaves every model rank holds whole come from model rank 0
    only; no two boxes overlap."""
    tag = os.path.join(ckpt_root, "port_tp2_adam_bf16m", "t")
    files = [ckpt.load_state_dict(os.path.join(tag, f)) for f in
             ("zero_pp_rank_0_mp_rank_00_optim_states.pt",
              "zero_pp_rank_1_mp_rank_00_optim_states.pt")]
    engine, _ = _port_engine(PORT_TAGS["tp2_adam_bf16m"])
    names = engine._jax_leaf_names()
    for i, name in enumerate(names):
        shape, boxes = files[0]["device_shards"]["master"][i]
        cover = np.zeros(shape, np.int32)
        per_rank = []
        for f in files:
            entries = f["device_shards"]["master"][i][1]
            per_rank.append(len(entries))
            for key, data in entries:
                cover[ckpt.key_to_index(key)] += 1
                assert data.shape == cover[ckpt.key_to_index(key)].shape
        assert (cover == 1).all(), name
        if name.endswith("qkv_kernel") or name.endswith("qkv_bias"):
            assert per_rank == [3, 3], (name, per_rank)
        elif tgpt2.partition_spec_fn(name, shape) is None:
            assert per_rank[1] == 0, name


# ------------------------------------------------------- without ml_dtypes

NO_ML_DTYPES = r"""
import json, sys
sys.modules["ml_dtypes"] = None
sys.path[:0] = [{repo!r}, {tests!r}]
import numpy as np, torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
import torch_ckpt_workers
conf = json.loads({conf!r})
model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(**json.loads({model!r})),
                             seed=5)
engine = deepspeed_tpu_torch.initialize(model=model, config_params=conf,
                                        device="cpu")[0]
assert engine.load_checkpoint({tag!r})[0] is not None
state = torch_ckpt_workers.state_bits(engine)
np.savez({out!r}, **{{p + "/" + k: v for p in ("master", "exp_avg",
                       "exp_avg_sq") for k, v in state[p].items()}})
try:
    engine.load_checkpoint({broken!r})
    err = None
except ckpt.CheckpointEnvironmentError as e:
    err = str(e)
print(json.dumps({{"error": err, "step": state["step"],
                  "jax": "jax" in sys.modules,
                  "ml_dtypes": sys.modules["ml_dtypes"] is None}}))
"""


def test_jax_bf16_tag_loads_without_ml_dtypes(jax_tags, tmp_path):
    """A process that cannot import ml_dtypes (the card's) reads the JAX
    engine's bf16 tag bit for bit. A newer tag whose model file needs a
    module that process lacks (an ml_dtypes float8 array in the client
    state) raises CheckpointEnvironmentError naming it: no walk back to
    the older tag, even with the newer one unverifiable (no manifest)."""
    import ml_dtypes
    want = jax_tags["dp1_adam_bf16m"]
    broken = str(tmp_path / "broken")
    engine, batch = _port_engine(JAX_TAGS["dp1_adam_bf16m"])
    engine.save_checkpoint(broken, tag="old")
    engine.train_batch(batch=batch)
    engine.save_checkpoint(broken, tag="new", client_state={
        "fp8": np.zeros(4, ml_dtypes.float8_e4m3fn)})
    os.remove(ckpt.manifest_path(broken, "new"))
    out = str(tmp_path / "state.npz")
    script = NO_ML_DTYPES.format(
        repo=REPO, tests=os.path.join(REPO, "tests"),
        conf=json.dumps(train_config(want["spec"])),
        model=json.dumps(MODEL), tag=want["dir"], out=out, broken=broken)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ml_dtypes"] and not res["jax"]
    assert res["error"] and "'ml_dtypes'" in res["error"], res
    assert res["step"] == want["state"]["step"]
    got = np.load(out)
    for part in ("master", "exp_avg", "exp_avg_sq"):
        for name, w in want["state"][part].items():
            g = got[part + "/" + name]
            assert g.dtype == w.dtype and np.array_equal(g, w), (part, name)


def test_import_failure_is_not_corruption(tmp_path):
    path = str(tmp_path / "x.pt")
    with open(path, "wb") as f:
        f.write(b"\x80\x02cno_such_mod\nx\n.")   # GLOBAL no_such_mod.x
    with pytest.raises(ckpt.CheckpointEnvironmentError, match="no_such_mod"):
        ckpt.load_state_dict(path)


# ------------------------------------------- test_checkpoint_faults cases

FAULT_LR = 1e-3


def _fault_cfg(zero=False, **ckpt_section):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "optimizer": {"type": "Adam", "params": {"lr": FAULT_LR}},
           "steps_per_print": 10 ** 9,
           # no sleeping between injected transient failures
           "checkpoint": dict({"io_retries": 3,
                               "io_retry_backoff_seconds": 0},
                              **ckpt_section)}
    if zero:
        cfg["bf16"] = {"enabled": True}
        cfg["zero_optimization"] = {"stage": 2}
    return cfg


def make_engine(config, seed=0):
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL),
                                  seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config_params=config,
                                          device="cpu")[0]


def run_steps(engine, steps, offset=0):
    for s in range(steps):
        ids = _ids(MICRO, seed=offset + s)
        engine.train_batch(batch=(ids, ids))


@pytest.mark.parametrize("mode", ["plain", "zero", "async"])
def test_kill_at_every_injection_point(tmp_path, mode):
    cfg = _fault_cfg(zero=(mode == "zero"))
    e1 = make_engine(cfg)
    run_steps(e1, 1)
    probe = str(tmp_path / "probe")
    e1.save_checkpoint(probe, tag="p")
    n_files = len(ckpt.read_manifest(probe, "p")["files"])
    assert n_files == (2 if mode == "zero" else 1)
    total_writes = n_files + 2
    e2 = make_engine(cfg, seed=9)
    for k in range(total_writes):
        d = str(tmp_path / "k{}".format(k))
        e1.save_checkpoint(d, tag="good")
        with inject_faults(kill_after_files=k):
            with pytest.raises(SimulatedKill):
                if mode == "async":
                    e1.save_checkpoint(d, tag="later", async_save=True)
                    e1.wait_pending_writes()
                else:
                    e1.save_checkpoint(d, tag="later")
        assert ckpt.read_latest(d) == "good"
        ok, why = ckpt.verify_tag(d, "good")
        assert ok, why
        path, _ = e2.load_checkpoint(d)
        assert path is not None and os.sep + "good" + os.sep in path
        assert e2.global_steps == e1.global_steps
    d = str(tmp_path / "clean")
    e1.save_checkpoint(d, tag="good")
    e1.save_checkpoint(d, tag="later")
    assert ckpt.read_latest(d) == "later"
    assert ckpt.verify_tag(d, "later")[0]


def test_bitrot_rejected_and_falls_back_to_prior_tag(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="t1")
    run_steps(e1, 1, offset=1)
    with inject_faults(corrupt_substr="model_states", corrupt_mode="flip"):
        e1.save_checkpoint(save_dir, tag="t2")
    assert ckpt.read_latest(save_dir) == "t2"
    ok, why = ckpt.verify_tag(save_dir, "t2")
    assert not ok and "checksum mismatch" in why
    e2 = make_engine(_fault_cfg(), seed=3)
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and os.sep + "t1" + os.sep in path
    assert e2.global_steps == 1


def test_fallback_scans_to_newest_complete_not_oldest(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg(zero=True))
    for i, tag in enumerate(("t1", "t2")):
        run_steps(e1, 1, offset=i)
        e1.save_checkpoint(save_dir, tag=tag)
    run_steps(e1, 1, offset=2)
    with inject_faults(corrupt_substr="optim_states",
                       corrupt_mode="truncate"):
        e1.save_checkpoint(save_dir, tag="t3")
    ok, why = ckpt.verify_tag(save_dir, "t3")
    assert not ok and "size mismatch" in why
    e2 = make_engine(_fault_cfg(zero=True), seed=3)
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and os.sep + "t2" + os.sep in path
    assert e2.global_steps == 2


def test_truncated_shard_raises_corruption_error_naming_file(tmp_path):
    path = str(tmp_path / "shard.pt")
    with open(path, "wb") as f:
        pickle.dump({"x": np.arange(100)}, f, protocol=4)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(ckpt.CheckpointCorruptionError) as err:
        ckpt.load_state_dict(path)
    assert "shard.pt" in str(err.value)
    assert "falls back" in str(err.value)


def test_transient_write_failures_are_retried(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    with inject_faults(fail_substr="model_states", n_failures=2) as fi:
        e1.save_checkpoint(save_dir, tag="t")
    assert [e for e, _ in fi.events].count("write_fail") == 2
    ok, why = ckpt.verify_tag(save_dir, "t")
    assert ok, why


def test_write_failures_beyond_retry_budget_keep_latest_intact(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    cfg = _fault_cfg(io_retries=1)
    e1 = make_engine(cfg)
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="good")
    with inject_faults(fail_substr="model_states", n_failures=5):
        with pytest.raises(OSError):
            e1.save_checkpoint(save_dir, tag="bad")
    assert ckpt.read_latest(save_dir) == "good"
    e2 = make_engine(cfg, seed=3)
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and os.sep + "good" + os.sep in path


def test_transient_read_failures_are_retried(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="t")
    e2 = make_engine(_fault_cfg(), seed=3)
    with inject_faults(fail_substr="model_states", n_failures=2,
                       fail_reads=True) as fi:
        path, _ = e2.load_checkpoint(save_dir)
    assert path is not None
    assert [e for e, _ in fi.events].count("read_fail") == 2


def test_retention_gc_keeps_last_n_and_never_eats_latest(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    cfg = _fault_cfg(keep_last_n=2)
    e1 = make_engine(cfg)
    for i in range(4):
        run_steps(e1, 1, offset=i)
        e1.save_checkpoint(save_dir)
    assert set(ckpt.list_tags(save_dir)) == {"global_step3", "global_step4"}
    assert ckpt.read_latest(save_dir) == "global_step4"
    e2 = make_engine(cfg, seed=3)
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and e2.global_steps == 4


def test_prune_protects_latest_and_anything_newer(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    for step, tag in enumerate(["a", "b", "c"], start=1):
        rec = ckpt.save_state_dict(
            ckpt.model_ckpt_name(save_dir, tag), {"step": step})
        ckpt.write_manifest(save_dir, tag, [rec], {"global_step": step})
    ckpt.save_latest(save_dir, "b")
    assert ckpt.prune_checkpoints(save_dir, keep_last_n=1) == ["a"]
    assert set(ckpt.list_tags(save_dir)) == {"b", "c"}


def test_read_latest_tolerates_empty_and_dangling_pointer(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    os.makedirs(save_dir)
    latest = os.path.join(save_dir, "latest")
    with open(latest, "w") as f:
        f.write("  \n\t")
    assert ckpt.read_latest(save_dir) is None
    with open(latest, "w") as f:
        f.write("ghost_tag")
    assert ckpt.read_latest(save_dir) is None


def test_dangling_latest_falls_back_to_complete_tag(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="real")
    with open(os.path.join(save_dir, "latest"), "w") as f:
        f.write("vanished")
    e2 = make_engine(_fault_cfg(), seed=3)
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and os.sep + "real" + os.sep in path


def test_explicit_tag_failure_does_not_substitute_another_tag(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="good")
    e2 = make_engine(_fault_cfg(), seed=3)
    path, state = e2.load_checkpoint(save_dir, tag="no_such_tag")
    assert path is None and state is None
    path, _ = e2.load_checkpoint(save_dir)
    assert path is not None and os.sep + "good" + os.sep in path


def test_wait_pending_writes_lands_queued_files(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="t", async_save=True)
    ckpt.wait_pending_writes()
    ok, why = ckpt.verify_tag(save_dir, "t")
    assert ok, why
    assert ckpt.read_latest(save_dir) == "t"


@pytest.mark.parametrize("mode", ["plain", "zero"])
def test_kill_at_every_read_point_leaves_tag_loadable(tmp_path, mode):
    cfg = _fault_cfg(zero=(mode == "zero"))
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(cfg)
    run_steps(e1, 2)
    e1.save_checkpoint(save_dir, tag="good")
    probe = make_engine(cfg, seed=7)
    with inject_faults() as fi:
        probe.load_checkpoint(save_dir)
    total_reads = fi.files_read
    assert total_reads >= 2
    for k in range(total_reads):
        victim = make_engine(cfg, seed=9)
        with inject_faults(kill_after_reads=k) as fi:
            with pytest.raises(SimulatedKill):
                victim.load_checkpoint(save_dir)
        assert ("kill_read", fi.events[-1][1]) == fi.events[-1]
        assert ckpt.read_latest(save_dir) == "good"
        ok, why = ckpt.verify_tag(save_dir, "good")
        assert ok, why
        path, _ = victim.load_checkpoint(save_dir)
        assert path is not None and os.sep + "good" + os.sep in path
        assert victim.global_steps == e1.global_steps


def test_kill_mid_restore_falls_back_to_prior_tag_when_newest_rots(
        tmp_path):
    save_dir = str(tmp_path / "ckpt")
    e1 = make_engine(_fault_cfg())
    run_steps(e1, 1)
    e1.save_checkpoint(save_dir, tag="t1")
    run_steps(e1, 1, offset=1)
    e1.save_checkpoint(save_dir, tag="t2")
    victim = make_engine(_fault_cfg(), seed=5)
    with inject_faults(kill_after_reads=1):
        with pytest.raises(SimulatedKill):
            victim.load_checkpoint(save_dir)
    for name in os.listdir(os.path.join(save_dir, "t2")):
        if "model_states" in name:
            p = os.path.join(save_dir, "t2", name)
            with open(p, "r+b") as f:
                f.seek(max(os.path.getsize(p) // 2, 0))
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
    path, _ = victim.load_checkpoint(save_dir)
    assert path is not None and os.sep + "t1" + os.sep in path
    assert victim.global_steps == 1


# ------------------------------------------------------------- the config

CKPT_SECTIONS = {
    "default": {},
    "fail": {"tag_validation": "Fail", "io_retries": 0,
             "io_retry_backoff_seconds": 0.5, "keep_last_n": 3},
    "ignore": {"tag_validation": "ignore", "keep_last_n": None},
}
CKPT_FIELDS = ("checkpoint_tag_validation_enabled",
               "checkpoint_tag_validation_fail", "checkpoint_io_retries",
               "checkpoint_io_backoff_seconds", "checkpoint_keep_last_n")


@pytest.mark.parametrize("name", sorted(CKPT_SECTIONS))
def test_checkpoint_section_parses_as_in_jax(name):
    cfg = {"train_batch_size": 8, "checkpoint": CKPT_SECTIONS[name]}
    j = jconfig.DeepSpeedConfig(None, param_dict=dict(cfg))
    t = tconfig.DeepSpeedConfig(None, param_dict=dict(cfg), world_size=8)
    for field in CKPT_FIELDS:
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("bad", [{"tag_validation": "Maybe"},
                                 {"io_retries": -1},
                                 {"io_retry_backoff_seconds": True},
                                 {"keep_last_n": 0}])
def test_bad_checkpoint_section_raises_in_both(bad):
    cfg = {"train_batch_size": 8, "checkpoint": bad}
    with pytest.raises(jconfig.DeepSpeedConfigError):
        jconfig.DeepSpeedConfig(None, param_dict=dict(cfg))
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.DeepSpeedConfig(None, param_dict=dict(cfg), world_size=8)
