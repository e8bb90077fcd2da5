"""ZeRO-Offload in the port: the fp32 master and moments in host memory
and the host Adam (``runtime/zero/offload.py``), held to the JAX
package's offload engine.

* ``tests/unit/test_zero_offload.py``'s eight cases, on
  ``torch_zero3_workers.Linear`` (the JAX cases' linear regression, its
  converters in that module), at world 1 on the CPU: the state on the
  host, convergence, ``train_batch``, save and resume, the LAMB and
  non-Adam refusals, the overflow skip, and ``cpu_offload`` ignored at
  stage 0;
* ``tests/unit/test_zero_stage3_keys.py``'s cases for the keys offload
  and stage 3 make live, on its tiny GPT-2: ``sub_group_size`` cuts the
  step into more work chunks and changes no bit, a small
  ``stage3_prefetch_bucket_size`` makes more host-to-device copies and
  changes no value, ``stage3_max_reuse_distance`` and
  ``cpu_offload_use_pin_memory`` warn (raise under ``strict``), a strict
  clean config trains, ``cpu_offload_params`` needs stage 3 (and
  runs there);
* the port's offload engine against the JAX offload engine on tiny GPT-2
  (2 layers, d 64, bf16, 5 steps, stages 2 and 3; the JAX engine on
  ``build_mesh(data=2)`` with the global batch, the port on one rank
  with the same rows): losses within 5e-4 relative, and masters by how
  far they moved, the difference's norm within 0.15 of the JAX engine's
  move on each leaf and 0.05 over the whole model, and the key third of
  each qkv bias, whose exact gradient is 0, elementwise within 1e-2, as
  ``tests/test_torch_zero_dp.py`` holds bf16 runs; a control run with
  the step 10% too long must fall outside the loss and whole-model
  tolerances. The two host Adams
  differ in FMA contraction and the two engines in summation order. Both
  packages refuse ZeRO at fp32, so no fp32 offload run exists;
* tags crossing: a JAX offload tag resumes in the port's offload engine
  and a port offload tag in the JAX offload engine, the master and
  moments bit for bit; a device-state tag resumes in an offload engine
  and an offload tag in a device-state engine, the same.
"""
import logging

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.logging import logger as port_logger

import torch_zero3_workers as workers

pytestmark = pytest.mark.torch_port

LOSS_RTOL = 5e-4
# against the JAX engine on the CPU the masters' difference by how far
# they moved read at most 0.092 on a leaf and 0.026 over the whole model;
# the control, a step 10% too long, reads 0.13 and 0.091 (and a loss
# difference of 8e-3)
MOVED_RTOL = 0.15
MODEL_MOVED_RTOL = 0.05
CONTROL_LR = 1.1
KEY_BIAS_ATOL = 1e-2
LR = 1e-3


def _config(stage=2, **zero):
    return {"train_batch_size": 16,
            "optimizer": {"type": "Adam", "params": {"lr": 5e-2}},
            "bf16": {"enabled": True},
            "zero_optimization": dict({"stage": stage, "cpu_offload": True},
                                      **zero)}


def _make(stage=2):
    return deepspeed_tpu_torch.initialize(
        model=workers.Linear(), config_params=_config(stage),
        device="cpu")[0]


def _regression(seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(32, 8).astype(np.float32)
    x = rs.randn(16, 32).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(x @ w)


# ------------------------------------------- test_zero_offload.py's cases


def test_offload_state_lives_on_host():
    engine = _make()
    flat = engine.flat
    assert engine.offload is not None and flat.offload
    for t in (flat.master, flat.exp_avg, flat.exp_avg_sq):
        assert t.device.type == "cpu" and t.dtype == torch.float32
    assert isinstance(engine.get_master_params()["w"], np.ndarray)
    assert isinstance(engine.get_optimizer_state()["exp_avg"]["w"],
                      np.ndarray)
    assert engine.offload.host_bytes()["master_and_moments"] == \
        3 * 4 * flat.part_numel


def test_offload_converges_and_counts_steps():
    engine = _make()
    x, y = _regression()
    losses = []
    for _ in range(40):
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    assert losses[-1] < 0.2 * losses[0], losses
    assert engine.flat.step == 40
    assert np.abs(engine.get_optimizer_state()["exp_avg"]["w"]).sum() > 0


def test_offload_train_batch_path():
    engine = _make()
    x, y = _regression()
    l0 = float(engine.train_batch(batch=(x[None], y[None])))
    l1 = float(engine.train_batch(batch=(x[None], y[None])))
    assert np.isfinite(l0) and l1 < l0


def test_offload_checkpoint_resume(tmp_path):
    engine = _make()
    x, y = _regression()
    for _ in range(4):
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
    engine.save_checkpoint(str(tmp_path))
    engine2 = _make()
    engine2.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(engine2.get_master_params()["w"],
                                  engine.get_master_params()["w"])
    assert engine2.flat.step == 4
    assert float(engine2(x, y)) == float(engine(x, y))
    # resumed training continues
    engine2.backward(engine2(x, y))
    engine2.step()
    assert engine2.flat.step == 5


def test_offload_rejects_lamb():
    config = _config()
    config["optimizer"] = {"type": "Lamb", "params": {"lr": 1e-3}}
    with pytest.raises(ValueError, match="cpu_offload requires"):
        deepspeed_tpu_torch.initialize(model=workers.Linear(),
                                       config_params=config, device="cpu")


def test_offload_overflow_skips_host_step():
    engine = _make()
    x, y = _regression()
    engine.backward(engine(x, y))
    engine.flat.acc[0] = float("inf")
    before = engine.get_master_params()["w"].copy()
    engine.step()
    assert engine.skipped_steps == 1 and engine.flat.step == 0
    np.testing.assert_array_equal(engine.get_master_params()["w"], before)
    # the accumulator was zeroed for the next accumulation round
    assert float(engine.flat.acc.abs().sum()) == 0.0


def test_stage0_cpu_offload_flag_ignored():
    config = {"train_batch_size": 16,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "zero_optimization": {"stage": 0, "cpu_offload": True}}
    engine = deepspeed_tpu_torch.initialize(
        model=workers.Linear(), config_params=config, device="cpu")[0]
    assert engine.offload is None and not engine.flat.offload


def test_offload_rejects_non_adam_client_optimizer():
    class NotAdam:
        def hyperparams(self):
            return {}

    with pytest.raises(ValueError, match="Adam-family"):
        deepspeed_tpu_torch.initialize(
            model=workers.Linear(), optimizer=NotAdam(),
            config_params=_config(), device="cpu")


# --------------------------------------- test_zero_stage3_keys.py's cases

CFG = dict(vocab_size=256, max_seq_len=64, n_layers=2, n_heads=2,
           d_model=64, remat=False, loss_chunk=0)


def _gpt2_engine(zero_extra, stage=3):
    zero = {"stage": stage, "cpu_offload": True}
    zero.update(zero_extra)
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**CFG)),
        device="cpu", config_params={
            "train_micro_batch_size_per_gpu": 2,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "steps_per_print": 10 ** 9})[0]


def _one_step(engine):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], size=(1, 2, CFG["max_seq_len"]))
    return float(engine.train_batch(batch=(ids, ids)))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_sub_group_size_chunks_offload_pipeline():
    default = _gpt2_engine({})
    tiny = _gpt2_engine({"sub_group_size": 256})
    assert _one_step(tiny) == _one_step(default)
    assert tiny.offload_work_chunks > default.offload_work_chunks == 1
    for a, b in zip(_leaves(default.get_master_params()),
                    _leaves(tiny.get_master_params())):
        np.testing.assert_array_equal(a, b)
    # the serial order (no copy ahead of the Adam) gives the same bits
    serial = _gpt2_engine({"sub_group_size": 256})
    serial.offload.overlap = False
    _one_step(serial)
    for a, b in zip(_leaves(tiny.get_master_params()),
                    _leaves(serial.get_master_params())):
        np.testing.assert_array_equal(a, b)


def test_prefetch_bucket_size_batches_h2d():
    coalesced = _gpt2_engine({"stage3_prefetch_bucket_size": 10 ** 9})
    scattered = _gpt2_engine({"stage3_prefetch_bucket_size": 1})
    assert _one_step(coalesced) == _one_step(scattered)
    assert scattered.h2d_batches > coalesced.h2d_batches == 1
    for a, b in zip(_leaves(coalesced.get_master_params()),
                    _leaves(scattered.get_master_params())):
        np.testing.assert_array_equal(a, b)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("key,value", [
    ("stage3_max_reuse_distance", 123),
    ("cpu_offload_use_pin_memory", True)])
def test_noop_keys_warn_and_strict_raises(key, value):
    cap = _Capture()
    port_logger.addHandler(cap)
    try:
        _gpt2_engine({key: value})
    finally:
        port_logger.removeHandler(cap)
    assert any(key in m for m in cap.messages)
    with pytest.raises(ValueError, match=key):
        _gpt2_engine({key: value, "strict": True})


def test_strict_mode_clean_config_builds():
    assert np.isfinite(_one_step(_gpt2_engine({"strict": True})))


def test_params_offload_requires_stage3():
    with pytest.raises(ValueError, match="cpu_offload_params"):
        _gpt2_engine({"cpu_offload_params": True}, stage=2)
    # at stage 3 it runs (tests/test_torch_stream_offload.py)
    engine = _gpt2_engine({"cpu_offload_params": True}, stage=3)
    assert engine.stream_runner is not None and \
        engine.zero_params_offload()


# ------------------------------------------- against the JAX offload engine

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
STEPS = 5


def _ids():
    return np.random.RandomState(0).randint(0, 128, size=(1, 4, 32))


def _ds(stage, micro, offload=True):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": LR}},
            "zero_optimization": {"stage": stage, "cpu_offload": offload},
            "steps_per_print": 10 ** 9}


def _jax_engine(stage, offload=True):
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False))
    return JEngine(model=model, mesh=j_build_mesh(data=2),
                   config_params=_ds(stage, 2, offload))


def _port_engine(stage, offload=True, lr=LR):
    ds = _ds(stage, 4, offload)
    ds["optimizer"]["params"]["lr"] = lr
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL)),
        config_params=ds, device="cpu")[0]


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


@pytest.fixture(scope="module")
def jax_offload():
    out = {}
    for stage in (2, 3):
        eng = _jax_engine(stage)
        init = _named(eng.get_master_params())
        losses = [float(eng.train_batch(batch=(_ids(), _ids())))
                  for _ in range(STEPS)]
        out[stage] = dict(stage=stage, init=init, losses=losses,
                          master=_named(eng.get_master_params()))
    return out


def _against(want, lr=LR):
    """A port offload engine's 5 steps against the JAX engine's run
    ``want``: the largest loss difference (relative), each leaf's and the
    whole model's master difference by how far the JAX masters moved (the
    qkv biases' key third apart), and that key third's largest
    difference."""
    eng = _port_engine(want["stage"], lr=lr)
    assert eng.offload is not None
    losses = [float(eng.train_batch(batch=(_ids(), _ids())))
              for _ in range(STEPS)]
    got = _named(eng.get_master_params())
    d = MODEL["d_model"]
    leaf, key_bias, diff2, moved2 = {}, 0.0, 0.0, 0.0
    for name, w in want["master"].items():
        a, b, init = got[name], w, want["init"][name]
        if name.endswith("qkv_bias"):
            key = slice(d, 2 * d)
            key_bias = max(key_bias, float(np.abs(a[key] - b[key]).max()))
            keep = np.r_[0:d, 2 * d:3 * d]
            a, b, init = a[keep], b[keep], init[keep]
        diff = float(np.linalg.norm((a - b).astype(np.float64)))
        moved = float(np.linalg.norm((b - init).astype(np.float64)))
        leaf[name] = diff / moved
        diff2, moved2 = diff2 + diff ** 2, moved2 + moved ** 2
    return {"loss_rel": float(np.max(np.abs(np.subtract(
                losses, want["losses"])) / np.abs(want["losses"]))),
            "leaf_moved": leaf, "moved": (diff2 / moved2) ** 0.5,
            "key_bias": key_bias}


@pytest.mark.parametrize("stage", [2, 3])
def test_offload_matches_the_jax_offload_engine(jax_offload, stage):
    got = _against(jax_offload[stage])
    assert got["loss_rel"] <= LOSS_RTOL, got
    assert max(got["leaf_moved"].values()) <= MOVED_RTOL, got
    assert got["moved"] <= MODEL_MOVED_RTOL, got
    assert got["key_bias"] <= KEY_BIAS_ATOL, got
    # the control: a host step 10% too long falls outside the tolerances
    wrong = _against(jax_offload[stage], lr=LR * CONTROL_LR)
    assert wrong["loss_rel"] > LOSS_RTOL, wrong
    assert wrong["moved"] > MODEL_MOVED_RTOL, wrong


def _state(eng, port):
    if port:
        opt = eng.get_optimizer_state()
        return (_named(eng.get_master_params()), _named(opt["exp_avg"]),
                _named(opt["exp_avg_sq"]), int(opt["step"]))
    opt = eng._opt_state_view()
    return (_named(eng.get_master_params()), _named(opt["exp_avg"]),
            _named(opt["exp_avg_sq"]), int(np.asarray(opt["step"])))


def _assert_same_state(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert sorted(x) == sorted(y)
        for name in x:
            np.testing.assert_array_equal(x[name], y[name], err_msg=name)
    assert a[3] == b[3]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_offload_tags_cross_with_the_jax_engine(tmp_path, direction):
    if direction == "jax_to_port":
        src = _jax_engine(3)
        src.train_batch(batch=(_ids(), _ids()))
        src.save_checkpoint(str(tmp_path), tag="t")
        dst = _port_engine(3)
        dst.load_checkpoint(str(tmp_path), tag="t")
        _assert_same_state(_state(dst, True), _state(src, False))
    else:
        src = _port_engine(3)
        src.train_batch(batch=(_ids(), _ids()))
        src.save_checkpoint(str(tmp_path), tag="t")
        dst = _jax_engine(3)
        dst.load_checkpoint(str(tmp_path), tag="t")
        _assert_same_state(_state(dst, False), _state(src, True))


@pytest.mark.parametrize("src_offload", [True, False])
def test_device_and_offload_tags_cross(tmp_path, src_offload):
    src = _port_engine(3 if src_offload else 2, offload=src_offload)
    src.train_batch(batch=(_ids(), _ids()))
    src.save_checkpoint(str(tmp_path), tag="t")
    dst = _port_engine(2 if src_offload else 3, offload=not src_offload)
    dst.load_checkpoint(str(tmp_path), tag="t")
    _assert_same_state(_state(dst, True), _state(src, True))
    assert np.isfinite(float(dst.train_batch(batch=(_ids(), _ids()))))


@pytest.mark.parametrize("shape,sub_group", [
    ((), 4), ((7,), 100), ((1, 50), 3), ((10, 16), 16), ((10, 16), 40),
    ((9, 4, 3), 25), ((64, 8), 10 ** 12)])
def test_chunk_rows_is_the_jax_function(shape, sub_group):
    from deepspeed_tpu.runtime.zero.transfer import chunk_rows as jax_rows
    from deepspeed_tpu_torch.runtime.zero.transfer import chunk_rows
    assert chunk_rows(shape, sub_group) == jax_rows(shape, sub_group)


def test_stage3_refuses_sparse_embedding_grads():
    """Stage 3 with sparse embedding gradients runs now (against the JAX
    engine over a data group: tests/test_torch_zero3_tp.py); at one rank
    the lookup keeps its dense gradient and the engine trains."""
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
        **CFG, sparse_embedding_grads=True))
    engine = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config_params={
            "train_micro_batch_size_per_gpu": 2,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})[0]
    ids = np.random.RandomState(0).randint(0, CFG["vocab_size"],
                                           size=(1, 2, CFG["max_seq_len"]))
    assert np.isfinite(float(engine.train_batch(batch=(ids, ids))))
