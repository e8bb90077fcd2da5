"""Streamed parameter offload (``zero_optimization.cpu_offload_params``)
in the port, held to ``tests/unit/test_stream_offload.py``'s cases and to
the JAX package's streamed engine on the same model and rows: GPT-2 with
4 layers, d 64, vocabulary 256, seq 64, micro 2, bf16, Adam lr 1e-3,
stage 3 with ``cpu_offload``, one rank on the CPU.

* fp32: the StreamSpec's segments composed equal the model's loss bit for
  bit, and the JAX package's ``lm_loss`` within 1e-5 relative;
* the streamed loss equals a plain segment-by-segment recompute from the
  host masters cast to bf16, group for group, bit for bit;
* streamed tracks the classic stage 3 + offload engine within a relative
  2e-4 over 3 steps and in eval (the JAX bounds), and the JAX streamed
  engine within 5e-4 (the two packages' bf16 roundings); the transfer
  snapshot is read-only and an eval leaks nothing into the next step's
  phase clocks or upload counters;
* ``stage3_max_live_parameters`` sizes the groups, the group list equal
  to the JAX runner's (1e9: one group; 120,000: more);
* ``gradient_accumulation_steps`` 2 through ``train_batch``, a save, and
  a resumed engine equal to the one that kept going, bit for bit; the
  streamed tag loads into the classic-offload engine and into the JAX
  streamed engine (the masters bit for bit), and the JAX streamed
  engine's tag and a classic-offload tag load into the streamed engine
  (the same);
* the grad norm prices the tied ``wte`` once: within 1e-3 of the classic
  engine's; the tied ``wte``'s accumulated gradient holds both the
  embedding's and the head's contributions (the classic engine's
  gradient within bf16 rounding, 2e-2 of its largest element);
* the JAX engine's refusals, with their messages.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.zero import stream as tstream

import torch_zero3_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=256, max_seq_len=64, n_layers=4, n_heads=2,
             d_model=64, use_flash_attention=False, remat=False,
             loss_chunk=0)
LIVE = {"stage3_max_live_parameters": 120_000}
TRACK_RTOL, JAX_RTOL = 2e-4, 5e-4


def _conf(zero_extra=None, gas=1):
    zero = {"stage": 3, "cpu_offload": True}
    zero.update(zero_extra or {})
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "steps_per_print": 10 ** 9}


def _engine(zero_extra=None, gas=1, **model):
    cfg = tgpt2.GPT2Config(**dict(MODEL, **model))
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=cfg),
        config_params=_conf(zero_extra, gas), device="cpu")[0]


def _stream(extra=None, gas=1):
    return _engine(dict({"cpu_offload_params": True}, **(extra or {})), gas)


def _jax_stream(extra=None, gas=1):
    return jds.initialize(
        model=jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(**MODEL)),
        config_params=_conf(dict({"cpu_offload_params": True},
                                 **(extra or {})), gas))[0]


def _ids(n_rows=2):
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, size=(n_rows, 64)).astype(np.int64)


def _step(engine, ids):
    loss = engine(ids, ids.copy())
    engine.backward(loss)
    engine.step()
    return float(loss)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


def _assert_same_master(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ exact segmentation


def test_fp32_segmented_forward_bitmatches_monolithic():
    cfg = tgpt2.GPT2Config(**MODEL)
    model = tgpt2.make_gpt2_model(config=cfg)
    spec = model.stream_spec
    ids = torch.from_numpy(_ids(4))
    with torch.no_grad():
        mono = float(model(ids, ids))
        e, blocks, h = spec.split(dict(model.named_parameters()))
        x = spec.embed_apply(e, (ids, ids), None, True)
        for bt in blocks:
            x = spec.block_apply(bt, x, None, True)
        seg = float(spec.head_apply(h, x, (ids, ids), None, True))
    assert seg == mono
    jcfg = jgpt2.GPT2Config(**MODEL)
    jids = jnp.asarray(ids.numpy().astype(np.int32))
    want = float(jgpt2.lm_loss(jgpt2.init_params(jcfg, seed=0), jids, jids,
                               jcfg, rng=None, train=True))
    assert abs(seg - want) / abs(want) <= 1e-5, (seg, want)


def test_streamed_step_matches_segment_reference_bitwise():
    engine = _stream(LIVE)
    runner = engine.stream_runner
    assert len(runner.groups) > 1
    spec = engine.module.stream_spec
    flat = engine.flat
    ref = {name: t.to(torch.bfloat16) for name, t in
           flat.tree_of(flat.master).items()}
    ids = _ids()
    loss = _step(engine, ids)
    t = torch.from_numpy(ids)
    with torch.no_grad():
        e, blocks, h = spec.split(ref)
        x = spec.embed_apply(e, (t, t), None, True)
        for start, stop in runner.groups:
            for bt in blocks[start:stop]:
                x = spec.block_apply(bt, x, None, True)
        want = float(spec.head_apply(h, x, (t, t), None, True))
    assert loss == want


# --------------------------------------------- streamed vs classic offload


@pytest.fixture(scope="module")
def tracked():
    classic, streamed, jax_streamed = _engine(), _stream(), _jax_stream()
    ids = _ids()
    out = {"classic": [], "streamed": [], "jax": []}
    for _ in range(3):
        out["classic"].append(_step(classic, ids))
        out["streamed"].append(_step(streamed, ids))
        out["jax"].append(_step(jax_streamed, ids))
    out["norms"] = (classic.get_global_grad_norm(),
                    streamed.get_global_grad_norm())
    runner = streamed.stream_runner
    out["snapshots"] = (runner.transfer_snapshot(),
                        runner.transfer_snapshot())
    before = (dict(streamed.offload_phase_times), dict(runner.phase_times),
              runner._step_upload_batches, runner._step_upload_elems)
    classic.eval()
    streamed.eval()
    jax_streamed.eval()
    out["eval"] = (float(classic(ids, ids.copy())),
                   float(streamed(ids, ids.copy())),
                   float(jax_streamed(ids, ids.copy())))
    out["after_eval"] = (before, (
        dict(streamed.offload_phase_times), dict(runner.phase_times),
        runner._step_upload_batches, runner._step_upload_elems))
    return out


def test_streamed_tracks_classic_offload(tracked):
    for ls, lc in zip(tracked["streamed"], tracked["classic"]):
        assert np.isfinite(ls)
        assert abs(ls - lc) / abs(lc) < TRACK_RTOL, (ls, lc)
    ec, es, _ = tracked["eval"]
    assert abs(es - ec) / abs(ec) < TRACK_RTOL
    first, second = tracked["snapshots"]
    assert first == second and first["groups"] == 1
    assert first["upload_batches"] > 0 and first["upload_bytes"] > 0
    before, after = tracked["after_eval"]
    assert after == before


def test_streamed_tracks_the_jax_streamed_engine(tracked):
    for ls, lj in zip(tracked["streamed"], tracked["jax"]):
        assert abs(ls - lj) / abs(lj) < JAX_RTOL, (ls, lj)
    _, es, ej = tracked["eval"]
    assert abs(es - ej) / abs(ej) < JAX_RTOL


def test_grad_norm_prices_tied_leaves_once(tracked):
    gn_c, gn_s = tracked["norms"]
    assert abs(gn_s - gn_c) / gn_c < 1e-3, (gn_s, gn_c)


# ------------------------------------------------------- budget / groups


@pytest.mark.parametrize("budget", [10 ** 9, 120_000])
def test_live_budget_sizes_groups_as_the_jax_runner(budget):
    extra = {"stage3_max_live_parameters": budget}
    port = _stream(extra)
    want = _jax_stream(extra).stream_runner.groups
    assert port.stream_runner.groups == want
    assert (len(want) == 1) == (budget == 10 ** 9)
    assert np.isfinite(float(port(_ids(), _ids())))


def test_plan_groups_copy_matches_the_jax_runner_on_gpt2_xl():
    """The XL plan ``chip_smoke.py`` asserts: 16 groups of 3 blocks."""
    cfg = jgpt2.config_for("gpt2_xl")
    d, v, s = cfg.d_model, cfg.vocab_size, cfg.max_seq_len
    block = 12 * d * d + 13 * d
    groups = tstream.plan_groups([block] * cfg.n_layers,
                                 max(v * d + s * d, 2 * d + v * d), 3e8)
    assert groups == [(3 * i, 3 * i + 3) for i in range(16)]


# ----------------------------------------------------- accumulation, ckpt


@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_tags")
    ids = np.stack([_ids(), _ids()])        # (gas, batch, seq)
    a = _stream(gas=2)
    l1 = float(a.train_batch(batch=(ids, ids.copy())))
    a.save_checkpoint(str(d), tag="t1")
    l2 = float(a.train_batch(batch=(ids, ids.copy())))
    b = _stream(gas=2)
    path, _ = b.load_checkpoint(str(d), tag="t1")
    l2b = float(b.train_batch(batch=(ids, ids.copy())))
    return dict(dir=str(d), l1=l1, l2=l2, l2b=l2b, path=path,
                a_master=a.get_master_params(),
                b_master=b.get_master_params(), ids=ids)


def test_gas2_train_batch_and_checkpoint_resume(tags):
    assert np.isfinite(tags["l1"]) and tags["path"] is not None
    assert tags["l2"] == tags["l2b"]
    _assert_same_master(tags["a_master"], tags["b_master"])


def test_streamed_tag_loads_into_classic_offload_and_jax(tags):
    saved = _stream(gas=2)
    saved.load_checkpoint(tags["dir"], tag="t1")
    want = saved.get_master_params()
    classic = _engine(gas=2)
    classic.load_checkpoint(tags["dir"], tag="t1")
    _assert_same_master(classic.get_master_params(), want)
    ids = tags["ids"]
    lc = float(classic.train_batch(batch=(ids, ids.copy())))
    assert abs(lc - tags["l2"]) / abs(tags["l2"]) < TRACK_RTOL
    j = _jax_stream(gas=2)
    path, _ = j.load_checkpoint(tags["dir"], tag="t1")
    assert path is not None
    _assert_same_master(j.get_master_params(), want)
    lj = float(j.train_batch(batch=(ids.astype(np.int32),
                                    ids.astype(np.int32))))
    assert abs(lj - tags["l2"]) / abs(tags["l2"]) < JAX_RTOL


def test_jax_and_classic_tags_load_into_the_streamed_engine(tmp_path):
    ids = _ids()
    j = _jax_stream()
    _step(j, ids.astype(np.int32))
    j.save_checkpoint(str(tmp_path / "jax"), tag="j")
    s = _stream()
    s.load_checkpoint(str(tmp_path / "jax"), tag="j")
    _assert_same_master(s.get_master_params(), j.get_master_params())
    assert s.flat.step == 1
    c = _engine()
    _step(c, ids)
    c.save_checkpoint(str(tmp_path / "classic"), tag="c")
    s = _stream()
    s.load_checkpoint(str(tmp_path / "classic"), tag="c")
    _assert_same_master(s.get_master_params(), c.get_master_params())
    # the host bf16 parameters are the loaded masters, rounded
    flat = s.flat
    assert torch.equal(flat.params, flat.master.to(torch.bfloat16))
    ls, lc = _step(s, ids), _step(c, ids)
    assert abs(ls - lc) / abs(lc) < TRACK_RTOL, (ls, lc)


def test_tied_wte_gets_both_grad_contributions():
    streamed, classic = _stream(), _engine()
    runner = streamed.stream_runner
    assert runner.shared == {"wte"}
    names = [n for tree in (runner.embed.trees + runner.head.trees)
             for n in tree.values()]
    assert names.count("wte") == 2
    ids = _ids()
    streamed.backward(streamed(ids, ids.copy()))
    classic.backward(classic(ids, ids.copy()))
    i = streamed.flat.names.index("wte")
    off, shape = streamed.flat.offsets[i], streamed.flat.shapes[i]
    n = shape[0] * shape[1]
    got = streamed.flat.acc[off:off + n]
    want = classic.flat.acc[off:off + n]
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    streamed.step()


# ---------------------------------------------------------------- refusals


def test_the_jax_refusals(monkeypatch):
    with pytest.raises(ValueError, match="is a ZeRO-3 feature"):
        _engine({"stage": 2, "cpu_offload_params": True})
    conf = _conf({"cpu_offload_params": True})
    conf["zero_optimization"]["stage"] = 0
    with pytest.raises(ValueError, match="requires ZeRO"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL)),
            config_params=conf, device="cpu")
    conf = _conf({"cpu_offload_params": True})
    conf["comm"] = {"quantized_collectives": {"enabled": True}}
    # the config refuses it at stage 3 first, as the JAX config does
    with pytest.raises(ValueError, match="quantized_collectives"):
        deepspeed_tpu_torch.initialize(
            model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**MODEL)),
            config_params=conf, device="cpu")
    with pytest.raises(ValueError, match="does not expose one"):
        deepspeed_tpu_torch.initialize(
            model=workers.Linear(), device="cpu",
            config_params=_conf({"cpu_offload_params": True}))
    sparse = tgpt2.GPT2Config(**MODEL, sparse_embedding_grads=True)
    assert tgpt2.make_gpt2_model(config=sparse).stream_spec is None
    with pytest.raises(ValueError, match="does not compose"):
        tgpt2.stream_spec_for(sparse)
    monkeypatch.setattr(tstream, "_processes", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        _stream()


def test_without_cpu_offload_the_state_is_host_resident(caplog):
    with caplog.at_level(logging.INFO):
        engine = _engine({"cpu_offload": False, "cpu_offload_params": True})
    flat = engine.flat
    for t in (flat.master, flat.exp_avg, flat.exp_avg_sq, flat.params,
              flat.acc):
        assert t.device.type == "cpu"
    assert engine.zero_params_offload() and engine.zero_cpu_offload()
    assert engine.flat.param_bytes() == 0
    assert all(p.numel() == 0 for p in engine.module.parameters())
