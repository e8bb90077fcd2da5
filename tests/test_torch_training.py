"""The port's training slice against the JAX package, on the CPU.

* copies: the port's config constants, the duplicate-key hook, the loss
  scaler and the gradient utilities equal the JAX package's originals;
* config: every ds_config dict of tests/unit/test_config.py that this
  slice accepts resolves to the same fields in both packages (world size
  8, the JAX test mesh), the BERT path's (LAMB, ``progressive_layer_drop``)
  too; bad configs raise alike; sections not ported yet raise
  ``NotImplementedError``; the ``sparse_attention`` section parses to the
  same dict for every mode and the engine hands it back;
* model: GPT-2's training loss and every gradient against the JAX
  ``lm_loss`` at bench.py's CPU shape (vocab 512, seq 128, 2 layers, 4
  heads, d_model 128), fp32, dense and chunked loss, flash "xla" and
  "pallas" (the port's plain kernel versions against JAX's Pallas
  interpreter), remat on and off; with ``sparse_attention`` set, on a
  shared and a per-head layout (the JAX package's packed-heads and
  per-head kernels), at the same tolerances;
* engine: 5 ``train_batch`` steps from the same init through
  ``deepspeed_tpu.initialize`` (8 virtual CPU devices, so its global batch
  is micro x 8) and ``deepspeed_tpu_torch.initialize`` at world size 1
  with the same global batch, fp32 and bf16, ZeRO stages 0/1/2,
  gradient accumulation 1 and 2: the loss trajectories and the final
  fp32 master weights; and a 3-step fp32 trajectory with the
  ``sparse_attention`` section on;
* rules: ``initialize`` needs CUDA unless asked for the CPU, a world size
  above 1 needs a process group of its size (the batch triple follows the
  mesh's data axis), ZeRO-3 raises ``NotImplementedError`` and client
  arguments the engine cannot take raise, the
  parameters and gradients stay views of the flat buffers, and the tied
  embedding's gradient sums both uses.

Tolerances: model loss 1e-5 relative and gradients 2e-5 of each
tensor's largest magnitude (fp32 sums in another order). Engine, fp32:
losses 1e-5 relative, masters 5e-5 absolute (Adam divides by
sqrt(v) + eps, so an element with a tiny gradient turns a last-bit
difference into up to ~1e-5 of movement). Engine, bf16: losses 5e-4
relative (the two frameworks round bf16 GEMM outputs and elementwise
chains at different points); for the masters, each leaf's movement from
the shared init, ||moved_port - moved_jax|| <= 0.25 ||moved_jax|| (L2
over the leaf; an element whose bf16 gradient is near zero can take an
Adam step of up to lr in either direction, so a per-element bound cannot
hold). The key third of each QKV bias has an exact gradient of zero and
moves by rounding noise alone: it is held to 1e-2 absolute (2 x 5 steps
x lr).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import config_utils as jconfig_utils
from deepspeed_tpu.runtime import constants as jconstants
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu.runtime.zero import constants as jzero_constants
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import config_utils as tconfig_utils
from deepspeed_tpu_torch.runtime import constants as tconstants
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls
from deepspeed_tpu_torch.runtime.zero import constants as tzero_constants
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime.zero.partition import FlatPartition

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

WORLD = 8


# ------------------------------------------------------------------ copies


@pytest.mark.parametrize("pair", [(jconstants, tconstants),
                                  (jzero_constants, tzero_constants)],
                         ids=["runtime", "zero"])
def test_constant_copies_equal_their_originals(pair):
    original, copy = pair
    names = [n for n in dir(original) if n.isupper()]
    assert names
    for name in names:
        assert getattr(copy, name) == getattr(original, name), name


def test_duplicate_key_hook_copy_behaves_alike(tmp_path):
    path = tmp_path / "dup.json"
    path.write_text('{"a": 1, "b": {"c": 2, "c": 3}}')
    import json
    for hook in (jconfig_utils.dict_raise_error_on_duplicate_keys,
                 tconfig_utils.dict_raise_error_on_duplicate_keys):
        with pytest.raises(ValueError, match="Duplicate keys"):
            json.loads(path.read_text(), object_pairs_hook=hook)
    ok = '{"a": 1, "b": {"c": 2}}'
    assert json.loads(ok, object_pairs_hook=(
        tconfig_utils.dict_raise_error_on_duplicate_keys)) == json.loads(
        ok, object_pairs_hook=jconfig_utils.dict_raise_error_on_duplicate_keys)


@pytest.mark.parametrize("kwargs", [
    dict(static_loss_scale=128.0),
    dict(static_loss_scale=None, init_scale=2 ** 8, scale_window=3,
         delayed_shift=1),
    dict(static_loss_scale=None, init_scale=2 ** 10, scale_window=2,
         delayed_shift=2, min_scale=4.0)])
def test_loss_scaler_copy_follows_the_same_schedule(kwargs):
    j, t = jls.create_loss_scaler(**kwargs), tls.create_loss_scaler(**kwargs)
    overflows = [False, True, False, False, True, True, True, False, False,
                 False, False, True, False]
    for of in overflows:
        j, t = jls.update_scale(j, jnp.asarray(of)), tls.update_scale(t, of)
        assert (float(j.cur_scale), int(j.cur_hysteresis),
                int(j.last_overflow_iter), int(j.cur_iter)) == \
            (t.cur_scale, t.cur_hysteresis, t.last_overflow_iter, t.cur_iter)


def test_grad_utils_copy_matches():
    rng = np.random.RandomState(0)
    leaves = [rng.randn(7, 3).astype(np.float32), rng.randn(5)
              .astype(np.float32)]
    j_norm = jutils.get_grad_norm([jnp.asarray(x) for x in leaves])
    t = [torch.from_numpy(x.copy()) for x in leaves]
    assert abs(float(tutils.get_grad_norm(t)) - float(j_norm)) <= \
        1e-6 * float(j_norm)
    j_clipped, _ = jutils.clip_grad_norm_([jnp.asarray(x) for x in leaves],
                                          1.0)
    tutils.clip_grad_norm_(t, 1.0)
    for got, want in zip(t, j_clipped):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    bad = [x.copy() for x in leaves]
    bad[1][2] = np.inf
    for arrays, want in ((leaves, False), (bad, True)):
        assert bool(jutils.CheckOverflow.has_overflow(
            [jnp.asarray(x) for x in arrays])) == want
        assert bool(tutils.CheckOverflow.has_overflow(
            [torch.from_numpy(x) for x in arrays])) == want


# ------------------------------------------------------------------ config


def _base(**kwargs):
    d = {"fp16": {"enabled": False}}
    d.update(kwargs)
    return d


ACCEPTED = {
    "only_train_batch": _base(train_batch_size=WORLD * 4),
    "only_micro_batch": _base(train_micro_batch_size_per_gpu=2),
    "train_and_micro": _base(train_batch_size=WORLD * 8,
                             train_micro_batch_size_per_gpu=2),
    "train_and_grad_acc": _base(train_batch_size=WORLD * 8,
                                gradient_accumulation_steps=2),
    "micro_and_grad_acc": _base(train_micro_batch_size_per_gpu=3,
                                gradient_accumulation_steps=5),
    "all_three_consistent": _base(train_batch_size=WORLD * 6,
                                  train_micro_batch_size_per_gpu=3,
                                  gradient_accumulation_steps=2),
    "fp16_static_scale": {"train_batch_size": WORLD * 2,
                          "fp16": {"enabled": True, "loss_scale": 128}},
    "zero_deprecated_bool": {"train_batch_size": WORLD,
                             "fp16": {"enabled": True},
                             "zero_optimization": True},
    "bf16_block": {"train_batch_size": WORLD, "bf16": {"enabled": True},
                   "zero_optimization": {"stage": 1}},
    "dynamic_loss_scale": {"train_batch_size": WORLD,
                           "fp16": {"enabled": True,
                                    "initial_scale_power": 16,
                                    "loss_scale_window": 500,
                                    "hysteresis": 2, "min_loss_scale": 1}},
    "train_path": {"train_micro_batch_size_per_gpu": 16,
                   "gradient_accumulation_steps": 1,
                   "bf16": {"enabled": True},
                   "zero_optimization": {"stage": 2},
                   "optimizer": {"type": "Adam", "params": {
                       "lr": 1e-4, "fused_kernel": "auto"}},
                   "gradient_clipping": 1.0, "steps_per_print": 7,
                   "data_types": {"grad_accum_dtype": "bf16"},
                   "transformer": {"flash_attention": "auto"}},
    "bert_path": {"train_micro_batch_size_per_gpu": 32,
                  "gradient_accumulation_steps": 1,
                  "bf16": {"enabled": True},
                  "zero_optimization": {"stage": 2},
                  "optimizer": {"type": "Lamb", "params": {
                      "lr": 2e-3, "max_coeff": 10.0, "min_coeff": 0.01,
                      "eps_inside_sqrt": False, "fused_kernel": "auto"}},
                  "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                             "gamma": 0.001}},
}

FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "fp16_enabled", "bf16_enabled",
          "loss_scale", "initial_dynamic_scale", "dynamic_loss_scale_args",
          "zero_optimization_stage", "zero_enabled", "optimizer_name",
          "optimizer_params", "gradient_clipping", "grad_accum_dtype",
          "steps_per_print", "transformer_flash_attention", "pld_enabled",
          "pld_params")


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_accepted_configs_resolve_alike(name):
    j = jconfig.DeepSpeedConfig(None, param_dict=dict(ACCEPTED[name]))
    t = tconfig.DeepSpeedConfig(None, param_dict=dict(ACCEPTED[name]),
                                world_size=WORLD)
    assert j.world_size == WORLD
    for field in FIELDS:
        assert getattr(t, field) == getattr(j, field), field
    assert t.zero_config.stage == j.zero_config.stage


def test_config_from_file_and_duplicate_keys_alike(tmp_path):
    good = tmp_path / "ds.json"
    good.write_text('{"train_batch_size": 16, "fp16": {"enabled": true, '
                    '"loss_scale": 128}}')
    j = jconfig.DeepSpeedConfig(str(good))
    t = tconfig.DeepSpeedConfig(str(good), world_size=WORLD)
    assert (t.fp16_enabled, t.loss_scale, t.train_batch_size) == \
        (j.fp16_enabled, j.loss_scale, j.train_batch_size)
    dup = tmp_path / "dup.json"
    dup.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    for cls, kw in ((jconfig.DeepSpeedConfig, {}),
                    (tconfig.DeepSpeedConfig, {"world_size": WORLD})):
        with pytest.raises(ValueError):
            cls(str(dup), **kw)


BAD = {
    "inconsistent_triple": (_base(train_batch_size=WORLD * 100,
                                  train_micro_batch_size_per_gpu=3,
                                  gradient_accumulation_steps=2),
                            AssertionError),
    "no_batch": (_base(), AssertionError),
    "only_grad_accum": (_base(gradient_accumulation_steps=4),
                        AssertionError),
    "zero_without_mixed_precision": ({"train_batch_size": WORLD,
                                      "zero_optimization": {"stage": 2}},
                                     AssertionError),
    "strict_unknown_key": ({"train_batch_size": WORLD,
                            "config_validation": "strict",
                            "zero_optimization": {"stgae": 2}},
                           "DeepSpeedConfigError"),
    "bad_flash_spelling": ({"train_batch_size": WORLD,
                            "transformer": {"flash_attention": "triton"}},
                           "DeepSpeedConfigError"),
    "bad_grad_accum_dtype": ({"train_batch_size": WORLD,
                              "data_types": {"grad_accum_dtype": "fp8"}},
                             "DeepSpeedConfigError"),
    "bad_hpz": ({"train_batch_size": WORLD, "bf16": {"enabled": True},
                 "zero_optimization": {"stage": 2,
                                       "zero_hierarchical_partition": -1}},
                ValueError),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_configs_raise_alike(name):
    cfg, err = BAD[name]
    for module, kw in ((jconfig, {}), (tconfig, {"world_size": WORLD})):
        exc = getattr(module, err) if isinstance(err, str) else err
        with pytest.raises(exc):
            module.DeepSpeedConfig(None, param_dict=dict(cfg), **kw)


# stage 3 and cpu_offload run now, the streamed parameter offload
# (cpu_offload_params, a stage-3 mode) and the ZeRO++ modes too
UNPORTED = {
    "zero_stage_3": {"zero_optimization": {"stage": 3,
                                           "cpu_offload_params": True}},
    "cpu_offload": {"zero_optimization": {"stage": 3, "cpu_offload": True,
                                          "cpu_offload_params": True}},
    "zeropp_qwz": {"zero_optimization": {"stage": 2,
                                         "zero_quantized_gradients": True}},
    "telemetry": {"telemetry": {"enabled": True}},
    "elasticity": {"elasticity": {"enabled": True}},
    "flops_profiler": {"flops_profiler": {"enabled": True}},
    "comm": {"comm": {"quantized_collectives": {"enabled": True}}},
    "executor": {"runtime": {"executor": "off"}},
}


# sections ported since the case was written: they now parse (the
# streamed parameter offload since the cpu_offload_params cases, ZeRO++
# since zeropp_qwz)
PORTED_SINCE = {"comm": lambda c: c.comm_config.quantized_collectives.enabled,
                "zero_stage_3": lambda c: c.zero_config.cpu_offload_params,
                "cpu_offload": lambda c: c.zero_config.cpu_offload_params,
                "zeropp_qwz": lambda c: c.zero_config.quantized_gradients}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_sections_raise_not_implemented(name):
    cfg = {"train_batch_size": WORLD, "bf16": {"enabled": True}}
    cfg.update(UNPORTED[name])
    if name in PORTED_SINCE:
        parsed = tconfig.DeepSpeedConfig(None, param_dict=cfg,
                                         world_size=WORLD)
        assert PORTED_SINCE[name](parsed)
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconfig.DeepSpeedConfig(None, param_dict=cfg, world_size=WORLD)
    # switched off, the section is accepted
    off = {"train_batch_size": WORLD, "telemetry": {"enabled": False}}
    tconfig.DeepSpeedConfig(None, param_dict=off, world_size=WORLD)


SPARSE_SECTIONS = {
    "dense": {"mode": "dense", "block": 32},
    "fixed": {"mode": "fixed", "block": 16, "different_layout_per_head": False,
              "num_local_blocks": 4, "num_global_blocks": 1,
              "attention": "unidirectional",
              "horizontal_global_attention": False,
              "num_different_global_patterns": 1},
    "fixed_defaults": {"mode": "fixed"},
    "variable": {"mode": "variable", "num_random_blocks": 2,
                 "local_window_blocks": [4, 8],
                 "global_block_indices": [0, 4],
                 "global_block_end_indices": [2, 6]},
    "bigbird": {"mode": "bigbird", "block": 32, "num_random_blocks": 1,
                "num_sliding_window_blocks": 5},
    "bslongformer": {"mode": "bslongformer",
                     "global_block_indices": [3]},
    "sliding_window": {"mode": "sliding_window",
                       "num_sliding_window_blocks": 2},
    "no_mode": {"block": 64},
}


@pytest.mark.parametrize("name", sorted(SPARSE_SECTIONS))
def test_sparse_attention_sections_parse_alike(name):
    cfg = {"train_batch_size": WORLD, "bf16": {"enabled": True},
           "sparse_attention": dict(SPARSE_SECTIONS[name])}
    j = jconfig.DeepSpeedConfig(None, param_dict=dict(cfg))
    t = tconfig.DeepSpeedConfig(None, param_dict=dict(cfg), world_size=WORLD)
    assert t.sparse_attention == j.sparse_attention
    assert t.sparse_attention["mode"] == SPARSE_SECTIONS[name].get(
        "mode", "fixed")
    absent = {"train_batch_size": WORLD}
    assert tconfig.DeepSpeedConfig(None, param_dict=absent,
                                   world_size=WORLD).sparse_attention is None
    bad = dict(cfg, sparse_attention={"mode": "strided"})
    for module, kw in ((jconfig, {}), (tconfig, {"world_size": WORLD})):
        with pytest.raises(NotImplementedError, match="strided"):
            module.DeepSpeedConfig(None, param_dict=bad, **kw)


def test_engine_returns_the_parsed_sparse_section_and_leaves_the_model():
    section = SPARSE_SECTIONS["fixed"]
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE))
    cfg = _ds("bf16", 2, 1, 2)
    cfg["sparse_attention"] = dict(section)
    engine = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                            device="cpu")[0]
    assert engine.sparse_attention_config() == section
    assert model.config.sparse_attention is None   # the caller sets it
    plain = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE)),
        config_params=_ds("bf16", 2, 1, 2), device="cpu")[0]
    assert plain.sparse_attention_config() is None


# ------------------------------------------------------------------- model


SHAPE = dict(vocab_size=512, max_seq_len=128, n_layers=2, n_heads=4,
             d_model=128)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + "." + k if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + "." + str(i))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("backend,chunk,remat", [
    ("xla", 0, False), ("xla", 32, True), ("pallas", 32, False),
    ("pallas", 0, True)])
def test_lm_loss_and_grads_match_jax(backend, chunk, remat):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, SHAPE["vocab_size"], size=(2, 128)).astype(np.int32)
    labels = ids.copy()
    labels[:, -5:] = -100                   # masked positions
    jcfg = jgpt2.GPT2Config(**SHAPE, remat=remat, loss_chunk=chunk,
                            flash_attention_backend=(
                                "interpret" if backend == "pallas"
                                else "xla"))
    jparams = jgpt2.init_params(jcfg, seed=1)
    j_loss, j_grads = jax.value_and_grad(jgpt2.lm_loss)(
        jparams, jnp.asarray(ids), jnp.asarray(labels), jcfg, train=True)
    tcfg = tgpt2.GPT2Config(**SHAPE, remat=remat, loss_chunk=chunk,
                            flash_attention_backend=backend)
    model = tgpt2.make_gpt2_model(config=tcfg, seed=1)
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= \
        1e-5 * abs(float(j_loss))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for name, want in _leaves(j_grads):
        got = grads[name]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 2e-5, (name, err)


SPARSE_MODEL = {
    # shared: the JAX package's packed-heads kernels (4 x 32 % 128 == 0)
    "shared": {"mode": "fixed", "block": 16, "num_local_blocks": 4,
               "attention": "unidirectional"},
    # per head: its per-head kernels
    "per_head": {"mode": "fixed", "block": 16,
                 "different_layout_per_head": True, "num_local_blocks": 4,
                 "attention": "unidirectional",
                 "num_different_global_patterns": 4},
}


@pytest.mark.parametrize("layout,chunk,remat", [
    ("shared", 32, False), ("per_head", 0, True)])
def test_lm_loss_and_grads_with_sparse_attention_match_jax(layout, chunk,
                                                           remat):
    """The ds_config sparse section drives both GPT-2s: loss and every
    gradient at test_lm_loss_and_grads_match_jax's tolerances. The path
    adds no parameter: the same seed gives the same weights (wpe covers
    max_seq_len in both)."""
    sa = SPARSE_MODEL[layout]
    rng = np.random.RandomState(8)
    ids = rng.randint(0, SHAPE["vocab_size"], size=(2, 128)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    jcfg = jgpt2.GPT2Config(**SHAPE, remat=remat, loss_chunk=chunk,
                            sparse_attention=sa)
    jparams = jgpt2.init_params(jcfg, seed=3)
    j_loss, j_grads = jax.value_and_grad(jgpt2.lm_loss)(
        jparams, jnp.asarray(ids), jnp.asarray(labels), jcfg, train=True)
    tcfg = tgpt2.GPT2Config(**SHAPE, remat=remat, loss_chunk=chunk,
                            sparse_attention=sa)
    assert not tgpt2._use_fused_attn(tcfg, torch.device("cuda"))
    model = tgpt2.make_gpt2_model(config=tcfg, seed=3)
    plain = dict(tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**SHAPE),
                                       seed=3).named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, plain[name]), name
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= \
        1e-5 * abs(float(j_loss))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for name, want in _leaves(j_grads):
        got = grads[name]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 2e-5, (name, err)


def test_num_params_matches_jax():
    for size in ("gpt2_small", "gpt2_medium"):
        assert tgpt2.num_params(tgpt2.config_for(size)) == \
            jgpt2.num_params(jgpt2.config_for(size))
    assert tgpt2.num_params(tgpt2.config_for("gpt2_medium")) == 354_871_296


def test_dropout_draws_from_the_generator_and_remat_redraws_it():
    cfg = tgpt2.GPT2Config(vocab_size=64, max_seq_len=32, n_layers=2,
                           n_heads=2, d_model=32, dropout=0.1, remat=True,
                           loss_chunk=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, size=(2, 32)))
    grads = []
    for remat in (True, False):
        cfg.remat = remat
        model = tgpt2.make_gpt2_model(config=cfg, seed=0)
        loss = model(ids, ids, generator=torch.Generator().manual_seed(5))
        loss.backward()
        grads.append((float(loss.detach()), model.wte.grad.clone()))
    assert grads[0][0] == grads[1][0]
    assert torch.allclose(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-7)
    model.eval()
    with torch.no_grad():
        evals = {float(model(ids, ids, generator=torch.Generator()
                             .manual_seed(s))) for s in (1, 2)}
    assert len(evals) == 1                    # no dropout in eval


def test_optimizer_state_crosses_both_ways():
    cfg = jgpt2.GPT2Config(vocab_size=64, max_seq_len=16, n_layers=1,
                           n_heads=2, d_model=16)
    tree = jax.tree_util.tree_map(np.asarray, jgpt2.init_params(cfg, 0))
    state = {"step": np.int32(3), "exp_avg": tree,
             "exp_avg_sq": jax.tree_util.tree_map(np.abs, tree)}
    back = tgpt2.optimizer_state_to_jax(
        tgpt2.optimizer_state_from_jax(state))
    assert int(back["step"]) == 3
    for (na, a), (nb, b) in zip(_leaves(state["exp_avg_sq"]),
                                _leaves(back["exp_avg_sq"])):
        assert na == nb and np.array_equal(a, b)


# ------------------------------------------------------------------ engine


ENGINE_SHAPE = dict(vocab_size=256, max_seq_len=64, n_layers=2, n_heads=2,
                    d_model=64)


def _ds(prec, stage, gas, micro):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "zero_optimization": {"stage": stage},
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {
               "lr": 1e-3, "weight_decay": 0.01}}}
    if prec == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


@pytest.mark.parametrize("prec,stage,gas", [
    ("fp32", 0, 1), ("fp32", 0, 2), ("bf16", 1, 2), ("bf16", 2, 1),
    ("bf16", 2, 2)])
def test_engine_trajectory_and_masters_match_jax(prec, stage, gas):
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 256, size=(gas, WORLD, 64)).astype(np.int32)
    jm = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **ENGINE_SHAPE, remat=False, loss_chunk=16), seed=2)
    je, *_ = deepspeed_tpu.initialize(model=jm,
                                      config_params=_ds(prec, stage, gas, 1))
    j_losses = [float(je.train_batch(batch=(ids, ids))) for _ in range(5)]
    tm = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
        **ENGINE_SHAPE, remat=False, loss_chunk=16), seed=2)
    te, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=tm, config_params=_ds(prec, stage, gas, WORLD), device="cpu")
    assert opt is te.optimizer and loader is None and sched is None
    init = dict(_leaves(te.get_master_params()))
    t_losses = [float(te.train_batch(batch=(ids, ids))) for _ in range(5)]
    loss_tol = 1e-5 if prec == "fp32" else 5e-4
    np.testing.assert_allclose(t_losses, j_losses, rtol=loss_tol)
    assert t_losses[-1] < t_losses[0]
    got = dict(_leaves(te.get_master_params()))
    d = ENGINE_SHAPE["d_model"]
    for name, want in _leaves(je.get_master_params()):
        want = np.asarray(want, np.float32)
        if prec == "fp32":
            err = float(np.abs(got[name] - want).max())
            assert err <= 5e-5, (name, err)
            continue
        moved, want_moved = got[name] - init[name], want - init[name]
        if name.endswith("qkv_bias"):
            # the key bias: its exact gradient is zero, so only rounding
            # noise moves it, by at most 5 steps x lr in either package
            key = slice(d, 2 * d)
            assert np.abs(moved[key] - want_moved[key]).max() <= 1e-2, name
            moved, want_moved = (np.delete(a, np.s_[d:2 * d])
                                 for a in (moved, want_moved))
        err = float(np.linalg.norm(moved - want_moved) /
                    np.linalg.norm(want_moved))
        assert err <= 0.25, (name, err)
    assert te.flat.check_views()
    assert te.global_steps == 5 and te.micro_steps == 5 * gas
    assert te.get_optimizer_state()["step"] == 5

    # the JAX engine's state crosses into a fresh port engine bit for bit,
    # and the next step agrees as the trajectories did
    j_master = jax.tree_util.tree_map(np.asarray, je.get_master_params())
    j_opt = jax.tree_util.tree_map(np.asarray, je.state["opt"])
    fresh = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
            **ENGINE_SHAPE, remat=False, loss_chunk=16), seed=9),
        config_params=_ds(prec, stage, gas, WORLD), device="cpu")[0]
    fresh.load_state_from_jax(master=j_master, optimizer_state=j_opt)
    back = fresh.get_optimizer_state()
    assert int(back["step"]) == int(j_opt["step"]) == 5
    for tree, want_tree in ((fresh.get_master_params(), j_master),
                            (back["exp_avg_sq"], j_opt["exp_avg_sq"])):
        got = dict(_leaves(tree))
        for name, want in _leaves(want_tree):
            assert np.array_equal(got[name], want.astype(np.float32)), name
    j_next = float(je.train_batch(batch=(ids, ids)))
    t_next = float(fresh.train_batch(batch=(ids, ids)))
    np.testing.assert_allclose(t_next, j_next, rtol=loss_tol)


def test_engine_trajectory_with_sparse_attention_matches_jax():
    """The parsed section in both GPT2Configs, fp32, 3 steps: the losses
    at the fp32 engine bound, and each engine hands back what its model
    was built with."""
    cfg = _ds("fp32", 0, 1, 1)
    cfg["sparse_attention"] = {"mode": "fixed", "block": 16,
                               "num_local_blocks": 2,
                               "attention": "unidirectional"}
    parsed = tconfig.get_sparse_attention(cfg)
    assert parsed == jconfig.get_sparse_attention(cfg)
    ids = np.random.RandomState(14).randint(
        0, 256, size=(1, WORLD, 64)).astype(np.int32)
    losses = []
    for pkg, gpt2, micro, kw in ((deepspeed_tpu, jgpt2, 1, {}),
                                 (deepspeed_tpu_torch, tgpt2, WORLD,
                                  {"device": "cpu"})):
        model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(
            **ENGINE_SHAPE, remat=False, loss_chunk=16,
            sparse_attention=dict(parsed)), seed=5)
        engine = pkg.initialize(model=model, config_params=dict(
            cfg, train_micro_batch_size_per_gpu=micro), **kw)[0]
        assert engine.sparse_attention_config() == \
            model.config.sparse_attention
        losses.append([float(engine.train_batch(batch=(ids, ids)))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0]


def test_forward_backward_step_equals_train_batch():
    rng = np.random.RandomState(12)
    ids = rng.randint(0, 256, size=(2, 4, 64)).astype(np.int32)
    engines = []
    for _ in range(2):
        model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
            **ENGINE_SHAPE, remat=False, loss_chunk=16), seed=3)
        engines.append(deepspeed_tpu_torch.initialize(
            model=model, config_params=_ds("bf16", 2, 2, 4),
            device="cpu")[0])
    a, b = engines
    for _ in range(2):
        a.train_batch(batch=(ids, ids))
        for i in range(2):
            loss = b(ids[i], ids[i])
            b.backward(loss)
            b.step()
    assert a.global_steps == b.global_steps == 2
    assert torch.equal(a.flat.master, b.flat.master)
    # eval mode: the loss without a graph, and no backward pending
    b.eval()
    loss = b(ids[0], ids[0])
    assert not loss.requires_grad
    with pytest.raises(AssertionError, match="without a prior"):
        b.backward(loss)
    b.train()
    assert torch.equal(loss, a(ids[0], ids[0]).detach())


def test_tied_embedding_grad_sums_both_uses():
    cfg = tgpt2.GPT2Config(**ENGINE_SHAPE, remat=False, loss_chunk=0)
    ids = torch.from_numpy(np.random.RandomState(13).randint(
        0, 256, size=(2, 64)))
    plain = tgpt2.make_gpt2_model(config=cfg, seed=4)
    plain(ids, ids).backward()
    model = tgpt2.make_gpt2_model(config=cfg, seed=4)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config_params=_ds("fp32", 0, 1, 2), device="cpu")[0]
    engine.backward(engine(ids, ids))
    assert engine.flat.check_views()
    got = engine.flat.tree_of(engine.flat.acc)["wte"]
    assert torch.allclose(got, plain.wte.grad, rtol=1e-6, atol=1e-9)


def test_initialize_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this rule is about a machine without CUDA")
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model,
                                       config_params=_ds("bf16", 2, 1, 2))


def test_world_size_above_one_and_unported_arguments_raise(monkeypatch):
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE))
    # a data-parallel world above one needs a process group of its size
    # (tests/test_torch_zero_dp.py trains one); ZeRO-3's streamed
    # parameter offload runs at one rank (tests/test_torch_stream_offload.py)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        build_mesh(data=2)
    streamed = _ds("bf16", 3, 1, 2)
    streamed["zero_optimization"]["cpu_offload_params"] = True
    assert deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE)),
        config_params=streamed, device="cpu")[0].stream_runner is not None
    # the batch triple follows the mesh's data axis (1 here), not the
    # size of a process group the mesh does not span
    monkeypatch.setattr(tconfig, "_world_size", lambda: 2)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config_params=_ds("bf16", 2, 1, 2), device="cpu")[0]
    assert engine.dp_world_size == 1 and engine.train_batch_size() == 2
    assert isinstance(engine.flat, FlatPartition) and \
        engine.flat.part_numel == engine.flat.numel
    monkeypatch.undo()
    # what the client arguments cannot take: a torch optimizer (no JAX
    # counterpart), a schedule without step(), a subset of the parameters
    for kw, match in (
            ({"optimizer": torch.optim.SGD(model.parameters(), lr=0.1)},
             "port optimizer handle"),
            ({"optimizer": object()}, "port optimizer handle"),
            ({"lr_scheduler": object()}, "step"),
            ({"model_parameters": list(model.parameters())[:1]},
             "frozen parameters")):
        with pytest.raises((TypeError, NotImplementedError), match=match):
            deepspeed_tpu_torch.initialize(
                model=model, config_params=_ds("bf16", 2, 1, 2),
                device="cpu", **kw)
    # OneBitAdam is ported: one rank trains it (its exchange is a no-op)
    cfg = _ds("bf16", 2, 1, 2)
    cfg["optimizer"]["type"] = "OneBitAdam"
    # (weight decay needs stage 0 under OneBitAdam, as in the JAX engine)
    cfg["optimizer"]["params"].pop("weight_decay", None)
    engine = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                            device="cpu")[0]
    assert engine._local_grad_mode() == "stacked"


def test_kernel_settings_resolve_to_the_plain_versions_on_cpu():
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE))
    cfg = _ds("bf16", 2, 1, 2)
    cfg["transformer"] = {"flash_attention": "auto"}
    cfg["optimizer"]["params"]["fused_kernel"] = "auto"
    engine = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                            device="cpu")[0]
    assert engine.flash_attention_backend == "xla"
    assert engine.fused_optimizer_kernel == "xla"
    assert model.config.flash_attention_backend == "xla"
    cfg["transformer"] = {"flash_attention": "pallas"}
    cfg["optimizer"]["params"]["fused_kernel"] = "pallas"
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**ENGINE_SHAPE))
    engine = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                            device="cpu")[0]
    assert engine.flash_attention_backend == "pallas"
    assert engine.optimizer.use_kernel
    ids = np.random.RandomState(0).randint(0, 256, size=(1, 2, 64))
    assert np.isfinite(float(engine.train_batch(batch=(ids, ids))))
