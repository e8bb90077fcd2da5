"""bf16 optimizer moments in the port against the JAX package, on the CPU.

``optimizer.params.moments_dtype: "bf16"`` stores Adam's and LAMB's
moments in bf16 and runs their math in fp32 (the JAX package's
``adam_init`` / ``lamb_init`` and the XLA leaves of ``adam_update`` /
``lamb_update``). The same numpy-seeded params, gradients and bf16
moments go through the JAX update (jitted, as the JAX engine runs it) and
through the port's, whose wrappers run their plain versions on CPU
tensors; then the engines: LAMB at TP 2 with shards of unequal norms
against TP 1 and the JAX engine, and a GPT-2 engine with bench.py's
``bf16_state`` settings against the JAX engine, whose state crosses both
ways.

Tolerances:
* stored moments: one bf16 ulp (the fp32 m' and v' may differ by the
  last fp32 bit where XLA fuses a multiply and an add, and that bit can
  move the rounding to bf16 by one step);
* params: 2 fp32 ulp at the larger of |p| and the step |p' - p|, plus
  2^-20 of the step (``tests/test_torch_lamb.py``'s bound). For Adam the
  2 ulp are ``tests/test_torch_adam.py``'s; the 2^-20 of the step covers
  the tree's all-zero leaf, where the step is all of p': m' is a sum
  whose two terms can nearly cancel, and XLA fuses one of its products
  into an FMA, so the update can differ by a few of its own ulp (4
  measured); for LAMB it also covers the norms' summation order;
* engines: the bounds of ``tests/test_torch_training.py`` and
  ``tests/test_torch_tp_training.py`` (losses 1e-5 relative at fp32, 5e-4
  at bf16 compute; fp32 masters 5e-5 absolute).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.adam import fused_adam as jax_adam
from deepspeed_tpu.ops.lamb import fused_lamb as jax_lamb
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.adam import (FusedAdam, adam_init, adam_update,
                                          fused_adam)
from deepspeed_tpu_torch.ops.lamb import (FusedLamb, LambPlan, fused_lamb,
                                          fused_lamb_apply, lamb_init,
                                          lamb_update)
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_tp_workers as workers

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
SHAPES = {"w": (16, 128), "ragged": (231,), "zero": (4, 4),
          "big": (3, 5000)}


def bf16_steps(a, b):
    """Largest distance between two bf16 arrays in bf16 steps."""
    def line(x):
        bits = np.asarray(x).view(np.uint16).astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(line(a) - line(b)).max())


def bf16_of(t):
    """A bf16 torch tensor -> its uint16 bit patterns."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def p_bound(before, got, want):
    """max |got - want| / (2 ulp(max(|p|, |step|)) + 2^-20 |step|)."""
    want = np.asarray(want, np.float64)
    step = np.abs(before.astype(np.float64) - want)
    top = np.maximum(np.abs(before), step).astype(np.float32)
    bound = 2 * np.spacing(top).astype(np.float64) + 2.0 ** -20 * step
    return float((np.abs(np.asarray(got, np.float64) - want) / bound).max())


def _state(seed):
    """fp32 params and gradients, bf16 moments (v >= 0) at step 3."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero"][:] = 0.0
    grads = {k: (rng.randn(*s) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()}
    m = {k: torch.from_numpy((rng.randn(*s) * 1e-2).astype(np.float32))
         .bfloat16() for k, s in SHAPES.items()}
    v = {k: torch.from_numpy((rng.randn(*s) * 1e-2).astype(np.float32) ** 2)
         .bfloat16() for k, s in SHAPES.items()}
    return params, grads, m, v


def _jax_state(m, v):
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return {"step": jnp.int32(3),
            "exp_avg": {k: as_j(t) for k, t in m.items()},
            "exp_avg_sq": {k: as_j(t) for k, t in v.items()}}


def _compare(t_params, t_state, j_params, j_state, params):
    assert t_state["step"] == int(j_state["step"]) == 4
    for k in SHAPES:
        for name in ("exp_avg", "exp_avg_sq"):
            got, want = t_state[name][k], j_state[name][k]
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            assert bf16_steps(bf16_of(got), np.asarray(want)) <= 1, (k, name)
        assert p_bound(params[k], t_params[k].numpy(),
                       np.asarray(j_params[k])) <= 1, k


@pytest.mark.parametrize("adam_w,bias_correction", [
    (True, True), (False, True), (True, False), (False, False)])
def test_bf16_adam_step_matches_adam_update(adam_w, bias_correction):
    """One step of ``adam_update`` with bf16 moments (the XLA leaf,
    jitted) and of the port's, AdamW and L2, bias correction on and off:
    moments within one bf16 ulp, params within 2 fp32 ulp."""
    params, grads, m, v = _state(0)
    jitted = jax.jit(jax_adam.adam_update, static_argnames=(
        "adam_w_mode", "bias_correction"))
    j_params, j_state = jitted(
        {k: jnp.asarray(g) for k, g in grads.items()}, _jax_state(m, v),
        {k: jnp.asarray(p) for k, p in params.items()},
        adam_w_mode=adam_w, bias_correction=bias_correction,
        **{k: jnp.float32(x) for k, x in HYPER.items()})
    t_params = {k: torch.from_numpy(p.copy()) for k, p in params.items()}
    t_state = {"step": 3, "exp_avg": {k: t.clone() for k, t in m.items()},
               "exp_avg_sq": {k: t.clone() for k, t in v.items()}}
    t_params, t_state = adam_update(
        {k: torch.from_numpy(g) for k, g in grads.items()}, t_state,
        t_params, adam_w_mode=adam_w, bias_correction=bias_correction,
        **HYPER)

    _compare(t_params, t_state, j_params, j_state, params)


@pytest.mark.parametrize("eps_inside_sqrt,bias_correction", [
    (False, True), (True, True), (False, False)])
def test_bf16_lamb_step_matches_lamb_update(eps_inside_sqrt,
                                            bias_correction):
    """One step of ``lamb_update`` with bf16 moments (the XLA leaf,
    jitted) and of the port's over a tree with a zero leaf (ratio 1) and
    a leaf of two kernel chunks: moments within one bf16 ulp; params 2
    ulp plus 2^-20 of the step (u comes from the fp32 m' and v': from the
    stored bf16 ones it would be ~2^-9 off)."""
    params, grads, m, v = _state(1)
    jitted = jax.jit(jax_lamb.lamb_update, static_argnames=(
        "bias_correction", "eps_inside_sqrt"))
    j_params, j_state = jitted(
        {k: jnp.asarray(g) for k, g in grads.items()}, _jax_state(m, v),
        {k: jnp.asarray(p) for k, p in params.items()},
        bias_correction=bias_correction, eps_inside_sqrt=eps_inside_sqrt,
        **{k: jnp.float32(x) for k, x in HYPER.items()})
    t_params = {k: torch.from_numpy(p.copy()) for k, p in params.items()}
    t_state = {"step": 3, "exp_avg": {k: t.clone() for k, t in m.items()},
               "exp_avg_sq": {k: t.clone() for k, t in v.items()}}
    t_params, t_state = lamb_update(
        {k: torch.from_numpy(g) for k, g in grads.items()}, t_state,
        t_params, bias_correction=bias_correction,
        eps_inside_sqrt=eps_inside_sqrt, **HYPER)

    _compare(t_params, t_state, j_params, j_state, params)


def test_bf16_lamb_kernel_design_on_a_flat_buffer():
    """Stage 1 leaves bf16 moments untouched and gives the tree form's
    ratios; the apply stores m' and v'; a flat buffer of four segments
    equals the tree form leaf by leaf, bit for bit; the apply refuses
    bf16 moments without g."""
    params, grads, m, v = _state(2)
    keys = list(SHAPES)
    offs = np.cumsum([0] + [-(-params[k].size // 64) * 64 for k in keys])
    n = int(offs[-1])
    flat = [torch.zeros(n) for _ in range(2)] + \
        [torch.zeros(n, dtype=torch.bfloat16) for _ in range(2)]
    for k, off in zip(keys, offs):
        size = params[k].size
        for buf, src in zip(flat, (params[k], grads[k], m[k], v[k])):
            buf[off:off + size] = torch.as_tensor(src).reshape(-1).to(
                buf.dtype)
    plan = LambPlan([(int(o), params[k].size) for k, o in zip(keys, offs)],
                    "cpu")
    p, g, mm, vv = flat
    m0, v0 = mm.clone(), vv.clone()
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bc1=0.271, bc2=0.003996)
    ratio, _ = fused_lamb(p, g, mm, vv, plan, **sc)
    assert torch.equal(mm, m0) and torch.equal(vv, v0)
    with pytest.raises(ValueError, match="need g"):
        fused_lamb_apply(p, mm, vv, ratio, plan, lr=1e-3, eps=1e-8,
                         weight_decay=0.01, bc1=0.271, bc2=0.003996)
    fused_lamb_apply(p, mm, vv, ratio, plan, lr=1e-3, g=g, **sc)
    tree = {k: torch.from_numpy(params[k].copy()) for k in keys}
    state = {"step": 0, "exp_avg": {k: m[k].clone() for k in keys},
             "exp_avg_sq": {k: v[k].clone() for k in keys}}
    opt = FusedLamb(lr=1e-3, weight_decay=0.01, moments_dtype="bf16")
    assert opt.init_state(tree)["exp_avg"]["w"].dtype == torch.bfloat16
    # the tree form at the same bias corrections: step 1 with betas whose
    # 1 - beta^1 are the corrections above is not it, so step it directly
    for k, off in zip(keys, offs):
        size = params[k].size
        leaf_plan = LambPlan([(0, size)], "cpu")
        lp = tree[k].reshape(-1)
        lm = state["exp_avg"][k].reshape(-1)
        lv = state["exp_avg_sq"][k].reshape(-1)
        lg = torch.from_numpy(grads[k]).reshape(-1)
        r, _ = fused_lamb(lp, lg, lm, lv, leaf_plan, **sc)
        fused_lamb_apply(lp, lm, lv, r, leaf_plan, lr=1e-3, g=lg, **sc)
        assert torch.equal(r[0], ratio[keys.index(k)]), k
        for whole, leaf in ((p, lp), (mm, lm), (vv, lv)):
            assert torch.equal(whole[off:off + size], leaf), k


def test_moment_spellings_and_init_state():
    for spelling in ("bf16", "BFLOAT16", torch.bfloat16):
        assert FusedAdam(moments_dtype=spelling).moments_dtype == \
            torch.bfloat16
    for spelling in (None, "fp32", "float32"):
        assert FusedLamb(moments_dtype=spelling).moments_dtype == \
            torch.float32
    for bad in ("fp16", "int8", torch.float16):
        with pytest.raises(ValueError, match="moments_dtype"):
            FusedAdam(moments_dtype=bad)
    tree = {"a": torch.ones(3), "b": [torch.ones(2, 2)]}
    for init in (adam_init, lamb_init):
        state = init(tree, torch.bfloat16)
        assert state["exp_avg_sq"]["b"][0].dtype == torch.bfloat16
    # an fp32 gradient is required, bf16 moments are fine
    p = torch.zeros(8)
    fused_adam(p, torch.ones(8), torch.zeros(8, dtype=torch.bfloat16),
               torch.zeros(8, dtype=torch.bfloat16), lr=1e-3, beta1=0.9,
               beta2=0.999, eps=1e-8, weight_decay=0.0, bc1=0.1, bc2=0.001)
    with pytest.raises(ValueError, match="alike"):
        fused_adam(p, torch.ones(8), torch.zeros(8, dtype=torch.bfloat16),
                   torch.zeros(8), lr=1e-3, beta1=0.9, beta2=0.999,
                   eps=1e-8, weight_decay=0.0, bc1=0.1, bc2=0.001)


# ------------------------------------------------------------- engines


TP_MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
                d_model=64, remat=False, loss_chunk=0)
FC_SCALE = 20.0
LAMB_STEPS = 2


def _tp_ds(tp):
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "Lamb", "params": {
                "lr": 1e-3, "moments_dtype": "bf16"}},
            "steps_per_print": 10 ** 9}
    if tp:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "pallas"}}
    return conf


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_tp2_bf16_lamb_with_unequal_shards_matches_tp1_and_jax():
    """LAMB with bf16 moments at TP 2 (rank 0's half of every fc kernel
    x20): each trust ratio still from the whole leaf. Losses 1e-5
    relative and fp32 masters 5e-5 against the port's TP 1 engine and the
    JAX engine on build_mesh(model=2), fp32 compute."""
    ids = np.random.RandomState(0).randint(0, 128, size=(1, 2, 32))
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **TP_MODEL, use_flash_attention=False))
    model.params = jax.tree_util.tree_map_with_path(
        lambda path, x: x.at[..., :x.shape[-1] // 2].multiply(FC_SCALE)
        if jax.tree_util.keystr(path).endswith("['fc_kernel']") else x,
        model.params)
    eng = JEngine(model=model, mesh=j_build_mesh(model=2),
                  config_params=_tp_ds(True))
    j_losses = [float(eng.train_batch(batch=(ids, ids)))
                for _ in range(LAMB_STEPS)]
    j_master = dict(_leaves(eng.get_master_params()))
    assert eng.state["opt"]["exp_avg"]["wte"].dtype == jnp.bfloat16

    module = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**TP_MODEL))
    workers.scale_fc_left_half(module, FC_SCALE)
    tp1 = deepspeed_tpu_torch.initialize(model=module,
                                         config_params=_tp_ds(False),
                                         device="cpu")[0]
    assert tp1.flat.exp_avg.dtype == torch.bfloat16
    t_ids = ids.astype(np.int64)
    tp1_losses = [float(tp1.train_batch(batch=(t_ids, t_ids)))
                  for _ in range(LAMB_STEPS)]
    tp1_master = dict(_leaves(tp1.get_master_params()))
    spec = dict(model=TP_MODEL, seed=0, prec="fp32", backend="pallas",
                micro=2, ids=t_ids, steps=LAMB_STEPS, load=None,
                optimizer="Lamb", opt_params={"moments_dtype": "bf16"},
                scale_fc=FC_SCALE)
    ranks = spawn(workers.tp_engine, 2, args=([spec],), timeout_s=150)
    np.testing.assert_allclose(tp1_losses, j_losses, rtol=1e-5)
    for rank in ranks:
        res = rank[0]
        np.testing.assert_allclose(res["losses"], tp1_losses, rtol=1e-5)
        np.testing.assert_allclose(res["losses"], j_losses, rtol=1e-5)
        assert res["opt_step"] == LAMB_STEPS
        got = dict(_leaves(res["master"]))
        for name, want in j_master.items():
            for ref in (want, tp1_master[name]):
                err = float(np.abs(got[name] - ref).max())
                assert err <= 5e-5, (name, err)


ENGINE_SHAPE = dict(vocab_size=256, max_seq_len=64, n_layers=2, n_heads=2,
                    d_model=64)
WORLD = 8


def _bench_rung(micro, optimizer="Adam"):
    """bench.py:124-140's first rung at a tiny width: bf16, ZeRO-2,
    bf16 moments and a bf16 gradient accumulator."""
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2},
            "optimizer": {"type": optimizer, "params": {
                "lr": 1e-3, "moments_dtype": "bf16"}},
            "data_types": {"grad_accum_dtype": "bf16"},
            "steps_per_print": 10 ** 9}


@pytest.mark.parametrize("optimizer", ["Adam", "Lamb"])
def test_engine_with_bf16_state_matches_jax_and_crosses_both_ways(
        optimizer):
    """GPT-2 through both engines at bench.py's first-rung settings, 4
    steps from one init: losses 5e-4 relative (bf16 compute, as the
    engine tests); the moments are bf16 in both. Then the JAX engine's
    state (bf16 moments) loads into a fresh port engine bit for bit, goes
    back out bit for bit, and the next loss agrees."""
    ids = np.random.RandomState(5).randint(
        0, 256, size=(1, WORLD, 64)).astype(np.int32)
    cfg = dict(ENGINE_SHAPE, remat=False, loss_chunk=16)
    je = deepspeed_tpu.initialize(
        model=jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(**cfg), seed=2),
        config_params=_bench_rung(1, optimizer))[0]
    j_losses = [float(je.train_batch(batch=(ids, ids))) for _ in range(4)]
    te = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**cfg), seed=2),
        config_params=_bench_rung(WORLD, optimizer), device="cpu")[0]
    assert te.flat.exp_avg.dtype == te.flat.acc.dtype == torch.bfloat16
    t_losses = [float(te.train_batch(batch=(ids, ids))) for _ in range(4)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-4)
    assert t_losses[-1] < t_losses[0]

    j_master = jax.tree_util.tree_map(np.asarray, je.get_master_params())
    j_opt = jax.tree_util.tree_map(np.asarray, je.state["opt"])
    assert j_opt["exp_avg"]["wte"].dtype.name == "bfloat16"
    fresh = deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**cfg), seed=9),
        config_params=_bench_rung(WORLD, optimizer), device="cpu")[0]
    fresh.load_state_from_jax(master=j_master, optimizer_state=j_opt)
    back = fresh.get_optimizer_state()
    assert int(back["step"]) == int(j_opt["step"]) == 4
    for name in ("exp_avg", "exp_avg_sq"):
        got = dict(_leaves(back[name]))
        for leaf, want in _leaves(j_opt[name]):
            bits = got[leaf].astype(jnp.bfloat16).view(np.uint16)
            assert np.array_equal(bits, want.view(np.uint16)), (name, leaf)
            assert np.array_equal(got[leaf], want.astype(np.float32))
    j_next = float(je.train_batch(batch=(ids, ids)))
    t_next = float(fresh.train_batch(batch=(ids, ids)))
    np.testing.assert_allclose(t_next, j_next, rtol=5e-4)


def test_lamb_plan_refuses_overlapping_segments():
    """With bf16 moments the apply makes m' from the old m, so an element
    in two segments would be stepped twice: the plan refuses tables whose
    segments overlap or run backwards."""
    LambPlan([(0, 8), (8, 0), (8, 5), (64, 3)], "cpu")
    for bad in ([(0, 10), (8, 4)], [(16, 4), (0, 4)], [(0, -1)]):
        with pytest.raises(ValueError, match="overlap"):
            LambPlan(bad, "cpu")
