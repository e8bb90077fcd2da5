"""The port's FP16_Optimizer against the JAX package's wrapper, on the
CPU: the cases of ``tests/unit/test_fp16_optimizer.py``, each run through
both wrappers from the same numpy inputs (the port's gradients from
autograd, the JAX package's from ``jax.grad``).

Tolerances: overflow flags, loss scales and scaler counters equal; the
40-step convergence run's losses 1e-3 relative step by step (bf16 params:
each step rounds the masters to bf16 in both, and the two frameworks'
fp32 matmuls differ in the last bits, which a bf16 rounding can turn
into one bf16 step; 1.7e-4 measured), and the final loss below a tenth
of the first in both; one-step params within one bf16 ulp; masters and moments carried
through ``state_dict`` bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb
from deepspeed_tpu.runtime.fp16.fused_optimizer import \
    FP16_Optimizer as JFP16
from deepspeed_tpu_torch.ops.adam import FusedAdam as TAdam
from deepspeed_tpu_torch.ops.lamb import FusedLamb as TLamb
from deepspeed_tpu_torch.ops.sgd import SGD as TSGD
from deepspeed_tpu_torch.runtime.fp16.fused_optimizer import (
    FP16_Optimizer, FP16_UnfusedOptimizer)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def _scaler(opt):
    s = opt.scaler
    return (float(s.cur_scale), int(s.cur_iter), int(s.last_overflow_iter),
            int(s.cur_hysteresis))


def test_converges_with_dynamic_scale():
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8})
    jopt, topt = JFP16(JAdam(lr=5e-2), **args), \
        FP16_Optimizer(TAdam(lr=5e-2), **args)
    rs = np.random.RandomState(0)
    W = rs.randn(16, 4).astype(np.float32)
    x = rs.randn(32, 16).astype(np.float32)
    y = x @ W
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jloss = lambda p: jnp.mean((jx @ p["w"] - jy) ** 2)
    tloss = lambda p: ((tx @ p["w"].float() - ty) ** 2).mean()
    jp = {"w": jnp.zeros((16, 4), dtype=jnp.bfloat16)}
    tp = {"w": torch.zeros(16, 4, dtype=torch.bfloat16)}
    jl, tl = [], []
    for _ in range(40):
        grads = jax.grad(lambda p: jopt.scale_loss(jloss(p)))(jp)
        jp, jof = jopt.step(grads, jp)
        w = tp["w"].clone().requires_grad_()
        topt.scale_loss(tloss({"w": w})).backward()
        tp, tof = topt.step({"w": w.grad}, tp)
        assert jof == tof and _scaler(jopt) == _scaler(topt)
        jl.append(float(jloss(jp)))
        tl.append(float(tloss(tp)))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < 0.1 * tl[0] and jl[-1] < 0.1 * jl[0]


def test_overflow_skips_and_halves_scale():
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8})
    jopt, topt = JFP16(JAdam(lr=1e-2), **args), \
        FP16_Optimizer(TAdam(lr=1e-2), **args)
    jp = {"w": jnp.ones((4, 4), dtype=jnp.bfloat16)}
    tp = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    jopt.initialize_state(jp)
    topt.initialize_state(tp)
    new_j, jof = jopt.step({"w": jnp.full((4, 4), jnp.inf)}, jp)
    new_t, tof = topt.step({"w": torch.full((4, 4), float("inf"))}, tp)
    assert jof and tof
    assert topt.loss_scale == jopt.loss_scale == 2 ** 7
    assert _scaler(jopt) == _scaler(topt)
    assert torch.equal(new_t["w"], tp["w"])
    np.testing.assert_array_equal(new_t["w"].float().numpy(),
                                  np.asarray(new_j["w"], np.float32))
    assert topt.state_dict()["optimizer_state_dict"]["step"] == 0


def test_static_scale_and_clip():
    jopt = JFP16(JAdam(lr=1e-2), static_loss_scale=64.0, clip_grad=1.0)
    topt = FP16_Optimizer(TAdam(lr=1e-2), static_loss_scale=64.0,
                          clip_grad=1.0)
    assert topt.loss_scale == jopt.loss_scale == 64.0
    assert float(topt.scale_loss(torch.tensor(2.0))) == \
        float(jopt.scale_loss(jnp.asarray(2.0))) == 128.0
    # the clip at work: scaled grads of norm 64 * 10 -> one step of a
    # unit-norm gradient, the same in both
    g = np.full((4, 4), 64.0 * 10 / 4, np.float32)
    jp, _ = jopt.step({"w": jnp.asarray(g)},
                      {"w": jnp.ones((4, 4), jnp.float32)})
    tp, _ = topt.step({"w": torch.from_numpy(g)}, {"w": torch.ones(4, 4)})
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


def test_state_dict_roundtrip():
    jopt = JFP16(JAdam(lr=1e-2), dynamic_loss_scale=True)
    topt = FP16_Optimizer(TAdam(lr=1e-2), dynamic_loss_scale=True)
    params = {"w": torch.ones(4, 2, dtype=torch.bfloat16)}
    grads = {"w": torch.ones(4, 2)}
    topt.step(grads, params)
    jopt.step({"w": jnp.ones((4, 2))},
              {"w": jnp.ones((4, 2), dtype=jnp.bfloat16)})
    sd = topt.state_dict()
    assert set(sd) == set(jopt.state_dict())
    topt2 = FP16_Optimizer(TAdam(lr=1e-2), dynamic_loss_scale=True)
    topt2.initialize_state(params)
    topt2.load_state_dict(sd)
    assert topt2.loss_scale == topt.loss_scale == jopt.loss_scale
    assert _scaler(topt2) == _scaler(topt) == _scaler(jopt)
    assert torch.equal(topt2._master["w"], topt._master["w"])
    np.testing.assert_allclose(topt._master["w"].numpy(),
                               np.asarray(jopt._master["w"]), rtol=1e-6)
    opt_sd = topt2.state_dict()["optimizer_state_dict"]
    assert opt_sd["step"] == 1
    assert torch.equal(opt_sd["exp_avg_sq"]["w"],
                       sd["optimizer_state_dict"]["exp_avg_sq"]["w"])
    # and both take the next step alike
    a, _ = topt.step(grads, params)
    b, _ = topt2.step(grads, params)
    assert torch.equal(a["w"], b["w"])


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_unfused_is_fused_and_takes_lamb(moments):
    assert FP16_UnfusedOptimizer is FP16_Optimizer
    jopt = JFP16(JLamb(lr=1e-2, moments_dtype=moments))
    topt = FP16_UnfusedOptimizer(TLamb(lr=1e-2, moments_dtype=moments))
    g = np.full((8, 4), 0.1, np.float32)
    new_j, jof = jopt.step({"w": jnp.asarray(g)},
                           {"w": jnp.ones((8, 4), dtype=jnp.bfloat16)})
    new_t, tof = topt.step({"w": torch.from_numpy(g)},
                           {"w": torch.ones(8, 4, dtype=torch.bfloat16)})
    assert not tof and not jof
    assert not torch.allclose(new_t["w"].float(), torch.ones(8, 4))
    # bf16 params: equal after the rounding, or one bf16 step apart
    got = new_t["w"].float().numpy()
    want = np.asarray(new_j["w"], np.float32)
    assert np.all(np.abs(got - want) <= np.spacing(want) * 2 ** 16), \
        (got, want)
    assert topt._m.dtype == (torch.bfloat16 if moments == "bf16"
                             else torch.float32)


def test_sgd_and_nested_trees():
    """SGD with momentum over a nested tree of two dtypes: the fp32
    masters move as the JAX wrapper's do."""
    jopt = JFP16(__import__("deepspeed_tpu.ops.sgd", fromlist=["SGD"])
                 .SGD(lr=0.1, momentum=0.9, weight_decay=0.01))
    topt = FP16_Optimizer(TSGD(lr=0.1, momentum=0.9, weight_decay=0.01))
    rng = np.random.RandomState(4)
    p0 = {"a": rng.randn(3, 5).astype(np.float32),
          "b": [rng.randn(7).astype(np.float32)]}
    jp = {"a": jnp.asarray(p0["a"]), "b": [jnp.asarray(p0["b"][0])]}
    tp = {"a": torch.from_numpy(p0["a"].copy()),
          "b": [torch.from_numpy(p0["b"][0].copy())]}
    for _ in range(3):
        g = {"a": rng.randn(3, 5).astype(np.float32),
             "b": [rng.randn(7).astype(np.float32)]}
        jp, _ = jopt.step({"a": jnp.asarray(g["a"]),
                           "b": [jnp.asarray(g["b"][0])]}, jp)
        tp, _ = topt.step({"a": torch.from_numpy(g["a"]),
                           "b": [torch.from_numpy(g["b"][0])]}, tp)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]),
                               rtol=1e-6, atol=1e-7)
