"""The port's Adam against the JAX package, on the CPU.

The same numpy-seeded params, moments and three steps of gradients go
through the JAX Pallas kernel ``_fused_adam_flat`` in interpret mode (as
tests/unit/test_pallas_kernels.py runs it) and through ``adam_update``'s
jnp path (jitted, as the JAX engine runs it), and through the port's ``fused_adam`` wrapper, which runs its
plain version (``fused_adam_reference``) on CPU tensors. AdamW
(decoupled decay) and L2 modes, weight decay 0.01.

Tolerance: 2 ulp (units in the last place of fp32) per element, at the
scale of the terms that make it (:func:`term_scales`: for ``m`` the
larger of ``beta1 * m``, ``(1 - beta1) * g`` and, in L2 mode, the decay
term; likewise for ``v`` and ``p``). Both sides round each operation
once in the same order and take the bias corrections in fp32, but XLA's
CPU compiler may fuse a multiply and an add into one FMA (one rounding
instead of two); where two terms nearly cancel, that last-bit
difference is many ulp of the small result, so the terms' scale is what
the arithmetic can promise. Each step starts both sides from the same
state, so a difference does not carry into the next step. The L2 mode's
decayed gradient ``g + weight_decay * p`` is one FMA on both sides (XLA
fuses it; the port rounds it once on purpose, :func:`fma_f32`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.adam import fused_adam as jax_adam
from deepspeed_tpu.ops.adam.pallas_adam import _fused_adam_flat
from deepspeed_tpu_torch.ops.adam import (FusedAdam, adam_init, adam_update,
                                          bias_corrections, fma_f32,
                                          fused_adam, fused_adam_reference)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
ROWS = 16                       # (rows, 128) fp32, the TPU kernel's layout


def ulp_diff(a, b, scale=None):
    """Element-wise |a - b| in fp32 units in the last place of the larger
    of |a|, |b| and ``scale``."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    top = np.maximum(np.abs(a), np.abs(b))
    if scale is not None:
        top = np.maximum(top, np.asarray(scale, np.float32))
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return diff / np.spacing(top).astype(np.float64)


def term_scales(p, m, v, g, adam_w):
    """The magnitude of the largest term of each output (p, m, v): the
    state before the step and the gradient (with the L2 decay term)."""
    p, m, v, g = (np.abs(np.asarray(x, np.float64)) for x in (p, m, v, g))
    wd, b1, b2 = HYPER["weight_decay"], HYPER["beta1"], HYPER["beta2"]
    g_eff = g if adam_w else np.maximum(g, wd * p)
    return (p, np.maximum(b1 * m, (1 - b1) * g_eff),
            np.maximum(b2 * v, (1 - b2) * g_eff * g_eff))


def _state(seed):
    rng = np.random.RandomState(seed)
    p = rng.randn(ROWS, 128).astype(np.float32)
    grads = [rng.randn(ROWS, 128).astype(np.float32) for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("adam_w", [True, False])
def test_plain_adam_matches_the_tpu_kernel(adam_w):
    p0, grads = _state(0)
    tp = torch.from_numpy(p0.copy()).reshape(-1)
    tm, tv = torch.zeros_like(tp), torch.zeros_like(tp)
    for step, g in enumerate(grads, start=1):
        before = [t.numpy().reshape(ROWS, 128).copy() for t in (tp, tm, tv)]
        bc1, bc2 = bias_corrections(HYPER["beta1"], HYPER["beta2"], step)
        scalars = jnp.asarray([HYPER["lr"], HYPER["beta1"], HYPER["beta2"],
                               HYPER["eps"], HYPER["weight_decay"], bc1,
                               bc2], jnp.float32)
        jp, jm, jv = _fused_adam_flat(
            *(jnp.asarray(x) for x in (before[0], g, before[1], before[2])),
            scalars, adam_w_mode=adam_w, interpret=True)
        fused_adam(tp, torch.from_numpy(g).reshape(-1), tm, tv, bc1=bc1,
                   bc2=bc2, adam_w_mode=adam_w, **HYPER)
        scales = term_scales(*before, g, adam_w)
        for got, want, scale in zip((tp, tm, tv), (jp, jm, jv), scales):
            err = ulp_diff(got.numpy(), np.asarray(want).reshape(-1),
                           scale.reshape(-1))
            assert err.max() <= 2, (step, err.max())


@pytest.mark.parametrize("adam_w", [True, False])
def test_pytree_adam_matches_adam_update(adam_w):
    """adam_update over a two-leaf tree, 3 steps, hyperparameters as f32
    and the update jitted (as the JAX engine runs it, inside its apply
    step's jit): params, moments and bias corrections all within 2 ulp."""
    jitted_update = jax.jit(jax_adam.adam_update,
                            static_argnames=("adam_w_mode",))
    rng = np.random.RandomState(1)
    shapes = {"w": (33, 7), "b": (7,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = jax_adam.adam_init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = adam_init(t_params)
    hyper32 = {k: jnp.float32(v) for k, v in HYPER.items()}
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        before = {k: [t[k].numpy().copy() for t in (
            t_params, t_state["exp_avg"], t_state["exp_avg_sq"])]
            for k in shapes}
        j_params = {k: jnp.asarray(v[0]) for k, v in before.items()}
        j_state = {"step": jnp.int32(t_state["step"]),
                   "exp_avg": {k: jnp.asarray(v[1])
                               for k, v in before.items()},
                   "exp_avg_sq": {k: jnp.asarray(v[2])
                                  for k, v in before.items()}}
        j_params, j_state = jitted_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, j_state,
            j_params, adam_w_mode=adam_w, **hyper32)
        t_params, t_state = adam_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, t_state,
            t_params, adam_w_mode=adam_w, **HYPER)
        assert t_state["step"] == int(j_state["step"])
        for k in shapes:
            scales = term_scales(*before[k], grads[k], adam_w)
            for got, want, scale in zip(
                    (t_params[k], t_state["exp_avg"][k],
                     t_state["exp_avg_sq"][k]),
                    (j_params[k], j_state["exp_avg"][k],
                     j_state["exp_avg_sq"][k]), scales):
                assert ulp_diff(got.numpy(), np.asarray(want),
                                scale).max() <= 2, k
    assert t_state["step"] == 3


def test_bias_corrections_in_fp32():
    for step in (1, 2, 7, 1000):
        bc1, bc2 = bias_corrections(0.9, 0.999, step)
        for bc, beta in ((bc1, 0.9), (bc2, 0.999)):
            want = 1.0 - jnp.power(jnp.float32(beta), jnp.float32(step))
            assert ulp_diff(np.float32(bc), np.asarray(want)).max() <= 1
            assert np.float32(bc) == bc          # exactly an fp32 value
    assert bias_corrections(0.9, 0.999, 5, bias_correction=False) == \
        (1.0, 1.0)


def test_fma_f32_rounds_once():
    """fma_f32 against the exact rational a * b + c: the result is the
    fp32 value nearest to it (no neighbour is nearer), including cases
    built to sit a hair off an fp32 midpoint, where rounding the fp64 sum
    to nearest and then to fp32 rounds twice and lands one ulp off."""
    from fractions import Fraction
    one_ulp = 2.0 ** -23
    a_hard = float(np.float32(2.0 ** -24 * (1 + one_ulp)))
    b = [np.float32(1 - one_ulp), np.float32(1 - one_ulp)]
    c = [np.float32(1 + one_ulp), np.float32(-(1 + one_ulp))]
    rng = np.random.RandomState(4)
    b += list(rng.randn(500).astype(np.float32))
    c += list((rng.randn(500) * 10.0 ** rng.randint(-8, 3, 500))
              .astype(np.float32))
    for a in (a_hard, float(np.float32(0.01))):
        got = fma_f32(a, torch.tensor(b), torch.tensor(c)).numpy()
        for bi, ci, r in zip(b, c, got):
            exact = Fraction(a) * Fraction(float(bi)) + Fraction(float(ci))
            err = abs(Fraction(float(r)) - exact)
            for side in (np.inf, -np.inf):
                near = np.nextafter(r, np.float32(side))
                assert err <= abs(Fraction(float(near)) - exact), (a, bi, ci)
    naive = (a_hard * torch.tensor(b[:1]).double() +
             torch.tensor(c[:1]).double()).float()
    assert not torch.equal(naive, fma_f32(a_hard, torch.tensor(b[:1]),
                                          torch.tensor(c[:1])))


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    rng = np.random.RandomState(2)
    a = [rng.randn(1001).astype(np.float32) for _ in range(4)]
    a[3] = np.abs(a[3])
    left = [torch.from_numpy(x.copy()) for x in a]
    right = [torch.from_numpy(x.copy()) for x in a]
    before = fused_adam.launches
    kw = dict(HYPER, bc1=0.1, bc2=0.001)
    fused_adam(*left, **kw)
    fused_adam_reference(*right, **kw)
    assert fused_adam.launches == before
    for got, want in zip(left, right):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous fp32"):
        fused_adam(left[0], left[1].double(), left[2], left[3], **kw)


def test_fused_adam_handle_steps_flat_buffers_like_the_tree_update():
    rng = np.random.RandomState(3)
    p = rng.randn(257).astype(np.float32)
    opt = FusedAdam(lr=2e-3, weight_decay=0.05, use_kernel=False)
    flat = [torch.from_numpy(p.copy()), torch.zeros(257), torch.zeros(257)]
    tree = {"p": torch.from_numpy(p.copy())}
    state = adam_init(tree)
    for step in (1, 2):
        g = torch.from_numpy(rng.randn(257).astype(np.float32))
        opt.step_flat(flat[0], g, flat[1], flat[2], step)
        tree, state = adam_update({"p": g}, state, tree, lr=2e-3,
                                  beta1=0.9, beta2=0.999, eps=1e-8,
                                  weight_decay=0.05)
    assert torch.equal(flat[0], tree["p"])
    assert torch.equal(flat[2], state["exp_avg_sq"]["p"])
    assert FusedAdam(moments_dtype="bf16").moments_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moments_dtype"):
        FusedAdam(moments_dtype="fp16")
