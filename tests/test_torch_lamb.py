"""The port's LAMB against the JAX package, on the CPU.

The same numpy-seeded params and three steps of gradients go through the
JAX ``lamb_update`` (jitted, as the JAX engine runs it inside its apply
step), on its jnp path and on its Pallas path (``_lamb_stage1_flat`` in
interpret mode), and through the port's ``lamb_update``, whose wrappers
run their plain versions (``fused_lamb_reference``,
``fused_lamb_apply_reference``) on CPU tensors. The tree has a (16, 128)
leaf, a ragged 231-element leaf, an all-zero leaf (the trust ratio's 1.0
branch: p = 0) and a 15,000-element leaf that spans two of the kernel's
8192-element chunks. Weight decay 0.01, eps inside and outside the
square root, bias correction on and off.

Tolerances, per element:
* m and v: 1 ulp (fp32 unit in the last place) at the scale of their
  larger term (``beta1 * m`` or ``(1 - beta1) * g``; likewise for v). Both
  sides round each operation once in the same order, but XLA's CPU
  compiler may fuse a multiply and an add into one FMA;
* p: 2 ulp at the scale of the larger of |p| and the step |p' - p| (the
  FMA again, in the apply), plus 2^-20 of the step: the trust ratio's
  norms sum the leaf's squares in another order than the JAX package's
  (the port: the CUDA kernel's chunk and tree order; JAX: XLA's reduce, or
  the Pallas kernel's padded (rows, 128) blocks), which moves the ratio by
  a few ulp.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.lamb import fused_lamb as jax_lamb
from deepspeed_tpu_torch.ops.lamb import (FusedLamb, LambPlan, fused_lamb,
                                          fused_lamb_apply,
                                          fused_lamb_apply_reference,
                                          fused_lamb_reference, lamb_init,
                                          lamb_update)

tl = importlib.import_module("deepspeed_tpu_torch.ops.lamb.fused_lamb")

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
SHAPES = {"w": (16, 128), "ragged": (231,), "zero": (4, 4),
          "big": (3, 5000)}


def ulp_diff(a, b, scale):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    top = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.asarray(scale, np.float32))
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return diff / np.spacing(top).astype(np.float64)


def p_bound_ratio(got, want, before):
    """max |got - want| / (2 ulp(max(|p|, |step|)) + 2^-20 |step|)."""
    want = np.asarray(want, np.float64)
    step = np.abs(before.astype(np.float64) - want)
    top = np.maximum(np.abs(before), step).astype(np.float32)
    bound = 2 * np.spacing(top).astype(np.float64) + 2.0 ** -20 * step
    return float((np.abs(np.asarray(got, np.float64) - want) / bound).max())


@pytest.mark.parametrize("use_pallas,eps_inside_sqrt,bias_correction", [
    (False, False, True), (False, True, False), (True, False, True),
    (True, True, True), (True, False, False)])
def test_plain_lamb_matches_jitted_lamb_update(use_pallas, eps_inside_sqrt,
                                               bias_correction):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero"][:] = 0.0
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = lamb_init(t_params)
    step = jax.jit(functools.partial(
        jax_lamb.lamb_update, use_pallas=use_pallas, interpret=use_pallas,
        eps_inside_sqrt=eps_inside_sqrt, bias_correction=bias_correction))
    hyper32 = [jnp.float32(HYPER[k]) for k in
               ("lr", "beta1", "beta2", "eps", "weight_decay")]
    b1, b2 = HYPER["beta1"], HYPER["beta2"]
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in SHAPES.items()}
        before = {k: [t[k].numpy().copy() for t in (
            t_params, t_state["exp_avg"], t_state["exp_avg_sq"])]
            for k in SHAPES}
        j_state = {"step": jnp.int32(t_state["step"]),
                   "exp_avg": {k: jnp.asarray(v[1])
                               for k, v in before.items()},
                   "exp_avg_sq": {k: jnp.asarray(v[2])
                                  for k, v in before.items()}}
        j_params, j_state = step(
            {k: jnp.asarray(g) for k, g in grads.items()}, j_state,
            {k: jnp.asarray(v[0]) for k, v in before.items()}, *hyper32)
        t_params, t_state = lamb_update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, t_state,
            t_params, eps_inside_sqrt=eps_inside_sqrt,
            bias_correction=bias_correction, **HYPER)
        assert t_state["step"] == int(j_state["step"])
        for k in SHAPES:
            p0, m0, v0 = before[k]
            g = grads[k]
            m_scale = np.maximum(b1 * np.abs(m0), (1 - b1) * np.abs(g))
            v_scale = np.maximum(b2 * v0, (1 - b2) * g * g)
            assert ulp_diff(t_state["exp_avg"][k].numpy(),
                            j_state["exp_avg"][k], m_scale).max() <= 1, k
            assert ulp_diff(t_state["exp_avg_sq"][k].numpy(),
                            j_state["exp_avg_sq"][k], v_scale).max() <= 1, k
            assert p_bound_ratio(t_params[k].numpy(), j_params[k], p0) <= 1, k
    # the zero leaf took the trust-ratio-1.0 branch and still moved
    assert torch.isfinite(t_params["zero"]).all()
    assert float(t_params["zero"].abs().max()) > 0


def _flat_case(seed, segments, total):
    rng = np.random.RandomState(seed)
    p = np.zeros(total, np.float32)
    g = np.zeros(total, np.float32)
    for off, n in segments:
        p[off:off + n] = rng.randn(n)
        g[off:off + n] = rng.randn(n)
    return p, g


SEGMENTS = [(0, 100), (128, 17000), (17152, 2000), (19200, 0), (19200, 8192)]


def test_multi_segment_flat_buffer_equals_the_tree_form():
    """One flat buffer with a segment table (zero padding between
    segments, a segment of 0 elements, one of exactly one chunk, one over
    three chunks) steps bit for bit as the per-leaf tree form: the chunk
    cut and the sums' order are per segment."""
    total = 19200 + 8192 + 64
    p, g = _flat_case(1, SEGMENTS, total)
    opt = FusedLamb(lr=2e-3, weight_decay=0.05, eps_inside_sqrt=True,
                    use_kernel=False)
    flat = [torch.from_numpy(p.copy()), torch.zeros(total),
            torch.zeros(total)]
    segs = torch.tensor(SEGMENTS, dtype=torch.int64)
    leaves = {str(i): torch.from_numpy(p[off:off + n].copy())
              for i, (off, n) in enumerate(SEGMENTS)}
    state = lamb_init(leaves)
    covered = np.zeros(total, bool)
    for off, n in SEGMENTS:
        covered[off:off + n] = True
    for step in (1, 2):
        g = (np.random.RandomState(step).randn(total) * covered).astype(
            np.float32)
        opt.step_flat(flat[0], torch.from_numpy(g), flat[1], flat[2], step,
                      segments=segs)
        leaves, state = lamb_update(
            {str(i): torch.from_numpy(g[off:off + n].copy())
             for i, (off, n) in enumerate(SEGMENTS)}, state, leaves,
            lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
            eps_inside_sqrt=True)
    for i, (off, n) in enumerate(SEGMENTS):
        assert torch.equal(flat[0][off:off + n], leaves[str(i)]), i
        assert torch.equal(flat[2][off:off + n],
                           state["exp_avg_sq"][str(i)]), i
    # padding stays zero in every buffer
    for t in flat:
        assert not t[torch.from_numpy(~covered)].any()
    assert opt.plan_for(segs, torch.device("cpu")) is opt._plan[1]


def test_plan_cuts_each_segment_into_chunks():
    plan = LambPlan(SEGMENTS, "cpu")
    rows = plan.chunks.numpy()
    assert plan.n_seg == len(SEGMENTS) and plan.n_chunks == len(rows)
    assert (rows[:, 1] <= tl.CHUNK).all() and (rows[:, 1] > 0).all()
    first = plan.seg_first.numpy()
    for seg, (off, n) in enumerate(SEGMENTS):
        mine = rows[first[seg]:first[seg + 1]]
        assert (mine[:, 2] == seg).all()
        assert mine[:, 1].sum() == n
        if n:
            assert mine[0, 0] == off
            assert (np.diff(mine[:, 0]) == tl.CHUNK).all()
    assert plan.aligned and plan.extent() == 19200 + 8192


def test_plain_norms_follow_the_kernel_order_and_are_sums():
    """The plain version's norm is the kernel's order of fp32 sums: close
    to the exact sum, and different from a plain torch.sum in the last
    bits for some inputs (so the order is really fixed)."""
    rng = np.random.RandomState(5)
    sq = torch.from_numpy((rng.randn(3 * tl.CHUNK + 77) ** 2)
                          .astype(np.float32))
    total = tl._segment_total(tl._chunk_partials(sq))
    exact = float(sq.double().sum())
    assert abs(float(total) - exact) <= 1e-6 * exact
    parts = tl._chunk_partials(sq)
    assert parts.shape == (4,)
    assert float(parts[-1]) == pytest.approx(float(sq[3 * tl.CHUNK:].sum()),
                                             rel=1e-6)


def test_wrappers_run_their_plain_versions_on_cpu_tensors():
    total = 19200 + 8192
    p, g = _flat_case(2, SEGMENTS, total)
    plan = LambPlan(SEGMENTS, "cpu")
    sides = [[torch.from_numpy(p.copy()), torch.from_numpy(g.copy()),
              torch.zeros(total), torch.zeros(total)] for _ in range(2)]
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.0, bc1=0.1,
              bc2=0.001)
    before = fused_lamb.launches, fused_lamb_apply.launches
    r0, s0 = fused_lamb(*sides[0], plan, **sc)
    r1, s1 = fused_lamb_reference(*sides[1], plan, **sc)
    assert torch.equal(r0, r1) and r0.shape == (len(SEGMENTS),)
    assert torch.equal(s0, s1) and s0.shape == (len(SEGMENTS), 2)
    assert float(r0[3]) == 1.0                 # the empty segment
    kw = {k: sc[k] for k in ("eps", "weight_decay", "bc1", "bc2")}
    fused_lamb_apply(sides[0][0], sides[0][2], sides[0][3], r0, plan,
                     lr=1e-3, **kw)
    fused_lamb_apply_reference(sides[1][0], sides[1][2], sides[1][3], r1,
                               plan, lr=1e-3, **kw)
    assert (fused_lamb.launches, fused_lamb_apply.launches) == before
    for got, want in zip(*sides):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous fp32"):
        fused_lamb(sides[0][0], sides[0][1].double(), sides[0][2],
                   sides[0][3], plan, **sc)
    with pytest.raises(ValueError, match="past"):
        fused_lamb(*(t[:100] for t in sides[0]), plan, **sc)


def test_fused_lamb_handle_options():
    assert FusedLamb(moments_dtype="BF16").moments_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="moments_dtype"):
        FusedLamb(moments_dtype="fp16")
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLamb(amsgrad=True)
    opt = FusedLamb(lr=5e-3, betas=(0.8, 0.99), max_grad_norm=1.0,
                    max_coeff=2.0, min_coeff=0.5)
    assert opt.hyperparams() == {"lr": 5e-3, "beta1": 0.8, "beta2": 0.99,
                                 "eps": 1e-8, "weight_decay": 0.0}
    # max_coeff / min_coeff clip the ratio: a tiny |p| against a large
    # update takes min_coeff
    p = torch.full((64,), 1e-6)
    g = torch.ones(64)
    m, v = torch.zeros(64), torch.zeros(64)
    plan = LambPlan([(0, 64)], "cpu")
    ratio, _ = fused_lamb_reference(p, g, m, v, plan, beta1=0.8,
                                    beta2=0.99, eps=1e-8, weight_decay=0.0,
                                    bc1=0.2, bc2=0.01, max_coeff=2.0,
                                    min_coeff=0.5)
    assert float(ratio[0]) == 0.5


def test_plain_stage1_sums_are_each_segments_sums():
    """Stage 1's per-segment ``(|p|^2, |u|^2)`` are the sums over each
    segment (the kernel's order bit for bit, within 1e-6 of float64), zero
    for the empty segment, and give back the ratios it returns; tensor
    parallelism all-reduces them (``ring_ratios``)."""
    total = 19200 + 8192
    p, g = _flat_case(3, SEGMENTS, total)
    plan = LambPlan(SEGMENTS, "cpu")
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    m, v = torch.zeros(total), torch.zeros(total)
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01, bc1=0.1,
              bc2=0.001)
    ratio, sums = fused_lamb_reference(pt, gt, m, v, plan, **sc)
    assert sums.shape == (len(SEGMENTS), 2) and sums.dtype == torch.float32
    for i, (off, n) in enumerate(SEGMENTS):
        sl = slice(off, off + n)
        u = tl._direction(pt[sl], m[sl], v[sl], eps=sc["eps"],
                          weight_decay=sc["weight_decay"], bc1=sc["bc1"],
                          bc2=sc["bc2"], eps_inside_sqrt=False)
        for j, x in enumerate((pt[sl], u)):
            want = float((x.double() ** 2).sum())
            assert abs(float(sums[i, j]) - want) <= 1e-6 * want, (i, j)
            if n:
                assert float(sums[i, j]) == float(
                    tl._segment_total(tl._chunk_partials(x * x)))
    assert sums[3].tolist() == [0.0, 0.0]
    assert torch.equal(tl.trust_ratios(sums, 10.0, 0.01), ratio)
    assert plan.sharded_index(17152).tolist() == [2, 3, 4]
