"""The port's packed flash attention against the JAX package, on the CPU.

The same numpy-seeded q/k/v, key bias and output gradient go through the
JAX Pallas kernels in interpret mode (``_fwd_packed``, ``_bwd_packed``,
``fused_ln_qkv_attention``, ``flash_attention_bshd``, as
tests/unit/test_flash_sparse.py runs them) and through the port, whose
wrappers run their plain PyTorch versions on CPU tensors (the CUDA
kernels are held against those same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: fp32 forward (out and lse) 2e-6 absolute and backward 5e-6
absolute, the last bits of fp32 sums taken in another order and over
other tiles (the JAX kernels walk 128-key blocks at these lengths, the
port 64); bf16 out 2e-2 absolute, where a probability can round to the
neighbouring bf16 value when the running max differs between tilings;
the fused op's and the (b, s, h, d) op's gradients 2e-5 relative to the
largest gradient, through LayerNorm and the QKV GEMM on top.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu.ops.transformer.attention import \
    reference_causal_attention as jax_reference
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer.attention import (
    reference_causal_attention, resolve_flash_backend)
from deepspeed_tpu_torch.ops.transformer.fused_ops import fused_layer_norm

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

B, H, D = 2, 4, 32


def _case(s, bias, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, s, H * D).astype(np.float32)
                   for _ in range(4))
    kb = None
    if bias:
        kb = rng.randn(B, s).astype(np.float32)
        kb[rng.rand(B, s) < 0.2] = -1e9       # key-padding drops
        kb[:, 0] = 0.0                        # every row keeps a live key
    return q, k, v, do, kb


def _jax_bias(kb, s):
    bias = np.zeros((B, s), np.float32) if kb is None else kb
    return jfa._pad_bias(jnp.asarray(bias), B, s, min(jfa.DEFAULT_BLOCK_K, s))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


GRID = [(s, causal, bias) for s in (128, 80) for causal in (True, False)
        for bias in (False, True)]


def _jax_fwd(q, k, v, kb, s, causal, dtype=jnp.float32):
    c = lambda a: jnp.asarray(a, dtype)
    return jfa._fwd_packed(c(q), c(k), c(v), _jax_bias(kb, s), D ** -0.5,
                           causal, 256, 512, True, H)


@pytest.mark.parametrize("s,causal,bias", GRID)
def test_plain_forward_matches_jax_fwd_packed(s, causal, bias):
    q, k, v, _, kb = _case(s, bias)
    j_out, j_lse = _jax_fwd(q, k, v, kb, s, causal)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), _t(kb), num_heads=H,
                             causal=causal)
    assert out.shape == (B, s, H * D) and lse.shape == (B, s, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0,
                               atol=2e-6)


def test_plain_forward_bf16_matches_jax():
    q, k, v, _, kb = _case(128, True, seed=3)
    j_out, j_lse = _jax_fwd(q, k, v, kb, 128, True, dtype=jnp.bfloat16)
    bf = torch.bfloat16
    out, lse = tfa.flash_fwd(_t(q, bf), _t(k, bf), _t(v, bf), _t(kb),
                             num_heads=H, causal=True)
    assert out.dtype == bf
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("s,causal,bias", GRID)
def test_plain_backward_matches_jax_bwd_packed(s, causal, bias):
    q, k, v, do, kb = _case(s, bias, seed=1)
    j_out, j_lse = _jax_fwd(q, k, v, kb, s, causal)
    j_dq, j_dk, j_dv = jfa._bwd_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jax_bias(kb, s),
        j_out, jnp.asarray(do), j_lse, D ** -0.5, causal, 256, 512, True, H)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), _t(kb), num_heads=H,
                             causal=causal)
    dq, dk, dv = tfa.flash_bwd(_t(q), _t(k), _t(v), _t(kb), out, _t(do),
                               lse, num_heads=H, causal=causal)
    for got, want in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-6)


def test_wrappers_run_their_plain_versions_on_cpu_tensors():
    q, k, v, do, kb = _case(80, True, seed=2)
    counts = (tfa.flash_fwd.launches, tfa.flash_bwd_dkdv.launches,
              tfa.flash_bwd_dq.launches)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), _t(kb), num_heads=H)
    ref_out, ref_lse = tfa.flash_fwd_reference(_t(q), _t(k), _t(v), _t(kb),
                                               num_heads=H)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = tfa.attention_delta(out, _t(do), H)
    dq = tfa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(kb), _t(do), lse, delta,
                          num_heads=H)
    assert torch.equal(dq, tfa.flash_bwd_dq_reference(
        _t(q), _t(k), _t(v), _t(kb), _t(do), lse, delta, num_heads=H))
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dkdv.launches,
            tfa.flash_bwd_dq.launches) == counts


def test_wrappers_refuse_mismatched_operands():
    q, k, v, _, _ = _case(64, False)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        tfa.flash_fwd(_t(q), _t(k), _t(v), num_heads=5)
    with pytest.raises(ValueError, match="k is"):
        tfa.flash_fwd(_t(q), _t(k)[:, :32], _t(v), num_heads=H)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_fwd(_t(q), _t(k), _t(v), torch.zeros(B, 63), num_heads=H)


def _ln_qkv_case(seed=4):
    rng = np.random.RandomState(seed)
    s, hd = 128, H * D
    return dict(
        x=rng.randn(B, s, hd).astype(np.float32),
        ln_scale=(1 + 0.1 * rng.randn(hd)).astype(np.float32),
        ln_bias=(0.1 * rng.randn(hd)).astype(np.float32),
        qkv_w=(0.05 * rng.randn(hd, 3 * hd)).astype(np.float32),
        qkv_b=(0.05 * rng.randn(3 * hd)).astype(np.float32),
        w=rng.randn(B, s, hd).astype(np.float32))


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() /
                 np.abs(want).max())


def test_fused_ln_qkv_attention_grads_match_jax_and_the_dense_reference():
    c = _ln_qkv_case()
    names = ("x", "ln_scale", "ln_bias", "qkv_w", "qkv_b")

    def jax_loss(x, s_, b_, w_, bb_):
        out = jfa.fused_ln_qkv_attention(x, s_, b_, w_, bb_, H,
                                         interpret=True)
        return jnp.sum(out * c["w"])

    j_val, j_grads = jax.value_and_grad(jax_loss, argnums=range(5))(
        *(jnp.asarray(c[n]) for n in names))

    def port_grads(attention):
        ts = [torch.from_numpy(c[n]).requires_grad_() for n in names]
        out = attention(*ts)
        loss = (out * torch.from_numpy(c["w"])).sum()
        loss.backward()
        return float(loss.detach()), [t.grad.numpy() for t in ts]

    def dense(x, s_, b_, w_, bb_):
        b, s, hd = x.shape
        qkv = fused_layer_norm(x, s_, b_) @ w_ + bb_
        q, k, v = (t.reshape(b, s, H, D) for t in qkv.split(hd, dim=-1))
        return reference_causal_attention(q, k, v).reshape(b, s, hd)

    fused_val, fused = port_grads(
        lambda *ts: tfa.fused_ln_qkv_attention(*ts, num_heads=H))
    dense_val, dense_grads = port_grads(dense)
    assert abs(fused_val - float(j_val)) <= 1e-5 * abs(float(j_val))
    assert abs(dense_val - float(j_val)) <= 1e-5 * abs(float(j_val))
    for name, got, ref, want in zip(names, fused, dense_grads, j_grads):
        assert _max_rel(got, want) <= 2e-5, name
        assert _max_rel(got, ref) <= 2e-5, name


def test_flash_attention_bshd_mask_bias_matches_jax():
    rng = np.random.RandomState(5)
    s = 96
    q, k, v, w = (rng.randn(B, s, H, D).astype(np.float32) for _ in range(4))
    mask = np.where(rng.rand(B, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0

    def jax_loss(q_, k_, v_):
        out = jfa.flash_attention_bshd(q_, k_, v_, causal=False,
                                       interpret=True,
                                       mask_bias=jnp.asarray(mask))
        return jnp.sum(out * w)

    j_val, j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_bshd(*ts, causal=False,
                                   mask_bias=torch.from_numpy(mask))
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(j_val)) <= \
        1e-5 * abs(float(j_val))
    for t, want in zip(ts, j_grads):
        assert _max_rel(t.grad.numpy(), want) <= 2e-5


def test_reference_attention_matches_jax_reference():
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(B, 40, H, D).astype(np.float32) for _ in range(3))
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = reference_causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_resolve_flash_backend_on_cpu():
    assert resolve_flash_backend("auto", "cpu") == "xla"
    assert resolve_flash_backend(True, "cpu") == "xla"
    assert resolve_flash_backend("pallas", "cpu") == "pallas"
    assert resolve_flash_backend(False, "cpu") == "xla"
    with pytest.raises(ValueError):
        resolve_flash_backend("triton", "cpu")
