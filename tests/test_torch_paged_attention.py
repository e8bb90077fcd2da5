"""The port's paged-attention module against the JAX package.

``deepspeed_tpu_torch.ops.paged_attention.paged_attention`` on CPU
tensors runs its plain version (the CUDA kernel is held against that
same plain version on the card by ``chip_smoke.py``). Here it is held
against the JAX Pallas kernel in interpret mode and the JAX gather
oracle, on the same numpy inputs: NaN-poisoned garbage and unallocated
pages, live windows crossing page boundaries, layers 0 and 1, and padded
``valid_lens``. Tolerance: atol = rtol = 1e-5, the JAX package's own for
its kernel against the gather path (fp32, summation order differs).
"""
import importlib
import pathlib
import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.models.gpt2 import _attend_cache_rows
from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu_torch.ops import cuda_build
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _paged_setup(seed=0, b=3, s=2, h=2, dh=8, ps=4, max_pages=8, layers=2,
                 usable_pages=12):
    """NaN garbage page 0, NaN unallocated tail pages, random live
    content; slots at mixed lengths whose live windows cross page
    boundaries (as tests/unit/test_pallas_kernels.py builds it)."""
    rng = np.random.RandomState(seed)
    k_pool = rng.randn(usable_pages + 1, layers, h, ps, dh).astype(np.float32)
    v_pool = rng.randn(usable_pages + 1, layers, h, ps, dh).astype(np.float32)
    k_pool[0] = v_pool[0] = np.nan
    k_pool[9:] = v_pool[9:] = np.nan
    positions = np.array([5, 13, 3], np.int32)
    valid_lens = np.full((b,), s, np.int32)
    page_tables = np.zeros((b, max_pages), np.int32)
    page_tables[0, :2] = [3, 4]
    page_tables[1, :4] = [1, 2, 5, 6]
    page_tables[2, :2] = [7, 8]
    q = rng.randn(b, s, h, dh).astype(np.float32)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, page_tables=page_tables,
                positions=positions, valid_lens=valid_lens, page_size=ps)


def _args(case, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return [conv(case[k]) for k in ("q", "k_pool", "v_pool", "page_tables",
                                    "positions", "valid_lens")]


def _jax_gather_oracle(case, layer):
    q, k_pool, v_pool, pt, pos, vl = _args(case, "jax")
    b, _, h, dh = q.shape
    ps, mp = case["page_size"], pt.shape[1]

    def rows_of(cache):
        g = jnp.take(cache[:, layer], pt, axis=0)
        return g.transpose(0, 2, 1, 3, 4).reshape(b, h, mp * ps, dh)

    return np.asarray(_attend_cache_rows(q, rows_of(k_pool), rows_of(v_pool),
                                         pos, dh, valid_lens=vl))


def _port(case, layer, fn=paged_attention):
    return fn(*_args(case, "torch"), layer_idx=layer,
              page_size=case["page_size"]).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_matches_jax_kernel_and_gather_oracle(layer):
    case = _paged_setup()
    got = _port(case, layer)
    kernel = np.asarray(jax_paged_attention(
        *_args(case, "jax"), layer_idx=layer, page_size=case["page_size"],
        interpret=True))
    oracle = _jax_gather_oracle(case, layer)
    assert got.dtype == np.float32 and got.shape == case["q"].shape
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_padded_valid_lens_stay_clean(layer):
    # prefill-shaped call: only valid_lens of the s-wide chunk are real;
    # the valid rows match both JAX paths and stay finite with every
    # stale lane NaN-poisoned
    case = _paged_setup(s=4)
    case["valid_lens"] = np.array([2, 3, 1], np.int32)
    got = _port(case, layer)
    kernel = np.asarray(jax_paged_attention(
        *_args(case, "jax"), layer_idx=layer, page_size=case["page_size"],
        interpret=True))
    oracle = _jax_gather_oracle(case, layer)
    for i, n in enumerate(case["valid_lens"]):
        assert np.isfinite(got[i, :n]).all()
        np.testing.assert_allclose(got[i, :n], kernel[i, :n], **TOL)
        np.testing.assert_allclose(got[i, :n], oracle[i, :n], **TOL)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    case = _paged_setup()
    before = paged_attention.launches
    got = _port(case, 1)
    np.testing.assert_array_equal(got, _port(case, 1,
                                             paged_attention_reference))
    assert paged_attention.launches == before


@pytest.mark.parametrize("bad", [
    "q_dtype", "pool_dtype", "int64_table", "page_size", "layer",
    "noncontiguous", "table_rows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k_pool, v_pool, pt, pos, vl = _args(_paged_setup(), "torch")
    kw = dict(layer_idx=0, page_size=4)
    if bad == "q_dtype":
        q = q.double()
    elif bad == "pool_dtype":
        k_pool, v_pool = k_pool.half(), v_pool.half()
    elif bad == "int64_table":
        pt = pt.long()
    elif bad == "page_size":
        kw["page_size"] = 8
    elif bad == "layer":
        kw["layer_idx"] = 2
    elif bad == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "table_rows":
        pt = pt[:2]
    with pytest.raises(ValueError, match="paged_attention"):
        paged_attention(q, k_pool, v_pool, pt, pos, vl, **kw)


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    # a compiler that refuses the source: the build raises with its
    # stderr and leaves no library behind
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused by the test' >&2\n"
                    "exit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(cuda_build.KernelBuildError,
                       match="refused by the test"):
        cuda_build.build(pathlib.Path(__file__))
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
        cuda_build.nvcc_path()


@pytest.mark.parametrize("element_size,dh,table_keys", [
    (2, 64, 1024), (2, 64, 16), (2, 256, 2048), (4, 256, 768),
    (4, 32, 20), (2, 16, 32768), (4, 128, 1)])
def test_launch_plan_covers_the_table(element_size, dh, table_keys):
    """The kernel's splits cover the page table's width with no split past
    its end, at most MAX_SPLITS of them, each round's K and V rows within
    STAGE_BYTES (or the smallest round of 16 keys)."""
    pam = importlib.import_module(
        "deepspeed_tpu_torch.ops.paged_attention.paged_attention")
    chunk, rounds, splits = pam.launch_plan(element_size, dh, table_keys)
    run = chunk * rounds
    assert chunk & (chunk - 1) == 0 and 16 <= chunk <= 256
    assert 2 * chunk * dh * element_size <= pam.STAGE_BYTES or chunk == 16
    assert 1 <= splits <= pam.MAX_SPLITS
    assert splits * run >= table_keys > (splits - 1) * run
