"""The port's ring GEMMs (``parallel/collective_matmul.py``,
``ops/ring_gemm``) held against the JAX package's collective matmul.

The port's ranks are gloo processes on the CPU, spawned once per world
size for the whole module (``utils.distributed.spawn``, with a deadline:
a hung ring fails in seconds). They import no JAX (``torch_tp_workers``).
The JAX side runs here on the 8-device CPU mesh, its Pallas ring kernels
in interpret mode (backend ``"pallas"``) and its ppermute loops; on the
port's CPU tensors the kernel wrappers run their plain versions.

Tolerances, at fp32:
* forward, 1e-6 relative (and 1e-6 of the output's scale absolute): the
  same products, summed by another BLAS in another order;
* gradients, the JAX package's own ``TOL_GRAD`` (1e-4) between its two
  backends;
* the bf16 wire policy, the JAX package's own 1e-5 between its backends:
  the casts happen at the same points.
"""
import logging
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from deepspeed_tpu.parallel.collective_matmul import (
    CollectiveMatmulBinding as JBinding, tp_column_matmul as j_column,
    tp_row_matmul as j_row)
from deepspeed_tpu.runtime.comm import config as jcomm
from deepspeed_tpu_torch.ops import ring_gemm as rg
from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm
from deepspeed_tpu_torch.parallel import collective_matmul as tcm
from deepspeed_tpu_torch.runtime.comm import config as tcomm
from deepspeed_tpu_torch.utils.distributed import SpawnError, spawn

import torch_tp_workers as workers

pytestmark = pytest.mark.torch_port

FWD_TOL = 1e-6
TOL_GRAD = dict(atol=1e-4, rtol=1e-4)      # test_pallas_kernels.py:271
WIRE_TOL = dict(atol=1e-5, rtol=1e-5)      # test_pallas_kernels.py:329
WORLDS = (2, 4)
BACKENDS = ("pallas", "ppermute")


def _cases(n):
    """The JAX package's ring-GEMM test shapes (test_pallas_kernels.py
    :281-330), as numpy: (kind, x, w, wire policy, with gradients)."""
    f32 = np.float32
    r = np.random.RandomState(3)
    col = (r.randn(2, 8, 16).astype(f32), r.randn(16, 8 * n).astype(f32))
    r = np.random.RandomState(4)
    row = (r.randn(2, 8, 8 * n).astype(f32), r.randn(8 * n, 16).astype(f32))
    r = np.random.RandomState(5)
    col_bwd = (r.randn(1, 8, 8).astype(f32), r.randn(8, 8 * n).astype(f32))
    r = np.random.RandomState(5)
    row_bwd = (r.randn(1, 8, 8 * n).astype(f32),
               r.randn(8 * n, 8).astype(f32))
    r = np.random.RandomState(6)
    wire = (r.randn(2, 8, 16).astype(f32), r.randn(16, 16).astype(f32))
    return {"column_fwd": ("column",) + col + ("compute", False),
            "row_fwd": ("row",) + row + ("compute", False),
            "column_bwd": ("column",) + col_bwd + ("compute", True),
            "row_bwd": ("row",) + row_bwd + ("compute", True),
            "column_wire": ("column",) + wire + ("bf16", False)}


@pytest.fixture(scope="module")
def ring_runs():
    """world -> (cases, per-rank results), one spawn per world."""
    return {n: (_cases(n), spawn(workers.ring_ops, n, args=(_cases(n),),
                                 timeout_s=120))
            for n in WORLDS}


_MESHES = {}


def _jbinding(n, backend, dtype="compute"):
    if n not in _MESHES:
        _MESHES[n] = Mesh(np.array(jax.devices()[:n]).reshape(n), ("model",))
    return JBinding(mesh=_MESHES[n], axis="model", backend=backend,
                    dtype=dtype)


def _assemble(kind, per_rank, key):
    """The global array from every rank's piece of ``key``."""
    axis = {("column", "y"): -1, ("column", "dx"): -2, ("column", "dw"): 1,
            ("row", "y"): -2, ("row", "dx"): -1, ("row", "dw"): 0}[
                (kind, key)]
    return np.concatenate([r[key] for r in per_rank], axis=axis)


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["column_fwd", "row_fwd"])
def test_forward_matches_jax(ring_runs, n, backend, case):
    cases, ranks = ring_runs[n]
    kind, x, w, _, _ = cases[case]
    got = _assemble(kind, [r[(backend, case)] for r in ranks], "y")
    op = j_column if kind == "column" else j_row
    for jbackend in BACKENDS:
        want = np.asarray(op(x, w, _jbinding(n, jbackend)))
        _close(got, want, FWD_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["column_bwd", "row_bwd"])
def test_gradients_match_jax_grad(ring_runs, n, backend, case):
    cases, ranks = ring_runs[n]
    kind, x, w, _, _ = cases[case]
    op = j_column if kind == "column" else j_row
    want = jax.grad(lambda x, w: (op(x, w, _jbinding(n, "pallas")) ** 2)
                    .sum(), argnums=(0, 1))(x, w)
    per_rank = [r[(backend, case)] for r in ranks]
    for key, jw in zip(("dx", "dw"), want):
        np.testing.assert_allclose(_assemble(kind, per_rank, key),
                                   np.asarray(jw), **TOL_GRAD)
    # the forward of the same case too
    _close(_assemble(kind, per_rank, "y"),
           np.asarray(op(x, w, _jbinding(n, "ppermute"))), FWD_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_wire_policy_matches_jax(ring_runs, backend):
    cases, ranks = ring_runs[4]
    kind, x, w, policy, _ = cases["column_wire"]
    got = _assemble(kind, [r[(backend, "column_wire")] for r in ranks], "y")
    for jbackend in BACKENDS:
        want = np.asarray(j_column(x, w, _jbinding(4, jbackend, policy)))
        np.testing.assert_allclose(got, want, **WIRE_TOL)
    # a bf16-grade approximation of the exact product, not the product
    np.testing.assert_allclose(got, x @ w, atol=0.3, rtol=0.05)
    assert not np.array_equal(got, (torch.from_numpy(x) @
                                    torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_rank4_input_warns_once_and_runs_the_ppermute_loop(ring_runs, n):
    """A rank-4 x on backend "pallas" folds its leading dims into the
    batch and runs the kernel loop: no warning, one kernel-wrapper call a
    ring step (two ops of n steps each), the same numbers as the ppermute
    loop and within FWD_TOL of the JAX package."""
    cases, ranks = ring_runs[n]
    kind, x, w, _, _ = cases["column_fwd"]
    got = _assemble(kind, [r["rank4"] for r in ranks], "y")
    for jbackend in BACKENDS:
        _close(got, np.asarray(j_column(x, w, _jbinding(n, jbackend))),
               FWD_TOL)
    for r in ranks:
        assert r["rank4"]["warnings"] == 0
        assert r["rank4"]["kernel_steps"] == 2 * n
        np.testing.assert_array_equal(r["rank4"]["y"],
                                      r[("ppermute", "column_fwd")]["y"])


def test_ring_of_one_is_the_plain_matmul():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for backend in BACKENDS:
        bind = tcm.CollectiveMatmulBinding(group=None, backend=backend)
        assert bind.size == 1
        for op, jop in ((tcm.tp_column_matmul, j_column),
                        (tcm.tp_row_matmul, j_row)):
            got = op(xt, wt, bind).numpy()
            np.testing.assert_array_equal(got, (xt @ wt).numpy())
            _close(got, np.asarray(jop(x, w, _jbinding(1, backend))),
                   FWD_TOL)
    assert tcm.tp_column_matmul(xt, wt, None).equal(xt @ wt)


def test_ring_step_wrappers_run_their_plain_versions_on_the_cpu():
    rng = np.random.RandomState(8)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    cur, w = t(2, 3, 5), t(5, 7)
    before = rg.ring_ag_gemm.launches
    out = torch.zeros(2, 9, 7)
    rg.ring_ag_gemm(cur, w.t().contiguous().t(), out, 1)
    torch.testing.assert_close(out[:, 3:6], cur @ w, rtol=1e-6, atol=1e-6)
    assert out[:, :3].eq(0).all() and out[:, 6:].eq(0).all()
    x, w2, recv = t(2, 6, 4), t(4, 5), t(2, 3, 5)
    out = torch.empty(2, 3, 5)
    rg.ring_rs_gemm_add(x, w2, 1, 2, out, recv)
    assert torch.equal(out, recv + x[:, 3:] @ w2)
    fixed = t(2, 6, 4)
    acc = torch.full((5, 4), float("nan"))
    rg.ring_gc_gemm_acc(cur, fixed, 0, acc, True)
    rg.ring_gc_gemm_acc(cur, fixed, 1, acc, False)
    want = cur.reshape(-1, 5).t() @ fixed[:, :3].reshape(-1, 4) + \
        cur.reshape(-1, 5).t() @ fixed[:, 3:].reshape(-1, 4)
    torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-6)
    acc_t = torch.empty(4, 5)
    rg.ring_gc_gemm_acc(cur, fixed, 0, acc_t, True, rot_is_lhs=False)
    torch.testing.assert_close(acc_t, (cur.reshape(-1, 5).t() @
                                       fixed[:, :3].reshape(-1, 4)).t())
    # a CPU tensor never counts as a launch
    assert rg.ring_ag_gemm.launches == before
    with pytest.raises(ValueError):
        rg.ring_ag_gemm(cur, w, torch.zeros(2, 8, 7), 0)    # 8 % 3


def test_ring_rotate_chunks_and_wire():
    res = spawn(workers.rotate, 3, args=((1, 2, 5),), timeout_s=60)
    for idx, per_chunks in enumerate(res):
        left = (idx - 1) % 3
        want = np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * left + \
            0.001
        for exact, wire in per_chunks.values():
            np.testing.assert_array_equal(exact, want)
            np.testing.assert_array_equal(wire, torch.from_numpy(want).to(
                torch.bfloat16).float().numpy())


def test_spawn_deadline_kills_a_hung_ring_and_reports_a_failing_rank():
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="did not finish"):
        spawn(workers.hang, 2, timeout_s=5)
    assert time.monotonic() - t0 < 20
    with pytest.raises(SpawnError, match="rank 1 fails on purpose"):
        spawn(workers.fail, 2, timeout_s=60)


# ---------------------------------------------------------------- config


COMM_CASES = {
    "defaults": ({}, None),
    "on": ({"collective_matmul": {"enabled": True, "chunks": 4,
                                  "dtype": "bf16"}}, None),
    "pallas": ({"collective_matmul": {"backend": "pallas"}}, None),
    "chunks_0": ({"collective_matmul": {"enabled": True, "chunks": 0}},
                 ValueError),
    "dtype_fp8": ({"collective_matmul": {"enabled": True, "dtype": "fp8"}},
                  ValueError),
    "backend_nccl": ({"collective_matmul": {"backend": "nccl"}}, ValueError),
    "unknown_warns": ({"collective_matmul": {"enabled": True, "bogus": 1}},
                      None),
    "unknown_strict": ({"collective_matmul": {"enabled": True,
                                              "strict": True, "bogus": 1}},
                       ValueError),
    "inert_pallas_strict": ({"collective_matmul": {
        "enabled": True, "backend": "pallas", "tensor_parallel": False,
        "strict": True}}, ValueError),
    "qc_bad_block": ({"quantized_collectives": {"block_size": 4}},
                     ValueError),
    "qc_cuda_aware": ({"quantized_collectives": {"cuda_aware": True}},
                      ValueError),
}


@pytest.mark.parametrize("name", sorted(COMM_CASES))
def test_comm_section_parses_and_validates_as_jax(name):
    section, err = COMM_CASES[name]
    param = {"comm": section}
    if err is not None:
        for module in (jcomm, tcomm):
            with pytest.raises(err):
                module.DeepSpeedCommConfig(param)
        return
    j = jcomm.DeepSpeedCommConfig(param).collective_matmul
    t = tcomm.DeepSpeedCommConfig(param).collective_matmul
    for key in ("enabled", "tensor_parallel", "zero_gather", "chunks",
                "dtype", "backend", "strict"):
        assert getattr(t, key) == getattr(j, key), key


def test_quantized_collectives_enabled_names_its_later_slice():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcomm.DeepSpeedCommConfig(
            {"comm": {"quantized_collectives": {"enabled": True}}})


def test_unknown_collective_matmul_key_warns(caplog):
    logger = logging.getLogger("DeepSpeedTPUTorch")
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    try:
        tcomm.DeepSpeedCommConfig(
            {"comm": {"collective_matmul": {"enabled": True, "bogus": 1}}})
    finally:
        logger.removeHandler(handler)
    assert any("bogus" in m and "NO effect" in m for m in seen)


# gpt2_medium TP 2's dW sites (chip_smoke.RING_SITES): (M, N) of the
# output over K = b * s_loc = 16 * 512 rows, and the splits the design
# gives them: the attention-projection and qkv outputs leave SMs idle
GC_SITES = {"qkv_dw": ((1024, 1536), 2), "fc_dw": ((1024, 2048), 1),
            "attn_proj_dw": ((512, 1024), 5),
            "mlp_proj_dw": ((2048, 1024), 1)}


@pytest.mark.parametrize("M,N,K,sm", [
    (1024, 1536, 8192, 132), (512, 1024, 8192, 132), (100, 70, 8192, 132),
    (64, 64, 777, 132), (130, 260, 5000, 132), (4096, 4096, 8192, 132),
    (512, 1024, 8192, 16), (300, 300, 1, 132), (128, 128, 3000, 132),
    (600, 700, 1000, 132)])
def test_gc_plan_splits_cover_k_and_fill_the_card(M, N, K, sm):
    """The bf16 dW kernel's plan: its splits cover K exactly in runs of a
    multiple of the k step (the last takes the rest, never empty); no
    split where the tiles fill nine tenths of the SMs, else as many as
    cover them, unless a run would fall under GC_MIN_SPLIT_K rows."""
    plan = rgm.gc_plan(M, N, K, sm)
    splits, k_split, tiles = plan["splits"], plan["k_split"], plan["tiles"]
    assert tiles == -(-M // rgm.GC_TILE) * -(-N // rgm.GC_TILE)
    assert k_split % rgm.GC_K_STEP == 0 and splits >= 1
    assert (splits - 1) * k_split < K <= splits * k_split
    runs = [min(k_split, K - z * k_split) for z in range(splits)]
    assert sum(runs) == K and min(runs) > 0
    assert splits == 1 or min(runs[:-1]) >= rgm.GC_MIN_SPLIT_K
    if 10 * tiles >= 9 * sm:              # the tiles alone fill the card
        assert splits == 1
    else:                                 # split until the grid covers it
        want = max(1, min(-(-sm // tiles), K // rgm.GC_MIN_SPLIT_K))
        assert want - 1 <= splits <= want   # runs rounded to the k step
        assert tiles * splits >= sm or splits == want


@pytest.mark.parametrize("site", sorted(GC_SITES))
def test_gc_plan_at_the_tensor_parallel_dw_sites(site):
    (M, N), splits = GC_SITES[site]
    plan = rgm.gc_plan(M, N, 16 * 512, rgm.H100_SMS)
    assert plan["splits"] == splits, plan
    assert plan["tiles"] * plan["splits"] >= rgm.H100_SMS * 0.9
