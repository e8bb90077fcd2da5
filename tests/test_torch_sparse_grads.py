"""The sparse embedding-gradient exchange and the CSR tensor in the port,
held against the JAX package's functions on the same numpy inputs.

* ``ops/sparse_grads.py::sparse_embedding_lookup``: the cases of
  ``tests/unit/test_sparse_grads.py`` (gradients against the dense
  lookup's, duplicate ids within and across ranks, the fallbacks) at
  world 2 and 4 in gloo processes (``torch_dp_workers.sparse_lookup``),
  each rank with its rows of the batch the JAX function takes whole on
  ``build_mesh(data=8)``. Each rank's table gradient is the gathered sum
  divided by the world, so ``world`` times it is the JAX gradient of the
  whole batch's loss: held within 1e-5 (relative and absolute, the unit
  test's); the lookup's output within 1e-6 of the dense one.
* the GPT-2 engine with ``sparse_embedding_grads`` and the ds_config
  ``sparse_gradients`` section at DP 2 (fp32, stage 0; and bf16, stage
  2) against the dense lookup: losses within 1e-5 (fp32) and 5e-4 (bf16)
  relative, fp32 masters within 5e-5 absolute; the engine records
  ``{"wte"}`` as the JAX engine does, and warns at one rank.
* ``runtime/csr_tensor.py``: ``tests/unit/test_csr.py``'s four cases,
  each against the JAX ``CSRTensor`` on the same numpy input.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.ops.sparse_grads import \
    sparse_embedding_lookup as j_lookup
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime import csr_tensor as jcsr
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.sparse_grads import sparse_embedding_lookup
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.runtime import csr_tensor as tcsr
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_dp_workers as workers

pytestmark = pytest.mark.torch_port

GRAD_TOL = 1e-5
MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)


def _lookup_cases():
    """test_sparse_grads.py's two exchange cases: random ids with the
    sum(out * cos(out)) loss, and every id 7 with sum(out)."""
    rng = np.random.RandomState(0)
    wte = rng.randn(64, 16).astype(np.float32)
    ids = rng.randint(0, 64, size=(8, 12)).astype(np.int64)
    dup = np.full((8, 4), 7, np.int64)
    wte1 = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    return [(wte, ids, "sum_cos"), (wte1, dup, "sum")]


@pytest.fixture(scope="module")
def jax_lookup():
    mesh = j_build_mesh(data=8)
    out = []
    for wte, ids, loss in _lookup_cases():
        ids_j = jnp.asarray(ids, jnp.int32)

        def f(w, fn):
            y = fn(w)
            return jnp.sum(y * jnp.cos(y)) if loss == "sum_cos" \
                else y.sum()

        sparse = lambda w: j_lookup(w, ids_j, mesh=mesh)
        out.append({"out": np.asarray(sparse(jnp.asarray(wte))),
                    "grad": np.asarray(jax.grad(f)(jnp.asarray(wte),
                                                   sparse))})
    return out


@pytest.fixture(scope="module")
def port_lookup():
    return {world: spawn(workers.sparse_lookup, world,
                         args=(_lookup_cases(),), timeout_s=90)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_lookup_grads_match_dense(jax_lookup, port_lookup, world):
    (wte, ids, _), want = _lookup_cases()[0], jax_lookup[0]
    rows = ids.shape[0] // world
    for rank, res in enumerate(port_lookup[world]):
        res = res[0]
        assert res["sparse_exchanged"] and not res["dense_exchanged"]
        np.testing.assert_allclose(res["sparse"], res["dense"], rtol=1e-6)
        np.testing.assert_allclose(
            res["sparse"], want["out"][rank * rows:(rank + 1) * rows],
            rtol=1e-6)
        np.testing.assert_allclose(world * res["sparse_grad"], want["grad"],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    # the dense lookups' gradients summed over the ranks are the JAX one
    np.testing.assert_allclose(
        sum(r[0]["dense_grad"] for r in port_lookup[world]), want["grad"],
        rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_lookup_handles_duplicate_ids(jax_lookup, port_lookup,
                                             world):
    """Duplicate ids within and across ranks scatter-add: every position
    is token 7, so its row of the whole batch's gradient is 32."""
    expect = np.zeros((32, 8), np.float32)
    expect[7] = 32.0
    np.testing.assert_allclose(jax_lookup[1]["grad"], expect, rtol=1e-6)
    for res in port_lookup[world]:
        np.testing.assert_allclose(world * res[1]["sparse_grad"], expect,
                                   rtol=1e-6)


def test_sparse_lookup_falls_back_off_mesh():
    """No mesh or a trivial data axis -> the plain lookup (a dense
    gradient), as the JAX function's fallbacks (there also for a batch
    the axis does not divide: here each rank passes its own rows)."""
    wte = np.ones((16, 4), np.float32)
    ids = np.zeros((3, 2), np.int64)
    want = np.asarray(j_lookup(jnp.asarray(wte), jnp.asarray(ids, jnp.int32),
                               mesh=j_build_mesh(data=8)))
    for mesh in (None, build_mesh()):
        w = torch.from_numpy(wte).requires_grad_(True)
        out = sparse_embedding_lookup(w, torch.from_numpy(ids), mesh=mesh)
        assert out.shape == (3, 2, 4)
        assert "SparseLookup" not in type(out.grad_fn).__name__
        np.testing.assert_array_equal(out.detach().numpy(), want)


@pytest.fixture(scope="module")
def engine_runs():
    ids = np.random.RandomState(0).randint(0, 128, size=(1, 4, 32))
    specs = []
    for prec, stage in (("fp32", 0), ("bf16", 2)):
        for sparse in (True, False):
            specs.append(dict(model=MODEL, seed=0, data=2, prec=prec,
                              stage=stage, micro=2, batch=(ids, ids),
                              steps=3, sparse_embedding_grads=sparse,
                              sparse_gradients=sparse))
    return spawn(workers.dp_engine, 2, args=(specs,), timeout_s=120)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_gpt2_sparse_embedding_grads_match_dense(engine_runs, prec):
    i = 0 if prec == "fp32" else 2
    for rank in engine_runs:
        sparse, dense = rank[i], rank[i + 1]
        assert sparse["csr"] == ["wte"] and dense["csr"] == []
        np.testing.assert_allclose(sparse["losses"], dense["losses"],
                                   rtol=1e-5 if prec == "fp32" else 5e-4)
        assert sparse["losses"][-1] < sparse["losses"][0]
        if prec == "fp32":
            want = dict(workers_leaves(dense["master"]))
            for name, got in workers_leaves(sparse["master"]):
                assert np.abs(got - want[name]).max() <= 5e-5, name


def workers_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from workers_leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from workers_leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def test_sparse_gradients_section_warns_without_a_live_exchange(caplog):
    """At one rank the section parses and the engine warns, as the JAX
    engine: the model routes no embedding through the exchange."""
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
        **MODEL, sparse_embedding_grads=True))
    logger = logging.getLogger("DeepSpeedTPUTorch")
    logger.addHandler(caplog.handler)
    try:
        engine = deepspeed_tpu_torch.initialize(
            model=model, config_params={
                "train_micro_batch_size_per_gpu": 2,
                "sparse_gradients": True, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
            device="cpu")[0]
    finally:
        logger.removeHandler(caplog.handler)
    assert engine.sparse_gradients_enabled()
    assert engine.csr_tensor_module_names == set()
    text = caplog.text
    assert "no nontrivial 'data' axis" in text and "stay dense" in text


def _sparse_dense(rs, rows=32, cols=8, active=5):
    dense = np.zeros((rows, cols), dtype=np.float32)
    idx = rs.choice(rows, size=active, replace=False)
    dense[idx] = rs.randn(active, cols)
    return dense


def test_csr_from_dense_roundtrip():
    dense = _sparse_dense(np.random.RandomState(0))
    got, want = tcsr.CSRTensor.from_dense(dense), \
        jcsr.CSRTensor.from_dense(dense)
    assert got.sparse_size() == want.sparse_size() == (5 * 8, 32 * 8)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)


def test_csr_empty():
    zeros = np.zeros((16, 4), dtype=np.float32)
    got, want = tcsr.CSRTensor.from_dense(zeros), \
        jcsr.CSRTensor.from_dense(zeros)
    assert got.sparse_size()[0] == want.sparse_size()[0] == 0
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


def test_csr_add():
    rs = np.random.RandomState(1)
    a, b = _sparse_dense(rs), _sparse_dense(rs)
    got = tcsr.CSRTensor.from_dense(a).add(tcsr.CSRTensor.from_dense(b))
    want = jcsr.CSRTensor.from_dense(a).add(jcsr.CSRTensor.from_dense(b))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    np.testing.assert_allclose(got.to_dense().numpy(), a + b, atol=1e-6)


def test_csr_all_gather_concat_sums_ranks():
    rs = np.random.RandomState(2)
    shards = [_sparse_dense(rs) for _ in range(4)]
    got = tcsr.all_gather_concat([tcsr.CSRTensor.from_dense(s)
                                  for s in shards])
    want = jcsr.all_gather_concat([jcsr.CSRTensor.from_dense(s)
                                   for s in shards])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), sum(shards), atol=1e-6)
