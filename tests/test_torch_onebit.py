"""The port's 1-bit exchange (``deepspeed_tpu_torch/runtime/comm/onebit.py``
and ``compressed.py``) held against the JAX package's bodies on the same
numpy-seeded per-rank inputs, and the reference's backend checks
(``tests/unit/test_onebit.py``) on the port.

The port's ranks are gloo processes on the CPU (``torch_comm_workers``),
one spawn for each world size with a deadline; the JAX bodies run in
``shard_map`` on the forced host devices. Tolerances:

* the scales ``||x|| / sqrt(n)``: the port sums the squares in fp64, XLA
  in fp32 in its own order: worker and server scales within
  ``SCALE_RTOL`` (1e-6) relative;
* the worker phase's chunk average (sums of +-scale) within ``SCALE_RTOL``
  of the largest scale; the sign bytes equal, so the new worker errors
  within ``SCALE_RTOL`` of the scale;
* the server phase re-signs ``chunk_mean + server_error``: a lane whose
  value lies within ``SIGN_ATOL`` (1e-5) of 0 in the JAX run may flip; on
  every other lane the averaged result and the new server error agree
  within ``SCALE_RTOL`` of the server scale. A control (the JAX run with
  the worker error zeroed) breaks the result check;
* the bytes each rank hands to ``torch.distributed`` equal
  ``onebit_exchange_bytes``.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.parallel.topology import shard_map_compat
from deepspeed_tpu.runtime.comm import CompressedBackend as JBackend
from deepspeed_tpu.runtime.comm import onebit as jo
from deepspeed_tpu_torch.runtime.comm import onebit as to
from deepspeed_tpu_torch.runtime.comm import pack_signs, unpack_signs
from deepspeed_tpu_torch.runtime.comm.wire import onebit_exchange_bytes
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_comm_workers as workers

pytestmark = pytest.mark.torch_port

SCALE_RTOL = 1e-6
SIGN_ATOL = 1e-5


def _onebit_case(world, seed, numel, padded):
    rng = np.random.RandomState(seed)
    x = rng.randn(world, padded).astype(np.float32)
    x[:, numel:] = 0.0
    we = (rng.randn(world, padded) * 0.3).astype(np.float32)
    we[:, numel:] = 0.0
    se = (rng.randn(world, padded // world) * 0.1).astype(np.float32)
    # the server error of pad lanes is zero (the last rank's chunk tail)
    tail = (np.arange(padded).reshape(world, -1) >= numel)
    se[tail] = 0.0
    return dict(kind="onebit", x=x, we=we, se=se, real_size=numel)


def _cases(world):
    padded = to.onebit_padded_size(1000, world)
    cases = [_onebit_case(world, 100 + world, 1000, padded),
             _onebit_case(world, 200 + world, padded, padded)]
    if world == 4:
        # a rank whose whole chunk is padding (count 0, scale 0)
        cases.append(_onebit_case(world, 300, 8 * 3 * 10, 8 * 4 * 10))
    rng = np.random.RandomState(400 + world)
    cases.append(dict(kind="backend",
                      x=rng.randn(world, 1000).astype(np.float32)))
    return cases


@pytest.fixture(scope="module")
def port_runs():
    """Per world size the port's ranks' results (one spawn each, side by
    side); the JAX bodies compile meanwhile."""
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(spawn, workers.exchanges, w,
                                  args=(_cases(w),), timeout_s=120)
                   for w in (2, 4)}
        for w in (2, 4):
            for case in _cases(w):
                if case["kind"] == "onebit":
                    _jax_onebit(case, w)
        return {w: f.result() for w, f in futures.items()}


@functools.lru_cache(maxsize=None)
def _jax_onebit_fn(world, real):
    """The JAX bodies compiled once per world and real-lane count."""
    mesh = j_build_mesh(data=world)

    def body(x, we, se):
        res, nwe, nse = jo.compressed_allreduce_local(
            x[0], we[0], se[0], "data", world, real)
        mean, _, _, _ = jo.onebit_reduce_scatter_local(x[0], we[0], "data",
                                                       world, real)
        return res[None], nwe[None], nse[None], mean[None]

    return jax.jit(shard_map_compat(body, mesh=mesh,
                                    in_specs=(P("data"),) * 3,
                                    out_specs=(P("data"),) * 4))


def _jax_onebit(case, world):
    out = _jax_onebit_fn(world, case["real_size"])(
        jnp.asarray(case["x"]), jnp.asarray(case["we"]),
        jnp.asarray(case["se"]))
    return [np.asarray(o) for o in out]


CASE_IDS = [(w, i) for w in (2, 4) for i in range(len(_cases(w)))
            if _cases(w)[i]["kind"] == "onebit"]


@pytest.mark.parametrize("world,index", CASE_IDS)
def test_compressed_allreduce_matches_jax(port_runs, world, index):
    case = _cases(world)[index]
    ranks = [r[index] for r in port_runs[world]]
    res_j, we_j, se_j, mean_j = _jax_onebit(case, world)
    real = case["real_size"]
    x_corr = case["x"] + case["we"]
    wscale = np.linalg.norm(x_corr[:, :real], axis=1) / np.sqrt(real)
    for rank, r in enumerate(ranks):
        # the worker phase: chunk averages and new worker errors
        tol = SCALE_RTOL * wscale.max()
        np.testing.assert_allclose(r["chunk_mean"], mean_j[rank], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(r["we"], we_j[rank], rtol=0,
                                   atol=SCALE_RTOL * wscale[rank])
        assert not r["we"][real:].any()
        # the server phase: off lanes near 0, equal within the tolerance
        server_in = (mean_j + case["se"]).reshape(-1)
        far = np.abs(server_in) > SIGN_ATOL
        sscale = np.abs(res_j[0]).max()
        diff = np.abs(r["out"] - res_j[rank])
        assert (diff[far] <= SCALE_RTOL * sscale).all(), diff[far].max()
        chunk = len(r["se"])
        own = slice(rank * chunk, (rank + 1) * chunk)
        np.testing.assert_allclose(r["se"][far[own]],
                                   se_j[rank][far[own]], rtol=0,
                                   atol=SCALE_RTOL * sscale)
        assert not r["out"][real:].any()
        assert r["wire_bytes"] == onebit_exchange_bytes(
            case["x"].shape[1], world), r["wire_bytes"]
    # every rank the same averaged buffer
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    # control: without the worker error the results disagree
    ctrl = dict(case, we=np.zeros_like(case["we"]))
    res_c = _jax_onebit(ctrl, world)[0]
    assert np.abs(ranks[0]["out"] - res_c[0]).max() > SCALE_RTOL * sscale


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_backend_matches_jax(port_runs, world):
    index = len(_cases(world)) - 1
    x = _cases(world)[index]["x"]
    ranks = [r[index] for r in port_runs[world]]
    out, we, se = JBackend(j_build_mesh(data=world)).compressed_allreduce(
        jnp.asarray(x))
    out = np.asarray(out)
    scale = np.abs(out).max()
    for rank, r in enumerate(ranks):
        assert r["out"].shape == (1000,)
        assert r["we"].shape == (to.onebit_padded_size(1000, world),)
        assert r["se"].shape == (to.onebit_padded_size(1000, world) //
                                 world,)
        # the average agrees but for lanes re-signed near 0 (1-bit)
        close = np.abs(r["out"] - out[rank]) <= SCALE_RTOL * scale
        assert close.mean() > 0.99, close.mean()
    # the single shot correlates with the true mean (the reference check)
    corr = np.corrcoef(ranks[0]["out"], x.mean(axis=0))[0, 1]
    assert corr > 0.5, corr


def test_pack_unpack_roundtrip():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(256).astype(np.float32))
    packed = pack_signs(x)
    assert packed.dtype == torch.uint8 and packed.numel() == 32
    signs = unpack_signs(packed, torch.tensor(1.0))
    np.testing.assert_array_equal(signs.numpy(),
                                  np.where(x.numpy() >= 0, 1.0, -1.0))


def test_small_buffer_quantization_unbiased():
    """``tests/unit/test_onebit.py::test_onebit_small_buffer_quantization_
    unbiased`` on the port: two real lanes padded to 8, the two-stage
    compression telescopes to the true value and pad lanes keep zero
    error."""
    def two_stage(x, we, se):
        n, padded = x.numel(), we.numel()
        flat = torch.nn.functional.pad(x, (0, padded - n))
        mask = (torch.arange(padded) < n).float()
        _, _, worker_q, nwe = to.masked_compress(flat + we, mask,
                                                 np.float32(n))
        _, _, server_q, nse = to.masked_compress(worker_q + se, mask,
                                                 np.float32(n))
        return server_q[:n], nwe, nse

    x = torch.tensor([0.5, -0.3])
    we, se = torch.zeros(8), torch.zeros(8)
    acc = np.zeros(2)
    for _ in range(50):
        out, we, se = two_stage(x, we, se)
        acc += out.numpy()
    np.testing.assert_allclose(acc / 50, [0.5, -0.3], atol=0.05)
    np.testing.assert_array_equal(we[2:].numpy(), 0.0)


def test_onebit_adam_rejects_zero3():
    import deepspeed_tpu_torch
    from torch_comm_workers import Quadratic
    config = {"train_micro_batch_size_per_gpu": 8,
              "optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-2}},
              "bf16": {"enabled": True}, "zero_optimization": {"stage": 3}}
    with pytest.raises(ValueError, match="not compatible with ZeRO"):
        deepspeed_tpu_torch.initialize(model=Quadratic(),
                                       config_params=config, device="cpu")
