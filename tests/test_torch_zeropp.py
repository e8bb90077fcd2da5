"""ZeRO++ in the port at a data degree of 2 (``runtime/zero/zeropp.py``):
the shape-preserving codec, the quantized reduce-scatter, qwZ's unit
gather, qgZ, their refusals and warnings, the wire census and qgZ's
checkpoint state, held to the JAX package.

The port's ranks are two gloo processes on the CPU (one spawn for the
module, ``torch_zero3_workers``), on the tiny GPT-2 of
``test_torch_zero3.py`` (2 layers, d 64, vocabulary 128, seq 32, bf16,
Adam, micro 2, two micro-steps a step, 3 steps, persistence threshold
1000); the JAX engine runs on ``build_mesh(data=2)``. Checks:

* the codec (``quantize_param`` / ``dequantize_param``) equals the JAX
  package's jitted one bit for bit at last dimensions 1600, 4800, 600 and
  1024, an all-zero block included, bf16 and fp32; so does
  ``quantized_reduce_scatter_local`` (with and without error feedback);
* qwZ's gathered unit equals ``dequantize_param(*quantize_param(leaf))``
  of the JAX codec bit for bit where a piece boundary falls inside a
  block (leaves of last dimension 1600 and 600);
* the ring gather equals the plain gather bit for bit (losses, masters),
  and its next unit's ring was posted ahead;
* qwZ and qgZ follow the JAX engine at ``test_torch_zero3.py``'s
  tolerances (losses within 5e-4 relative; masters by their move within
  0.25, the key third of each qkv bias within 1e-2);
* qgZ at stage 3 equals qgZ at stage 2 bit for bit; its residual is reset
  by an overflowed step; a qgZ tag crosses between the engines both ways
  with ``qg_error`` bit for bit;
* the refusals and warnings are the JAX engine's words; the pipeline
  engine warns that qwZ and qgZ have no effect there (raises under
  ``strict``);
* the wire census (``wire.estimate_engine_comm_bytes``) gives the JAX
  engine's integers for the same configs, and the bytes the port hands
  to ``torch.distributed`` in a step (``quantize.WIRE``) are the census's
  (qwZ within 1% above it).
"""
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.comm import quantize as jq
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.parallel.topology import shard_map_compat
from deepspeed_tpu_torch.runtime.comm import quantize as tq
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_zero3_workers as workers
import torch_zeropp_jax as zj

pytestmark = pytest.mark.torch_port

WORLD = 2
S3 = zj.S3
QWZ = dict(S3, zero_quantized_weights=True)
QGZ = dict(S3, zero_quantized_gradients=True)
S2_QGZ = {"stage": 2, "zero_quantized_gradients": True}
# (name, zero, collective_matmul section or None)
CONFIGS = [("s3", S3, None), ("ring", S3, {"zero_gather": True}),
           ("qwz", QWZ, None), ("ring_qwz", QWZ, {}), ("qgz", QGZ, None),
           ("s2_qgz", S2_QGZ, None), ("s2", {"stage": 2}, None),
           ("s1", {"stage": 1}, None)]
# leaves whose pieces split a block at DP 2 (block 200, and 200 / 150)
GATHER_LEAVES = [("a", (5, 1600)), ("b", (3, 600)), ("c", (7, 64))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's spawn and one JAX engine, each run in a thread while
    the other JAX engines train in this process (the port's load of the
    JAX tag waits for its ``latest``); then the JAX engine loads the
    port's tag."""
    jax_dir = str(tmp_path_factory.mktemp("zeropp_jax_tag"))
    port_dir = str(tmp_path_factory.mktemp("zeropp_port_tag"))
    specs = [zj.port_spec(name, WORLD, zero, cm=cm)
             for name, zero, cm in CONFIGS]
    specs += [zj.port_spec(name + "_t10k", WORLD, dict(
        zero, stage3_param_persistence_threshold=10000), cm=cm)
        for name, zero, cm in CONFIGS if name in ("s3", "qwz", "ring")]
    specs += [zj.port_spec("qgz_save", WORLD, QGZ, save=port_dir,
                           save_tag="port"),
              zj.port_spec("qgz_overflow", WORLD, QGZ, steps=1,
                           overflow=True),
              zj.port_spec("qgz_load", WORLD, QGZ, load=jax_dir,
                           load_tag="jax", steps=0,
                           wait_for=os.path.join(jax_dir, "latest"))]
    leaves = [(n, zj.leaf(shape, seed)) for seed, (n, shape) in
              enumerate(GATHER_LEAVES)]
    rng = np.random.RandomState(3)
    rows = rng.randn(WORLD, WORLD * 600).astype(np.float32)
    errors = (rng.randn(WORLD, WORLD * 600) * 1e-2).astype(np.float32)
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn, _rank, WORLD, args=(
            specs, [(leaves, True, None, 0)], rows, errors), timeout_s=240)
        qwz = pool.submit(zj.jax_run, WORLD, QWZ)
        jax_runs = {name: zj.jax_run(WORLD, zero, steps=0, cm=cm)
                    for name, zero, cm in CONFIGS
                    if name not in ("qwz", "qgz")}
        jax_runs["qgz"] = zj.jax_run(WORLD, QGZ, save=(jax_dir, "jax"))
        jax_runs["qwz"] = qwz.result()
        engines, gathers, rs = ranks.result()[0]
    jax_runs["port_tag"] = zj.jax_load_qg_error(WORLD, QGZ, port_dir,
                                                "port")
    port = dict(runs={s["name"]: r for s, r in zip(specs, engines)},
                gathers=gathers, leaves=leaves, rs=rs, rows=rows,
                errors=errors)
    return port, jax_runs


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _rank(rank, world, specs, cases, rows, errors):
    # rank 0's results for everything; the other rank's engines run too
    engines = workers.zero_engine(rank, world, specs)
    gathers = workers.gather_cases(rank, world, cases)
    rs = [workers.reduce_scatter_cases(rank, world, rows, errors)]
    return engines, gathers, rs


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("shape", [(4, 1600), (2, 4800), (3, 600),
                                   (5, 1024)])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_codec_matches_jax_bit_for_bit(shape, dtype):
    import torch
    x = zj.leaf(shape, seed=shape[-1])
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = jnp.asarray(x, jdt)
    q, s = jax.jit(jq.quantize_param)(jx)
    d = jax.jit(jq.dequantize_param, static_argnums=2)(q, s, jdt)
    tqv, ts = tq.quantize_param(torch.from_numpy(x).to(tdt))
    td = tq.dequantize_param(tqv, ts, tdt)
    assert ts.shape == tuple(s.shape)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(s.astype(jnp.float32)))
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(d.astype(jnp.float32)))
    # the leaf's first block is all zeros: scale 0, lanes 0
    assert float(ts.float().reshape(-1)[0]) == 0.0


def test_quantized_reduce_scatter_matches_jax(port):
    from jax.sharding import PartitionSpec as P
    mesh = j_build_mesh(data=WORLD)

    def body(x, e):
        out, err = jq.quantized_reduce_scatter_local(
            x[0], "data", WORLD, error=e[0])
        plain, _ = jq.quantized_reduce_scatter_local(x[0], "data", WORLD)
        return plain[None], out[None], err[None]

    fn = jax.jit(shard_map_compat(body, mesh=mesh,
                                  in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"),) * 3))
    plain, fed, err = (np.asarray(a) for a in fn(port["rows"],
                                                 port["errors"]))
    got_plain, got_fed, got_err = port["rs"][0]
    chunk = plain.shape[-1]
    np.testing.assert_array_equal(got_plain, plain[0][:chunk])
    np.testing.assert_array_equal(got_fed, fed[0][:chunk])
    np.testing.assert_array_equal(got_err, err[0])


def test_qwz_gather_splits_blocks_bit_for_bit(port):
    got = port["gathers"][0]
    for name, x in port["leaves"]:
        np.testing.assert_array_equal(got[name], zj.qwz_values(x),
                                      err_msg=name)


# ------------------------------------------------------------- engines
def test_ring_gather_equals_the_plain_gather(port):
    runs = port["runs"]
    for ring, plain in (("ring", "s3"), ("ring_qwz", "qwz")):
        a, b = runs[ring], runs[plain]
        assert a["modes"][3] and not b["modes"][3]
        assert a["losses"] == b["losses"]
        zj.assert_trees_equal(zj.named(a["master"]), zj.named(b["master"]))
        assert a["prefetched"] > 0 and a["gathers"] == b["gathers"]
        # every ring posted ahead was the one asked for next: no gather
        # was made twice (the embedding unit is gathered by two calls)
        assert a["wire"]["allgather"] == b["wire"]["allgather"]
    assert runs["qwz"]["modes"][0] and not runs["s3"]["modes"][0]


@pytest.mark.parametrize("name", ["qwz", "qgz"])
def test_follows_the_jax_engine(port, jax_runs, name):
    zj.check_follows_jax(port["runs"][name], jax_runs[name])


def test_qgz_stage3_equals_stage2(port):
    a, b = port["runs"]["qgz"], port["runs"]["s2_qgz"]
    assert a["losses"] == b["losses"]
    zj.assert_trees_equal(zj.named(a["master"]), zj.named(b["master"]))
    zj.assert_trees_equal(zj.named(a["qg_error"]), zj.named(b["qg_error"]))
    # qgZ moved the run off plain stage 3
    assert a["losses"] != port["runs"]["s3"]["losses"]


def test_qgz_residual_reset_on_overflow(port):
    res = port["runs"]["qgz_overflow"]["overflow"]
    assert res["before"] > 0 and res["after"] == 0.0
    assert res["skipped"] == 1


def test_qgz_tags_cross_with_the_jax_engine(port, jax_runs):
    runs = port["runs"]
    # JAX -> port
    zj.assert_trees_equal(zj.named(runs["qgz_load"]["loaded_qg_error"]),
                          jax_runs["qgz"]["qg_error"])
    # port -> JAX
    zj.assert_trees_equal(jax_runs["port_tag"],
                          zj.named(runs["qgz_save"]["qg_error"]))


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_wire_census_matches_jax(port, jax_runs, name):
    assert port["runs"][name]["census"] == jax_runs[name]["census"]


def test_wire_tally_holds_to_the_census(port):
    """The bytes the port hands to ``torch.distributed`` in a step
    (``quantize.WIRE``) against its census, where the embedding stays
    whole (threshold 10000), so every gathered leaf is gathered twice a
    micro-step as the census prices it (GPT-2's head otherwise borrows
    the embedding unit for two more gathers): the plain gather and the
    ring exactly; qwZ within 1% above (each rank's scales padded to the
    largest count and the straddling blocks' scales sent by both ranks,
    plus the partial absmax exchange). The unit reduce-scatter moves the
    fp32 accumulator's dtype in every leg: the census's fp32 price."""
    runs = port["runs"]
    reduce = runs["s3_t10k"]["census"]["reduce_bytes_per_step"]
    for name in ("s3_t10k", "ring_t10k", "qwz_t10k"):
        run = runs[name]
        wire = {k: v / zj.STEPS for k, v in run["wire"].items()}
        want = run["census"]["allgather_bytes_per_step"]
        if name == "qwz_t10k":
            assert want <= wire["allgather"] <= 1.01 * want, (wire, want)
        else:
            assert wire["allgather"] == want, (name, wire, want)
        assert wire["reduce"] == reduce, (name, wire, reduce)
    assert "wte" in runs["s3_t10k"]["persistent"]


# ------------------------------------------------ refusals and warnings
def _messages(caplog, build):
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        try:
            build()
            err = None
        except ValueError as e:
            err = str(e)
    return err, sorted({r.getMessage() for r in caplog.records
                        if "zero_" in r.getMessage()})


def _port_engine(zero):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    return deepspeed_tpu_torch.initialize(
        model=tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**zj.MODEL)),
        config_params=workers.zero_config(dict(micro=2, zero=zero)),
        device="cpu")[0]


@pytest.mark.parametrize("zero", [
    {"stage": 0, "zero_hierarchical_partition": 2},
    {"stage": 1, "zero_quantized_weights": True,
     "zero_hierarchical_partition": 2, "zero_quantized_gradients": True},
    {"stage": 2, "zero_quantized_weights": True,
     "zero_hierarchical_partition": 2},
    {"stage": 3, "zero_hierarchical_partition": 3}])
def test_refusals_and_warnings_match_jax(caplog, zero):
    for name in ("DeepSpeedTPU", "DeepSpeedTPUTorch"):
        logging.getLogger(name).propagate = True
    want = _messages(caplog, lambda: zj.jax_engine(1, zero))
    got = _messages(caplog, lambda: _port_engine(zero))
    assert got == want
    assert want[0] is not None or want[1], want
    if want[0] is None:
        engine = _port_engine(zero)
        assert not engine.zero_quantized_weights()
        assert engine.zero_hierarchical_partition() == 0
        assert not engine.zero_quantized_gradients()


@pytest.mark.parametrize("key", ["zero_quantized_weights",
                                 "zero_quantized_gradients"])
def test_pipeline_says_qwz_and_qgz_have_no_effect(caplog, key):
    """The JAX pipeline's step reaches neither codec: the port's pipeline
    engine warns (one stage in one process) and keeps the mode off, and
    raises under ``zero_optimization.strict``."""
    import deepspeed_tpu_torch
    import torch_pipe_jax as pj
    import torch_pipe_workers as pipe_workers
    run = dict(S=1, dp=1, prec="bf16", M=2, micro=2, stage=3,
               gpt2=dict(pj.GPT2, n_layers=2), zero={key: True})
    logging.getLogger("DeepSpeedTPUTorch").propagate = True
    with caplog.at_level(logging.WARNING):
        engine = deepspeed_tpu_torch.initialize(
            model=pipe_workers.build(run), device="cpu",
            config_params=pipe_workers.config(run))[0]
    assert not engine.zero_quantized_weights()
    assert not engine.zero_quantized_gradients()
    assert any(key in r.getMessage() and "NO effect" in r.getMessage()
               for r in caplog.records)
    strict = dict(run, zero={key: True, "strict": True})
    with pytest.raises(ValueError, match="NO effect under pipeline"):
        deepspeed_tpu_torch.initialize(
            model=pipe_workers.build(strict), device="cpu",
            config_params=pipe_workers.config(strict))

