"""The port's int8 codec, sign helpers, fused layout bridge and the
in-collective int8 exchange (``deepspeed_tpu_torch/runtime/comm``), held
against the JAX package's ``runtime/comm/quantize.py`` on the same
numpy-seeded inputs. The JAX functions are compiled (``jax.jit``), as
the JAX engine runs them: XLA turns ``absmax / 127`` into a product with
the reciprocal and fuses the ring hop's dequantize-and-add into one FMA,
and the port computes the same.

The port's exchange bodies run in gloo ranks on the CPU
(``torch_comm_workers``, one spawn for each world size, with a deadline);
the JAX bodies run in ``shard_map`` on the forced host devices of
``tests/conftest.py``. Checks, with their tolerances:

* ``pack_signs`` / ``unpack_signs``, ``quantize_blockwise`` /
  ``dequantize_blockwise`` and ``quantize_dequantize`` bit-equal to JAX in
  fp32 and bf16, ties at .5 (half to even), zero blocks and pad lanes
  included; ``masked_compress``'s sign bytes bit-equal, its scale
  (``||x|| / sqrt(n)``: the port sums the squares in fp64, XLA in fp32)
  equal or one ulp apart (2e-7 relative), its decompressed values and
  errors bit-equal where the scales are and otherwise off by the scales'
  difference;
* ``ring_reduce_scatter_inline``, ``quantized_all_gather_local`` and
  ``quantized_all_reduce_local`` at w = 2 and 4, and
  ``hierarchical_all_reduce_local`` at 2 x 2: bit-equal to the JAX bodies
  (the same fp32 operations in the same order), every rank the same
  bits, and within the codec's per-hop bound of the exact sum; the bytes
  each rank hands to ``torch.distributed`` equal
  ``quantized_allreduce_bytes``;
* the layout bridge: the fused buffer built from the engine's flat
  buffer (``FlatBridge.to_fused``) equals the JAX package's
  ``FusedFlatLayout.flatten`` of the same tree bit for bit, padded for DP
  1, 2 and 4, and ``from_fused`` inverts it;
* the wire formulas equal the JAX package's.
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
from deepspeed_tpu.parallel.topology import factor_data_axis as j_factor
from deepspeed_tpu.parallel.topology import shard_map_compat
from deepspeed_tpu.runtime.comm import onebit as jo
from deepspeed_tpu.runtime.comm import quantize as jq
from deepspeed_tpu.runtime.comm import wire as jwire
from deepspeed_tpu_torch.runtime.comm import onebit as to
from deepspeed_tpu_torch.runtime.comm import quantize as tq
from deepspeed_tpu_torch.runtime.comm import wire as twire
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_comm_workers as workers

pytestmark = pytest.mark.torch_port

SCALE_RTOL = 2e-7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


def _pair(x32, dtype):
    """The same values in both packages: fp32, or fp32 rounded to bf16."""
    if dtype == "bf16":
        return (torch.from_numpy(x32).to(torch.bfloat16),
                jnp.asarray(x32).astype(jnp.bfloat16))
    return torch.from_numpy(x32.copy()), jnp.asarray(x32)


def _codec_input(n, seed, block=16):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 3).astype(np.float32)
    # a block of ties: absmax 127 -> scale 1, lanes on k + 0.5
    x[:block] = np.array(([127.0, 2.5, 3.5, -0.5, -1.5, 126.5, 0.5, -2.5]
                          * 4)[:block], np.float32)
    # a zero block
    x[block:2 * block] = 0.0
    return x


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sign_pack_unpack_bit_equal(dtype):
    rng = np.random.RandomState(1)
    x32 = rng.randn(8 * 37).astype(np.float32)
    x32[::7] = 0.0
    x32[3] = -0.0
    t, j = _pair(x32, dtype)
    tp, jp = tq.pack_signs(t), jax.jit(jq.pack_signs)(j)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    scale32 = np.float32(0.37)
    ts, js = _pair(np.array(scale32), dtype)
    tu = tq.unpack_signs(tp, ts.reshape(()))
    ju = jax.jit(jq.unpack_signs)(jp, js)
    assert tu.dtype == ts.dtype
    np.testing.assert_array_equal(_np(tu), _np(ju))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [16 * 9, 16 * 9 + 5])
def test_blockwise_codec_bit_equal(dtype, n):
    x32 = _codec_input(n, seed=n)
    t, j = _pair(x32, dtype)
    tqv, ts = tq.quantize_blockwise(t, 16)
    jqv, js = jax.jit(lambda v: jq.quantize_blockwise(v, 16))(j)
    assert tqv.dtype == torch.int8 and ts.dtype == t.dtype
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_np(ts), _np(js))
    # ties rounded half to even, the zero block quantized to 0
    if dtype == "fp32":
        np.testing.assert_array_equal(
            tqv.numpy()[0, :8], [127, 2, 4, 0, -2, 126, 0, -2])
        np.testing.assert_array_equal(tqv.numpy()[1], 0)
    np.testing.assert_array_equal(
        _np(tq.dequantize_blockwise(tqv, ts, n, t.dtype)),
        _np(jax.jit(lambda q, s: jq.dequantize_blockwise(
            q, s, n, j.dtype))(jqv, js)))
    np.testing.assert_array_equal(
        _np(tq.quantize_dequantize(t, 16)),
        _np(jax.jit(lambda v: jq.quantize_dequantize(v, 16))(j)))


def test_error_feedback_codec_bit_equal():
    rng = np.random.RandomState(3)
    x = rng.randn(300).astype(np.float32)
    err = (rng.randn(300) * 1e-3).astype(np.float32)
    tq_, te = tq.quantize_with_error_feedback(torch.from_numpy(x),
                                              torch.from_numpy(err), 64,
                                              scale=4.0)
    jq_, je = jax.jit(lambda a, b: jq.quantize_with_error_feedback(
        a, b, 64, scale=4.0))(jnp.asarray(x), jnp.asarray(err))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_masked_compress_matches_jax(dtype, seed):
    """Sign bytes bit-equal; the scale within 2e-7 (the port sums the
    squares in fp64, XLA in fp32: equal, or one ulp apart); the
    decompressed values (+-scale) and the errors then bit-equal where the
    scales are, and otherwise off by exactly the scales' difference (the
    errors by one more rounding of x - d)."""
    rng = np.random.RandomState(seed)
    n, real = 8 * 25, 8 * 25 - 13
    x32 = rng.randn(n).astype(np.float32)
    mask32 = (np.arange(n) < real).astype(np.float32)
    x32[real:] = 0.0
    t, j = _pair(x32, dtype)
    tp, ts, td, te = to.masked_compress(t, torch.from_numpy(mask32),
                                        np.float32(real))
    jp, js, jd, je = jax.jit(jo.masked_compress)(
        j, jnp.asarray(mask32), jnp.float32(real))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert ts.dtype == t.dtype
    np.testing.assert_allclose(_np(ts), _np(js), rtol=SCALE_RTOL)
    gap = abs(float(_np(ts)) - float(_np(js)))
    assert (np.abs(_np(td) - _np(jd)) <= gap).all()
    slack = 2 * float(np.spacing(np.abs(_np(t)).max() + abs(
        float(_np(js))))) if gap else 0.0
    assert (np.abs(_np(te) - _np(je)) <= gap + slack).all()
    # pad lanes: zero value and zero error
    assert not _np(td)[real:].any() and not _np(te)[real:].any()


# ------------------------------------------------------------- wire formulas
@pytest.mark.parametrize("args", [(2000, 8, 256, None), (2000, 8, 256, (4, 2)),
                                  (354_823_168, 2, 256, None),
                                  (354_823_168, 4, 256, (2, 2)),
                                  (1000, 4, 16, None)])
def test_wire_formulas_equal_jax(args):
    numel, world, block, levels = args
    assert twire.quantized_allreduce_bytes(numel, world, block, levels) == \
        jwire.quantized_allreduce_bytes(numel, world, block, levels)
    assert twire.quantized_allreduce_bytes(
        numel, world, block, levels, min_component=16) == \
        jwire.quantized_allreduce_bytes(numel, world, block, levels,
                                        min_component=16)
    for bits in (1, 32):
        assert twire.onebit_exchange_bytes(numel, world,
                                           itemsize_bits=bits) == \
            jwire.onebit_exchange_bytes(numel, world, itemsize_bits=bits)
    assert twire._payload(numel, 2, True, 4, block) == \
        jwire._payload(numel, 2, True, 4, block)
    assert tq.qc_padded_size(numel, world, block) == \
        jq.qc_padded_size(numel, world, block)
    assert to.onebit_padded_size(numel, world) == \
        jo.onebit_padded_size(numel, world)


# ----------------------------------------------------------- layout bridge
LAYOUT_MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
                    d_model=64, remat=False, loss_chunk=0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_layout_bridge_equals_jax_fused_flatten(world):
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.runtime.checkpointing import jax_leaf_order
    from deepspeed_tpu_torch.runtime.zero.partition import FlatPartition
    jparams = jgpt2.init_params(jgpt2.GPT2Config(**LAYOUT_MODEL), seed=0)
    for name, pad in (("onebit", lambda n: jo.onebit_padded_size(n, world)),
                      ("qc", lambda n: jq.qc_padded_size(n, world, 256))):
        jl = jq.FusedFlatLayout(jparams, pad)
        want = np.asarray(jl.flatten(jparams))
        model = tgpt2.make_gpt2_model(
            config=tgpt2.GPT2Config(**LAYOUT_MODEL), seed=0)
        flat = FlatPartition(model, torch.device("cpu"), torch.float32)
        order = jax_leaf_order(tgpt2.params_to_jax, flat.names)
        shapes = dict(zip(flat.names, flat.shapes))
        tl = tq.FusedFlatLayout([(n, shapes[n]) for n in order], pad)
        assert (tl.numel, tl.padded) == (jl.numel, jl.padded), name
        bridge = tl.bridge(dict(zip(flat.names, flat.offsets)))
        got = bridge.to_fused(flat.master)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        back = torch.zeros_like(flat.master)
        bridge.from_fused(got, back)
        np.testing.assert_array_equal(back.numpy(), flat.master.numpy())
        # the bf16 buffer round-trips through the fp32 fused form
        grads = flat.master.to(torch.bfloat16)
        fused = bridge.to_fused(grads)
        back16 = torch.zeros_like(grads)
        bridge.from_fused(fused, back16)
        assert torch.equal(back16, grads)


# ------------------------------------------------------ exchange bodies
EX_N = {2: 2 * 4 * 16, 4: 4 * 4 * 16}


def _ex_inputs(world, seed, kind="randn"):
    rng = np.random.RandomState(seed)
    n = EX_N[world]
    if kind == "ints":
        return rng.randint(-1, 2, size=(world, n)).astype(np.float32)
    return rng.randn(world, n).astype(np.float32)


def _ex_cases(world):
    cases = [dict(kind="ring_rs", x=_ex_inputs(world, 10 + world), block=16),
             dict(kind="all_gather", x=_ex_inputs(world, 20 + world),
                  block=16),
             dict(kind="all_reduce", x=_ex_inputs(world, 30 + world),
                  block=16),
             dict(kind="all_reduce", x=_ex_inputs(world, 40 + world, "ints"),
                  block=16)]
    if world == 4:
        cases.append(dict(kind="hierarchical", shard=2, block=16,
                          x=_ex_inputs(world, 50)))
    return cases


@pytest.fixture(scope="module")
def port_exchanges():
    """Per world size the port's ranks' results (one spawn each, side by
    side), and under "jax" the JAX bodies' results, computed meanwhile."""
    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(spawn, workers.exchanges, w,
                                  args=(_ex_cases(w),), timeout_s=120)
                   for w in (2, 4)}
        out = {"jax": {(w, i): _jax_exchange(case, w)
                       for w in (2, 4)
                       for i, case in enumerate(_ex_cases(w))}}
        out.update((w, f.result()) for w, f in futures.items())
    return out


@functools.lru_cache(maxsize=None)
def _jax_exchange_fn(kind, world, block, shard=None):
    """The JAX body of ``kind`` in shard_map, compiled once per shape."""
    if kind == "hierarchical":
        mesh = j_factor(j_build_mesh(data=world), shard)
        axis = ("data_replica", "data_shard")

        def body(v):
            return jq.hierarchical_all_reduce_local(
                v, "data_shard", "data_replica", shard, world // shard,
                block)
    else:
        mesh, axis = j_build_mesh(data=world), "data"
        body = {"ring_rs": lambda v: jq.ring_reduce_scatter_inline(
                    v, "data", world, block),
                "all_gather": lambda v: jq.quantized_all_gather_local(
                    v, "data", block),
                "all_reduce": lambda v: jq.quantized_all_reduce_local(
                    v, "data", world, block)}[kind]
    return jax.jit(shard_map_compat(lambda v: body(v[0])[None], mesh=mesh,
                                    in_specs=(P(axis),), out_specs=P(axis)))


def _jax_exchange(case, world):
    fn = _jax_exchange_fn(case["kind"], world, case["block"],
                          case.get("shard"))
    return np.asarray(fn(jnp.asarray(case["x"])))


EX_IDS = [(w, i) for w in (2, 4) for i in range(len(_ex_cases(w)))]


@pytest.mark.parametrize("world,index", EX_IDS)
def test_exchange_bodies_bit_equal_to_jax(port_exchanges, world, index):
    case = _ex_cases(world)[index]
    ranks = [r[index] for r in port_exchanges[world]]
    want = port_exchanges["jax"][(world, index)]
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res["out"], want[rank],
                                      err_msg="{} rank {}".format(
                                          case["kind"], rank))
    if case["kind"] != "ring_rs":
        # every rank the same bits, near the exact sum / the gather
        for res in ranks[1:]:
            np.testing.assert_array_equal(res["out"], ranks[0]["out"])
    if case["kind"] in ("all_reduce", "hierarchical"):
        exact = case["x"].sum(axis=0)
        hops = 2 * (world - 1)
        bound = hops * np.abs(case["x"]).sum(axis=0).max() / 127.0
        assert np.abs(ranks[0]["out"] - exact).max() <= bound
        levels = (2, 2) if case["kind"] == "hierarchical" else None
        wire = twire.quantized_allreduce_bytes(case["x"].shape[1], world,
                                               case["block"], levels=levels)
        assert all(r["wire_bytes"] == wire for r in ranks), \
            ([r["wire_bytes"] for r in ranks], wire)
    if case["kind"] == "hierarchical":
        assert [(r["replica_rank"], r["shard_rank"]) for r in ranks] == \
            [(0, 0), (0, 1), (1, 0), (1, 1)]
