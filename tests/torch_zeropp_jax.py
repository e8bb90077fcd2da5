"""The JAX side of the port's ZeRO++ tests (``test_torch_zeropp.py``,
``test_torch_zero3_ring_gather.py``): the JAX engine on the tiny GPT-2 of
``test_torch_zero3.py`` at a ZeRO config, the JAX codecs and gathers on
seeded leaves, and the comparisons the two files share."""
import numpy as np

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.collective_matmul import zero3_ring_gather
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.comm import quantize as jq
from deepspeed_tpu.runtime.comm.wire import estimate_engine_comm_bytes
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO, GAS, STEPS = 2, 2, 3
THRESHOLD = 1000
S3 = {"stage": 3, "stage3_param_persistence_threshold": THRESHOLD}
LOSS_RTOL = 5e-4
MOVED_RTOL = 0.25
KEY_BIAS_ATOL = 1e-2


def ids(world):
    return np.random.RandomState(0).randint(
        0, 128, size=(GAS, MICRO * world, 32)).astype(np.int64)


def port_spec(name, world, zero, **extra):
    spec = dict(name=name, data=world, model=dict(MODEL), seed=0,
                micro=MICRO, gas=GAS, steps=STEPS,
                batch=(ids(world), ids(world)), zero=dict(zero))
    spec.update(extra)
    return spec


def named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(named(tree[key], prefix + key + "."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, child in enumerate(tree):
            out.update(named(child, prefix + str(i) + "."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def jax_engine(world, zero, cm=None):
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **MODEL, use_flash_attention=False))
    conf = {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": dict(zero), "steps_per_print": 10 ** 9}
    if cm is not None:
        conf["comm"] = {"collective_matmul": dict({"enabled": True}, **cm)}
    return JEngine(model=model, mesh=j_build_mesh(data=world),
                   config_params=conf)


def jax_run(world, zero, steps=STEPS, save=None, cm=None):
    """The JAX engine trained ``steps`` steps on the global batch; its
    initial and final masters, losses, qgZ residual and wire census; a
    tag ``save = (dir, tag)`` written at the end."""
    eng = jax_engine(world, zero, cm)
    init = named(eng.get_master_params())
    losses = [float(eng.train_batch(batch=(ids(world), ids(world))))
              for _ in range(steps)]
    out = dict(init=init, losses=losses, master=named(eng.get_master_params()),
               census=estimate_engine_comm_bytes(eng),
               qg_error=named(jax.device_get(eng.state["qg_error"]))
               if "qg_error" in eng.state else None)
    if save is not None:
        eng.save_checkpoint(save[0], tag=save[1])
    return out


def jax_load_qg_error(world, zero, load_dir, tag, save=None):
    """A fresh JAX engine's qgZ residual after loading a tag (then saved
    as the tag ``save = (dir, tag)`` when given)."""
    eng = jax_engine(world, zero)
    eng.load_checkpoint(load_dir, tag=tag)
    out = named(jax.device_get(eng.state["qg_error"]))
    if save is not None:
        eng.save_checkpoint(save[0], tag=save[1])
    return out


def check_masters(got, want, init):
    """``test_torch_zero_dp.py``'s bf16 rule: each leaf's move within
    MOVED_RTOL of the reference's, by norm; the key third of a qkv bias
    elementwise within KEY_BIAS_ATOL."""
    d = MODEL["d_model"]
    for name, w in want.items():
        moved, want_moved = got[name] - init[name], w - init[name]
        if name.endswith("qkv_bias"):
            key = slice(d, 2 * d)
            assert np.abs(moved[..., key] - want_moved[..., key]).max() \
                <= KEY_BIAS_ATOL, name
            moved = np.delete(moved, np.s_[d:2 * d], axis=-1)
            want_moved = np.delete(want_moved, np.s_[d:2 * d], axis=-1)
        err = float(np.linalg.norm(moved - want_moved) /
                    np.linalg.norm(want_moved))
        assert err <= MOVED_RTOL, (name, err)


def check_follows_jax(rank, want):
    np.testing.assert_allclose(rank["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    check_masters(named(rank["master"]), want["master"], want["init"])


def assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def leaf(shape, seed, zero_block=True):
    """A seeded fp32 leaf of bf16 values at mixed scales, the first half
    of its first row zero (an all-zero block at every block size)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x *= rs.choice([1e-3, 1.0, 30.0], size=shape).astype(np.float32)
    if zero_block:
        x.reshape(-1)[:shape[-1] // 2 or 1] = 0.0
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def qwz_values(x):
    """``dequantize_param(*quantize_param(leaf))`` of the JAX codec, as
    the JAX engine's jitted ``qwz_gather`` computes it, in bf16."""
    def f(v):
        q, s = jq.quantize_param(v)
        return jq.dequantize_param(q, s, v.dtype)
    return np.asarray(jax.jit(f)(jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))


def ring_qwz_values(x, world):
    """The JAX ring gather's qwZ values of a leaf at a data degree of
    ``world`` (``zero3_ring_gather`` with ``quantized=True`` on the first
    dimension the degree divides)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = j_build_mesh(data=world)
    dim = next(i for i, n in enumerate(x.shape) if n % world == 0)
    sharded = P(*[("data" if i == dim else None) for i in range(x.ndim)])
    gathered = P()
    p = jax.device_put(jnp.asarray(x, jnp.bfloat16),
                       NamedSharding(mesh, sharded))
    fn = jax.jit(lambda v: zero3_ring_gather(v, mesh, sharded, gathered,
                                             "data", dim, 1, True, 256))
    return np.asarray(fn(p).astype(jnp.float32))
