"""The JAX side of the port's pipeline tests: the JAX package's
``PipelineEngine`` on the virtual CPU devices of ``tests/conftest.py``,
its module's weights as a numpy tree for the port's ranks
(``torch_pipe_workers``), and the comparisons, with their tolerances."""
import numpy as np

import jax

import deepspeed_tpu as jds
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import gpt2_pipe as jgpt2_pipe
from deepspeed_tpu.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.pipe import PipelineModule as JPipelineModule

import torch_pipe_workers as workers

GPT2 = dict(vocab_size=128, max_seq_len=32, n_heads=2, d_model=64,
            remat=False, loss_chunk=0)
LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-4, "fp16": 5e-4}
MASTER_ATOL = 5e-5
MOVED_RTOL = 0.25
KEY_BIAS_ATOL = 1e-2


class TanhLinear:
    """``tests/unit/test_pipe.py::TanhLinear`` (the JAX layer)."""

    def __init__(self, dim):
        self.dim = dim

    def init(self, rng):
        return {"w": jax.random.normal(rng, (self.dim, self.dim)) * 0.3,
                "b": jax.numpy.zeros((self.dim,))}

    def apply(self, params, x):
        return jax.numpy.tanh(x @ params["w"].astype(x.dtype) +
                              params["b"].astype(x.dtype))


def mse_loss(out, labels):
    return jax.numpy.mean((out.astype(np.float32) -
                           labels.astype(np.float32)) ** 2)


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def jax_net(run):
    """The JAX module of a run spec (``torch_pipe_workers.build``'s)."""
    kw = dict(num_stages=run["S"], num_dp=run.get("dp", 1),
              num_mp=run.get("tp", 1),
              num_virtual_stages=run.get("v", 1))
    if "gpt2" in run:
        cfg = jgpt2.GPT2Config(**dict(run["gpt2"],
                                      use_flash_attention=False))
        return jgpt2_pipe.make_gpt2_pipeline(
            config=cfg, activation_checkpoint_interval=run.get("aci", 0),
            **kw)
    return JPipelineModule(
        layers=[JLayerSpec(TanhLinear, workers.DIM)
                for _ in range(run["tanh"])], loss_fn=mse_loss, **kw)


def jax_engine(run, net=None):
    """The JAX engine of a run spec. Its config has no ``comm`` section:
    the JAX engine refuses ``comm.collective_matmul`` under a pipe axis
    (ValueError, "not a certified combination": GSPMD shards its blocks
    from their partition specs), while the port runs a model axis only
    through the ring ops; both compute the same function."""
    net = net if net is not None else jax_net(run)
    conf = workers.config(run)
    conf.pop("comm", None)
    engine, _, _, _ = jds.initialize(model=net, config_params=conf)
    return net, engine


def jax_play(run, engine):
    """The run's train/eval actions on the JAX engine (the global batch
    whole): losses, evals, the master tree after them."""
    res = {"losses": [], "evals": []}
    for action in run["actions"]:
        if action[0] == "train":
            for _ in range(action[2]):
                res["losses"].append(float(engine.train_batch(
                    batch=tuple(np.asarray(x, np.int32)
                                if x.dtype.kind == "i" else x
                                for x in action[1]))))
        elif action[0] == "eval":
            res["evals"].append(float(engine.eval_batch(
                batch=tuple(np.asarray(x, np.int32)
                            if x.dtype.kind == "i" else x
                            for x in action[1]))))
    res["master"] = numpy_tree(engine.get_master_params())
    return res


def gpt2_batch(M, rows, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, GPT2["vocab_size"], size=(M, rows, GPT2["max_seq_len"]))
    return ids.astype(np.int64), ids.astype(np.int64)


def tanh_batch(M, rows, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, rows, workers.DIM).astype(np.float32)
    y = np.tanh(x @ (rng.randn(workers.DIM, workers.DIM) * 0.3)
                .astype(np.float32))
    return x, y


def real_leaves(tree, parts, num_virtual=1):
    """``{path: array}`` of a pipeline tree with each body leaf cut to its
    real layers in global order (padded slots dropped)."""
    from deepspeed_tpu_torch.runtime.pipe.module import global_to_slot
    layout = {"parts": parts, "num_virtual": num_virtual}
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], prefix + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, prefix + (str(i),))
        elif node is not None:
            leaf = np.asarray(node, np.float32)
            if prefix[0] == "body":
                leaf = np.stack([leaf[global_to_slot(layout, g)]
                                 for g in range(parts[-1])])
            out[".".join(prefix)] = leaf

    walk(tree, ())
    return out


def master_diff(got, want, init, parts, v_got=1, v_want=1, v_init=None):
    """Largest |got - want| over the real leaves, apart from it over the
    qkv biases' key part (its exact gradient is zero, softmax rows summing
    to one, so rounding noise alone moves it), and the largest relative
    difference of how far each leaf moved from ``init`` (by norm, the key
    part left out): ``(max_abs, key_bias_max_abs, moved_rel)``."""
    g = real_leaves(got, parts, v_got)
    w = real_leaves(want, parts, v_want)
    i = real_leaves(init, parts, v_init or v_want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    worst, key_bias, moved = 0.0, 0.0, 0.0
    for name in w:
        a, b, c = g[name], w[name], i[name]
        if name.endswith("qkv_bias"):
            d = a.shape[-1] // 3
            key = np.s_[..., d:2 * d]
            key_bias = max(key_bias, float(np.abs(a[key] - b[key]).max()))
            a, b, c = (np.delete(t, np.s_[d:2 * d], axis=-1)
                       for t in (a, b, c))
        worst = max(worst, float(np.abs(a - b).max()))
        norm = float(np.linalg.norm(b - c))
        if norm > 0:
            moved = max(moved, float(np.linalg.norm((a - c) - (b - c))) /
                        norm)
    return worst, key_bias, moved


def check_masters(got, want, init, parts, prec, **layout):
    """fp32: every real element within MASTER_ATOL; bf16/fp16: each
    leaf's move within MOVED_RTOL of the JAX engine's, the key bias within
    KEY_BIAS_ATOL."""
    worst, key_bias, moved = master_diff(got, want, init, parts, **layout)
    if prec == "fp32":
        assert max(worst, key_bias) <= MASTER_ATOL, (worst, key_bias)
    else:
        assert moved <= MOVED_RTOL and key_bias <= KEY_BIAS_ATOL, \
            (moved, key_bias)


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))
