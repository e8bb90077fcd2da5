"""Activation checkpointing in the port, held against the JAX package's
tests and its GPT-2 ``"dots"`` remat policy, on the CPU.

* ``tests/unit/test_activation_checkpointing.py``'s eleven cases on the
  port's ``deepspeed_tpu_torch.checkpointing``: gradients through
  ``checkpoint`` equal the plain function's at that file's tolerances
  (rtol 1e-5, atol 2e-6; in fact bit for bit: the recompute runs the same
  ops), with partitioned and with host-kept inputs, nested; the
  ``configure`` surface, the decorator, the RNG tracker (explicit
  ``torch.Generator`` streams), the public name, and the engine applying
  the ds_config section.
* Partitioned activations over a TP 2 gloo pair: each rank keeps half of
  every saved input's last dimension, and the gradients equal the plain
  function's.
* GPT-2 under ``remat_policy="dots"``: loss and gradients equal
  ``"full"``'s bit for bit in the port (dropout on: the recompute redraws
  the same masks), and the JAX model's under ``"dots"`` within
  ``test_lm_loss_and_grads_match_jax``'s bounds (loss 1e-5 relative,
  each gradient 2e-5 of its largest element), on the plain and the
  flash path; a dispatch-mode count shows the backward recomputes no
  ``aten.mm`` under ``"dots"`` (as many as without remat) and recomputes
  them under ``"full"``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as deepspeed
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_ckpt_workers as workers
from torch_ckpt_workers import mlp as _mlp

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


def _reset_options():
    ckpt.PARTITION_ACTIVATIONS = False
    ckpt.CPU_CHECKPOINT = False
    ckpt.CONTIGUOUS_CHECKPOINTING = False
    ckpt.SYNCHRONIZE = False
    ckpt.PROFILE_TIME = False
    ckpt.deepspeed_checkpointing_enabled = False
    ckpt.mpu = None


@pytest.fixture(autouse=True)
def reset_options():
    _reset_options()
    yield
    _reset_options()


def _rand_weights(seed=0, d=16):
    rng = np.random.RandomState(seed)
    w1 = torch.tensor(rng.randn(d, 4 * d), dtype=torch.float32,
                      requires_grad=True)
    w2 = torch.tensor(rng.randn(4 * d, d), dtype=torch.float32,
                      requires_grad=True)
    x = torch.tensor(rng.randn(8, d), dtype=torch.float32)
    return w1, w2, x


def _grads(loss_fn, w1, w2):
    return torch.autograd.grad(loss_fn(w1, w2), (w1, w2))


def _assert_grads(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=2e-6)
        assert torch.equal(a, b)


def test_checkpoint_matches_plain_grads():
    w1, w2, x = _rand_weights()
    _assert_grads(_grads(lambda a, b: ckpt.checkpoint(_mlp, a, b, x), w1, w2),
                  _grads(lambda a, b: _mlp(a, b, x), w1, w2))


def test_checkpoint_nested():
    """The JAX file's checkpoint-inside-jit case: here a checkpoint inside
    another checkpointed function; finite gradients equal to plain."""
    w1, w2, x = _rand_weights(1)

    def outer(a, b):
        return ckpt.checkpoint(_mlp, a, b, x) * 2.0

    g = _grads(lambda a, b: ckpt.checkpoint(outer, a, b), w1, w2)
    assert all(torch.isfinite(t).all() for t in g)
    _assert_grads(g, _grads(lambda a, b: 2.0 * _mlp(a, b, x), w1, w2))


@pytest.mark.parametrize("option", ["partition_activations",
                                    "checkpoint_in_cpu"])
def test_option_grads_match(option):
    """Partitioned (no model group here: kept whole) and host-kept saved
    inputs: the gradients of the plain function."""
    ckpt.configure(**{option: True})
    w1, w2, x = _rand_weights(2)
    x.requires_grad_(True)
    got = torch.autograd.grad(ckpt.checkpoint(_mlp, w1, w2, x),
                              (w1, w2, x))
    want = torch.autograd.grad(_mlp(w1, w2, x), (w1, w2, x))
    _assert_grads(got, want)


def test_cpu_checkpointing_keeps_saved_inputs_on_host():
    ckpt.configure(checkpoint_in_cpu=True)
    w1, w2, x = _rand_weights(4)
    out = ckpt.checkpoint(_mlp, w1, w2, x)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(t.device.type == "cpu" for t in saved)
    assert [tuple(t.shape) for t in saved] == [(16, 64), (64, 16), (8, 16)]


def test_configure_from_ds_config(tmp_config_file):
    path = tmp_config_file({
        "train_batch_size": 8,
        "activation_checkpointing": {
            "partition_activations": True,
            "cpu_checkpointing": False,
            "number_checkpoints": 4,
            "profile": False,
        },
    })
    ckpt.configure(deepspeed_config=path)
    assert ckpt.is_configured()
    assert ckpt.PARTITION_ACTIVATIONS is True
    assert ckpt.num_layers == 4


def test_contiguous_requires_partition():
    with pytest.raises(ValueError):
        ckpt.configure(partition_activations=False,
                       contiguous_checkpointing=True, num_checkpoints=2)


def test_checkpoint_wrapper_decorator():
    w1, w2, x = _rand_weights(3)
    wrapped = ckpt.checkpoint_wrapper(_mlp)
    np.testing.assert_allclose(wrapped(w1, w2, x).detach().numpy(),
                               _mlp(w1, w2, x).detach().numpy(), rtol=1e-6)


def test_rng_tracker_fork_advances():
    ckpt.model_parallel_cuda_manual_seed(123, tp_rank=0, device="cpu")
    tracker = ckpt.get_cuda_rng_tracker()
    with tracker.fork() as g1:
        a = torch.randn(4, generator=g1)
    with tracker.fork() as g2:
        b = torch.randn(4, generator=g2)
    assert not torch.allclose(a, b)


def test_rng_tracker_tp_ranks_differ():
    ckpt.model_parallel_cuda_manual_seed(7, tp_rank=0, device="cpu")
    s0 = ckpt.get_cuda_rng_tracker().get_states()["model-parallel-rng"]
    ckpt.model_parallel_cuda_manual_seed(7, tp_rank=1, device="cpu")
    s1 = ckpt.get_cuda_rng_tracker().get_states()["model-parallel-rng"]
    assert not torch.equal(s0, s1)


def test_rng_tracker_duplicate_seed_raises():
    tracker = ckpt.RNGStatesTracker()
    tracker.add("a", 1)
    with pytest.raises(Exception):
        tracker.add("b", 1)
    with pytest.raises(Exception):
        tracker.add("a", 2)


def test_manual_seed_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.model_parallel_cuda_manual_seed(1)


def test_public_api_reachable():
    assert deepspeed.checkpointing.checkpoint is ckpt.checkpoint


def test_engine_applies_config_section():
    """An activation_checkpointing section configures the module at
    engine init, unless it is configured already."""
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(
        vocab_size=64, max_seq_len=16, n_layers=1, n_heads=2, d_model=32))
    config = {
        "train_batch_size": 8,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
        "activation_checkpointing": {"partition_activations": True,
                                     "cpu_checkpointing": True},
    }
    deepspeed.initialize(model=model, config_params=config, device="cpu")
    assert ckpt.is_configured()
    assert ckpt.PARTITION_ACTIVATIONS and ckpt.CPU_CHECKPOINT
    ckpt.configure(partition_activations=False)
    deepspeed.initialize(model=model, config_params=config, device="cpu")
    assert not ckpt.PARTITION_ACTIVATIONS


# ---------------------------------------- partitioned activations at TP 2


def test_partitioned_activations_at_tp2():
    rng = np.random.RandomState(5)
    arrays = (rng.randn(16, 64).astype(np.float32),
              rng.randn(64, 16).astype(np.float32),
              rng.randn(8, 16).astype(np.float32))
    for res in spawn(workers.partitioned_rank, 2, args=(arrays,),
                     timeout_s=120):
        assert res["saved"] == [(16, 32), (64, 8), (8, 8)], res
        assert all(res["equal"]), res


# ------------------------------------------------------- GPT-2 "dots"

SHAPE = dict(vocab_size=128, max_seq_len=64, n_layers=2, n_heads=2,
             d_model=64)
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MM:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_run(backend, remat, policy, ids, labels, dropout=0.0):
    cfg = tgpt2.GPT2Config(**SHAPE, remat=remat, remat_policy=policy,
                           loss_chunk=0, dropout=dropout,
                           flash_attention_backend=backend)
    model = tgpt2.make_gpt2_model(config=cfg, seed=1)
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels),
                 generator=torch.Generator().manual_seed(3))
    count = _CountMM()
    with count:
        loss.backward()
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            count.n)


def _data():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, SHAPE["vocab_size"], size=(2, 64)).astype(np.int64)
    labels = ids.copy()
    labels[:, -5:] = -100
    return ids, labels


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dots_equals_full_and_recomputes_no_product(backend):
    ids, labels = _data()
    full = _port_run(backend, True, "full", ids, labels, dropout=0.1)
    dots = _port_run(backend, True, "dots", ids, labels, dropout=0.1)
    plain = _port_run(backend, False, "full", ids, labels, dropout=0.1)
    assert dots[0] == full[0] == plain[0]
    for name, g in full[1].items():
        assert torch.equal(dots[1][name], g), name
    # the backward's own products only: as many as without remat, and
    # fewer than under "full", which recomputes every linear layer's
    assert dots[2] == plain[2] < full[2], (dots[2], plain[2], full[2])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dots_matches_jax(backend):
    ids, labels = _data()
    jcfg = jgpt2.GPT2Config(**SHAPE, remat=True, remat_policy="dots",
                            loss_chunk=0, flash_attention_backend=(
                                "interpret" if backend == "pallas"
                                else "xla"))
    jparams = jgpt2.init_params(jcfg, seed=1)
    j_loss, j_grads = jax.value_and_grad(jgpt2.lm_loss)(
        jparams, jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(labels.astype(np.int32)), jcfg, train=True)
    loss, grads, _ = _port_run(backend, True, "dots", ids, labels)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for path, want in jax.tree_util.tree_leaves_with_path(j_grads):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        want = np.asarray(want)
        err = float(np.abs(grads[name].numpy() - want).max() /
                    np.abs(want).max())
        assert err <= 2e-5, (name, err)


def test_uncached_forward_runs_under_dots():
    """The training forward (``forward_hidden``) under "dots", as the
    serving tests once probed it: the same hidden states as "full"."""
    cfg = tgpt2.GPT2Config(**SHAPE, remat=True)
    model = tgpt2.make_gpt2_model(config=cfg, seed=1)
    ids = torch.from_numpy(_data()[0])
    out = {policy: tgpt2.forward_hidden(
        model, ids, dataclasses.replace(cfg, remat_policy=policy),
        train=True) for policy in ("full", "dots")}
    assert torch.equal(out["full"], out["dots"])
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt2.forward_hidden(model, ids, dataclasses.replace(
            cfg, remat_policy="offload"), train=True)
