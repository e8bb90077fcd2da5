"""The port's BERT slice against the JAX package, on the CPU.

* weights: ``init_params`` (and the SQuAD head) equal the JAX package's
  bit for bit at fp32; ``num_params`` agrees, 336,232,258 for BERT-large;
* layer: ``DeepSpeedTransformerLayer`` (forward and every gradient)
  against the JAX ``transformer_layer_forward``, pre-LN and post-LN, with
  and without a padded key mask, on the einsum path ("xla") and the flash
  path ("pallas", whose wrappers run the kernels' plain versions on CPU
  tensors; the JAX layer takes its einsum path off the TPU); the
  checkpoint flags keep the gradients; HF-ordered initial weights load
  with the reference's transposes; the class-wide layer ids;
* model: the pretraining (MLM + NSP) and SQuAD losses and every gradient
  against the JAX package's, on both attention paths, remat on and off;
* engine: 5 ``train_batch`` steps of LAMB from the same init through
  ``deepspeed_tpu.initialize`` (8 virtual CPU devices, global batch micro
  x 8) and ``deepspeed_tpu_torch.initialize`` at world size 1 with the
  same global batch, fp32 ZeRO 0 and bf16 ZeRO 0/1/2: loss trajectories
  and final masters; the engine's JAX-tree methods on a BERT engine (the
  master tree and the LAMB state cross both ways); the
  ``progressive_layer_drop`` schedule.

Inputs: vocab 512, seq 64, 2 layers, 4 heads, d_model 64, d_intermediate
256, dropout 0; a key-padding mask with per-row valid lengths, MLM labels
at 15% of the valid positions (-100 elsewhere), random NSP labels.

Tolerances (fp32 sums in another order): layer outputs 2e-5 of the
output's largest magnitude and gradients 2e-5 of each tensor's largest
magnitude; model losses 1e-5 relative and gradients 2e-5 as the layer's
(SQuAD: 2e-4, its bias gradients are sums over every position of terms
that nearly cancel, and its span bias, whose exact gradient is zero,
1e-6 absolute).
Engine, fp32: losses 1e-5 relative, masters 5e-5 absolute (LAMB divides by
sqrt(v) + eps: an element with a tiny gradient turns a last-bit difference
into up to ~1e-5 of movement). Engine, bf16: losses 5e-4 relative (the two
frameworks round bf16 GEMM outputs and elementwise chains at different
points); each leaf's movement from the shared init within 0.25 of the JAX
movement in L2, as the GPT-2 engine test holds Adam (an element whose bf16
gradient is near zero can move by up to lr either way); the key third of
the QKV bias, whose exact gradient is zero, 2e-2 absolute (2 x 5 steps x
lr: it moves by rounding noise alone, with a trust ratio of 1 while the
leaf is zero).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.transformer import transformer as jtr
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops.transformer import transformer as ttr
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as TorchPLD

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

WORLD = 8
SHAPE = dict(vocab_size=512, max_seq_len=128, n_layers=2, n_heads=4,
             d_model=64, d_intermediate=256, dropout=0.0, attn_dropout=0.0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + "." + k if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(seed, b, s=64, vocab=512):
    """(ids, token types, keep mask, MLM labels, NSP labels): valid
    lengths in [s/2, s], MLM labels at 15% of the valid positions."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(b, s)).astype(np.int32)
    types = (np.arange(s)[None, :] >= rng.randint(1, s, size=(b, 1))) \
        .astype(np.int32)
    valid = rng.randint(s // 2, s + 1, size=(b,))
    valid[0] = s
    mask = (np.arange(s)[None, :] < valid[:, None]).astype(np.int32)
    pick = (rng.rand(b, s) < 0.15) & (mask == 1)
    pick[:, 1] = True
    mlm = np.where(pick, ids, -100).astype(np.int32)
    nsp = rng.randint(0, 2, size=(b,)).astype(np.int32)
    return ids, types, mask, mlm, nsp


# ----------------------------------------------------------------- weights


def test_init_params_bit_equal_to_jax():
    jcfg, tcfg = jbert.BertConfig(**SHAPE), tbert.BertConfig(**SHAPE)
    want = dict(_leaves(jbert.init_params(jcfg, seed=3)))
    got = dict(_leaves(tbert.init_params(tcfg, seed=3)))
    assert sorted(got) == sorted(want) and len(got) == 26
    for name, w in want.items():
        assert got[name].dtype == np.float32
        assert np.array_equal(got[name], np.asarray(w)), name
    jm = jbert.make_bert_squad_model(config=jcfg, seed=3)
    tm = tbert.make_bert_squad_model(config=tcfg, seed=3)
    state = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    for name, w in _leaves(jm.params):
        assert np.array_equal(state[name], w), name
    assert len(state) == 28


def test_num_params_matches_jax():
    for size in ("bert_base", "bert_large"):
        assert tbert.num_params(tbert.config_for(size)) == \
            jbert.num_params(jbert.config_for(size))
    assert tbert.num_params(tbert.config_for("bert_large")) == 336_232_258
    model = tbert.BertModel(tbert.BertConfig(**SHAPE))
    assert sum(p.numel() for p in model.parameters()) == \
        tbert.num_params(tbert.BertConfig(**SHAPE))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tbert.partition_spec_fn("layers.attn_qkvw", (2, 64, 192))
    with pytest.raises(NotImplementedError, match="observability"):
        tbert.profile_spec(tbert.BertConfig(**SHAPE), 2)


# ------------------------------------------------------------------- layer


def _layer_configs(**overrides):
    kw = dict(batch_size=2, hidden_size=64, heads=4, intermediate_size=256,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              num_hidden_layers=2, initializer_range=0.02, seed=7,
              pre_layer_norm=True)
    kw.update(overrides)
    backend = kw.pop("flash_attention_backend", "xla")
    return jtr.DeepSpeedTransformerConfig(**kw), \
        ttr.DeepSpeedTransformerConfig(flash_attention_backend=backend, **kw)


def _layer_case(seed=0, s=48):
    """x, a keep-mask with a padded row, and the weights of the test loss
    sum(out * w) (a mean of squares is flat after a post-LN layer norm)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, s, 64).astype(np.float32)
    w = rng.randn(2, s, 64).astype(np.float32)
    mask = np.ones((2, s), np.int32)
    mask[1, 30:] = 0
    mask[0, rng.rand(s) < 0.2] = 0
    mask[0, 0] = 1
    return x, mask, w


@pytest.mark.parametrize("pre_ln,masked,backend", [
    (True, True, "xla"), (False, True, "xla"), (True, False, "xla"),
    (True, True, "pallas"), (False, True, "pallas"),
    (True, False, "pallas")])
def test_layer_forward_and_grads_match_jax(pre_ln, masked, backend):
    jcfg, tcfg = _layer_configs(pre_layer_norm=pre_ln,
                                flash_attention_backend=backend)
    x, mask, w = _layer_case()
    mask = mask if masked else None
    jlayer = jtr.DeepSpeedTransformerLayer(jcfg)
    jparams = jlayer.init_params()
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(params, xx):
        return (jlayer(params, xx, jm, train=False) * w).sum()

    j_out = jlayer(jparams, jnp.asarray(x), jm, train=False)
    j_grads, j_dx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    tlayer = ttr.DeepSpeedTransformerLayer(tcfg)
    for name, p in tlayer.named_parameters():
        assert np.array_equal(p.detach().numpy(), np.asarray(jparams[name]))
    xt = torch.from_numpy(x).requires_grad_()
    out = tlayer(xt, None if mask is None else torch.from_numpy(mask),
                 train=False)
    assert _max_rel(out.detach().numpy(), j_out) <= 2e-5
    (out * torch.from_numpy(w)).sum().backward()
    assert _max_rel(xt.grad.numpy(), j_dx) <= 2e-5
    for name, p in tlayer.named_parameters():
        assert _max_rel(p.grad.numpy(), j_grads[name]) <= 2e-5, name


@pytest.mark.parametrize("flag", ["gelu_checkpoint", "attn_dropout_checkpoint",
                                  "normalize_invertible"])
def test_checkpoint_flags_preserve_grads(flag):
    x, mask, w = _layer_case(seed=1, s=16)
    grads = []
    for on in (False, True):
        _, tcfg = _layer_configs(**({flag: True} if on else {}))
        layer = ttr.DeepSpeedTransformerLayer(tcfg)
        xt = torch.from_numpy(x).requires_grad_()
        (layer(xt, torch.from_numpy(mask), train=False) *
         torch.from_numpy(w)).sum().backward()
        grads.append([xt.grad] + [p.grad for p in layer.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_attention_dropout_checkpoint_redraws_the_mask():
    """Probability dropout under attn_dropout_checkpoint: the recompute
    draws the forward's mask (the gradients equal those without the
    checkpoint), and leaves the generator where the backward found it."""
    x, mask, w = _layer_case(seed=2, s=16)
    runs = []
    for on in (False, True):
        _, tcfg = _layer_configs(attn_dropout_ratio=0.3,
                                 attn_dropout_checkpoint=on)
        layer = ttr.DeepSpeedTransformerLayer(tcfg)
        gen = torch.Generator().manual_seed(3)
        xt = torch.from_numpy(x).requires_grad_()
        (layer(xt, torch.from_numpy(mask), generator=gen, train=True) *
         torch.from_numpy(w)).sum().backward()
        runs.append((xt.grad, torch.rand(4, generator=gen)))
    assert torch.allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-6)
    assert torch.equal(runs[0][1], runs[1][1])


def test_initial_weight_loading():
    jcfg, tcfg = _layer_configs()
    d, di = 64, 256
    rs = np.random.RandomState(3)
    # torch-layout (out, in) weights as module_inject hands them over
    weights = [rs.randn(d, d) for _ in range(4)] + [rs.randn(d)] + \
        [rs.randn(di, d), rs.randn(d, di)] + [rs.randn(d)]
    biases = [rs.randn(d) for _ in range(5)] + [rs.randn(di)] + \
        [rs.randn(d), rs.randn(d)]
    want = jtr.DeepSpeedTransformerLayer(
        jcfg, initial_weights=weights, initial_biases=biases).init_params()
    layer = ttr.DeepSpeedTransformerLayer(tcfg, initial_weights=weights,
                                          initial_biases=biases)
    for name, p in layer.named_parameters():
        assert np.array_equal(p.detach().numpy(), np.asarray(want[name])), \
            name
    np.testing.assert_allclose(layer.attn_qkvw.detach().numpy()[:, :d],
                               weights[0].T, atol=1e-6)


def test_layer_ids_and_config_round_trip(tmp_path):
    ttr.DeepSpeedTransformerLayer.layer_count = 0
    _, tcfg = _layer_configs()
    layers = [ttr.DeepSpeedTransformerLayer(tcfg) for _ in range(3)]
    assert [lyr.config.layer_id for lyr in layers] == [0, 1, 2]
    assert tcfg.layer_id == -1
    path = tmp_path / "layer.json"
    path.write_text('{"hidden_size": 32, "heads": 2, "fp16": true}')
    cfg = ttr.DeepSpeedTransformerConfig.from_json_file(str(path))
    assert (cfg.hidden_size, cfg.heads, cfg.compute_dtype) == \
        (32, 2, torch.bfloat16)
    with pytest.warns(UserWarning, match="stochastic_mode"):
        ttr.DeepSpeedTransformerConfig(hidden_size=64, stochastic_mode=True)
    assert ttr.DeepSpeedTransformerConfig(hidden_size=64) \
        .intermediate_size == 256


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("head,backend,remat", [
    ("pretrain", "xla", False), ("pretrain", "pallas", True),
    ("squad", "xla", True), ("squad", "pallas", False)])
def test_losses_and_grads_match_jax(head, backend, remat):
    ids, types, mask, mlm, nsp = _batch(4, b=3)
    jcfg = jbert.BertConfig(**SHAPE, remat=remat)
    tcfg = tbert.BertConfig(**SHAPE, remat=remat,
                            flash_attention_backend=backend)
    if head == "pretrain":
        jm, tm = jbert.make_bert_model(config=jcfg, seed=2), \
            tbert.make_bert_model(config=tcfg, seed=2)
        labels = (mlm, nsp)
    else:
        jm, tm = jbert.make_bert_squad_model(config=jcfg, seed=2), \
            tbert.make_bert_squad_model(config=tcfg, seed=2)
        rng = np.random.RandomState(5)
        labels = tuple(rng.randint(0, 32, size=(3,)).astype(np.int32)
                       for _ in range(2))
    inputs = (ids, types, mask) + labels
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jm.apply_fn(p, *(jnp.asarray(a) for a in inputs),
                              train=True))(jm.params)
    loss = tm(*(torch.from_numpy(a) for a in inputs))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= \
        1e-5 * abs(float(j_loss))
    # the squad loss leaves the pretraining heads without a gradient
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for n, p in tm.named_parameters()}
    tol = 2e-5 if head == "pretrain" else 2e-4
    for name, want in _leaves(j_grads):
        if name == "squad.bias":
            # the span CE over a sequence is invariant to a bias shared by
            # every position: its exact gradient is zero
            assert np.abs(grads[name]).max() <= 1e-6
            continue
        assert _max_rel(grads[name], want) <= tol, name


def test_flash_path_only_for_key_padding_masks_without_dropout(monkeypatch):
    """The "pallas" layer takes the flash op for a (b, s) keep-mask and
    for no mask; an (s, s)-shaped mask or probability dropout takes the
    einsum path, as the JAX gate does."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
    calls = []
    real = tfa.flash_attention_bshd
    monkeypatch.setattr(tfa, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, mask, _ = _layer_case(seed=3, s=16)
    xt = torch.from_numpy(x)
    _, tcfg = _layer_configs(flash_attention_backend="pallas")
    layer = ttr.DeepSpeedTransformerLayer(tcfg)
    layer(xt, torch.from_numpy(mask), train=False)
    layer(xt, None, train=False)
    assert len(calls) == 2
    square = torch.zeros(2, 1, 16, 16)
    layer(xt, square, train=False)
    _, dcfg = _layer_configs(flash_attention_backend="pallas",
                             attn_dropout_ratio=0.1)
    ttr.DeepSpeedTransformerLayer(dcfg)(
        xt, torch.from_numpy(mask), generator=torch.Generator(), train=True)
    assert len(calls) == 2
    _, auto = _layer_configs(flash_attention_backend="auto")
    ttr.DeepSpeedTransformerLayer(auto)(xt, None, train=False)
    assert len(calls) == 2                 # "auto" on the CPU: einsum


# ------------------------------------------------------------------ engine


def _ds(prec, stage, micro):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 1,
           "zero_optimization": {"stage": stage},
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Lamb", "params": {
               "lr": 2e-3, "weight_decay": 0.01}}}
    if prec == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


ENGINE = dict(SHAPE, max_seq_len=64, remat=False)


@pytest.mark.parametrize("prec,stage", [
    ("fp32", 0), ("bf16", 0), ("bf16", 1), ("bf16", 2)])
def test_lamb_engine_trajectory_and_masters_match_jax(prec, stage):
    batch = tuple(a[None] for a in _batch(11, b=WORLD))
    je, *_ = deepspeed_tpu.initialize(
        model=jbert.make_bert_model(config=jbert.BertConfig(**ENGINE),
                                    seed=6),
        config_params=_ds(prec, stage, 1))
    j_losses = [float(je.train_batch(batch=batch)) for _ in range(5)]
    te, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=tbert.make_bert_model(config=tbert.BertConfig(**ENGINE),
                                    seed=6),
        config_params=_ds(prec, stage, WORLD), device="cpu")
    assert opt is te.optimizer and opt.name == "lamb"
    assert te.flat.segments.shape == (26, 2)
    init = dict(_leaves(te.get_master_params()))
    t_losses = [float(te.train_batch(batch=batch)) for _ in range(5)]
    loss_tol = 1e-5 if prec == "fp32" else 5e-4
    np.testing.assert_allclose(t_losses, j_losses, rtol=loss_tol)
    assert t_losses[-1] < t_losses[0]
    got = dict(_leaves(te.get_master_params()))
    d = ENGINE["d_model"]
    for name, want in _leaves(je.get_master_params()):
        want = np.asarray(want, np.float32)
        if prec == "fp32":
            err = float(np.abs(got[name] - want).max())
            assert err <= 5e-5, (name, err)
            continue
        moved, want_moved = got[name] - init[name], want - init[name]
        if name == "layers.attn_qkvb":
            # the key bias: its exact gradient is zero, so only rounding
            # noise moves it (LAMB's trust ratio is 1 while a leaf is 0)
            key = np.s_[:, d:2 * d]
            assert np.abs(moved[key] - want_moved[key]).max() <= 2e-2, name
            moved, want_moved = (np.delete(a, np.s_[d:2 * d], axis=1)
                                 for a in (moved, want_moved))
        err = float(np.linalg.norm(moved - want_moved) /
                    np.linalg.norm(want_moved))
        assert err <= 0.25, (name, err)
    assert te.flat.check_views()
    assert te.get_optimizer_state()["step"] == 5


def test_bert_engine_state_crosses_both_ways():
    """The engine's JAX-tree methods use the BERT module's converters: the
    master tree comes out with the JAX structure (stacked layer leaves),
    and a JAX engine's masters and LAMB state load bit for bit."""
    batch = tuple(a[None] for a in _batch(12, b=WORLD))
    je, *_ = deepspeed_tpu.initialize(
        model=jbert.make_bert_model(config=jbert.BertConfig(**ENGINE),
                                    seed=7),
        config_params=_ds("fp32", 0, 1))
    for _ in range(2):
        je.train_batch(batch=batch)
    te = deepspeed_tpu_torch.initialize(
        model=tbert.make_bert_model(config=tbert.BertConfig(**ENGINE),
                                    seed=8),
        config_params=_ds("fp32", 0, WORLD), device="cpu")[0]
    tree = te.get_master_params()
    assert sorted(tree) == ["embeddings", "layers", "mlm", "nsp", "pooler"]
    assert tree["layers"]["inter_w"].shape == (2, 64, 256)
    j_master = jax.tree_util.tree_map(np.asarray, je.get_master_params())
    j_opt = jax.tree_util.tree_map(np.asarray, je.state["opt"])
    te.load_state_from_jax(master=j_master, optimizer_state=j_opt)
    back = te.get_optimizer_state()
    assert int(back["step"]) == 2
    for got_tree, want_tree in ((te.get_master_params(), j_master),
                                (back["exp_avg"], j_opt["exp_avg"]),
                                (back["exp_avg_sq"], j_opt["exp_avg_sq"])):
        got = dict(_leaves(got_tree))
        for name, want in _leaves(want_tree):
            assert np.array_equal(got[name], want.astype(np.float32)), name
    j_next = float(je.train_batch(batch=batch))
    t_next = float(te.train_batch(batch=batch))
    np.testing.assert_allclose(t_next, j_next, rtol=1e-5)


def test_pld_schedule_matches_jax_and_reaches_the_forward_if_taken():
    j, t = JaxPLD(theta=0.4, gamma=0.01), TorchPLD(theta=0.4, gamma=0.01)
    for step in range(0, 200, 7):
        j.update_state(step)
        t.update_state(step)
        assert t.get_theta() == j.get_theta()
        assert t.get_state() == j.get_state()

    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, x, progressive_layer_drop=False, pld_theta=None):
            seen.append((progressive_layer_drop, pld_theta))
            return (self.w * x).sum()

    cfg = {"train_micro_batch_size_per_gpu": 1, "steps_per_print": 10 ** 9,
           "progressive_layer_drop": {"enabled": True, "theta": 0.4,
                                      "gamma": 0.01}}
    engine = deepspeed_tpu_torch.initialize(model=Probe(), config_params=cfg,
                                            device="cpu")[0]
    x = np.ones((1, 1, 4), np.float32)
    for _ in range(3):
        engine.train_batch(batch=(x,))
    ref = JaxPLD(theta=0.4, gamma=0.01)
    want = []
    for step in range(3):
        want.append((True, ref.get_theta()))
        ref.update_state(step)
    assert seen == want
    # a model whose module defines no JAX-tree converters
    with pytest.raises(NotImplementedError, match="converters"):
        engine.get_master_params()
    # BERT's forward takes neither kwarg: the section only runs the
    # schedule, as with the JAX BERT
    te = deepspeed_tpu_torch.initialize(
        model=tbert.make_bert_model(config=tbert.BertConfig(**ENGINE)),
        config_params=dict(_ds("fp32", 0, 2), progressive_layer_drop={
            "enabled": True, "theta": 0.5}), device="cpu")[0]
    te.train_batch(batch=tuple(a[None] for a in _batch(13, b=2)))
    assert te.progressive_layer_drop.get_theta() == \
        TorchPLD(theta=0.5).get_theta()   # update_state(0): theta(0) = 1
