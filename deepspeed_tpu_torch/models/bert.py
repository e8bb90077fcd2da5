"""BERT: configuration, weights, the pretraining and SQuAD losses.

Port of ``deepspeed_tpu/models/bert.py``: the encoder is a stack of
``DeepSpeedTransformerLayer`` layers (``ops/transformer/transformer.py``)
under masked-LM + next-sentence pretraining heads, or a SQuAD span head.

The weights are a :class:`BertModel` (``nn.Module``) holding the JAX tree's
names in the JAX ``(in, out)`` layout. As in the JAX package the encoder's
parameters are STACKED: ``layers.attn_qkvw`` is one ``(n_layers, d, 3 d)``
parameter, one ``nn.Parameter`` per JAX leaf (26 for pretraining), not one
per layer. It matters for LAMB, whose trust ratio is taken per leaf: the
engine's segment table has one segment per parameter, so the port steps
the same leaves as the JAX engine does. :func:`init_params` draws from the
same ``np.random.RandomState`` streams in the same order, so one seed gives
the same weights bit for bit at fp32; :func:`params_from_jax` /
:func:`params_to_jax` and the optimizer-state converters carry JAX trees
across (the engine finds them in this module).

Training: ``BertModel.forward(input_ids, token_type_ids, attention_mask,
mlm_labels, nsp_labels, generator=None)`` returns :func:`pretrain_loss`.
The encoder (:func:`encode`) runs each layer under
``torch.utils.checkpoint`` when ``remat``, as the JAX package's
``jax.checkpoint`` over its ``lax.scan`` body; dropout draws from one
``torch.Generator`` per layer, seeded from the engine's generator, so a
recomputed layer redraws the same masks. Attention takes the flash kernels
with the key-padding mask as a key bias on the "pallas" backend (see
``DeepSpeedTransformerConfig.flash_attention_backend``).
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.transformer.fused_ops import fused_layer_norm
from ..ops.transformer.transformer import (PARAM_NAMES,
                                           DeepSpeedTransformerConfig,
                                           _expand_mask,
                                           init_transformer_params,
                                           transformer_layer_forward)
# BERT's tree is dicts only: the shared converters are its own (the
# engine finds them here)
from ._tree import (optimizer_state_from_jax,  # noqa: F401
                    optimizer_state_to_jax, params_from_jax,
                    params_to_jax)


@dataclass
class BertConfig:
    vocab_size: int = 30528        # 30522 padded to a multiple of 64
    max_seq_len: int = 512
    type_vocab_size: int = 2
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_intermediate: int = 3072
    dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True    # reference's deepspeed bert uses pre-LN
    remat: bool = True
    dtype: torch.dtype = torch.float32   # param dtype at init
    # Resolved transformer.flash_attention backend: "pallas" (the flash
    # kernels; their plain versions on CPU tensors) or "xla" (the einsum
    # path). None: "auto", the kernels exactly on a CUDA device.
    flash_attention_backend: object = None


SIZES = {
    "bert_base": dict(n_layers=12, n_heads=12, d_model=768,
                      d_intermediate=3072),
    "bert_large": dict(n_layers=24, n_heads=16, d_model=1024,
                       d_intermediate=4096),
}


def config_for(name, **overrides):
    base = dict(SIZES[name])
    base.update(overrides)
    return BertConfig(**base)


def _layer_config(config):
    return DeepSpeedTransformerConfig(
        hidden_size=config.d_model,
        intermediate_size=config.d_intermediate,
        heads=config.n_heads,
        attn_dropout_ratio=config.attn_dropout,
        hidden_dropout_ratio=config.dropout,
        num_hidden_layers=config.n_layers,
        initializer_range=config.initializer_range,
        layer_norm_eps=config.layer_norm_eps,
        pre_layer_norm=config.pre_layer_norm,
        fp16=config.dtype == torch.bfloat16,
        flash_attention_backend=config.flash_attention_backend or "auto")


# ------------------------------------------------------------- weights


def init_params(config, seed=0):
    """The model as a JAX-shaped tree of float32 numpy arrays, equal bit
    for bit to the reference ``init_params`` at float32: each layer from
    its own ``RandomState(seed + 1 + i)``, stacked on a leading
    (n_layers,) axis; the heads from ``RandomState(seed)`` in the
    reference's order."""
    rng = np.random.RandomState(seed)
    d, v = config.d_model, config.vocab_size
    std = config.initializer_range
    norm = lambda *shape: (rng.randn(*shape) * std).astype(np.float32)
    zeros = lambda *shape: np.zeros(shape, np.float32)
    ones = lambda *shape: np.ones(shape, np.float32)
    layer_cfg = _layer_config(config)
    layers = [init_transformer_params(layer_cfg, seed=seed + 1 + i)
              for i in range(config.n_layers)]
    stacked = {k: np.stack([layer[k] for layer in layers]) for k in
               PARAM_NAMES}
    return {
        "embeddings": {
            "word": norm(v, d),
            "position": norm(config.max_seq_len, d),
            "token_type": norm(config.type_vocab_size, d),
            "ln_scale": ones(d),
            "ln_bias": zeros(d),
        },
        "layers": stacked,
        "pooler": {"kernel": norm(d, d), "bias": zeros(d)},
        "mlm": {
            "transform_kernel": norm(d, d),
            "transform_bias": zeros(d),
            "ln_scale": ones(d),
            "ln_bias": zeros(d),
            "output_bias": zeros(v),
        },
        "nsp": {"kernel": norm(d, 2), "bias": zeros(2)},
    }


def _squad_params(config, seed):
    rng = np.random.RandomState(seed + 977)
    return {"kernel": (rng.randn(config.d_model, 2) *
                       config.initializer_range).astype(np.float32),
            "bias": np.zeros((2,), np.float32)}


def _tree_shapes(config, squad=False):
    """The leaves' shapes, without drawing any weights."""
    d, v, di, L = (config.d_model, config.vocab_size, config.d_intermediate,
                   config.n_layers)
    layer = {"attn_qkvw": (d, 3 * d), "attn_qkvb": (3 * d,),
             "attn_ow": (d, d), "attn_ob": (d,), "attn_nw": (d,),
             "attn_nb": (d,), "inter_w": (d, di), "inter_b": (di,),
             "output_w": (di, d), "output_b": (d,), "norm_w": (d,),
             "norm_b": (d,)}
    tree = {
        "embeddings": {"word": (v, d), "position": (config.max_seq_len, d),
                       "token_type": (config.type_vocab_size, d),
                       "ln_scale": (d,), "ln_bias": (d,)},
        "layers": {k: (L,) + layer[k] for k in PARAM_NAMES},
        "pooler": {"kernel": (d, d), "bias": (d,)},
        "mlm": {"transform_kernel": (d, d), "transform_bias": (d,),
                "ln_scale": (d,), "ln_bias": (d,), "output_bias": (v,)},
        "nsp": {"kernel": (d, 2), "bias": (2,)},
    }
    if squad:
        tree["squad"] = {"kernel": (d, 2), "bias": (2,)}
    return tree


class _Group(nn.Module):
    """One dict of the JAX tree: its leaves as parameters, in order."""

    def __init__(self, shapes, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))


class BertModel(nn.Module):
    """BERT weights under the JAX tree's names (``embeddings.word``,
    ``layers.inter_w`` (n_layers, d, d_intermediate), ``mlm.output_bias``,
    ...). Construction allocates them uninitialised on ``device`` in
    ``dtype`` (default ``config.dtype``); :func:`make_bert_model` fills
    them. The forward is the pretraining loss."""

    with_squad_head = False

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        dtype = dtype or config.dtype
        for group, shapes in _tree_shapes(config, self.with_squad_head).items():
            self.add_module(group, _Group(shapes, device, dtype))

    def forward(self, input_ids, token_type_ids, attention_mask, mlm_labels,
                nsp_labels, generator=None):
        """Masked-LM + NSP loss (:func:`pretrain_loss`); dropout (when the
        config has it and the module is training) draws from
        ``generator``."""
        return pretrain_loss(self, input_ids, token_type_ids, attention_mask,
                             mlm_labels, nsp_labels, self.config,
                             generator=generator, train=self.training)


class BertSquadModel(BertModel):
    """BERT with the SQuAD span head (``squad.kernel``, ``squad.bias``);
    the forward is :func:`squad_loss`."""

    with_squad_head = True

    def forward(self, input_ids, token_type_ids, attention_mask,
                start_positions, end_positions, generator=None):
        return squad_loss(self, input_ids, token_type_ids, attention_mask,
                          start_positions, end_positions, self.config,
                          generator=generator, train=self.training)


def make_bert_model(config=None, size="bert_base", seed=0, **overrides):
    """A pretraining :class:`BertModel` on the CPU with the reference's
    seeded init, cast to ``config.dtype``."""
    if config is None:
        config = config_for(size, **overrides)
    model = BertModel(config)
    model.load_state_dict(params_from_jax(init_params(config, seed=seed)))
    return model


def make_bert_squad_model(config=None, size="bert_base", seed=0,
                          **overrides):
    """A :class:`BertSquadModel` (span-extraction fine-tuning), the
    pretraining init plus the span head from ``RandomState(seed + 977)``."""
    if config is None:
        config = config_for(size, **overrides)
    tree = init_params(config, seed=seed)
    tree["squad"] = _squad_params(config, seed)
    model = BertSquadModel(config)
    model.load_state_dict(params_from_jax(tree))
    return model


def partition_spec_fn(path, shape):
    raise NotImplementedError(
        "BERT's tensor-parallel layout is not ported yet: it comes with the "
        "tensor-parallel slice")


def profile_spec(config, batch_size, seq=None, seed=0, head="pretrain"):
    raise NotImplementedError(
        "BERT's flops-profiler spec is not ported yet: it comes with the "
        "observability slice")


def num_params(config):
    d, v, di = config.d_model, config.vocab_size, config.d_intermediate
    per_layer = 4 * d * d + 2 * d * di + 9 * d + di
    return (v * d + config.max_seq_len * d + config.type_vocab_size * d
            + 2 * d + config.n_layers * per_layer
            + (d * d + d)                       # pooler
            + (d * d + d + 2 * d + v)           # mlm head
            + (2 * d + 2))                      # nsp head


# ---------------------------------------------------------------- forward


def _layer_seeds(config, generator, train):
    if not (train and generator is not None and
            (config.dropout > 0.0 or config.attn_dropout > 0.0)):
        return [None] * config.n_layers
    return torch.randint(0, 2 ** 62, (config.n_layers,),
                         generator=generator).tolist()


def encode(params, input_ids, token_type_ids=None, attention_mask=None,
           config=None, generator=None, train=False):
    """Embeddings + encoder stack -> (b, s, d) hidden states, in the
    parameters' dtype."""
    emb = params.embeddings
    s = input_ids.shape[1]
    x = emb.word[input_ids]
    x = x + emb.position[None, :s]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + emb.token_type[token_type_ids]
    x = fused_layer_norm(x, emb.ln_scale, emb.ln_bias, config.layer_norm_eps)
    x = x.to(emb.word.dtype)

    layer_cfg = _layer_config(config)
    mask = _expand_mask(attention_mask, torch.float32)
    # one unbind per leaf: the backward stacks the layers' gradients once
    slices = [torch.unbind(getattr(params.layers, name), 0)
              for name in PARAM_NAMES]

    def layer(x, seed, *leaves):
        rng = None if seed is None else \
            torch.Generator(device=x.device).manual_seed(seed)
        return transformer_layer_forward(dict(zip(PARAM_NAMES, leaves)), x,
                                         mask, layer_cfg, rng, train)

    for i, seed in enumerate(_layer_seeds(config, generator, train)):
        leaves = [leaf[i] for leaf in slices]
        if config.remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, seed, *leaves, use_reentrant=False)
        else:
            x = layer(x, seed, *leaves)
    return x


def pool(params, hidden):
    """[CLS] -> tanh dense (pooler)."""
    first = hidden[:, 0]
    return torch.tanh(first @ params.pooler.kernel.to(first.dtype) +
                      params.pooler.bias.to(first.dtype))


def mlm_logits(params, hidden, config):
    mlm = params.mlm
    h = hidden @ mlm.transform_kernel.to(hidden.dtype) + \
        mlm.transform_bias.to(hidden.dtype)
    h = F.gelu(h, approximate="tanh")
    h = fused_layer_norm(h, mlm.ln_scale, mlm.ln_bias, config.layer_norm_eps)
    word = params.embeddings.word.to(h.dtype)
    return h @ word.t() + mlm.output_bias.to(h.dtype)


def _class_ll(logits, labels):
    """log-softmax likelihood of ``labels`` along the last dim."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None].long())[..., 0]


def pretrain_loss(params, input_ids, token_type_ids, attention_mask,
                  mlm_labels, nsp_labels, config, generator=None, train=True):
    """Masked-LM CE (over -100-masked labels) + NSP CE."""
    hidden = encode(params, input_ids, token_type_ids, attention_mask,
                    config, generator, train)
    logits = mlm_logits(params, hidden, config).float()
    mask = (mlm_labels != -100).float()
    safe = torch.where(mlm_labels == -100, torch.zeros_like(mlm_labels),
                       mlm_labels)
    token_ll = _class_ll(logits, safe)
    mlm_loss = -(token_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    pooled = pool(params, hidden)
    nsp = (pooled @ params.nsp.kernel.to(pooled.dtype) +
           params.nsp.bias.to(pooled.dtype)).float()
    return mlm_loss - _class_ll(nsp, nsp_labels).mean()


def squad_logits(params, hidden):
    """(batch, seq, 2) fp32 start/end span logits from encoder hiddens."""
    return (hidden @ params.squad.kernel.to(hidden.dtype) +
            params.squad.bias.to(hidden.dtype)).float()


def squad_loss(params, input_ids, token_type_ids, attention_mask,
               start_positions, end_positions, config, generator=None,
               train=True):
    """SQuAD span-extraction loss (BingBertSquad e2e workload)."""
    hidden = encode(params, input_ids, token_type_ids, attention_mask,
                    config, generator, train)
    logits = squad_logits(params, hidden)
    ce = lambda lg, pos: -_class_ll(lg, pos).mean()
    return 0.5 * (ce(logits[..., 0], start_positions) +
                  ce(logits[..., 1], end_positions))
