"""DeepSpeedTransformerLayer: the BERT-style encoder layer.

Port of ``deepspeed_tpu/ops/transformer/transformer.py``
(``TransformerConfig``, ``DeepSpeedTransformerConfig``,
``init_transformer_params``, ``transformer_layer_forward``,
``DeepSpeedTransformerLayer``). The reference fuses the layer's GEMM
epilogues into CUDA ops; here, as in the JAX package, the layer is plain
tensor code (matrix products to ``torch.matmul``, the elementwise epilogues
of ``fused_ops``) around one kernel: bidirectional attention runs the
packed flash kernels (``flash_attention.py``) with the key-padding mask as
an fp32 key bias, non-causal.

* ``normalize_invertible`` / ``gelu_checkpoint`` and
  ``attn_dropout_checkpoint`` recompute their sub-function in the backward
  (``torch.utils.checkpoint``, non-reentrant), where the JAX package wraps
  the same sub-functions in ``jax.checkpoint``.
* The attention backend: the config's ``flash_attention_backend``
  ("auto" | "pallas" | "xla", resolved by ``attention.
  resolve_flash_backend``: "auto" takes the kernels on CUDA and the plain
  reference on the CPU) stands where the JAX gate reads
  ``jax.default_backend() == "tpu"``. "pallas" takes the flash path for a
  key-padding (or no) mask without probability dropout (on CPU tensors the
  kernels' plain versions); anything else runs the einsum path.
* Dropout draws from a ``torch.Generator`` on the activations' device, in
  the order attention probabilities, first residual, second residual.

Parameter names match the reference layer (``attn_qkvw``, ``attn_qkvb``,
``attn_ow``, ``attn_ob``, ``attn_nw``, ``attn_nb``, ``inter_w``,
``inter_b``, ``output_w``, ``output_b``, ``norm_w``, ``norm_b``), in the
JAX ``(in, out)`` layout.
"""
import copy
import json
import math
import warnings

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import resolve_flash_backend
from .fused_ops import (fused_bias_dropout_residual, fused_bias_gelu,
                        fused_layer_norm)

PARAM_NAMES = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
               "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
               "norm_w", "norm_b")


class TransformerConfig:
    """Base config (reference transformer.py:18-36)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1):
        self.layer_id = -1
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range


class DeepSpeedTransformerConfig(TransformerConfig):
    """All knobs of the reference config. ``fp16`` selects bf16 parameters
    and compute, as in the JAX package; ``local_rank`` is accepted and
    ignored. ``flash_attention_backend`` is the port's attention switch
    (see the module docstring)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1,
                 layer_norm_eps=1e-12, local_rank=-1, seed=-1, fp16=False,
                 pre_layer_norm=True, normalize_invertible=False,
                 gelu_checkpoint=False, adjust_init_range=True,
                 attn_dropout_checkpoint=False, stochastic_mode=False,
                 huggingface=False, training=True,
                 flash_attention_backend="auto"):
        super().__init__(
            batch_size, hidden_size,
            intermediate_size if intermediate_size > 0 else 4 * hidden_size,
            heads, attn_dropout_ratio, hidden_dropout_ratio,
            num_hidden_layers, initializer_range)
        self.layer_norm_eps = layer_norm_eps
        self.pre_layer_norm = pre_layer_norm
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        if stochastic_mode:
            warnings.warn(
                "stochastic_mode has no distinct kernel in this port: the "
                "reference's stochastic transformer op trades determinism "
                "for speed inside its fused CUDA layer, which this layer "
                "does not have, so the flag is a no-op here", stacklevel=2)
        self.huggingface = huggingface
        self.training = training
        self.flash_attention_backend = flash_attention_backend

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.fp16 else torch.float32

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            config.__dict__[key] = value
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def init_transformer_params(config, seed=None):
    """One encoder layer's params as a dict of float32 numpy arrays, the
    reference's scheme: normal(0, initializer_range), output projections
    scaled by 1/sqrt(2 * num_hidden_layers) when ``adjust_init_range``.
    Draws from ``np.random.RandomState`` in the JAX package's order, so a
    seed gives the same values (cast to ``config.compute_dtype`` by the
    caller)."""
    seed = config.seed if seed is None else seed
    rng = np.random.RandomState(seed if seed is not None and seed >= 0 else 0)
    d = config.hidden_size
    di = config.intermediate_size
    std = config.initializer_range if config.initializer_range > 0 else 0.02
    out_std = std
    if config.adjust_init_range and config.num_hidden_layers > 0:
        out_std = std / math.sqrt(2.0 * config.num_hidden_layers)
    norm = lambda *shape, sd=std: (rng.randn(*shape) * sd).astype(np.float32)
    zeros = lambda *shape: np.zeros(shape, np.float32)
    ones = lambda *shape: np.ones(shape, np.float32)
    return {
        "attn_qkvw": norm(d, 3 * d),
        "attn_qkvb": zeros(3 * d),
        "attn_ow": norm(d, d, sd=out_std),
        "attn_ob": zeros(d),
        "attn_nw": ones(d),
        "attn_nb": zeros(d),
        "inter_w": norm(d, di),
        "inter_b": zeros(di),
        "output_w": norm(di, d, sd=out_std),
        "output_b": zeros(d),
        "norm_w": ones(d),
        "norm_b": zeros(d),
    }


def _expand_mask(attention_mask, dtype):
    """Accept (b, s) 0/1 keep-masks or pre-expanded additive masks
    ((b, 1, 1, s) / (b, 1, s, s)); return the additive (b, 1, *, s) mask
    in ``dtype`` (-1e9 where a key is dropped)."""
    if attention_mask is None:
        return None
    m = torch.as_tensor(attention_mask)
    if m.dim() == 2:
        keep = m.to(torch.float32)
        return ((1.0 - keep) * -1e9)[:, None, None, :].to(dtype)
    return m.to(dtype)


def _attention_backend(config, device):
    backend = getattr(config, "flash_attention_backend", "auto")
    return resolve_flash_backend("auto" if backend is None else backend,
                                 device)


def _self_attention(x, params, config, mask, generator, train):
    """Bidirectional multi-head attention -> the output projection (its
    bias is added by the caller).

    Flash path: backend "pallas", a key-padding (or no) mask and no
    probability dropout; the packed kernels take the mask as an fp32 key
    bias, so the (b, h, s, s) scores never reach device memory. Otherwise
    the einsum path: scores in the activations' dtype plus the fp32 mask
    (promoting to fp32, as in JAX), softmax in fp32."""
    b, s, d = x.shape
    h = config.heads
    dh = d // h
    qkv = x @ params["attn_qkvw"].to(x.dtype) + \
        params["attn_qkvb"].to(x.dtype)
    q, k, v = qkv.split(d, dim=-1)
    split = lambda t: t.reshape(b, s, h, dh)

    dropout_on = train and config.attn_dropout_ratio > 0 and \
        generator is not None
    key_padding_only = mask is None or (mask.dim() == 4 and
                                        mask.shape[1] == 1 and
                                        mask.shape[2] == 1)
    if _attention_backend(config, x.device) == "pallas" and \
            key_padding_only and not dropout_on:
        from .flash_attention import flash_attention_bshd
        mask_bias = None if mask is None else mask[:, 0, 0, :]
        ctx = flash_attention_bshd(split(q), split(k), split(v),
                                   1.0 / math.sqrt(dh), False,
                                   mask_bias=mask_bias)
        return ctx.reshape(b, s, d) @ params["attn_ow"].to(x.dtype)

    scores = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) / \
        math.sqrt(dh)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)

    def apply_dropout_and_context(probs, v):
        p = probs
        if dropout_on:
            keep_p = 1.0 - config.attn_dropout_ratio
            keep = torch.rand(p.shape, generator=generator, device=p.device,
                              dtype=torch.float32) < keep_p
            p = torch.where(keep, p / keep_p, torch.zeros_like(p)).to(p.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
        return ctx.reshape(b, s, d)

    if config.attn_dropout_checkpoint and torch.is_grad_enabled():
        if dropout_on:
            # the recompute redraws the forward's mask, then puts the
            # generator back where the backward found it
            state, calls = generator.get_state(), []
            inner = apply_dropout_and_context

            def apply_dropout_and_context(probs, v):
                if not calls:
                    calls.append(1)
                    return inner(probs, v)
                current = generator.get_state()
                generator.set_state(state)
                try:
                    return inner(probs, v)
                finally:
                    generator.set_state(current)
        ctx = checkpoint(apply_dropout_and_context, probs, v,
                         use_reentrant=False)
    else:
        ctx = apply_dropout_and_context(probs, v)
    return ctx @ params["attn_ow"].to(x.dtype)


def transformer_layer_forward(params, hidden_states, attention_mask=None,
                              config=None, generator=None, train=None):
    """One encoder layer, pre- or post-LN. ``params``: the twelve tensors by
    name (a layer's parameters, or one layer's slices of a stacked tree);
    ``generator``: a ``torch.Generator`` on the activations' device for
    dropout, or None."""
    train = config.training if train is None else train
    x = hidden_states
    eps = config.layer_norm_eps
    mask = _expand_mask(attention_mask, torch.float32)
    if mask is not None:
        mask = mask.to(x.device)

    if config.pre_layer_norm:
        attn_in = fused_layer_norm(x, params["attn_nw"], params["attn_nb"],
                                   eps)
    else:
        attn_in = x
    attn_out = _self_attention(attn_in, params, config, mask, generator,
                               train)
    x = fused_bias_dropout_residual(attn_out, params["attn_ob"], x,
                                    config.hidden_dropout_ratio, generator,
                                    train)
    if not config.pre_layer_norm:
        x = fused_layer_norm(x, params["attn_nw"], params["attn_nb"], eps)

    def ffn(y, norm_w, norm_b, inter_w, inter_b, output_w):
        inter_in = fused_layer_norm(y, norm_w, norm_b, eps) \
            if config.pre_layer_norm else y
        inter = fused_bias_gelu(inter_in @ inter_w.to(y.dtype),
                                inter_b.to(y.dtype))
        return inter @ output_w.to(y.dtype)

    ffn_args = (x, params["norm_w"], params["norm_b"], params["inter_w"],
                params["inter_b"], params["output_w"])
    if (config.gelu_checkpoint or config.normalize_invertible) and \
            torch.is_grad_enabled():
        # recompute the FFN (its LN input included) in the backward
        ffn_out = checkpoint(ffn, *ffn_args, use_reentrant=False)
    else:
        ffn_out = ffn(*ffn_args)
    x = fused_bias_dropout_residual(ffn_out, params["output_b"], x,
                                    config.hidden_dropout_ratio, generator,
                                    train)
    if not config.pre_layer_norm:
        x = fused_layer_norm(x, params["norm_w"], params["norm_b"], eps)
    return x


class DeepSpeedTransformerLayer(nn.Module):
    """The layer as an ``nn.Module`` holding its twelve parameters
    (reference transformer.py:155). ``layer_id`` mirrors the reference's
    class-wide layer counter. ``initial_weights`` / ``initial_biases`` are
    the reference's HF-ordered lists (qkv split in three, attention
    output, attention LN, intermediate, output, output LN), weights in the
    torch ``(out, in)`` layout, transposed on load."""

    layer_count = 0

    def __init__(self, config, initial_weights=None, initial_biases=None,
                 seed=None, device=None):
        super().__init__()
        self.config = copy.deepcopy(config)
        self.config.layer_id = DeepSpeedTransformerLayer.layer_count
        DeepSpeedTransformerLayer.layer_count += 1
        self._initial = (initial_weights, initial_biases)
        dtype = self.config.compute_dtype
        for name, value in self.init_params(seed).items():
            self.register_parameter(name, nn.Parameter(
                torch.from_numpy(value).to(device=device, dtype=dtype)))

    def init_params(self, seed=None):
        """The layer's params as a dict of float32 numpy arrays, the
        initial weights and biases loaded over the seeded init."""
        params = init_transformer_params(self.config, seed=seed)
        weights, biases = self._initial
        arr = lambda t: np.asarray(t, np.float32)
        if weights is not None:
            params["attn_qkvw"] = np.concatenate(
                [arr(weights[0]).T, arr(weights[1]).T, arr(weights[2]).T],
                axis=-1)
            params["attn_ow"] = arr(weights[3]).T
            params["attn_nw"] = arr(weights[4])
            params["inter_w"] = arr(weights[5]).T
            params["output_w"] = arr(weights[6]).T
            params["norm_w"] = arr(weights[7])
        if biases is not None:
            params["attn_qkvb"] = np.concatenate(
                [arr(biases[0]), arr(biases[1]), arr(biases[2])])
            params["attn_ob"] = arr(biases[3])
            params["attn_nb"] = arr(biases[4])
            params["inter_b"] = arr(biases[5])
            params["output_b"] = arr(biases[6])
            params["norm_b"] = arr(biases[7])
        return {k: np.ascontiguousarray(v) for k, v in params.items()}

    def forward(self, hidden_states, attention_mask=None, generator=None,
                train=None):
        """``train`` None: the module is training and ``config.training``."""
        if train is None:
            train = self.training and self.config.training
        params = {name: getattr(self, name) for name in PARAM_NAMES}
        return transformer_layer_forward(params, hidden_states,
                                         attention_mask, self.config,
                                         generator, train)
