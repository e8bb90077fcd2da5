"""GPT-2: configuration, weights, the training forward and loss, and the
KV-cached serving forward.

Port of ``deepspeed_tpu/models/gpt2.py``. The weights are an
:class:`GPT2Model` (``nn.Module``) holding the JAX tree's names (``wte``,
``wpe``, ``blocks.{i}.attn.qkv_kernel``, ``ln_f.scale``, ...) in the JAX
``(in, out)`` layout, so ``x @ W`` reads as in the reference.
:func:`init_params` draws from the same ``np.random.RandomState`` stream
in the same order, so one seed gives the same weights in both packages;
:func:`params_from_jax` / :func:`params_to_jax` carry a JAX tree (the
params, an fp32 master tree, or an Adam moment tree) across, and
:func:`optimizer_state_from_jax` / :func:`optimizer_state_to_jax` the
whole Adam state.

Training: ``GPT2Model.forward(input_ids, labels)`` returns :func:`lm_loss`.
The block is :func:`make_block_fn`'s: on the flash path the fused LN + QKV
+ flash-attention op (``ops/transformer/flash_attention.py``, CUDA
kernels) runs outside ``torch.utils.checkpoint`` and only
:func:`_block_rest` is recomputed under ``remat``, as the JAX package's
``jax.checkpoint`` does; the loss is chunked over the sequence
(:func:`chunked_causal_lm_loss`, each chunk checkpointed) so the full
``(b, s, vocab)`` logits never exist. Dropout draws from an explicit
``torch.Generator``: one seed per layer, so a recomputed block redraws
the same masks.

Serving: the cached forward mirrors the reference function for function.
The KV caches are mutated IN PLACE (the JAX programs donate those buffers
and return new ones): ``_cached_attn_ctx`` / ``_paged_attn_ctx`` write the
new tokens' K/V into the cache they are given and return only the
attention context.
"""
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.paged_attention import paged_attention, paged_attention_reference
from ..ops.sparse_attention import SparseSelfAttention
from ..ops.sparse_attention.sparsity_config import sparsity_config_from_dict
from ..ops.transformer.attention import causal_attention
from ..ops.transformer.flash_attention import fused_ln_qkv_attention
from ..ops.transformer.fused_ops import fused_bias_gelu, fused_layer_norm
from . import _tree
from ._tree import params_from_jax


@dataclass
class GPT2Config:
    vocab_size: int = 50304        # 50257 padded to a multiple of 128
    max_seq_len: int = 1024
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    dropout: float = 0.0
    remat: bool = True             # activation checkpointing per block
    remat_policy: str = "full"     # "full" only (see make_block_fn)
    loss_chunk: int = 128          # CE seq-chunking (0 = dense logits)
    use_flash_attention: bool = True
    # Resolved transformer.flash_attention backend: "pallas" (the fused
    # LN+QKV+flash op: CUDA kernels, or their plain versions on CPU
    # tensors) or "xla" (the dense reference). None: the flash path when
    # use_flash_attention and the weights are on CUDA.
    flash_attention_backend: object = None
    dtype: torch.dtype = torch.float32   # param dtype at init
    # Block-sparse attention: the parsed ds_config "sparse_attention" dict
    # (mode/block/...), e.g. engine.sparse_attention_config(). When set,
    # _attn_ctx runs the block-sparse kernels (ops/sparse_attention)
    # instead of flash, causal; no parameter changes.
    sparse_attention: object = None
    # Paged-attention read path: "xla" (the plain gather-back, the
    # numerics oracle and default) or "pallas" (the CUDA page-walk
    # kernel, ops/paged_attention). The serving engine sets it on the
    # DECODE family only; prefill never reads it.
    paged_attention_kernel: str = "xla"

    @property
    def d_head(self):
        return self.d_model // self.n_heads


SIZES = {
    "gpt2_small": dict(n_layers=12, n_heads=12, d_model=768),      # 125M
    "gpt2_medium": dict(n_layers=24, n_heads=16, d_model=1024),    # 350M
    "gpt2_large": dict(n_layers=36, n_heads=20, d_model=1280),     # 760M
    "gpt2_xl": dict(n_layers=48, n_heads=25, d_model=1600),        # 1.5B
}


def config_for(name, **overrides):
    base = dict(SIZES[name])
    base.update(overrides)
    return GPT2Config(**base)


# ------------------------------------------------------------- weights


def init_block_params(config, rng):
    """One transformer block as a JAX-shaped dict of float32 numpy
    arrays, Megatron init: normal(0, 0.02) with the residual output
    projections scaled by 1/sqrt(2*n_layers). Draws from ``rng`` in the
    reference's order; float64 draws are cast to float32 in numpy."""
    std = 0.02
    proj_std = std / math.sqrt(2.0 * config.n_layers)
    d = config.d_model
    norm = lambda *shape, sd=std: (rng.randn(*shape) * sd).astype(np.float32)
    zeros = lambda *shape: np.zeros(shape, np.float32)
    ones = lambda *shape: np.ones(shape, np.float32)
    return {
        "ln1": {"scale": ones(d), "bias": zeros(d)},
        "attn": {
            "qkv_kernel": norm(d, 3 * d),
            "qkv_bias": zeros(3 * d),
            "proj_kernel": norm(d, d, sd=proj_std),
            "proj_bias": zeros(d),
        },
        "ln2": {"scale": ones(d), "bias": zeros(d)},
        "mlp": {
            "fc_kernel": norm(d, 4 * d),
            "fc_bias": zeros(4 * d),
            "proj_kernel": norm(4 * d, d, sd=proj_std),
            "proj_bias": zeros(d),
        },
    }


def init_params(config, seed=0):
    """The whole model as a JAX-shaped tree of float32 numpy arrays,
    equal bit for bit to the reference ``init_params`` at float32."""
    rng = np.random.RandomState(seed)
    std = 0.02
    d, v, s = config.d_model, config.vocab_size, config.max_seq_len
    norm = lambda *shape, sd=std: (rng.randn(*shape) * sd).astype(np.float32)
    blocks = [init_block_params(config, rng) for _ in range(config.n_layers)]
    return {
        "wte": norm(v, d),
        "wpe": norm(s, d, sd=std / 2),
        "blocks": blocks,
        "ln_f": {"scale": np.ones(d, np.float32),
                 "bias": np.zeros(d, np.float32)},
    }


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class _LayerNorm(nn.Module):
    def __init__(self, d, device, dtype):
        super().__init__()
        self.scale = _param((d,), device, dtype)
        self.bias = _param((d,), device, dtype)


class _Attention(nn.Module):
    def __init__(self, d, device, dtype):
        super().__init__()
        self.qkv_kernel = _param((d, 3 * d), device, dtype)
        self.qkv_bias = _param((3 * d,), device, dtype)
        self.proj_kernel = _param((d, d), device, dtype)
        self.proj_bias = _param((d,), device, dtype)


class _MLP(nn.Module):
    def __init__(self, d, device, dtype):
        super().__init__()
        self.fc_kernel = _param((d, 4 * d), device, dtype)
        self.fc_bias = _param((4 * d,), device, dtype)
        self.proj_kernel = _param((4 * d, d), device, dtype)
        self.proj_bias = _param((d,), device, dtype)


class _Block(nn.Module):
    def __init__(self, d, device, dtype):
        super().__init__()
        self.ln1 = _LayerNorm(d, device, dtype)
        self.attn = _Attention(d, device, dtype)
        self.ln2 = _LayerNorm(d, device, dtype)
        self.mlp = _MLP(d, device, dtype)


class GPT2Model(nn.Module):
    """GPT-2 weights under the JAX tree's names. Construction allocates
    them uninitialised (``torch.empty``) on ``device`` in ``dtype``
    (default ``config.dtype``); :func:`make_gpt2_model` fills them."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        dtype = dtype or config.dtype
        d = config.d_model
        self.wte = _param((config.vocab_size, d), device, dtype)
        self.wpe = _param((config.max_seq_len, d), device, dtype)
        self.blocks = nn.ModuleList(_Block(d, device, dtype)
                                    for _ in range(config.n_layers))
        self.ln_f = _LayerNorm(d, device, dtype)

    def forward(self, input_ids, labels, generator=None):
        """The causal-LM loss (:func:`lm_loss`); dropout (when the config
        has it and the module is training) draws from ``generator``."""
        return lm_loss(self, input_ids, labels, self.config,
                       generator=generator, train=self.training)


def params_to_jax(state_dict):
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the
    JAX-shaped tree of numpy arrays (``blocks`` a list)."""
    tree = _tree.params_to_jax(state_dict)
    blocks = tree["blocks"]
    tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def optimizer_state_from_jax(state):
    """A JAX Adam state ``{"step", "exp_avg": tree, "exp_avg_sq": tree}``
    -> ``{"step": int, "exp_avg": state_dict, "exp_avg_sq": state_dict}``
    (dotted names -> fp32 CPU tensors)."""
    return _tree.optimizer_state_from_jax(state, params_from_jax)


def optimizer_state_to_jax(state):
    """The inverse of :func:`optimizer_state_from_jax`."""
    return _tree.optimizer_state_to_jax(state, params_to_jax)


def make_gpt2_model(config=None, size="gpt2_small", seed=0, **overrides):
    """A :class:`GPT2Model` on the CPU with the reference's seeded
    Megatron init (``init_params``), cast to ``config.dtype``."""
    if config is None:
        config = config_for(size, **overrides)
    model = GPT2Model(config)
    model.load_state_dict(params_from_jax(init_params(config, seed=seed)))
    return model


# ------------------------------------------------------------ the block


def _layer_norm(x, scale, bias, eps=1e-5):
    return fused_layer_norm(x, scale, bias, eps)


def _dropout(x, p, generator):
    """Inverted dropout with keep-probability ``1 - p``, the mask drawn
    from ``generator`` (as ``jax.random.bernoulli`` + ``where``)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _mlp(x, block, config=None, rng=None, train=False):
    h = fused_bias_gelu(x @ block.fc_kernel.to(x.dtype),
                        block.fc_bias.to(x.dtype))
    out = h @ block.proj_kernel.to(x.dtype) + block.proj_bias.to(x.dtype)
    if train and rng is not None and config.dropout > 0.0:
        out = _dropout(out, config.dropout, rng)
    return out


def _block_rest(x, ctx, block_params, config=None, rng=None, train=False):
    """Everything after the attention context: proj + residual + MLP.
    Split out so per-block remat can wrap THIS while the fused attention
    op stays outside (it saves out/lse and recomputes LN+QKV in its own
    backward). ``rng`` is a ``torch.Generator`` (dropout) or None."""
    attn = block_params.attn
    out = ctx @ attn.proj_kernel.to(x.dtype) + attn.proj_bias.to(x.dtype)
    if train and rng is not None and config.dropout > 0.0:
        out = _dropout(out, config.dropout, rng)
    x = x + out
    ln2 = _layer_norm(x, block_params.ln2.scale, block_params.ln2.bias)
    return x + _mlp(ln2, block_params.mlp, config, rng, train)


def _use_fused_attn(config, device):
    """The fused LN+QKV+flash op on the flash path: backend "pallas"
    (kernels on CUDA, their plain versions on the CPU), or, with no
    resolved backend, use_flash_attention on a CUDA device. Never with
    ``sparse_attention``: the block-sparse kernels own the attention."""
    if config.sparse_attention:
        return False
    if config.flash_attention_backend is not None:
        return config.flash_attention_backend == "pallas"
    return config.use_flash_attention and device.type == "cuda"


def _fused_attn_ctx(x, block_params, config):
    return fused_ln_qkv_attention(
        x, block_params.ln1.scale, block_params.ln1.bias,
        block_params.attn.qkv_kernel, block_params.attn.qkv_bias,
        config.n_heads)


def _attn_ctx(x, block, config):
    """QKV projection + attention -> (b, s, d) context, BEFORE the output
    projection (the unfused path: the block-sparse kernels when
    ``sparse_attention`` is set, else the reference attention unless the
    backend is "pallas")."""
    b, s, d = x.shape
    h, dh = config.n_heads, config.d_head
    qkv = x @ block.qkv_kernel.to(x.dtype) + block.qkv_bias.to(x.dtype)
    q, k, v = (t.reshape(b, s, h, dh) for t in qkv.split(d, dim=-1))
    if config.sparse_attention:
        # (b, h, s, d) views of the projection in; out is a (b, h, s, d)
        # view of (b, s, h, d) memory, so the reshape back copies nothing
        attn = _sparse_attn_fn(config, s)
        ctx = attn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return ctx.transpose(1, 2).reshape(b, s, d)
    ctx = causal_attention(q, k, v, use_flash=config.use_flash_attention,
                           backend=config.flash_attention_backend)
    return ctx.reshape(b, s, d)


_SPARSE_ATTN_CACHE = {}          # (config key) -> SparseSelfAttention
_SPARSE_ATTN_CACHE_MAX = 4       # each holds a layout and its tables


def _sparse_attn_fn(config, seq):
    """The cached block-sparse attention for (config, seq): one
    SparseSelfAttention per sparsity config and head count (its layout and
    kernel tables built once), bounded LRU-style; causal."""
    key = (tuple(sorted((k, str(v))
                        for k, v in dict(config.sparse_attention).items())),
           config.n_heads)
    sa = _SPARSE_ATTN_CACHE.pop(key, None)
    if sa is None or sa.max_seq_length < seq:
        sa = SparseSelfAttention(
            sparsity_config=sparsity_config_from_dict(
                dict(config.sparse_attention), config.n_heads),
            max_seq_length=seq, causal=True)
    _SPARSE_ATTN_CACHE[key] = sa                   # re-insert = LRU touch
    while len(_SPARSE_ATTN_CACHE) > _SPARSE_ATTN_CACHE_MAX:
        _SPARSE_ATTN_CACHE.pop(next(iter(_SPARSE_ATTN_CACHE)))
    return sa._kernel(seq, False, False)


def _block(x, block_params, config, rng, train):
    """Unfused block: LN1 + attention context, then :func:`_block_rest`."""
    ln1 = _layer_norm(x, block_params.ln1.scale, block_params.ln1.bias)
    ctx = _attn_ctx(ln1, block_params.attn, config)
    return _block_rest(x, ctx, block_params, config, rng, train)


def _layer_rng(seed, device):
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def make_block_fn(config, train, device):
    """One transformer block as ``block_fn(x, block_params, seed) -> x``
    with the config's remat / fused-attention choices, as the JAX
    package's ``make_block_fn``: on the fused path the attention op runs
    outside the checkpoint (it keeps out + lse and recomputes LN + QKV in
    its backward) and ``torch.utils.checkpoint`` wraps only
    :func:`_block_rest`; otherwise it wraps the whole block. ``seed``
    (or None) seeds the layer's dropout generator inside the checkpointed
    function, so the recompute redraws the same masks."""
    if config.remat and config.remat_policy != "full":
        raise NotImplementedError(
            "remat_policy={!r} is not ported yet (only \"full\"): saving "
            "matmul outputs needs selective checkpointing, a later "
            "slice".format(config.remat_policy))

    def maybe_remat(fn, *args):
        if config.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    if _use_fused_attn(config, device):
        def rest(x, ctx, bp, seed):
            return _block_rest(x, ctx, bp, config, _layer_rng(seed, x.device),
                               train)

        return lambda x, bp, seed: maybe_remat(
            rest, x, _fused_attn_ctx(x, bp, config), bp, seed)

    def block(x, bp, seed):
        return _block(x, bp, config, _layer_rng(seed, x.device), train)

    return lambda x, bp, seed: maybe_remat(block, x, bp, seed)


# --------------------------------------------------------- training loss


def _layer_seeds(config, generator, train):
    if not (train and generator is not None and config.dropout > 0.0):
        return [None] * config.n_layers
    return torch.randint(0, 2 ** 62, (config.n_layers,),
                         generator=generator).tolist()


def causal_lm_cross_entropy(logits, labels):
    """Shifted masked CE; ``labels`` may equal ``input_ids`` (the shift
    happens here); -100 positions are masked."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    mask = (shift_labels != -100).float()
    safe = torch.where(shift_labels == -100,
                       torch.zeros_like(shift_labels), shift_labels)
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return -(token_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_ll(hc, lc, wte):
    """(sum of token log-likelihoods, token count) of one sequence chunk:
    the chunk's logits -> lse + one gathered logit, never log_softmax."""
    logits = (hc @ wte.t()).float()
    mask = lc != -100
    safe = torch.where(mask, lc, torch.zeros_like(lc))
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0] - lse
    return (ll * mask).sum(), mask.sum().float()


def chunked_causal_lm_loss(hidden, wte, labels, chunk):
    """Shifted masked CE without the full (b, s, V) logits: each sequence
    chunk's logits are made, reduced and dropped, and recomputed in the
    backward (``torch.utils.checkpoint`` per chunk, the JAX package's
    ``jax.checkpoint(body)`` under ``lax.scan``)."""
    b, s, d = hidden.shape
    shift_labels = torch.cat(
        [labels[:, 1:], torch.full((b, 1), -100, dtype=labels.dtype,
                                   device=labels.device)], dim=1)
    wte_c = wte.to(hidden.dtype)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, s, chunk):
        hc = hidden[:, c0:c0 + chunk]
        lc = shift_labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            ll, n = checkpoint(_chunk_ll, hc, lc, wte_c, use_reentrant=False)
        else:
            ll, n = _chunk_ll(hc, lc, wte_c)
        tot, cnt = tot + ll, cnt + n
    return -tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, input_ids, labels, config, generator=None, train=True):
    """Causal-LM cross-entropy (mean over tokens) with the tied
    embedding as the head."""
    hidden = forward_hidden(params, input_ids, config, generator=generator,
                            train=train)
    chunk = config.loss_chunk
    if chunk and hidden.shape[1] % chunk == 0 and hidden.shape[1] > chunk:
        return chunked_causal_lm_loss(hidden, params.wte, labels, chunk)
    logits = hidden @ params.wte.to(hidden.dtype).t()
    return causal_lm_cross_entropy(logits, labels)


def num_params(config):
    d, v, s, L = (config.d_model, config.vocab_size, config.max_seq_len,
                  config.n_layers)
    per_block = 12 * d * d + 13 * d
    return v * d + s * d + L * per_block + 2 * d


# ------------------------------------------------------ serving forward


def _qkv_for_cache(x, block, config):
    """Shared QKV projection for the cached attention paths:
    -> q (b, s, h, dh), k/v (b, h, s, dh) (views of one projection)."""
    b, s, d = x.shape
    h, dh = config.n_heads, config.d_head
    qkv = x @ block.qkv_kernel.to(x.dtype) + block.qkv_bias.to(x.dtype)
    q, k, v = qkv.split(d, dim=-1)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, h, dh).transpose(1, 2)
    v = v.reshape(b, s, h, dh).transpose(1, 2)
    return q, k, v


def _attend_cache_rows(q, k_rows, v_rows, positions, dh, valid_lens=None):
    """Absolute-position causal attention of ``s`` new queries over the
    full per-slot cache rows (b, h, S, dh), in fp32. The ``k_pos <=
    q_pos`` mask makes every entry past a slot's live length
    unreachable, and V is zeroed past the live window (``positions +
    valid_lens - 1``; default: all ``s`` tokens real) by a select, so
    stale or NaN rows never reach the weighted sum (``0 * NaN`` would).
    Shared by the slot and paged layouts, so paged decode is
    bit-compatible with the slot-cache oracle."""
    s = q.shape[1]
    S = k_rows.shape[2]
    device = q.device
    qf = q.float() * (1.0 / math.sqrt(dh))
    scores = torch.einsum("bqhd,bhkd->bhqk", qf, k_rows.float())
    k_pos = torch.arange(S, device=device)[None, None, None, :]
    q_pos = (positions.long()[:, None] +
             torch.arange(s, device=device)[None, :])[:, None, :, None]
    scores = scores.masked_fill(k_pos > q_pos, -1e30)
    probs = torch.softmax(scores, dim=-1)
    live = positions.long() + (valid_lens.long() if valid_lens is not None
                               else s) - 1
    dead_v = torch.arange(S, device=device)[None, :] > live[:, None]
    v_rows = v_rows.masked_fill(dead_v[:, None, :, None], 0)
    return torch.einsum("bhqk,bhkd->bqhd", probs, v_rows.float())


def _cached_attn_ctx(x, block, config, k_cache, v_cache, layer_idx,
                     positions):
    """Incremental attention against the slot-based KV cache.

    ``x`` is the LN'd input for ``s`` NEW tokens per slot (batch row i IS
    cache row i of ``k_cache``/``v_cache`` (rows, layers, heads, max_seq,
    d_head)). The new K/V are written IN PLACE at ``positions[i] ..
    positions[i] + s``, which must lie inside the row (the engine
    asserts it; the reference instead clamps the write start), then the
    queries attend over the whole row. Returns the context (b, s, d)."""
    b, s, d = x.shape
    q, k, v = _qkv_for_cache(x, block, config)
    rows = torch.arange(b, device=x.device)[:, None]
    tok_pos = positions.long()[:, None] + \
        torch.arange(s, device=x.device)[None, :]                 # (b, s)
    k_rows, v_rows = k_cache[:, layer_idx], v_cache[:, layer_idx]
    # advanced (row, position) indices split by the heads slice: the
    # value layout is (b, s, h, dh)
    k_rows[rows, :, tok_pos, :] = k.transpose(1, 2).to(k_cache.dtype)
    v_rows[rows, :, tok_pos, :] = v.transpose(1, 2).to(v_cache.dtype)
    ctx = _attend_cache_rows(q, k_rows, v_rows, positions, config.d_head)
    return ctx.to(x.dtype).reshape(b, s, d)


def _paged_write_index(positions, page_tables, valid_lens, page_size, s):
    """Physical (page, offset) of each of the ``s`` new tokens per slot,
    flattened to (b*s,). Padded tokens (``i >= valid_lens[b]``) and
    positions past the page-table window go to the garbage page 0, so a
    bucket-padded prefill never touches another sequence's pages. The
    same for every layer: the forward computes it once."""
    max_pages = page_tables.shape[1]
    ar = torch.arange(s, device=positions.device)
    tok_pos = positions.long()[:, None] + ar[None, :]             # (b, s)
    valid = (ar[None, :] < valid_lens.long()[:, None]) & \
        (tok_pos < max_pages * page_size)
    logical = (tok_pos // page_size).clamp(0, max_pages - 1)
    page = torch.gather(page_tables.long(), 1, logical)
    page = torch.where(valid, page, torch.zeros_like(page))
    return page.reshape(-1), (tok_pos % page_size).reshape(-1)


def _paged_attn_ctx(x, block, config, k_cache, v_cache, layer_idx,
                    positions, page_tables, valid_lens, page_size,
                    write_index=None):
    """Incremental attention against the PAGED KV cache.

    The cache is a global pool ``(pages, layers, heads, page_size,
    d_head)``; ``page_tables`` (b, max_pages) int32 maps each slot's
    logical page j to a physical page (entry 0 = the reserved garbage
    page). Token i of row b is written IN PLACE at physical
    ``(page_tables[b, pos // page_size], pos % page_size)`` by one masked
    scatter (``write_index``, from :func:`_paged_write_index` when not
    given). Reads: ``config.paged_attention_kernel == "pallas"`` runs
    the page-walk kernel (ops/paged_attention), anything else the plain
    gather-back. The write is shared by both, and lands on the same
    stream before the read. Returns the context (b, s, d)."""
    b, s, d = x.shape
    dh = config.d_head
    q, k, v = _qkv_for_cache(x, block, config)
    if write_index is None:
        write_index = _paged_write_index(positions, page_tables, valid_lens,
                                         page_size, s)
    flat_page, flat_off = write_index
    # advanced (page, offset) indices split by the heads slice: the value
    # layout is (b*s, h, dh)
    k_cache[flat_page, layer_idx, :, flat_off, :] = \
        k.transpose(1, 2).reshape(b * s, -1, dh).to(k_cache.dtype)
    v_cache[flat_page, layer_idx, :, flat_off, :] = \
        v.transpose(1, 2).reshape(b * s, -1, dh).to(v_cache.dtype)
    read = paged_attention if config.paged_attention_kernel == "pallas" \
        else paged_attention_reference
    ctx = read(q.contiguous(), k_cache, v_cache, page_tables, positions,
               valid_lens, layer_idx=layer_idx, page_size=page_size)
    return ctx.to(x.dtype).reshape(b, s, d)


def _forward_hidden_cached(params, input_ids, config, cache, positions,
                           page_tables=None, valid_lens=None,
                           page_size=None):
    """Cache-threaded forward for serving -> final hidden states.

    ``cache`` is ``(k, v)``: the slot layout (rows, layers, heads,
    max_seq, d_head), or — when ``page_tables`` is given — the paged
    pool (pages, layers, heads, page_size, d_head) indexed per slot
    through ``page_tables`` (b, max_pages) int32 with ``valid_lens``
    (b,) int32 masking padded writes. ``positions`` (b,) int32 is the
    absolute position of ``input_ids[:, 0]`` per slot. The caches are
    updated in place."""
    b, s = input_ids.shape
    k_cache, v_cache = cache
    compute_dtype = params.ln_f.scale.dtype
    tok = params.wte[input_ids]
    # padded prefill tokens may run past the position table; their rows
    # only ever feed the garbage page, so clamping them changes nothing
    pos_ids = (positions.long()[:, None] +
               torch.arange(s, device=input_ids.device)[None, :]).clamp(
                   max=params.wpe.shape[0] - 1)
    x = tok.to(compute_dtype) + params.wpe[pos_ids].to(compute_dtype)
    write_index = None
    if page_tables is not None:
        write_index = _paged_write_index(positions, page_tables, valid_lens,
                                         page_size, s)
    for i, bp in enumerate(params.blocks):
        ln1 = _layer_norm(x, bp.ln1.scale, bp.ln1.bias)
        if page_tables is not None:
            ctx = _paged_attn_ctx(ln1, bp.attn, config, k_cache, v_cache, i,
                                  positions, page_tables, valid_lens,
                                  page_size, write_index=write_index)
        else:
            ctx = _cached_attn_ctx(ln1, bp.attn, config, k_cache, v_cache,
                                   i, positions)
        x = _block_rest(x, ctx, bp)
    return _layer_norm(x, params.ln_f.scale, params.ln_f.bias)


def forward_hidden(params, input_ids, config, cache=None, positions=None,
                   page_tables=None, valid_lens=None, page_size=None,
                   generator=None, train=False):
    """Embedding + transformer stack -> final hidden states.

    With ``cache`` (a ``(k, v)`` KV-cache pair) the stack runs the
    incremental serving path (see :func:`_forward_hidden_cached`);
    without it, the training stack of :func:`make_block_fn` blocks, with
    dropout drawn from ``generator`` when ``train``."""
    if cache is not None:
        if positions is None:
            positions = torch.zeros((input_ids.shape[0],),
                                    dtype=torch.int32,
                                    device=input_ids.device)
        return _forward_hidden_cached(params, input_ids, config, cache,
                                      positions, page_tables=page_tables,
                                      valid_lens=valid_lens,
                                      page_size=page_size)
    s = input_ids.shape[1]
    compute_dtype = params.ln_f.scale.dtype
    x = params.wte[input_ids].to(compute_dtype) + \
        params.wpe[:s].to(compute_dtype)
    block_fn = make_block_fn(config, train, x.device)
    for bp, seed in zip(params.blocks, _layer_seeds(config, generator,
                                                    train)):
        x = block_fn(x, bp, seed)
    return _layer_norm(x, params.ln_f.scale, params.ln_f.bias)
