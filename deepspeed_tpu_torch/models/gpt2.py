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
``jax.checkpoint`` does (``remat_policy`` "full" recomputes all of it,
"dots" keeps the linear layers' outputs); the loss is chunked over the sequence
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
import dataclasses
import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.paged_attention import paged_attention, paged_attention_reference
from ..ops.sparse_attention import SparseSelfAttention
from ..ops.sparse_attention.sparsity_config import sparsity_config_from_dict
from ..ops.sparse_grads import sparse_embedding_lookup
from ..ops.transformer.attention import causal_attention
from ..ops.transformer.flash_attention import fused_ln_qkv_attention
from ..ops.transformer.fused_ops import fused_bias_gelu, fused_layer_norm
from ..parallel.collective_matmul import (gather_rows, sum_across,
                                          tp_column_matmul, tp_row_matmul)
from ..parallel.topology import MODEL_AXIS
from ..utils.distributed import (all_gather, all_reduce_,
                                 reduce_scatter)
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
    remat_policy: str = "full"     # "full" | "dots" (see make_block_fn)
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
    # Tensor parallelism (comm.collective_matmul): a
    # parallel.collective_matmul.CollectiveMatmulBinding, set on the
    # shard's own copy of the config when the engine's mesh has a
    # ``model`` axis > 1. The model is then this rank's shard
    # (GPT2Model.tensor_parallel_shard), the residual stream holds
    # this rank's rows of the sequence, and the four TP sites run the ring
    # ops; None keeps the plain matmuls.
    collective_matmul: object = None
    # Sparse embedding-gradient exchange (ds_config "sparse_gradients",
    # ops/sparse_grads.py): the lookup's backward all-gathers (ids, rows)
    # over the ``data`` axis of ``embedding_grad_mesh`` (the engine's
    # ProcessMesh) and densifies them; no mesh or a trivial axis keeps the
    # plain lookup.
    sparse_embedding_grads: bool = False
    embedding_grad_mesh: object = None

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
    def __init__(self, d, device, dtype, tp=1):
        super().__init__()
        self.qkv_kernel = _param((d, 3 * d // tp), device, dtype)
        self.qkv_bias = _param((3 * d // tp,), device, dtype)
        self.proj_kernel = _param((d // tp, d), device, dtype)
        self.proj_bias = _param((d,), device, dtype)


class _MLP(nn.Module):
    def __init__(self, d, device, dtype, tp=1):
        super().__init__()
        self.fc_kernel = _param((d, 4 * d // tp), device, dtype)
        self.fc_bias = _param((4 * d // tp,), device, dtype)
        self.proj_kernel = _param((4 * d // tp, d), device, dtype)
        self.proj_bias = _param((d,), device, dtype)


class _Block(nn.Module):
    def __init__(self, d, device, dtype, tp=1):
        super().__init__()
        self.ln1 = _LayerNorm(d, device, dtype)
        self.attn = _Attention(d, device, dtype, tp)
        self.ln2 = _LayerNorm(d, device, dtype)
        self.mlp = _MLP(d, device, dtype, tp)


class GPT2Model(nn.Module):
    """GPT-2 weights under the JAX tree's names. Construction allocates
    them uninitialised (``torch.empty``) on ``device`` in ``dtype``
    (default ``config.dtype``); :func:`make_gpt2_model` fills them.

    ``tp_size > 1`` allocates one rank's tensor-parallel shard
    (:func:`partition_spec_fn`): ``wte`` by vocabulary rows, the qkv and
    fc kernels and biases by columns, the two proj kernels by rows; the
    rest whole. :meth:`tensor_parallel_shard` cuts one from a full
    model."""

    def __init__(self, config, device=None, dtype=None, tp_size=1):
        super().__init__()
        self.config = config
        self.tp_size = tp_size
        dtype = dtype or config.dtype
        d = config.d_model
        if tp_size > 1 and (config.n_heads % tp_size or
                            config.vocab_size % tp_size):
            raise ValueError(
                "tensor parallelism {} must divide n_heads {} and "
                "vocab_size {}".format(tp_size, config.n_heads,
                                       config.vocab_size))
        self.wte = _param((config.vocab_size // tp_size, d), device, dtype)
        self.wpe = _param((config.max_seq_len, d), device, dtype)
        self.blocks = nn.ModuleList(_Block(d, device, dtype, tp_size)
                                    for _ in range(config.n_layers))
        self.ln_f = _LayerNorm(d, device, dtype)

    def tensor_parallel_shard(self, binding):
        """This rank's shard of this full model for the ring of
        ``binding`` (a CollectiveMatmulBinding over more than one rank): a
        new module on the same device whose config is a copy carrying the
        binding; this model and its config stay as they are."""
        if self.tp_size != 1:
            raise ValueError("tensor_parallel_shard: the model is already "
                             "a shard of {}".format(self.tp_size))
        rank, size = binding.rank, binding.size
        if size < 2:
            raise ValueError("tensor_parallel_shard: a ring of {} rank has "
                             "nothing to shard".format(size))
        p = next(self.parameters())
        shard = GPT2Model(dataclasses.replace(self.config,
                                              collective_matmul=binding),
                          device=p.device, dtype=p.dtype, tp_size=size)
        with torch.no_grad():
            shard.load_state_dict(tp_shard_state_dict(self.state_dict(),
                                                      rank, size))
        return shard

    def forward(self, input_ids, labels, generator=None):
        """The causal-LM loss (:func:`lm_loss`); dropout (when the config
        has it and the module is training) draws from ``generator``."""
        return lm_loss(self, input_ids, labels, self.config,
                       generator=generator, train=self.training)

    @property
    def stream_spec(self):
        """The streamed-offload decomposition (:func:`stream_spec_for`),
        None for the configs it does not compose with (the engine then
        refuses ``cpu_offload_params``), as the JAX package attaches
        none."""
        if self.config.sparse_embedding_grads:
            return None
        return stream_spec_for(self.config)


# ------------------------------------------------- tensor-parallel layout


def partition_spec_fn(path, shape):
    """The Megatron TP layout on the ``model`` axis, as the JAX package's
    spec tuples: ``wte`` by vocabulary rows, the qkv/fc kernels by columns
    and their biases with them, the two proj kernels by rows; None (whole
    on every rank) for the layer norms, ``wpe`` and the proj biases.
    ``shape`` is unused (the port has no stacked layer dim)."""
    if path.endswith("wte"):
        return (MODEL_AXIS, None)
    if "qkv_kernel" in path or "fc_kernel" in path:
        return (None, MODEL_AXIS)
    if "qkv_bias" in path or "fc_bias" in path:
        return (MODEL_AXIS,)
    if "proj_kernel" in path:
        return (MODEL_AXIS, None)
    return None


def _shard_dim(name):
    spec = partition_spec_fn(name, None)
    return None if spec is None else spec.index(MODEL_AXIS)


def tp_shard_state_dict(state_dict, rank, size):
    """Rank ``rank``'s shard of a full ``state_dict`` (the JAX tree's
    dotted names) for a ring of ``size``. The qkv kernel and bias take
    columns ``[rank*d/size, (rank+1)*d/size)`` of EACH of q, k and v, so
    the rank's product splits into its own heads; the JAX package shards
    the fused (d, 3d) columns contiguously and lets GSPMD reshard after
    the split, which computes the same numbers."""
    out = {}
    for name, t in state_dict.items():
        dim = _shard_dim(name)
        if dim is None:
            out[name] = t
        elif "qkv" in name:
            parts = t.reshape(t.shape[:-1] + (3, t.shape[-1] // 3))
            out[name] = parts.chunk(size, dim=-1)[rank].reshape(
                t.shape[:-1] + (-1,)).contiguous()
        else:
            out[name] = t.chunk(size, dim=dim)[rank].contiguous()
    return out


def tp_gather_state_dicts(shards):
    """The inverse of :func:`tp_shard_state_dict`: every rank's shard, in
    rank order -> the full ``state_dict`` (replicated entries from rank
    0)."""
    out = {}
    for name, t in shards[0].items():
        dim = _shard_dim(name)
        if dim is None:
            out[name] = t
        elif "qkv" in name:
            parts = [s[name].reshape(t.shape[:-1] + (3, -1)) for s in shards]
            out[name] = torch.cat(parts, dim=-1).reshape(
                t.shape[:-1] + (-1,))
        else:
            out[name] = torch.cat([s[name] for s in shards], dim=dim)
    return out


def tp_full_boxes(name, shard_shape, box, rank, size):
    """A box ``((lo, hi), ...)`` of rank ``rank``'s shard of ``name`` (as
    :func:`tp_shard_state_dict` cuts it for a ring of ``size``) -> the full
    leaf's shape and ``[(box of the full leaf, index of that part within
    the box's data)]``: one part, shifted along the sharded dimension, or
    for the qkv kernel and bias up to three, one each of q, k and v."""
    dim = _shard_dim(name)
    if dim is None:
        return tuple(shard_shape), [(tuple(box), ())]
    full = list(shard_shape)
    full[dim] *= size
    n = shard_shape[dim]
    if "qkv" not in name:
        shifted = list(box)
        lo, hi = box[dim]
        shifted[dim] = (lo + rank * n, hi + rank * n)
        return tuple(full), [(tuple(shifted), ())]
    local, d = n // 3, n // 3 * size
    lo, hi = box[-1]
    parts = []
    for j in range(3):
        a, b = max(lo, j * local), min(hi, (j + 1) * local)
        if a < b:
            start = j * d + rank * local - j * local
            parts.append((tuple(box[:-1]) + ((start + a, start + b),),
                          (Ellipsis, slice(a - lo, b - lo))))
    return tuple(full), parts


def params_to_jax(state_dict, keep_dtype=False):
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the
    JAX-shaped tree of numpy arrays (``blocks`` a list; CPU tensors of
    their own dtype with ``keep_dtype``)."""
    tree = _tree.params_to_jax(state_dict, keep_dtype)
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


def _tp_binding(config):
    """The tensor-parallel binding the engine attached (only on a ring of
    more than one rank, to a shard's own config), or None."""
    return getattr(config, "collective_matmul", None)


def _column_matmul(x, w, config):
    """x @ w at a column-parallel site (qkv, fc): the ring all-gather
    matmul under a binding, the plain matmul otherwise."""
    binding = _tp_binding(config)
    return x @ w if binding is None else tp_column_matmul(x, w, binding)


def _row_matmul(x, w, config, reduce=None):
    """x @ w at a row-parallel site (attention proj, mlp proj): the ring
    matmul-reduce-scatter under a binding (the output leaves
    sequence-sharded), the plain matmul otherwise, summed over the ranks
    by ``reduce`` when one is given (tensor-parallel serving: each rank
    holds whole activations and its rows of ``w``)."""
    binding = _tp_binding(config)
    if binding is not None:
        return tp_row_matmul(x, w, binding)
    y = x @ w
    return y if reduce is None else reduce(y)


def _mlp(x, block, config=None, rng=None, train=False, reduce=None):
    h = fused_bias_gelu(_column_matmul(x, block.fc_kernel.to(x.dtype),
                                       config),
                        block.fc_bias.to(x.dtype))
    out = _row_matmul(h, block.proj_kernel.to(x.dtype), config, reduce) + \
        block.proj_bias.to(x.dtype)
    if train and rng is not None and config.dropout > 0.0:
        out = _dropout(out, config.dropout, rng)
    return out


def _block_rest(x, ctx, block_params, config=None, rng=None, train=False,
                reduce=None):
    """Everything after the attention context: proj + residual + MLP.
    Split out so per-block remat can wrap THIS while the fused attention
    op stays outside (it saves out/lse and recomputes LN+QKV in its own
    backward). ``rng`` is a ``torch.Generator`` (dropout) or None;
    ``reduce`` sums each row-parallel product over the serving TP group
    (before its bias, which is added once)."""
    attn = block_params.attn
    out = _row_matmul(ctx, attn.proj_kernel.to(x.dtype), config, reduce) + \
        attn.proj_bias.to(x.dtype)
    if train and rng is not None and config.dropout > 0.0:
        out = _dropout(out, config.dropout, rng)
    x = x + out
    ln2 = _layer_norm(x, block_params.ln2.scale, block_params.ln2.bias)
    return x + _mlp(ln2, block_params.mlp, config, rng, train, reduce)


def _use_fused_attn(config, device):
    """The fused LN+QKV+flash op on the flash path: backend "pallas"
    (kernels on CUDA, their plain versions on the CPU), or, with no
    resolved backend, use_flash_attention on a CUDA device. Never with
    ``sparse_attention``: the block-sparse kernels own the attention."""
    if config.sparse_attention or _tp_binding(config) is not None:
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
    """QKV projection + attention -> (b, s, d_local) context, BEFORE the
    output projection (the unfused path: the block-sparse kernels when
    ``sparse_attention`` is set, else the reference attention unless the
    backend is "pallas").

    Under tensor parallelism x is this rank's rows (b, s/n, d) and the
    qkv product is the ring all-gather matmul: the context covers the
    whole sequence for this rank's n_heads/n heads. The JAX package's
    fused LN+QKV+flash op ignores the binding (GSPMD gathers its qkv
    product on the TPU); the port has no GSPMD, so under a live binding
    the qkv product rides the ring here and the flash kernels run on the
    local heads: the op that computes qkv differs, the result does
    not."""
    b = x.shape[0]
    dh = config.d_head
    qkv = _column_matmul(x, block.qkv_kernel.to(x.dtype), config) + \
        block.qkv_bias.to(x.dtype)
    s, d = qkv.shape[1], qkv.shape[2] // 3
    h = d // dh
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


REMAT_POLICIES = ("full", "dots")
# the products with no batch dimension: the linear layers (a (b, s, d) @
# (d, f) product reaches aten.mm through matmul's fold), never attention's
# batched products
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the output of every product with no batch dimension, recompute the
    rest. A product inside a custom autograd op's forward (grad mode is
    off there: the tensor-parallel ring ops) is recomputed with its op,
    as the JAX package recomputes a ``pallas_call``."""
    if op in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def make_block_fn(config, train, device):
    """One transformer block as ``block_fn(x, block_params, seed) -> x``
    with the config's remat / fused-attention choices, as the JAX
    package's ``make_block_fn``: on the fused path the attention op runs
    outside the checkpoint (it keeps out + lse and recomputes LN + QKV in
    its backward) and ``torch.utils.checkpoint`` wraps only
    :func:`_block_rest`; otherwise it wraps the whole block. ``seed``
    (or None) seeds the layer's dropout generator inside the checkpointed
    function, so the recompute redraws the same masks.

    ``remat_policy``: "full" recomputes everything in the backward;
    "dots" keeps the outputs of the products with no batch dimension (the
    qkv, proj and fc matmuls, ``aten.mm``) and recomputes the rest (layer
    norms, GeLU, biases, dropout, attention's batched products), through
    ``torch.utils.checkpoint``'s selective checkpointing. Under tensor
    parallelism the four TP products run as ring ops (custom autograd
    functions over the CUDA ring kernels), which are not saveable dots:
    they are recomputed, as the JAX package recomputes a ``pallas_call``
    under this policy."""
    if config.remat_policy not in REMAT_POLICIES:
        raise ValueError("remat_policy must be one of {}, got {!r}".format(
            "|".join(REMAT_POLICIES), config.remat_policy))
    context = {"full": {}, "dots": {"context_fn": _dots_contexts}}[
        config.remat_policy]

    def maybe_remat(fn, *args):
        if config.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, **context)
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


def _shifted_labels(labels):
    """labels[:, 1:] with -100 in the last position (b, s)."""
    b = labels.shape[0]
    return torch.cat([labels[:, 1:],
                      torch.full((b, 1), -100, dtype=labels.dtype,
                                 device=labels.device)], dim=1)


def _chunked_ll(hidden, wte, shift_labels, chunk):
    """(sum of token log-likelihoods, token count) over ``hidden``'s rows,
    chunk by chunk (each chunk checkpointed)."""
    s = hidden.shape[1]
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
    return tot, cnt


def chunked_causal_lm_loss(hidden, wte, labels, chunk):
    """Shifted masked CE without the full (b, s, V) logits: each sequence
    chunk's logits are made, reduced and dropped, and recomputed in the
    backward (``torch.utils.checkpoint`` per chunk, the JAX package's
    ``jax.checkpoint(body)`` under ``lax.scan``)."""
    tot, cnt = _chunked_ll(hidden, wte, _shifted_labels(labels), chunk)
    return -tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, input_ids, labels, config, generator=None, train=True):
    """Causal-LM cross-entropy (mean over tokens) with the tied
    embedding as the head. Under ZeRO stage 3 (the engine's runtime on
    ``params._zero3``) the same computation runs unit by unit with each
    unit's parameters gathered around it (:func:`_zero3_lm_loss`)."""
    z3 = getattr(params, "_zero3", None)
    if z3 is not None:
        return _zero3_lm_loss(params, input_ids, labels, config, generator,
                              train, z3)
    binding = _tp_binding(config)
    hidden, wte = _forward_hidden_train(params, input_ids, config,
                                        generator, train)
    if binding is not None:
        return _tp_lm_loss(hidden, wte, labels, config, binding)
    return _head_loss(hidden, params.wte, labels, config)


def _tp_lm_loss(hidden, wte, labels, config, binding):
    """The loss under tensor parallelism: this rank's rows against the
    gathered table, their labels cut from the full labels every rank
    holds (a block's last row takes its label from the next block), the
    sum all-reduced over the ring and divided by the global count."""
    shifted = _shifted_labels(labels)
    local = shifted[:, _local_rows(labels.shape[1], binding)]
    s_loc, chunk = hidden.shape[1], config.loss_chunk
    if chunk and s_loc % chunk == 0 and s_loc > chunk:
        tot, _ = _chunked_ll(hidden, wte, local, chunk)
    else:
        tot, _ = _chunk_ll(hidden, local, wte.to(hidden.dtype))
    cnt = (shifted != -100).sum().float()
    return -sum_across(tot, binding.group) / torch.clamp(cnt, min=1.0)


def _head_loss(hidden, wte, labels, config):
    """The loss from the final hidden states, the tied table as the head
    (chunked over the sequence when ``loss_chunk`` divides it)."""
    chunk = config.loss_chunk
    if chunk and hidden.shape[1] % chunk == 0 and hidden.shape[1] > chunk:
        return chunked_causal_lm_loss(hidden, wte, labels, chunk)
    logits = hidden @ wte.to(hidden.dtype).t()
    return causal_lm_cross_entropy(logits, labels)


def zero3_units(module):
    """ZeRO stage 3's gather units of a :class:`GPT2Model`, in forward
    order: the embedding (``wte``, ``wpe``), each block, ``ln_f``."""
    names = [n for n, _ in module.named_parameters()]
    units = [("embed", [n for n in names if n in ("wte", "wpe")])]
    units += [("blocks.{}".format(i),
               [n for n in names if n.startswith("blocks.{}.".format(i))])
              for i in range(len(module.blocks))]
    units.append(("ln_f", [n for n in names if n.startswith("ln_f.")]))
    return units


class _TiedRows(torch.autograd.Function):
    """``gather_rows`` for the two stage-3 calls that share the vocabulary
    shards of ``wte`` under tensor parallelism: the head's call (whose
    backward runs first) keeps its gradient of the gathered table in
    ``held``, and the embedding's call reduce-scatters the sum of both
    over the ring once, as autograd sums the two uses of one gathered
    table before ``gather_rows``' reduce-scatter on the path without
    ZeRO-3."""

    @staticmethod
    def forward(ctx, w, group, held, last):
        ctx.group, ctx.held, ctx.last = group, held, last
        return all_gather(w, group, dim=0)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.last:
            ctx.held["grad"] = grad
            return None, None, None, None
        kept = ctx.held.pop("grad", None)
        if kept is not None:
            grad = grad + kept
        return reduce_scatter(grad.contiguous(), ctx.group, dim=0), \
            None, None, None


def _zero3_lm_loss(params, input_ids, labels, config, generator, train, z3):
    """:func:`lm_loss` under ZeRO stage 3: the embedding, each block and
    the head (``ln_f`` and the loss, borrowing the embedding unit for the
    tied ``wte``) each run as one ``z3.call``, which gathers the unit's
    parameters over the data group around the call and again for its
    backward (``runtime/zero/stage3.py``). The call recomputes its unit in
    the backward, so the blocks run with ``remat`` off inside it. The
    operations, and so the values, are those of the path without ZeRO-3:
    under tensor parallelism the units hold the rank's shards, the calls
    run the ring ops over the model group (again in each recompute), and
    the two uses of the gathered ``wte`` reduce-scatter their summed
    gradient once (:class:`_TiedRows`); with ``sparse_embedding_grads``
    the lookup's ``(ids, rows)`` exchange runs inside the embedding's
    recompute."""
    binding = _tp_binding(config)
    dtype = z3.flat.compute_dtype
    s = input_ids.shape[1]
    rows = _local_rows(s, binding)
    held = {}

    def table(last):
        if binding is None:
            return params.wte
        return _TiedRows.apply(params.wte, binding.group, held, last)

    def embed(ids):
        wte, ids = table(True), ids[:, rows]
        tok = sparse_embedding_lookup(wte, ids,
                                      mesh=config.embedding_grad_mesh) \
            if config.sparse_embedding_grads else wte[ids]
        return tok.to(dtype) + params.wpe[rows].to(dtype)

    x = z3.call(embed, input_ids, units=("embed",))
    block_fn = make_block_fn(dataclasses.replace(config, remat=False),
                             train, x.device)
    seeds = _layer_seeds(config, generator, train)
    for i, (bp, seed) in enumerate(zip(params.blocks, seeds)):
        x = z3.call(lambda h, bp=bp, seed=seed: block_fn(h, bp, seed), x,
                    units=("blocks.{}".format(i),))

    def head(h, lab):
        hidden = _layer_norm(h, params.ln_f.scale, params.ln_f.bias)
        if binding is not None:
            return _tp_lm_loss(hidden, table(False), lab, config, binding)
        return _head_loss(hidden, params.wte, lab, config)

    return z3.call(head, x, labels, units=("ln_f",), borrow=("embed",))


def _tree_view(tree):
    """``{"ln1.scale": t, ...}`` -> a namespace read as ``.ln1.scale``
    (what :func:`make_block_fn`'s block reads from a module)."""
    out = {}
    for name, value in tree.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value

    def build(node):
        return SimpleNamespace(**{k: build(v) if isinstance(v, dict) else v
                                  for k, v in node.items()})

    return build(out)


def stream_spec_for(config):
    """:class:`runtime.model.StreamSpec` for GPT-2, the decomposition the
    streamed-offload runner (``cpu_offload_params``) drives; port of the
    JAX package's ``stream_spec_for``. The composition equals
    :func:`lm_loss` segment for segment: embed (``wte`` gather + ``wpe``
    add), per-layer :func:`make_block_fn` blocks (the fused flash op on
    the flash path), head (``ln_f`` + the tied-``wte`` loss, chunked by
    ``loss_chunk``). ``split`` returns the same ``wte`` object in the
    embed and head segments, so the runner sums the two gradient
    contributions. The blocks run with ``remat`` off: the runner
    recomputes each layer group in its backward, which is the
    checkpoint."""
    from ..runtime.model import StreamSpec
    if getattr(config, "sequence_parallel", None) or \
            config.sparse_embedding_grads:
        raise ValueError(
            "streamed parameter offload does not compose with "
            "sequence_parallel or sparse_embedding_grads")

    def split(params):
        blocks = {}
        for name, value in params.items():
            if name.startswith("blocks."):
                _, i, inner = name.split(".", 2)
                blocks.setdefault(int(i), {})[inner] = value
        return ({"wte": params["wte"], "wpe": params["wpe"]},
                [blocks[i] for i in sorted(blocks)],
                {"ln_f.scale": params["ln_f.scale"],
                 "ln_f.bias": params["ln_f.bias"], "wte": params["wte"]})

    def embed_apply(embed, batch, seed, train):
        input_ids = batch[0]
        s = input_ids.shape[1]
        dtype = embed["wpe"].dtype
        return embed["wte"][input_ids].to(dtype) + embed["wpe"][:s].to(dtype)

    def block_apply(bp, x, seed, train):
        block = make_block_fn(dataclasses.replace(config, remat=False),
                              train, x.device)
        return block(x, _tree_view(bp), seed)

    def head_apply(head, x, batch, seed, train):
        hidden = _layer_norm(x, head["ln_f.scale"], head["ln_f.bias"])
        return _head_loss(hidden, head["wte"], batch[1], config)

    return StreamSpec(split, embed_apply, block_apply, head_apply)


def num_params(config):
    d, v, s, L = (config.d_model, config.vocab_size, config.max_seq_len,
                  config.n_layers)
    per_block = 12 * d * d + 13 * d
    return v * d + s * d + L * per_block + 2 * d


# ------------------------------------------------------ serving forward


def _qkv_for_cache(x, block, config):
    """Shared QKV projection for the cached attention paths:
    -> q (b, s, h, dh), k/v (b, h, s, dh) (views of one projection).
    ``h`` is the heads the block's qkv kernel holds: all of them, or
    under tensor-parallel serving the rank's ``n_heads / tp``
    (:func:`tp_shard_state_dict` gives each rank whole q, k and v
    heads)."""
    b, s, _ = x.shape
    dh = config.d_head
    qkv = x @ block.qkv_kernel.to(x.dtype) + block.qkv_bias.to(x.dtype)
    d_local = qkv.shape[-1] // 3
    h = d_local // dh
    q, k, v = qkv.split(d_local, dim=-1)
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
    queries attend over the whole row. Returns the context (b, s, h * dh)
    over the cache's heads (the rank's under tensor-parallel serving)."""
    b, s, _ = x.shape
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
    return ctx.to(x.dtype).reshape(b, s, -1)


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
    stream before the read. Returns the context (b, s, h * dh) over the
    pool's heads (the rank's under tensor-parallel serving)."""
    b, s, _ = x.shape
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
    return ctx.to(x.dtype).reshape(b, s, -1)


def _embed_tokens(wte, ids, tp_group):
    """``wte[ids]``; under tensor-parallel serving ``wte`` is the rank's
    vocabulary rows, so each rank looks up the ids it holds (zeros
    elsewhere) and the sum over the group, exact with one non-zero term,
    is the whole lookup."""
    if tp_group is None:
        return wte[ids]
    rows = wte.shape[0]
    local = ids - dist.get_rank(tp_group) * rows
    inside = (local >= 0) & (local < rows)
    tok = torch.where(inside[..., None], wte[local.clamp(0, rows - 1)],
                      torch.zeros((), dtype=wte.dtype, device=wte.device))
    return all_reduce_(tok, tp_group)


def _forward_hidden_cached(params, input_ids, config, cache, positions,
                           page_tables=None, valid_lens=None,
                           page_size=None, tp_group=None):
    """Cache-threaded forward for serving -> final hidden states.

    ``cache`` is ``(k, v)``: the slot layout (rows, layers, heads,
    max_seq, d_head), or — when ``page_tables`` is given — the paged
    pool (pages, layers, heads, page_size, d_head) indexed per slot
    through ``page_tables`` (b, max_pages) int32 with ``valid_lens``
    (b,) int32 masking padded writes. ``positions`` (b,) int32 is the
    absolute position of ``input_ids[:, 0]`` per slot. The caches are
    updated in place.

    Tensor-parallel serving (``tp_group``, the mesh's ``model`` group):
    ``params`` is the rank's :func:`tp_shard_state_dict` shard and the
    cache holds the rank's heads. Activations stay whole on every rank:
    the vocabulary-parallel embedding and the two row-parallel products
    of each block (attention proj, MLP proj) are each followed by one
    all-reduce over the group, their biases added once after it (the
    Megatron layout GSPMD gives the JAX engine)."""
    b, s = input_ids.shape
    k_cache, v_cache = cache
    compute_dtype = params.ln_f.scale.dtype
    tok = _embed_tokens(params.wte, input_ids, tp_group)
    # padded prefill tokens may run past the position table; their rows
    # only ever feed the garbage page, so clamping them changes nothing
    pos_ids = (positions.long()[:, None] +
               torch.arange(s, device=input_ids.device)[None, :]).clamp(
                   max=params.wpe.shape[0] - 1)
    x = tok.to(compute_dtype) + params.wpe[pos_ids].to(compute_dtype)
    reduce = None if tp_group is None else \
        (lambda y: all_reduce_(y, tp_group))
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
        x = _block_rest(x, ctx, bp, reduce=reduce)
    return _layer_norm(x, params.ln_f.scale, params.ln_f.bias)


def forward_hidden(params, input_ids, config, cache=None, positions=None,
                   page_tables=None, valid_lens=None, page_size=None,
                   generator=None, train=False, tp_group=None):
    """Embedding + transformer stack -> final hidden states.

    With ``cache`` (a ``(k, v)`` KV-cache pair) the stack runs the
    incremental serving path (see :func:`_forward_hidden_cached`; under
    tensor-parallel serving over ``tp_group``); without it, the training
    stack of :func:`make_block_fn` blocks, with dropout drawn from
    ``generator`` when ``train``."""
    if cache is not None:
        if positions is None:
            positions = torch.zeros((input_ids.shape[0],),
                                    dtype=torch.int32,
                                    device=input_ids.device)
        return _forward_hidden_cached(params, input_ids, config, cache,
                                      positions, page_tables=page_tables,
                                      valid_lens=valid_lens,
                                      page_size=page_size,
                                      tp_group=tp_group)
    hidden, _ = _forward_hidden_train(params, input_ids, config,
                                      generator, train)
    return hidden


def _local_rows(s, binding):
    """This rank's slice of the sequence (all of it without a live
    binding)."""
    if binding is None:
        return slice(0, s)
    n, r = binding.size, binding.rank
    if s % n:
        raise ValueError("sequence {} must divide the tensor-parallel size "
                         "{}".format(s, n))
    return slice(r * (s // n), (r + 1) * (s // n))


def _forward_hidden_train(params, input_ids, config, generator, train):
    """The training stack -> (final hidden states, the embedding table the
    head uses). Under a live TP binding the hidden states are this rank's
    rows (b, s/n, d) and the table is the all-gathered ``wte`` (its
    gradient reduce-scatters back to the vocabulary shards)."""
    binding = _tp_binding(config)
    if binding is not None and train and config.dropout > 0.0:
        raise NotImplementedError(
            "dropout under tensor parallelism is not ported yet: the "
            "sequence-sharded masks come with a later slice")
    s = input_ids.shape[1]
    rows = _local_rows(s, binding)
    compute_dtype = params.ln_f.scale.dtype
    wte = params.wte if binding is None else gather_rows(params.wte,
                                                         binding.group)
    ids = input_ids[:, rows]
    tok = sparse_embedding_lookup(wte, ids, mesh=config.embedding_grad_mesh) \
        if config.sparse_embedding_grads else wte[ids]
    x = tok.to(compute_dtype) + params.wpe[rows].to(compute_dtype)
    block_fn = make_block_fn(config, train, x.device)
    for bp, seed in zip(params.blocks, _layer_seeds(config, generator,
                                                    train)):
        x = block_fn(x, bp, seed)
    return _layer_norm(x, params.ln_f.scale, params.ln_f.bias), wte
