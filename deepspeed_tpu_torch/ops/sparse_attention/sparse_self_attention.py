"""SparseSelfAttention: layout-driven block-sparse attention module.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
the reference call signature ``(query, key, value, rpe,
key_padding_mask, attn_mask)`` with 'add'/'mul' mask modes, one cached
kernel per ``(seq_len, has_kpm, has_bias)``, and the master layout sliced
for shorter sequences. The attention runs in
``block_sparse_attention.py`` (CUDA kernels for CUDA tensors, their plain
versions for CPU tensors).
"""
import torch

from .sparsity_config import SparsityConfig
from .block_sparse_attention import make_block_sparse_attention, NEG_INF


class SparseSelfAttention:
    """Applies block-sparse self attention per a :class:`SparsityConfig`.

    q/k/v: (batch, heads, seq, d_head). ``rpe`` is an additive
    (seq, seq) relative position bias; ``key_padding_mask`` is
    (batch, seq); ``attn_mask`` is (seq, seq). 'mul' masks are 0/1
    keep-masks, 'add' masks are additive biases (both as in the
    reference).
    """

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048, causal=False):
        self.sparsity_config = sparsity_config or SparsityConfig(num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        # layouts that are causal by construction (sliding_window) force
        # causal masking inside the diagonal blocks
        self.causal = causal or getattr(self.sparsity_config,
                                        "requires_causal", False)
        self.master_layout = self.sparsity_config.make_layout(max_seq_length)
        self._kernels = {}

    def get_layout(self, seq_len):
        block = self.sparsity_config.block
        if seq_len % block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block "
                f"{block}!")
        nb = seq_len // block
        return self.master_layout[:, :nb, :nb]

    def _kernel(self, seq_len, has_kpm, has_bias):
        key = (seq_len, has_kpm, has_bias)
        if key not in self._kernels:
            self._kernels[key] = make_block_sparse_attention(
                self.get_layout(seq_len), self.sparsity_config.block,
                causal=self.causal, has_kpm=has_kpm, has_bias=has_bias)
        return self._kernels[key]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        assert query.dim() == 4, "q/k/v must be (batch, heads, seq, d_head)"
        seq_len = query.shape[2]
        as_f32 = lambda t: torch.as_tensor(t, device=query.device).to(
            torch.float32)
        keep = lambda m: torch.where(m != 0, 0.0, NEG_INF)

        kpm = None
        if key_padding_mask is not None:
            kpm = as_f32(key_padding_mask)
            if self.key_padding_mask_mode == "mul":
                kpm = keep(kpm)

        bias = None
        if attn_mask is not None:
            bias = as_f32(attn_mask)
            if self.attn_mask_mode == "mul":
                bias = keep(bias)
        if rpe is not None:
            rpe = as_f32(rpe)
            bias = rpe if bias is None else bias + rpe

        attn = self._kernel(seq_len, kpm is not None, bias is not None)
        return attn(query, key, value, kpm, bias)

    forward = __call__


class BertSparseSelfAttention:
    """BERT-style QKV projection around SparseSelfAttention
    (reference bert_sparse_self_attention.py:10). Functional: weights are
    passed per call as a dict {query, key, value: {kernel, bias}} in the
    JAX ``(in, out)`` layout."""

    def __init__(self, num_attention_heads, hidden_size,
                 sparsity_config=None, max_seq_length=2048):
        if hidden_size % num_attention_heads != 0:
            raise ValueError(
                f"hidden size {hidden_size} is not a multiple of "
                f"num_attention_heads {num_attention_heads}")
        self.num_attention_heads = num_attention_heads
        self.attention_head_size = hidden_size // num_attention_heads
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or SparsityConfig(num_heads=num_attention_heads),
            max_seq_length=max_seq_length)

    def transpose_for_scores(self, x):
        b, s, _ = x.shape
        x = x.reshape(b, s, self.num_attention_heads,
                      self.attention_head_size)
        return x.transpose(1, 2)

    def __call__(self, params, hidden_states, attention_mask=None):
        proj = lambda name: hidden_states @ params[name]["kernel"] + \
            params[name]["bias"]
        ql, kl, vl = (self.transpose_for_scores(proj(n))
                      for n in ("query", "key", "value"))
        ctx = self.sparse_self_attention(ql, kl, vl,
                                         key_padding_mask=attention_mask)
        b, h, s, d = ctx.shape
        return ctx.transpose(1, 2).reshape(b, s, h * d)
