"""Preallocated KV caches for incremental decode: slot and paged layouts.

Port of ``deepspeed_tpu/inference/kv_cache.py``. Both hold a ``(k, v)``
pair of device tensors, allocated once and updated IN PLACE by the
model's cached forward (the JAX programs donate the buffers instead).

**Slot layout** (:class:`KVCache`, the numerics oracle and default):
``(slots, layers, heads, max_seq, d_head)``; a request owns one slot for
its lifetime and its batch row in prefill/decode IS its slot index.

**Paged layout** (:class:`PagedKVCache`): a pool of fixed-size pages
``(pages + 1, layers, heads, page_size, d_head)`` plus host-side page
tables (inference/paging.py). Physical page 0 is the reserved garbage
page: never allocated, the target of every masked/padded write.

Under tensor-parallel serving both layouts hold the rank's ``heads /
tp`` heads (the JAX ``KV_CACHE_SPEC``: heads on the ``model`` axis), the
heads of the rank's q/k/v columns.

Freed slots and recycled pages are reused WITHOUT clearing — the
absolute-position causal mask and the V-zeroing past the live window
(``models/gpt2.py::_attend_cache_rows``, and the same contract in the
paged-attention kernel) make stale entries unreachable in both layouts,
for any garbage content including NaN.
"""
from dataclasses import dataclass

import torch


def local_heads(heads, tp):
    """The heads one rank of a ``tp``-way model group holds."""
    assert heads % tp == 0, \
        "n_heads {} not divisible by model-parallel degree {}".format(
            heads, tp)
    return heads // tp


@dataclass
class KVCache:
    """The slot layout's ``(k, v)`` tensors."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def allocate(cls, slots, layers, heads, max_seq, d_head, dtype,
                 device, tp=1):
        shape = (slots, layers, local_heads(heads, tp), max_seq, d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def nbytes(self):
        return self.k.numel() * self.k.element_size() * 2

    def buffers(self):
        return self.k, self.v


@dataclass
class PagedKVCache:
    """The paged ``(k, v)`` pool: ``(num_pages + 1, layers, heads,
    page_size, d_head)`` — ``num_pages`` counts USABLE pages."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int

    @classmethod
    def allocate(cls, num_pages, layers, heads, page_size, d_head, dtype,
                 device, tp=1):
        shape = (num_pages + 1, layers, local_heads(heads, tp), page_size,
                 d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   int(page_size))

    @property
    def nbytes(self):
        return self.k.numel() * self.k.element_size() * 2

    def buffers(self):
        return self.k, self.v
