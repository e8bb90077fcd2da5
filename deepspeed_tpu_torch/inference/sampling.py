"""Token sampling: greedy, temperature, top-k, top-p.

Port of ``deepspeed_tpu/inference/sampling.py::make_sampler``. The
random draws come from an explicit ``torch.Generator`` on the logits'
device, so they differ from ``jax.random``'s; greedy decoding is
bit-identical (``torch.argmax``, like ``jnp.argmax``, returns the first
maximum). Top-p runs in sorted space (sample an index into the
descending-sorted logits, map back through the sort permutation).
"""
from functools import lru_cache

import torch

NEG_INF = -1e30


@lru_cache(maxsize=None)
def make_sampler(greedy, top_k=0):
    """Build ``sample(logits, generator, temperature, top_p) -> (b,)``
    int64 tokens. ``logits`` is (b, vocab); every row samples
    independently. Cached: one sampler per (greedy, top_k)."""
    if greedy:
        def sample(logits, generator, temperature, top_p):
            del generator, temperature, top_p
            return torch.argmax(logits, dim=-1)
        return sample

    def sample(logits, generator, temperature, top_p):
        logits = logits.float() / max(temperature, 1e-6)
        if top_k and top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, NEG_INF)
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        # keep tokens whose cumulative mass BEFORE them is < top_p — the
        # head token always survives, so the distribution never empties
        cum_before = torch.cumsum(probs, dim=-1) - probs
        sorted_logits = sorted_logits.masked_fill(cum_before >= top_p,
                                                  NEG_INF)
        idx = torch.multinomial(torch.softmax(sorted_logits, dim=-1), 1,
                                generator=generator)
        return torch.gather(order, -1, idx)[..., 0]

    return sample
