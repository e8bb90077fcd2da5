"""Speculative decoding: drafters that propose ``k`` tokens per step.

Port of ``deepspeed_tpu/inference/speculative.py``. The scheduler
verifies proposals with ONE target-model pass (engine ``verify_step``: a
cached forward over ``(slots, k+1)`` tokens) and accepts the longest
prefix the target agrees with, so decode emits ``1 + accepted`` tokens
per model step instead of 1. Greedy acceptance reproduces the
autoregressive greedy stream byte for byte: position i's target logits
are conditioned on drafts ``d_1..d_i``, which equal the committed prefix
for as long as every earlier draft matched the target argmax.

Two drafters, selected by ``inference.speculative.method``:

  * :class:`NGramDrafter` — host-side prompt-lookup drafting (no second
    model), a copy of the JAX package's class;
  * :class:`ModelDrafter` — a small GPT-2 sharing the target's
    vocabulary, with its OWN slot-layout KV cache, proposing ``k``
    greedy tokens per scheduler step in ``k + 1`` cached decode steps
    (a Python loop where the JAX drafter runs one ``lax.scan``). Its
    cache advances in lockstep with the target's acceptance (rejected
    drafts become stale masked entries, exactly like the target's).
    Under tensor-parallel serving every rank runs the whole drafter: its
    proposals are the same tokens on each.
"""
import dataclasses

import numpy as np
import torch


class NGramDrafter:
    """Prompt-lookup drafting (host-side, deterministic, model-free).

    ``propose(context, k)`` finds the most recent earlier occurrence of
    the context's trailing ``m``-gram (``m`` from ``ngram_max`` down to
    ``ngram_min``) and proposes the ``k`` tokens that followed it,
    padding with the final proposed token; with no match it proposes
    ``k`` copies of the last token (greedy decode of small models loves
    loops, so even this degenerate draft earns acceptances)."""

    needs_model = False

    def __init__(self, ngram_max=3, ngram_min=1):
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def propose(self, context, k):
        context = list(context)
        for m in range(min(self.ngram_max, len(context) - 1),
                       self.ngram_min - 1, -1):
            suffix = context[-m:]
            for j in range(len(context) - m - 1, -1, -1):
                if context[j:j + m] == suffix:
                    cont = context[j + m:j + m + k]
                    if cont:
                        return cont + [cont[-1]] * (k - len(cont))
        return [context[-1]] * k

    # cache-lifecycle no-ops: the drafter is stateless
    def prefill(self, slot, context):
        pass

    def advance(self, slot, n):
        pass

    def free_slot(self, slot):
        pass


class ModelDrafter:
    """A small GPT-2 drafter with its own slot-layout KV cache.

    The drafter model must share the target's tokenizer (vocab) and
    positional reach; everything else (depth/width/heads) is free — the
    classic draft/target split. Proposals are always GREEDY: the
    acceptance rule, not the drafter, owns the sampling semantics. The
    weights are a copy in the serving dtype on ``device``."""

    needs_model = True

    def __init__(self, model, num_slots, max_seq_len, dtype, device,
                 vocab_size=None):
        from ..models.gpt2 import GPT2Model
        from .kv_cache import KVCache
        cfg = getattr(model, "config", None)
        assert cfg is not None and hasattr(cfg, "n_heads"), \
            "speculative.method 'model' needs a draft model with a " \
            "GPT2Config at .config (models.gpt2.make_gpt2_model)"
        assert cfg.max_seq_len >= max_seq_len, \
            "draft model max_seq_len {} < serving max_seq_len {}".format(
                cfg.max_seq_len, max_seq_len)
        assert vocab_size is None or cfg.vocab_size == vocab_size, \
            "draft model vocab_size {} != the target's {}".format(
                cfg.vocab_size, vocab_size)
        # the plain serving forward: no TP binding, no sparse layout, the
        # gather read path
        self.config = dataclasses.replace(
            cfg, dropout=0.0, sparse_attention=None, collective_matmul=None,
            sparse_embedding_grads=False, embedding_grad_mesh=None,
            paged_attention_kernel="xla")
        self.max_seq_len = int(max_seq_len)
        self.device = device
        params = GPT2Model(self.config, device=device, dtype=dtype)
        params.load_state_dict(model.state_dict())
        self.params = params.requires_grad_(False)
        self.kv = KVCache.allocate(
            num_slots, self.config.n_layers, self.config.n_heads,
            self.max_seq_len, self.config.d_head, dtype, device)
        self.lengths = np.zeros((num_slots,), np.int32)

    def _positions(self, values):
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    # ------------------------------------------------------------- serving

    @torch.no_grad()
    def prefill(self, slot, context):
        """Embed the full ``context`` into the drafter's cache slot (one
        bucket-padded pass; the drafter is small, so chunking it buys
        nothing) and reset the slot's length."""
        from ..models import gpt2
        n = len(context)
        assert 1 <= n < self.max_seq_len
        bucket = 64
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_seq_len)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = np.asarray(context, np.int64)
        gpt2.forward_hidden(
            self.params, torch.from_numpy(ids).to(self.device), self.config,
            cache=(self.kv.k[slot:slot + 1], self.kv.v[slot:slot + 1]),
            positions=self._positions([0]))
        self.lengths[slot] = n

    @torch.no_grad()
    def propose_batch(self, pending, k):
        """One draft pass for every slot: ``pending`` (slots,) are each
        slot's most recent token. Returns (slots, k) int proposals;
        inactive slots produce garbage the scheduler ignores (their
        cache writes are position-masked like the target's). ``k + 1``
        greedy decode steps: the drafter must WRITE K/V for every token
        the verify pass can commit (pending + k drafts — on full
        acceptance the target advances k+1, and a hole at the last
        draft's position would poison every later proposal); the
        (k+1)-th PROPOSAL is discarded."""
        from ..models import gpt2
        tok = torch.as_tensor(np.asarray(pending, np.int64),
                              device=self.device)
        lens = self._positions(self.lengths)
        drafts = []
        for _ in range(int(k) + 1):
            hidden = gpt2.forward_hidden(self.params, tok[:, None],
                                         self.config, cache=self.kv.buffers(),
                                         positions=lens)
            logits = hidden[:, 0] @ self.params.wte.to(hidden.dtype).T
            tok = torch.argmax(logits, dim=-1)
            drafts.append(tok)
            lens = lens + 1
        drafts = torch.stack(drafts[:int(k)], dim=1) if k else \
            torch.zeros((len(self.lengths), 0), dtype=torch.int64)
        return drafts.cpu().numpy().astype(np.int32)

    def advance(self, slot, n):
        self.lengths[slot] += int(n)

    def free_slot(self, slot):
        self.lengths[slot] = 0
