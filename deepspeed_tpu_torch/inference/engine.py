"""InferenceEngine: KV-cache serving for GPT-2-family models.

Port of ``deepspeed_tpu/inference/engine.py::InferenceEngine``, returned
by ``deepspeed_tpu_torch.init_inference()``. The same host state and
method names: ``prefill_chunk`` embeds one prompt chunk (padded to a
length bucket) into a slot's cache rows or pages and samples the first
token on the final chunk; ``decode_step`` runs one token for EVERY slot
in one batched step (inactive slots compute garbage the scheduler
ignores; their paged writes land in the garbage page).

Two KV layouts (``inference.kv_layout``):

  * ``slot`` (default, the numerics oracle): one contiguous
    ``(slots, layers, heads, max_seq, d_head)`` tensor pair;
  * ``paged``: a pooled ``(pages + 1, layers, heads, page_size,
    d_head)`` tensor pair plus host-side page tables
    (inference/paging.py), prefix sharing and copy-on-write.

The caches and weights live on ``device``, CUDA unless the caller asks
for the CPU, and the caches are updated in place. The decode family of
the paged layout reads through the CUDA paged-attention kernel when
``inference.paged_attention_kernel`` resolves to ``pallas``; prefill and
the slot layout always take the plain gather path.

Speculative decoding (``inference.speculative``): the engine holds the
drafter (inference/speculative.py) and ``verify_step`` is the decode
step at width ``k + 1``; the scheduler drafts, verifies and accepts.

Tensor-parallel serving (a ``mesh`` whose ``model`` axis is > 1): every
rank of the model group runs this engine on its own shard of the
weights (``models/gpt2.py::tp_shard_state_dict``) with a KV cache of its
``n_heads / tp`` heads; the forward all-reduces whole activations after
the row-parallel products and all-gathers the logits in vocabulary
order, so every rank samples the same tokens from the same seeded
generator and runs the same host scheduler. The paged kernel runs over
the rank's heads, as on one device.
"""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.topology import MODEL_AXIS
from ..utils.distributed import all_gather
from ..utils.logging import logger
from ..utils.monitor import ServingMetrics
from .config import DeepSpeedInferenceConfig
from .kv_cache import KVCache, PagedKVCache
from .paging import GARBAGE_PAGE, PageAllocator, PrefixCache
from .sampling import make_sampler

_UNSET = object()    # "argument not given" (None means "no EOS token")

# ds_config sections of the JAX engine that this slice does not serve,
# with the later slice of the port that brings each
_UNPORTED_SECTIONS = {
    "telemetry": "the observability slice",
    "analysis": "the observability slice",
    "controller": "the observability and control slice",
}


def _section_on(value):
    if isinstance(value, dict):
        return value.get("enabled", True) is not False
    return bool(value)


def _parse_config(config):
    """ds_config (dict, JSON path, :class:`DeepSpeedInferenceConfig` or
    None) -> the inference config. Raises ``NotImplementedError`` for a
    section this slice cannot honour instead of ignoring it."""
    if isinstance(config, DeepSpeedInferenceConfig):
        return config
    if config is None:
        return DeepSpeedInferenceConfig({})
    if isinstance(config, (str, os.PathLike)):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError("config must be a dict, a JSON path or a "
                        "DeepSpeedInferenceConfig, got {}".format(
                            type(config).__name__))
    for key, later in _UNPORTED_SECTIONS.items():
        if _section_on(config.get(key)):
            raise NotImplementedError(
                "the {!r} ds_config section is not ported yet: it comes "
                "with {}".format(key, later))
    return DeepSpeedInferenceConfig(config)


def resolve_device(device=None):
    """``None`` -> the current CUDA device; raises when CUDA is absent.
    Only an explicit ``device="cpu"`` runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port serves on the GPU "
                "by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {} requested but CUDA is not "
                           "available".format(device))
    return device


class InferenceEngine:
    """Incremental-decode engine over a :class:`models.gpt2.GPT2Model`
    (whose ``.config`` is its GPT2Config). Prompt/token values are plain
    ints; the weights and KV cache live on ``self.device`` (under a
    ``mesh`` with a ``model`` axis > 1, the rank's shards of them).
    ``draft_model`` is the small GPT-2 that
    ``inference.speculative.method: "model"`` drafts with."""

    def __init__(self, model, config=None, dtype=None, seed=0, device=None,
                 mesh=None, draft_model=None):
        model_config = getattr(model, "config", None)
        assert model_config is not None and \
            hasattr(model_config, "n_heads"), \
            "init_inference needs a model with a GPT2Config at .config " \
            "(e.g. models.gpt2.make_gpt2_model)"
        self.device = resolve_device(device)
        self.inference_config = ic = _parse_config(config)
        if ic.fleet_keys:
            raise NotImplementedError(
                "inference.fleet is not ported yet: disaggregated roles "
                "and adapters come with the serving-fleet slice")
        # dtype override is engine-local state: the config object may be
        # shared with other engines and must not be mutated
        if dtype is not None:
            name = dtype if isinstance(dtype, str) else \
                str(dtype).replace("torch.", "")
            parsed = DeepSpeedInferenceConfig({"inference": {"dtype": name}})
            self.dtype, self.dtype_name = parsed.dtype, parsed.dtype_name
        else:
            self.dtype = ic.dtype
            self.dtype_name = ic.dtype_name

        # prefill and every oracle comparison read the plain gather path;
        # only the decode family takes the resolved kernel
        self.model_config = dataclasses.replace(
            model_config, paged_attention_kernel="xla")
        self.max_seq_len = ic.max_seq_len or model_config.max_seq_len
        assert self.max_seq_len <= model_config.max_seq_len, \
            "inference.max_seq_len {} exceeds the model's positional " \
            "table {}".format(self.max_seq_len, model_config.max_seq_len)
        self.num_slots = ic.max_batch_size
        self.prefill_buckets = ic.resolve_buckets(self.max_seq_len)

        # tensor parallelism over the mesh's model group (None: one rank)
        self.mesh = mesh
        self.tp_size = 1 if mesh is None else \
            int(mesh.shape.get(MODEL_AXIS, 1))
        self.tp_group = mesh.get_group(MODEL_AXIS) \
            if self.tp_size > 1 else None
        self.tp_rank = 0 if self.tp_group is None else \
            dist.get_rank(self.tp_group)
        self.params = self._place_params(model, self.dtype)

        # ------------------------------------------------- KV cache layout
        cfg = self.model_config
        self.kv_layout = ic.kv_layout
        self.page_size = ic.kv_block_size
        if self.kv_layout == "paged":
            self.max_pages = -(-self.max_seq_len // self.page_size)
            num_pages = ic.resolve_num_pages(self.num_slots,
                                             self.max_seq_len)
            self.kv = PagedKVCache.allocate(
                num_pages, cfg.n_layers, cfg.n_heads, self.page_size,
                cfg.d_head, self.dtype, self.device, tp=self.tp_size)
            self.allocator = PageAllocator(num_pages)
            # per-slot logical->physical map; GARBAGE_PAGE everywhere a
            # slot has no allocation (writes there are redirected and
            # reads position-masked)
            self.page_tables = np.full((self.num_slots, self.max_pages),
                                       GARBAGE_PAGE, np.int32)
            self.page_counts = np.zeros((self.num_slots,), np.int32)
            # pages matched at admission time per slot, so the first-
            # chunk extension match knows where to resume
            self._admit_matched = {}
            self.prefix_cache = (
                PrefixCache(self.allocator, self.page_size)
                if ic.prefix_caching else None)
        else:
            self.max_pages = 0
            self.kv = KVCache.allocate(
                self.num_slots, cfg.n_layers, cfg.n_heads, self.max_seq_len,
                cfg.d_head, self.dtype, self.device, tp=self.tp_size)
            self.allocator = None
            self.page_tables = None
            self.page_counts = None
            self.prefix_cache = None

        # paged-attention decode read path, resolved once at build
        self.paged_attention_kernel = \
            self._resolve_paged_attention_kernel()

        # host mirror of each slot's live length (tokens whose K/V are in
        # the cache); the scheduler owns slot assignment on top of this
        self.lengths = np.zeros((self.num_slots,), np.int32)

        # ------------------------------------------ speculative decoding
        self.drafter = None
        self.spec_k = 0
        if ic.spec_enabled:
            self.spec_k = ic.spec_num_draft_tokens
            if ic.spec_method == "model":
                from .speculative import ModelDrafter
                assert draft_model is not None, \
                    "inference.speculative.method 'model' needs " \
                    "init_inference(..., draft_model=<small gpt2 model>)"
                self.drafter = ModelDrafter(
                    draft_model, self.num_slots, self.max_seq_len,
                    self.dtype, self.device,
                    vocab_size=model_config.vocab_size)
            else:
                from .speculative import NGramDrafter
                self.drafter = NGramDrafter(ic.spec_ngram_max,
                                            ic.spec_ngram_min)

        # every rank of a model group draws from the same seed: the
        # gathered logits are equal, so the sampled tokens are too
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._prefill_fns = {}     # (bucket, greedy, top_k) -> fn
        self._decode_fns = {}      # (width, greedy, top_k) -> fn
        # distinct prefill/decode programs built, as the JAX engine
        # counts its jit traces
        self.compile_stats = {"prefill_traces": 0, "decode_traces": 0}
        # the latest decode step's logits (slots, width, vocab), kept for
        # callers that check them
        self.last_logits = None
        # engine-lifetime serving counters (generate() builds a fresh
        # scheduler per call; per-call metrics are accounted in parallel)
        self.serving_metrics = ServingMetrics()
        logger.info(
            "InferenceEngine: device={} slots={} max_seq={} buckets={} "
            "dtype={} layout={} kv_cache={:.1f} MB{}{}{}".format(
                self.device, self.num_slots, self.max_seq_len,
                self.prefill_buckets, self.dtype_name, self.kv_layout,
                self.kv.nbytes / 2 ** 20,
                " pages={}x{} paged_attn={}".format(
                    self.allocator.num_pages, self.page_size,
                    self.paged_attention_kernel)
                if self.kv_layout == "paged" else "",
                " spec_k={} drafter={}".format(
                    self.spec_k, type(self.drafter).__name__)
                if self.drafter is not None else "",
                " tp={} (rank {})".format(self.tp_size, self.tp_rank)
                if self.tp_size > 1 else ""))

    def _resolve_paged_attention_kernel(self):
        """``inference.paged_attention_kernel`` tri-state -> the decode
        family's read path ("pallas" = the CUDA kernel | "xla" = the
        plain gather-back). A "pallas" request on the slot layout, which
        has no page tables to walk, warns and runs the gather path."""
        key = self.inference_config.paged_attention_kernel
        if self.kv_layout != "paged":
            if key == "pallas":
                logger.warning(
                    "inference.paged_attention_kernel='pallas' has NO "
                    "effect: kv_layout is %r — the slot layout has no "
                    "page tables to walk (set inference.kv_layout: "
                    "\"paged\")", self.kv_layout)
            return "xla"
        if key == "auto":
            return "pallas" if self.device.type == "cuda" else "xla"
        return key

    def _place_params(self, model, dtype):
        """A copy of the model's weights on the engine's device, cast to
        the serving dtype (the caller's model is left as it was); under
        tensor parallelism the rank's Megatron shard of them
        (``tp_shard_state_dict``: vocabulary rows of ``wte``, whole q/k/v
        heads and fc columns, proj rows), the counterpart of the JAX
        engine's stage-0 placement by ``partition_spec_fn``."""
        from ..models.gpt2 import GPT2Model, tp_shard_state_dict
        params = GPT2Model(self.model_config, device=self.device,
                           dtype=dtype, tp_size=self.tp_size)
        state = model.state_dict()
        if self.tp_size > 1:
            state = tp_shard_state_dict(state, self.tp_rank, self.tp_size)
        params.load_state_dict(state)
        return params.requires_grad_(False)

    def attach_adapters(self, adapter_set):
        raise NotImplementedError(
            "multi-tenant adapters are not ported yet: they come with the "
            "serving-fleet slice")

    # ---------------------------------------------------------- programs

    def _sampling_key(self, sampling):
        ic = self.inference_config
        s = sampling or {}
        greedy = bool(s.get("greedy", ic.greedy))
        # greedy ignores top_k; clamp to the vocab (k == vocab is already
        # "no filtering")
        top_k = 0 if greedy else min(int(s.get("top_k", ic.top_k)),
                                     self.model_config.vocab_size)
        temperature = float(s.get("temperature", ic.temperature))
        top_p = float(s.get("top_p", ic.top_p))
        return greedy, top_k, temperature, top_p

    def _last_logits(self, hidden):
        """Tied-embedding LM head, in the compute dtype; under tensor
        parallelism each rank's vocabulary rows, all-gathered in
        vocabulary order."""
        logits = hidden @ self.params.wte.to(hidden.dtype).T
        if self.tp_group is None:
            return logits
        return all_gather(logits, self.tp_group, dim=-1)

    def _get_prefill_fn(self, bucket, greedy, top_k):
        key = (bucket, greedy, top_k)
        fn = self._prefill_fns.get(key)
        if fn is not None:
            return fn
        from ..models import gpt2
        cfg = self.model_config
        sampler = make_sampler(greedy, top_k)
        paged, ps = self.kv_layout == "paged", self.page_size

        def scalar(n):
            return torch.tensor([n], dtype=torch.int32, device=self.device)

        if paged:
            def prefill(ids, page_row, start, length, temperature, top_p):
                # ids (1, bucket); page_row (max_pages,) int32; the chunk
                # covers positions [start, start + length); padded
                # tokens redirect to the garbage page
                hidden = gpt2.forward_hidden(
                    self.params, ids, cfg, cache=self.kv.buffers(),
                    positions=scalar(start), page_tables=page_row[None],
                    valid_lens=scalar(length), page_size=ps,
                    tp_group=self.tp_group)
                logits = self._last_logits(hidden[0, length - 1][None])
                return sampler(logits, self.generator, temperature,
                               top_p)[0]
        else:
            def prefill(ids, slot, start, length, temperature, top_p):
                # the request's cache rows, filled in place from `start`
                k_row = self.kv.k[slot:slot + 1]
                v_row = self.kv.v[slot:slot + 1]
                hidden = gpt2.forward_hidden(
                    self.params, ids, cfg, cache=(k_row, v_row),
                    positions=scalar(start), tp_group=self.tp_group)
                logits = self._last_logits(hidden[0, length - 1][None])
                return sampler(logits, self.generator, temperature,
                               top_p)[0]

        self._prefill_fns[key] = prefill
        self.compile_stats["prefill_traces"] += 1
        return prefill

    def _get_decode_fn(self, greedy, top_k, width=1):
        """The batched all-slot decode step: ``width`` new tokens per
        slot."""
        key = (width, greedy, top_k)
        fn = self._decode_fns.get(key)
        if fn is not None:
            return fn
        from ..models import gpt2
        # the ONE family that may run the paged-attention kernel
        cfg = dataclasses.replace(
            self.model_config,
            paged_attention_kernel=self.paged_attention_kernel)
        sampler = make_sampler(greedy, top_k)
        paged, ps = self.kv_layout == "paged", self.page_size

        def decode(tokens, lengths, page_tables, temperature, top_p):
            # tokens (slots, width); lengths (slots,) int32
            if paged:
                hidden = gpt2.forward_hidden(
                    self.params, tokens, cfg, cache=self.kv.buffers(),
                    positions=lengths, page_tables=page_tables,
                    valid_lens=torch.full_like(lengths, tokens.shape[1]),
                    page_size=ps, tp_group=self.tp_group)
            else:
                hidden = gpt2.forward_hidden(
                    self.params, tokens, cfg, cache=self.kv.buffers(),
                    positions=lengths, tp_group=self.tp_group)
            logits = self._last_logits(hidden)
            chosen = sampler(logits.reshape(-1, logits.shape[-1]),
                             self.generator, temperature, top_p)
            return chosen.reshape(tokens.shape), logits

        self._decode_fns[key] = decode
        self.compile_stats["decode_traces"] += 1
        return decode

    # --------------------------------------------------- paged host state

    def pages_for(self, n_tokens):
        return -(-n_tokens // self.page_size)

    def prefix_stats(self):
        return self.prefix_cache.stats() if self.prefix_cache is not None \
            else None

    def try_admit(self, slot, context):
        """Paged admission: match the prompt against the prefix cache
        FIRST (mapping shared pages into this slot's table, refcounted)
        and allocate fresh pages only for the unmatched suffix. Returns
        True, or False when the pool cannot hold the suffix — the caller
        keeps the request queued. A second match pass runs at first-chunk
        time (:meth:`match_prefix`). Slot layout: always True."""
        if self.kv_layout != "paged":
            return True
        n = len(context)
        row = self.page_tables[slot]
        matched = []
        if self.prefix_cache is not None:
            # cap the match below the full prompt: the first sampled
            # token's logits must come from at least one real forward
            matched, _ = self.prefix_cache.match(context, n - 1)
        need = self.pages_for(n) - len(matched)
        if not self.allocator.can_alloc(need) and \
                self.prefix_cache is not None:
            self.prefix_cache.evict(need)
        if not self.allocator.can_alloc(need):
            if self.prefix_cache is not None:
                # refs AND stats roll back: a queued request retrying
                # admission every step must not inflate the hit gauges
                self.prefix_cache.unmatch(matched)
            return False
        for j, page in enumerate(matched):
            row[j] = page
        for j in range(len(matched), self.pages_for(n)):
            row[j] = self.allocator.alloc()
        self.page_counts[slot] = self.pages_for(n)
        self._admit_matched[slot] = len(matched)
        return True

    def match_prefix(self, slot, context):
        """Second match phase, at first-chunk time: extend the admission
        match with pages a same-step burst sibling registered in
        between. Newly matched shared pages replace the slot's freshly
        allocated ones, which return to the pool. Returns the TOTAL
        number of leading tokens already resident (the prefill start
        offset)."""
        have = int(self._admit_matched.get(slot, 0)) \
            if self.kv_layout == "paged" else 0
        if self.prefix_cache is None:
            return 0
        extra, _ = self.prefix_cache.match(
            context, len(context) - 1, skip_pages=have, count_lookup=False)
        row = self.page_tables[slot]
        for j, page in enumerate(extra, start=have):
            self.allocator.free(int(row[j]))
            row[j] = page
        return (have + len(extra)) * self.page_size

    def ensure_pages(self, slot, upto_tokens):
        """Grow ``slot``'s allocation to cover ``upto_tokens`` logical
        positions. False when the pool is exhausted (after trying
        prefix-cache eviction) — the scheduler preempts."""
        if self.kv_layout != "paged":
            return True
        need = min(self.pages_for(upto_tokens), self.max_pages)
        cur = int(self.page_counts[slot])
        if need <= cur:
            return True
        if not self.allocator.can_alloc(need - cur) and \
                self.prefix_cache is not None:
            self.prefix_cache.evict(need - cur)
        if not self.allocator.can_alloc(need - cur):
            return False
        for j in range(cur, need):
            self.page_tables[slot, j] = self.allocator.alloc()
        self.page_counts[slot] = need
        return True

    def register_prefix(self, slot, context):
        """Record the prompt's FULL pages in the prefix cache once its
        prefill completed (the cache takes its own refs; retiring this
        sequence won't free them)."""
        if self.prefix_cache is None:
            return
        full = len(context) // self.page_size
        if full:
            self.prefix_cache.register(
                context, self.page_tables[slot, :full].tolist())

    @torch.no_grad()
    def _page_copy(self, src, dst):
        """Copy physical page ``src`` to ``dst`` in both pools, in
        place."""
        self.kv.k[dst] = self.kv.k[src]
        self.kv.v[dst] = self.kv.v[src]

    def _cow_writes(self, slot, first_pos, last_pos):
        """Copy-on-write: fork any SHARED page the coming write range
        ``[first_pos, last_pos]`` touches (refcount > 1 means a prefix
        consumer or the prefix cache also maps it)."""
        if self.kv_layout != "paged":
            return
        lo = first_pos // self.page_size
        hi = min(last_pos // self.page_size,
                 int(self.page_counts[slot]) - 1)
        for j in range(lo, hi + 1):
            page = int(self.page_tables[slot, j])
            if page != GARBAGE_PAGE and self.allocator.refcount(page) > 1:
                new, forked = self.allocator.fork(page)
                if forked:
                    self._page_copy(page, new)
                    self.page_tables[slot, j] = new

    # ------------------------------------------------------------ serving

    def bucket_for(self, length):
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            "prompt length {} exceeds the largest prefill bucket {} "
            "(inference.prefill_buckets / max_seq_len)".format(
                length, self.prefill_buckets[-1]))

    @torch.no_grad()
    def prefill_chunk(self, slot, tokens, start, sampling=None):
        """Embed ``tokens`` (one prompt chunk) into ``slot`` at absolute
        positions ``[start, start+len)`` and return the sampled token
        from the chunk's last position (only meaningful on the FINAL
        chunk). Paged slots must already hold pages covering the range
        (``try_admit``)."""
        assert 0 <= slot < self.num_slots
        n = len(tokens)
        assert n >= 1, "empty prefill chunk"
        assert start + n < self.max_seq_len, \
            "chunk end {} leaves no room to decode (max_seq_len " \
            "{})".format(start + n, self.max_seq_len)
        bucket = self.bucket_for(n)
        greedy, top_k, temperature, top_p = self._sampling_key(sampling)
        fn = self._get_prefill_fn(bucket, greedy, top_k)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = np.asarray(tokens, np.int64)
        ids = torch.from_numpy(ids).to(self.device)
        if self.kv_layout == "paged":
            self._cow_writes(slot, start, start + n - 1)
            token = fn(ids, torch.from_numpy(self.page_tables[slot]).to(
                self.device), start, n, temperature, top_p)
        else:
            # the slot layout writes the whole padded bucket into the
            # row; paging.plan_chunks guarantees it fits (the reference
            # clamps the write start instead — never needed)
            assert start + bucket <= self.max_seq_len, \
                "chunk bucket {}@{} overruns max_seq_len {}".format(
                    bucket, start, self.max_seq_len)
            token = fn(ids, slot, start, n, temperature, top_p)
        self.lengths[slot] = start + n
        return int(token)

    def prefill(self, slot, prompt, sampling=None):
        """Single-shot prefill of a whole prompt (the unchunked path:
        admission + one chunk). Returns the first sampled token."""
        n = len(prompt)
        assert n >= 1, "empty prompt"
        assert n < self.max_seq_len, \
            "prompt length {} leaves no room to decode (max_seq_len " \
            "{})".format(n, self.max_seq_len)
        if self.kv_layout == "paged" and \
                int(self.page_counts[slot]) < self.pages_for(n):
            assert self.ensure_pages(slot, n), "KV page pool exhausted"
        return self.prefill_chunk(slot, prompt, 0, sampling=sampling)

    @torch.no_grad()
    def decode_step(self, tokens, sampling=None):
        """One decode step for ALL slots: ``tokens`` (slots,) or
        (slots, width) are each slot's pending token (anything for
        inactive slots). Returns the same-shaped int array of chosen
        tokens; the caller decides which slots' results are live and
        calls :meth:`advance`."""
        tokens = np.asarray(tokens, np.int64)
        squeeze = tokens.ndim == 1
        if squeeze:
            tokens = tokens[:, None]
        assert tokens.shape[0] == self.num_slots
        width = tokens.shape[1]
        greedy, top_k, temperature, top_p = self._sampling_key(sampling)
        fn = self._get_decode_fn(greedy, top_k, width=width)
        page_tables = None
        if self.kv_layout == "paged":
            for slot in range(self.num_slots):
                if self.lengths[slot] > 0:
                    self._cow_writes(slot, int(self.lengths[slot]),
                                     int(self.lengths[slot]) + width - 1)
            page_tables = torch.from_numpy(self.page_tables).to(self.device)
        chosen, self.last_logits = fn(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.lengths).to(self.device), page_tables,
            temperature, top_p)
        chosen = chosen.cpu().numpy().astype(np.int32)
        return chosen[:, 0] if squeeze else chosen

    def verify_step(self, tokens, sampling=None):
        """Speculative verify: ``tokens`` (slots, k+1) = each slot's
        pending token followed by its k drafts. Returns (slots, k+1)
        ``chosen`` tokens — row i's entry j is the target's choice for
        the position AFTER tokens[i, :j+1]; the scheduler accepts the
        longest prefix with drafts[j] == chosen[j-1]."""
        return self.decode_step(tokens, sampling=sampling)

    def advance(self, slot, n=1):
        """Account ``n`` committed cache writes for ``slot`` (its live
        length grew by n: 1 per plain decode step, accepted+1 per
        speculative verify step)."""
        self.lengths[slot] += n

    def can_decode(self, slot):
        return self.lengths[slot] < self.max_seq_len

    def free_slot(self, slot):
        """Retire a slot: release its pages back to the pool (shared
        prefix pages just drop one reference) and zero its length."""
        if self.kv_layout == "paged":
            for j in range(int(self.page_counts[slot])):
                self.allocator.free(int(self.page_tables[slot, j]))
            self.page_tables[slot, :] = GARBAGE_PAGE
            self.page_counts[slot] = 0
            self._admit_matched.pop(slot, None)
        self.lengths[slot] = 0

    def generate(self, prompts, max_new_tokens=None, sampling=None,
                 eos_token_id=_UNSET, metrics=None):
        """Generate completions for ``prompts`` via the continuous-batching
        scheduler. Returns a list of generated-token lists, prompt order.
        ``eos_token_id`` left unset falls through to the config default
        (``inference.eos_token_id``); pass None to disable early stop."""
        from .scheduler import ContinuousBatchingScheduler
        if metrics is None:
            metrics = self.serving_metrics
        sched = ContinuousBatchingScheduler(self, metrics=metrics,
                                            sampling=sampling)
        kwargs = ({} if eos_token_id is _UNSET
                  else {"eos_token_id": eos_token_id})
        uids = [sched.submit(p, max_new_tokens=max_new_tokens, **kwargs)
                for p in prompts]
        results = sched.run()
        return [results[u] for u in uids]
