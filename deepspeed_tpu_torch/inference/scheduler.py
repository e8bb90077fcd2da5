"""Continuous-batching scheduler over the InferenceEngine's cache slots.

Port of ``deepspeed_tpu/inference/scheduler.py``. Each ``step()`` runs
four phases, in this order, directly: admit queued requests into free
slots (paged admission maps prefix-cache hits and allocates prompt
pages), run at most ONE prefill chunk per admitted-but-not-ready slot,
run one batched decode step for every decoding slot, then close the step
(step counter, occupancy accounting). That is the serial order the JAX
package's segment-plan executor is held bit-exact against
(``runtime/executor/serving.py``); the executor, spans, watchdogs and
the controller come with the observability slice.

With ``inference.prefill_chunk_tokens`` set, a long prefill does not
stall the decode batch: decode keeps firing between chunks.

Speculative decoding (``inference.speculative``): the drafter proposes
``k`` tokens per decoding slot, one verify pass (the decode step at width
``k + 1``) scores all slots' proposals, and the longest target-agreeing
prefix (+1 bonus token) commits — greedy acceptance reproduces the
autoregressive greedy stream byte for byte. Paged-pool
pressure: admission that cannot allocate stays queued; mid-decode
exhaustion preempts the YOUNGEST decoding request (pages freed, request
requeued; its context re-prefills on re-admission).
"""
import time
from collections import deque

from ..utils.monitor import ServingMetrics
from ..utils.timer import SynchronizedWallClockTimer
from .paging import plan_chunks

_UNSET = object()


class InferenceRequest:
    """One queued/running generation request."""

    __slots__ = ("uid", "prompt", "max_new_tokens", "eos_token_id",
                 "generated", "slot", "state", "context", "chunks",
                 "chunk_idx", "arrival_t", "first_token_t", "resumed",
                 "admit_order")

    def __init__(self, uid, prompt, max_new_tokens, eos_token_id):
        self.uid = uid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.generated = []
        self.slot = None
        self.state = "queued"        # queued -> prefill -> decode -> done
        self.context = self.prompt   # tokens to embed (grows on resume)
        self.chunks = None           # [(start, len), ...] prefill plan
        self.chunk_idx = 0
        self.arrival_t = time.perf_counter()
        self.first_token_t = None
        self.resumed = False         # re-admitted after preemption
        self.admit_order = -1        # preemption picks the youngest


class ContinuousBatchingScheduler:

    def __init__(self, engine, metrics=None, sampling=None):
        self.engine = engine
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # the engine-lifetime counters are kept in parallel with a
        # caller-supplied per-call `metrics`
        self._record_metrics = engine.serving_metrics
        self.sampling = sampling
        self.queue = deque()
        self.slots = [None] * engine.num_slots
        self.results = {}
        self.timers = SynchronizedWallClockTimer(device=engine.device)
        self._next_uid = 0
        self._admitted = 0
        self.steps = 0
        self.preemptions = 0

    def _account(self, method, *args, **kwargs):
        """Apply one ServingMetrics update to the caller's object AND
        the engine-lifetime one."""
        getattr(self.metrics, method)(*args, **kwargs)
        if self._record_metrics is not self.metrics:
            getattr(self._record_metrics, method)(*args, **kwargs)

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens=None, eos_token_id=_UNSET,
               adapter=0):
        """Queue a request; returns its uid (results keyed by it)."""
        if adapter:
            raise NotImplementedError(
                "multi-tenant adapters are not ported yet: they come with "
                "the serving-fleet slice")
        ic = self.engine.inference_config
        prompt = list(prompt)
        assert len(prompt) >= 1, "empty prompt"
        # admission-time validation so a bad request fails its caller,
        # not a later step() on someone else's request
        self.engine.bucket_for(len(prompt))
        assert len(prompt) < self.engine.max_seq_len, \
            "prompt length {} leaves no room to decode (max_seq_len " \
            "{})".format(len(prompt), self.engine.max_seq_len)
        assert max_new_tokens is None or max_new_tokens >= 1, \
            "max_new_tokens must be >= 1, got {!r}".format(max_new_tokens)
        req = InferenceRequest(
            self._next_uid, prompt,
            max_new_tokens if max_new_tokens is not None
            else ic.max_new_tokens,
            ic.eos_token_id if eos_token_id is _UNSET else eos_token_id)
        self._next_uid += 1
        self.queue.append(req)
        return req.uid

    # ------------------------------------------------------------ stepping

    @property
    def num_active(self):
        return sum(1 for r in self.slots if r is not None)

    @property
    def has_work(self):
        return bool(self.queue) or self.num_active > 0

    def _finish(self, req):
        """Move a request's result out and release its slot + pages."""
        self.results[req.uid] = list(req.generated)
        req.state = "done"
        self.slots[req.slot] = None
        self.engine.free_slot(req.slot)
        if self.engine.drafter is not None:
            self.engine.drafter.free_slot(req.slot)
        now = time.perf_counter()
        tpot = None
        if len(req.generated) > 1 and req.first_token_t is not None:
            tpot = (now - req.first_token_t) / (len(req.generated) - 1)
        self._account("record_completion", len(req.generated), tpot)
        req.slot = None

    def _retire_if_done(self, req):
        done = (len(req.generated) >= req.max_new_tokens or
                (req.eos_token_id is not None and req.generated and
                 req.generated[-1] == req.eos_token_id) or
                not self.engine.can_decode(req.slot))
        if done:
            self._finish(req)
        return done

    def _append_tokens(self, req, tokens):
        """Commit generated tokens, honoring EOS and the budget. Returns
        ``(appended, done)`` — how many tokens the request actually took
        (speculative accounting must not count truncated ones) and
        whether it retired."""
        appended = 0
        for tok in tokens:
            req.generated.append(int(tok))
            appended += 1
            if ((req.eos_token_id is not None and
                 int(tok) == req.eos_token_id) or
                    len(req.generated) >= req.max_new_tokens):
                break
        return appended, self._retire_if_done(req)

    def _preempt_youngest(self, exclude=()):
        """Recompute-preemption: requeue the most recently admitted
        decoding request, freeing its pages. Its context (prompt + the
        tokens generated so far, minus the pending one) re-prefills on
        re-admission and generation continues where it stopped."""
        victim = None
        for req in self.slots:
            if req is None or req in exclude or req.state != "decode":
                continue
            if victim is None or req.admit_order > victim.admit_order:
                victim = req
        if victim is None:
            return False
        self.slots[victim.slot] = None
        self.engine.free_slot(victim.slot)
        if self.engine.drafter is not None:
            self.engine.drafter.free_slot(victim.slot)
        victim.slot = None
        victim.state = "queued"
        victim.resumed = True
        # generated[-1] is the PENDING token (not yet in the cache): it
        # re-enters as the decode input after the context re-prefills
        victim.context = victim.prompt + victim.generated[:-1]
        victim.chunks, victim.chunk_idx = None, 0
        self.queue.appendleft(victim)
        self.preemptions += 1
        return True

    # ------------------------------------------------------------ phases

    def _admit(self):
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            if not self.engine.try_admit(slot, req.context):
                break                      # pool full: stay queued
            self.queue.popleft()
            req.slot = slot
            req.state = "prefill"
            req.admit_order = self._admitted
            self._admitted += 1
            self.slots[slot] = req
            # the chunk plan is built at FIRST-chunk time (below): the
            # prefix match runs there, after same-step siblings have
            # registered their pages
            req.chunks, req.chunk_idx = None, 0

    def _prefill_chunks(self, retired):
        ic = self.engine.inference_config
        for req in list(self.slots):
            if req is None or req.state != "prefill":
                continue
            if req.chunks is None:
                start = self.engine.match_prefix(req.slot, req.context)
                req.chunks = plan_chunks(
                    len(req.context) - start, ic.prefill_chunk_tokens,
                    self.engine.bucket_for, self.engine.max_seq_len,
                    start=start,
                    max_chunk=self.engine.prefill_buckets[-1])
                if start:
                    # prefix-cache hit: the matched pages' tokens are
                    # already resident — only the suffix embeds
                    self.engine.lengths[req.slot] = start
            start, ln = req.chunks[req.chunk_idx]
            chunk = req.context[start:start + ln]
            # try_admit reserved the WHOLE context's pages at admission,
            # so every chunk's range is covered
            t = self.timers("prefill")
            t.start()
            token = self.engine.prefill_chunk(req.slot, chunk, start,
                                              sampling=self.sampling)
            t.stop()
            self._account("record_prefill", ln, t.elapsed(reset=True))
            req.chunk_idx += 1
            # register the pages filled SO FAR (full pages only): a
            # same-burst sibling admitted this very step can match them
            self.engine.register_prefix(req.slot,
                                        req.context[:start + ln])
            if req.chunk_idx < len(req.chunks):
                continue
            # final chunk: the request becomes a decoder
            req.state = "decode"
            if self.engine.drafter is not None:
                self.engine.drafter.prefill(req.slot, req.context)
            if req.resumed:
                # the pending token survived preemption; nothing sampled
                continue
            now = time.perf_counter()
            req.first_token_t = now
            self._account("record_ttft", now - req.arrival_t)
            if self._append_tokens(req, [token])[1]:
                retired.append(req.uid)

    def _spec_k_eff(self):
        """Draft length this step: the configured k, or 0 (plain
        decode) whenever ANY occupied slot — decoding OR mid-prefill,
        the verify pass writes K/V for every slot — sits within k+1 of
        max_seq (the write would leave the slot's cache row). All or
        nothing, as in the JAX scheduler, so the decode family keeps two
        widths."""
        k = self.engine.spec_k
        for req in self.slots:
            if req is None:
                continue
            if int(self.engine.lengths[req.slot]) + 1 + k > \
                    self.engine.max_seq_len:
                return 0
        return k

    def _decode(self, retired):
        active = [r for r in self.slots
                  if r is not None and r.state == "decode"]
        if not active:
            return
        # paged capacity for this step's writes (plain decode: 1 token;
        # verify: k+1) — exhaustion preempts the youngest decoder
        drafter = self.engine.drafter
        k_eff = self._spec_k_eff() if drafter is not None else 0
        width = 1 + k_eff
        for req in list(active):
            if req.state != "decode":
                # preempted by an earlier slot's capacity fight
                active.remove(req)
                continue
            ok = self.engine.ensure_pages(
                req.slot, int(self.engine.lengths[req.slot]) + width)
            while not ok and self._preempt_youngest(exclude=(req,)):
                ok = self.engine.ensure_pages(
                    req.slot, int(self.engine.lengths[req.slot]) + width)
            if not ok:
                # starved even after preemption: sit this step out (its
                # write would land in the garbage page)
                active.remove(req)
        # a later slot's capacity fight may have preempted an EARLIER
        # already-validated one — keep only the still-decoding survivors
        active = [r for r in active if r.state == "decode"]
        if not active:
            return

        pending = [0] * self.engine.num_slots
        for req in active:
            pending[req.slot] = req.generated[-1]
        if k_eff >= 1:
            self._verify(active, pending, k_eff, retired)
            return
        if drafter is not None and drafter.needs_model:
            # a k=0 propose embeds exactly the pending token into the
            # drafter's cache: advancing its lengths without this write
            # would leave a stale hole INSIDE the live window and poison
            # every draft after speculation resumes
            drafter.propose_batch(pending, 0)
        t = self.timers("decode")
        t.start()
        next_tokens = self.engine.decode_step(pending, sampling=self.sampling)
        t.stop()
        self._account("record_decode", len(active), t.elapsed(reset=True))
        for req in active:
            self.engine.advance(req.slot)
            if drafter is not None and drafter.needs_model:
                drafter.advance(req.slot, 1)
            if self._append_tokens(req, [int(next_tokens[req.slot])])[1]:
                retired.append(req.uid)

    def _verify(self, active, pending, k_eff, retired):
        """Speculative step: draft k, verify all slots in one pass,
        commit each slot's accepted prefix plus the target's next
        token."""
        drafter = self.engine.drafter
        slots = self.engine.num_slots
        if drafter.needs_model:
            drafts = drafter.propose_batch(pending, k_eff)
        else:
            drafts = [[0] * k_eff for _ in range(slots)]
            for req in active:
                # prompt + generated = the TRUE token stream; a
                # preemption-resume folded earlier generations into
                # req.context, so context+generated would duplicate them
                drafts[req.slot] = drafter.propose(
                    req.prompt + req.generated, k_eff)
        tokens = [[pending[s]] + list(drafts[s])[:k_eff]
                  for s in range(slots)]
        t = self.timers("decode")
        t.start()
        chosen = self.engine.verify_step(tokens, sampling=self.sampling)
        t.stop()
        dt = t.elapsed(reset=True)
        emitted = 0
        for req in active:
            row, s = chosen[req.slot], req.slot
            accepted = 0
            while accepted < k_eff and \
                    int(tokens[s][accepted + 1]) == int(row[accepted]):
                accepted += 1
            new = [int(row[j]) for j in range(accepted + 1)]
            self.engine.advance(s, accepted + 1)
            if drafter.needs_model:
                drafter.advance(s, accepted + 1)
            self._account("record_spec", k_eff, accepted)
            appended, done = self._append_tokens(req, new)
            emitted += appended
            if done:
                retired.append(req.uid)
        self._account("record_decode", emitted, dt)

    def step(self):
        """Admit -> prefill chunks -> one decode/verify step -> retire.
        Returns the uids retired this step."""
        if not self.queue and self.num_active == 0:
            return []                  # idle poll: no work, no record
        retired = []
        self._admit()
        self._prefill_chunks(retired)
        # occupancy counts slots that did work THIS step — retire-at-
        # prefill already freed some, so measure before the decode retire
        busy = self.num_active + len(retired)
        self._decode(retired)
        self.steps += 1
        self._account("record_schedule",
                      occupancy=min(busy, self.engine.num_slots) /
                      self.engine.num_slots,
                      queue_depth=len(self.queue), step=self.steps)
        return retired

    def run(self):
        """Drive step() until every submitted request has retired; returns
        {uid: generated tokens}."""
        while self.has_work:
            self.step()
        return self.results
