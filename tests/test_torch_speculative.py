"""The port's speculative decoding against the JAX package, on the CPU.

Every speculative case of ``tests/unit/test_serving.py`` (n-gram and
model drafters, EOS and budget, the slot layout and the cache end, the
model drafter across plain-decode interludes, sampled reproducibility,
the missing draft model) runs through ``deepspeed_tpu.init_inference``
and ``deepspeed_tpu_torch.init_inference`` on the same seeded weights
(2 layers, d_model 32, 2 heads, fp32) and prompts. Greedy streams are
held byte-identical to the JAX engine's and to the plain greedy stream,
and the speculative counts (proposed, accepted) equal the JAX engine's;
with the target as its own drafter every draft is accepted. Sampled
streams draw from ``torch.Generator`` (not ``jax.random``), so they are
held to themselves: same seed, same stream. ``NGramDrafter`` is a copy:
its source equals the original's.
"""
import inspect

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import speculative as jspec
from deepspeed_tpu.inference.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.utils.monitor import ServingMetrics as JaxMetrics
from deepspeed_tpu_torch.inference import speculative as tspec
from deepspeed_tpu_torch.inference.scheduler import \
    ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.monitor import ServingMetrics

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

TINY = dict(vocab_size=128, max_seq_len=64, n_layers=2, n_heads=2,
            d_model=32)
PS = 8


def _jax_model(seed=0, **over):
    cfg = jgpt2.GPT2Config(**dict(TINY, **over), use_flash_attention=False,
                           remat=False)
    return jgpt2.make_gpt2_model(config=cfg, seed=seed)


def _port_model(seed=0, **over):
    return tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**dict(TINY,
                                                                **over)),
                                 seed=seed)


@pytest.fixture(scope="module")
def models():
    return _jax_model(), _port_model()


def _inference(layout="paged", **over):
    base = {"max_batch_size": 3, "prefill_buckets": [8, 16, 32],
            "dtype": "fp32", "greedy": True}
    if layout == "paged":
        base.update(kv_layout="paged", kv_block_size=PS)
    base.update(over)
    return base


def _spec(method="ngram", k=4):
    return {"enabled": True, "method": method, "num_draft_tokens": k}


def _engines(models, inference, draft=None):
    """(JAX engine, port engine) on the same weights; ``draft`` is None,
    "same" (the target drafts for itself) or the overrides of another
    tiny drafter (seed 123)."""
    jm, tm = models
    jkw, tkw = {}, {}
    if draft == "same":
        jkw["draft_model"], tkw["draft_model"] = jm, tm
    elif draft is not None:
        jkw["draft_model"] = _jax_model(seed=123, **draft)
        tkw["draft_model"] = _port_model(seed=123, **draft)
    jeng = deepspeed_tpu.init_inference(
        model=jm, config={"inference": inference}, **jkw)
    teng = deepspeed_tpu_torch.init_inference(
        model=tm, config={"inference": inference}, device="cpu", **tkw)
    return jeng, teng


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=n).tolist() for n in lens]


def greedy_chain(model, prompt, n):
    """n greedy tokens by repeated full forwards of the port's model."""
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            ids = torch.tensor([seq])
            hidden = tgpt2.forward_hidden(model, ids, model.config)
            seq.append(int((hidden[0, -1] @ model.wte.T).argmax()))
    return seq[len(prompt):]


_REPETITIVE = ([3, 7, 9] * 6)[:14]

# name -> (layout, draft, spec section, prompts, max_new)
CASES = {
    "ngram_paged": ("paged", None, _spec("ngram", 4),
                    [_REPETITIVE] + _prompts(1, (9, 17)), 11),
    "ngram_slot": ("slot", None, _spec("ngram", 4),
                   [_REPETITIVE] + _prompts(1, (9, 17)), 11),
    "model_same_paged": ("paged", "same", _spec("model", 3),
                         _prompts(2, (6, 13)), 9),
    "model_same_slot": ("slot", "same", _spec("model", 3),
                        _prompts(2, (6, 13)), 9),
    "model_other_paged": ("paged", {"n_layers": 1}, _spec("model", 3),
                          _prompts(2, (6, 13)), 9),
    "model_other_slot": ("slot", {"n_layers": 1}, _spec("model", 3),
                         _prompts(2, (6, 13)), 9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_greedy_streams_byte_identical_to_jax(models, name):
    """Byte-identical to the JAX engine and to plain greedy decode,
    with equal (proposed, accepted) counts and scheduler steps; the
    target drafting for itself accepts every draft."""
    layout, draft, spec, prompts, max_new = CASES[name]
    inference = _inference(layout, speculative=spec)
    if layout == "slot":
        inference["max_batch_size"] = 2
    jeng, teng = _engines(models, inference, draft)
    jsched, tsched = JaxScheduler(jeng), ContinuousBatchingScheduler(teng)
    juids = [jsched.submit(p, max_new_tokens=max_new) for p in prompts]
    tuids = [tsched.submit(p, max_new_tokens=max_new) for p in prompts]
    jres, tres = jsched.run(), tsched.run()
    tout = [tres[u] for u in tuids]
    assert tout == [jres[u] for u in juids]
    assert tout == [greedy_chain(models[1], p, max_new) for p in prompts]
    assert tsched.steps == jsched.steps
    tdist = teng.serving_metrics.spec_dist()
    assert tdist == jeng.serving_metrics.spec_dist()
    assert tdist["proposed"] > 0
    if draft == "same":
        assert tdist["acceptance_rate"] == 1.0
    assert teng.serving_metrics.decode_tokens == \
        jeng.serving_metrics.decode_tokens
    if layout == "paged":
        assert teng.allocator.pages_in_use == 0
        np.testing.assert_array_equal(teng.page_tables, jeng.page_tables)
    if draft is not None:
        np.testing.assert_array_equal(teng.drafter.lengths,
                                      jeng.drafter.lengths)


def test_spec_respects_eos_and_budget(models):
    """EOS inside an accepted draft run truncates exactly like the
    baseline (and the JAX engine), and max_new_tokens never overshoots."""
    jeng, teng = _engines(models, _inference(speculative=_spec("ngram", 4)))
    prompt = [7, 7, 7]
    free_run = greedy_chain(models[1], prompt, 8)
    eos = free_run[2]
    got = teng.generate([prompt], max_new_tokens=8, eos_token_id=eos)[0]
    assert got == free_run[:free_run.index(eos) + 1]
    assert got == jeng.generate([prompt], max_new_tokens=8,
                                eos_token_id=eos)[0]
    out = teng.generate([prompt], max_new_tokens=5)[0]
    assert out == free_run[:5]
    assert out == jeng.generate([prompt], max_new_tokens=5)[0]
    assert teng.lengths.tolist() == [0] * teng.num_slots
    assert teng.serving_metrics.spec_dist() == \
        jeng.serving_metrics.spec_dist()


def test_spec_slot_layout_and_cache_end(models):
    """Speculation composes with the slot layout, and k_eff clamps near
    the cache ceiling (no write past max_seq): 60 -> 64 leaves 4 writes +
    the final sampled-but-not-embedded token."""
    inference = _inference("slot", prefill_buckets=[8, 16, 32, 64],
                           speculative=_spec("ngram", 4))
    jeng, teng = _engines(models, inference)
    long_prompt = list(range(30)) * 2
    out = teng.generate([long_prompt], max_new_tokens=50)[0]
    n_new = TINY["max_seq_len"] - len(long_prompt) + 1
    assert len(out) == n_new
    assert out == greedy_chain(models[1], long_prompt, n_new)
    assert out == jeng.generate([long_prompt], max_new_tokens=50)[0]
    assert teng.serving_metrics.spec_dist() == \
        jeng.serving_metrics.spec_dist()


def test_model_drafter_survives_plain_decode_interludes(models):
    """While a slot sits near the cache ceiling, steps run plain decode
    (k_eff 0); the model drafter still embeds each committed token, so
    speculation resumes with every draft accepted (target = drafter)."""
    inference = _inference(max_batch_size=2,
                           prefill_buckets=[8, 16, 32, 64],
                           speculative=_spec("model", 3))
    jeng, teng = _engines(models, inference, draft="same")
    near_ceiling = list(range(1, 59))             # 58 of 64: forces k_eff 0
    short = [5, 3, 8, 1]
    got = {}
    for name, eng, scheduler in (("jax", jeng, JaxScheduler),
                                 ("port", teng,
                                  ContinuousBatchingScheduler)):
        sched = scheduler(eng)
        u_long = sched.submit(near_ceiling, max_new_tokens=10)
        u_short = sched.submit(short, max_new_tokens=25)
        res = sched.run()
        got[name] = (res[u_long], res[u_short], sched.steps,
                     eng.serving_metrics.spec_dist())
    long_out, short_out, _, spec = got["port"]
    assert short_out == greedy_chain(models[1], short, 25)
    assert len(long_out) == 64 - 58 + 1
    assert spec is not None and spec["acceptance_rate"] == 1.0, spec
    assert got["port"] == got["jax"]


def test_spec_sampled_acceptance_reproducible(models):
    """Non-greedy speculative decode: same seed -> same stream, right
    lengths (sequential-sampling semantics through the verify pass)."""
    inference = _inference(max_batch_size=1, prefill_buckets=[8],
                           greedy=False, top_k=8, temperature=0.9,
                           speculative=_spec("ngram", 3))
    run = lambda seed: deepspeed_tpu_torch.init_inference(
        model=models[1], config={"inference": inference}, device="cpu",
        seed=seed).generate([[3, 1, 4, 1, 5]], max_new_tokens=6)
    out = run(0)
    assert out == run(0)
    assert len(out[0]) == 6


def test_spec_through_the_kernel_wrapper_on_cpu(models):
    """``paged_attention_kernel: "pallas"`` sends the verify pass (s =
    k + 1 queries a slot) through the kernel's wrapper, which runs its
    plain version on CPU tensors: the same stream and counts."""
    _, _, spec, prompts, max_new = CASES["ngram_paged"]
    streams = []
    for kernel in ("pallas", "xla"):
        eng = deepspeed_tpu_torch.init_inference(
            model=models[1], device="cpu", config={"inference": _inference(
                speculative=spec, paged_attention_kernel=kernel)})
        assert eng.paged_attention_kernel == kernel
        streams.append((eng.generate(prompts, max_new_tokens=max_new),
                        eng.serving_metrics.spec_dist()))
    assert streams[0] == streams[1]


def test_model_drafter_requires_draft_model(models):
    with pytest.raises(AssertionError, match="draft_model"):
        deepspeed_tpu_torch.init_inference(
            model=models[1], device="cpu", config={"inference": _inference(
                speculative={"enabled": True, "method": "model"})})


def test_model_drafter_requires_the_targets_vocab_and_reach(models):
    inference = _inference(speculative=_spec("model", 3))
    for over, match in (({"vocab_size": 256}, "vocab_size"),
                        ({"max_seq_len": 32}, "max_seq_len")):
        with pytest.raises(AssertionError, match=match):
            deepspeed_tpu_torch.init_inference(
                model=models[1], device="cpu",
                draft_model=_port_model(**over),
                config={"inference": inference})


def test_model_drafter_proposals_match_jax(models):
    """One prefill and two draft passes of the two ModelDrafters on the
    same weights: the same proposals and lengths."""
    jm, tm = models
    jd = jspec.ModelDrafter(jm, 2, 64, np.float32)
    td = tspec.ModelDrafter(tm, 2, 64, torch.float32, torch.device("cpu"))
    contexts = _prompts(3, (7, 12))
    for slot, ctx in enumerate(contexts):
        jd.prefill(slot, ctx)
        td.prefill(slot, ctx)
    pending = [c[-1] for c in contexts]
    for k in (4, 0):
        want = jd.propose_batch(pending, k)
        got = td.propose_batch(pending, k)
        assert got.shape == (2, k)
        np.testing.assert_array_equal(got, want)
        for slot in range(2):
            jd.advance(slot, 1)
            td.advance(slot, 1)
    np.testing.assert_array_equal(td.lengths, jd.lengths)
    td.free_slot(0)
    assert td.lengths[0] == 0


def test_ngram_drafter_is_a_copy():
    assert inspect.getsource(tspec.NGramDrafter) == \
        inspect.getsource(jspec.NGramDrafter)
    drafter = tspec.NGramDrafter(3, 1)
    assert drafter.propose([1, 2, 3, 1, 2], 3) == [3, 1, 2]
    assert drafter.propose([5], 2) == [5, 5]


def test_spec_counters_match_jax():
    port, jax_ = ServingMetrics(), JaxMetrics()
    assert port.spec_dist() is None and jax_.spec_dist() is None
    for proposed, accepted in ((4, 4), (4, 1), (3, 0)):
        port.record_spec(proposed, accepted)
        jax_.record_spec(proposed, accepted)
        port.record_decode(accepted + 1, 0.01)
        jax_.record_decode(accepted + 1, 0.01)
    assert port.spec_dist() == jax_.spec_dist()
    assert port.spec_acceptance_rate == jax_.spec_acceptance_rate
    assert port.snapshot()["speculative"] == jax_.snapshot()["speculative"]
