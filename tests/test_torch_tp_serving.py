"""Tensor-parallel serving in the port against TP 1 and the JAX engine,
on the CPU.

Two gloo ranks (one spawn for the whole file, ``torch_tp_workers.
tp_serve``) each call ``deepspeed_tpu_torch.init_inference`` on the same
seeded model (2 layers, d_model 32, 2 heads, vocab 128, fp32) with
``mp_size=2`` (or a ``mesh``) and serve the same prompts: the paged and
slot layouts, n-gram and model-drafter speculation, the paged kernel's
wrapper, sampled decoding. Greedy streams are held byte-identical across
the ranks and to the port's TP 1 engine, and for the paged and slot
layouts to the JAX engine on ``build_mesh(data=4, model=2)`` (8 virtual
CPU devices, as ``tests/unit/test_inference.py`` builds it); the
speculative counts equal TP 1's. Each rank's KV cache holds ``n_heads /
2`` heads and its ``wte`` half the vocabulary. ``mp_size`` builds the
mesh; a world size it does not divide raises, and so does ``mp_size >
1`` without a process group.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as jax_build_mesh
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_tp_workers as workers

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

TINY = dict(vocab_size=128, max_seq_len=64, n_layers=2, n_heads=2,
            d_model=32)
DRAFT = dict(TINY, n_layers=1)
PS = 8
WORLD = 2


def _inference(layout, **over):
    base = {"max_batch_size": 3, "prefill_buckets": [8, 16, 32],
            "dtype": "fp32", "greedy": True}
    if layout == "paged":
        base.update(kv_layout="paged", kv_block_size=PS)
    base.update(over)
    return base


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=n).tolist() for n in lens]


_PROMPTS = [([3, 7, 9] * 6)[:14]] + _prompts(0, (5, 11, 26))
_NGRAM = {"enabled": True, "method": "ngram", "num_draft_tokens": 4}
_MODEL = {"enabled": True, "method": "model", "num_draft_tokens": 3}

# name -> (inference section, draft model overrides or None, build the
# mesh by hand)
GREEDY = {
    "paged": (_inference("paged"), None, False),
    "slot": (_inference("slot"), None, True),
    "paged_ngram": (_inference("paged", speculative=_NGRAM), None, False),
    "slot_ngram": (_inference("slot", speculative=_NGRAM), None, True),
    "paged_model": (_inference("paged", speculative=_MODEL), DRAFT, False),
    "paged_kernel": (_inference("paged", speculative=_NGRAM,
                                paged_attention_kernel="pallas"), None,
                     False),
}
MAX_NEW = 10
SAMPLED = _inference("paged", greedy=False, top_k=8, temperature=0.9,
                     speculative=_NGRAM)


def _specs():
    specs = [dict(model=TINY, inference=inference, prompts=_PROMPTS,
                  max_new=MAX_NEW, mesh=mesh, draft=draft)
             for inference, draft, mesh in
             (GREEDY[name] for name in sorted(GREEDY))]
    specs.append(dict(model=TINY, inference=SAMPLED, prompts=_PROMPTS,
                      max_new=MAX_NEW, sample_seed=5))
    specs.append(dict(model=TINY, inference=_inference("paged"),
                      prompts=_PROMPTS, max_new=MAX_NEW, mp_size=3,
                      raises=True))
    return specs


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, one list per rank in :func:`_specs`'s
    order: ``{name: result}`` for the greedy cases, then "sampled" and
    "mp_size_3"."""
    out = spawn(workers.tp_serve, WORLD, args=(_specs(),), timeout_s=300)
    names = sorted(GREEDY) + ["sampled", "mp_size_3"]
    return [dict(zip(names, results)) for results in out]


def _tp1(name):
    inference, draft, _ = GREEDY[name]
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**TINY), seed=0)
    kw = {}
    if draft is not None:
        kw["draft_model"] = tgpt2.make_gpt2_model(
            config=tgpt2.GPT2Config(**draft), seed=1)
    eng = deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": inference}, device="cpu", **kw)
    return eng.generate(_PROMPTS, max_new_tokens=MAX_NEW), \
        eng.serving_metrics.spec_dist()


def _jax_tp2(name):
    model = jgpt2.make_gpt2_model(config=jgpt2.GPT2Config(
        **TINY, use_flash_attention=False, remat=False), seed=0)
    eng = deepspeed_tpu.init_inference(
        model=model, mesh=jax_build_mesh(data=4, model=2),
        config={"inference": GREEDY[name][0]})
    return eng.generate(_PROMPTS, max_new_tokens=MAX_NEW)


@pytest.mark.parametrize("name", sorted(GREEDY))
def test_tp2_streams_equal_tp1_and_the_jax_engine(ranks, name):
    """Every case against TP 1 (streams and speculative counts); the
    paged and slot layouts also against the JAX engine on a model axis of
    2 (the speculative TP 1 streams are held to the JAX engine's in
    test_torch_speculative.py)."""
    got = [r[name]["streams"] for r in ranks]
    assert got[0] == got[1]
    assert all(len(o) == MAX_NEW for o in got[0])
    want, spec = _tp1(name)
    assert got[0] == want
    assert ranks[0][name]["spec"] == spec
    if name in ("paged", "slot"):
        assert got[0] == _jax_tp2(name)


@pytest.mark.parametrize("name", ["paged", "slot"])
def test_tp2_rank_holds_half_the_heads(ranks, name):
    for rank, r in enumerate(ranks):
        res = r[name]
        assert res["tp_rank"] == rank
        assert res["pool_shape"][2] == TINY["n_heads"] // WORLD
        assert res["wte_rows"] == TINY["vocab_size"] // WORLD
        assert res["pages_in_use"] == 0
    if name == "paged":
        assert ranks[0][name]["pool_shape"][3] == PS
    else:
        assert ranks[0][name]["pool_shape"][:2] == (3, TINY["n_layers"])


def test_mp_size_builds_the_mesh(ranks):
    assert all(r[name]["model_axis"] == WORLD
               for r in ranks for name in GREEDY)
    assert ranks[0]["paged_kernel"]["kernel"] == "pallas"
    assert ranks[0]["paged"]["kernel"] == "xla"


def test_tp2_ranks_sample_alike(ranks):
    a, b = (r["sampled"]["streams"] for r in ranks)
    assert a == b
    assert all(len(o) == MAX_NEW for o in a)


def test_non_dividing_mp_size_raises(ranks):
    for r in ranks:
        assert r["mp_size_3"]["raised"] == "ValueError"
        assert "does not divide" in r["mp_size_3"]["message"]


def test_mp_size_without_a_process_group_raises():
    model = tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**TINY), seed=0)
    with pytest.raises(RuntimeError, match="process group"):
        deepspeed_tpu_torch.init_inference(model=model, mp_size=2,
                                           device="cpu")


def test_kv_cache_heads_must_divide():
    from deepspeed_tpu_torch.inference.kv_cache import (KVCache,
                                                        PagedKVCache)
    assert KVCache.allocate(2, 1, 4, 8, 4, torch.float32, "cpu",
                            tp=2).k.shape == (2, 1, 2, 8, 4)
    assert PagedKVCache.allocate(3, 1, 4, 4, 4, torch.float32, "cpu",
                                 tp=4).k.shape == (4, 1, 1, 4, 4)
    with pytest.raises(AssertionError, match="not divisible"):
        KVCache.allocate(2, 1, 3, 8, 4, torch.float32, "cpu", tp=2)
