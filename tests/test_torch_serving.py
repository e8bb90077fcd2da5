"""The port's serving slice against the JAX package, on the CPU.

Same numpy-seeded weights and inputs through ``deepspeed_tpu`` and
``deepspeed_tpu_torch`` at a tiny size (2 layers, d_model 32, 2 heads,
fp32):

* model: ``init_params`` bit-identical, ``params_from_jax`` round trip
  bit-exact, ``_paged_attn_ctx`` context within 1e-5 with the pool
  writes bitwise equal, ``_forward_hidden_cached`` hidden states within
  1e-5 for both KV layouts;
* slice: greedy ``generate`` streams byte-identical between the port and
  ``deepspeed_tpu.init_inference`` for the slot, paged, prefix-caching,
  chunked-prefill and preemption configurations, paged == slot inside
  the port, and the page pool drains;
* rules: config error probes raise alike in both packages, sampling is
  reproducible from a seed and top-k keeps its support, the entry point
  refuses to run without CUDA unless asked for the CPU, unported
  features (the fleet, telemetry, analysis, controller and adapters)
  raise ``NotImplementedError``, and the port imports neither jax nor
  ``deepspeed_tpu`` (AST scan, and a run with jax blocked). Speculative
  decoding and tensor-parallel serving have their own files
  (``test_torch_speculative.py``, ``test_torch_tp_serving.py``).

Tolerances: 1e-5 (atol and rtol) where the two frameworks' fp32 matmuls
and softmax round differently in the last bits.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.inference.config import (
    DeepSpeedInferenceConfig as JaxInferenceConfig,
    DeepSpeedInferenceConfigError as JaxConfigError)
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference.config import (
    DeepSpeedInferenceConfig, DeepSpeedInferenceConfigError)
from deepspeed_tpu_torch.inference.sampling import make_sampler
from deepspeed_tpu_torch.inference.scheduler import \
    ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import gpt2 as tgpt2

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, max_seq_len=64, n_layers=2, n_heads=2,
            d_model=32)
PS = 8
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jgpt2.GPT2Config(**TINY, use_flash_attention=False, remat=False)
    return jgpt2.make_gpt2_model(config=cfg, seed=0)


@pytest.fixture(scope="module")
def port_model():
    return tgpt2.make_gpt2_model(config=tgpt2.GPT2Config(**TINY), seed=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + "/" + k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + "/" + str(i))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        np.testing.assert_array_equal(la[name], lb[name], err_msg=name)


# ------------------------------------------------------------------ model


def test_init_params_bitwise_equal_to_jax(jax_model):
    port = tgpt2.init_params(tgpt2.GPT2Config(**TINY), seed=0)
    _assert_trees_bitwise(port, jax_model.params)


def test_params_from_jax_round_trip(jax_model, port_model):
    state = tgpt2.params_from_jax(jax_model.params)
    assert set(state) == set(port_model.state_dict())
    assert "blocks.1.attn.qkv_kernel" in state
    _assert_trees_bitwise(tgpt2.params_to_jax(state), jax_model.params)
    # the module built from the seed holds the same weights
    _assert_trees_bitwise(tgpt2.params_to_jax(port_model.state_dict()),
                          jax_model.params)


def _attn_case():
    """One attention block's weights, input and a random paged pool
    (the shapes of tests/unit/test_pallas_kernels.py's dispatch test)."""
    rng = np.random.RandomState(1)
    b, s, ps = 2, 2, 4
    block = {"qkv_kernel": rng.randn(16, 48).astype(np.float32),
             "qkv_bias": rng.randn(48).astype(np.float32),
             "proj_kernel": rng.randn(16, 16).astype(np.float32),
             "proj_bias": rng.randn(16).astype(np.float32)}
    x = rng.randn(b, s, 16).astype(np.float32)
    k_pool = rng.randn(9, 2, 2, ps, 8).astype(np.float32)
    v_pool = rng.randn(9, 2, 2, ps, 8).astype(np.float32)
    pt = np.zeros((b, 8), np.int32)
    pt[0, :2] = [1, 2]
    pt[1, :3] = [3, 4, 5]
    pos = np.array([5, 9], np.int32)
    vl = np.array([s, s], np.int32)
    return block, x, k_pool, v_pool, pt, pos, vl, ps


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_paged_attn_ctx_matches_jax(kernel):
    block, x, k_pool, v_pool, pt, pos, vl, ps = _attn_case()
    jcfg = jgpt2.GPT2Config(vocab_size=64, max_seq_len=32, n_layers=2,
                            n_heads=2, d_model=16, paged_attention_kernel=kernel)
    want_ctx, want_k, want_v = jgpt2._paged_attn_ctx(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in block.items()}, jcfg,
        jnp.asarray(k_pool), jnp.asarray(v_pool), 1, jnp.asarray(pos),
        jnp.asarray(pt), jnp.asarray(vl), ps)
    tcfg = tgpt2.GPT2Config(vocab_size=64, max_seq_len=32, n_layers=2,
                            n_heads=2, d_model=16, paged_attention_kernel=kernel)
    tblock = torch.nn.Module()
    for k, v in block.items():
        setattr(tblock, k, torch.nn.Parameter(torch.from_numpy(v)))
    k_t, v_t = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    with torch.no_grad():
        ctx = tgpt2._paged_attn_ctx(
            torch.from_numpy(x), tblock, tcfg, k_t, v_t, 1,
            torch.from_numpy(pos), torch.from_numpy(pt), torch.from_numpy(vl),
            ps)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), **TOL)
    # the in-place writes land bit for bit where the JAX scatter puts them
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_forward_hidden_cached_matches_jax(jax_model, port_model, layout):
    # a bucket-padded prefill chunk then one batched decode step, both
    # through the cache
    rng = np.random.RandomState(2)
    L, h, dh = TINY["n_layers"], TINY["n_heads"], TINY["d_model"] // 2
    ids = rng.randint(0, 128, size=(2, 8)).astype(np.int64)
    positions = np.array([0, 3], np.int32)
    dec_ids = rng.randint(0, 128, size=(2, 1)).astype(np.int64)
    if layout == "slot":
        k = rng.randn(2, L, h, 32, dh).astype(np.float32)
        extra = [{}, {}]
        dec_pos = np.array([8, 11], np.int32)
    else:
        k = rng.randn(9, L, h, PS, dh).astype(np.float32)
        k[0] = np.nan                                    # garbage page
        pt = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
        valid = np.array([6, 8], np.int32)               # row 0 padded
        extra = [dict(page_tables=pt, valid_lens=valid, page_size=PS),
                 dict(page_tables=pt, valid_lens=np.ones(2, np.int32),
                      page_size=PS)]
        dec_pos = positions + valid
    v = rng.randn(*k.shape).astype(np.float32)

    jcache = (jnp.asarray(k), jnp.asarray(v))
    tcache = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    for step, (inp, pos) in enumerate(((ids, positions),
                                       (dec_ids, dec_pos))):
        jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
               for key, val in extra[step].items()}
        jh, jcache = jgpt2._forward_hidden_cached(
            jax_model.params, jnp.asarray(inp.astype(np.int32)),
            jax_model.config, jcache, jnp.asarray(pos), **jkw)
        tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray)
               else val for key, val in extra[step].items()}
        with torch.no_grad():
            th = tgpt2._forward_hidden_cached(
                port_model, torch.from_numpy(inp), port_model.config, tcache,
                torch.from_numpy(pos), **tkw)
        rows = [slice(None)] * 2 if layout == "slot" else \
            [slice(0, int(n)) for n in extra[step]["valid_lens"]]
        for b, r in enumerate(rows):
            np.testing.assert_allclose(th[b, r].numpy(),
                                       np.asarray(jh)[b, r], **TOL)
    for t, j in zip(tcache, jcache):
        t, j = t.numpy(), np.asarray(j)
        if layout == "paged":                 # page 0 is write-only garbage
            t, j = t[1:], j[1:]
        np.testing.assert_allclose(t, j, **TOL)


# ------------------------------------------------------------------ slice


def _inference(**over):
    base = {"max_batch_size": 3, "prefill_buckets": [8, 16, 32],
            "dtype": "fp32", "greedy": True}
    base.update(over)
    return base


def _prompts(seed, lens, prefix=()):
    rs = np.random.RandomState(seed)
    return [list(prefix) + rs.randint(0, 128, size=n).tolist()
            for n in lens]


_SYSTEM = np.random.RandomState(9).randint(0, 128, size=2 * PS).tolist()

SLICE_CASES = {
    "slot": (_inference(), _prompts(0, (5, 11, 14, 26)), 12),
    "paged": (_inference(kv_layout="paged", kv_block_size=PS),
              _prompts(0, (5, 11, 14, 26)), 12),
    "prefix": (_inference(kv_layout="paged", kv_block_size=PS,
                          max_batch_size=4, prefix_caching=True),
               _prompts(10, (3, 6, 2, 5, 9), prefix=_SYSTEM), 6),
    "chunked": (_inference(kv_layout="paged", kv_block_size=PS,
                           prefill_chunk_tokens=8),
                _prompts(4, (29, 5, 18)), 6),
    "preempt": (_inference(kv_layout="paged", kv_block_size=PS,
                           num_pages=9),
                _prompts(5, (12, 14, 10)), 24),
}


def _run(engine, prompts, max_new):
    """Drive one scheduler over ``prompts``; -> (streams, scheduler)."""
    scheduler = ContinuousBatchingScheduler \
        if isinstance(engine, InferenceEngine) else JaxScheduler
    sched = scheduler(engine)
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    results = sched.run()
    return [results[u] for u in uids], sched


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_greedy_streams_byte_identical_to_jax(jax_model, port_model, name):
    inference, prompts, max_new = SLICE_CASES[name]
    jeng = deepspeed_tpu.init_inference(model=jax_model,
                                        config={"inference": inference})
    teng = deepspeed_tpu_torch.init_inference(
        model=port_model, config={"inference": inference}, device="cpu")
    jout, jsched = _run(jeng, prompts, max_new)
    tout, tsched = _run(teng, prompts, max_new)
    assert tout == jout
    assert all(len(o) == max_new for o in tout)
    assert tsched.preemptions == jsched.preemptions
    assert tsched.steps == jsched.steps
    assert teng.compile_stats == jeng.compile_stats
    if name == "preempt":
        assert tsched.preemptions > 0
    if teng.kv_layout == "paged":
        # paged == slot inside the port, and the pool drains
        slot = deepspeed_tpu_torch.init_inference(
            model=port_model, device="cpu", config={"inference": _inference(
                max_batch_size=inference["max_batch_size"])})
        assert _run(slot, prompts, max_new)[0] == tout
        assert teng.prefix_stats() == jeng.prefix_stats()
        entries = (teng.prefix_stats() or {}).get("entries", 0)
        assert teng.allocator.pages_in_use == entries
        if teng.prefix_cache is not None:
            assert teng.prefix_stats()["hits"] >= 3
            teng.prefix_cache.clear()
        assert teng.allocator.pages_in_use == 0
        np.testing.assert_array_equal(teng.page_tables, jeng.page_tables)


def test_paged_kernel_setting_reads_the_wrapper_on_cpu(port_model):
    # "pallas" on CPU tensors takes the wrapper, which runs the plain
    # version: same streams, prefill stays on the gather path
    inference, prompts, max_new = SLICE_CASES["paged"]
    eng = deepspeed_tpu_torch.init_inference(
        model=port_model, device="cpu", config={"inference": dict(
            inference, paged_attention_kernel="pallas")})
    assert eng.paged_attention_kernel == "pallas"
    assert eng.model_config.paged_attention_kernel == "xla"
    auto = deepspeed_tpu_torch.init_inference(
        model=port_model, device="cpu", config={"inference": inference})
    assert auto.paged_attention_kernel == "xla"
    assert _run(eng, prompts, max_new)[0] == \
        _run(auto, prompts, max_new)[0]


# ------------------------------------------------------------------ rules


BAD_INFERENCE = [
    {"kv_layout": "blocked"}, {"prefix_caching": True}, {"kv_block_size": 0},
    {"num_pages": 4, "kv_pool_fraction": 0.5}, {"prefill_chunk_tokens": 0},
    {"speculative": {"enabled": True, "method": "oracle"}},
    {"speculative": {"num_draft_tokens": 0}}, {"speculative": {"drafts": 4}},
    {"paged_attention_kernel": "cuda"}, {"dtype": "int8"},
    {"max_batch_size": 0}, {"top_p": 0.0}, {"temperature": 0},
    {"prefill_buckets": []}, {"fleet": {"role": "prefill"}},
]


@pytest.mark.parametrize("bad", BAD_INFERENCE,
                         ids=[str(sorted(b)) for b in BAD_INFERENCE])
def test_config_error_probes_raise_alike(bad):
    with pytest.raises(JaxConfigError) as jerr:
        JaxInferenceConfig({"inference": bad})
    with pytest.raises(DeepSpeedInferenceConfigError) as terr:
        DeepSpeedInferenceConfig({"inference": bad})
    assert str(terr.value) == str(jerr.value)


def test_config_defaults_match():
    j = vars(JaxInferenceConfig({"inference": {"kv_layout": "paged"}}))
    t = vars(DeepSpeedInferenceConfig({"inference": {"kv_layout": "paged"}}))
    assert t.pop("dtype") == torch.float32 and str(j.pop("dtype")).endswith(
        "float32'>")
    assert t.pop("fleet_keys") == []
    assert t == j


def test_sampled_decoding_reproducible_from_seed(port_model):
    inference = _inference(kv_layout="paged", kv_block_size=PS, greedy=False,
                           top_k=5, temperature=0.8)
    prompts = _prompts(6, (4, 9))
    run = lambda seed: deepspeed_tpu_torch.init_inference(
        model=port_model, device="cpu", seed=seed,
        config={"inference": inference}).generate(prompts, max_new_tokens=8)
    assert run(3) == run(3)
    assert run(3) != run(4)


def test_top_k_keeps_its_support():
    rng = np.random.RandomState(7)
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32))
    top = torch.topk(logits, 3, dim=-1).indices
    sample = make_sampler(False, 3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = sample(logits, gen, 1.0, 1.0)
        assert (top == tok[:, None]).any(dim=-1).all()
    greedy = make_sampler(True)(logits, gen, 1.0, 1.0)
    assert torch.equal(greedy, top[:, 0])


def test_init_inference_without_device_needs_cuda(port_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model=port_model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_inference(model=port_model, device="cuda")


@pytest.mark.parametrize("probe", [
    "fleet", "telemetry", "analysis", "controller", "adapters",
    "submit_adapter"])
def test_unported_features_raise_not_implemented(port_model, probe):
    kw = dict(model=port_model, device="cpu")
    inference = {"max_batch_size": 2, "dtype": "fp32"}
    with pytest.raises(NotImplementedError, match="slice"):
        if probe == "fleet":
            deepspeed_tpu_torch.init_inference(config={"inference": dict(
                inference, kv_layout="paged", fleet={"role": "decode"})},
                **kw)
        elif probe in ("telemetry", "analysis", "controller"):
            deepspeed_tpu_torch.init_inference(config={
                "inference": inference, probe: {"enabled": True}}, **kw)
        else:
            eng = deepspeed_tpu_torch.init_inference(
                config={"inference": inference}, **kw)
            if probe == "adapters":
                eng.attach_adapters(object())
            else:
                ContinuousBatchingScheduler(eng).submit([1, 2], adapter=1)
    # a section given but switched off is accepted
    deepspeed_tpu_torch.init_inference(
        config={"inference": inference, "telemetry": {"enabled": False}},
        **kw)


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deepspeed_tpu"}


def _port_sources():
    # the tensor-parallel test ranks run the port alone, so their module
    # is held to the same rule
    return sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py", REPO / "tests" / "torch_tp_workers.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += ["{}:{} {}".format(path.relative_to(REPO),
                                            node.lineno, n)
                          for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(_port_sources()) > 10
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("utils/distributed.py", "parallel/topology.py",
                   "parallel/ring.py", "parallel/collective_matmul.py",
                   "ops/ring_gemm/ring_gemm.py", "runtime/comm/config.py"):
        assert "deepspeed_tpu_torch/" + module in scanned, module
    assert not offenders, offenders


def test_port_runs_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["deepspeed_tpu"] = None
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch, chip_smoke
from deepspeed_tpu_torch.models import gpt2
cfg = gpt2.GPT2Config(vocab_size=64, max_seq_len=32, n_layers=1, n_heads=2,
                      d_model=16)
eng = deepspeed_tpu_torch.init_inference(
    model=gpt2.make_gpt2_model(config=cfg), device="cpu",
    config={"inference": {"max_batch_size": 2, "prefill_buckets": [8],
                          "kv_layout": "paged", "kv_block_size": 4}})
out = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
assert [len(o) for o in out] == [3, 3], out
import numpy as np
import deepspeed_tpu_torch.ops.transformer.attention
tcfg = gpt2.GPT2Config(vocab_size=64, max_seq_len=32, n_layers=1, n_heads=2,
                       d_model=64, loss_chunk=8)
teng = deepspeed_tpu_torch.initialize(
    model=gpt2.make_gpt2_model(config=tcfg), device="cpu", config_params={
        "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
        "zero_optimization": {"stage": 2},
        "transformer": {"flash_attention": "pallas"},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})[0]
ids = np.random.RandomState(0).randint(0, 64, size=(1, 2, 32))
assert np.isfinite(float(teng.train_batch(batch=(ids, ids))))
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
