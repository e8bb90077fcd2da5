"""The port's CUDA kernels on the card, at shapes beyond the main path's.

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

* ``paged_attention``: the kernel against its plain version
  (``paged_attention_reference``) on the same inputs on the card, over
  float32 / bfloat16 / float16 pools, head widths 32-256, pages of 4-32
  tokens, one or several queries per slot with padded valid lengths, and
  NaN in the garbage page and every unallocated page. Tolerance 2e-5
  absolute: both sides read the same values and compute in fp32, only the
  order of the sums differs.
* the engine: tiny fp32 GPT-2 greedy streams identical for the slot
  layout and the paged layout read through the kernel, with one launch
  per layer per decode step; speculative decoding (n-gram and model
  drafter, the kernel at the verify width) and tensor-parallel serving
  (two gloo ranks on the card, one head each) give the plain stream.
* flash attention (forward, dk/dv and dq kernels): each against its
  plain version over d_head 32/64/128, ragged lengths, causal and not,
  a key bias, fp32/bf16/fp16, q/k/v as strided column blocks of one QKV
  tensor or separate; the fp16 backward at long sequences with a key bias
  and with P and dS in fp16's subnormal range; outputs written into
  caller-given views; repeated runs bit-identical; refusals;
  the (b, s, h, d) op with a key-padding mask against its CPU run.
* Adam: the kernel against its plain version bit for bit, over odd
  lengths and misaligned starts, AdamW and L2, fp32 and bf16 moments, and
  over each ZeRO rank's range of one buffer (views at an aligned nonzero
  offset).
* training: a tiny fp32 GPT-2 through ``initialize(...).train_batch``, 3
  steps with the kernels ("pallas") and with the plain versions ("xla"),
  losses within 1e-5 relative, with one launch of each flash kernel per
  layer per step and one Adam launch per step; the same at data-parallel
  world 2 (two gloo ranks on the card), fp32 and bf16 ZeRO-2, Adam with
  both moment dtypes and LAMB.
* ZeRO-3: DP 2 x TP 2 at stage 3 equal to stage 2 bit for bit through
  the kernels (four gloo ranks on the card); streamed parameter offload
  (``cpu_offload_params``) through the flash kernels: its loss bit for
  bit the segments on one device copy of the host parameters, 3 steps
  and eval within 2e-4 of the classic offload engine, the flash forward
  twice a layer a step and the device Adam never.
* checkpoints: a tiny bf16 ZeRO-2 GPT-2 saved after 2 steps (sync, and
  async with fp32 moments) and resumed by a fresh engine takes the same
  next 2 steps bit for bit (losses, master, moments); under
  ``remat_policy="dots"`` it trains bit for bit as under "full".
* LAMB (stage-1 and apply kernels): against the plain versions over
  aligned and misaligned segment tables, fp32 and bf16 moments, m, v and
  the trust ratios bit for bit, p within one ulp, repeated runs
  bit-identical; refusals.
* the 3D flash API ((b * h, s, d), any s) against its CPU run; the fp32
  key-mask op repeated over 8 seeds with each error printed.
* BERT: a tiny fp32 BERT with a padded mask trained with LAMB through the
  kernels and through the plain versions, losses within 1e-5 relative.
* block-sparse attention (forward, dq and dk/dv kernels): each against
  its plain version over blocks 16-128, d_head 32/64/128,
  fp32/bf16/fp16, shared and per-head layouts of every mode, causal and
  not, key-padding and score biases, an empty query block; repeated runs
  bit-identical; the bf16 dq and dk/dv kernels over the long transposed
  walks of global columns, held to the plain versions and bit-identical
  run to run; refusals; and a tiny fp32 GPT-2 with the ds_config
  sparse section trained through the kernels and through the plain
  versions, losses within 1e-5 relative.
* ring GEMMs (the all-gather-matmul, matmul-reduce-scatter and dW
  gather-contract step kernels): each against its plain version over
  ragged shapes, fp32 and bf16, plain and transposed weights, ring blocks
  1-4; the reduce-scatter step in place; the bf16 reduce-scatter kernel
  at the TP 2 sites' (K, weight layout) pairs with and without what
  arrived, in place, into a misaligned output and twice bit for bit; the
  dW sum over every ring step; refusals (device, dtype, strides, shapes).
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference)
from deepspeed_tpu_torch.utils.monitor import ServingMetrics

pytestmark = pytest.mark.torch_port

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # fp32 references in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _paged_case(device, dtype, dh, ps, s, b=5, h=3, layers=2, max_pages=12,
                seed=0, lives=None, poison_tail=False):
    """Slots at lengths spread over the whole page-table window (crossing
    page boundaries), their pages scattered over the pool, NaN in page 0
    and every unallocated page; with s > 1 the valid lengths are padded.
    ``lives`` instead gives each slot's live key count (its last real
    query at key lives - 1); ``poison_tail`` puts NaN in every row after
    a slot's last live key in its last page."""
    rng = np.random.RandomState(seed)
    usable = b * max_pages + 3
    positions = np.linspace(0, max_pages * ps - s, b).round().astype(np.int32)
    valid_lens = np.full(b, s, np.int32)
    if s > 1:
        valid_lens = rng.randint(1, s + 1, size=b).astype(np.int32)
    if lives is not None:
        lives = np.asarray(lives, np.int64)
        b = len(lives)
        valid_lens = np.ones(b, np.int32)
        if s > 1:
            valid_lens = rng.randint(1, s + 1, size=b).clip(
                max=lives).astype(np.int32)
        positions = (lives - valid_lens).astype(np.int32)
    page_tables = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, usable + 1)))
    for i in range(b):
        need = min(max_pages, -(-(int(positions[i]) + s) // ps))
        page_tables[i, :need] = [free.pop() for _ in range(need)]
    shape = (usable + 1, layers, h, ps, dh)
    k_pool = rng.randn(*shape).astype(np.float32)
    v_pool = rng.randn(*shape).astype(np.float32)
    dead = np.ones(usable + 1, bool)
    dead[page_tables[page_tables > 0]] = False
    k_pool[dead] = v_pool[dead] = np.nan
    if poison_tail:
        for i in range(b):
            last = int(positions[i]) + int(valid_lens[i]) - 1
            page = page_tables[i, last // ps]
            k_pool[page, :, :, last % ps + 1:] = np.nan
            v_pool[page, :, :, last % ps + 1:] = np.nan
    q = rng.randn(b, s, h, dh).astype(np.float32)
    to = lambda a, t=dtype: torch.from_numpy(a).to(device=device, dtype=t)
    return (to(q), to(k_pool), to(v_pool), to(page_tables, torch.int32),
            to(positions, torch.int32), to(valid_lens, torch.int32)), \
        valid_lens


@pytest.mark.parametrize("dtype,dh,ps,s", [
    (torch.float32, 64, 16, 1),
    (torch.bfloat16, 64, 16, 1),
    (torch.float16, 64, 16, 4),
    (torch.bfloat16, 128, 8, 3),
    (torch.float32, 32, 4, 5),
    (torch.bfloat16, 256, 32, 2),
    (torch.float16, 16, 16, 1),
])
def test_paged_attention_kernel_matches_plain_version(cuda, dtype, dh, ps, s):
    args, valid_lens = _paged_case(cuda, dtype, dh, ps, s)
    for layer in (0, 1):
        before = paged_attention.launches
        got = paged_attention(*args, layer_idx=layer, page_size=ps)
        assert paged_attention.launches == before + 1
        want = paged_attention_reference(*args, layer_idx=layer, page_size=ps)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == args[0].shape
        for i, n in enumerate(valid_lens):      # padded queries excluded
            g, w = got[i, :n], want[i, :n]
            assert torch.isfinite(g).all(), (i, layer)
            err = float((g - w).abs().max())
            assert err <= ATOL, (i, layer, err)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("dtype,dh,ps", [
    (torch.bfloat16, 64, 16),
    (torch.float32, 128, 8),
    (torch.float16, 32, 4),
    (torch.float32, 256, 32),
])
def test_paged_attention_split_edges(cuda, dtype, dh, ps, s):
    """Live lengths at the edges of the kernel's splits: one key, exactly
    one split's run, one run plus one key, two runs less one, the full
    page table; NaN in every row after each slot's last live key; with s
    > 1 padded valid lengths. Each against the plain version (real query
    rows, 2e-5), three runs bit for bit."""
    from deepspeed_tpu_torch.ops.paged_attention.paged_attention import \
        launch_plan
    max_pages = 1024 // ps
    table = max_pages * ps
    elem = torch.tensor([], dtype=dtype).element_size()
    chunk, rounds, splits = launch_plan(elem, dh, table)
    run = chunk * rounds
    assert splits > 1
    lives = [1, run, run + 1, 2 * run - 1, table, min(3, table)]
    args, valid_lens = _paged_case(cuda, dtype, dh, ps, s, max_pages=max_pages,
                                   lives=lives, poison_tail=True)
    runs = [paged_attention(*args, layer_idx=1, page_size=ps)
            for _ in range(3)]
    want = paged_attention_reference(*args, layer_idx=1, page_size=ps)
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert torch.equal(runs[0], other)
    for i, n in enumerate(valid_lens):
        g, w = runs[0][i, :n], want[i, :n]
        assert torch.isfinite(g).all(), (i, lives[i])
        err = float((g - w).abs().max())
        assert err <= ATOL, (i, lives[i], err)


@pytest.mark.parametrize("bad", ["head_width", "device"])
def test_paged_attention_kernel_refuses_what_it_cannot_take(cuda, bad):
    if bad == "head_width":      # bf16 rows must be whole 16-byte vectors
        args, _ = _paged_case(cuda, torch.bfloat16, 12, 8, 1)
        match = "d_head"
    else:
        args, _ = _paged_case(cuda, torch.float32, 32, 8, 1)
        args = (args[0].cpu(),) + args[1:]
        match = "is on"
    before = paged_attention.launches
    with pytest.raises(ValueError, match=match):
        paged_attention(*args, layer_idx=0, page_size=8)
    assert paged_attention.launches == before


def test_engine_paged_kernel_streams_equal_slot_streams(cuda):
    cfg = gpt2.GPT2Config(vocab_size=256, max_seq_len=128, n_layers=2,
                          n_heads=2, d_model=64)
    model = gpt2.make_gpt2_model(config=cfg, seed=3)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (3, 17, 40, 9)]
    base = {"max_batch_size": 3, "prefill_buckets": [16, 32, 64],
            "dtype": "fp32", "greedy": True, "max_new_tokens": 20}
    slot = deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": base})
    paged = deepspeed_tpu_torch.init_inference(model=model, config={
        "inference": dict(base, kv_layout="paged", kv_block_size=8)})
    assert paged.device.type == "cuda"
    assert paged.paged_attention_kernel == "pallas"      # "auto" on CUDA
    want = slot.generate(prompts)
    metrics = ServingMetrics()
    paged_attention.launches = 0
    got = paged.generate(prompts, metrics=metrics)
    assert got == want
    assert paged_attention.launches == metrics.decode_steps * cfg.n_layers
    assert paged.allocator.pages_in_use == 0


@pytest.mark.parametrize("method", ["ngram", "model"])
def test_engine_speculative_streams_equal_plain_streams(cuda, method):
    """Speculative serving on the card, k 3 (the paged kernel at s = 4 in
    every verify step): the greedy streams of plain paged decode, one
    launch a layer a model step; the target drafting for itself accepts
    every draft."""
    cfg = gpt2.GPT2Config(vocab_size=256, max_seq_len=128, n_layers=2,
                          n_heads=2, d_model=64)
    model = gpt2.make_gpt2_model(config=cfg, seed=3)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (3, 17, 40, 9)]
    base = {"max_batch_size": 3, "prefill_buckets": [16, 32, 64],
            "dtype": "fp32", "greedy": True, "max_new_tokens": 20,
            "kv_layout": "paged", "kv_block_size": 8}
    plain = deepspeed_tpu_torch.init_inference(model=model, config={
        "inference": base})
    spec = deepspeed_tpu_torch.init_inference(
        model=model, draft_model=model if method == "model" else None,
        config={"inference": dict(base, speculative={
            "enabled": True, "method": method, "num_draft_tokens": 3})})
    assert spec.paged_attention_kernel == "pallas"
    want = plain.generate(prompts)
    metrics = ServingMetrics()
    paged_attention.launches = 0
    assert spec.generate(prompts, metrics=metrics) == want
    assert paged_attention.launches == metrics.decode_steps * cfg.n_layers
    assert metrics.spec_proposed > 0
    if method == "model":
        assert metrics.spec_acceptance_rate == 1.0


def test_engine_tp2_streams_equal_tp1_streams(cuda):
    """Tensor-parallel serving on the card: two gloo ranks sharing it
    (``tests/torch_tp_workers.py::tp_serve``), each with one of the two
    heads in its paged pool, read through the kernel, with and without
    n-gram speculation: both ranks give the TP 1 stream, one launch a
    layer a model step on each."""
    import torch_tp_workers as workers
    from deepspeed_tpu_torch.utils.distributed import spawn
    tiny = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
                d_model=64)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (3, 17, 40, 9)]
    base = {"max_batch_size": 3, "prefill_buckets": [16, 32, 64],
            "dtype": "fp32", "greedy": True, "kv_layout": "paged",
            "kv_block_size": 8}
    configs = [base, dict(base, speculative={
        "enabled": True, "method": "ngram", "num_draft_tokens": 3})]
    specs = [dict(model=tiny, inference=c, prompts=prompts, max_new=16,
                  device="cuda") for c in configs]
    ranks = spawn(workers.tp_serve, 2, args=(specs,), timeout_s=600)
    model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(**tiny), seed=0)
    for i, inference in enumerate(configs):
        want = deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": inference}).generate(
                prompts, max_new_tokens=16)
        for r in ranks:
            got = r[i]
            assert got["device"].startswith("cuda")
            assert got["kernel"] == "pallas" and got["pool_shape"][2] == 1
            assert got["streams"] == want
            assert got["launches"] == got["decode_steps"] * 2


# ------------------------------------------------------ flash attention


def _flash_case(device, dtype, b, s, h, d, seed=0, strided=True,
                bias=False):
    """q, k, v as column blocks of one (b, s, 3 * h * d) tensor (the QKV
    projection's layout) or as separate contiguous tensors; dout; and an
    optional key bias that drops some keys (-1e9) and shifts others."""
    rng = np.random.RandomState(seed)
    to = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    hd = h * d
    if strided:
        qkv = to(rng.randn(b, s, 3 * hd).astype(np.float32))
        q, k, v = qkv.split(hd, dim=-1)
    else:
        q, k, v = (to(rng.randn(b, s, hd).astype(np.float32))
                   for _ in range(3))
    dout = to(rng.randn(b, s, hd).astype(np.float32))
    key_bias = None
    if bias:
        kb = rng.randn(b, s).astype(np.float32)
        kb[rng.rand(b, s) < 0.2] = -1e9
        kb[:, 0] = 0.0                     # every row keeps a live key
        key_bias = torch.from_numpy(kb).to(device)
    return q, k, v, dout, key_bias


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max().clamp_min(1e-30))


def _ulp_ratio(got, want, atol):
    """max over elements of |got - want| / (eps |want| + atol), eps the
    machine epsilon of ``want``'s dtype (one ulp of the plain value): at
    most 1 when every element is within the bound."""
    eps = torch.finfo(want.dtype).eps
    want = want.float()
    return float(((got.float() - want).abs() /
                  (eps * want.abs() + atol)).max())


@pytest.mark.parametrize("dtype,d,s,causal,bias,strided", [
    (torch.float32, 64, 128, True, False, True),
    (torch.bfloat16, 64, 200, True, False, True),
    (torch.bfloat16, 32, 80, False, True, True),
    (torch.float32, 128, 130, True, True, False),
    (torch.bfloat16, 128, 256, False, False, True),
    (torch.float16, 64, 67, True, True, False),
    (torch.float32, 32, 64, False, False, True),
])
def test_flash_kernels_match_plain_versions(cuda, dtype, d, s, causal, bias,
                                            strided):
    """fp32: out within 1e-5 absolute, dq, dk, dv within 1e-5 of their
    largest magnitude. bf16/fp16, per element: out within one ulp of the
    plain value plus eps / 4 (one ulp at |out| in [0.25, 0.5)), dq, dk, dv
    within one ulp plus 1e-6. lse within 1e-4. Both sides round p and ds
    at the same points, only sums reorder."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, h = 2, 3
    q, k, v, dout, kb = _flash_case(cuda, dtype, b, s, h, d, strided=strided,
                                    bias=bias)
    kw = dict(num_heads=h, causal=causal)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches,
              fa.flash_bwd_dq.launches)
    out, lse = fa.flash_fwd(q, k, v, kb, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, kb, **kw)
    delta = fa.attention_delta(out, dout, h)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, kb, dout, lse, delta, **kw)
    dq = fa.flash_bwd_dq(q, k, v, kb, dout, lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(q, k, v, kb, dout, lse,
                                                 delta, **kw)
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, kb, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches,
            fa.flash_bwd_dq.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    grads = (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))
    for name, got, want in grads:
        assert torch.isfinite(got.float()).all(), name
    if dtype == torch.float32:
        assert float((out - ref_out).abs().max()) <= 1e-5
        for name, got, want in grads:
            assert _rel_err(got, want) <= 1e-5, (name, _rel_err(got, want))
        return
    eps = torch.finfo(dtype).eps
    assert _ulp_ratio(out, ref_out, eps / 4) <= 1.0, \
        _ulp_ratio(out, ref_out, eps / 4)
    for name, got, want in grads:
        assert _ulp_ratio(got, want, 1e-6) <= 1.0, \
            (name, _ulp_ratio(got, want, 1e-6))


def test_flash_backward_writes_into_the_qkv_gradient_views(cuda):
    """dq/dk/dv land in the column blocks of one (b, s, 3 * h * d) buffer,
    equal to the kernels' own fresh outputs; dq is deterministic."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    q, k, v, dout, _ = _flash_case(cuda, torch.bfloat16, 2, 192, 4, 64)
    out, lse = fa.flash_fwd(q, k, v, num_heads=4)
    fresh = fa.flash_bwd(q, k, v, None, out, dout, lse, num_heads=4)
    dqkv = torch.empty((2, 192, 3 * 256), dtype=torch.bfloat16, device=cuda)
    views = dqkv.split(256, dim=-1)
    fa.flash_bwd(q, k, v, None, out, dout, lse, num_heads=4, dq=views[0],
                 dk=views[1], dv=views[2])
    for got, want in zip(views, fresh):
        assert torch.equal(got, want)


def test_flash_kernels_are_deterministic(cuda):
    """No atomics: repeated forward and backward runs on the same inputs
    are bit-identical, fp32 with a key bias and bf16 causal."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    for dtype, causal, bias in ((torch.float32, False, True),
                                (torch.bfloat16, True, False)):
        q, k, v, dout, kb = _flash_case(cuda, dtype, 2, 200, 4, 64,
                                        bias=bias)
        kw = dict(num_heads=4, causal=causal)
        runs = []
        for _ in range(20):
            out, lse = fa.flash_fwd(q, k, v, kb, **kw)
            runs.append((out, lse) + fa.flash_bwd(q, k, v, kb, out, dout,
                                                  lse, **kw))
        torch.cuda.synchronize()
        for run in runs[1:]:
            for got, want in zip(run, runs[0]):
                assert torch.equal(got, want), dtype


@pytest.mark.parametrize("causal,bias", [(True, False), (True, True),
                                         (False, False), (False, True)])
@pytest.mark.parametrize("s", [96, 1000, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_tensor_core_backward_matches_plain_versions(cuda, d, s,
                                                           causal, bias):
    """The bf16 backward kernels (mma.sync on the tensor cores, P and dS
    rounded to bf16 at the plain versions' points and bits) against the
    plain versions: dq, dk, dv per element within one ulp of the plain
    value plus 1e-6 (FLASH_TOL in chip_smoke.py); s need not be a multiple
    of the 64-row tiles; a second run bit-identical. (fp16 at the same
    bound: test_flash_fp16_backward_matches_plain_versions.)"""
    dtype = torch.bfloat16
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, h = 1, 2
    q, k, v, dout, kb = _flash_case(cuda, dtype, b, s, h, d, seed=s + d,
                                    bias=bias)
    kw = dict(num_heads=h, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, kb, **kw)
    delta = fa.attention_delta(out, dout, h)
    args = (q, k, v, kb, dout, lse, delta)
    counts = (fa.flash_bwd_dkdv.launches, fa.flash_bwd_dq.launches)
    runs = [fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
            for _ in range(2)]
    want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
        (fa.flash_bwd_dq_reference(*args, **kw),)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkdv.launches, fa.flash_bwd_dq.launches) == \
        (counts[0] + 2, counts[1] + 2)
    for name, got, again, ref in zip(("dk", "dv", "dq"), runs[0], runs[1],
                                     want):
        assert torch.isfinite(got.float()).all(), name
        assert torch.equal(got, again), name
        assert _ulp_ratio(got, ref, 1e-6) <= 1.0, \
            (name, _ulp_ratio(got, ref, 1e-6))


def test_flash_tensor_core_backward_is_bit_stable_over_repeats(cuda):
    """20 runs of the bf16 backward kernels at a ragged length with a key
    bias, causal and not: the same bits every time (no atomics; each
    warp owns its rows)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    q, k, v, dout, kb = _flash_case(cuda, torch.bfloat16, 2, 1000, 4, 64,
                                    bias=True)
    for causal in (True, False):
        kw = dict(num_heads=4, causal=causal)
        out, lse = fa.flash_fwd(q, k, v, kb, **kw)
        delta = fa.attention_delta(out, dout, 4)
        args = (q, k, v, kb, dout, lse, delta)
        runs = [fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args,
                                                                 **kw),)
                for _ in range(20)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            for got, want in zip(run, runs[0]):
                assert torch.equal(got, want), causal


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [96, 1000])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_fp16_backward_matches_plain_versions(cuda, d, s, causal):
    """The fp16 backward (tensor-core kernels; P and dS at the plain
    versions' bits through fp16's own rounding edges) at the cases of
    probes/kernel_probe.py fp16_backward: b 2, h 3, a key bias dropping 20%
    of keys. dq, dk, dv per element within one fp16 ulp of the plain value
    plus 1e-6; a second run bit-identical."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, h, dtype = 2, 3, torch.float16
    q, k, v, dout, kb = _flash_case(cuda, dtype, b, s, h, d, seed=s + d,
                                    bias=True)
    kw = dict(num_heads=h, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, kb, **kw)
    delta = fa.attention_delta(out, dout, h)
    args = (q, k, v, kb, dout, lse, delta)
    runs = [fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
            for _ in range(2)]
    want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
        (fa.flash_bwd_dq_reference(*args, **kw),)
    torch.cuda.synchronize()
    for name, got, again, ref in zip(("dk", "dv", "dq"), runs[0], runs[1],
                                     want):
        assert torch.isfinite(got.float()).all(), name
        assert torch.equal(got, again), name
        assert _ulp_ratio(got, ref, 1e-6) <= 1.0, \
            (name, _ulp_ratio(got, ref, 1e-6))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fp16_backward_in_the_subnormal_range(cuda, causal):
    """fp16 with q and k scaled by 3 (scores spread ~9 wide at d 64), so
    that many P = exp(x) and dS fall into fp16's subnormal range (below
    2**-14, spacing 2**-24) and below its rounding to 0 (2**-25): the
    backward still within one fp16 ulp of the plain value plus 1e-6, the
    forward within one ulp plus eps / 4 and lse within 1e-4."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, s, h, d, dtype = 2, 333, 2, 64, torch.float16
    q, k, v, dout, kb = _flash_case(cuda, dtype, b, s, h, d, seed=11,
                                    bias=True)
    q.mul_(3)       # in place: q, k, v stay column blocks of one tensor
    k.mul_(3)
    kw = dict(num_heads=h, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, kb, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, kb, **kw)
    delta = fa.attention_delta(out, dout, h)
    args = (q, k, v, kb, dout, lse, delta)
    got = fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
    want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
        (fa.flash_bwd_dq_reference(*args, **kw),)
    _, _, _, p, ds = fa._bwd_terms(q, k, v, kb, dout, lse, delta, h, causal,
                                   d ** -0.5)
    torch.cuda.synchronize()
    sub = lambda t: int(((t.float().abs() > 0) &
                         (t.float().abs() < 2 ** -14)).sum())
    tiny = int(((p > 0) & (p < 2 ** -25)).sum())
    assert min(sub(p.half()), sub(ds), tiny) >= 1000, \
        (sub(p.half()), sub(ds), tiny)
    eps = torch.finfo(dtype).eps
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    assert _ulp_ratio(out, ref_out, eps / 4) <= 1.0
    for name, g, w in zip(("dk", "dv", "dq"), got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _ulp_ratio(g, w, 1e-6) <= 1.0, (name, _ulp_ratio(g, w, 1e-6))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tensor_core_forward_matches_plain_version(cuda, dtype, d,
                                                         bias):
    """The forward on the tensor cores (P at the plain version's bits,
    its running max taken exactly) against flash_fwd_reference, causal and
    not, s not a multiple of the 64-row tiles, q/k/v strided column blocks
    of one QKV tensor: out per element within one ulp of the plain value
    plus eps / 4 (FLASH_TOL's 2**-9 at bf16), lse within 1e-4, and one
    launch a call."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    b, h = 2, 3
    for s, causal in ((200, True), (1000, False), (77, False), (130, True)):
        q, k, v, _, kb = _flash_case(cuda, dtype, b, s, h, d, seed=s + d,
                                     bias=bias)
        kw = dict(num_heads=h, causal=causal)
        before = fa.flash_fwd.launches
        out, lse = fa.flash_fwd(q, k, v, kb, **kw)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, kb, **kw)
        torch.cuda.synchronize()
        assert fa.flash_fwd.launches == before + 1
        assert torch.isfinite(out.float()).all() and \
            torch.isfinite(lse).all()
        assert float((lse - ref_lse).abs().max()) <= 1e-4, (s, causal)
        eps = torch.finfo(dtype).eps
        assert _ulp_ratio(out, ref_out, eps / 4) <= 1.0, \
            (s, causal, _ulp_ratio(out, ref_out, eps / 4))


def test_flash_tensor_core_forward_is_bit_stable_over_repeats(cuda):
    """20 runs of the forward at a ragged length with a key bias, bf16 and
    fp16, causal and not: out and lse the same bits every time."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, _, kb = _flash_case(cuda, dtype, 2, 1000, 4, 64, bias=True)
        for causal in (True, False):
            runs = [fa.flash_fwd(q, k, v, kb, num_heads=4, causal=causal)
                    for _ in range(20)]
            torch.cuda.synchronize()
            for out, lse in runs[1:]:
                assert torch.equal(out, runs[0][0]), (dtype, causal)
                assert torch.equal(lse, runs[0][1]), (dtype, causal)


@pytest.mark.parametrize("bad", ["d_head", "strides", "device"])
def test_flash_kernel_refuses_what_it_cannot_take(cuda, bad):
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    if bad == "d_head":
        q, k, v, _, _ = _flash_case(cuda, torch.bfloat16, 1, 64, 2, 48)
        match, h = "d_head", 2
    elif bad == "strides":
        q, k, v, _, _ = _flash_case(cuda, torch.bfloat16, 1, 64, 2, 64)
        k, match, h = k.contiguous(), "stride", 2
    else:
        q, k, v, _, _ = _flash_case(cuda, torch.float32, 1, 64, 2, 64)
        k, match, h = k.cpu(), "is", 2
    before = fa.flash_fwd.launches
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(q, k, v, num_heads=h)
    assert fa.flash_fwd.launches == before


def _online_float64(arrays, mask, block=64):
    """The plain forward's online softmax over key tiles of ``block`` in
    float64 (non-causal, the key bias added): per tile S, P, the running
    row sums l and the running P.V, as ``flash_fwd_reference`` traces them
    in fp32."""
    q, k, v = (np.transpose(a.astype(np.float64), (0, 2, 1, 3))
               for a in arrays[:3])
    b, h, s, d = q.shape
    bias = mask.astype(np.float64)[:, None, None, :]
    m = np.full((b, h, s, 1), -1e30)
    l = np.zeros((b, h, s, 1))
    acc = np.zeros((b, h, s, d))
    tiles = []
    for k0 in range(0, s, block):
        sc = q @ np.swapaxes(k[:, :, k0:k0 + block], -1, -2) / np.sqrt(d) + \
            bias[..., k0:k0 + block]
        m_new = np.maximum(m, sc.max(-1, keepdims=True))
        p = np.exp(sc - m_new)
        corr = np.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdims=True)
        acc = acc * corr + p @ v[:, :, k0:k0 + block]
        m = m_new
        tiles.append({"S": sc, "P": p, "l": l, "PV": acc})
    return tiles


def _cpu_intermediates(trace, exact):
    """Each traced op's largest |fp32 - float64| over the key tiles of the
    CPU run (S over the unmasked keys: a masked score is -1e9 in both)."""
    errs = {}
    for op in ("S", "P", "l", "PV"):
        worst = 0.0
        for tile, want in zip(trace, exact):
            diff = np.abs(tile[op].double().numpy() - want[op])
            if op == "S":
                diff = np.where(want[op] > -1e8, diff, 0.0)
            worst = max(worst, float(diff.max()))
        errs[op] = worst
    return errs


def test_flash_attention_bshd_mask_bias_grads_match_plain(cuda):
    """The (b, s, h, d) op with a key-padding mask through the kernels
    against the same op on CPU copies (the plain versions), fp32. A failure
    message carries ``cpu_intermediates``: the CPU forward's S, P, l and
    P.V against float64, so it names the operation that moved."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import flash_attention_bshd
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 96, 2, 32
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    mask = np.where(rng.rand(b, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    results, trace = [], []
    plain = fa.flash_fwd_reference
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays[:3])
        if dev.type == "cpu":
            fa.flash_fwd_reference = \
                lambda *a, **kw: plain(*a, trace=trace, **kw)
        try:
            out = flash_attention_bshd(
                q, k, v, causal=False,
                mask_bias=torch.from_numpy(mask).to(dev))
        finally:
            fa.flash_fwd_reference = plain
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        results.append([t.detach().cpu() for t in (out, q.grad, k.grad,
                                                  v.grad)])
    cpu_intermediates = _cpu_intermediates(trace, _online_float64(arrays,
                                                                  mask))
    for name, got, want in zip(("out", "dq", "dk", "dv"), *results):
        assert _rel_err(got, want) <= 1e-5, (
            name, _rel_err(got, want),
            {"cpu_intermediates": cpu_intermediates})


def test_flash_attention_bshd_mask_bias_bit_stable_over_repeats(cuda):
    """The case of test_flash_attention_bshd_mask_bias_grads_match_plain
    run 50 times through the kernels: every run bit-identical to the
    first, and each held to the CPU run at the same 1e-5 (run with -s to
    print the worst element of each output and both sides' values)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention_bshd
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 96, 2, 32
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    mask = np.where(rng.rand(b, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0

    def run(dev):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays[:3])
        out = flash_attention_bshd(q, k, v, causal=False,
                                   mask_bias=torch.from_numpy(mask).to(dev))
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    want = run(torch.device("cpu"))
    runs = [run(cuda) for _ in range(50)]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        errs = [_rel_err(r[i], want[i]) for r in runs]
        worst = max(range(len(runs)), key=errs.__getitem__)
        diff = (runs[worst][i] - want[i]).abs()
        at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        print("repeats {}: worst run {} rel {} at {}: gpu {} cpu {}".format(
            name, worst, errs[worst], at, float(runs[worst][i][at]),
            float(want[i][at])))
        assert all(torch.equal(r[i], runs[0][i]) for r in runs), name
        assert max(errs) <= 1e-5, (name, max(errs))


# ------------------------------------------------------------------ Adam


@pytest.mark.parametrize("n,offset,adam_w", [
    (1, 0, True), (3, 0, False), (4099, 0, True), (4099, 1, False),
    (1 << 20, 3, True), ((1 << 20) + 7, 0, False)])
def test_fused_adam_kernel_matches_plain_version(cuda, n, offset, adam_w):
    """Three steps over odd lengths and misaligned starts (the scalar
    path): equal to the plain version bit for bit, since both round each
    operation once in the same order."""
    from deepspeed_tpu_torch.ops.adam import (bias_corrections, fused_adam,
                                              fused_adam_reference)
    rng = np.random.RandomState(n)
    host = [rng.randn(n + offset).astype(np.float32) for _ in range(2)]
    host.append(np.abs(rng.randn(n + offset)).astype(np.float32))
    sides = []
    for _ in range(2):
        p, m, v = (torch.from_numpy(a.copy()).to(cuda)[offset:]
                   for a in host)
        sides.append([p, m, v])
    before = fused_adam.launches
    for step in (1, 2, 3):
        g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
        bc1, bc2 = bias_corrections(0.9, 0.999, step)
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01, bc1=bc1, bc2=bc2, adam_w_mode=adam_w)
        fused_adam(*sides[0][:1], g, *sides[0][1:], **kw)
        fused_adam_reference(*sides[1][:1], g, *sides[1][1:], **kw)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 3
    for got, want in zip(*sides):
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("n,offset,adam_w", [
    (1, 0, True), (4099, 0, False), (4099, 2, True), (1 << 20, 0, True),
    ((1 << 20) + 7, 1, False)])
def test_fused_adam_bf16_moments_kernel_matches_plain_version(cuda, n,
                                                              offset,
                                                              adam_w):
    """bf16 moments (fp32 math, stored rounded to nearest even), three
    steps over odd lengths and misaligned starts: p, m and v equal to the
    plain version bit for bit."""
    from deepspeed_tpu_torch.ops.adam import (bias_corrections, fused_adam,
                                              fused_adam_reference)
    rng = np.random.RandomState(n + 1)
    host = [rng.randn(n + offset).astype(np.float32),
            rng.randn(n + offset).astype(np.float32) * 1e-2,
            np.abs(rng.randn(n + offset)).astype(np.float32) * 1e-4]
    sides = []
    for _ in range(2):
        p = torch.from_numpy(host[0].copy()).to(cuda)[offset:]
        m, v = (torch.from_numpy(a).to(cuda).bfloat16()[offset:]
                for a in host[1:])
        sides.append([p, m, v])
    before = fused_adam.launches
    for step in (1, 2, 3):
        g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
        bc1, bc2 = bias_corrections(0.9, 0.999, step)
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01, bc1=bc1, bc2=bc2, adam_w_mode=adam_w)
        fused_adam(sides[0][0], g, *sides[0][1:], **kw)
        fused_adam_reference(sides[1][0], g, *sides[1][1:], **kw)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 3
    assert sides[0][1].dtype == torch.bfloat16
    for got, want in zip(*sides):
        assert torch.equal(got, want), float((got.float() -
                                              want.float()).abs().max())


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_fused_adam_steps_one_ranks_range_of_a_buffer(cuda, moments):
    """ZeRO's partitions: the kernel over views of one buffer at a nonzero
    storage offset that is a multiple of the partition alignment (64
    elements; the four-wide path), each rank's range in turn, bit for bit
    the plain version over the same ranges; a range's step leaves the
    other untouched."""
    from deepspeed_tpu_torch.ops.adam import (bias_corrections, fused_adam,
                                              fused_adam_reference)
    from deepspeed_tpu_torch.ops.adam.fused_adam import aligned
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    part = 1000 * ALIGN
    rng = np.random.RandomState(7)
    host = [rng.randn(2 * part).astype(np.float32),
            rng.randn(2 * part).astype(np.float32) * 1e-2,
            np.abs(rng.randn(2 * part)).astype(np.float32) * 1e-4]
    sides = [[torch.from_numpy(host[0].copy()).to(cuda)] +
             [torch.from_numpy(a).to(cuda).to(moments) for a in host[1:]]
             for _ in range(2)]
    before = fused_adam.launches
    for rank in (1, 0):
        lo = rank * part
        g = torch.from_numpy(rng.randn(part).astype(np.float32)).to(cuda)
        bc1, bc2 = bias_corrections(0.9, 0.999, 1)
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01, bc1=bc1, bc2=bc2)
        views = [[t[lo:lo + part] for t in side] for side in sides]
        assert views[0][0].storage_offset() == lo and \
            aligned(views[0] + [g]) == 1
        untouched = [t[part - lo:2 * part - lo].clone() for t in sides[0]]
        fused_adam(views[0][0], g, *views[0][1:], **kw)
        fused_adam_reference(views[1][0], g, *views[1][1:], **kw)
        torch.cuda.synchronize()
        for t, was in zip(sides[0], untouched):
            assert torch.equal(t[part - lo:2 * part - lo], was)
    assert fused_adam.launches == before + 2
    for got, want in zip(*sides):
        assert torch.equal(got, want), float((got.float() -
                                              want.float()).abs().max())


# --------------------------------------------------------------- training


def test_tiny_training_kernels_match_plain_versions(cuda):
    from deepspeed_tpu_torch.ops.adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, remat=True, loss_chunk=32)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, size=(1, 4, 128)).astype(np.int64)
    runs = {}
    for backend in ("pallas", "xla"):
        model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(**cfg), seed=5)
        engine = deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-3, "fused_kernel": backend}},
            "transformer": {"flash_attention": backend}})[0]
        assert engine.device.type == "cuda"
        for fn in (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq,
                   fused_adam):
            fn.launches = 0
        runs[backend] = [float(engine.train_batch(batch=(ids, ids)))
                         for _ in range(3)]
        launches = [fn.launches for fn in (fa.flash_fwd, fa.flash_bwd_dkdv,
                                           fa.flash_bwd_dq, fused_adam)]
        want = [3 * 2] * 3 + [3] if backend == "pallas" else [0] * 4
        assert launches == want, (backend, launches)
    np.testing.assert_allclose(runs["pallas"], runs["xla"], rtol=1e-5)
    assert runs["pallas"][-1] < runs["pallas"][0]


@pytest.mark.parametrize("moments,async_save", [("bf16", False),
                                                 ("fp32", True)])
def test_tiny_training_resumes_bit_for_bit(cuda, tmp_path, moments,
                                           async_save):
    """Checkpoints on the card: a tiny GPT-2 (bf16, ZeRO-2, the flash and
    Adam kernels) saves after 2 steps and takes 2 more; a fresh engine
    from another seed loads the tag and takes the same 2 steps: the
    losses, the fp32 master and both moments equal bit for bit."""
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, remat=True, loss_chunk=32)
    ids = np.random.RandomState(8).randint(0, 256, size=(1, 4, 128))
    conf = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2},
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-3, "fused_kernel": "pallas",
                "moments_dtype": moments}},
            "transformer": {"flash_attention": "pallas"}}

    def engine(seed):
        return deepspeed_tpu_torch.initialize(
            model=gpt2.make_gpt2_model(config=gpt2.GPT2Config(**cfg),
                                       seed=seed), config_params=conf)[0]

    def state(e):
        return [t.detach().clone() for t in (e.flat.master, e.flat.exp_avg,
                                             e.flat.exp_avg_sq)]
    first = engine(5)
    for _ in range(2):
        first.train_batch(batch=(ids, ids))
    first.save_checkpoint(str(tmp_path), async_save=async_save)
    kept = [float(first.train_batch(batch=(ids, ids))) for _ in range(2)]
    first.wait_pending_writes()
    assert ckpt.verify_tag(str(tmp_path), "global_step2")[0]
    second = engine(6)
    assert second.load_checkpoint(str(tmp_path))[0] is not None
    resumed = [float(second.train_batch(batch=(ids, ids))) for _ in range(2)]
    assert resumed == kept
    for a, b in zip(state(second), state(first)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_tiny_training_dots_equals_full(cuda):
    """remat_policy "dots" on the card (the flash and Adam kernels): after
    3 steps from one init the losses and the fp32 master equal "full"'s
    bit for bit."""
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, remat=True, loss_chunk=32)
    ids = np.random.RandomState(9).randint(0, 256, size=(1, 4, 128))
    runs = {}
    for policy in ("full", "dots"):
        model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(
            **cfg, remat_policy=policy), seed=5)
        engine = deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2},
            "optimizer": {"type": "Adam", "params": {
                "lr": 1e-3, "fused_kernel": "pallas"}},
            "transformer": {"flash_attention": "pallas"}})[0]
        runs[policy] = ([float(engine.train_batch(batch=(ids, ids)))
                         for _ in range(3)], engine.flat.master.clone())
    assert runs["dots"][0] == runs["full"][0]
    assert torch.equal(runs["dots"][1], runs["full"][1])


def test_dp2_training_kernels_match_plain_versions(cuda):
    """ZeRO data parallelism on the card: two gloo ranks sharing it
    (``tests/torch_dp_workers.py``), a tiny GPT-2 on each rank's rows of
    one global batch, with the kernels and with the plain versions, for
    Adam with fp32 and bf16 moments and LAMB with bf16 moments: at fp32
    (stage 0) the losses within 1e-5 relative, at bf16 with ZeRO-2 (the
    optimizer over each rank's half of the buffers, LAMB's trust ratios
    from the data group's sums) within 5e-4; both ranks report the same
    losses; with the kernels each flash kernel launches once a layer a
    step and the optimizer's once a step, with the plain versions none."""
    import torch_dp_workers as workers
    from deepspeed_tpu_torch.utils.distributed import spawn
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, remat=True, loss_chunk=32)
    ids = np.random.RandomState(6).randint(0, 256, size=(1, 8, 128))
    cases = [(prec, stage, opt, moments)
             for prec, stage in (("fp32", 0), ("bf16", 2))
             for opt, moments in (("Adam", "fp32"), ("Adam", "bf16"),
                                  ("Lamb", "bf16"))]
    specs = [dict(model=cfg, seed=5, data=2, prec=prec, stage=stage,
                  micro=4, batch=(ids, ids), steps=3, optimizer=opt,
                  moments=moments, backend=backend, device="cuda")
             for prec, stage, opt, moments in cases
             for backend in ("pallas", "xla")]
    ranks = spawn(workers.dp_engine, 2, args=(specs,), timeout_s=600)
    for i, (prec, stage, opt, moments) in enumerate(cases):
        kern, plain = (r[2 * i] for r in ranks), (r[2 * i + 1] for r in ranks)
        for k, p in zip(kern, plain):
            assert k["device"].startswith("cuda") and k["views"]
            np.testing.assert_allclose(k["losses"], p["losses"],
                                       rtol=1e-5 if prec == "fp32" else 5e-4)
            assert k["losses"][-1] < k["losses"][0]
            assert k["losses"] == ranks[0][2 * i]["losses"]
            opt_kernel = "fused_lamb" if opt == "Lamb" else "fused_adam"
            assert k["launches"]["flash_fwd"] == 2 * 3, k["launches"]
            assert k["launches"][opt_kernel] == 3, k["launches"]
            assert not any(p["launches"].values()), p["launches"]
            assert k["adam_numel"] * (2 if stage else 1) == k["numel"]


def test_zero3_tp_equals_stage2_on_the_card(cuda):
    """ZeRO stage 3 under tensor parallelism on the card: DP 2 x TP 2, four
    gloo ranks sharing it (``tests/torch_zero3_workers.py``), a tiny bf16
    GPT-2 through the flash, ring and Adam kernels: stage 3 (every block
    partitioned over the data group, the units holding each rank's TP
    shards) equals stage 2 bit for bit, losses and gathered masters; the
    flash forward launches twice as often (each unit's recompute), the
    backward kernels and Adam as often."""
    import torch_zero3_workers as workers
    from deepspeed_tpu_torch.utils.distributed import spawn
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, remat=False, loss_chunk=32)
    ids = np.random.RandomState(6).randint(0, 256, size=(1, 8, 128))
    base = dict(model=cfg, seed=5, data=2, tp=2, micro=4, batch=(ids, ids),
                steps=3, backend="pallas", device="cuda")
    specs = [dict(base, zero={"stage": 3,
                              "stage3_param_persistence_threshold": 1000}),
             dict(base, zero={"stage": 2})]
    ranks = spawn(workers.zero_engine, 4, args=(specs,), timeout_s=600)
    for s3, s2 in ranks:
        assert s3["losses"] == s2["losses"] and s3["gathers"] > 0
        for (_, a), (_, b) in zip(sorted(_np_leaves(s3["master"])),
                                  sorted(_np_leaves(s2["master"]))):
            assert np.array_equal(a, b)
        k3, k2 = s3["launches"], s2["launches"]
        assert k3["flash_fwd"] == 2 * k2["flash_fwd"] == 2 * 2 * 3, k3
        for name in ("flash_bwd_dkdv", "flash_bwd_dq", "fused_adam"):
            assert k3[name] == k2[name] > 0, (name, k3, k2)
        assert k3["ring_ag_gemm"] > k2["ring_ag_gemm"] > 0, (k3, k2)


def _np_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in tree:
            yield from _np_leaves(tree[key], prefix + str(key) + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _np_leaves(child, prefix + str(i) + ".")
    else:
        yield prefix, np.asarray(tree, np.float32)


def test_streamed_offload_kernels_on_the_card(cuda):
    """Streamed parameter offload on the card: a tiny bf16 GPT-2 (4
    layers, one block a group) with the flash kernels, its parameters in
    pinned host memory and uploaded a group at a time on a side stream:
    the first loss equal, bit for bit, to the segments run on one device
    copy of the host parameters; 3 steps and eval within 2e-4 relative of
    the classic stage 3 + offload engine; the flash forward twice a layer
    a step (the group's recompute), dk/dv and dq once, the device Adam
    never; the parameters hold no device memory between steps."""
    from deepspeed_tpu_torch.ops.adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=4, n_heads=2,
               d_model=128, remat=True, loss_chunk=32)
    d, v, s = 128, 256, 128
    budget = v * d + s * d + 2 * (12 * d * d + 13 * d)
    ids = np.random.RandomState(4).randint(0, 256, size=(1, 4, 128))

    def engine(streamed):
        zero = {"stage": 3, "cpu_offload": True}
        if streamed:
            zero.update(cpu_offload_params=True,
                        stage3_max_live_parameters=budget)
        model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(**cfg), seed=5)
        return deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
            "zero_optimization": zero,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "transformer": {"flash_attention": "pallas"}})[0]

    streamed = engine(True)
    runner = streamed.stream_runner
    assert streamed.device.type == "cuda" and len(runner.groups) == 4
    assert all(p.numel() == 0 for p in streamed.module.parameters())
    flat = streamed.flat
    assert flat.params.is_pinned()
    dev = flat.params.to(cuda)
    tree = {n: dev[o:o + int(np.prod(sh))].view(sh) for n, o, sh in
            zip(flat.names, flat.offsets, flat.shapes)}
    spec = streamed.module.stream_spec
    x_ids = torch.as_tensor(ids[0], device=cuda)
    with torch.no_grad():
        e, blocks, h = spec.split(tree)
        x = spec.embed_apply(e, (x_ids, x_ids), None, True)
        for bt in blocks:
            x = spec.block_apply(bt, x, None, True)
    with torch.enable_grad():
        ref = float(spec.head_apply(h, x, (x_ids, x_ids), None, True))
    kernels = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam)
    for fn in kernels:
        fn.launches = 0
    losses = [float(streamed.train_batch(batch=(ids, ids)))
              for _ in range(3)]
    assert [fn.launches for fn in kernels] == [2 * 4 * 3, 4 * 3, 4 * 3, 0]
    assert losses[0] == ref
    streamed.eval()
    ev = float(streamed(x_ids, x_ids))
    classic = engine(False)
    want = [float(classic.train_batch(batch=(ids, ids))) for _ in range(3)]
    classic.eval()
    np.testing.assert_allclose(losses, want, rtol=2e-4)
    np.testing.assert_allclose(ev, float(classic(x_ids, x_ids)), rtol=2e-4)


# ----------------------------------------------- block-sparse attention


def _sparse_case(device, dtype, section, h, s, d, seed=0, kpm=False,
                 bias=False, empty_row=True):
    """A layout from a ds_config section (one query block emptied), q/k/v
    as the (b, h, s, d) views of one (b, s, 3 * h * d) tensor, dout, and
    optional key-padding and score biases."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        block_sparse_attention as bsa, sparsity_config_from_dict)
    cfg = sparsity_config_from_dict(dict(section), h)
    layout = cfg.make_layout(s)
    if empty_row:
        layout[:, 1] = 0
    tables = bsa.LayoutTables(layout, cfg.block)
    rng = np.random.RandomState(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    b = 2
    qkv = to(rng.randn(b, s, 3 * h * d)).to(dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    dout = to(rng.randn(b, h, s, d)).to(dtype)
    kpm_t = bias_t = None
    if kpm:
        a = rng.randn(b, s)
        a[rng.rand(b, s) < 0.2] = -1e4
        kpm_t = to(a)
    if bias:
        bias_t = to(rng.randn(s, s))
    return tables, q, k, v, dout, kpm_t, bias_t


FIXED = {"mode": "fixed", "num_local_blocks": 4,
         "attention": "unidirectional"}
PER_HEAD = dict(FIXED, different_layout_per_head=True,
                num_different_global_patterns=4)


# (section, block, d, dtype, causal, kpm, bias, seq); seq None: 12 blocks
SPARSE_CASES = [
    (FIXED, 16, 64, torch.bfloat16, True, False, False, None),
    (PER_HEAD, 16, 64, torch.bfloat16, True, True, True, None),
    (FIXED, 32, 32, torch.float16, False, True, False, None),
    (PER_HEAD, 32, 128, torch.float32, True, False, True, None),
    ({"mode": "bigbird", "num_random_blocks": 1, "seed": 2}, 64, 64,
     torch.float32, False, False, False, None),
    ({"mode": "bslongformer", "global_block_indices": [0]}, 128, 128,
     torch.bfloat16, True, True, False, None),
    ({"mode": "variable", "different_layout_per_head": True,
      "num_random_blocks": 1, "seed": 5}, 16, 32, torch.bfloat16, False,
     False, True, None),
    ({"mode": "sliding_window", "num_sliding_window_blocks": 3}, 128, 64,
     torch.float16, True, False, False, None),
] + [
    # the fp16 backward on long walks with a key bias and a score bias:
    # every block of a dense layout, at the flash fp16 cases' lengths
    # (chip_smoke.py FP16_CASES: 96, and 1000 rounded up to the block)
    ({"mode": "dense"}, 32, d, torch.float16, causal, True, True, s)
    for d in (32, 128) for s in (96, 1024) for causal in (True, False)
]


@pytest.mark.parametrize("section,block,d,dtype,causal,kpm,bias,seq",
                         SPARSE_CASES)
def test_block_sparse_kernels_match_plain_versions(cuda, section, block, d,
                                                   dtype, causal, kpm, bias,
                                                   seq):
    """Each of the three kernels against its plain version, an empty query
    block included. fp32: out within 1e-5 absolute, dq, dk, dv within 1e-5
    of their largest magnitude; bf16/fp16, per element: one ulp of the
    plain value plus eps / 4 (out) or 1e-6 (grads); lse within 1e-4 and
    NEG_INF exactly where the plain version has it; three forward runs bit
    for bit."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    h = 4
    s = seq or block * 12
    tables, q, k, v, dout, kpm_t, bias_t = _sparse_case(
        cuda, dtype, dict(section, block=block), h, s, d, kpm=kpm, bias=bias)
    kw = dict(tables=tables, causal=causal)
    names = ("block_sparse_fwd", "block_sparse_bwd_dq",
             "block_sparse_bwd_dkdv")
    counts = [getattr(bsa, n).launches for n in names]
    runs = [bsa.block_sparse_fwd(q, k, v, kpm_t, bias_t, **kw)
            for _ in range(3)]
    out, lse = runs[0]
    delta = bsa.attention_delta(out, dout)
    args = (q, k, v, kpm_t, bias_t, dout, lse, delta)
    dq = bsa.block_sparse_bwd_dq(*args, **kw)
    dk, dv = bsa.block_sparse_bwd_dkdv(*args, **kw)
    ref_out, ref_lse = bsa.block_sparse_fwd_reference(q, k, v, kpm_t, bias_t,
                                                      **kw)
    ref_dq = bsa.block_sparse_bwd_dq_reference(*args, **kw)
    ref_dk, ref_dv = bsa.block_sparse_bwd_dkdv_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [getattr(bsa, n).launches for n in names] == \
        [c + n for c, n in zip(counts, (3, 1, 1))]
    for o, ls in runs[1:]:                          # the forward's repeats
        assert torch.equal(o, out) and torch.equal(ls, lse)
    assert out.transpose(1, 2).is_contiguous()      # (b, s, h, d) memory
    dead = ref_lse <= bsa.NEG_INF
    assert bool(dead.any()) and torch.equal(lse <= bsa.NEG_INF, dead)
    assert float((lse - ref_lse)[~dead].abs().max()) <= 1e-4
    assert float(out[dead].float().abs().max()) == 0.0
    grads = (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))
    for name, got, _ in grads + (("out", out, None),):
        assert torch.isfinite(got.float()).all(), name
    if dtype == torch.float32:
        assert float((out - ref_out).abs().max()) <= 1e-5
        for name, got, want in grads:
            assert _rel_err(got, want) <= 1e-5, (name, _rel_err(got, want))
        return
    eps = torch.finfo(dtype).eps
    assert _ulp_ratio(out, ref_out, eps / 4) <= 1.0, \
        _ulp_ratio(out, ref_out, eps / 4)
    for name, got, want in grads:
        assert _ulp_ratio(got, want, 1e-6) <= 1.0, \
            (name, _ulp_ratio(got, want, 1e-6))


@pytest.mark.parametrize("mask", ["kpm", "bias", "both"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_block_sparse_rows_masked_to_neg_inf(cuda, dtype, mask):
    """Rows whose every key in the layout a kpm or bias of NEG_INF masks
    (batch 1's first block as padding under causal masking; whole bias
    rows) get out 0 and lse NEG_INF, as in the plain version, and no
    gradient; the other rows and the gradients as in
    test_block_sparse_kernels_match_plain_versions."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    h, block, d = 4, 16, 64
    s = block * 12
    tables, q, k, v, dout, kpm_t, bias_t = _sparse_case(
        cuda, dtype, dict(FIXED, block=block), h, s, d, seed=2,
        kpm=mask != "bias", bias=mask != "kpm", empty_row=False)
    expect = torch.zeros((2, h, s), dtype=torch.bool, device=cuda)
    if kpm_t is not None:
        kpm_t[1, :block] = bsa.NEG_INF
        expect[1, :, :block] = True
    if bias_t is not None:
        rows = [3 * block + 5, 7 * block, 7 * block + 1, 11 * block + 15]
        bias_t[rows] = bsa.NEG_INF
        expect[:, :, rows] = True
    kw = dict(tables=tables, causal=True)
    out, lse = bsa.block_sparse_fwd(q, k, v, kpm_t, bias_t, **kw)
    delta = bsa.attention_delta(out, dout)
    args = (q, k, v, kpm_t, bias_t, dout, lse, delta)
    grads = (bsa.block_sparse_bwd_dq(*args, **kw),
             *bsa.block_sparse_bwd_dkdv(*args, **kw))
    ref_out, ref_lse = bsa.block_sparse_fwd_reference(q, k, v, kpm_t, bias_t,
                                                      **kw)
    refs = (bsa.block_sparse_bwd_dq_reference(*args, **kw),
            *bsa.block_sparse_bwd_dkdv_reference(*args, **kw))
    torch.cuda.synchronize()
    dead = ref_lse <= bsa.NEG_INF
    assert torch.equal(dead, expect)
    assert torch.equal(lse <= bsa.NEG_INF, dead)
    assert float((lse - ref_lse)[~dead].abs().max()) <= 1e-4
    assert float(out[dead].float().abs().max()) == 0.0
    assert float(grads[0][dead].float().abs().max()) == 0.0
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                               (ref_out,) + refs):
        assert torch.isfinite(got.float()).all(), name
        if dtype == torch.float32:
            err = float((got - want).abs().max()) if name == "out" else \
                _rel_err(got, want)
            assert err <= 1e-5, (name, err)
        else:
            tol = torch.finfo(dtype).eps / 4 if name == "out" else 1e-6
            assert _ulp_ratio(got, want, tol) <= 1.0, \
                (name, _ulp_ratio(got, want, tol))


def test_block_sparse_kernels_are_deterministic(cuda):
    """Repeated launches give bit-identical out, lse, dq, dk, dv (no
    atomics)."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    tables, q, k, v, dout, kpm, bias = _sparse_case(
        cuda, torch.bfloat16, dict(PER_HEAD, block=16), 4, 512, 64,
        kpm=True)
    kw = dict(tables=tables, causal=True)
    runs = []
    for _ in range(3):
        out, lse = bsa.block_sparse_fwd(q, k, v, kpm, None, **kw)
        delta = bsa.attention_delta(out, dout)
        args = (q, k, v, kpm, None, dout, lse, delta)
        runs.append((out, lse, bsa.block_sparse_bwd_dq(*args, **kw),
                     *bsa.block_sparse_bwd_dkdv(*args, **kw)))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("s", [2048, 4096])
def test_block_sparse_long_transposed_walks(cuda, s):
    """Global columns make the transposed walks of a causal ``fixed``
    layout long (a key tile of global columns walks every later query).
    dq, dk and dv within one bf16 ulp of the plain versions (plus 1e-6)
    and bit-identical over three runs."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    section = dict(FIXED, block=16, num_global_blocks=1)
    tables, q, k, v, dout, _, _ = _sparse_case(
        cuda, torch.bfloat16, section, 2, s, 64, empty_row=False)
    assert int(tables.bwd.lengths.max()) * 16 >= s // 2   # a long walk
    kw = dict(tables=tables, causal=True)
    out, lse = bsa.block_sparse_fwd(q, k, v, **kw)
    delta = bsa.attention_delta(out, dout)
    args = (q, k, v, None, None, dout, lse, delta)
    runs = [(bsa.block_sparse_bwd_dq(*args, **kw),
             *bsa.block_sparse_bwd_dkdv(*args, **kw)) for _ in range(3)]
    refs = (bsa.block_sparse_bwd_dq_reference(*args, **kw),
            *bsa.block_sparse_bwd_dkdv_reference(*args, **kw))
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), runs[0], refs):
        assert torch.isfinite(got.float()).all(), name
        assert _ulp_ratio(got, want, 1e-6) <= 1.0, \
            (name, _ulp_ratio(got, want, 1e-6))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_block_sparse_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    tables, q, k, v, dout, _, _ = _sparse_case(
        cuda, torch.bfloat16, dict(FIXED, block=16), 4, 128, 64)
    kw = dict(tables=tables, causal=True)
    with pytest.raises(ValueError, match="k is"):
        bsa.block_sparse_fwd(q, k.cpu(), v, **kw)          # mixed devices
    with pytest.raises(ValueError, match="k is"):
        bsa.block_sparse_fwd(q, k.float(), v, **kw)        # mixed dtypes
    with pytest.raises(ValueError, match="dtype"):
        bsa.block_sparse_fwd(q.double(), k.double(), v.double(), **kw)
    with pytest.raises(ValueError, match="d_head"):
        bsa.block_sparse_fwd(q[..., :48], k[..., :48], v[..., :48], **kw)
    with pytest.raises(ValueError, match="must match the layout"):
        bsa.block_sparse_fwd(q[:, :, :120], k[:, :, :120], v[:, :, :120],
                             **kw)                         # 120 % 16 != 0
    with pytest.raises(ValueError, match="must match the layout"):
        bsa.block_sparse_fwd(q[:, :2], k[:, :2], v[:, :2], **kw)
    with pytest.raises(ValueError, match="kpm must be"):
        bsa.block_sparse_fwd(q, k, v, torch.zeros(2, 128), **kw)
    with pytest.raises(ValueError, match="must be \\(b, h, s, d\\)"):
        bsa.block_sparse_fwd(q[0], k[0], v[0], **kw)
    with pytest.raises(ValueError, match="unit stride"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        bsa.block_sparse_fwd(t, t, t, **kw)
    odd = bsa.LayoutTables(np.ones((4, 16, 16), np.int64), 8)
    with pytest.raises(ValueError, match="multiples of 16"):
        bsa.block_sparse_fwd(q, k, v, tables=odd, causal=True)
    out, lse = bsa.block_sparse_fwd(q, k, v, **kw)
    with pytest.raises(ValueError, match="lse must be"):
        bsa.block_sparse_bwd_dq(q, k, v, None, None, dout, lse.double(),
                                lse, **kw)


def test_sparse_training_kernels_match_plain_versions(cuda):
    """A tiny fp32 GPT-2 with the ds_config sparse section (per-head
    layout), 3 train_batch steps through the kernels and through their
    plain versions (names swapped for the comparison): losses within 1e-5
    relative; one launch of each kernel per layer per step, none of the
    flash kernels."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    section = dict(PER_HEAD, block=16)
    names = ("block_sparse_fwd", "block_sparse_bwd_dq",
             "block_sparse_bwd_dkdv")
    kernels = {n: getattr(bsa, n) for n in names}
    ids = np.random.RandomState(3).randint(0, 256, size=(1, 2, 256))
    runs = {}
    for route in ("kernels", "plain"):
        for c in list(kernels.values()) + [fa.flash_fwd]:
            c.launches = 0
        if route == "plain":
            for n in names:
                setattr(bsa, n, getattr(bsa, n + "_reference"))
        try:
            cfg = gpt2.GPT2Config(vocab_size=256, max_seq_len=256,
                                  n_layers=2, n_heads=4, d_model=256,
                                  loss_chunk=64, remat=False,
                                  sparse_attention=section)
            engine = deepspeed_tpu_torch.initialize(
                model=gpt2.make_gpt2_model(config=cfg, seed=1),
                config_params={"train_micro_batch_size_per_gpu": 2,
                               "optimizer": {"type": "Adam",
                                             "params": {"lr": 1e-3}},
                               "sparse_attention": section})[0]
            runs[route] = [float(engine.train_batch(batch=(ids, ids)))
                           for _ in range(3)]
        finally:
            for n, fn in kernels.items():
                setattr(bsa, n, fn)
        if route == "kernels":
            assert all(c.launches == 2 * 3 for c in kernels.values())
            assert fa.flash_fwd.launches == 0
        else:
            assert all(c.launches == 0 for c in kernels.values())
    np.testing.assert_allclose(runs["kernels"], runs["plain"], rtol=1e-5)
    assert runs["kernels"][-1] < runs["kernels"][0]


# ----------------------------------------------------- LAMB, BERT, 3D flash


def _ulp_steps(got, want):
    """Per-element distance in fp32 representable steps (0 = bit-equal)."""
    a = got.float().contiguous().view(torch.int32).long()
    b = want.float().contiguous().view(torch.int32).long()
    # map the sign-magnitude bit patterns onto a monotone integer line
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int((a - b).abs().max())


LAMB_SEGMENTS = {
    # a BERT-like table: aligned starts, tiny and multi-chunk segments,
    # an all-zero segment (the trust ratio's 1.0 branch), an empty one
    "aligned": [(0, 2), (64, 100_000), (100_096, 17), (100_160, 8192),
                (108_352, 0), (108_352, 30_000)],
    # starts that are no multiple of 4: the scalar path
    "misaligned": [(1, 5000), (5003, 9000), (14_007, 1)],
}


@pytest.mark.parametrize("table,eps_inside_sqrt", [
    ("aligned", False), ("aligned", True), ("misaligned", False)])
def test_fused_lamb_kernels_match_plain_versions(cuda, table,
                                                 eps_inside_sqrt):
    """Three steps: m and v bit-equal to the plain versions, the trust
    ratios and the per-segment sums (|p|^2, |u|^2) bit-equal (the plain
    version sums in the kernel's order), p within one fp32 ulp; two runs
    of the kernels bit-identical."""
    from deepspeed_tpu_torch.ops.adam import bias_corrections
    from deepspeed_tpu_torch.ops.lamb import (
        LambPlan, fused_lamb, fused_lamb_apply, fused_lamb_apply_reference,
        fused_lamb_reference)
    segments = LAMB_SEGMENTS[table]
    total = max(o + n for o, n in segments) + 64
    rng = np.random.RandomState(len(segments))
    covered = np.zeros(total, bool)
    for off, n in segments:
        covered[off:off + n] = True
    if table == "aligned":
        covered[100_096:100_113] = False       # the all-zero segment
    p0 = (rng.randn(total) * covered).astype(np.float32)
    plan = LambPlan(segments, cuda)
    sides = [[torch.tensor(p0, device=cuda), torch.zeros(total, device=cuda),
              torch.zeros(total, device=cuda)] for _ in range(3)]
    for step in (1, 2, 3):
        g = torch.from_numpy((rng.randn(total) * covered).astype(
            np.float32)).to(cuda)
        bc1, bc2 = bias_corrections(0.9, 0.999, step)
        sc = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                  bc1=bc1, bc2=bc2, eps_inside_sqrt=eps_inside_sqrt)
        kw = {k: sc[k] for k in ("eps", "weight_decay", "bc1", "bc2",
                                 "eps_inside_sqrt")}
        ratios, sums = [], []
        for i, (p, m, v) in enumerate(sides):
            if i < 2:
                r, sq = fused_lamb(p, g, m, v, plan, **sc)
                fused_lamb_apply(p, m, v, r, plan, lr=2e-3, **kw)
            else:
                r, sq = fused_lamb_reference(p, g, m, v, plan, **sc)
                fused_lamb_apply_reference(p, m, v, r, plan, lr=2e-3, **kw)
            ratios.append(r)
            sums.append(sq)
        torch.cuda.synchronize()
        for t0, t1 in zip(sides[0], sides[1]):
            assert torch.equal(t0, t1)             # deterministic
        assert torch.equal(sums[0], sums[1])
        assert torch.equal(ratios[0], ratios[2]), (ratios[0], ratios[2])
        assert torch.equal(sums[0], sums[2]), (sums[0], sums[2])
        assert torch.equal(sides[0][1], sides[2][1])
        assert torch.equal(sides[0][2], sides[2][2])
        assert _ulp_steps(sides[0][0], sides[2][0]) <= 1
    if table == "aligned":
        assert float(ratios[0][2]) == 1.0          # the all-zero segment
    assert torch.isfinite(sides[0][0]).all()


@pytest.mark.parametrize("table", ["aligned", "misaligned"])
def test_fused_lamb_bf16_moments_kernels_match_plain_versions(cuda, table):
    """bf16 moments, three steps: stage 1 leaves m and v untouched, the
    apply makes m' and v' from g and stores them; m, v, the trust ratios
    and the sums bit-equal to the plain versions, p within one fp32 ulp,
    two kernel runs bit-identical."""
    from deepspeed_tpu_torch.ops.adam import bias_corrections
    from deepspeed_tpu_torch.ops.lamb import (
        LambPlan, fused_lamb, fused_lamb_apply, fused_lamb_apply_reference,
        fused_lamb_reference)
    segments = LAMB_SEGMENTS[table]
    total = max(o + n for o, n in segments) + 64
    rng = np.random.RandomState(len(segments) + 7)
    covered = np.zeros(total, bool)
    for off, n in segments:
        covered[off:off + n] = True
    p0 = (rng.randn(total) * covered).astype(np.float32)
    plan = LambPlan(segments, cuda)
    sides = [[torch.tensor(p0, device=cuda),
              torch.zeros(total, device=cuda, dtype=torch.bfloat16),
              torch.zeros(total, device=cuda, dtype=torch.bfloat16)]
             for _ in range(3)]
    for step in (1, 2, 3):
        g = torch.from_numpy((rng.randn(total) * covered).astype(
            np.float32)).to(cuda)
        bc1, bc2 = bias_corrections(0.9, 0.999, step)
        sc = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                  bc1=bc1, bc2=bc2)
        kw = dict(sc, g=g, lr=2e-3)
        ratios, sums = [], []
        for i, (p, m, v) in enumerate(sides):
            m0 = m.clone()
            if i < 2:
                r, sq = fused_lamb(p, g, m, v, plan, **sc)
                assert torch.equal(m, m0)          # stage 1: untouched
                fused_lamb_apply(p, m, v, r, plan, **kw)
            else:
                r, sq = fused_lamb_reference(p, g, m, v, plan, **sc)
                fused_lamb_apply_reference(p, m, v, r, plan, **kw)
            ratios.append(r)
            sums.append(sq)
        torch.cuda.synchronize()
        for t0, t1 in zip(sides[0], sides[1]):
            assert torch.equal(t0, t1)             # deterministic
        assert torch.equal(ratios[0], ratios[2]), (ratios[0], ratios[2])
        assert torch.equal(sums[0], sums[2])
        assert torch.equal(sides[0][1], sides[2][1])
        assert torch.equal(sides[0][2], sides[2][2])
        assert _ulp_steps(sides[0][0], sides[2][0]) <= 1
    assert sides[0][1].dtype == torch.bfloat16
    assert torch.isfinite(sides[0][0]).all()


def test_fused_lamb_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    from deepspeed_tpu_torch.ops.lamb import LambPlan, fused_lamb
    plan = LambPlan([(0, 100)], cuda)
    p = torch.zeros(100, device=cuda)
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, bc1=0.1,
              bc2=0.001)
    before = fused_lamb.launches
    with pytest.raises(ValueError, match="plan"):
        fused_lamb(p, p.clone(), p.clone(), p.clone(),
                   LambPlan([(0, 100)], "cpu"), **sc)
    with pytest.raises(ValueError, match="contiguous fp32"):
        fused_lamb(p, p.half(), p.clone(), p.clone(), plan, **sc)
    assert fused_lamb.launches == before


@pytest.mark.parametrize("s,causal", [(128, True), (100, False),
                                      (200, True)])
def test_3d_flash_attention_matches_its_cpu_run(cuda, s, causal):
    """The (b * h, s, d) API through the kernels against the same op on CPU
    copies (the plain versions), fp32, any s."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    rng = np.random.RandomState(s)
    arrays = [rng.randn(6, s, 64).astype(np.float32) for _ in range(4)]
    results = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays[:3])
        before = fa.flash_fwd.launches
        out = fa.flash_attention(q, k, v, causal=causal)
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        assert fa.flash_fwd.launches - before == (dev.type == "cuda")
        results.append([t.detach().cpu() for t in (out, q.grad, k.grad,
                                                  v.grad)])
    for name, got, want in zip(("out", "dq", "dk", "dv"), *results):
        assert _rel_err(got, want) <= 1e-5, (name, _rel_err(got, want))


@pytest.mark.parametrize("seed", range(8))
def test_flash_mask_bias_fp32_repeats(cuda, seed):
    """The fp32 (b, s, h, d) op with a key-padding mask, repeated over
    seeds at the shape of test_flash_attention_bshd_mask_bias_grads_
    match_plain: each of out/dq/dk/dv's relative error against the CPU run
    is printed (run with -s to record it) and held to 1e-5."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention_bshd
    rng = np.random.RandomState(100 + seed)
    b, s, h, d = 2, 96, 2, 32
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    mask = np.where(rng.rand(b, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    results = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays[:3])
        out = flash_attention_bshd(q, k, v, causal=False,
                                   mask_bias=torch.from_numpy(mask).to(dev))
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        results.append([t.detach().cpu() for t in (out, q.grad, k.grad,
                                                  v.grad)])
    errs = {name: _rel_err(got, want) for name, got, want in
            zip(("out", "dq", "dk", "dv"), *results)}
    print("flash_mask_bias_fp32 seed={} {}".format(seed, errs))
    assert max(errs.values()) <= 1e-5, errs


def test_tiny_bert_training_kernels_match_plain_versions(cuda):
    """A tiny fp32 BERT with a padded mask, LAMB, 3 steps, remat on: the
    flash kernels and the LAMB kernels ("pallas") against the einsum path
    and the plain LAMB ("xla"), losses within 1e-5 relative; per step the
    flash forward launches twice a layer (remat recomputes it), each
    backward kernel once, each LAMB kernel once."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.adam import fused_adam
    from deepspeed_tpu_torch.ops.lamb import fused_lamb, fused_lamb_apply
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    cfg = dict(vocab_size=256, max_seq_len=128, n_layers=2, n_heads=2,
               d_model=128, d_intermediate=256, dropout=0.0,
               attn_dropout=0.0, remat=True)
    rng = np.random.RandomState(6)
    b, s = 4, 128
    ids = rng.randint(0, 256, size=(b, s))
    valid = np.array([128, 100, 77, 64])
    mask = (np.arange(s)[None, :] < valid[:, None]).astype(np.int64)
    mlm = np.where((rng.rand(b, s) < 0.15) & (mask == 1), ids, -100)
    mlm[:, 1] = ids[:, 1]
    batch = tuple(a[None] for a in (ids, np.zeros_like(ids), mask, mlm,
                                    rng.randint(0, 2, size=(b,))))
    counters = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq,
                fused_lamb, fused_lamb_apply, fused_adam)
    runs = {}
    for backend in ("pallas", "xla"):
        model = bert.make_bert_model(config=bert.BertConfig(**cfg), seed=5)
        engine = deepspeed_tpu_torch.initialize(model=model, config_params={
            "train_micro_batch_size_per_gpu": b,
            "optimizer": {"type": "Lamb", "params": {
                "lr": 2e-3, "fused_kernel": backend}},
            "transformer": {"flash_attention": backend}})[0]
        assert engine.device.type == "cuda"
        for fn in counters:
            fn.launches = 0
        runs[backend] = [float(engine.train_batch(batch=batch))
                         for _ in range(3)]
        launches = [fn.launches for fn in counters]
        want = [3 * 4, 3 * 2, 3 * 2, 3, 3, 0] if backend == "pallas" \
            else [0] * 6
        assert launches == want, (backend, launches)
    np.testing.assert_allclose(runs["pallas"], runs["xla"], rtol=1e-5)
    assert runs["pallas"][-1] < runs["pallas"][0]


# ------------------------------------------------------------ ring GEMMs


def _ring_tol(dtype):
    """fp32: another summation order (1e-5 of the output's scale); bf16:
    one rounding of an fp32 sum each side, so two bf16 ulps, plus a floor
    of 2**-14 of the scale for values near zero."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -6, 2 ** -14)


def _assert_ring_close(got, want, dtype):
    rel, floor = _ring_tol(dtype)
    got, want = got.float(), want.float()
    bound = rel * want.abs() + floor * float(want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


def _full_precision_reduction(monkeypatch):
    """The plain versions' bf16 torch.matmul sums in fp32, as the kernels
    do (cuBLAS may otherwise reduce split-K partials in bf16); restored
    after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)


def _rnd(gen, device, dtype, *shape):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_loc,d,f,n,blk,wt", [
    (2, 40, 72, 24, 2, 1, False), (1, 17, 35, 9, 3, 2, True),
    (3, 64, 128, 256, 2, 0, True), (2, 130, 136, 200, 4, 3, False),
    # M, N and K off the 128 x 128 tiles and the 64-deep k steps, both
    # layouts of w (the n-contiguous weight, the k-contiguous w^T view),
    # with K and N multiples of 8 (16-byte copies) and not (plain loads)
    (2, 200, 1000, 300, 2, 1, False), (2, 200, 1000, 300, 2, 0, True),
    (1, 333, 517, 270, 3, 2, False), (1, 333, 517, 270, 3, 1, True),
    (4, 256, 1024, 1536, 2, 1, False), (4, 256, 1024, 520, 2, 0, True)])
def test_ring_ag_gemm_matches_plain_version(cuda, monkeypatch, dtype, b,
                                            s_loc, d, f, n, blk, wt):
    """One all-gather step against its plain version within _ring_tol,
    only the step's ring block written, and a second run bit-identical."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    _full_precision_reduction(monkeypatch)
    gen = torch.Generator(device=cuda).manual_seed(d + f)
    cur = _rnd(gen, cuda, dtype, b, s_loc, d)
    w = _rnd(gen, cuda, dtype, f, d).t() if wt else \
        _rnd(gen, cuda, dtype, d, f)
    outs = [torch.full((b, n * s_loc, f), 7.0, device=cuda, dtype=dtype)
            for _ in range(2)]
    before = rg.ring_ag_gemm.launches
    rg.ring_ag_gemm(cur, w, outs[0], blk)
    rg.ring_ag_gemm_reference(cur, w, outs[1], blk)
    torch.cuda.synchronize()
    assert rg.ring_ag_gemm.launches == before + 1
    rows = slice(blk * s_loc, (blk + 1) * s_loc)
    _assert_ring_close(outs[0][:, rows], outs[1][:, rows], dtype)
    others = torch.ones(n * s_loc, dtype=torch.bool)
    others[rows] = False
    assert bool((outs[0][:, others.to(cuda)] == 7.0).all())
    again = torch.full_like(outs[0], 7.0)
    rg.ring_ag_gemm(cur, w, again, blk)
    assert torch.equal(again, outs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_loc,f,d,n,blk,wt,first", [
    (2, 40, 72, 24, 2, 1, False, False), (1, 17, 35, 9, 3, 2, True, True),
    (3, 64, 128, 256, 2, 0, True, False),
    (2, 33, 136, 200, 4, 3, False, False)])
def test_ring_rs_gemm_add_matches_plain_version(cuda, monkeypatch, dtype, b,
                                                s_loc, f, d, n, blk, wt,
                                                first):
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    _full_precision_reduction(monkeypatch)
    gen = torch.Generator(device=cuda).manual_seed(f + d)
    x = _rnd(gen, cuda, dtype, b, n * s_loc, f)
    w = _rnd(gen, cuda, dtype, d, f).t() if wt else \
        _rnd(gen, cuda, dtype, f, d)
    recv = None if first else _rnd(gen, cuda, dtype, b, s_loc, d)
    outs = [torch.empty(b, s_loc, d, device=cuda, dtype=dtype)
            for _ in range(2)]
    rg.ring_rs_gemm_add(x, w, blk, n, outs[0], recv)
    rg.ring_rs_gemm_add_reference(x, w, blk, n, outs[1], recv)
    torch.cuda.synchronize()
    _assert_ring_close(outs[0], outs[1], dtype)
    if recv is not None:
        # in place: the received accumulator is the output slot
        slot, plain = recv.clone(), recv.clone()
        rg.ring_rs_gemm_add(x, w, blk, n, slot, slot)
        rg.ring_rs_gemm_add_reference(x, w, blk, n, plain, plain)
        assert torch.equal(slot, outs[0])
        _assert_ring_close(slot, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_rs_gemm_add_in_place_matches_plain_version(cuda, monkeypatch,
                                                         dtype):
    """A middle step of a ring of 4 as matmul_rs runs it: ``out`` is the
    very tensor ``recv`` (the slot the hop filled), at a shape of many
    tiles; held to the plain version run the same way."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    _full_precision_reduction(monkeypatch)
    b, s_loc, f, d, n = 2, 192, 256, 320, 4
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _rnd(gen, cuda, dtype, b, n * s_loc, f)
    w = _rnd(gen, cuda, dtype, f, d)
    recv = _rnd(gen, cuda, dtype, b, s_loc, d)
    for blk in range(n):
        slot, plain = recv.clone(), recv.clone()
        before = rg.ring_rs_gemm_add.launches
        assert rg.ring_rs_gemm_add(x, w, blk, n, slot, slot) is slot
        rg.ring_rs_gemm_add_reference(x, w, blk, n, plain, plain)
        torch.cuda.synchronize()
        assert rg.ring_rs_gemm_add.launches == before + 1
        _assert_ring_close(slot, plain, dtype)


# (b, s_loc, K, N, w^T): the TP 2 sites' (K, weight layout) pairs at 400
# rows (M off the 128-row tiles), then K off the 64-deep steps (16-byte
# copies) and off 8 (plain loads), N off the 128-column tiles
@pytest.mark.parametrize("b,s_loc,k,n,wt", [
    (2, 200, 512, 1024, False), (2, 200, 2048, 1024, False),
    (2, 200, 1536, 1024, True), (2, 200, 2048, 1024, True),
    (1, 333, 520, 270, False), (1, 333, 517, 270, True),
    (3, 77, 200, 1000, False)])
def test_ring_rs_gemm_add_bf16_kernel_at_the_tp_sites(cuda, monkeypatch, b,
                                                     s_loc, k, n, wt):
    """The bf16 reduce-scatter step on the all-gather kernel's main loop:
    against its plain version (_ring_tol) without ``recv`` (the first ring
    step) and with it; in place (``out`` is ``recv``) and into a misaligned
    output (2-byte aligned: the scalar stores) with the same bits as the
    aligned run; and a second run bit-identical."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    _full_precision_reduction(monkeypatch)
    dt, ring = torch.bfloat16, 2
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = _rnd(gen, cuda, dt, b, ring * s_loc, k)
    w = _rnd(gen, cuda, dt, n, k).t() if wt else _rnd(gen, cuda, dt, k, n)
    recv = _rnd(gen, cuda, dt, b, s_loc, n)
    shape = (b, s_loc, n)
    for arrived in (None, recv):
        out, plain = (torch.empty(shape, device=cuda, dtype=dt)
                      for _ in range(2))
        before = rg.ring_rs_gemm_add.launches
        rg.ring_rs_gemm_add(x, w, 1, ring, out, arrived)
        rg.ring_rs_gemm_add_reference(x, w, 1, ring, plain, arrived)
        torch.cuda.synchronize()
        assert rg.ring_rs_gemm_add.launches == before + 1
        _assert_ring_close(out, plain, dt)
        again = torch.empty_like(out)
        rg.ring_rs_gemm_add(x, w, 1, ring, again, arrived)
        assert torch.equal(again, out)
        odd = torch.empty(out.numel() + 1, device=cuda, dtype=dt)[1:]
        odd = odd.view(shape)
        assert odd.data_ptr() % 4 == 2
        rg.ring_rs_gemm_add(x, w, 1, ring, odd, arrived)
        assert torch.equal(odd, out)
    slot = recv.clone()
    assert rg.ring_rs_gemm_add(x, w, 1, ring, slot, slot) is slot
    assert torch.equal(slot, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_loc,a,c,n,lhs", [
    (2, 40, 72, 24, 2, True), (1, 17, 35, 9, 3, False),
    (4, 128, 64, 192, 2, True), (2, 130, 136, 200, 4, False)])
def test_ring_gc_gemm_acc_matches_plain_version(cuda, dtype, b, s_loc, a, c,
                                                n, lhs):
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    gen = torch.Generator(device=cuda).manual_seed(a + c)
    rot = _rnd(gen, cuda, dtype, b, s_loc, a)
    fixed = _rnd(gen, cuda, dtype, b, n * s_loc, c)
    shape = (a, c) if lhs else (c, a)
    accs = [torch.full(shape, float("nan"), device=cuda) for _ in range(2)]
    outs = [torch.empty(shape, device=cuda, dtype=dtype) for _ in range(2)]
    for step in range(n):
        last = step == n - 1
        rg.ring_gc_gemm_acc(rot, fixed, step, accs[0], step == 0,
                            outs[0] if last else None, lhs)
        rg.ring_gc_gemm_acc_reference(rot, fixed, step, accs[1], step == 0,
                                      outs[1] if last else None, lhs)
    torch.cuda.synchronize()
    _assert_ring_close(accs[0], accs[1], torch.float32)
    _assert_ring_close(outs[0], outs[1], dtype)


# (b, s_loc, a, c, ring n, lhs): K = b * s_loc rows; ragged M, N and K
# (some not multiples of 8: the plain-load staging), and the planner's
# split counts 1, 2, 4, 5 and 8 (checked in the test)
GC_BF16_CASES = [
    ((2, 40, 72, 24, 2, True), 1), ((3, 100, 37, 53, 2, False), 1),
    ((1, 3000, 35, 9, 3, True), 2), ((4, 1024, 100, 70, 2, False), 4),
    ((2, 4096, 1024, 512, 2, False), 5), ((8, 1024, 1024, 1536, 2, True), 2),
    ((1, 8292, 72, 40, 2, True), 8), ((16, 512, 2048, 1024, 2, True), 1),
    ((2, 4096, 600, 700, 2, True), 5)]


@pytest.mark.parametrize("first,with_out", [(True, True), (False, False),
                                            (False, True)])
@pytest.mark.parametrize("case,splits", GC_BF16_CASES)
def test_ring_gc_gemm_acc_bf16_kernel_matches_plain_version(
        cuda, monkeypatch, case, splits, first, with_out):
    """The bf16 dW kernel (k-major tiles staged by cp.async, ldmatrix.trans
    fragments, split K folded in split order) against its plain version:
    acc within 2**-16 of its largest entry and out within two bf16 ulps
    (RING_TOL's and _ring_tol's bounds), lhs and rhs modes, ``first`` or
    accumulating, ``out`` given or not; a second run from the same acc
    bit-identical."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm
    _full_precision_reduction(monkeypatch)
    b, s_loc, a, c, n, lhs = case
    shape = (a, c) if lhs else (c, a)
    plan = rgm.gc_plan(shape[0], shape[1], b * s_loc,
                       torch.cuda.get_device_properties(cuda)
                       .multi_processor_count)
    assert plan["splits"] == splits, plan
    gen = torch.Generator(device=cuda).manual_seed(a + c + s_loc)
    rot = _rnd(gen, cuda, torch.bfloat16, b, s_loc, a)
    fixed = _rnd(gen, cuda, torch.bfloat16, b, n * s_loc, c)
    acc0 = torch.randn(shape, generator=gen, device=cuda)
    accs = [acc0.clone() for _ in range(3)]
    outs = [torch.empty(shape, device=cuda, dtype=torch.bfloat16)
            if with_out else None for _ in range(3)]
    before = rg.ring_gc_gemm_acc.launches
    for i in range(2):
        rg.ring_gc_gemm_acc(rot, fixed, n - 1, accs[i], first, outs[i], lhs)
    rg.ring_gc_gemm_acc_reference(rot, fixed, n - 1, accs[2], first, outs[2],
                                  lhs)
    torch.cuda.synchronize()
    assert rg.ring_gc_gemm_acc.launches == before + 2
    assert torch.equal(accs[0], accs[1])
    want = accs[2]
    err = (accs[0] - want).abs().max()
    assert float(err) <= 2 ** -16 * float(want.abs().max()), float(err)
    if with_out:
        assert torch.equal(outs[0], outs[1])
        _assert_ring_close(outs[0], outs[2], torch.bfloat16)


def test_ring_gemm_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    cur = torch.zeros(2, 8, 16, device=cuda)
    w = torch.zeros(16, 8, device=cuda)
    out = torch.zeros(2, 16, 8, device=cuda)
    before = (rg.ring_ag_gemm.launches, rg.ring_rs_gemm_add.launches,
              rg.ring_gc_gemm_acc.launches)
    with pytest.raises(ValueError, match="every operand"):
        rg.ring_ag_gemm(cur, w.cpu(), out, 0)                 # device
    with pytest.raises(ValueError, match="dtype"):
        rg.ring_ag_gemm(cur.half(), w.half(), out.half(), 0)  # fp16
    with pytest.raises(ValueError, match="every operand"):
        rg.ring_ag_gemm(cur, w.bfloat16(), out, 0)            # mixed
    with pytest.raises(ValueError, match="contiguous"):
        rg.ring_ag_gemm(cur.transpose(0, 1).contiguous().transpose(0, 1),
                        w, out, 0)                            # stride
    with pytest.raises(ValueError, match="unit stride"):
        rg.ring_ag_gemm(cur, torch.zeros(16, 16, device=cuda)[:, ::2],
                        out, 0)
    with pytest.raises(ValueError, match="shapes"):
        rg.ring_ag_gemm(cur, w, out, 2)                       # block
    x = torch.zeros(2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rg.ring_rs_gemm_add(x, w, 0, 2, torch.zeros(2, 8, 8, device=cuda),
                            torch.zeros(2, 8, 8, device=cuda).transpose(1, 2)
                            .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shapes"):
        rg.ring_gc_gemm_acc(cur, x, 0, torch.zeros(16, 16, device=cuda,
                                                   dtype=torch.bfloat16),
                            True)                             # acc dtype
    assert (rg.ring_ag_gemm.launches, rg.ring_rs_gemm_add.launches,
            rg.ring_gc_gemm_acc.launches) == before
