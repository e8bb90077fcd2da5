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
  per layer per decode step.
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
                seed=0):
    """Slots at lengths spread over the whole page-table window (crossing
    page boundaries), their pages scattered over the pool, NaN in page 0
    and every unallocated page; with s > 1 the valid lengths are padded."""
    rng = np.random.RandomState(seed)
    usable = b * max_pages + 3
    positions = np.linspace(0, max_pages * ps - s, b).round().astype(np.int32)
    valid_lens = np.full(b, s, np.int32)
    if s > 1:
        valid_lens = rng.randint(1, s + 1, size=b).astype(np.int32)
    page_tables = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, usable + 1)))
    for i in range(b):
        need = -(-(int(positions[i]) + s) // ps)
        page_tables[i, :need] = [free.pop() for _ in range(need)]
    shape = (usable + 1, layers, h, ps, dh)
    k_pool = rng.randn(*shape).astype(np.float32)
    v_pool = rng.randn(*shape).astype(np.float32)
    dead = np.ones(usable + 1, bool)
    dead[page_tables[page_tables > 0]] = False
    k_pool[dead] = v_pool[dead] = np.nan
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
