#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero
with no ``ok`` line):

1. device  — the card's name and power limit from ``nvidia-smi``;
2. build   — every kernel source of the paths built with nvcc from the
   checkout, and the host ops ``csrc/ds_dataio.cpp`` and
   ``csrc/cpu_adam.cpp`` with g++, all builds started together;
3. kernel  — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its time, the plain version's, the least time
   the card could take (``bound_ms``) and a PyTorch library call's where
   one exists: paged attention (the serve path's decode shape, the
   speculative verify width s = 5 and TP 2's 8 heads a rank, two runs
   bit-identical, its splits, and timed with every slot at 64, 512 and
   1024 live keys beside SDPA and the bound; s = 5 at 512 and 1024 live
   keys, 8 heads at the decode case and s = 5), the flash
   forward, dk/dv and dq kernels (b 16, s 1024, h 16, d 64, bf16, causal,
   q/k/v strided column blocks of one QKV tensor; two runs of each
   bit-identical), the same three in the
   BERT path's mode (``flash_bert``: b 32, s 512, h 16, d 64, bf16,
   non-causal, the fp32 key bias of the train_bert batch's padded mask,
   also timed without the bias) and Adam (one flat fp32 buffer of
   GPT-2-350M's size, with fp32 and with bf16 moments);
4. train   — the training main path at bench.py's first rung:
   ``initialize(...).train_batch(...)`` on GPT-2-350M (``gpt2_medium``) at
   full width and depth, seq 1024, micro 20, remat off, bf16, ZeRO-2,
   Adam with bf16 moments and a bf16 gradient accumulator, the flash and
   Adam kernels chosen by "auto"; every kernel's launch count set to 0
   just before the timed steps and read just after; then a
   torch.profiler window;
5. train-parity — fp32 loss trajectories with the kernels and with the
   plain versions, at gpt2_medium width with 2 layers, with fp32 and with
   bf16 Adam moments; then ``train_example``: the GPT-2 example's twin
   (``deepspeed_tpu_torch/examples/gpt2_pretrain.py``) on the repo's
   ``examples/gpt2/ds_config_zero2.json`` at gpt2_medium (WarmupDecayLR,
   betas (0.9, 0.95), weight decay 0.1, clipping 1.0), a few steps: the
   learning rate of every step held to WarmupDecayLR, the loss falling,
   counts set to 0 just before and read just after; then
   ``train_example_data``: the twin with ``--data_prefix`` on a seeded
   corpus of patterned documents written to a temporary directory,
   read through the native loader (``csrc/ds_dataio.cpp``, built with
   g++ in the build phase), a few steps, the loss falling, the loader's
   host ms a batch and the step ms;
6. block_sparse_attention kernel phase — the three block-sparse kernels
   against their plain versions at the long-context train shape (b 2,
   s 8192, h 16, d 64, bf16, causal), over the train config's shared
   ``fixed`` layout and the parity config's per-head layout (the forward
   and the two backward kernels also bit for bit over two runs; the fp16
   forward, on the same tensor-core kernel, within one fp16 ulp of its
   plain version plus eps / 4), timed beside their
   bounds, ``flex_attention`` (torch.compile, same block mask) and
   ``scaled_dot_product_attention`` with the layout as a dense mask;
7. train_sparse — the long-context main path: ``initialize(...)
   .train_batch(...)`` on gpt2_medium at full width and depth, seq 8192,
   micro batch 2, with the ds_config ``sparse_attention`` section (the
   documented ``fixed`` layout, unidirectional); counts set to 0 just
   before the timed steps and read just after; a torch.profiler window;
8. train_sparse_parity — fp32 loss trajectories through the block-sparse
   kernels and through their plain versions, a per-head layout, at
   gpt2_medium width with 2 layers, seq 2048;
9. serve   — the serving main path: ``init_inference(...).generate(...)``
   serving 48 requests with gpt2_medium at full width and depth, bf16,
   from the paged KV cache, counts set to 0 just before and read just
   after; then a few all-slot decode steps under torch.profiler;
10. parity — fp32 greedy streams identical for the slot layout, the paged
   layout's plain read path and the paged kernel, on the card; then
   ``serve_spec``: the Serve configuration with n-gram speculation (k 4,
   the paged kernel at s = 5 in every verify step) over 48 prompts cut
   from a patterned document (bench_inference.py:140-170, seed 17), a
   profile of a few verify steps, then 16 of them with a
   gpt2_small-shaped model drafter; ``serve_spec_parity``: fp32, 2
   layers, the n-gram and model-drafter (draft = target) streams equal
   the plain greedy stream, the target as drafter accepting every
   draft; ``serve_tp``: two spawned ranks sharing the card over gloo,
   each ``init_inference(mp_size=2)`` on gpt2_medium (bf16, paged, the
   kernel over its 8 heads), 16 Serve requests, streams equal across
   ranks, counts set to 0 just before and read just after, per rank;
   its ``serve_tp_parity`` part: fp32, 2 layers, TP 2 streams equal to
   TP 1's with n-gram speculation off and on;
11. flash3d — the JAX package's 3D flash API (``flash_attention``, (b * h,
   s, d) operands) at (32 * 16, 512, 64) bf16, causal and not: the same
   op through its autograd against direct kernel calls, the kernels
   against their plain versions, timed; then ``flash_fp32_repeats``: the
   fp32 key-mask case of the GPU tests (b 2, s 96, h 2, d 32) 60 times,
   every run bit-identical, the worst element against the CPU run printed,
   and each run's out against a float64 evaluation, and each CPU run's
   forward intermediates (S, P, the row sums l, P.V per key tile) against
   float64 and against CPU run 1;
   then ``flash_fp16``: the fp16 forward, dk/dv and dq (tensor cores)
   against their plain versions at probes/kernel_probe.py fp16_backward's
   cases (d 32 / 128, s 96 / 1000, causal or not, a key bias dropping 20%
   of keys) and one whose P and dS fall into fp16's subnormal range, each
   within one fp16 ulp of the plain value plus 1e-6 (eps / 4 for out);
12. lamb — the LAMB stage-1 and apply kernels against their plain
   versions over one flat fp32 buffer of BERT-large's size with its real
   segment table (26 parameters, 336,232,258 elements), the per-segment
   sums (|p|^2, |u|^2) included, with fp32 and with bf16 moments, timed;
13. train_bert — the BERT main path: ``initialize(...).train_batch(...)``
   on BERT-large at full width and depth, seq 512, micro batch 32, bf16,
   ZeRO-2, LAMB with bf16 moments and a bf16 gradient accumulator
   (tests/perf/bert_bench.py's default bf16_state), remat on, dropout 0,
   a padded key mask (the flash kernels non-causal with a key bias);
   counts set to 0 just before the timed steps and read just after; a
   torch.profiler window;
14. train_bert_parity — fp32 loss trajectories with the kernels (flash +
   LAMB) and with the plain versions (einsum attention + plain LAMB), at
   BERT-large width with 2 layers, seq 128, the padded mask, with fp32
   and with bf16 LAMB moments;
15. ring_gemm — the three ring-step kernels of the tensor-parallel path
   (all-gather-matmul, matmul-reduce-scatter with the add, the dW
   gather-contract) at gpt2_medium TP 2's shapes (b 16, s 1024, four
   sites each, bf16, transposed weight views as the backward gives
   them) against their plain versions, per element (all three also bit
   for bit over two runs), timed beside their bounds and torch.matmul of
   the same product;
16. train_tp — the tensor-parallel main path: two spawned ranks sharing
   this card (gloo, each hop through host memory), each
   ``initialize(mesh=build_mesh(model=2), ...)`` with the ds_config
   ``comm.collective_matmul`` section (backend "pallas"), gpt2_medium at
   full width with 6 of its 24 layers (``ONE_CARD_LAYERS``; the
   four-card mode runs all 24), seq 1024, micro 16, bf16, ZeRO-2, Adam;
   counts set to 0 just before the timed steps and read just after, per
   rank;
17. train_tp_parity — fp32 loss trajectories at gpt2_medium width with 2
   layers: TP 2 through the ring kernels and through the plain ring, and
   the TP 1 engine, from the same init;
18. train_tp_lamb — LAMB at TP 2 (ring and LAMB kernels, rank 0's half of
   every fc kernel scaled x20) against the TP 1 engine, fp32, 2 layers:
   losses and fc masters;
19. train_dp — the data-parallel main path: two spawned ranks sharing
   this card (gloo, every collective through host memory), each
   ``initialize(mesh=build_mesh(data=2), ...)`` on the GPT-2 example's
   ``examples/gpt2/ds_config_zero2.json`` (ZeRO-2, WarmupDecayLR,
   clipping) at gpt2_medium (6 of its 24 layers; all 24 on four
   cards), seq 1024, micro 8 a rank, each its rows of
   one global batch; counts set to 0 just before the timed steps and read
   just after, per rank (Adam once a step over numel / 2); a profile
   step (the ZeRO collectives' host time); the state a rank holds at
   stages 0, 1 and 2;
20. train_dp_parity — DP 2 at gpt2_medium width with 2 layers (4 before
   the ZeRO-3 phases came: the script's time limit) against DP
   1 and against the plain versions, fp32 and bf16 (stages 0, 1 and 2 bit
   for bit), and LAMB with one rank's part of a leaf scaled x20 (stage 2
   against stage 0 and DP 1): losses and masters;
21. train_dp_ckpt — DP 2 (train_dp_parity's two ranks, after its runs:
   ZeRO-2, the example's config, 2 layers) saves; DP 1 loads: the master
   bit for bit, the next step within train_dp_parity's bounds;
22. train_dp_tp_parity — four ranks on ``build_mesh(data=2, model=2)``
   (ring, flash and Adam kernels), 2 layers, fp32 and bf16 ZeRO-2,
   against DP 1 x TP 1; then ZeRO-3 under TP (the units hold each rank's
   TP shards) equal to ZeRO-2 under TP bit for bit, and ZeRO-3 with
   ``sparse_embedding_grads`` against the dense-gradient ZeRO-3;
   train_pipe3 — the same four ranks as PP 2 x DP 2 (gpt2_medium width,
   4 layers, 2 steps): ZeRO-3 under PP against ZeRO-2 (the first loss
   within 1e-6 relative, masters' moves within ``PIPE_MOVED_RTOL``, as
   train_pipe_parity holds PP 2 to the dense engine), each rank's
   flash launches as ``pipe_chip.expected_launches`` states them (at
   stage 3 the forward twice a layer and micro-batch on every stage),
   and a pipeline tag under ``cpu_offload`` resumed equal to the run that
   kept going;
23. train_ckpt — the train path at bench.py's first rung (6 of its 24
   layers) saves after 2
   steps (``save_checkpoint``, a temporary directory, deleted after),
   takes 2 more; a fresh engine from another seed loads the tag
   (``verify_tag`` first) and takes the same 2: losses, master and
   moments equal bit for bit; counts set to 0 just before the resumed
   steps and read just after; save and load seconds, tag bytes by file;
24. train_remat — bench.py's third rung (micro 24, remat on) under
   ``remat_policy`` "full" and "dots": the first step bit-equal, step ms
   and peak GB each ("dots" keeping at least REMAT_DOTS_EXTRA_GB more),
   and a profile under "dots";
25. train_xl_offload — BASELINE config 4, the ZeRO-Offload main path:
   ``initialize(...).train_batch(...)`` on gpt2_xl at full width and
   depth (48 layers, d 1600, 25 heads, vocabulary 50304; the weights
   made on the card from a seed), seq 1024, micro 8, bf16, ZeRO stage 3
   with ``cpu_offload`` (the host Adam of ``csrc/cpu_adam.cpp``), Adam lr
   1e-4, remat on, loss chunk 128 (``tests/perf/bench_gpt2_xl.py:45-55``);
   2 warm-up and 3 timed steps (counts set to 0 just before, read just
   after): step ms, tokens/s, MFU, then one step split into the device's
   forward and backward, the D2H, the host Adam and the H2D; the device
   peak, the host bytes of master and moments, a falling loss. Before it,
   after the Adam kernel phase, ``cpu_adam``: the host op against its
   plain version on 64M elements (error, ms, GB/s, threads, whether the
   OpenMP probe passed);
   train_xl_stream — the same configuration with streamed parameter
   offload (``cpu_offload_params``, ``stage3_max_live_parameters`` 3e8:
   the asserted plan of 16 groups of 3 blocks), 1 warm-up and 2 timed
   steps: step ms, the split (uploads, device compute, D2H, the host's
   adds, norm and Adam), the device peak (under train_xl_offload's) and
   the losses (within 2e-4 of train_xl_offload's at each step), host
   bytes, upload batches and bytes a step, launches a step (flash forward
   96, dk/dv and dq 48, the device Adam 0); train_stream_parity —
   gpt2_xl width at 2 layers, one block a group: the streamed loss bit
   for bit the segment-by-segment recompute from the host masters, and 3
   steps and eval within 2e-4 relative of the classic stage 3 + offload
   engine;
26. train_offload_parity — gpt2_xl width at 2 layers, 5 steps: the
   offload engine against a stage-2 engine with the state on the card
   (losses within 1e-4 relative, masters by how far they moved, within
   ``OFFLOAD_MOVED_RTOL``; a control with the host step 5% too long must
   fall outside it, one with eps x10 is reported), and the offload step
   overlapped against serial and at two ``sub_group_size`` values, 2
   steps, bit for bit;
27. train_dp3 — ZeRO-3 over a data group: two ranks sharing the card
   over gloo (train_dp_parity's, after its runs), train_dp's config
   without clipping at gpt2_medium width, 2 layers: stage 3 == stage 2
   bit for bit (losses, masters), with and without ``cpu_offload``; a
   rank's parameter bytes about half;
28. train_offload_ckpt — an offload engine saves and a fresh one resumes
   bit for bit; a device-state engine and an offload engine load each
   other's tags;
29. train_pipe — BASELINE config 5's pipeline, the PP main path:
   ``initialize(model=make_gpt2_pipeline(...)).train_batch(...)`` on
   gpt2_medium at full width as PP 2, 12 of its 24 layers on one card
   (``PIPE_ONE_CARD_LAYERS``: the depth is cut, not the steps, to keep
   the script inside its limit; ``--pp-nccl`` keeps the full depth), two
   spawned ranks sharing this card over gloo (every hop and the tied-embedding sum through host
   memory), the GPT-2 example's ``examples/gpt2/ds_config_zero2.json``
   (bf16, ZeRO-2, clipping, WarmupDecayLR) at micro 4 and M = 8
   micro-batches, seq 1024; 2 warm-up and 3 timed steps (counts set to 0
   just before, read just after, per rank: each flash kernel and Adam at
   the launches the recompute schedule gives): step ms, tokens/s, MFU,
   each rank's peak, the hops' and the tied sum's host ms a step, a
   profile step; the losses finite and the two tied copies equal;
30. train_pipe_parity — 4 layers at gpt2_medium width, bf16, the
   example's config at a constant lr 1e-4, TF32 off, from the dense
   model's seeded weights: PP 2 against the one-rank engine on the same
   micro-batches (the first loss within 1e-6 relative, the masters' move
   within ``PIPE_MOVED_RTOL`` of the dense run's, which the control run
   without the tied-gradient sum must exceed); v = 2 and
   ``save_stage_residuals`` against the default; a tag saved at PP 2
   (v = 1) after one step resumed at v = 2 against the run that kept
   going; each rank's peak at M = 4 and M = 8 within 10%;
31. train_onebit — compressed communication, OneBitAdam: two spawned
   ranks sharing this card over gloo, ``initialize(mesh=build_mesh(
   data=2), ...)`` on gpt2_medium at full width with 4 of its 24 layers
   (``COMM_ONE_CARD_LAYERS``: the depth is cut, not the steps, to keep
   the script inside its limit), seq 1024, micro 8 a rank,
   bf16, ZeRO stage
   0, the 1-bit Adam tutorial's optimizer block (betas (0.9, 0.999),
   weight decay 0.01, lr 4e-4) with ``freeze_step`` 2: 2 warmup and 3
   frozen steps. The warmup losses and masters against stage 0 Adam in
   plain math from the same init; the second frozen step's exchange
   recomputed by the port's code on CPU tensors from the same per-rank
   inputs (scales within 1e-5, no sign flip away from 0); the error
   state non-zero after the frozen steps and zero after a forced
   overflow (the step skipped, the master unchanged); the bytes handed to
   all_to_all and all_gather a frozen step equal to
   ``onebit_exchange_bytes``; the loss finite, falling over the warmup;
32. train_qc — the same ranks and model on the GPT-2 example's config
   (ZeRO-2, Adam, clipping 1.0) with ``comm.quantized_collectives`` flat,
   3 steps, against the same config with the fp32 exchange (losses
   within 1e-3); Adam's kernel once a step a rank; the bytes a step equal
   to ``quantized_allreduce_bytes``; then rank 0 times the codec
   (quantize, dequantize, sign pack and unpack) over 354,871,296 lanes,
   gpt2_medium's exchange buffer. Both phases share one spawn;

33. train_zeropp — ZeRO++ and the stage-3 ring gather: train_dp_parity's
   two ranks (after train_dp3's runs) at gpt2_medium width (d 1024), 2
   layers, stage 3 on train_dp3's config, one warm-up and 2 timed steps a
   leg from one init: the ring gather (``zero_gather``) against plain
   stage 3 bit for bit and with its gather bytes, with qwZ against qwZ
   bit for bit, each ring leg serving gathers from posted rings; qwZ,
   qgZ, the ring with qwZ and the three modes (qwZ, hpZ 2, qgZ) apart
   from plain stage 3 but within the CPU tests' tolerances of it (losses
   5e-4 relative, each leaf's move 0.25, the key bias 1e-2), qwZ's
   gathers about half plain's bytes; each leg's modes as its keys name
   them; then hpZ 2 at DP 4 in train_dp_tp_parity's four ranks, bit for bit
   flat stage 3 at DP 4; each leg's step ms, unit gathers, bytes handed
   to ``torch.distributed`` and peak GB a step, and the flash and Adam
   launches;

then one ``kernels`` line (the Adam and LAMB rows at the bf16-moment
variant the main paths run) and, last, ``{"ok": true, "device":
{...}}``.
``python3 chip_smoke.py --tp-nccl`` (four cards) runs, after the build,
only the NCCL mode: TP 2 and TP 4 with one rank per card, each site's
ring op against the unfused collective + torch.matmul, and the train_tp
step on both backends, then DP 2 x TP 2 at ZeRO stage 3 against stage 2
at gpt2_medium full depth (stage 3's units gathered by the ring,
``zero_gather``'s default; step ms, the NCCL and ring kernels' ms a
step; ``tp_nccl_zero3``); ``--pp-nccl`` (four cards) runs train_pipe at
full depth over NCCL as PP 4, PP 2 x DP 2 (ZeRO-2 and ZeRO-3) and PP 2 x
TP 2 (ZeRO-1, the ring GEMMs), with each rank's busy share and the NCCL
send/recv kernels' time a step, holds PP 2 x DP 2 against the dense DP 4
engine on the same global batch and its ZeRO-3 run against its ZeRO-2
run (``pp_nccl_zero3``); ``--dp-nccl`` (four cards) runs train_dp at DP 4
and at DP 2 x TP 2 with one rank per card, then resumes a DP 4 tag at
DP 2 x TP 2 (``dp_nccl_ckpt``), then ``dp_nccl_zero3``: gpt2_xl at
full depth, DP 4, stage 2, stage 3 and stage 3 with ``cpu_offload`` from
one init (step ms, each rank's peak and parameter bytes, the all-gather
and reduce-scatter kernel ms a step), stage 3 held to stage 2 and the
offload run to stage 3 (losses, the whole masters), then the ZeRO++
legs (qwZ, qgZ, the ring gather with and without qwZ, the three modes
with hpZ 2) against stage 3: step ms, the NCCL all-gather,
reduce-scatter and send/recv kernel ms, the bytes handed over and the
peak a step; ``--comm-nccl``
(four cards) trains gpt2_medium at full depth at DP 4, one rank per
card: the example's config with the fp32 exchange (the reference run),
with ``quantized_collectives`` flat and with ``hierarchical: 2``, and
OneBitAdam (train_onebit's block at stage 0, ``freeze_step`` 3, 3
frozen steps), each with its step ms, the NCCL kernels' ms a step, the
bytes a step by formula and by count and its losses against the
reference run's.
Weights are random, from a seed; nothing is downloaded. Exits non-zero
without a result when CUDA is unavailable.
"""
import functools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
L2_FLUSH_BYTES = 512 * 2 ** 20   # > the 50 MB L2, and covers launch latency
SERVE_LAYERS = 24                # gpt2_medium depth
# the depth train_tp, train_dp and train_ckpt run at on one card (of
# gpt2_medium's 24), so that the script stays inside its time limit; the
# four-card modes run them at full depth
ONE_CARD_LAYERS = 6
# train_onebit and train_qc's depth (the script's time limit)
COMM_ONE_CARD_LAYERS = 4


T0 = time.perf_counter()


@functools.lru_cache(maxsize=2)
def _init_tree(vocab, seq, layers, d_model, seed):
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.init_params(gpt2.GPT2Config(
        vocab_size=vocab, max_seq_len=seq, n_layers=layers,
        d_model=d_model), seed=seed)


def seeded_gpt2(cfg, seed):
    """``gpt2.make_gpt2_model(config=cfg, seed=seed)``: the same weights
    (the seeded numpy draws of ``init_params``, which depend only on the
    vocabulary, sequence, depth and width), the draws kept for the next
    model of that shape in this process (they take seconds at gpt2_medium
    size, and the phases build the same shape again and again)."""
    from deepspeed_tpu_torch.models import gpt2
    model = gpt2.GPT2Model(cfg)
    model.load_state_dict(gpt2.params_from_jax(_init_tree(
        cfg.vocab_size, cfg.max_seq_len, cfg.n_layers, cfg.d_model, seed)))
    return model


def emit(obj):
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush, reps=25):
    """Median device time of one ``fn()`` call by CUDA events, the L2
    cache flushed before each call."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernel case


def paged_case(s, seed, device, live=None, h=16, full_valid=False):
    """The serving path's paged-attention shapes: 16 slots, 16 heads
    (``h`` 8: a rank's heads under TP 2), d_head 64, pages of 16 tokens,
    the full gpt2_medium pool (1024 usable pages + garbage page 0, 24
    layers) in bf16, 64 pages per table. Lengths spread to 1023 so
    windows cross page boundaries (``live``: every slot at that many
    keys with its s queries); garbage page 0 and every unallocated page
    are NaN. With s > 1 the valid lengths are padded (some slots have
    fewer real queries than s) unless ``full_valid`` (the speculative
    verify step: all k + 1 queries real)."""
    import torch
    b, dh, ps, max_pages, layers, usable = 16, 64, 16, 64, 24, 1024
    rng = np.random.RandomState(seed)
    positions = np.linspace(0, max_pages * ps - s, b).round().astype(np.int32)
    if live is not None:
        positions = np.full(b, live - s, np.int32)
    valid_lens = np.full(b, s, np.int32)
    if s > 1 and not full_valid:
        valid_lens = rng.randint(1, s + 1, size=b).astype(np.int32)
        valid_lens[0] = s
    page_tables = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, usable + 1)))
    for i in range(b):
        need = -(-(int(positions[i]) + s) // ps)
        page_tables[i, :need] = [free.pop() for _ in range(need)]
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (usable + 1, layers, h, ps, dh)
    k_pool = torch.randn(shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
    dead = torch.ones(usable + 1, dtype=torch.bool, device=device)
    dead[torch.from_numpy(page_tables[page_tables > 0]).long().to(device)] = \
        False
    k_pool[dead] = float("nan")
    v_pool[dead] = float("nan")
    q = torch.randn((b, s, h, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    as_dev = lambda a: torch.from_numpy(a).to(device)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool,
                page_tables=as_dev(page_tables), positions=as_dev(positions),
                valid_lens=as_dev(valid_lens), page_size=ps)


def paged_bound_ms(case):
    """Least time for the work this case's data needs: each live K/V row
    read once, q read once, the fp32 context written once; 4 flops per
    (query, live key, d) for QK^T and PV."""
    q = case["q"]
    b, s, h, dh = q.shape
    live = (case["positions"] + case["valid_lens"]).long().cpu().numpy()
    n_keys = int(np.minimum(live, case["page_tables"].shape[1] *
                            case["page_size"]).sum())
    elem = case["k_pool"].element_size()
    nbytes = (2 * n_keys * h * dh * elem + q.numel() * elem +
              q.numel() * 4 + case["page_tables"].numel() * 4 + 2 * b * 4)
    flops = 4 * s * n_keys * h * dh
    return bound_ms(nbytes, flops, FP32_FLOPS_PER_S)


def bound_ms(nbytes, flops, flops_per_s):
    """(ms, "bytes" | "operations"): the larger of the bytes' time at the
    card's memory rate and the operations' time at ``flops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def paged_library_ms(case, flush):
    """Yardstick: scaled_dot_product_attention over the case's rows
    gathered into contiguous memory beforehand (the gather itself is
    excluded), each query's causal live window as a boolean mask."""
    import torch
    import torch.nn.functional as F
    device = case["q"].device
    b, s, h, dh = case["q"].shape
    index = case["page_tables"].long()
    rows_of = lambda pool: torch.nan_to_num(pool[:, 0][index]).permute(
        0, 2, 1, 3, 4).reshape(b, h, -1, dh).contiguous()
    k_rows, v_rows = rows_of(case["k_pool"]), rows_of(case["v_pool"])
    live = (case["positions"] + case["valid_lens"] - 1).long()
    q_pos = torch.minimum(case["positions"].long()[:, None] +
                          torch.arange(s, device=device)[None, :],
                          live[:, None])                          # (b, s)
    mask = (torch.arange(k_rows.shape[2], device=device)[None, None, :] <=
            q_pos[:, :, None])[:, None]
    qh = case["q"].transpose(1, 2).contiguous()
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, k_rows, v_rows, attn_mask=mask), flush)


PAGED_CHECKS = ((1, 16), (4, 16), (5, 16), (1, 8), (5, 8))   # (s, heads)
# the speculative verify step (s = k + 1 = 5) and TP 2's heads a rank
PAGED_NEW_SHAPES = (("s5_h16_live512", 5, 16, 512),
                    ("s5_h16_live1024", 5, 16, 1024),
                    ("s1_h8_kernel_case", 1, 8, None),
                    ("s5_h8_live1024", 5, 8, 1024))


def phase_kernel(flush):
    """paged_attention vs paged_attention_reference on the card; two runs
    bit for bit; at the decode shape (s 1), a padded s 4, the speculative
    verify width s 5 (k = 4) and TP 2's 8 heads a rank. Timed at the
    decode shape of the path and with every slot at 64, 512 and 1024
    live keys; the verify shape at 512 and 1024 live keys and the 8-head
    shapes beside SDPA and the bound."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)
    from deepspeed_tpu_torch.ops.paged_attention.paged_attention import \
        launch_plan
    device = torch.device("cuda", 0)
    max_err, checks, repeat_equal = 0.0, [], True
    for s, h in PAGED_CHECKS:
        case = paged_case(s, seed=s + 16 - h, device=device, h=h,
                          full_valid=s == 5)
        for layer in (0, SERVE_LAYERS - 1):
            args = (case["q"], case["k_pool"], case["v_pool"],
                    case["page_tables"], case["positions"],
                    case["valid_lens"])
            kw = dict(layer_idx=layer, page_size=case["page_size"])
            got = paged_attention(*args, **kw)
            again = paged_attention(*args, **kw)
            want = paged_attention_reference(*args, **kw)
            torch.cuda.synchronize()
            repeat_equal = repeat_equal and torch.equal(got, again)
            # valid query rows only: a padded row's reference output reads
            # past the live window by design
            vl = case["valid_lens"].cpu().numpy()
            rows = torch.zeros(got.shape[:2], dtype=torch.bool,
                               device=device)
            for i, n in enumerate(vl):
                rows[i, :n] = True
            g, w = got[rows], want[rows]
            assert not torch.isnan(g).any(), "NaN in a live kernel row"
            assert torch.isfinite(w).all(), "non-finite reference row"
            err = float((g - w).abs().max())
            checks.append({"s": s, "heads": h, "layer": layer,
                           "max_abs_err": err})
            max_err = max(max_err, err)
    assert max_err <= 2e-5, "paged_attention off its plain version by " \
        "{} > 2e-5".format(max_err)
    assert repeat_equal, "two paged_attention runs differ"

    # times at the decode shape of the path (s = 1), then the sweep
    timed = {}
    for name, live in (("kernel_case", None), ("all_64", 64),
                       ("all_512", 512), ("all_1024", 1024)):
        case = paged_case(1, seed=1, device=device, live=live)
        args = (case["q"], case["k_pool"], case["v_pool"],
                case["page_tables"], case["positions"], case["valid_lens"])
        kw = dict(layer_idx=0, page_size=case["page_size"])
        bound = paged_bound_ms(case)
        timed[name] = {
            "kernel_ms": time_ms(lambda: paged_attention(*args, **kw), flush),
            "library_ms": paged_library_ms(case, flush),
            "bound_ms": bound[0], "bound_by": bound[1]}
        if live is None:
            timed[name]["plain_ms"] = time_ms(
                lambda: paged_attention_reference(*args, **kw), flush)
    new_shapes = {}
    for name, s, h, live in PAGED_NEW_SHAPES:
        shape_case = paged_case(s, seed=1, device=device, live=live, h=h,
                                full_valid=True)
        args = (shape_case["q"], shape_case["k_pool"], shape_case["v_pool"],
                shape_case["page_tables"], shape_case["positions"],
                shape_case["valid_lens"])
        kw = dict(layer_idx=0, page_size=shape_case["page_size"])
        bound = paged_bound_ms(shape_case)
        new_shapes[name] = {
            "s": s, "heads": h, "live": live,
            "kernel_ms": time_ms(lambda: paged_attention(*args, **kw), flush),
            "plain_ms": time_ms(
                lambda: paged_attention_reference(*args, **kw), flush),
            "library_ms": paged_library_ms(shape_case, flush),
            "bound_ms": bound[0], "bound_by": bound[1]}
        del shape_case, args
    b, _, h, dh = case["q"].shape
    chunk, rounds, splits = launch_plan(case["q"].element_size(), dh,
                                        case["page_tables"].shape[1] *
                                        case["page_size"])
    row = timed.pop("kernel_case")
    return {"phase": "kernel", "name": "paged_attention", "checks": checks,
            "max_abs_err": max_err, "tolerance": 2e-5,
            "repeat_bit_equal": repeat_equal, **row,
            "sweep_every_slot_at": timed,
            "verify_and_tp_shapes": new_shapes,
            "launch": {"splits": splits, "keys_a_round": chunk,
                       "rounds_a_split": rounds,
                       "blocks": b * h * splits},
            "library_call": "F.scaled_dot_product_attention over pre-gathered "
                            "contiguous rows, gather excluded",
            "shape": {"slots": b, "heads": h, "d_head": dh, "page_size": 16,
                      "max_pages": 64, "pool_dtype": "bf16", "s": 1}}


# ------------------------------------------------ flash attention and Adam


FLASH_SHAPE = dict(b=16, s=1024, h=16, d=64)     # the train path's
BERT_FLASH_SHAPE = dict(b=32, s=512, h=16, d=64)  # the train_bert path's
# Per element, |kernel - plain| <= 2**-7 * |plain| + atol: one bf16 ulp of
# the plain value, plus a floor. The backward kernels round ds at the
# plain version's points, so their floor is ~0; out's floor is one ulp at
# |out| in [0.25, 0.5), where a reordered fp32 sum may round the other way.
FLASH_TOL = {"ulp_rel": 2 ** -7, "out_atol": 2 ** -9, "grad_atol": 1e-6,
             "lse": 1e-4}


def flash_case(device, shape=FLASH_SHAPE, seed=0):
    """A path's attention operands: q, k, v as the column blocks of one
    (b, s, 3 * h * d) bf16 QKV tensor (row stride 3 * h * d), as the
    layers' QKV projections produce them, and an output gradient."""
    import torch
    b, s, h, d = (shape[k] for k in "bshd")
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    dout = torch.randn((b, s, h * d), generator=gen, device=device,
                       dtype=torch.bfloat16)
    return q, k, v, dout


def flash_bound(q, h, mults, tensors, causal=True):
    """Least time for ``mults`` products per (query, key) pair over the
    pairs these inputs need (key <= query when causal, all pairs
    otherwise), at the bf16 tensor-core rate, against each of ``tensors``
    moved once."""
    b, s, hd = q.shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 2 * mults * pairs * (hd // h)
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    return bound_ms(nbytes, flops, BF16_FLOPS_PER_S)


def _ulp_ratio(got, want, atol):
    """max over elements of |got - want| / (2**-7 |want| + atol): at most
    1 when every element is within the per-element bound."""
    want = want.float()
    return float(((got.float() - want).abs() /
                  (FLASH_TOL["ulp_rel"] * want.abs() + atol)).max())


def flash_check_and_time(q, k, v, dout, bias, h, causal, flush):
    """The three flash kernels on packed (b, s, h * d) operands with an
    optional fp32 (b, s) key ``bias``: out, lse, dq, dk, dv held to the
    plain versions at FLASH_TOL, then each kernel timed beside its plain
    version, its bound and SDPA on contiguous (b, h, s, d) copies (the
    bias as a boolean key mask). Returns (errors, rows by kernel name)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    kw = dict(num_heads=h, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, bias, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, bias, **kw)
    delta = fa.attention_delta(out, dout, h)
    args = (q, k, v, bias, dout, lse, delta)
    dk, dv = fa.flash_bwd_dkdv(*args, **kw)
    dq = fa.flash_bwd_dq(*args, **kw)
    again = fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
    fwd_again = fa.flash_fwd(q, k, v, bias, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(*args, **kw)
    ref_dq = fa.flash_bwd_dq_reference(*args, **kw)
    torch.cuda.synchronize()
    abs_err = lambda a, b: float((a.float() - b.float()).abs().max())
    pairs = {"out": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk),
             "dv": (dv, ref_dv)}
    errs = {"lse": abs_err(lse, ref_lse)}
    for name, (got, want) in pairs.items():
        atol = FLASH_TOL["out_atol" if name == "out" else "grad_atol"]
        errs[name + "_abs"] = abs_err(got, want)
        errs[name + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
    errs["bwd_repeat_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(again, (dk, dv, dq)))
    errs["fwd_repeat_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(fwd_again, (out, lse)))
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t.float()).all(), "non-finite kernel output"
    assert errs["lse"] <= FLASH_TOL["lse"], errs
    assert max(errs[n + "_ulp_ratio"] for n in pairs) <= 1.0, errs
    assert errs["bwd_repeat_bit_equal"], "two backward runs differ"
    assert errs["fwd_repeat_bit_equal"], "two forward runs differ"
    del ref_out, ref_lse, ref_dk, ref_dv, ref_dq, again, fwd_again

    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, bias, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, bias, **kw)),
        "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*args, **kw),
                           lambda: fa.flash_bwd_dkdv_reference(*args, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*args, **kw),
                         lambda: fa.flash_bwd_dq_reference(*args, **kw)),
    }
    bounds = {
        "flash_fwd": flash_bound(q, h, 2, (q, k, v, bias, out, lse), causal),
        "flash_bwd_dkdv": flash_bound(q, h, 4, (q, k, v, bias, dout, lse,
                                                delta, dk, dv), causal),
        "flash_bwd_dq": flash_bound(q, h, 3, (q, k, v, bias, dout, lse,
                                              delta, dq), causal),
    }
    # yardstick: scaled_dot_product_attention on pre-transposed contiguous
    # (b, h, s, d) copies (the transposes excluded); its backward is its
    # forward + backward minus its forward, and computes dq, dk, dv at once
    heads = lambda t: t.reshape(t.shape[0], t.shape[1], h, -1).transpose(
        1, 2).contiguous()
    qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
    doh = heads(dout)
    keep = None if bias is None else (bias == 0)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep,
                                                  is_causal=causal)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa, flush)
    lib_fwd_bwd = time_ms(
        lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), flush)
    library = {"flash_fwd": lib_fwd,
               "flash_bwd_dkdv": lib_fwd_bwd - lib_fwd,
               "flash_bwd_dq": lib_fwd_bwd - lib_fwd}
    rows = {}
    for name, (kernel, plain) in times.items():
        rows[name] = {"kernel_ms": time_ms(kernel, flush),
                      "plain_ms": time_ms(plain, flush, reps=5),
                      "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1],
                      "library_ms": library[name]}
    return errs, rows


def phase_flash(flush):
    """The three flash kernels at the GPT-2 train path's shape (causal, no
    bias) against their plain versions, timed."""
    import torch
    h = FLASH_SHAPE["h"]
    q, k, v, dout = flash_case(torch.device("cuda", 0))
    errs, rows = flash_check_and_time(q, k, v, dout, None, h, True, flush)
    return {"phase": "kernel", "name": "flash_attention", "errors": errs,
            "tolerance": FLASH_TOL, "kernels": rows,
            "library_call": "F.scaled_dot_product_attention(is_causal=True) "
                            "on contiguous (b, h, s, d) copies; the "
                            "backward's time covers dq, dk and dv together",
            "shape": dict(FLASH_SHAPE, dtype="bf16", causal=True,
                          qkv_row_stride=3 * h * FLASH_SHAPE["d"])}


def phase_flash_bert(flush):
    """The three flash kernels in the BERT path's mode: non-causal with
    the fp32 (b, s) key bias the layer makes (``_expand_mask``) from the
    train_bert batch's padded mask, at BERT-large's attention shape, q/k/v
    strided as the layer's QKV projection gives them; held to the plain
    versions at FLASH_TOL and timed, then timed again without the bias at
    the same shape, so the bias's cost is a measured difference."""
    import torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer.transformer import _expand_mask
    device = torch.device("cuda", 0)
    h = BERT_FLASH_SHAPE["h"]
    cfg = bert.config_for("bert_large", max_seq_len=BERT_SEQ)
    keep = torch.from_numpy(bert_batch(cfg, BERT_MICRO, BERT_SEQ,
                                       seed=0)[2][0]).to(device)
    bias = _expand_mask(keep, torch.float32)[:, 0, 0, :].contiguous()
    q, k, v, dout = flash_case(device, BERT_FLASH_SHAPE, seed=1)
    errs, rows = flash_check_and_time(q, k, v, dout, bias, h, False, flush)
    kw = dict(num_heads=h, causal=False)
    out, lse = fa.flash_fwd(q, k, v, None, **kw)
    args = (q, k, v, None, dout, lse, fa.attention_delta(out, dout, h))
    no_bias = {"flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, None, **kw),
                                    flush),
               "flash_bwd_dkdv": time_ms(lambda: fa.flash_bwd_dkdv(*args,
                                                                   **kw),
                                         flush),
               "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args, **kw),
                                       flush)}
    for name, ms in no_bias.items():
        rows[name]["kernel_ms_without_bias"] = ms
    return {"phase": "flash_bert", "name": "flash_attention (BERT mode)",
            "errors": errs, "tolerance": FLASH_TOL, "kernels": rows,
            "valid_keys": int(keep.sum()), "keys": keep.numel(),
            "library_call": "F.scaled_dot_product_attention with the keep "
                            "mask as a boolean (b, 1, 1, s) attn_mask on "
                            "contiguous (b, h, s, d) copies; the backward's "
                            "time covers dq, dk and dv together",
            "shape": dict(BERT_FLASH_SHAPE, dtype="bf16", causal=False,
                          key_bias="fp32 (b, s), 0 / -1e9",
                          qkv_row_stride=3 * h * BERT_FLASH_SHAPE["d"])}


def _worst(got, want):
    """The element where |got - want| is largest: its index and both
    values, and the relative error max |got - want| / max |want|."""
    diff = (got.double() - want.double()).abs()
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    return {"index": [int(i) for i in at], "gpu": float(got[at]),
            "cpu": float(want[at]),
            "rel_err": float(diff.max() / want.double().abs().max())}


def _cpu_model():
    """The host CPU's model name (the CPU side of a parity check runs
    there)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


TRACE_OPS = ("S", "P", "l", "PV")


def _online_float64(arrays, mask, block=64):
    """The plain forward's online softmax over key tiles of ``block`` in
    float64 (non-causal, the key bias added): per tile S, P, the running
    row sums l and the running P.V, as ``flash_fwd_reference`` traces
    them in fp32."""
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


def _trace_report(traces, exact):
    """Per CPU run: each op's largest |fp32 - float64| over the tiles
    (S over the unmasked keys: a masked score is -1e9 in both), and the
    first (tile, op) whose values differ from CPU run 1's, bit for bit."""
    import torch
    report = []
    for run in traces:
        errs = {}
        for op in TRACE_OPS:
            worst = 0.0
            for tile, want in zip(run, exact):
                want = want[op]
                diff = np.abs(tile[op].double().numpy() - want)
                if op == "S":
                    diff = np.where(want > -1e8, diff, 0.0)
                worst = max(worst, float(diff.max()))
            errs[op] = worst
        first = None
        for i, (tile, ref) in enumerate(zip(run, traces[0])):
            for op in TRACE_OPS:
                if first is None and not torch.equal(tile[op], ref[op]):
                    first = "tile {} {}".format(i, op)
        report.append({"max_abs_err_vs_float64": errs,
                       "first_differing_from_run_1": first})
    return report


def flash_fp32_case():
    """The fp32 key-mask case of tests/test_torch_cuda.py (b 2, s 96, h 2,
    d 32, 25% of keys masked by -1e9): q, k, v, dout and the mask."""
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 96, 2, 32
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    mask = np.where(rng.rand(b, s) < 0.25, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    return arrays, mask


def flash_fp32_run(arrays, mask, dev, trace=None):
    """Forward and backward of the case through flash_attention_bshd on
    ``dev``; ``trace`` (a list) gets the CPU plain forward's per-tile
    intermediates. Returns (out, dq, dk, dv) on the CPU."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
               for a in arrays[:3])
    plain = fa.flash_fwd_reference
    if trace is not None:
        fa.flash_fwd_reference = lambda *a, **kw: plain(*a, trace=trace,
                                                        **kw)
    try:
        out = fa.flash_attention_bshd(
            q, k, v, causal=False, mask_bias=torch.from_numpy(mask).to(dev))
    finally:
        fa.flash_fwd_reference = plain
    out.backward(torch.from_numpy(arrays[3]).to(dev))
    return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]


def phase_flash_fp32_repeats(repeats=60):
    """The fp32 key-mask case of tests/test_torch_cuda.py::
    test_flash_attention_bshd_mask_bias_grads_match_plain (b 2, s 96, h 2,
    d 32, 25% of keys masked by -1e9), forward and backward through the
    kernels ``repeats`` times and on the CPU (the plain versions) 5 times:
    every GPU run bit-identical to the first, every CPU run too, and the
    worst element of each output against the CPU run printed with both
    sides' values, and each run's out against a float64 evaluation, batch
    by batch (the distinct values over the GPU runs, one a CPU run); each
    CPU run's forward intermediates (S, P, the row sums l, P.V, per key
    tile) against float64 and against CPU run 1, so a run that leaves
    the exact value names the op; held to the test's 1e-5."""
    import torch
    arrays, mask = flash_fp32_case()
    b, s, h, d = arrays[0].shape
    gpu = [flash_fp32_run(arrays, mask, torch.device("cuda", 0))
           for _ in range(repeats)]
    traces = [[] for _ in range(5)]
    cpu = [flash_fp32_run(arrays, mask, torch.device("cpu"), trace=t)
           for t in traces]
    names = ("out", "dq", "dk", "dv")
    gpu_varies = {n: sum(not torch.equal(r[i], gpu[0][i]) for r in gpu[1:])
                  for i, n in enumerate(names)}
    cpu_varies = {n: sum(not torch.equal(r[i], cpu[0][i]) for r in cpu[1:])
                  for i, n in enumerate(names)}
    worst = {n: max((_worst(r[i], cpu[0][i]) for r in gpu),
                    key=lambda w: w["rel_err"])
             for i, n in enumerate(names)}
    rel = max(w["rel_err"] for w in worst.values())
    tiles = _online_float64(arrays, mask)
    # out in float64, to tell which side a run that differs has left
    exact = torch.from_numpy(np.transpose(
        tiles[-1]["PV"] / tiles[-1]["l"], (0, 2, 1, 3)))

    def per_batch(out):
        return tuple(float(e) for e in
                     (out.double() - exact).abs().amax(dim=(1, 2, 3)))

    out_vs_float64 = {"gpu_runs": sorted({per_batch(r[0]) for r in gpu}),
                      "cpu_runs": [per_batch(r[0]) for r in cpu]}
    result = {"phase": "flash_fp32_repeats", "repeats": repeats,
              "shape": {"b": b, "s": s, "h": h, "d": d, "dtype": "fp32",
                        "key_mask": "25% of keys -1e9"},
              "gpu_runs_differing_from_the_first": gpu_varies,
              "cpu_runs_differing_from_the_first": cpu_varies,
              "worst_vs_cpu": worst, "max_rel_err": rel, "tolerance": 1e-5,
              "out_max_abs_err_vs_float64": out_vs_float64,
              "cpu_intermediates": _trace_report(traces, tiles),
              "cpu": {"model": _cpu_model(),
                      "capability": torch.backends.cpu.get_cpu_capability(),
                      "threads": torch.get_num_threads()}}
    assert not any(gpu_varies.values()), result
    assert not any(cpu_varies.values()), result
    assert rel <= 1e-5, result
    return result


# The fp16 cases (b, h, d, s, causal, q and k scale): probes/kernel_probe.py
# fp16_backward's, and one with q and k scaled by 3 so that P and dS fall
# into fp16's subnormal range and below its rounding to 0 (2**-25).
FP16_CASES = [(2, 3, d, s, causal, 1.0) for d in (32, 128) for s in (96, 1000)
              for causal in (True, False)] + \
    [(2, 2, 64, 333, causal, 3.0) for causal in (True, False)]


def fp16_case(device, b, h, d, s, qk_scale=1.0):
    """fp16 q, k, v (column blocks of one QKV tensor), dout and a key bias
    dropping 20% of keys (-1e9) and shifting the others, from numpy's
    generator seeded with s + d (the probe's and the GPU tests' recipe)."""
    import torch
    rng = np.random.RandomState(s + d)
    to = lambda a: torch.from_numpy(a).to(device, torch.float16)
    qkv = to(rng.randn(b, s, 3 * h * d).astype(np.float32))
    q, k, v = qkv.split(h * d, -1)
    dout = to(rng.randn(b, s, h * d).astype(np.float32))
    bias = rng.randn(b, s).astype(np.float32)
    bias[rng.rand(b, s) < 0.2] = -1e9
    bias[:, 0] = 0.0
    q.mul_(qk_scale)    # in place: q, k, v stay column blocks of one tensor
    k.mul_(qk_scale)
    return q, k, v, dout, torch.from_numpy(bias).to(device)


def phase_flash_fp16():
    """fp16 on the tensor-core kernels: forward, dk/dv and dq against their
    plain versions at FP16_CASES, each output per element within one fp16
    ulp of the plain value plus 1e-6 (the gradients) or eps / 4 (out), lse
    within 1e-4, with the share of the pairs whose P or dS is an fp16
    subnormal."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    device = torch.device("cuda", 0)
    eps = torch.finfo(torch.float16).eps
    ratio = lambda got, want, atol: float(
        ((got.float() - want.float()).abs() /
         (eps * want.float().abs() + atol)).max())
    cases, worst = [], 0.0
    for b, h, d, s, causal, qk_scale in FP16_CASES:
        q, k, v, dout, bias = fp16_case(device, b, h, d, s, qk_scale)
        kw = dict(num_heads=h, causal=causal)
        out, lse = fa.flash_fwd(q, k, v, bias, **kw)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, bias, **kw)
        delta = fa.attention_delta(out, dout, h)
        args = (q, k, v, bias, dout, lse, delta)
        got = fa.flash_bwd_dkdv(*args, **kw) + (fa.flash_bwd_dq(*args, **kw),)
        want = fa.flash_bwd_dkdv_reference(*args, **kw) + \
            (fa.flash_bwd_dq_reference(*args, **kw),)
        _, _, _, p, ds = fa._bwd_terms(q, k, v, bias, dout, lse, delta, h,
                                       causal, d ** -0.5)
        torch.cuda.synchronize()
        sub = lambda t: float(((t != 0) & (t.float().abs() < 2 ** -14))
                              .float().mean())
        row = {"b": b, "h": h, "d": d, "s": s, "causal": causal,
               "qk_scale": qk_scale, "lse_abs": float((lse - ref_lse).abs()
                                                     .max()),
               "out_ulp_ratio": ratio(out, ref_out, eps / 4),
               "subnormal_share": {"p": sub(p.half()), "ds": sub(ds)}}
        for name, g, w in zip(("dk", "dv", "dq"), got, want):
            assert torch.isfinite(g.float()).all(), (row, name)
            row[name + "_ulp_ratio"] = ratio(g, w, 1e-6)
        cases.append(row)
        worst = max(worst, row["out_ulp_ratio"], row["dk_ulp_ratio"],
                    row["dv_ulp_ratio"], row["dq_ulp_ratio"])
        assert row["lse_abs"] <= FLASH_TOL["lse"], row
        del p, ds, got, want
    result = {"phase": "flash_fp16", "cases": cases, "worst_ulp_ratio": worst,
              "bound": "one fp16 ulp of the plain value + 1e-6 (dq, dk, dv) "
                       "or + eps / 4 (out); lse 1e-4"}
    assert worst <= 1.0, result
    return result


def phase_flash3d(flush):
    """Rows 5/6: the JAX package's 3D API, (b * h, s, d) operands on the
    packed kernels with one head, at BERT-large's attention shape, causal
    and not. The 3D op (forward, then its backward through autograd)
    equals direct kernel calls bit for bit; the kernels hold to their
    plain versions at FLASH_TOL; each timed, with SDPA on the same memory
    viewed (b, h, s, d) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    device = torch.device("cuda", 0)
    b, h, s, d = 32, 16, 512, 64
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, dout = (torch.randn((b * h, s, d), generator=gen, device=device,
                                 dtype=torch.bfloat16) for _ in range(4))
    modes = {}
    for causal in (True, False):
        kw = dict(num_heads=1, causal=causal)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out3 = fa.flash_attention(qq, kk, vv, causal=causal)
        out3.backward(dout)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        dq, dk, dv = fa.flash_bwd(q, k, v, None, out, dout, lse, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in (
            (out3.detach(), out), (qq.grad, dq), (kk.grad, dk),
            (vv.grad, dv)))
        assert same, "the 3D op differs from direct kernel calls"
        delta = fa.attention_delta(out, dout, 1)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
        ref_dq = fa.flash_bwd_dq_reference(q, k, v, None, dout, lse, delta,
                                           **kw)
        ref_dk, ref_dv = fa.flash_bwd_dkdv_reference(q, k, v, None, dout,
                                                     lse, delta, **kw)
        abs_err = lambda a, b_: float((a.float() - b_.float()).abs().max())
        pairs = {"out": (out, ref_out), "dq": (dq, ref_dq),
                 "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
        errs = {"lse": abs_err(lse, ref_lse)}
        for name, (got, want) in pairs.items():
            atol = FLASH_TOL["out_atol" if name == "out" else "grad_atol"]
            errs[name + "_abs"] = abs_err(got, want)
            errs[name + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
        for t in (out, lse, dq, dk, dv):
            assert torch.isfinite(t.float()).all(), "non-finite kernel output"
        assert errs["lse"] <= FLASH_TOL["lse"], errs
        assert max(errs[n + "_ulp_ratio"] for n in pairs) <= 1.0, errs
        del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, qq, kk, vv, out3

        pairs_n = b * h * (s * (s + 1) // 2 if causal else s * s)
        nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=causal), flush)
        plain_fwd = time_ms(lambda: fa.flash_fwd_reference(q, k, v, **kw),
                            flush, reps=5)
        dkdv_ms = time_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, None, dout, lse, delta, **kw), flush)
        dq_ms = time_ms(lambda: fa.flash_bwd_dq(
            q, k, v, None, dout, lse, delta, **kw), flush)
        plain_bwd = time_ms(lambda: (
            fa.flash_bwd_dkdv_reference(q, k, v, None, dout, lse, delta, **kw),
            fa.flash_bwd_dq_reference(q, k, v, None, dout, lse, delta, **kw)),
            flush, reps=5)
        view = lambda t: t.view(b, h, s, d)
        qh, kh, vh = (view(t).detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=causal)
        with torch.no_grad():
            lib_fwd = time_ms(sdpa, flush)
        lib_both = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qh, kh, vh), view(dout)), flush)
        modes["causal" if causal else "non_causal"] = {
            "errors": errs, "same_as_direct_calls": same,
            "fwd": {"kernel_ms": fwd_ms, "plain_ms": plain_fwd,
                    "library_ms": lib_fwd,
                    "bound": bound_ms(nbytes(q, k, v, out, lse),
                                      2 * 2 * pairs_n * d, BF16_FLOPS_PER_S)},
            "bwd": {"kernel_ms": dkdv_ms + dq_ms, "dkdv_ms": dkdv_ms,
                    "dq_ms": dq_ms, "plain_ms": plain_bwd,
                    "library_ms": lib_both - lib_fwd,
                    "bound": bound_ms(nbytes(q, k, v, dout, lse, delta, dq,
                                             dk, dv),
                                      2 * 5 * pairs_n * d, BF16_FLOPS_PER_S)}}
        del out, lse, dq, dk, dv, delta
    return {"phase": "flash3d", "name": "flash_attention (3D)",
            "shape": {"batch_heads": b * h, "seq": s, "d_head": d,
                      "dtype": "bf16"},
            "tolerance": FLASH_TOL, "modes": modes,
            "library_call": "F.scaled_dot_product_attention on the same "
                            "memory viewed (b, h, s, d); backward = fwd+bwd "
                            "minus fwd, dq, dk, dv together"}


def phase_adam(flush):
    """The Adam kernel against its plain version over one flat fp32
    buffer of GPT-2-350M's parameter count, with fp32 moments and with
    bf16 moments (the train path's, ``moments_dtype: "bf16"``), timed;
    bit-exact. The bound counts each variant's bytes: fp32 moments read
    p, g, m, v and write p, m, v (28 bytes an element), bf16 moments 20."""
    import torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.adam.fused_adam import (
        bias_corrections, fused_adam, fused_adam_reference)
    device = torch.device("cuda", 0)
    n = gpt2.num_params(gpt2.config_for("gpt2_medium"))
    gen = torch.Generator(device=device).manual_seed(3)
    new = lambda: torch.randn(n, generator=gen, device=device)
    g = new()
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              bc1=bc1, bc2=bc2)
    step = torch.tensor(7.0, device=device)
    variants = {}
    for moments, dtype, nbytes in (("fp32", torch.float32, 28),
                                   ("bf16", torch.bfloat16, 20)):
        p, m, v = new(), new() * 1e-2, new().abs_() * 1e-4
        m, v = m.to(dtype), v.to(dtype)
        copies = [[t.clone() for t in (p, m, v)] for _ in range(2)]
        fused_adam(copies[0][0], g, copies[0][1], copies[0][2], **kw)
        fused_adam_reference(copies[1][0], g, copies[1][1], copies[1][2],
                             **kw)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(*copies))
        equal = all(torch.equal(a, b) for a, b in zip(*copies))
        assert equal and err == 0.0, \
            "fused_adam ({} moments) off its plain version by {}".format(
                moments, err)
        del copies
        kernel_ms = time_ms(lambda: fused_adam(p, g, m, v, **kw), flush)
        plain_ms = time_ms(lambda: fused_adam_reference(p, g, m, v, **kw),
                           flush, reps=5)
        library_ms, library_call = None, None
        try:
            fn = lambda: torch._fused_adam_(
                [p], [g], [m], [v], [], [step], lr=1e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False)
            fn()
            library_ms = time_ms(fn, flush)
            library_call = "torch._fused_adam_ over the same flat tensors"
        except (RuntimeError, TypeError) as exc:
            library_call = "none: torch._fused_adam_ refuses {} moments " \
                "with fp32 params ({})".format(moments, str(exc)[:120])
        b_ms, b_by = bound_ms(nbytes * n, 18 * n, FP32_FLOPS_PER_S)
        variants[moments] = {
            "max_abs_err": err, "bit_equal": equal, "tolerance": 0.0,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes_per_element": nbytes,
            "library_ms": library_ms, "library_call": library_call}
        del p, m, v
        torch.cuda.empty_cache()
    return {"phase": "kernel", "name": "fused_adam", "elements": n,
            "variants": variants}


# ------------------------------------------------------------ training path


# bench.py:96-140's first rung, (20, False, True): micro 20, remat off,
# bf16 moments and a bf16 gradient accumulator; its "runtime.executor" and
# "telemetry" sections are left out (the port has neither yet)
TRAIN_MICRO, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 20, 1024, 2, 10
TRAIN_REMAT = False
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                             "moments_dtype": "bf16",
                                             "fused_kernel": "auto"}},
    "data_types": {"grad_accum_dtype": "bf16"},
    "transformer": {"flash_attention": "auto"},
    "steps_per_print": 10 ** 9,
}


def phase_train(launch_counters):
    """The training main path at bench.py's first rung: gpt2_medium at
    full width and depth, seq 1024, micro 20, bf16, ZeRO-2, Adam with bf16
    moments and a bf16 gradient accumulator, remat off, through the
    port's initialize(...).train_batch(...) on one fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT)
    assert cfg.n_layers == 24 and cfg.d_model == 1024
    t0 = time.perf_counter()
    model = seeded_gpt2(cfg, 0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=TRAIN_CONFIG)
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert engine.flash_attention_backend == "pallas", \
        engine.flash_attention_backend
    assert engine.fused_optimizer_kernel == "pallas", \
        engine.fused_optimizer_kernel
    flat = engine.flat
    assert flat.exp_avg.dtype == flat.acc.dtype == torch.bfloat16
    # fp32 -> bf16 moments save 2 x 2 bytes an element, the accumulator 2
    saved = {"moments_gb": 4 * flat.numel / 2 ** 30,
             "grad_accumulator_gb": 2 * flat.numel / 2 ** 30}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, TRAIN_MICRO, TRAIN_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    assert launches["fused_adam"] == TRAIN_STEPS, launches
    assert engine.flat.check_views()
    step_s = wall / TRAIN_STEPS
    tokens = TRAIN_MICRO * TRAIN_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        TRAIN_SEQ                                      # bench.py's formula
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch, kernel_groups=FLASH_GROUPS)
    return {"phase": "train", "model": "gpt2_medium", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "seq": TRAIN_SEQ,
            "micro_batch": TRAIN_MICRO, "dtype": "bf16", "zero_stage": 2,
            "moments": "bf16", "grad_accum": "bf16",
            "memory_saved_vs_fp32_state": saved, "remat": TRAIN_REMAT,
            "params": n_params,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "mfu": mfu, "mfu_peak": "989 TFLOP/s dense bf16",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


# the flash kernels' device names (profile groups of the train phases)
FLASH_GROUPS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")


def train_profile(engine, batch, steps=2, span_names=(), kernel_groups=()):
    """Where a training step's time goes: ``steps`` train_batch calls
    under torch.profiler (device busy share, launches per step and the
    costliest kernels). ``span_names``: record_function spans whose host
    time a step is reported; ``kernel_groups``: substrings of kernel
    names whose device time a step is summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device activity only: a record_function span (the hop spans, gloo's
    # own) also has a device-side event covering what it launched, which
    # the profiler marks as a user annotation and which is no work
    device = lambda e: e.device_type == torch.autograd.DeviceType.CUDA \
        and not e.is_user_annotation
    averages = prof.key_averages()
    kernels = [e for e in averages if device(e)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # idle time between consecutive device activities, and the host's
    # time blocked on a full launch queue (the device is then the limit)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if device(e))
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    blocked = sum(e.self_cpu_time_total for e in averages
                  if e.key == "Command Buffer Full")
    extra = {}
    if span_names:
        extra["host_ms_per_step_in_spans"] = {
            name: sum(e.cpu_time_total for e in averages if e.key == name) *
            1e-3 / steps for name in span_names}
    if kernel_groups:
        by_group = {
            g: sum(e.self_device_time_total for e in kernels if g in e.key) *
            1e-3 / steps for g in kernel_groups}
        extra["kernel_ms_per_step_by_group"] = by_group
        extra["groups_share_of_step"] = sum(by_group.values()) * 1e-3 / \
            (wall / steps)
    return {"steps": steps, "wall_s_per_step": wall / steps, **extra,
            "device_busy_s_per_step": busy_us * 1e-6 / steps,
            "device_busy_share": busy_us * 1e-6 / wall,
            "device_gaps_ms_per_step": sum(gaps) * 1e-3 / steps,
            "device_gaps_over_200us_ms_per_step":
                sum(g for g in gaps if g > 200) * 1e-3 / steps,
            "host_blocked_on_full_queue_ms_per_step": blocked * 1e-3 / steps,
            "kernel_launches_per_step": sum(e.count for e in kernels) /
            steps,
            "top_kernels": [{"name": e.key[:80],
                             "ms_per_step": e.self_device_time_total * 1e-3 /
                             steps,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def phase_train_parity(steps=5, tol=1e-4):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, TF32
    off: the kernels ("pallas", "pallas") against the plain versions
    ("xla", "xla"), from the same init, with fp32 and with bf16 Adam
    moments."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    runs, rel = {}, {}
    for moments in ("fp32", "bf16"):
        for backend in ("pallas", "xla"):
            cfg = gpt2.config_for("gpt2_medium", n_layers=2,
                                  max_seq_len=TRAIN_SEQ, loss_chunk=128,
                                  remat=False)
            model = seeded_gpt2(cfg, 1)
            engine = deepspeed_tpu_torch.initialize(
                model=model, config_params={
                    "train_micro_batch_size_per_gpu": 4,
                    "optimizer": {"type": "Adam", "params": {
                        "lr": 1e-4, "fused_kernel": backend,
                        "moments_dtype": moments}},
                    "transformer": {"flash_attention": backend},
                    "steps_per_print": 10 ** 9})[0]
            assert engine.flash_attention_backend == backend
            assert engine.flat.exp_avg.dtype == getattr(
                torch, {"fp32": "float32", "bf16": "bfloat16"}[moments])
            runs["{}/{}".format(moments, backend)] = [
                float(engine.train_batch(batch=(ids, ids)))
                for _ in range(steps)]
            del engine, model
            torch.cuda.empty_cache()
        rel[moments] = max(
            abs(a - b) / abs(b) for a, b in zip(
                runs[moments + "/pallas"], runs[moments + "/xla"]))
        assert rel[moments] <= tol, (moments, rel, runs)
    return {"phase": "train_parity", "layers": 2, "d_model": 1024,
            "dtype": "fp32", "moments": ["fp32", "bf16"], "steps": steps,
            "losses": runs, "max_rel_diff": rel, "tolerance": tol}


EXAMPLE_CONFIG = "examples/gpt2/ds_config_zero2.json"
EXAMPLE_STEPS = 8


def phase_train_example(launch_counters):
    """The GPT-2 example's twin (deepspeed_tpu_torch/examples/
    gpt2_pretrain.py) on the repo's examples/gpt2/ds_config_zero2.json at
    gpt2_medium, seq 1024: bf16, ZeRO-2, Adam betas (0.9, 0.95), weight
    decay 0.1, clipping 1.0, WarmupDecayLR; fresh synthetic tokens each
    step, as the JAX example. Counts set to 0 just before main() and read
    just after; the learning rate of every step held to WarmupDecayLR's
    formula, written here; the loss falls: the first batch's loss after
    the run (eval mode; dropout is 0, so train and eval give the same
    loss) below its loss at step 0. The training losses themselves, each
    on a fresh random batch at a warm-up rate of at most ~4e-5 after step
    0, stay within noise of ln(vocab)."""
    import json
    import math
    import torch
    from deepspeed_tpu_torch.examples import gpt2_pretrain
    with open(EXAMPLE_CONFIG) as f:
        sched = json.load(f)["scheduler"]["params"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    res = gpt2_pretrain.main(["--size", "gpt2_medium", "--seq_len", "1024",
                              "--steps", str(EXAMPLE_STEPS),
                              "--deepspeed_config", EXAMPLE_CONFIG])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    engine = res["engine"]
    first = np.random.RandomState(0).randint(      # the twin's first batch
        0, engine.module.config.vocab_size, size=(8, 1024)).astype(np.int32)
    engine.eval()
    first_after = float(engine(first, first))
    lr0 = engine._config.optimizer_params["lr"]
    lo, hi = sched["warmup_min_lr"], sched["warmup_max_lr"]
    warm = max(2, sched["warmup_num_steps"])
    want = [lr0] + [lo + (hi - lo) * math.log(i + 1) / math.log(warm)
                    for i in range(EXAMPLE_STEPS - 1)]
    lr_err = max(abs(a - b) for a, b in zip(res["lrs"], want))
    losses = res["losses"]
    layers = engine.module.config.n_layers
    assert layers == 24 and engine.device.type == "cuda"
    assert type(engine.lr_scheduler).__name__ == "WarmupDecayLR"
    assert engine.optimizer.betas == (0.9, 0.95)
    assert lr_err <= 1e-15 * hi, (res["lrs"], want)
    assert all(np.isfinite(losses)), losses
    assert first_after < losses[0], (first_after, losses)
    for name in FLASH_GROUPS:
        assert launches[name] == layers * EXAMPLE_STEPS, launches
    assert launches["fused_adam"] == EXAMPLE_STEPS, launches
    step_ms = statistics.median(res["step_seconds"][2:]) * 1e3
    del engine, res
    return {"phase": "train_example", "script":
            "deepspeed_tpu_torch/examples/gpt2_pretrain.py",
            "config": EXAMPLE_CONFIG, "model": "gpt2_medium", "seq": 1024,
            "micro_batch": 8, "steps": EXAMPLE_STEPS, "losses": losses,
            "first_batch_loss_after": first_after,
            "lrs": [float(x) for x in want], "lr_max_abs_err": lr_err,
            "step_ms_median_after_2": step_ms, "wall_s_incl_init": wall,
            "peak_memory_gb": peak_gb, "launches": launches}


DATA_STEPS = 6
DATA_DOCS, DATA_SEED = 160, 17


def write_corpus(prefix, vocab, docs=DATA_DOCS, seed=DATA_SEED):
    """A seeded corpus of patterned documents in the ``.bin``/``.idx``
    format (the port's IndexedDatasetBuilder): each document a window of
    a 512-token block tiled over the document's first half, random
    tokens after. Returns (prefix, tokens)."""
    from deepspeed_tpu_torch.runtime.data import IndexedDatasetBuilder
    rng = np.random.RandomState(seed)
    block = rng.randint(0, vocab, size=512)
    builder = IndexedDatasetBuilder(prefix)
    tokens = 0
    for _ in range(docs):
        n = int(rng.randint(256, 1024))
        doc = rng.randint(0, vocab, size=n)
        doc[:n // 2] = np.resize(np.roll(block, -rng.randint(512)), n // 2)
        builder.add_doc(doc.astype(np.int32))
        tokens += n
    return builder.finalize(), tokens


def phase_train_example_data(launch_counters, steps=DATA_STEPS):
    """The GPT-2 example's twin with ``--data_prefix``: a corpus written
    to a temporary directory (enough tokens for every step's 8 x 1024
    window without wrapping an epoch) read through the native loader
    (csrc/ds_dataio.cpp) at gpt2_medium on the example's config; counts
    set to 0 just before main() and read just after. The loss is finite
    and falls: the first batch's loss after the run below its loss at
    step 0. Prints the loader's host ms a batch and the step ms."""
    import tempfile
    import torch
    from deepspeed_tpu_torch.examples import gpt2_pretrain
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime.data import (IndexedDataset,
                                                  NativePrefetchLoader)
    vocab = gpt2.config_for("gpt2_medium").vocab_size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        t0 = time.perf_counter()
        prefix, tokens = write_corpus(tmp + "/corpus", vocab)
        write_s = time.perf_counter() - t0
        assert tokens >= steps * 8 * 1024, tokens
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in launch_counters:
            counter.launches = 0
        t0 = time.perf_counter()
        res = gpt2_pretrain.main(["--size", "gpt2_medium", "--seq_len",
                                  "1024", "--steps", str(steps),
                                  "--deepspeed_config", EXAMPLE_CONFIG,
                                  "--data_prefix", prefix])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in launch_counters}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # the loader's order is fixed: a new loader's first batch is the
        # first step's
        dataset = IndexedDataset(prefix)
        loader = NativePrefetchLoader(dataset, batch_size=8, seq_len=1024)
        first = next(loader)
        loader.close()
        dataset.close()
    engine = res["engine"]
    engine.eval()
    first_after = float(engine(first, first))
    losses = res["losses"]
    layers = engine.module.config.n_layers
    assert layers == 24 and engine.device.type == "cuda"
    assert all(np.isfinite(losses)), losses
    assert first_after < losses[0], (first_after, losses)
    for name in FLASH_GROUPS:
        assert launches[name] == layers * steps, launches
    assert launches["fused_adam"] == steps, launches
    load_ms = [t * 1e3 for t in res["load_seconds"]]
    step_ms = statistics.median(res["step_seconds"][2:]) * 1e3
    del engine, res
    return {"phase": "train_example_data", "script":
            "deepspeed_tpu_torch/examples/gpt2_pretrain.py --data_prefix",
            "config": EXAMPLE_CONFIG, "model": "gpt2_medium", "seq": 1024,
            "micro_batch": 8, "steps": steps, "corpus_docs": DATA_DOCS,
            "corpus_tokens": tokens, "corpus_write_s": write_s,
            "losses": losses, "first_batch_loss_after": first_after,
            "loader_ms_per_batch_median": statistics.median(load_ms),
            "loader_ms_per_batch_max": max(load_ms),
            "step_ms_median_after_2": step_ms, "wall_s_incl_init": wall,
            "peak_memory_gb": peak_gb, "launches": launches}


# ------------------------------------------- block-sparse attention (slice 3)


SPARSE_SOURCE = \
    "deepspeed_tpu_torch/ops/sparse_attention/csrc/block_sparse_attention.cu"
# the documented ds_config section (docs/_pages/config-json.md), causal
SPARSE_TRAIN = {"mode": "fixed", "block": 16,
                "different_layout_per_head": False, "num_local_blocks": 4,
                "num_global_blocks": 1, "attention": "unidirectional",
                "horizontal_global_attention": False,
                "num_different_global_patterns": 1}
SPARSE_PARITY = dict(SPARSE_TRAIN, different_layout_per_head=True,
                     num_different_global_patterns=4)
SPARSE_SHAPE = dict(b=2, s=8192, h=16, d=64)    # the train_sparse path's
SPARSE_MICRO, SPARSE_SEQ = 2, 8192
SPARSE_REMAT = False      # the peak stays under 70 GB without it
SPARSE_NAMES = ("block_sparse_fwd", "block_sparse_bwd_dq",
                "block_sparse_bwd_dkdv")


def sparse_layout(section, heads, seq):
    from deepspeed_tpu_torch.ops.sparse_attention import (
        sparsity_config_from_dict)
    return sparsity_config_from_dict(dict(section), heads).make_layout(seq)


def mean_keys_per_query(layout, block):
    """k-bar: keys a query attends under the layout and the causal rule,
    averaged over queries and heads."""
    lay = np.asarray(layout, bool)
    nb = lay.shape[1]
    qb, kb = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    per_pair = np.where(qb > kb, block * block,
                        np.where(qb == kb, block * (block + 1) // 2, 0))
    return float((lay * per_pair[None]).sum() / (lay.shape[0] * nb * block))


def sparse_case(device, seed=0):
    """The train_sparse path's attention operands: q, k, v the (b, h, s,
    d) views of one (b, s, 3 * h * d) bf16 QKV tensor, and an output
    gradient in the (b, h, s, d) view of (b, s, h, d) memory."""
    import torch
    b, s, h, d = (SPARSE_SHAPE[k] for k in "bshd")
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=device,
                      dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device=device,
                       dtype=torch.bfloat16).transpose(1, 2)
    return q, k, v, dout


def sparse_library(q, k, v, dout, layout, block, flush):
    """Yardsticks, never on the port's path: flex_attention under
    torch.compile with a BlockMask from the layout and the causal rule (it
    skips the same inactive blocks), and scaled_dot_product_attention with
    the layout expanded to a dense boolean mask. Each: forward ms and
    backward ms (forward + backward minus forward, dq, dk, dv together)."""
    import torch
    import torch.nn.functional as F
    b, h, s, d = q.shape
    qh, kh, vh = (t.contiguous().requires_grad_() for t in (q, k, v))
    doh = dout.contiguous()
    lay = torch.from_numpy(np.asarray(layout, bool)).to(q.device)
    one = lay.shape[0] == 1

    def timed(fn):
        with torch.no_grad():
            fwd = time_ms(fn, flush)
        both = time_ms(lambda: torch.autograd.grad(fn(), (qh, kh, vh), doh),
                       flush)
        return fwd, both - fwd

    out = {}
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def mask_mod(bi, hi, qi, ki):
            hl = 0 if one else hi
            return lay[hl, qi // block, ki // block] & (qi >= ki)

        mask = create_block_mask(mask_mod, B=None, H=None if one else h,
                                 Q_LEN=s, KV_LEN=s, device=q.device)
        flex = torch.compile(flex_attention)
        out["flex"] = timed(lambda: flex(qh, kh, vh, block_mask=mask))
        out["flex_error"] = None
    except Exception as exc:   # a yardstick only: the kernels' checks decide
        out["flex"] = (None, None)
        out["flex_error"] = "{}: {}".format(type(exc).__name__, exc)[:400]
    dense = (lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
             & torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril())[None]
    out["sdpa"] = timed(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=dense))
    del dense
    return out


def phase_sparse(flush):
    """The three block-sparse kernels against their plain versions at the
    train_sparse shape, for the train config's shared layout (the path of
    the TPU's packed-heads rows) and the parity config's per-head layout
    (its per-head rows), timed."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    device = torch.device("cuda", 0)
    b, s, h, d = (SPARSE_SHAPE[k] for k in "bshd")
    q, k, v, dout = sparse_case(device)
    layouts = {}
    for name, section in (("shared", SPARSE_TRAIN),
                          ("per_head", SPARSE_PARITY)):
        layout = sparse_layout(section, h, s)
        tables = bsa.LayoutTables(layout, section["block"])
        kw = dict(tables=tables, causal=True)
        out, lse = bsa.block_sparse_fwd(q, k, v, **kw)
        delta = bsa.attention_delta(out, dout)
        args = (q, k, v, None, None, dout, lse, delta)
        dq = bsa.block_sparse_bwd_dq(*args, **kw)
        dk, dv = bsa.block_sparse_bwd_dkdv(*args, **kw)
        again = (bsa.block_sparse_bwd_dq(*args, **kw),
                 *bsa.block_sparse_bwd_dkdv(*args, **kw))
        fwd_again = bsa.block_sparse_fwd(q, k, v, **kw)
        ref_out, ref_lse = bsa.block_sparse_fwd_reference(q, k, v, **kw)
        ref_dq = bsa.block_sparse_bwd_dq_reference(*args, **kw)
        ref_dk, ref_dv = bsa.block_sparse_bwd_dkdv_reference(*args, **kw)
        torch.cuda.synchronize()
        abs_err = lambda a, b: float((a.float() - b.float()).abs().max())
        pairs = {"out": (out, ref_out), "dq": (dq, ref_dq),
                 "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
        errs = {"lse": abs_err(lse, ref_lse)}
        for g, (got, want) in pairs.items():
            atol = FLASH_TOL["out_atol" if g == "out" else "grad_atol"]
            errs[g + "_abs"] = abs_err(got, want)
            errs[g + "_ulp_ratio"] = _ulp_ratio(got, want, atol)
        for t in (out, lse, dq, dk, dv):
            assert torch.isfinite(t.float()).all(), "non-finite kernel output"
        errs["bwd_repeat_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
        errs["fwd_repeat_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(fwd_again, (out, lse)))
        assert errs["lse"] <= FLASH_TOL["lse"], (name, errs)
        assert max(errs[g + "_ulp_ratio"] for g in pairs) <= 1.0, (name, errs)
        assert errs["bwd_repeat_bit_equal"], (name, "two backward runs differ")
        assert errs["fwd_repeat_bit_equal"], (name, "two forward runs differ")
        # fp16 runs the same tensor-core forward: one fp16 ulp of the plain
        # value plus eps / 4, as flash_fp16 holds the flash forward
        q16, k16, v16 = (t.to(torch.float16) for t in (q, k, v))
        out16, lse16 = bsa.block_sparse_fwd(q16, k16, v16, **kw)
        ref16, ref_lse16 = bsa.block_sparse_fwd_reference(q16, k16, v16, **kw)
        torch.cuda.synchronize()
        eps16 = torch.finfo(torch.float16).eps
        errs["fp16_out_ulp_ratio"] = float(
            ((out16.float() - ref16.float()).abs() /
             (eps16 * ref16.float().abs() + eps16 / 4)).max())
        errs["fp16_lse"] = abs_err(lse16, ref_lse16)
        assert errs["fp16_out_ulp_ratio"] <= 1.0, (name, errs)
        assert errs["fp16_lse"] <= FLASH_TOL["lse"], (name, errs)
        del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, again, fwd_again
        del q16, k16, v16, out16, lse16, ref16, ref_lse16

        times = {
            "block_sparse_fwd": (
                lambda: bsa.block_sparse_fwd(q, k, v, **kw),
                lambda: bsa.block_sparse_fwd_reference(q, k, v, **kw)),
            "block_sparse_bwd_dq": (
                lambda: bsa.block_sparse_bwd_dq(*args, **kw),
                lambda: bsa.block_sparse_bwd_dq_reference(*args, **kw)),
            "block_sparse_bwd_dkdv": (
                lambda: bsa.block_sparse_bwd_dkdv(*args, **kw),
                lambda: bsa.block_sparse_bwd_dkdv_reference(*args, **kw)),
        }
        # operations over active pairs only (the JAX _sparse_cost count):
        # 2 * mults * b * n_active * block^2 * d; bytes: each input once,
        # each output once
        nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        blk = section["block"]
        work = lambda mults: 2 * mults * b * tables.n_active * blk * blk * d
        bounds = {
            "block_sparse_fwd": bound_ms(nbytes(q, k, v, out, lse), work(2),
                                         BF16_FLOPS_PER_S),
            "block_sparse_bwd_dq": bound_ms(
                nbytes(q, k, v, dout, lse, delta, dq), work(3),
                BF16_FLOPS_PER_S),
            "block_sparse_bwd_dkdv": bound_ms(
                nbytes(q, k, v, dout, lse, delta, dk, dv), work(4),
                BF16_FLOPS_PER_S),
        }
        lib = sparse_library(q, k, v, dout, layout, blk, flush)
        library = {"block_sparse_fwd": lib["flex"][0],
                   "block_sparse_bwd_dq": lib["flex"][1],
                   "block_sparse_bwd_dkdv": lib["flex"][1]}
        dense_library = {"block_sparse_fwd": lib["sdpa"][0],
                         "block_sparse_bwd_dq": lib["sdpa"][1],
                         "block_sparse_bwd_dkdv": lib["sdpa"][1]}
        rows = {}
        for kname, (kernel, plain) in times.items():
            rows[kname] = {"kernel_ms": time_ms(kernel, flush),
                           "plain_ms": time_ms(plain, flush, reps=5),
                           "bound_ms": bounds[kname][0],
                           "bound_by": bounds[kname][1],
                           "library_ms": library[kname],
                           "dense_library_ms": dense_library[kname]}
        nb = tables.nb
        layouts[name] = {
            "section": section, "shared": tables.shared,
            "active_pairs_per_head": tables.n_active // h,
            "density_of_causal": tables.n_active / h / (nb * (nb + 1) // 2),
            "walk_steps_per_head": {
                walk: int((-(-getattr(tables, walk).lengths * blk //
                             64)).sum()) // tables.layout_heads
                for walk in ("fwd", "bwd")},
            "errors": errs, "kernels": rows,
            "flex_error": lib["flex_error"]}
        del out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return {"phase": "kernel", "name": "block_sparse_attention",
            "tolerance": FLASH_TOL, "layouts": layouts,
            "library_call": "flex_attention (torch.compile) with a BlockMask "
                            "of the layout and the causal rule; "
                            "dense_library: scaled_dot_product_attention "
                            "with the layout as a dense bool mask; "
                            "backward times cover dq, dk and dv together",
            "shape": dict(SPARSE_SHAPE, dtype="bf16", causal=True,
                          qkv="(b, h, s, d) views of one (b, s, 3hd) "
                              "tensor")}


def phase_train_sparse(launch_counters):
    """The long-context main path: gpt2_medium at full width and depth,
    seq 8192, micro batch 2, bf16, ZeRO-2, Adam with fp32 moments, the
    ds_config sparse_attention section, through initialize(...)
    .train_batch(...) on one fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    # the train config with fp32 moments and accumulator, as before the
    # bench rung's bf16 state
    ds = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=SPARSE_MICRO,
              sparse_attention=dict(SPARSE_TRAIN),
              optimizer={"type": "Adam", "params": {
                  "lr": 1e-4, "fused_kernel": "auto"}})
    del ds["data_types"]
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=SPARSE_SEQ,
                          loss_chunk=128, remat=SPARSE_REMAT,
                          sparse_attention=dict(SPARSE_TRAIN))
    assert cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
    t0 = time.perf_counter()
    model = seeded_gpt2(cfg, 0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config_params=ds)
    init_s = time.perf_counter() - t0
    # the model consumes the engine's parsed section: the two agree
    assert engine.sparse_attention_config() == SPARSE_TRAIN
    assert cfg.sparse_attention == engine.sparse_attention_config()
    assert engine.device.type == "cuda"
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, SPARSE_MICRO, SPARSE_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for name in SPARSE_NAMES:
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == 0, launches
    assert launches["fused_adam"] == TRAIN_STEPS, launches
    assert engine.flat.check_views()
    layout = sparse_layout(SPARSE_TRAIN, cfg.n_heads, SPARSE_SEQ)
    block = SPARSE_TRAIN["block"]
    nb = SPARSE_SEQ // block
    active = int(np.asarray(layout[0]).sum())
    k_bar = mean_keys_per_query(layout, block)
    step_s = wall / TRAIN_STEPS
    tokens = SPARSE_MICRO * SPARSE_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        k_bar
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch)
    return {"phase": "train_sparse", "model": "gpt2_medium",
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "seq": SPARSE_SEQ,
            "micro_batch": SPARSE_MICRO, "dtype": "bf16", "zero_stage": 2,
            "moments": "fp32", "remat": SPARSE_REMAT, "params": n_params,
            "sparse_attention": SPARSE_TRAIN,
            "active_block_pairs_per_head": active,
            "density_of_causal": active / (nb * (nb + 1) // 2),
            "mean_keys_per_query": k_bar,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "mfu": mfu,
            "mfu_formula": "tokens/s * (6 N + 12 L d k_bar) / 989e12, "
                           "k_bar = mean keys a query attends under the "
                           "layout (bench.py's formula with s -> k_bar)",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


def phase_train_sparse_parity(steps=5, tol=1e-4, seq=2048):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, seq
    2048, a per-head layout (the TPU's per-head rows), TF32 off: through
    the block-sparse kernels, and through their plain versions (the
    wrappers' names swapped for the plain functions here, for the
    comparison only)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50304, size=(1, 2, seq)).astype(np.int64)
    kernels = {n: getattr(bsa, n) for n in SPARSE_NAMES}
    plains = {n: getattr(bsa, n + "_reference") for n in SPARSE_NAMES}
    runs, launches = {}, {}
    for route, fns in (("kernels", kernels), ("plain", plains)):
        for counter in kernels.values():
            counter.launches = 0
        for n, fn in fns.items():
            setattr(bsa, n, fn)
        try:
            cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=seq,
                                  loss_chunk=128, remat=False,
                                  sparse_attention=dict(SPARSE_PARITY))
            model = seeded_gpt2(cfg, 1)
            engine = deepspeed_tpu_torch.initialize(model=model, config_params={
                "train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                "sparse_attention": dict(SPARSE_PARITY),
                "steps_per_print": 10 ** 9})[0]
            runs[route] = [float(engine.train_batch(batch=(ids, ids)))
                           for _ in range(steps)]
        finally:
            for n, fn in kernels.items():
                setattr(bsa, n, fn)
        launches[route] = {n: c.launches for n, c in kernels.items()}
        del engine, model
        torch.cuda.empty_cache()
    assert all(v == 2 * steps for v in launches["kernels"].values()), launches
    assert all(v == 0 for v in launches["plain"].values()), launches
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["kernels"],
                                                  runs["plain"]))
    assert rel <= tol, (rel, runs)
    assert runs["kernels"][-1] < runs["kernels"][0], runs
    return {"phase": "train_sparse_parity", "layers": 2, "d_model": 1024,
            "seq": seq, "dtype": "fp32", "sparse_attention": SPARSE_PARITY,
            "steps": steps, "losses": runs, "launches": launches,
            "max_rel_diff": rel, "tolerance": tol}


# --------------------------------------------- BERT + LAMB (slice 4)


LAMB_SOURCE = "deepspeed_tpu_torch/ops/lamb/csrc/fused_lamb.cu"
LAMB_NAMES = ("fused_lamb", "fused_lamb_apply")
# BERT-large leaves that init_params fills with zeros (biases, LN shifts):
# at step 1 their trust ratio takes the 1.0 branch
ZERO_INIT = ("bias", "qkvb", "attn_ob", "attn_nb", "inter_b", "output_b",
             "norm_b")
BERT_MICRO, BERT_SEQ, BERT_REMAT = 32, 512, True
# tests/perf/bert_bench.py:18-40 at its default bf16_state=True: bf16
# LAMB moments and a bf16 gradient accumulator
BERT_CONFIG = {
    "train_micro_batch_size_per_gpu": BERT_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Lamb", "params": {"lr": 2e-3,
                                             "moments_dtype": "bf16",
                                             "fused_kernel": "auto"}},
    "data_types": {"grad_accum_dtype": "bf16"},
    "transformer": {"flash_attention": "auto"},
    "steps_per_print": 10 ** 9,
}


def bert_segments(cfg):
    """(segments, zero-init segment indices, buffer length) of a BERT
    model's flat partition, laid out as FlatPartition lays it out."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    segments, zero, total = [], [], 0
    for name, p in bert.BertModel(cfg, device="meta").named_parameters():
        if name.endswith(ZERO_INIT):
            zero.append(len(segments))
        segments.append((total, p.numel()))
        total += -(-p.numel() // ALIGN) * ALIGN
    return segments, zero, total


def _fp32_steps(got, want):
    """Largest distance in fp32 representable steps (0 = bit-equal)."""
    import torch
    line = lambda t: torch.where(t.view(torch.int32) < 0,
                                 -(t.view(torch.int32) & 0x7FFFFFFF),
                                 t.view(torch.int32)).long()
    return int((line(got) - line(want)).abs().max())


def phase_lamb(flush):
    """The two LAMB kernels against their plain versions over one flat
    fp32 buffer of BERT-large's size and segment table, step 7, with fp32
    moments and with bf16 moments (the train_bert path's): m, v, the
    trust ratios and the per-segment sums (|p|^2, |u|^2) bit-equal (the
    sums also within 1e-5 of a float64 sum of each segment), p within one
    ulp, two kernel runs bit-identical; with bf16 moments stage 1 leaves
    m and v untouched; timed. Bytes an element: fp32 moments stage 1 24
    (reads p, g, m, v, writes m, v), apply 16 (reads p, m, v, writes p);
    bf16 moments stage 1 12 (reads p, g, m, v), apply 20 (reads p, g, m,
    v, writes p, m, v)."""
    import torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.adam.fused_adam import bias_corrections
    from deepspeed_tpu_torch.ops.lamb import (
        LambPlan, fused_lamb, fused_lamb_apply, fused_lamb_apply_reference,
        fused_lamb_reference)
    device = torch.device("cuda", 0)
    cfg = bert.config_for("bert_large")
    segments, zero, total = bert_segments(cfg)
    n = sum(numel for _, numel in segments)
    assert n == bert.num_params(cfg) and len(segments) == 26
    covered = torch.zeros(total, dtype=torch.bool, device=device)
    for i, (off, numel) in enumerate(segments):
        covered[off:off + numel] = i not in zero
    gen = torch.Generator(device=device).manual_seed(7)
    new = lambda scale: torch.randn(total, generator=gen, device=device) * \
        scale * covered
    p, g, m32 = new(0.02), new(1e-3), new(1e-4)
    v32 = new(1e-4) ** 2
    for i in zero:                   # zero params, live gradients
        off, numel = segments[i]
        g[off:off + numel] = torch.randn(numel, generator=gen,
                                         device=device) * 1e-3
    plan = LambPlan(segments, device)
    bc1, bc2 = bias_corrections(0.9, 0.999, 7)
    sc = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01, bc1=bc1,
              bc2=bc2)
    p0 = p
    variants = {}
    for moments, dtype, stage1_bytes, apply_bytes in (
            ("fp32", torch.float32, 24, 16), ("bf16", torch.bfloat16, 12, 20)):
        # each variant from the same state (the timing runs move p)
        p = p0.clone()
        m, v = m32.to(dtype, copy=True), v32.to(dtype, copy=True)
        p_sq = torch.stack([(p[off:off + numel].double() ** 2).sum()
                            for off, numel in segments])
        kw = dict(lr=2e-3, eps=1e-8, weight_decay=0.01, bc1=bc1, bc2=bc2)
        if dtype == torch.bfloat16:
            kw.update(g=g, beta1=0.9, beta2=0.999)
        sides, ratios, sums, untouched = [], [], [], True
        for route in ("kernel", "kernel", "plain"):
            pp, mm, vv = p.clone(), m.clone(), v.clone()
            if route == "kernel":
                r, sq = fused_lamb(pp, g, mm, vv, plan, **sc)
                if dtype == torch.bfloat16:
                    untouched &= torch.equal(mm, m) and torch.equal(vv, v)
                fused_lamb_apply(pp, mm, vv, r, plan, **kw)
            else:
                r, sq = fused_lamb_reference(pp, g, mm, vv, plan, **sc)
                fused_lamb_apply_reference(pp, mm, vv, r, plan, **kw)
            sides.append((pp, mm, vv))
            ratios.append(r)
            sums.append(sq)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(sides[0], sides[1])) \
            and torch.equal(sums[0], sums[1])
        m_equal = torch.equal(sides[0][1], sides[2][1])
        v_equal = torch.equal(sides[0][2], sides[2][2])
        ratio_equal = torch.equal(ratios[0], ratios[2])
        sums_equal = torch.equal(sums[0], sums[2])
        sums_rel = float(((sums[0][:, 0].double() - p_sq).abs() /
                          p_sq.clamp_min(1e-30)).max())
        assert sums_equal, "the kernel's per-segment sums differ from plain"
        assert sums_rel <= 1e-5, sums_rel
        p_steps = _fp32_steps(sides[0][0], sides[2][0])
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(sides[0], sides[2]))
        assert repeat, "two runs of the LAMB kernels differ"
        assert untouched, "stage 1 wrote bf16 moments"
        assert m_equal and v_equal, "m or v off the plain version"
        assert ratio_equal, (ratios[0], ratios[2])
        assert p_steps <= 1, "p off the plain version by {} ulp".format(
            p_steps)
        assert torch.isfinite(sides[0][0]).all()
        ones = int((ratios[0] == 1.0).sum())
        assert ones >= len(zero), (ones, len(zero))
        ratio = ratios[0]
        del sides, sums
        torch.cuda.empty_cache()
        stage1_ms = time_ms(lambda: fused_lamb(p, g, m, v, plan, **sc),
                            flush)
        apply_ms = time_ms(lambda: fused_lamb_apply(p, m, v, ratio, plan,
                                                    **kw), flush)
        plain_stage1 = time_ms(lambda: fused_lamb_reference(
            p, g, m, v, plan, **sc), flush, reps=5)
        plain_apply = time_ms(lambda: fused_lamb_apply_reference(
            p, m, v, ratio, plan, **kw), flush, reps=5)
        # operations: ~20 fp32 an element for stage 1 (the TPU kernel's
        # own count), ~10 for the apply (~20 with bf16 moments: m', v'
        # again); partials and ratios are < 0.1% more bytes
        apply_ops = 10 if dtype == torch.float32 else 20
        variants[moments] = {
            "bit_equal": {"m": m_equal, "v": v_equal, "ratio": ratio_equal,
                          "sums": sums_equal, "repeat": repeat,
                          "stage1_leaves_bf16_moments": untouched},
            "p_sq_rel_err_vs_float64": sums_rel,
            "p_max_ulp": p_steps, "max_abs_err": err,
            "ratio_one_segments": ones,
            "kernels": {
                "fused_lamb": dict(
                    kernel_ms=stage1_ms, plain_ms=plain_stage1,
                    library_ms=None, max_abs_err=err,
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        stage1_bytes * n, 20 * n, FP32_FLOPS_PER_S)))),
                "fused_lamb_apply": dict(
                    kernel_ms=apply_ms, plain_ms=plain_apply,
                    library_ms=None, max_abs_err=err,
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        apply_bytes * n, apply_ops * n,
                        FP32_FLOPS_PER_S))))},
            "step_ms": stage1_ms + apply_ms,
            "step_bound_ms": bound_ms((stage1_bytes + apply_bytes) * n,
                                      (20 + apply_ops) * n,
                                      FP32_FLOPS_PER_S)[0]}
        del m, v
        torch.cuda.empty_cache()
    return {"phase": "lamb", "elements": n, "buffer": total,
            "segments": len(segments), "chunks": plan.n_chunks,
            "zero_init_segments": len(zero),
            "tolerance": "m, v, ratio, sums bit-equal; p <= 1 ulp; "
                         "|p|^2 sums 1e-5 of float64",
            "variants": variants, "library_call": None}


def bert_batch(cfg, micro, seq, seed):
    """One pretraining batch, stacked (1, micro, ...): random ids, zero
    token types, a keep mask of ones up to a seeded valid length in
    [3/4 seq, seq] and zeros after, MLM labels at a seeded 15% of the valid
    positions (-100 elsewhere), random NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(micro, seq)).astype(np.int64)
    valid = rng.randint(3 * seq // 4, seq + 1, size=(micro,))
    mask = (np.arange(seq)[None, :] < valid[:, None]).astype(np.int64)
    pick = (rng.rand(micro, seq) < 0.15) & (mask == 1)
    mlm = np.where(pick, ids, -100).astype(np.int64)
    nsp = rng.randint(0, 2, size=(micro,)).astype(np.int64)
    return tuple(a[None] for a in (ids, np.zeros_like(ids), mask, mlm, nsp))


def phase_train_bert(launch_counters):
    """The BERT main path: BERT-large at full width and depth, seq 512,
    micro batch 32, bf16, ZeRO-2, LAMB with bf16 moments and a bf16
    gradient accumulator (bert_bench.py's bf16_state), remat on, dropout
    0, the padded mask, through initialize(...).train_batch(...) on one
    fixed batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.lamb import FusedLamb
    cfg = bert.config_for("bert_large", max_seq_len=BERT_SEQ, dropout=0.0,
                          attn_dropout=0.0, remat=BERT_REMAT)
    assert cfg.n_layers == 24 and cfg.d_model == 1024 and cfg.n_heads == 16
    t0 = time.perf_counter()
    model = bert.make_bert_model(config=cfg, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=BERT_CONFIG)
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert isinstance(engine.optimizer, FusedLamb)
    assert engine.fused_optimizer_kernel == "pallas"
    assert engine.flash_attention_backend == "pallas"
    assert engine.flat.segments.shape == (26, 2)
    assert engine.flat.exp_avg.dtype == engine.flat.acc.dtype == \
        torch.bfloat16
    batch = bert_batch(cfg, BERT_MICRO, BERT_SEQ, seed=0)
    mask = batch[2][0]
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    losses += [float(x) for x in step_losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    fwd_per_step = cfg.n_layers * (2 if BERT_REMAT else 1)
    assert launches["flash_fwd"] == fwd_per_step * TRAIN_STEPS, launches
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert launches[name] == cfg.n_layers * TRAIN_STEPS, launches
    for name in LAMB_NAMES:
        assert launches[name] == TRAIN_STEPS, launches
    assert launches["fused_adam"] == 0, launches
    assert engine.flat.check_views()
    step_s = wall / TRAIN_STEPS
    tokens = BERT_MICRO * BERT_SEQ
    n_params = bert.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * \
        BERT_SEQ                              # tests/perf/bert_bench.py:56-59
    mfu = tokens / step_s * flops_per_token / BF16_FLOPS_PER_S
    profile = train_profile(engine, batch, kernel_groups=FLASH_GROUPS)
    return {"phase": "train_bert", "model": "bert_large",
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "seq": BERT_SEQ, "micro_batch": BERT_MICRO,
            "valid_tokens": int(mask.sum()), "dtype": "bf16",
            "zero_stage": 2, "optimizer": "lamb", "moments": "bf16",
            "grad_accum": "bf16",
            "remat": BERT_REMAT, "params": n_params,
            "engine_init_s": init_s, "steps": TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_per_sec": tokens / step_s,
            "samples_per_sec": BERT_MICRO / step_s, "mfu": mfu,
            "mfu_formula": "tokens/s * (6 N + 12 L d s) / 989e12 "
                           "(tests/perf/bert_bench.py)",
            "losses": losses, "peak_memory_gb": peak_gb,
            "launches": launches, "train_profile": profile}


def phase_train_bert_parity(launch_counters, steps=5, tol=1e-4, seq=128):
    """fp32 loss trajectories at BERT-large width with 2 layers, seq 128,
    the padded mask, TF32 off: the kernels (flash "pallas", LAMB "pallas")
    against the plain versions (einsum attention "xla", plain LAMB "xla"),
    from the same init, with fp32 and with bf16 LAMB moments."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    micro = 8
    runs, launches, rel = {}, {}, {}
    want = {"flash_fwd": 2 * 2 * steps, "flash_bwd_dkdv": 2 * steps,
            "flash_bwd_dq": 2 * steps, "fused_lamb": steps,
            "fused_lamb_apply": steps}
    for moments in ("fp32", "bf16"):
        for backend in ("pallas", "xla"):
            key = "{}/{}".format(moments, backend)
            cfg = bert.config_for("bert_large", n_layers=2, max_seq_len=seq,
                                  dropout=0.0, attn_dropout=0.0, remat=True)
            model = bert.make_bert_model(config=cfg, seed=1)
            engine = deepspeed_tpu_torch.initialize(
                model=model, config_params={
                    "train_micro_batch_size_per_gpu": micro,
                    "optimizer": {"type": "Lamb", "params": {
                        "lr": 2e-3, "fused_kernel": backend,
                        "moments_dtype": moments}},
                    "transformer": {"flash_attention": backend},
                    "steps_per_print": 10 ** 9})[0]
            assert engine.flash_attention_backend == backend
            batch = bert_batch(cfg, micro, seq, seed=3)
            for counter in launch_counters:
                counter.launches = 0
            runs[key] = [float(engine.train_batch(batch=batch))
                         for _ in range(steps)]
            launches[key] = {c.__name__: c.launches
                             for c in launch_counters}
            del engine, model
            torch.cuda.empty_cache()
        assert launches[moments + "/pallas"] == want, launches
        assert not any(launches[moments + "/xla"].values()), launches
        rel[moments] = max(abs(a - b) / abs(b) for a, b in zip(
            runs[moments + "/pallas"], runs[moments + "/xla"]))
        assert rel[moments] <= tol, (moments, rel, runs)
        assert runs[moments + "/pallas"][-1] < runs[moments + "/pallas"][0]
    return {"phase": "train_bert_parity", "layers": 2, "d_model": 1024,
            "seq": seq, "micro_batch": micro, "dtype": "fp32",
            "moments": ["fp32", "bf16"], "steps": steps, "losses": runs,
            "launches": launches, "max_rel_diff": rel, "tolerance": tol}


# ----------------------------------------------------------- serving path


SERVE_INFERENCE = {"max_batch_size": 16, "dtype": "bf16",
                   "prefill_buckets": [128, 256, 512],
                   "max_new_tokens": 64, "greedy": True,
                   "kv_layout": "paged", "kv_block_size": 16,
                   "paged_attention_kernel": "auto"}
SERVE_REQUESTS, SERVE_PROMPT_LENS = 48, (64, 180, 400)
_SERVE_MODEL = []


def serve_model():
    """The serving phases' gpt2_medium (seed 0, on the host), built once:
    init_inference copies the weights and leaves the model as it was."""
    from deepspeed_tpu_torch.models import gpt2
    if not _SERVE_MODEL:
        cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
        _SERVE_MODEL.append(seeded_gpt2(cfg, 0))
    return _SERVE_MODEL[0]


def phase_serve(launch_counters):
    """The main path: gpt2_medium at full width and depth, bf16, 48
    requests through the port's init_inference(...).generate(...)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.monitor import ServingMetrics
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
    assert cfg.n_layers == SERVE_LAYERS
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        model=serve_model(), config={"inference": SERVE_INFERENCE})
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda"
    assert engine.paged_attention_kernel == "pallas"
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=SERVE_PROMPT_LENS[i % 3]).tolist()
               for i in range(SERVE_REQUESTS)]
    # warm-up: every prefill bucket and the decode step, off the clock
    engine.generate(prompts[:len(SERVE_PROMPT_LENS)], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    metrics = ServingMetrics()
    for counter in launch_counters:
        counter.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}

    snap = metrics.snapshot()
    assert all(len(o) == SERVE_INFERENCE["max_new_tokens"] for o in outs), \
        "a request returned {} tokens".format(sorted({len(o) for o in outs}))
    assert launches["paged_attention"] == snap["decode_steps"] * SERVE_LAYERS, \
        (launches, snap["decode_steps"])
    assert engine.last_logits is not None and \
        bool(torch.isfinite(engine.last_logits).all()), "non-finite logits"
    entries = (engine.prefix_stats() or {}).get("entries", 0)
    assert engine.allocator.pages_in_use == entries, \
        (engine.allocator.pages_in_use, entries)
    profile = decode_profile(engine, prompts)
    return {"phase": "serve", "model": "gpt2_medium", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "bf16", "requests": len(outs),
            "new_tokens": sum(len(o) for o in outs),
            "engine_init_s": init_s, "wall_s": wall,
            "decode_steps": snap["decode_steps"],
            "decode_s_per_step": metrics.decode_seconds /
            max(snap["decode_steps"], 1),
            "prefill_tokens_per_sec": snap["prefill_tokens_per_sec"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "ttft_p50_s": snap["ttft"]["p50_s"],
            "ttft_p95_s": snap["ttft"]["p95_s"],
            "tpot_p50_s": snap["tpot"]["p50_s"],
            "mean_slot_occupancy": snap["mean_slot_occupancy"],
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "kv_pool_gb": engine.kv.nbytes / 2 ** 30,
            "decode_profile": profile}


def decode_profile(engine, prompts, steps=8, max_new=None):
    """Where a decode step's time goes: ``steps`` scheduler steps with
    every slot decoding (``max_new`` tokens a request, default ``steps``
    + 2), under torch.profiler. Returns the window's wall time, the
    device time summed over its kernels (one stream, so the busy time),
    the busy share and the costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(engine)
    for prompt in prompts[:engine.num_slots]:
        sched.submit(prompt, max_new_tokens=max_new or steps + 2)
    sched.step()                  # admit + prefill every slot + 1 decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"steps": steps, "wall_s_per_step": wall / steps,
            "device_busy_s_per_step": busy_us * 1e-6 / steps,
            "device_busy_share": busy_us * 1e-6 / wall,
            "kernel_launches_per_step": sum(e.count for e in kernels) /
            steps,
            "top_kernels": [{"name": e.key[:80],
                             "us_per_step": e.self_device_time_total / steps,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def phase_parity():
    """fp32 greedy streams: slot == paged plain == paged kernel, at
    gpt2_medium width with 2 layers, TF32 off for matmul and cuDNN."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=1024)
    model = seeded_gpt2(cfg, 1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 64, 130, 300, 5, 250, 33, 480, 90, 16)]
    base = {"max_batch_size": 4, "dtype": "fp32",
            "prefill_buckets": [128, 256, 512], "max_new_tokens": 24,
            "greedy": True}
    paged = dict(base, kv_layout="paged", kv_block_size=16)
    streams = {}
    for name, inference in (("slot", base),
                            ("paged_xla", dict(paged,
                                               paged_attention_kernel="xla")),
                            ("paged_pallas", dict(
                                paged, paged_attention_kernel="pallas"))):
        engine = deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": inference})
        streams[name] = engine.generate(prompts)
        del engine
    assert streams["paged_xla"] == streams["slot"], "paged plain != slot"
    assert streams["paged_pallas"] == streams["slot"], "paged kernel != slot"
    return {"phase": "parity", "layers": 2, "d_model": cfg.d_model,
            "dtype": "fp32", "requests": len(prompts),
            "tokens_per_stream": sum(len(o) for o in streams["slot"]),
            "identical": True}


# ------------------------------------- speculative and TP serving (slice 13)


SPEC_K = 4
SPEC_NGRAM = {"enabled": True, "method": "ngram", "num_draft_tokens": SPEC_K}
SPEC_MODEL = {"enabled": True, "method": "model", "num_draft_tokens": SPEC_K}
SPEC_SEED = 17              # bench_inference.py's TRACE_SEED
SPEC_MODEL_REQUESTS = 16
SPEC_PROFILE_STEPS = 4


def patterned_prompts(vocab, n, lens, seed=SPEC_SEED):
    """``n`` prompts of ``lens`` (cycled) cut from one patterned
    document, as bench_inference.py:140-170 builds its trace's bodies: a
    192-token block tiled 4 times, each prompt a window of it at a
    random start, so prompt-lookup drafting has repeats to find."""
    rng = np.random.RandomState(seed)
    doc = np.tile(rng.randint(0, vocab, size=192), 4)
    prompts = []
    for i in range(n):
        length = lens[i % len(lens)]
        start = rng.randint(0, len(doc) - length)
        prompts.append(doc[start:start + length].tolist())
    return prompts


def _serve_run(engine, prompts, counter):
    """Warm up (every prefill bucket and both decode widths), then
    generate ``prompts`` with the paged kernel's count set to 0 just
    before and read just after. -> (outputs, metrics, wall s, launches,
    peak GB)."""
    import gc
    import torch
    from deepspeed_tpu_torch.utils.monitor import ServingMetrics
    engine.generate(prompts[:len(SERVE_PROMPT_LENS)], max_new_tokens=2)
    # an engine is a reference cycle (its programs close over it): an
    # earlier phase's must be gone before the peak is read
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = ServingMetrics()
    counter.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    snap = metrics.snapshot()
    assert all(len(o) == SERVE_INFERENCE["max_new_tokens"] for o in outs), \
        "a request returned {} tokens".format(sorted({len(o) for o in outs}))
    # one verify (or plain decode) step = one launch a layer
    assert launches == snap["decode_steps"] * engine.model_config.n_layers, \
        (launches, snap["decode_steps"])
    assert engine.last_logits is not None and \
        bool(torch.isfinite(engine.last_logits).all()), "non-finite logits"
    assert engine.allocator.pages_in_use == 0, engine.allocator.pages_in_use
    return outs, metrics, wall, launches, \
        torch.cuda.max_memory_allocated() / 2 ** 30


def _serve_summary(outs, metrics, wall, launches, peak_gb):
    snap = metrics.snapshot()
    new_tokens = sum(len(o) for o in outs)
    return {"requests": len(outs), "new_tokens": new_tokens,
            "wall_s": wall, "tokens_per_sec": new_tokens / wall,
            "decode_steps": snap["decode_steps"],
            "tokens_per_decode_step": snap["decode_tokens"] /
            max(snap["decode_steps"], 1),
            "decode_s_per_step": metrics.decode_seconds /
            max(snap["decode_steps"], 1),
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "ttft_p50_s": snap["ttft"]["p50_s"],
            "tpot_p50_s": snap["tpot"]["p50_s"],
            "speculative": snap.get("speculative"),
            "paged_attention_launches": launches,
            "peak_memory_gb": peak_gb}


def phase_serve_spec(launch_counters):
    """The Serve configuration with n-gram speculation (k = 4): 48
    patterned prompts of 64/180/400 tokens; the paged kernel at s = 5
    in every verify step, 24 launches a model step; a profile of a few
    verify steps. Then 16 of the prompts with a gpt2_small-shaped model
    drafter (12 layers, d 768, seed 1) on the same target."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    counter, = launch_counters
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
    prompts = patterned_prompts(cfg.vocab_size, SERVE_REQUESTS,
                                SERVE_PROMPT_LENS)
    t0 = time.perf_counter()
    model = serve_model()
    engine = deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": dict(SERVE_INFERENCE,
                                               speculative=SPEC_NGRAM)})
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda" and engine.spec_k == SPEC_K
    assert engine.paged_attention_kernel == "pallas"
    ngram = _serve_summary(*_serve_run(engine, prompts, counter))
    assert ngram["speculative"]["proposed"] > 0, ngram
    # a verify step emits up to k + 1 tokens: the budget keeps every slot
    # verifying through the window
    profile = decode_profile(engine, prompts, steps=SPEC_PROFILE_STEPS,
                             max_new=SERVE_INFERENCE["max_new_tokens"])
    del engine
    torch.cuda.empty_cache()

    drafter_cfg = gpt2.config_for("gpt2_small", max_seq_len=1024)
    drafter = seeded_gpt2(drafter_cfg, 1)
    engine = deepspeed_tpu_torch.init_inference(
        model=model, draft_model=drafter,
        config={"inference": dict(SERVE_INFERENCE, speculative=SPEC_MODEL)})
    del drafter
    _SERVE_MODEL.clear()
    assert type(engine.drafter).__name__ == "ModelDrafter"
    drafted = _serve_summary(*_serve_run(
        engine, prompts[:SPEC_MODEL_REQUESTS], counter))
    del engine
    torch.cuda.empty_cache()
    return {"phase": "serve_spec", "model": "gpt2_medium",
            "layers": cfg.n_layers, "dtype": "bf16", "k": SPEC_K,
            "prompts": "patterned document (bench_inference.py:140-170), "
                       "seed {}".format(SPEC_SEED),
            "engine_init_s": init_s, "ngram": ngram,
            "verify_profile": profile,
            "model_drafter": dict(drafted, drafter="gpt2_small shape, "
                                  "12 layers, d 768, seed 1")}


def phase_serve_spec_parity(launch_counters):
    """fp32, TF32 off, gpt2_medium width with 2 layers, the parity
    phase's prompts, the paged kernel: the n-gram and the model-drafter
    (draft = target) speculative streams equal the plain greedy stream,
    and the target drafting for itself accepts every draft."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    counter, = launch_counters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=1024)
    model = seeded_gpt2(cfg, 1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 64, 130, 300, 5, 250, 33, 480, 90, 16)]
    base = {"max_batch_size": 4, "dtype": "fp32",
            "prefill_buckets": [128, 256, 512], "max_new_tokens": 24,
            "greedy": True, "kv_layout": "paged", "kv_block_size": 16,
            "paged_attention_kernel": "pallas"}
    runs = {}
    for name, spec in (("plain", None), ("ngram", SPEC_NGRAM),
                       ("model", SPEC_MODEL)):
        inference = dict(base, speculative=spec) if spec else base
        engine = deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": inference},
            draft_model=model if name == "model" else None)
        counter.launches = 0
        outs = engine.generate(prompts)
        snap = engine.serving_metrics.snapshot()
        assert counter.launches == snap["decode_steps"] * cfg.n_layers, \
            (name, counter.launches, snap["decode_steps"])
        runs[name] = {"streams": outs, "decode_steps": snap["decode_steps"],
                      "speculative": snap.get("speculative"),
                      "launches": counter.launches}
        del engine
    assert runs["ngram"]["streams"] == runs["plain"]["streams"], \
        "n-gram speculative stream != plain greedy"
    assert runs["model"]["streams"] == runs["plain"]["streams"], \
        "model-drafter speculative stream != plain greedy"
    assert runs["model"]["speculative"]["acceptance_rate"] == 1.0, runs
    return {"phase": "serve_spec_parity", "layers": 2,
            "d_model": cfg.d_model, "dtype": "fp32", "k": SPEC_K,
            "requests": len(prompts), "identical": True,
            **{name: {k: v for k, v in run.items() if k != "streams"}
               for name, run in runs.items()}}


TP_SERVE_REQUESTS = 16


def tp_serve_rank(rank, world, spec):
    """One rank of tensor-parallel serving: init_inference(mp_size=world)
    on gpt2_medium at full width and depth, bf16, paged, the kernel over
    this rank's heads (the weights drawn on the card from a seed,
    :func:`device_gpt2`: every rank draws the same bits, and the numpy
    draws of 24 layers took ~14 s a rank); 16 Serve requests with the
    paged count set to 0
    just before and read just after. Then the parity runs: fp32, TF32
    off, 2 layers, n-gram speculation off and on."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.utils.monitor import ServingMetrics
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
    t0 = time.perf_counter()
    model = device_gpt2(cfg, seed=0)
    engine = deepspeed_tpu_torch.init_inference(
        model=model, mp_size=world, config={"inference": SERVE_INFERENCE})
    del model
    init_s = time.perf_counter() - t0
    assert engine.tp_size == world and engine.device.type == "cuda"
    assert engine.paged_attention_kernel == "pallas"
    assert engine.kv.k.shape[2] == cfg.n_heads // world, engine.kv.k.shape
    prompts = spec["prompts"]
    engine.generate(prompts[:len(SERVE_PROMPT_LENS)], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = ServingMetrics()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    snap = metrics.snapshot()
    finite = bool(torch.isfinite(engine.last_logits).all())
    serve = {"rank": rank, "streams": outs, "launches": launches,
             "decode_steps": snap["decode_steps"], "wall_s": wall,
             "decode_s_per_step": metrics.decode_seconds /
             max(snap["decode_steps"], 1),
             "ttft_p50_s": snap["ttft"]["p50_s"],
             "tpot_p50_s": snap["tpot"]["p50_s"],
             "kv_pool_bytes": engine.kv.nbytes,
             "kv_pool_shape": list(engine.kv.k.shape),
             "logits_finite": finite, "init_s": init_s,
             "transport": torch.distributed.get_backend(engine.tp_group),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del engine
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=1024)
    model = seeded_gpt2(pcfg, 1)
    parity = {}
    for name, inference in spec["parity"].items():
        engine = deepspeed_tpu_torch.init_inference(
            model=model, mp_size=world, config={"inference": inference})
        paged_attention.launches = 0
        parity[name] = {"streams": engine.generate(spec["parity_prompts"]),
                        "launches": paged_attention.launches,
                        "decode_steps":
                        engine.serving_metrics.snapshot()["decode_steps"]}
        del engine
    return {"serve": serve, "parity": parity}


def _tp_parity_configs():
    base = {"max_batch_size": 4, "dtype": "fp32",
            "prefill_buckets": [128, 256, 512], "max_new_tokens": 24,
            "greedy": True, "kv_layout": "paged", "kv_block_size": 16,
            "paged_attention_kernel": "pallas"}
    return {"plain": base, "ngram": dict(base, speculative=SPEC_NGRAM)}


def phase_serve_tp(world=2):
    """Tensor-parallel serving: ``world`` spawned ranks sharing this card
    over gloo (every all-reduce and the logits' all-gather through host
    memory), each init_inference(mp_size=world) with its 16 / world heads
    of the pool; streams equal across ranks, the paged kernel 24
    launches a rank a decode step. Then ``serve_tp_parity``: fp32, 2
    layers, the TP streams equal the TP 1 engine's (run here), n-gram
    speculation off and on."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.utils.distributed import spawn
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=1024)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=SERVE_PROMPT_LENS[i % 3]).tolist()
               for i in range(TP_SERVE_REQUESTS)]
    prng = np.random.RandomState(1)
    parity_prompts = [prng.randint(0, cfg.vocab_size, size=n).tolist()
                      for n in (17, 64, 130, 300, 5, 250, 33, 480, 90, 16)]
    configs = _tp_parity_configs()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(tp_serve_rank, world, args=({
        "prompts": prompts, "parity": configs,
        "parity_prompts": parity_prompts},), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    serve = [r["serve"] for r in ranks]
    for r in serve:
        assert r["logits_finite"], r["rank"]
        assert all(len(o) == SERVE_INFERENCE["max_new_tokens"]
                   for o in r["streams"]), r["rank"]
        assert r["launches"] == r["decode_steps"] * SERVE_LAYERS, \
            (r["rank"], r["launches"], r["decode_steps"])
    assert all(r["streams"] == serve[0]["streams"] for r in serve), \
        "the ranks' streams differ"

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=1024)
    model = seeded_gpt2(pcfg, 1)
    parity = {}
    for name, inference in configs.items():
        engine = deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": inference})
        paged_attention.launches = 0
        tp1 = engine.generate(parity_prompts)
        tp1_launches = paged_attention.launches
        del engine
        for r in ranks:
            got = r["parity"][name]
            assert got["streams"] == tp1, \
                "TP {} {} stream != TP 1 (rank {})".format(
                    world, name, r["serve"]["rank"])
            assert got["launches"] == got["decode_steps"] * 2, got
        parity[name] = {"identical": True, "tp1_launches": tp1_launches,
                        "tp_launches_per_rank":
                        [r["parity"][name]["launches"] for r in ranks],
                        "tp_decode_steps":
                        ranks[0]["parity"][name]["decode_steps"]}
    torch.cuda.empty_cache()
    return {"phase": "serve_tp", "model": "gpt2_medium",
            "layers": SERVE_LAYERS, "tp": world, "dtype": "bf16",
            "heads_per_rank": cfg.n_heads // world,
            "requests": TP_SERVE_REQUESTS, "spawn_wall_s": spawn_s,
            "streams_equal_across_ranks": True,
            "ranks": [{k: v for k, v in r.items() if k != "streams"}
                      for r in serve],
            "serve_tp_parity": {"layers": 2, "dtype": "fp32",
                                "requests": len(parity_prompts),
                                "configs": parity}}


# ------------------------------------------ tensor-parallel ring GEMMs (slice 5)


RING_SOURCE = "deepspeed_tpu_torch/ops/ring_gemm/csrc/ring_gemm.cu"
RING_NAMES = ("ring_ag_gemm", "ring_rs_gemm_add", "ring_gc_gemm_acc")
TP, TP_B, TP_S, TP_D = 2, 16, 1024, 1024   # the train_tp path: gpt2_medium
# The per-step products at gpt2_medium, TP 2, micro 16, seq 1024 (one ring
# step each; "t" marks a transposed weight view, as the backward passes
# give it): (rows m, inner k, cols n) in the kernel's own terms.
RING_SITES = {
    "ring_ag_gemm": [("qkv", 1024, 1536, ""), ("fc", 1024, 2048, ""),
                     ("attn_proj_dx", 1024, 512, "t"),
                     ("mlp_proj_dx", 1024, 2048, "t")],
    "ring_rs_gemm_add": [("attn_proj", 512, 1024, ""),
                         ("mlp_proj", 2048, 1024, ""),
                         ("qkv_dx", 1536, 1024, "t"),
                         ("fc_dx", 2048, 1024, "t")],
    "ring_gc_gemm_acc": [("qkv_dw", 1024, 1536, "lhs"),
                         ("fc_dw", 1024, 2048, "lhs"),
                         ("attn_proj_dw", 1024, 512, "rhs"),
                         ("mlp_proj_dw", 1024, 2048, "rhs")],
}
# Per element, |kernel - plain| <= rel * |plain| + abs_of_max * max|plain|.
# bf16 outputs: both sides sum in fp32 (cuBLAS's reduced-precision split-K
# reduction switched off) in different orders and round once to bf16, so
# one bf16 ulp (<= 2**-7 relative); the reduce-scatter step rounds twice
# (the partial, then the sum with what arrived), so two; the floor covers
# a rounding flip of values near zero. The dW kernel's fp32 sum over
# K = 8192 rows is held at 2**-16 of its largest entry.
RING_TOL = {"ring_ag_gemm": {"rel": 2 ** -7, "abs_of_max": 2 ** -16},
            "ring_rs_gemm_add": {"rel": 2 ** -6, "abs_of_max": 2 ** -16},
            "ring_gc_gemm_acc": {"rel": 2 ** -7, "abs_of_max": 2 ** -16,
                                 "acc_abs_of_max": 2 ** -16}}


def _ring_err(got, want, tol, key="abs_of_max", rel=None):
    """(max |got - want|, the largest ratio of the error to its bound)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = tol["rel"] if rel is None else rel
    bound = rel * want.abs() + tol[key] * float(want.abs().max())
    return float(err.max()), float((err / bound).max())


def ring_case(name, k, n, mode, device, gen):
    """The operands of one site's ring step (bf16, randn): returns
    (kernel call, plain call, library call, output getter, plain output,
    flops, bytes)."""
    import torch
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    b, s_loc = TP_B, TP_S // TP
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                     dtype=torch.bfloat16)
    el = 2
    if name == "ring_ag_gemm":
        cur = rnd(b, s_loc, k)
        w = rnd(n, k).t() if mode == "t" else rnd(k, n)
        outs = [torch.zeros(b, TP * s_loc, n, device=device,
                            dtype=torch.bfloat16) for _ in range(2)]
        kern = lambda: rg.ring_ag_gemm(cur, w, outs[0], 1)
        plain = lambda: rg.ring_ag_gemm_reference(cur, w, outs[1], 1)
        lib = lambda: torch.matmul(cur, w)
        get = lambda i: outs[i][:, s_loc:]
        m = b * s_loc
        nbytes = (m * k + k * n + m * n) * el
    elif name == "ring_rs_gemm_add":
        x = rnd(b, TP * s_loc, k)
        w = rnd(n, k).t() if mode == "t" else rnd(k, n)
        recv = rnd(b, s_loc, n)
        outs = [torch.empty(b, s_loc, n, device=device,
                            dtype=torch.bfloat16) for _ in range(2)]
        kern = lambda: rg.ring_rs_gemm_add(x, w, 0, TP, outs[0], recv)
        plain = lambda: rg.ring_rs_gemm_add_reference(x, w, 0, TP, outs[1],
                                                      recv)
        lib = lambda: torch.matmul(x[:, :s_loc], w)
        get = lambda i: outs[i]
        m = b * s_loc
        nbytes = (m * k + k * n + 2 * m * n) * el
    else:
        # dW: rot (b, s_loc, a) against fixed[:, blk] (b, s_loc, c), a = k
        # and c = n; "lhs" gives (a, c), "rhs" the (c, a) transpose
        a, c = k, n
        rot = rnd(b, s_loc, a)
        fixed = rnd(b, TP * s_loc, c)
        lhs = mode == "lhs"
        shape = (a, c) if lhs else (c, a)
        acc0 = torch.randn(shape, generator=gen, device=device)
        accs = [acc0.clone(), acc0.clone()]
        outs = [torch.empty(shape, device=device, dtype=torch.bfloat16)
                for _ in range(2)]
        kern = lambda: rg.ring_gc_gemm_acc(rot, fixed, 1, accs[0], False,
                                           outs[0], lhs)
        kern.reset = lambda: accs[0].copy_(acc0)
        plain = lambda: rg.ring_gc_gemm_acc_reference(
            rot, fixed, 1, accs[1], False, outs[1], lhs)
        r2, f2 = rot.reshape(-1, a), fixed[:, s_loc:].reshape(-1, c)
        lib = (lambda: torch.matmul(r2.t(), f2)) if lhs else \
            (lambda: torch.matmul(f2.t(), r2))
        get = lambda i: (outs[i], accs[i])
        m = b * s_loc                       # the contraction length
        nbytes = (m * a + m * c) * el + a * c * (4 + 4 + el)
        return kern, plain, lib, get, 2 * m * a * c, nbytes
    return kern, plain, lib, get, 2 * m * k * n, nbytes


def phase_ring_gemm(flush):
    """The three ring-step kernels at the train_tp path's shapes (bf16)
    against their plain versions, per element, then timed beside their
    bounds and torch.matmul of the same product."""
    import torch
    device = torch.device("cuda", 0)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device=device).manual_seed(5)
    kernels = {}
    try:
        for name, sites in RING_SITES.items():
            tol = RING_TOL[name]
            rows, worst = [], 0.0
            total = dict(kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, flops=0, bytes=0)
            for site, k, n, mode in sites:
                kern, plain, lib, get, flops, nbytes = ring_case(
                    name, k, n, mode, device, gen)
                kern()
                plain()
                torch.cuda.synchronize()
                if name == "ring_gc_gemm_acc":
                    (o0, a0), (o1, a1) = get(0), get(1)
                    err, ratio = _ring_err(o0, o1, tol)
                    acc_err, acc_ratio = _ring_err(a0, a1, tol,
                                                   "acc_abs_of_max", 0.0)
                    ratio = max(ratio, acc_ratio)
                    assert torch.isfinite(o0).all()
                    # the same bits run to run, from the same acc
                    first = (a0.clone(), o0.clone())
                    kern.reset()
                    kern()
                    torch.cuda.synchronize()
                    assert torch.equal(a0, first[0]) and \
                        torch.equal(o0, first[1]), (site, "two runs differ")
                    del first
                else:
                    err, ratio = _ring_err(get(0), get(1), tol)
                    acc_err = None
                    assert torch.isfinite(get(0)).all()
                    if name in ("ring_ag_gemm", "ring_rs_gemm_add"):
                        # the same bits run to run (no split K)
                        first = get(0).clone()
                        kern()
                        torch.cuda.synchronize()
                        assert torch.equal(get(0), first), \
                            (site, "two runs differ")
                        del first
                assert ratio <= 1.0, (name, site, err, ratio)
                worst = max(worst, err)
                b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
                row = {"site": site, "k": k, "n": n, "mode": mode,
                       "max_abs_err": err, "err_over_bound": ratio,
                       "kernel_ms": time_ms(kern, flush),
                       "plain_ms": time_ms(plain, flush, reps=5),
                       "library_ms": time_ms(lib, flush),
                       "bound_ms": b_ms, "bound_by": b_by}
                if acc_err is not None:
                    row["acc_max_abs_err"] = acc_err
                rows.append(row)
                for key in ("kernel_ms", "plain_ms", "bound_ms",
                            "library_ms"):
                    total[key] += row[key]
                total["flops"] += flops
                total["bytes"] += nbytes
            _, by = bound_ms(total["bytes"], total["flops"],
                             BF16_FLOPS_PER_S)
            kernels[name] = dict(total, bound_by=by, max_abs_err=worst,
                                 sites=rows)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"phase": "kernel", "name": "ring_gemm", "tolerance": RING_TOL,
            "kernels": kernels,
            "timing": "each kernel's ms, plain_ms, bound_ms and library_ms "
                      "are sums over its four sites (one ring step of each "
                      "of one layer's sites)",
            "library_call": "torch.matmul of the same bf16 product (the "
                            "unfused path's per-device GEMM)",
            "shape": {"b": TP_B, "s": TP_S, "tp": TP, "d_model": TP_D,
                      "dtype": "bf16"}}


TP_MICRO = 16           # the train path's micro batch before bench.py's rung
TP_CONFIG = {
    "train_micro_batch_size_per_gpu": TP_MICRO,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                             "fused_kernel": "auto"}},
    "transformer": {"flash_attention": "auto"},
    "comm": {"collective_matmul": {"enabled": True, "tensor_parallel": True,
                                   "backend": "pallas"}},
    "steps_per_print": 10 ** 9,
}


def _tp_counters():
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [rg.ring_ag_gemm, rg.ring_rs_gemm_add, rg.ring_gc_gemm_acc,
            fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam]


def tp_train_rank(rank, world, spec):
    """One rank of the tensor-parallel main path: gpt2_medium (depth
    ``spec["layers"]``) through initialize(mesh=build_mesh(model=world))
    .train_batch(...); counts reset just before the timed steps."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT,
                          n_layers=spec["layers"])
    conf = json.loads(json.dumps(TP_CONFIG))
    conf["comm"]["collective_matmul"]["backend"] = spec["backend"]
    t0 = time.perf_counter()
    model = seeded_gpt2(cfg, 0)
    engine = deepspeed_tpu_torch.initialize(
        model=model, mesh=build_mesh(model=world), config_params=conf)[0]
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda" and engine._cm_tp
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      size=(1, TP_MICRO, TRAIN_SEQ)).astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(spec["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _tp_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(spec["steps"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(x) for x in step_losses]
    profile = tp_profile(engine, batch) if spec.get("profile") else None
    return {"rank": rank, "losses": losses, "step_ms": wall * 1e3 /
            spec["steps"], "init_s": init_s, "launches": launches,
            "peak_memory_gb": peak_gb, "transport": engine.comm_transport,
            "device": str(engine.device), "views": engine.flat.check_views(),
            "train_profile": profile}


def tp_profile(engine, batch):
    """One train_tp step under torch.profiler (after the timed steps and
    the counts): this rank's device busy share and gaps, its ring
    kernels' device time, and the host time inside the ring hops (the
    start: staging copies and posting the sends; the wait: the receive
    and its copy in), marked by spans put around the port's hop functions
    for this window only."""
    from torch.profiler import record_function
    from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm
    from deepspeed_tpu_torch.parallel import ring
    start, wait = rgm.ring_rotate_start, ring.RingHop.wait

    def spanned_start(*args, **kwargs):
        with record_function("ring_hop_start"):
            return start(*args, **kwargs)

    def spanned_wait(hop):
        with record_function("ring_hop_wait"):
            return wait(hop)

    rgm.ring_rotate_start, ring.RingHop.wait = spanned_start, spanned_wait
    try:
        return train_profile(engine, batch, steps=1,
                             span_names=("ring_hop_start",
                                         "ring_hop_wait"),
                             kernel_groups=("ring_", "flash_", "Memcpy"))
    finally:
        rgm.ring_rotate_start, ring.RingHop.wait = start, wait


# 5 timed steps (10 until the data-parallel phases came; the script's time)
TP_LAYERS, TP_WARMUP, TP_STEPS = 24, 2, 5


def phase_train_tp(world=TP, layers=TP_LAYERS, steps=TP_STEPS,
                   backend="pallas"):
    """The tensor-parallel main path, ``world`` spawned ranks (one card:
    both on it, over gloo through host memory; one card each: NCCL).
    Every ring kernel must launch 4 * world times per layer per step on
    each rank (four sites, world ring steps, forward and backward as
    allgather/reduce-scatter pairs plus the dW gather-contract)."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.distributed import spawn
    spec = {"layers": layers, "warmup": TP_WARMUP, "steps": steps,
            "backend": backend, "profile": True}
    ranks = spawn(tp_train_rank, world, args=(spec,), timeout_s=900)
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          n_layers=layers)
    per_step = {"ring_ag_gemm": 4 * world * layers,
                "ring_rs_gemm_add": 4 * world * layers,
                "ring_gc_gemm_acc": 4 * world * layers,
                "flash_fwd": layers, "flash_bwd_dkdv": layers,
                "flash_bwd_dq": layers, "fused_adam": 1}
    if backend != "pallas":
        per_step.update((n, 0) for n in RING_NAMES)
    for r in ranks:
        losses = r["losses"]
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        assert r["views"], r
        for name, n in per_step.items():
            assert r["launches"][name] == n * steps, (name, r["launches"])
    assert max(abs(a - b) for a, b in zip(ranks[0]["losses"],
                                          ranks[-1]["losses"])) == 0.0
    step_ms = max(r["step_ms"] for r in ranks)
    tokens = TP_MICRO * TRAIN_SEQ
    n_params = gpt2.num_params(cfg)
    flops_per_token = 6.0 * n_params + 12.0 * layers * cfg.d_model * \
        TRAIN_SEQ
    return {"phase": "train_tp", "model": "gpt2_medium", "layers": layers,
            "d_model": cfg.d_model, "seq": TRAIN_SEQ,
            "micro_batch": TP_MICRO, "tp": world, "dtype": "bf16",
            "zero_stage": 2, "backend": backend,
            "transport": ranks[0]["transport"],
            "devices": [r["device"] for r in ranks], "steps": steps,
            "step_ms": step_ms, "tokens_per_sec": tokens / step_ms * 1e3,
            "mfu_all_ranks": tokens / step_ms * 1e3 * flops_per_token /
            (BF16_FLOPS_PER_S * len({r["device"] for r in ranks})),
            "launches_per_rank_per_step": per_step,
            "launches": {name: sum(r["launches"][name] for r in ranks)
                         for name in per_step},
            "ranks": ranks}


def _fc_leaves(tree, prefix=""):
    """The ``fc_kernel`` leaves of a JAX-shaped tree, by dotted name."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)} \
            if prefix.endswith("fc_kernel.") else {}
    out = {}
    for key, child in items:
        out.update(_fc_leaves(child, "{}{}.".format(prefix, key)))
    return out


def tp_parity_rank(rank, world, spec):
    """fp32 losses of one TP engine (2 layers at gpt2_medium width); with
    ``spec["optimizer"]`` "Lamb", the left half of every fc kernel's
    columns (rank 0's shard at TP 2) scaled by ``spec["scale_fc"]`` before
    the engine takes the model, and the fc masters returned."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.lamb import fused_lamb
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    optimizer = spec.get("optimizer", "Adam")
    counters = _tp_counters()[:3]
    if optimizer == "Lamb":
        counters.append(fused_lamb)
    for c in counters:
        c.launches = 0
    cfg = gpt2.config_for("gpt2_medium", n_layers=2, max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=False)
    conf = {"train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": optimizer,
                          "params": {"lr": spec.get("lr", 1e-4)}},
            "transformer": {"flash_attention": "xla"},
            "steps_per_print": 10 ** 9}
    mesh = None
    if world > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": spec["backend"]}}
        mesh = build_mesh(model=world)
    model = seeded_gpt2(cfg, 1)
    if spec.get("scale_fc"):
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.endswith("fc_kernel"):
                    t[:, :t.shape[1] // 2] *= spec["scale_fc"]
    engine = deepspeed_tpu_torch.initialize(model=model, mesh=mesh,
                                            config_params=conf)[0]
    ids = spec["ids"]
    losses = [float(engine.train_batch(batch=(ids, ids)))
              for _ in range(spec["steps"])]
    out = {"losses": losses,
           "launches": {c.__name__: c.launches for c in counters}}
    if optimizer == "Lamb":
        out["fc"] = _fc_leaves(engine.get_master_params())
    return out


def tp_parity_ranks(rank, world, specs):
    """:func:`tp_parity_rank` for each of ``specs``, in one process."""
    return [tp_parity_rank(rank, world, spec) for spec in specs]


def phase_train_tp_parity(steps=5, tol=1e-5, lamb=None):
    """fp32 loss trajectories at gpt2_medium width with 2 layers, TF32 off,
    plain attention: TP 2 with the ring kernels ("pallas") and with the
    plain ring ("ppermute"), both on the one card over gloo, against the
    port's TP 1 engine from the same init. With ``lamb``
    (:func:`tp_lamb_spec`) the same two ranks then run train_tp_lamb's TP 2
    part, sharing their start-up; its returns come back under
    "lamb_ranks"."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    specs = [{"backend": backend, "ids": ids, "steps": steps}
             for backend in ("pallas", "ppermute")]
    per_rank = spawn(tp_parity_ranks, 2, args=(specs + ([lamb] if lamb
                                                         else []),),
                     timeout_s=600)
    runs = {}
    for i, backend in enumerate(("pallas", "ppermute")):
        ranks = [r[i] for r in per_rank]
        assert ranks[0]["losses"] == ranks[1]["losses"]
        live = backend == "pallas"
        for r in ranks:
            assert all((n > 0) == live for n in r["launches"].values()), r
        runs["tp2_" + backend] = ranks[0]["losses"]
    runs["tp1"] = tp_parity_rank(0, 1, {"ids": ids, "steps": steps})[
        "losses"]
    torch.cuda.empty_cache()
    ref = runs["tp1"]
    rel = {name: max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
           for name, losses in runs.items() if name != "tp1"}
    rel["pallas_vs_ppermute"] = max(
        abs(a - b) / abs(b) for a, b in zip(runs["tp2_pallas"],
                                            runs["tp2_ppermute"]))
    assert max(rel.values()) <= tol, (rel, runs)
    out = {"phase": "train_tp_parity", "layers": 2, "d_model": 1024,
           "dtype": "fp32", "tp": 2, "steps": steps, "losses": runs,
           "max_rel_diff": rel, "tolerance": tol}
    if lamb:
        out["lamb_ranks"] = [r[2] for r in per_rank]
    return out


def tp_lamb_spec(steps=2, scale=20.0):
    """train_tp_lamb's rank spec: LAMB lr 1e-3, rank 0's half of every fc
    kernel scaled by ``scale``."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50304, size=(1, 4, TRAIN_SEQ)).astype(np.int64)
    return {"backend": "pallas", "ids": ids, "steps": steps,
            "optimizer": "Lamb", "lr": 1e-3, "scale_fc": scale}


def phase_train_tp_lamb(spec=None, ranks=None, loss_tol=1e-5,
                        master_atol=5e-5):
    """LAMB under tensor parallelism on the card: fp32, gpt2_medium width
    with 2 layers, TF32 off, plain attention, rank 0's half of every fc
    kernel scaled x20 (shards of unequal norms), TP 2 through the ring and
    LAMB kernels (two gloo ranks on this card) against the TP 1 engine:
    losses and the fc masters, where a ratio taken from one shard's norms
    shows. Tolerances as the CPU test's (tests/test_torch_tp_training.py)."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    spec = spec or tp_lamb_spec()
    steps, scale = spec["steps"], spec["scale_fc"]
    if ranks is None:
        ranks = spawn(tp_parity_rank, 2, args=(spec,), timeout_s=600)
    tp1 = tp_parity_rank(0, 1, spec)
    torch.cuda.empty_cache()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for r in ranks:
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
    assert tp1["launches"]["fused_lamb"] == steps, tp1["launches"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                       tp1["losses"]))
    fc_err = max(float(np.abs(ranks[0]["fc"][name] - w).max())
                 for name, w in tp1["fc"].items())
    assert sorted(ranks[0]["fc"]) == sorted(tp1["fc"]) and tp1["fc"]
    assert loss_rel <= loss_tol and fc_err <= master_atol, \
        (loss_rel, fc_err)
    return {"phase": "train_tp_lamb", "layers": 2, "d_model": 1024,
            "dtype": "fp32", "tp": 2, "steps": steps, "fc_scale": scale,
            "losses": {"tp2": ranks[0]["losses"], "tp1": tp1["losses"]},
            "launches_tp2_rank0": ranks[0]["launches"],
            "loss_max_rel_diff": loss_rel, "fc_master_max_abs_diff": fc_err,
            "tolerance": {"loss_rel": loss_tol, "master_atol": master_atol}}


# ------------------------------------------ data parallelism, ZeRO-1/2 (slice 11)


DP, DP_MICRO, DP_WARMUP, DP_STEPS = 2, 8, 2, 4
DP_SPANS = ("zero.reduce_scatter", "zero.all_gather", "zero.all_reduce")


def _dp_counters():
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.lamb import fused_lamb, fused_lamb_apply
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam,
            fused_lamb, fused_lamb_apply, rg.ring_ag_gemm,
            rg.ring_rs_gemm_add, rg.ring_gc_gemm_acc]


def dp_rows(batch, rank, micro):
    """Data coordinate ``rank``'s rows of a global batch ``(gas, rows,
    ...)``."""
    return tuple(np.ascontiguousarray(x[:, rank * micro:(rank + 1) * micro])
                 for x in batch)


def dp_train_rank(rank, world, spec):
    """One rank of the data-parallel main path: the GPT-2 example's config
    (``examples/gpt2/ds_config_zero2.json``: bf16, ZeRO-2, Adam betas (0.9,
    0.95), weight decay 0.1, clipping 1.0, WarmupDecayLR) at gpt2_medium,
    seq 1024, micro 8 a rank, over ``build_mesh(data=spec["data"],
    model=spec["tp"])`` (TP through ``comm.collective_matmul``); this data
    coordinate's rows of one global batch; counts reset just before the
    timed steps; then a profile step, and the state a rank holds at each
    stage (engines built on the same model without stepping)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf["steps_per_print"] = 10 ** 9
    conf["transformer"] = {"flash_attention": "auto"}
    tp = spec.get("tp", 1)
    if tp > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "pallas"}}
    conf["zero_optimization"] = {"stage": spec.get("stage", 2)}
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT,
                          n_layers=spec["layers"])
    mesh = build_mesh(data=spec["data"], model=tp)
    t0 = time.perf_counter()
    model = seeded_gpt2(cfg, 0)
    engine = deepspeed_tpu_torch.initialize(model=model, mesh=mesh,
                                            config_params=conf)[0]
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda" and engine.dp_world_size == \
        spec["data"] and engine.zero_optimization_stage() == \
        spec.get("stage", 2)
    assert engine.flash_attention_backend == "pallas"
    assert engine.fused_optimizer_kernel == "pallas"
    micro = engine.train_micro_batch_size_per_gpu()
    assert micro == DP_MICRO, micro
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(
        1, micro * spec["data"], TRAIN_SEQ)).astype(np.int64)
    batch = dp_rows((ids, ids.copy()), engine.dp_rank, micro)
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(spec["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _dp_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    step_losses = [engine.train_batch(batch=batch)
                   for _ in range(spec["steps"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(x) for x in step_losses]
    flat = engine.flat
    out = {"rank": rank, "dp_rank": engine.dp_rank, "losses": losses,
           "step_ms": wall * 1e3 / spec["steps"], "init_s": init_s,
           "launches": launches, "peak_memory_gb": peak_gb,
           "transport": torch.distributed.get_backend(),
           "device": str(engine.device), "views": flat.check_views(),
           "numel": flat.numel, "adam_numel": flat.master.numel(),
           "lr": engine.get_lr()[0]}
    groups = ("ReduceScatter", "AllGather", "AllReduce", "flash_", "ring_",
              "Memcpy")
    out["train_profile"] = train_profile(engine, batch, steps=1,
                                         span_names=DP_SPANS,
                                         kernel_groups=groups)
    state = {spec.get("stage", 2): flat.state_bytes()}
    del engine, flat
    torch.cuda.empty_cache()
    for stage in (1, 0) if spec.get("stage_bytes") else ():
        other = dict(conf, zero_optimization={"stage": stage})
        eng = deepspeed_tpu_torch.initialize(model=model, mesh=mesh,
                                             config_params=other)[0]
        state[stage] = eng.flat.state_bytes()
        del eng
        torch.cuda.empty_cache()
    out["state_bytes"] = state
    return out


def phase_train_dp(world=DP, layers=24, tp=1, steps=DP_STEPS):
    """The data-parallel main path: ``world`` spawned ranks (one card: all
    on it over gloo, every collective through host memory, so the step
    time only shows that the path runs; one card each: NCCL). Every rank
    launches fused_adam once a step over its partition (numel / data) and
    each flash kernel once a layer a step; the ranks report the same
    losses, and the loss falls."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    data = world // tp
    spec = {"layers": layers, "warmup": DP_WARMUP, "steps": steps,
            "data": data, "tp": tp, "stage_bytes": tp == 1}
    ranks = spawn(dp_train_rank, world, args=(spec,), timeout_s=900)
    per_step = {"flash_fwd": layers, "flash_bwd_dkdv": layers,
                "flash_bwd_dq": layers, "fused_adam": 1,
                "fused_lamb": 0, "fused_lamb_apply": 0}
    if tp > 1:
        per_step.update((n, 4 * tp * layers) for n in RING_NAMES)
    for r in ranks:
        losses = r["losses"]
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        assert r["views"], r
        assert r["adam_numel"] * data == r["numel"], r
        for name, n in per_step.items():
            assert r["launches"][name] == n * steps, (name, r["launches"])
        assert r["losses"] == ranks[0]["losses"]
    if tp == 1:
        bytes_ = ranks[0]["state_bytes"]
        assert bytes_[1]["master"] * data == bytes_[0]["master"]
        assert bytes_[2]["acc"] * data == bytes_[0]["acc"] == \
            bytes_[1]["acc"]
    step_ms = max(r["step_ms"] for r in ranks)
    prof = ranks[0]["train_profile"]
    return {"phase": "train_dp" if tp == 1 else "train_dp_tp",
            "config": EXAMPLE_CONFIG, "model": "gpt2_medium",
            "layers": layers, "seq": TRAIN_SEQ,
            "micro_batch_per_rank": DP_MICRO, "data": data, "tp": tp,
            "zero_stage": 2, "transport": ranks[0]["transport"],
            "devices": [r["device"] for r in ranks], "steps": steps,
            "step_ms": step_ms,
            "step_ms_note": "ranks share one card and cross host memory for "
                            "every collective over gloo: this time only "
                            "shows that the path runs"
            if ranks[0]["transport"] == "gloo" else "one rank a card, NCCL",
            "host_collective_ms_per_step":
                prof.get("host_ms_per_step_in_spans"),
            "collective_kernel_ms_per_step":
                prof.get("kernel_ms_per_step_by_group"),
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
            "state_bytes_rank0_by_stage": ranks[0]["state_bytes"],
            "launches_per_rank_per_step": per_step,
            "launches": {name: sum(r["launches"][name] for r in ranks)
                         for name in per_step},
            "losses": ranks[0]["losses"], "ranks": ranks}


# 2 layers (4 before the ZeRO-3 phases came: the script's time limit)
DP_PARITY_LAYERS, DP_PARITY_MICRO, DP_PARITY_STEPS = 2, 2, 3


def _dp_parity_conf(prec, stage, backend, optimizer="Adam", lr=1e-4,
                    tp=1):
    conf = {"train_micro_batch_size_per_gpu": DP_PARITY_MICRO,
            "optimizer": {"type": optimizer, "params": {
                "lr": lr, "fused_kernel": backend}},
            "transformer": {"flash_attention": backend},
            "steps_per_print": 10 ** 9}
    if prec == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": stage}
    if tp > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": backend}}
    return conf


def _leaf_items(tree, prefix=""):
    """A JAX-shaped tree -> ``{dotted name: fp32 array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree, np.float32)}
    out = {}
    for key, child in items:
        out.update(_leaf_items(child, "{}{}.".format(prefix, key)))
    return out


def _master_diff(got, want, d_model, init):
    """Largest |got - want| over the master leaves, apart from it over the
    qkv biases' key part (whose exact gradient is zero, softmax rows
    summing to one, so rounding noise alone moves it), and the largest
    over the leaves of how far got's move from ``init`` is from want's,
    by norm, relative to want's (the key part left out)."""
    worst, key_bias, moved = 0.0, 0.0, 0.0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        step = (got[name] - init[name], w - init[name])
        if name.endswith("qkv_bias"):
            key = np.s_[d_model:2 * d_model]
            key_bias = max(key_bias, float(diff[..., key].max()))
            diff = np.delete(diff, key, axis=-1)
            step = tuple(np.delete(a, key, axis=-1) for a in step)
        worst = max(worst, float(diff.max()))
        norm = float(np.linalg.norm(step[1]))
        if norm > 0:
            moved = max(moved, float(np.linalg.norm(step[0] - step[1])) /
                        norm)
    return {"max_abs": worst, "key_bias_max_abs": key_bias,
            "moved_rel": moved}


def _straddling_leaf(model, data):
    """The leaf that straddles rank 1's range at ``data`` ranks and how
    many of its elements lie in rank 0's range (the engine's layout: each
    parameter at a multiple of ALIGN, the whole padded to data x ALIGN)."""
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    sizes = [(n, p.numel()) for n, p in model.named_parameters()]
    numel = sum(-(-n // ALIGN) * ALIGN for _, n in sizes)
    half = -(-numel // (data * ALIGN)) * ALIGN
    off = 0
    for name, n in sizes:
        if off < half < off + n:
            return name, half - off
        off += -(-n // ALIGN) * ALIGN
    raise AssertionError("no leaf straddles rank 1's range")


def dp_parity_model(layers, scale=None, data=DP):
    """gpt2_medium width at ``layers`` layers, seed 1; with ``scale``, rank
    0's part of the leaf straddling rank 1's range scaled by it."""
    import torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", n_layers=layers,
                          max_seq_len=TRAIN_SEQ, loss_chunk=128, remat=False)
    model = seeded_gpt2(cfg, 1)
    if scale:
        name, count = _straddling_leaf(model, data)
        with torch.no_grad():
            dict(model.named_parameters())[name].view(-1)[:count] *= scale
    return model


def dp_parity_rank(rank, world, spec):
    """Every run of ``spec["runs"]`` (name, prec, stage, backend,
    optimizer, scaled) at ``build_mesh(data=spec["data"],
    model=spec["tp"])``, this data coordinate's rows of ``spec["ids"]``,
    TF32 off; per run the losses, the launches, and the gathered masters'
    differences from the single-rank references in ``spec["ref_path"]``
    and from the runs named in ``spec["pairs"]``; with ``spec["ckpt"]``,
    then :func:`dp_ckpt_rank` on it, under the key "ckpt"; with
    ``spec["dp3"]``, then :func:`dp3_rank`, under the key "dp3"; the runs
    named in ``spec["sparse"]`` turn on the sparse embedding-gradient
    exchange over the mesh's data group; with ``spec["pipe3"]``, then
    ``pipe_chip.pipe3_rank`` on it, under the key "pipe3"."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = dict(np.load(spec["ref_path"])) if spec.get("ref_path") else {}
    counters = _dp_counters()
    keep, out = {}, {}
    for name, prec, stage, backend, optimizer, scaled in spec["runs"]:
        mesh = build_mesh(data=spec["data"], model=spec["tp"])
        model = dp_parity_model(spec["layers"], scale=scaled,
                                data=spec["data"])
        if name in spec.get("sparse", ()):
            model.config.sparse_embedding_grads = True
            model.config.embedding_grad_mesh = mesh
        engine = deepspeed_tpu_torch.initialize(
            model=model, mesh=mesh, config_params=_dp_parity_conf(
                prec, stage, backend, optimizer, spec["lr"][optimizer],
                spec["tp"]))[0]
        batch = dp_rows((spec["ids"], spec["ids"]), engine.dp_rank,
                        DP_PARITY_MICRO)
        d_model = model.config.d_model
        init = _leaf_items(engine.get_master_params())
        for c in counters:
            c.launches = 0
        losses = [float(engine.train_batch(batch=batch))
                  for _ in range(spec["steps"])]
        master = _leaf_items(engine.get_master_params())
        res = {"losses": losses,
               "launches": {c.__name__: c.launches for c in counters},
               "adam_numel": engine.flat.master.numel(),
               "numel": engine.flat.numel}
        ref = spec["refs"].get(name)
        if ref:
            want = {k[len(ref) + 1:]: v for k, v in refs.items()
                    if k.startswith(ref + "/")}
            res["vs_" + ref] = _master_diff(master, want, d_model, init)
        for other in spec["pairs"].get(name, ()):
            res["vs_" + other] = _master_diff(master, keep[other], d_model,
                                              init)
            res["bit_equal_" + other] = all(
                np.array_equal(master[k], v) for k, v in keep[other].items())
        if name in spec["keep"]:
            keep[name] = master
        out[name] = res
        del engine, model, master, init
        torch.cuda.empty_cache()
    if spec.get("ckpt"):
        out["ckpt"] = dp_ckpt_rank(rank, world, spec["ckpt"])
    if spec.get("dp3"):
        out["dp3"] = dp3_rank(rank, world, spec["dp3"])
    if spec.get("zeropp"):
        out["zeropp"] = zeropp_rank(rank, world, spec["zeropp"])
    if spec.get("pipe3"):
        out["pipe3"] = _pipe_chip().pipe3_rank(rank, world, spec["pipe3"])
    return out


def dp1_reference(runs, layers, ids, lr, steps, path):
    """The single-rank (and single-model-rank) engine on the whole global
    batch, per run (name, prec, stage, backend, optimizer, scaled): the
    losses, the launches; the masters saved to ``path`` (npz, keyed
    ``run/leaf``)."""
    import torch
    import deepspeed_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _dp_counters()
    out, arrays = {}, {}
    for name, prec, stage, backend, optimizer, scaled in runs:
        model = dp_parity_model(layers, scale=scaled)
        conf = _dp_parity_conf(prec, stage, backend, optimizer, lr[optimizer])
        conf["train_micro_batch_size_per_gpu"] = ids.shape[1]
        engine = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=conf)[0]
        for c in counters:
            c.launches = 0
        losses = [float(engine.train_batch(batch=(ids, ids)))
                  for _ in range(steps)]
        out[name] = {"losses": losses,
                     "launches": {c.__name__: c.launches for c in counters}}
        arrays.update(("{}/{}".format(name, k), v) for k, v in
                      _leaf_items(engine.get_master_params()).items())
        del engine, model
        torch.cuda.empty_cache()
    np.savez(path, **arrays)
    return out


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_train_dp_parity(loss_tol=1e-4, master_atol=5e-5, moved_rtol=0.25,
                          scale=20.0, ckpt=None, dp3=None, zeropp=None):
    """DP 2 on the card (two gloo ranks) at gpt2_medium width with
    ``DP_PARITY_LAYERS`` layers (2; 4 before the ZeRO-3 phases came, cut
    for the script's time limit), seq 1024, micro 2 a rank, TF32 off:
    with the kernels against
    DP 1 with the kernels on the same global batch, and against DP 2 with
    the plain versions; fp32 (stage 0: ZeRO needs bf16) and bf16 at stages
    0, 1 and 2 (equal bit for bit: every stage sums in the accumulator's
    dtype and Adam is elementwise); LAMB at bf16, stages 0 and 2, with
    rank 0's part of the leaf straddling the two ranges scaled x20, stage
    2 (trust ratios from the data group's sums) against stage 0 (each
    rank the whole leaf) and DP 1. Losses within ``loss_tol`` relative;
    masters (:func:`_check_masters`) within ``master_atol`` absolute at
    fp32 and between LAMB's stages, and at bf16 across runs that round
    their gradients differently each leaf's move within ``moved_rtol`` of
    the reference's. With ``ckpt`` (:func:`dp_ckpt_spec`) the ranks then
    run train_dp_ckpt's DP 2 part (:func:`dp_ckpt_rank`), sharing their
    start-up; its returns come back under "dp_ckpt_ranks"; with ``dp3``
    (train_dp3's rank spec) they then run train_dp3's four engines, whose
    returns come back under "dp3_ranks"; with ``zeropp`` (train_zeropp's
    rank spec, :func:`zeropp_spec`) its legs, under "zeropp_ranks"."""
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 50304, size=(1, DP_PARITY_MICRO * DP, TRAIN_SEQ)) \
        .astype(np.int64)
    lr = {"Adam": 1e-4, "Lamb": 1e-3}
    runs = [("fp32/pallas/s0", "fp32", 0, "pallas", "Adam", None),
            ("fp32/xla/s0", "fp32", 0, "xla", "Adam", None),
            ("bf16/pallas/s0", "bf16", 0, "pallas", "Adam", None),
            ("bf16/pallas/s1", "bf16", 1, "pallas", "Adam", None),
            ("bf16/pallas/s2", "bf16", 2, "pallas", "Adam", None),
            ("bf16/xla/s2", "bf16", 2, "xla", "Adam", None),
            ("lamb/pallas/s0", "bf16", 0, "pallas", "Lamb", scale),
            ("lamb/pallas/s2", "bf16", 2, "pallas", "Lamb", scale)]
    dp1_runs = [("dp1/fp32", "fp32", 0, "pallas", "Adam", None),
                ("dp1/bf16", "bf16", 2, "pallas", "Adam", None),
                ("dp1/lamb", "bf16", 2, "pallas", "Lamb", scale)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dp1.npz")
        dp1 = dp1_reference(dp1_runs, DP_PARITY_LAYERS, ids, lr,
                            DP_PARITY_STEPS, path)
        spec = {"runs": runs, "data": DP, "tp": 1, "ids": ids, "lr": lr,
                "layers": DP_PARITY_LAYERS, "steps": DP_PARITY_STEPS,
                "ref_path": path,
                "refs": {"fp32/pallas/s0": "dp1/fp32",
                         "bf16/pallas/s2": "dp1/bf16",
                         "lamb/pallas/s2": "dp1/lamb"},
                "pairs": {"fp32/xla/s0": ("fp32/pallas/s0",),
                          "bf16/pallas/s1": ("bf16/pallas/s0",),
                          "bf16/pallas/s2": ("bf16/pallas/s0",),
                          "bf16/xla/s2": ("bf16/pallas/s2",),
                          "lamb/pallas/s2": ("lamb/pallas/s0",)},
                "keep": ("fp32/pallas/s0", "bf16/pallas/s0",
                         "bf16/pallas/s2", "lamb/pallas/s0"),
                "ckpt": ckpt, "dp3": dp3, "zeropp": zeropp}
        ranks = spawn(dp_parity_rank, DP, args=(spec,), timeout_s=900)
    torch.cuda.empty_cache()
    ckpt_ranks = [r.pop("ckpt") for r in ranks] if ckpt else None
    dp3_ranks = [r.pop("dp3") for r in ranks] if dp3 else None
    zeropp_ranks = [r.pop("zeropp") for r in ranks] if zeropp else None
    r0 = ranks[0]
    for r in ranks:
        for name in r0:
            assert r[name]["losses"] == r0[name]["losses"], name
    losses = {name: r0[name]["losses"] for name in r0}
    losses.update((name, d["losses"]) for name, d in dp1.items())
    rel = {"fp32: dp2 vs dp1": _rel(losses["fp32/pallas/s0"],
                                    losses["dp1/fp32"]),
           "fp32: kernels vs plain": _rel(losses["fp32/pallas/s0"],
                                          losses["fp32/xla/s0"]),
           "bf16: dp2 vs dp1": _rel(losses["bf16/pallas/s2"],
                                    losses["dp1/bf16"]),
           "bf16: kernels vs plain": _rel(losses["bf16/pallas/s2"],
                                          losses["bf16/xla/s2"]),
           "lamb: stage 2 vs stage 0": _rel(losses["lamb/pallas/s2"],
                                            losses["lamb/pallas/s0"]),
           "lamb: dp2 vs dp1": _rel(losses["lamb/pallas/s2"],
                                    losses["dp1/lamb"])}
    masters = {"fp32: dp2 vs dp1": r0["fp32/pallas/s0"]["vs_dp1/fp32"],
               "fp32: kernels vs plain":
                   r0["fp32/xla/s0"]["vs_fp32/pallas/s0"],
               "bf16: dp2 vs dp1": r0["bf16/pallas/s2"]["vs_dp1/bf16"],
               "bf16: kernels vs plain":
                   r0["bf16/xla/s2"]["vs_bf16/pallas/s2"],
               "lamb: stage 2 vs stage 0":
                   r0["lamb/pallas/s2"]["vs_lamb/pallas/s0"],
               "lamb: dp2 vs dp1": r0["lamb/pallas/s2"]["vs_dp1/lamb"]}
    stages_equal = {s: r0["bf16/pallas/" + s]["bit_equal_bf16/pallas/s0"]
                    and losses["bf16/pallas/" + s] == losses["bf16/pallas/s0"]
                    for s in ("s1", "s2")}
    result = {"phase": "train_dp_parity", "layers": DP_PARITY_LAYERS,
              "d_model": 1024, "seq": TRAIN_SEQ,
              "micro_batch_per_rank": DP_PARITY_MICRO, "data": DP,
              "steps": DP_PARITY_STEPS, "lr": lr, "lamb_scale": scale,
              "losses": losses, "loss_max_rel_diff": rel,
              "master_max_abs_diff": masters,
              "bf16_stages_bit_equal_to_stage_0": stages_equal,
              "launches_rank0": {n: r0[n]["launches"] for n in r0},
              "tolerance": {"loss_rel": loss_tol,
                            "master_atol": master_atol,
                            "moved_rel": moved_rtol}}
    steps = DP_PARITY_STEPS
    for r in ranks:
        for name, res in r.items():
            live = "/pallas/" in name
            counts = res["launches"]
            opt = "fused_lamb" if name.startswith("lamb") else "fused_adam"
            assert (counts["flash_fwd"] == DP_PARITY_LAYERS * steps) == \
                live, (name, counts)
            assert (counts[opt] == steps) == live, (name, counts)
            if name.endswith("s2") or name.endswith("s1"):
                assert res["adam_numel"] * DP == res["numel"], (name, res)
    for name, d in dp1.items():
        assert d["launches"]["flash_fwd"] == DP_PARITY_LAYERS * steps, d
    assert all(stages_equal.values()), result
    assert max(rel.values()) <= loss_tol, result
    _check_masters(masters, master_atol, moved_rtol, result)
    if ckpt:
        result["dp_ckpt_ranks"] = ckpt_ranks
    if dp3:
        result["dp3_ranks"] = dp3_ranks
    if zeropp:
        result["zeropp_ranks"] = zeropp_ranks
    return result


def _check_masters(masters, atol, moved_rtol, result):
    """Pairs that round alike (fp32; LAMB's stages at bf16) within ``atol``
    everywhere; bf16 pairs that round their gradients differently by how
    far each leaf moved (within ``moved_rtol`` of the reference's move),
    since an Adam or LAMB step moves an element whose gradient is rounding
    noise by up to lr either way."""
    for pair, m in masters.items():
        if pair.startswith("fp32") or "stage 2 vs stage 0" in pair:
            assert max(m["max_abs"], m["key_bias_max_abs"]) <= atol, \
                (pair, result)
        else:
            assert m["moved_rel"] <= moved_rtol, (pair, result)


def phase_train_dp_tp_parity(layers=2, loss_tol=1e-4, master_atol=5e-5,
                             moved_rtol=0.25, pipe3=None, zeropp=None):
    """DP 2 x TP 2 on the card: four gloo ranks over ``build_mesh(data=2,
    model=2)`` (the ring kernels for the TP matmuls, flash, Adam), fp32
    stage 0 and bf16 stage 2, at gpt2_medium width with ``layers`` layers,
    TF32 off, against DP 1 x TP 1 on the same global batch: losses within
    ``loss_tol`` relative, masters as :func:`_check_masters` holds them.
    Then ZeRO stage 3 under TP (bf16; its units hold each rank's TP
    shards, gathered over the data group): equal to stage 2 bit for bit,
    losses and masters; and stage 3 with ``sparse_embedding_grads`` (the
    ``(ids, rows)`` exchange over the data group inside the embedding
    unit's recompute) against the dense-gradient stage 3: losses within
    ``loss_tol``, masters' moves within ``moved_rtol``. The flash forward
    runs twice a layer at stage 3 (the unit's recompute), the ring
    kernels more than at stage 2. Depth 2 keeps the phase inside the
    script's time limit. Stage 3 under TP gathers its units as the ring
    (``zero_gather``, on by default with the section). With ``zeropp``
    (:func:`zeropp_spec`) the same four ranks then run train_zeropp's DP 4
    legs (hpZ), returned under "zeropp_ranks"; with ``pipe3``
    (:func:`pipe3_spec`) train_pipe3's runs, under "pipe3_ranks"."""
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 50304, size=(1, DP_PARITY_MICRO * DP, TRAIN_SEQ)) \
        .astype(np.int64)
    lr = {"Adam": 1e-4}
    runs = [("fp32", "fp32", 0, "pallas", "Adam", None),
            ("bf16", "bf16", 2, "pallas", "Adam", None)]
    zero3 = [("bf16_s3", "bf16", 3, "pallas", "Adam", None),
             ("bf16_s3_sparse", "bf16", 3, "pallas", "Adam", None)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dp1.npz")
        dp1 = dp1_reference([("dp1/" + r[0],) + r[1:] for r in runs],
                            layers, ids, lr, DP_PARITY_STEPS, path)
        spec = {"runs": runs + zero3, "data": 2, "tp": 2, "ids": ids,
                "lr": lr, "layers": layers, "steps": DP_PARITY_STEPS,
                "ref_path": path,
                "refs": {"fp32": "dp1/fp32", "bf16": "dp1/bf16"},
                "pairs": {"bf16_s3": ("bf16",),
                          "bf16_s3_sparse": ("bf16_s3",)},
                "keep": ("bf16", "bf16_s3"),
                "sparse": ("bf16_s3_sparse",), "pipe3": pipe3,
                "zeropp": zeropp}
        ranks = spawn(dp_parity_rank, 4, args=(spec,), timeout_s=900)
    torch.cuda.empty_cache()
    pipe3_ranks = [r.pop("pipe3") for r in ranks] if pipe3 else None
    zeropp_ranks = [r.pop("zeropp") for r in ranks] if zeropp else None
    r0 = ranks[0]
    names = [r[0] for r in runs]
    rel = {name: _rel(r0[name]["losses"], dp1["dp1/" + name]["losses"])
           for name in names}
    masters = {name: r0[name]["vs_dp1/" + name] for name in names}
    stage3 = {
        "bit_equal_stage3_vs_stage2": r0["bf16_s3"]["bit_equal_bf16"] and
        r0["bf16_s3"]["losses"] == r0["bf16"]["losses"],
        "sparse_vs_dense_loss_rel": _rel(r0["bf16_s3_sparse"]["losses"],
                                         r0["bf16_s3"]["losses"]),
        "sparse_vs_dense_master": r0["bf16_s3_sparse"]["vs_bf16_s3"]}
    result = {"phase": "train_dp_tp_parity", "layers": layers,
              "d_model": 1024, "seq": TRAIN_SEQ, "data": 2, "tp": 2,
              "micro_batch_per_rank": DP_PARITY_MICRO,
              "steps": DP_PARITY_STEPS,
              "losses": {"dp2_tp2": {n: r0[n]["losses"] for n in r0},
                         "dp1_tp1": {n: d["losses"]
                                     for n, d in dp1.items()}},
              "loss_max_rel_diff": rel, "master_max_abs_diff": masters,
              "stage3": stage3,
              "launches_rank0": {n: r0[n]["launches"] for n in r0},
              "tolerance": {"loss_rel": loss_tol,
                            "master_atol": master_atol,
                            "moved_rel": moved_rtol}}
    for r in ranks:
        for name in r0:
            assert r[name]["losses"] == r0[name]["losses"], name
            counts = r[name]["launches"]
            recompute = 2 if name.startswith("bf16_s3") else 1
            assert counts["flash_fwd"] == \
                recompute * layers * DP_PARITY_STEPS, counts
            for kernel in ("flash_bwd_dkdv", "flash_bwd_dq"):
                assert counts[kernel] == layers * DP_PARITY_STEPS, counts
            assert counts["fused_adam"] == DP_PARITY_STEPS, counts
            if recompute == 1:
                assert all(counts[n] == 4 * 2 * layers * DP_PARITY_STEPS
                           for n in RING_NAMES), (name, counts)
            else:
                assert all(counts[n] >= r["bf16"]["launches"][n] > 0
                           for n in RING_NAMES), (name, counts)
    assert max(rel.values()) <= loss_tol, result
    _check_masters(masters, master_atol, moved_rtol, result)
    assert stage3["bit_equal_stage3_vs_stage2"], result
    assert stage3["sparse_vs_dense_loss_rel"] <= loss_tol, result
    assert stage3["sparse_vs_dense_master"]["moved_rel"] <= moved_rtol, \
        result
    result["pipe3_ranks"] = pipe3_ranks
    result["zeropp_ranks"] = zeropp_ranks
    return result


def nccl_rank(rank, world, spec):
    """One rank of the multi-card run: each site's ring op (kernels, and
    the plain ring) against the unfused reference (all_gather_into_tensor
    + torch.matmul, or torch.matmul + reduce_scatter_tensor), by CUDA
    events with a barrier before each timed call; then the TP train step."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    group = dist.group.WORLD
    device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(rank)
    b, s = TP_B, TP_S
    s_loc = s // world
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                     dtype=torch.bfloat16)

    def timed(fn, reps=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def ring_err(got, want):
        # the same products; the sums of the partials round in bf16 in
        # another order (the ring adds one a hop, NCCL its own way)
        err = (got.float() - want.float()).abs()
        bound = 2 ** -5 * want.float().abs() + \
            2 ** -10 * float(want.float().abs().max())
        assert bool((err <= bound).all()), float(err.max())

    ops = {}
    for site, f in (("qkv", 3 * TP_D), ("fc", 4 * TP_D)):
        x, w = rnd(b, s_loc, TP_D), rnd(TP_D, f // world)
        full = torch.empty(b, s, TP_D, device=device, dtype=torch.bfloat16)

        def unfused():
            dist.all_gather_into_tensor(full.view(world * b, s_loc, TP_D),
                                        x)
            return torch.matmul(full.view(world, b, s_loc, TP_D)
                                .transpose(0, 1).reshape(b, s, TP_D), w)
        ring_err(rg.ag_matmul(x, w, group), unfused())
        ops["ag_" + site] = {
            "kernels_ms": timed(lambda: rg.ag_matmul(x, w, group)),
            "plain_ring_ms": timed(lambda: rg.ag_matmul(x, w, group,
                                                        use_kernel=False)),
            "unfused_ms": timed(unfused)}
    for site, f in (("attn_proj", TP_D), ("mlp_proj", 4 * TP_D)):
        x, w = rnd(b, s, f // world), rnd(f // world, TP_D)
        out = torch.empty(b, s_loc, TP_D, device=device,
                          dtype=torch.bfloat16)

        def unfused():
            part = torch.matmul(x, w).view(b, world, s_loc, TP_D) \
                .transpose(0, 1).contiguous()
            dist.reduce_scatter_tensor(out, part.view(world * b, s_loc,
                                                      TP_D))
            return out
        ring_err(rg.matmul_rs(x, w, group), unfused())
        ops["rs_" + site] = {
            "kernels_ms": timed(lambda: rg.matmul_rs(x, w, group)),
            "plain_ring_ms": timed(lambda: rg.matmul_rs(x, w, group,
                                                        use_kernel=False)),
            "unfused_ms": timed(unfused)}
    for site, f in (("qkv_dw", 3 * TP_D), ("fc_dw", 4 * TP_D)):
        x, dy = rnd(b, s_loc, TP_D), rnd(b, s, f // world)
        full = torch.empty(b, s, TP_D, device=device, dtype=torch.bfloat16)

        def unfused():
            dist.all_gather_into_tensor(full.view(world * b, s_loc, TP_D),
                                        x)
            gathered = full.view(world, b, s_loc, TP_D).transpose(0, 1)
            return torch.matmul(gathered.reshape(-1, TP_D).t(),
                                dy.reshape(-1, f // world))
        ring_err(rg.gather_contract(x, dy, group), unfused())
        ops["gc_" + site] = {
            "kernels_ms": timed(lambda: rg.gather_contract(x, dy, group)),
            "plain_ring_ms": timed(lambda: rg.gather_contract(
                x, dy, group, use_kernel=False)),
            "unfused_ms": timed(unfused)}
    torch.cuda.empty_cache()
    train = {backend: tp_train_rank(rank, world, dict(spec,
                                                      backend=backend))
             for backend in ("pallas", "ppermute")}
    return {"rank": rank, "ops": ops, "train": train}


def main_tp_nccl():
    """``--tp-nccl``: tensor parallelism with one rank per card over NCCL
    at TP 2 and TP 4 (needs 4 cards): the ring ops against the unfused
    collective + matmul, and the train_tp step on both backends."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    count = torch.cuda.device_count()
    assert count >= 4, "--tp-nccl needs 4 cards, found {}".format(count)
    spec = {"layers": TP_LAYERS, "warmup": TP_WARMUP, "steps": 5}
    for world in (2, 4):
        ranks = spawn(nccl_rank, world, args=(spec,), timeout_s=900)
        for r in ranks:
            for backend, t in r["train"].items():
                assert t["transport"] == "nccl", t
                assert t["losses"][-1] < t["losses"][0], t
        emit({"phase": "tp_nccl", "tp": world, "transport": "nccl",
              "ops_rank0": ranks[0]["ops"],
              "ops_max_over_ranks": {
                  op: {k: max(r["ops"][op][k] for r in ranks)
                       for k in ranks[0]["ops"][op]}
                  for op in ranks[0]["ops"]},
              "train_step_ms": {
                  backend: max(r["train"][backend]["step_ms"]
                               for r in ranks)
                  for backend in ("pallas", "ppermute")},
              "peak_memory_gb": max(r["train"]["pallas"]["peak_memory_gb"]
                                    for r in ranks),
              "losses": ranks[0]["train"]["pallas"]["losses"],
              "launches_rank0": ranks[0]["train"]["pallas"]["launches"],
              "shape": {"b": TP_B, "s": TP_S, "d_model": TP_D,
                        "layers": TP_LAYERS, "dtype": "bf16"}})
    # ZeRO stage 3 under TP: DP 2 x TP 2 at gpt2_medium full depth (the
    # example's config), stage 3 against stage 2 from the same weights
    runs = {}
    for stage in (2, 3):
        ranks = spawn(dp_train_rank, 4, args=(dict(
            data=2, tp=2, layers=24, warmup=DP_WARMUP, steps=DP_STEPS,
            stage=stage),), timeout_s=900)
        assert all(r["transport"] == "nccl" for r in ranks), ranks
        runs[stage] = ranks
    r2, r3 = runs[2][0], runs[3][0]
    result = {
        "phase": "tp_nccl_zero3", "data": 2, "tp": 2, "layers": 24,
        "transport": "nccl",
        "step_ms": {s: max(r["step_ms"] for r in runs[s]) for s in runs},
        "losses": {s: runs[s][0]["losses"] for s in runs},
        "loss_max_rel_diff": _rel(r3["losses"], r2["losses"]),
        "bit_equal_losses": r3["losses"] == r2["losses"],
        "peak_memory_gb": {s: max(r["peak_memory_gb"] for r in runs[s])
                           for s in runs},
        "nccl_and_ring_kernel_ms_per_step_rank0": {
            s: runs[s][0]["train_profile"]["kernel_ms_per_step_by_group"]
            for s in runs},
        "device_busy_share_rank0": {
            s: runs[s][0]["train_profile"]["device_busy_share"]
            for s in runs},
        "launches_rank0": {s: runs[s][0]["launches"] for s in runs},
        "tolerance": {"loss_rel": 1e-3}}
    emit(result)
    assert result["loss_max_rel_diff"] <= 1e-3, result


def nccl_ckpt_rank(rank, world, spec):
    """One rank of ``--dp-nccl``'s checkpoint run: the GPT-2 example's
    config at gpt2_medium, DP 4 (ZeRO-2) for 2 steps, a save into
    ``spec["dir"]``, one more step; then DP 2 x TP 2 (the ring kernels)
    loads the tag and takes that step on the same global batch."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=False)
    state = {k: v.clone() for k, v in
             seeded_gpt2(cfg, 0).state_dict().items()}
    out = {"transport": torch.distributed.get_backend()}
    for data, tp in ((world, 1), (world // 2, 2)):
        model = gpt2.GPT2Model(cfg)
        model.load_state_dict(state)
        micro = spec["rows"] // data
        conf = _example_conf(micro)
        if tp > 1:
            conf["comm"] = {"collective_matmul": {"enabled": True,
                                                  "backend": "pallas"}}
        engine = deepspeed_tpu_torch.initialize(
            model=model, mesh=build_mesh(data=data, model=tp),
            config_params=conf)[0]
        batch = dp_rows((spec["ids"], spec["ids"]), engine.dp_rank, micro)
        key = "dp{}_tp{}".format(data, tp)
        if tp == 1:
            losses = [float(engine.train_batch(batch=batch))
                      for _ in range(CKPT_STEPS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.save_checkpoint(spec["dir"], tag="t")
            out["save_s"] = time.perf_counter() - t0
            out[key] = {"losses": losses}
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path, _ = engine.load_checkpoint(spec["dir"])
            torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
            assert path is not None
            out[key] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[key]["next_loss"] = float(engine.train_batch(batch=batch))
        out[key]["next_step_ms"] = (time.perf_counter() - t0) * 1e3
        del engine, model
        torch.cuda.empty_cache()
    return out


def main_dp_nccl():
    """``--dp-nccl``: the data-parallel main path with one rank per card
    over NCCL (needs 4 cards): DP 4, and DP 2 x TP 2; the step and the
    reduce-scatter and all-gather kernels' device time a step; then
    :func:`phase_dp_nccl_ckpt`."""
    import torch
    count = torch.cuda.device_count()
    assert count >= 4, "--dp-nccl needs 4 cards, found {}".format(count)
    for tp in (1, 2):
        res = phase_train_dp(world=4, tp=tp)
        assert res["transport"] == "nccl", res["transport"]
        res["phase"] = "dp_nccl"
        emit(res)
    emit(phase_dp_nccl_ckpt())
    emit(phase_dp_nccl_zero3())


def phase_dp_nccl_ckpt(loss_tol=5e-4):
    """A tag saved at DP 4 resumes at DP 2 x TP 2, one rank per card over
    NCCL (4 cards): the next step's loss within ``loss_tol`` (bf16: the
    two layouts sum in other orders) of DP 4's; the save and load
    seconds."""
    import tempfile
    from deepspeed_tpu_torch.utils.distributed import spawn
    rows = DP_MICRO * 4
    ids = np.random.RandomState(6).randint(
        0, 50304, size=(1, rows, TRAIN_SEQ)).astype(np.int64)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_ckpt_") as tmp:
        ranks = spawn(nccl_ckpt_rank, 4, args=({"ids": ids, "rows": rows,
                                                "dir": tmp},),
                      timeout_s=900)
    r0 = ranks[0]
    want, got = r0["dp4_tp1"]["next_loss"], r0["dp2_tp2"]["next_loss"]
    res = {"phase": "dp_nccl_ckpt", "transport": r0["transport"],
           "saved_at": "DP 4", "loaded_at": "DP 2 x TP 2",
           "model": "gpt2_medium", "config": EXAMPLE_CONFIG,
           "save_s": max(r["save_s"] for r in ranks),
           "load_s": max(r["load_s"] for r in ranks),
           "losses_dp4": r0["dp4_tp1"]["losses"], "next_loss_dp4": want,
           "next_loss_dp2_tp2": got, "loss_rel_diff": abs(got - want) /
           abs(want), "loss_tol": loss_tol,
           "next_step_ms": {k: max(r[k]["next_step_ms"] for r in ranks)
                            for k in ("dp4_tp1", "dp2_tp2")}}
    assert r0["transport"] == "nccl", res
    assert all(r["dp2_tp2"]["next_loss"] == got for r in ranks), res
    assert res["loss_rel_diff"] <= loss_tol, res
    return res


# ------------------------ checkpoints and activation checkpointing (slice 12)


CKPT_STEPS = 2
# predicted tag bytes a parameter: bf16 module + fp32 master + bf16 moments
# (3.55 GB at gpt2_medium's full depth)
CKPT_TAG_BYTES_PER_PARAM = 10


def _bench_engine(seed, layers=None, micro=TRAIN_MICRO, seq=TRAIN_SEQ,
                  remat=TRAIN_REMAT, policy="full", state=None):
    """bench.py's rung engine (``TRAIN_CONFIG``: bf16, ZeRO-2, Adam with
    bf16 moments and accumulator) on gpt2_medium, from ``seed`` or from a
    CPU ``state`` dict of its weights."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=seq, loss_chunk=128,
                          remat=remat, remat_policy=policy,
                          **({"n_layers": layers} if layers else {}))
    if state is None:
        model = seeded_gpt2(cfg, seed)
    else:
        model = gpt2.GPT2Model(cfg)
        model.load_state_dict(state)
    conf = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config_params=conf)[0]
    assert engine.device.type == "cuda"
    assert engine.flash_attention_backend == "pallas"
    assert engine.fused_optimizer_kernel == "pallas"
    return engine, cfg


def _flat_state(engine):
    flat = engine.flat
    return [t.detach().clone() for t in (flat.master, flat.exp_avg,
                                         flat.exp_avg_sq)]


def _max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_train_ckpt(launch_counters, layers=None, micro=TRAIN_MICRO,
                     seq=TRAIN_SEQ):
    """Save and resume on the training main path at bench.py's first rung:
    2 steps, a synchronous ``save_checkpoint`` into a temporary directory,
    2 more steps; a fresh engine from another seed ``load_checkpoint``s
    the tag (``verify_tag`` first) and runs the same 2 steps. The losses
    and the fp32 masters and both moments of the two runs must be equal
    bit for bit; counts set to 0 just before the resumed steps and read
    just after. Prints save and load seconds, the tag's bytes by file and
    the free disk before the save; the directory is deleted."""
    import shutil
    import tempfile
    import torch
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    from deepspeed_tpu_torch.models import gpt2
    engine, cfg = _bench_engine(0, layers, micro, seq)
    tag_gb = CKPT_TAG_BYTES_PER_PARAM * gpt2.num_params(cfg) / 1e9
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, micro, seq)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(CKPT_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        assert free_gb > 2 * tag_gb, \
            "{:.2f} GB free for a {:.2f} GB tag".format(free_gb, tag_gb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.save_checkpoint(tmp, tag="t")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok, why = ckpt.verify_tag(tmp, "t")
        verify_s = time.perf_counter() - t0
        assert ok, why
        files = ckpt.read_manifest(tmp, "t")["files"]
        tag_bytes = {name: rec["bytes"] for name, rec in files.items()}
        kept = [float(engine.train_batch(batch=batch))
                for _ in range(CKPT_STEPS)]
        kept_state = _flat_state(engine)
        del engine
        torch.cuda.empty_cache()
        other, _ = _bench_engine(1, layers, micro, seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, client = other.load_checkpoint(tmp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert path is not None and other.global_steps == CKPT_STEPS
        for counter in launch_counters:
            counter.launches = 0
        resumed = [float(other.train_batch(batch=batch))
                   for _ in range(CKPT_STEPS)]
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in launch_counters}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = ("master", "exp_avg", "exp_avg_sq")
    equal = {n: bool(torch.equal(a, b)) for n, a, b in
             zip(names, _flat_state(other), kept_state)}
    diff = {n: _max_abs(a, b) for n, a, b in
            zip(names, _flat_state(other), kept_state)}
    result = {"phase": "train_ckpt", "model": "gpt2_medium",
              "layers": cfg.n_layers, "seq": seq, "micro_batch": micro,
              "dtype": "bf16", "zero_stage": 2, "moments": "bf16",
              "free_disk_gb_before_save": free_gb, "save_s": save_s,
              "verify_s": verify_s, "load_s": load_s,
              "tag_bytes": tag_bytes,
              "tag_gb": sum(tag_bytes.values()) / 1e9,
              "predicted_tag_gb": tag_gb, "layers": cfg.n_layers,
              "losses_before_save": losses, "losses_kept_going": kept,
              "losses_resumed": resumed, "state_bit_equal": equal,
              "state_max_abs_diff": diff, "launches_resumed": launches}
    assert resumed == kept and all(equal.values()), result
    for name in FLASH_GROUPS:
        assert launches[name] == cfg.n_layers * CKPT_STEPS, result
    assert launches["fused_adam"] == CKPT_STEPS, result
    return result


def _example_conf(micro):
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf.update(steps_per_print=10 ** 9,
                train_micro_batch_size_per_gpu=micro,
                transformer={"flash_attention": "auto"})
    return conf


DP_CKPT_LAYERS = 2


def dp_ckpt_rank(rank, world, spec):
    """One rank of ``train_dp_ckpt``: the GPT-2 example's config at
    gpt2_medium width with ``DP_CKPT_LAYERS`` layers over
    ``build_mesh(data=world)``, 2 steps, ``save_checkpoint`` into
    ``spec["dir"]`` (every rank its zero file), the gathered master then
    (``spec["saved"]``, npz), one more step and the master after it
    (``spec["next"]``)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=False,
                          n_layers=DP_CKPT_LAYERS)
    model = seeded_gpt2(cfg, 0)
    engine = deepspeed_tpu_torch.initialize(
        model=model, mesh=build_mesh(data=world),
        config_params=_example_conf(DP_MICRO))[0]
    assert engine.device.type == "cuda" and engine.dp_world_size == world
    batch = dp_rows((spec["ids"], spec["ids"]), engine.dp_rank, DP_MICRO)
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(CKPT_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(spec["dir"], tag="t")
    save_s = time.perf_counter() - t0
    saved = _leaf_items(engine.get_master_params())
    next_loss = float(engine.train_batch(batch=batch))
    after = _leaf_items(engine.get_master_params())
    if rank == 0:
        np.savez(spec["saved"], **saved)
        np.savez(spec["next"], **after)
    return {"losses": losses, "next_loss": next_loss, "save_s": save_s,
            "lr": engine.get_lr()[0],
            "transport": torch.distributed.get_backend()}


def dp_ckpt_spec(tmp):
    """:func:`dp_ckpt_rank`'s spec: the global batch (seed 5), the tag
    directory and the npz files of the masters, all under ``tmp``."""
    import os
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 50304, size=(1, DP_MICRO * DP, TRAIN_SEQ)) \
        .astype(np.int64)
    return {"ids": ids, "dir": os.path.join(tmp, "tags"),
            "saved": os.path.join(tmp, "saved.npz"),
            "next": os.path.join(tmp, "next.npz")}


def phase_train_dp_ckpt(launch_counters, loss_tol=1e-4, moved_rtol=0.25,
                        spec=None, ranks=None):
    """Elastic resume on the card: DP 2 (two gloo ranks on this card,
    ZeRO-2, the example's config at gpt2_medium width, 2 layers) saves
    after 2 steps and takes one more; DP 1 in this process (the same
    global batch) loads the tag: its master equals DP 2's at the save bit
    for bit, and after the next step the loss and masters agree with DP
    2's within ``train_dp_parity``'s bf16 bounds (loss ``loss_tol``
    relative; each leaf's move within ``moved_rtol`` of DP 2's). Counts
    set to 0 just before the resumed step and read just after. ``spec``
    and ``ranks``: the spec and the ranks' returns where train_dp_parity's
    ranks ran :func:`dp_ckpt_rank`; without them it is spawned here."""
    import os
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.distributed import spawn
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_ckpt_") as tmp:
        if ranks is None:
            spec = dp_ckpt_spec(tmp)
            ranks = spawn(dp_ckpt_rank, DP, args=(spec,), timeout_s=900)
        ids = spec["ids"]
        torch.cuda.empty_cache()
        saved, after = dict(np.load(spec["saved"])), dict(np.load(
            spec["next"]))
        files = sorted(os.listdir(os.path.join(spec["dir"], "t")))
        cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                              loss_chunk=128, remat=False,
                              n_layers=DP_CKPT_LAYERS)
        engine = deepspeed_tpu_torch.initialize(
            model=seeded_gpt2(cfg, 1),
            config_params=_example_conf(DP_MICRO * DP))[0]
        t0 = time.perf_counter()
        path, _ = engine.load_checkpoint(spec["dir"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    assert path is not None
    loaded = _leaf_items(engine.get_master_params())
    bit_equal = all(np.array_equal(loaded[k], v) for k, v in saved.items())
    for counter in launch_counters:
        counter.launches = 0
    loss = float(engine.train_batch(batch=(ids, ids)))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in launch_counters}
    diff = _master_diff(_leaf_items(engine.get_master_params()), after,
                        cfg.d_model, saved)
    r0 = ranks[0]
    rel = abs(loss - r0["next_loss"]) / abs(r0["next_loss"])
    result = {"phase": "train_dp_ckpt", "config": EXAMPLE_CONFIG,
              "model": "gpt2_medium", "layers": DP_CKPT_LAYERS,
              "seq": TRAIN_SEQ, "saved_at": {"data": DP, "zero_stage": 2,
                                             "micro_per_rank": DP_MICRO},
              "loaded_at": {"data": 1, "micro": DP_MICRO * DP},
              "transport": r0["transport"], "tag_files": files,
              "save_s_per_rank": [r["save_s"] for r in ranks],
              "load_s": load_s, "losses_dp2": r0["losses"],
              "next_loss_dp2": r0["next_loss"], "next_loss_dp1": loss,
              "loss_rel_diff": rel, "master_bit_equal_at_load": bit_equal,
              "master_after_next_step": diff,
              "lr_dp2": r0["lr"], "lr_dp1": engine.get_lr()[0],
              "launches_resumed": launches,
              "tolerance": {"loss_rel": loss_tol, "moved_rel": moved_rtol}}
    assert all(r["losses"] == r0["losses"] for r in ranks), result
    assert bit_equal and rel <= loss_tol, result
    assert diff["moved_rel"] <= moved_rtol, result
    assert result["lr_dp1"] == result["lr_dp2"], result
    for name in FLASH_GROUPS:
        assert launches[name] == DP_CKPT_LAYERS, result
    assert launches["fused_adam"] == 1, result
    del engine
    torch.cuda.empty_cache()
    return result


REMAT_MICRO, REMAT_WARMUP, REMAT_STEPS = 24, 1, 3    # bench.py's 3rd rung
# "dots" keeps every layer's linear-layer outputs, which "full" recomputes:
# 9 * d_model values a token a layer in bf16, 10.1 GiB at this rung, some
# of which "full" holds at its peak too (7.8 GiB more measured on an
# H100); a policy that matched no product would keep nothing more
REMAT_DOTS_EXTRA_GB = 4.0     # GiB, as peak_memory_gb
# kernel-name substrings of the profile: cuBLAS's GEMMs (either family),
# the flash kernels, PyTorch's elementwise kernels
REMAT_GROUPS = ("gemm", "nvjet", "flash_", "elementwise")


def phase_train_remat(launch_counters, layers=None, micro=REMAT_MICRO,
                      seq=TRAIN_SEQ, steps=REMAT_STEPS):
    """bench.py's third rung, ``(24, True, True)``: gpt2_medium, micro 24,
    remat on, bf16 state, once under ``remat_policy`` "full" and once
    under "dots" (the linear layers' outputs kept), from one init. After
    one step the losses and the fp32 masters of the two are equal bit for
    bit; then ``REMAT_WARMUP`` + ``steps`` timed steps each (counts set to
    0 just before the timed steps and read just after), with the peak
    memory of the timed steps, which under "dots" must exceed "full"'s by
    ``REMAT_DOTS_EXTRA_GB`` (the kept products); under "dots" then a
    profile of 2 steps (device time by kernel group, the host's wait on a
    full launch queue)."""
    import gc
    import torch
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=seq,
                          **({"n_layers": layers} if layers else {}))
    state = {k: v.clone() for k, v in
             seeded_gpt2(cfg, 0).state_dict().items()}
    rng = np.random.RandomState(3)
    ids = rng.randint(0, cfg.vocab_size, size=(1, micro, seq)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    runs, first = {}, {}
    for policy in ("full", "dots"):
        # an engine is a reference cycle: an earlier phase's (or policy's)
        # would otherwise stay on the card and into this peak
        gc.collect()
        torch.cuda.empty_cache()
        engine, cfg = _bench_engine(0, layers, micro, seq, remat=True,
                                    policy=policy, state=state)
        loss = float(engine.train_batch(batch=batch))
        first[policy] = (loss, engine.flat.master.detach().clone())
        for _ in range(REMAT_WARMUP):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counter in launch_counters:
            counter.launches = 0
        t0 = time.perf_counter()
        losses = [engine.train_batch(batch=batch) for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[policy] = {
            "step_ms": wall * 1e3 / steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": [loss] + [float(x) for x in losses],
            "launches": {c.__name__: c.launches for c in launch_counters}}
        if policy == "dots":
            runs[policy]["train_profile"] = train_profile(
                engine, batch, kernel_groups=REMAT_GROUPS)
        del engine
        torch.cuda.empty_cache()
    equal = first["full"][0] == first["dots"][0] and \
        bool(torch.equal(first["full"][1], first["dots"][1]))
    result = {"phase": "train_remat", "model": "gpt2_medium",
              "layers": cfg.n_layers, "seq": seq, "micro_batch": micro,
              "dtype": "bf16", "zero_stage": 2, "moments": "bf16",
              "remat": True, "steps": steps, "policies": runs,
              "first_step_bit_equal": equal,
              "first_step_master_max_abs_diff": _max_abs(
                  first["full"][1], first["dots"][1]),
              "dots_vs_full_step": runs["dots"]["step_ms"] /
              runs["full"]["step_ms"],
              "dots_extra_peak_gb": runs["dots"]["peak_memory_gb"] -
              runs["full"]["peak_memory_gb"],
              "dots_extra_peak_gb_min": REMAT_DOTS_EXTRA_GB}
    assert equal, result
    assert result["dots_extra_peak_gb"] >= REMAT_DOTS_EXTRA_GB, result
    for policy, run in runs.items():
        assert all(np.isfinite(run["losses"])), result
        for name in FLASH_GROUPS:
            assert run["launches"][name] == cfg.n_layers * steps, result
        assert run["launches"]["fused_adam"] == steps, result
    return result


# ------------------------------------------------ ZeRO-3 and ZeRO-Offload

# BASELINE config 4 as tests/perf/bench_gpt2_xl.py:45-55 runs it
XL_SEQ, XL_MICRO, XL_WARMUP, XL_STEPS = 1024, 8, 2, 3
XL_CONFIG = {"train_micro_batch_size_per_gpu": XL_MICRO,
             "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
             "zero_optimization": {"stage": 3, "cpu_offload": True},
             "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
             "steps_per_print": 10 ** 9}
XL_HOST_GB = 18.69        # predicted: 12 bytes a parameter of 1,557,686,400
CPU_ADAM_N = 64 * 2 ** 20
CPU_ADAM_BYTES = 30       # an element: p, g, m, v read; p, m, v, bf16 written
HOST_ULPS = 4             # at the scale of each output's operation
OFFLOAD_PARITY_LAYERS, OFFLOAD_PARITY_STEPS = 2, 5
# the offload engine's masters against the device engine's, each leaf's
# difference by how far it moved: the sound reading was 0.0035 on the
# H100; a step 5% too long should read about 0.05 (the phase's control)
OFFLOAD_MOVED_RTOL = 0.02
# the same reading on a leaf at gpt2_xl's full depth (dp_nccl_zero3): the
# offload run against stage 3 read 0.0257 after 4 steps on four H100s
DEEP_LEAF_MOVED_RTOL = 0.05
DP3_LAYERS, DP3_STEPS = 2, 3
OFFLOAD_CKPT_LAYERS = 2
ZERO3_SPANS = ("zero3.all_gather", "zero3.reduce_scatter",
               "zero.offload_step")


def device_gpt2(cfg, seed, device="cuda"):
    """A GPT-2 made on the card in bf16: N(0, 0.02) kernels and ``wte``
    (the two projection kernels N(0, 0.02 / sqrt(2 L)), ``wpe`` N(0,
    0.01)), unit scales, zero biases, drawn from a seeded generator on the
    device (drawing gpt2_xl's 1.56e9 normals with numpy on the host would
    take about half a minute)."""
    import math
    import torch
    from deepspeed_tpu_torch.models import gpt2
    model = gpt2.GPT2Model(cfg, device=device, dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    proj = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                std = proj if "proj_kernel" in name else \
                    0.01 if name == "wpe" else 0.02
                p.normal_(0.0, std, generator=gen)
    return model


def _scaled_err(got, want, *scales):
    """max |got - want| in fp32 spacings of the largest of ``scales`` and
    |got| (the scale the operation that made them rounds at)."""
    import torch
    scale = torch.stack([s.abs().float() for s in (got,) + scales]).amax(0)
    spacing = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    return float(((got.double() - want.double()).abs() /
                  spacing.double()).max())


def phase_cpu_adam(n=CPU_ADAM_N):
    """The host Adam (``csrc/cpu_adam.cpp``, ``ops/adam/cpu_adam.py``)
    against its plain version on 64M elements at step 3 (AdamW, weight
    decay 0.01, the fused bf16 copy): the worst error in fp32 spacings of
    each output's scale, the bf16 copies bit for bit, the op's and the
    plain version's ms, the op's GB/s over 30 bytes an element, its
    threads and whether the compiler's OpenMP probe passed."""
    import torch
    from deepspeed_tpu_torch.ops import host_build
    from deepspeed_tpu_torch.ops.adam import cpu_adam as ca
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(n, generator=gen)
    g = torch.randn(n, generator=gen)
    m = torch.randn(n, generator=gen) * 0.1
    v = torch.rand(n, generator=gen) * 0.01
    h = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
             bc1=1 - 0.9 ** 3, bc2=1 - 0.999 ** 3, adam_w_mode=True)
    op = [t.clone() for t in (p, g, m, v)]
    plain = [t.clone() for t in (p, g, m, v)]
    half = torch.empty(n, dtype=torch.bfloat16)
    plain_half = torch.empty(n, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    ca.cpu_adam(*op, p_bf16=half, **h)
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ca.cpu_adam_reference(*plain, p_bf16=plain_half, **h)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {"p": _scaled_err(op[0], plain[0], p),
            "m": _scaled_err(op[2], plain[2], m, g),
            "v": _scaled_err(op[3], plain[3], v, g * g * 1e-3)}
    bf16_equal = bool(torch.equal(half.view(torch.int16),
                                  plain_half.view(torch.int16)))
    assert max(errs.values()) <= HOST_ULPS, errs
    assert bf16_equal
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ca.cpu_adam(*op, p_bf16=half, **h)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    cxx = host_build.compiler()
    return {"phase": "cpu_adam", "elements": n, "errors_in_spacings": errs,
            "tolerance_spacings": HOST_ULPS, "bf16_copy_bit_equal":
            bf16_equal, "op_ms": ms, "first_call_ms": first_ms,
            "plain_ms": plain_ms, "op_gb_per_s": CPU_ADAM_BYTES * n / ms /
            1e6, "bytes_per_element": CPU_ADAM_BYTES,
            "pool_threads": ca.threads_for(n),
            "openmp_threads": ca.openmp_threads(),
            "usable_cores": ca.usable_cores(),
            "openmp_probe_passed": host_build.OPENMP_FLAG in
            host_build.flags(cxx), "flags": list(host_build.flags(cxx))}


def _xl_cfg(layers=None):
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.config_for("gpt2_xl", max_seq_len=XL_SEQ, remat=True,
                           loss_chunk=128,
                           **({"n_layers": layers} if layers else {}))


def xl_flops_per_token(cfg):
    """6 N + 12 L d s: the model's flops a token, recompute not counted."""
    from deepspeed_tpu_torch.models import gpt2
    return 6 * gpt2.num_params(cfg) + \
        12 * cfg.n_layers * cfg.d_model * cfg.max_seq_len


def phase_train_xl_offload(launch_counters=None, layers=None,
                           steps=XL_STEPS):
    """BASELINE config 4: ``initialize(...).train_batch(...)`` on gpt2_xl
    at full width and depth (48 layers, d 1600, 25 heads, vocabulary
    50304), seq 1024, micro 8, bf16, ZeRO stage 3 with ``cpu_offload``,
    Adam lr 1e-4, remat on, loss chunk 128 (bench_gpt2_xl.py's config),
    the weights made on the card from a seed. ``XL_WARMUP`` steps, then
    counts set to 0 and ``steps`` timed steps (step ms, tokens/s, MFU over
    6N + 12 L d s flops a token against 989 TFLOP/s); then one step
    through ``forward`` / ``backward`` / ``step`` with the offload step
    serial, for the split: the device's forward and backward, the
    gradients' D2H, the host Adam, the weights' H2D. The device peak, the
    host bytes of the master and moments, launches by kernel (each flash
    kernel once a layer: at one rank stage 3 keeps every leaf whole, as
    the JAX plan does, so nothing is gathered, and remat recomputes the
    rest of each block but not its fused attention; the device Adam
    never), and a falling loss."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.adam.cpu_adam import cpu_adam
    if launch_counters is None:
        launch_counters = _dp_counters()[:4]
    cfg = _xl_cfg(layers)
    t0 = time.perf_counter()
    model = device_gpt2(cfg, seed=0)
    made_s = time.perf_counter() - t0
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config_params=XL_CONFIG)[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert engine.device.type == "cuda" and engine.zero3 is None
    assert engine.offload is not None
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, XL_MICRO, XL_SEQ)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    losses = []
    for _ in range(XL_WARMUP):
        losses.append(float(engine.train_batch(batch=batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in launch_counters:
        c.launches = 0
    adam_calls = cpu_adam.calls
    t0 = time.perf_counter()
    timed = [engine.train_batch(batch=batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    host_adam_calls = cpu_adam.calls - adam_calls
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    overlapped = dict(engine.offload.last_times)
    losses += [float(x) for x in timed]
    # the split, one step with the offload step serial
    engine.offload.overlap = False
    x = torch.as_tensor(ids[0], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = engine(x, x)
    engine.backward(loss)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    serial = dict(engine.offload.last_times)
    losses.append(float(loss.detach()))
    engine.offload.overlap = True
    step_ms = wall * 1e3 / steps
    tokens = XL_MICRO * XL_SEQ
    flops = xl_flops_per_token(cfg) * tokens
    host = engine.offload.host_bytes()
    n = gpt2.num_params(cfg)
    per_step = {"flash_fwd": cfg.n_layers,
                "flash_bwd_dkdv": cfg.n_layers, "flash_bwd_dq":
                cfg.n_layers, "fused_adam": 0}
    for name, k in per_step.items():
        if name in launches:
            assert launches[name] == k * steps, (name, launches)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    if layers is None:
        assert abs(host["master_and_moments"] / 1e9 - XL_HOST_GB) < 0.05, \
            host
    return {"phase": "train_xl_offload", "model": "gpt2_xl",
            "params": n, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": cfg.n_heads, "vocab": cfg.vocab_size, "seq": XL_SEQ,
            "micro_batch": XL_MICRO, "config": XL_CONFIG, "remat": True,
            "steps": steps, "step_ms": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
            "split_ms": {"device_fwd_bwd": (t1 - t0) * 1e3,
                         "step_total": (t2 - t1) * 1e3,
                         "d2h": serial["d2h_wait_ms"],
                         "host_adam": serial["adam_ms"],
                         "h2d": serial["h2d_ms"]},
            "offload_overlapped_ms": overlapped,
            "host_adam_gb_per_s": CPU_ADAM_BYTES * engine.flat.part_numel /
            serial["adam_ms"] / 1e6,
            "d2h_gb": 4 * engine.flat.part_numel / 1e9,
            "h2d_gb": 2 * engine.flat.part_numel / 1e9,
            "work_chunks": engine.offload_work_chunks,
            "h2d_batches": engine.h2d_batches,
            "host_adam_threads": engine.offload.threads(
                max(b - a for a, b in engine.offload.chunks)),
            "host_bytes": host, "peak_memory_gb": peak_gb,
            "param_bytes": engine.flat.param_bytes(),
            "persistent_leaves": len(engine.flat.persistent),
            "model_made_s": made_s, "init_s": init_s,
            "launches": launches, "launches_per_step": per_step,
            "host_adam_calls": host_adam_calls, "losses": losses}


# -------------------------------------------- streamed parameter offload

# BASELINE config 4 as train_xl_offload runs it, plus cpu_offload_params
# and a live-parameter budget that the runner's plan cuts into 16 groups
# of 3 blocks: a block is 30,740,800 elements, the embed segment
# 82,124,800, so (3e8 - 82,124,800) / 2 = 108,937,600 a group
XL_STREAM_LIVE = 300000000
XL_STREAM_WARMUP, XL_STREAM_STEPS = 1, 2
XL_STREAM_CONFIG = dict(XL_CONFIG, zero_optimization=dict(
    XL_CONFIG["zero_optimization"], cpu_offload_params=True,
    stage3_max_live_parameters=XL_STREAM_LIVE))
STREAM_PARITY_LAYERS, STREAM_PARITY_STEPS = 2, 3
STREAM_RTOL = 2e-4          # the JAX test's bound against classic offload


def stream_plan(cfg, budget):
    """The group plan the runner must make for ``cfg`` at ``budget``
    (``runtime/zero/stream.py::plan_groups``, the JAX runner's)."""
    from deepspeed_tpu_torch.runtime.zero.stream import plan_groups
    d, v, s = cfg.d_model, cfg.vocab_size, cfg.max_seq_len
    block = 12 * d * d + 13 * d
    return plan_groups([block] * cfg.n_layers,
                       max(v * d + s * d, v * d + 2 * d), budget)


def phase_train_xl_stream(launch_counters=None, offload=None, layers=None,
                          steps=XL_STREAM_STEPS, tol=STREAM_RTOL):
    """BASELINE config 4 with streamed parameter offload: train_xl_offload's
    configuration (gpt2_xl at full width and depth, seq 1024, micro 8,
    bf16, Adam lr 1e-4, loss chunk 128, stage 3 + ``cpu_offload``) plus
    ``cpu_offload_params`` and ``stage3_max_live_parameters`` 3e8, from
    the same seeded weights (made on the card again, then moved to host
    memory by the engine: no parameter stays on the card). The plan the
    runner made is asserted (16 groups of 3 blocks); ``XL_STREAM_WARMUP``
    steps, then the counts set to 0 and ``steps`` timed steps: the step
    ms, the split of the last step (uploads, device compute, D2H, the host
    adds, norm and Adam; device times by CUDA events on their streams,
    which overlap), the device peak beside train_xl_offload's (its
    result, ``offload``: the peak must stay under it, and each loss
    within ``tol`` relative of its loss at the same step: from one batch
    at lr 1e-4 the loss rises at the third step in both engines), the
    host bytes, the upload batches and bytes a step, and launches a step:
    the flash forward twice a layer (the forward, then the group's
    recompute in the backward), dk/dv and dq once, the device Adam
    never."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.adam.cpu_adam import cpu_adam
    if launch_counters is None:
        launch_counters = _dp_counters()[:4]
    cfg = _xl_cfg(layers)
    t0 = time.perf_counter()
    model = device_gpt2(cfg, seed=0)
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config_params=XL_STREAM_CONFIG)[0]
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    runner = engine.stream_runner
    assert engine.device.type == "cuda" and runner is not None
    assert engine.offload is None and engine.zero3 is None
    plan = stream_plan(cfg, XL_STREAM_LIVE)
    assert runner.groups == plan, (runner.groups, plan)
    if layers is None:
        assert plan == [(3 * i, 3 * i + 3) for i in range(16)], plan
    resident = torch.cuda.memory_allocated() / 2 ** 30
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, XL_MICRO, XL_SEQ)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(XL_STREAM_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in launch_counters:
        c.launches = 0
    runner.reset_step_counters()
    adam_calls = cpu_adam.calls
    t0 = time.perf_counter()
    timed = [engine.train_batch(batch=batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in launch_counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    snap = runner.transfer_snapshot()
    phases = {k: v * 1e3 for k, v in engine.offload_phase_times.items()}
    losses += [float(x) for x in timed]
    step_ms = wall * 1e3 / steps
    per_step = {"flash_fwd": 2 * cfg.n_layers,
                "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "fused_adam": 0}
    for name, k in per_step.items():
        if name in launches:
            assert launches[name] == k * steps, (name, launches)
    assert all(np.isfinite(losses)), losses
    offload_peak_gb = offload_losses = None
    if offload is not None:
        offload_peak_gb = offload["peak_memory_gb"]
        offload_losses = offload["losses"][:len(losses)]
        assert peak_gb < offload_peak_gb, (peak_gb, offload_peak_gb)
        assert _rel(losses, offload_losses) <= tol, (losses, offload_losses)
    flat = engine.flat
    host = {name: t.numel() * t.element_size() for name, t in (
        ("master", flat.master), ("exp_avg", flat.exp_avg),
        ("exp_avg_sq", flat.exp_avg_sq), ("acc", flat.acc),
        ("params_pinned", flat.params))}
    host["staging_pinned"] = sum(t.numel() * t.element_size()
                                 for t in runner._staging)
    tokens = XL_MICRO * XL_SEQ
    flops = xl_flops_per_token(cfg) * tokens
    return {"phase": "train_xl_stream", "model": "gpt2_xl",
            "params": gpt2.num_params(cfg), "layers": cfg.n_layers,
            "d_model": cfg.d_model, "seq": XL_SEQ, "micro_batch": XL_MICRO,
            "config": XL_STREAM_CONFIG, "groups": runner.groups,
            "group_numel": [seg.numel for seg in runner.segments],
            "terminal_numel": max(runner.embed.numel, runner.head.numel),
            "steps": steps, "step_ms": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
            "split_ms_last_step": phases,
            "split_note": "h2d_s, compute_*, d2h_grads_s: device time by "
                          "CUDA events on each stream (they overlap); "
                          "h2d_wait_s, d2h_wait_s, host_*: host clock",
            "peak_memory_gb": peak_gb,
            "train_xl_offload_peak_memory_gb": offload_peak_gb,
            "train_xl_offload_losses": offload_losses,
            "loss_max_rel_diff_vs_offload": _rel(losses, offload_losses)
            if offload_losses else None, "loss_tolerance": tol,
            "resident_after_init_gb": resident, "host_bytes": host,
            "upload_batches_per_step": snap["upload_batches"] / steps,
            "upload_bytes_per_step": snap["upload_bytes"] / steps,
            "transfer_snapshot": snap, "init_s": init_s,
            "host_adam_calls": cpu_adam.calls - adam_calls,
            "launches": launches, "launches_per_step": per_step,
            "losses": losses}


def phase_train_stream_parity(layers=STREAM_PARITY_LAYERS,
                              steps=STREAM_PARITY_STEPS, tol=STREAM_RTOL):
    """gpt2_xl width at ``layers`` layers, train_xl_stream's batch and
    config with a budget of two blocks and the embed segment (one block a
    group, so more than one group): (1) the streamed loss of the first
    micro-step equals, bit for bit, a plain segment-by-segment recompute
    on the card from the host masters cast to bf16, group for group (the
    JAX test ``test_streamed_step_matches_segment_reference_bitwise``);
    (2) over ``steps`` steps the streamed losses track the classic stage
    3 + offload engine's within ``tol`` relative, and so does eval (the
    JAX bounds)."""
    import torch
    import deepspeed_tpu_torch
    cfg = _xl_cfg(layers)
    d, v, s = cfg.d_model, cfg.vocab_size, cfg.max_seq_len
    budget = v * d + s * d + 2 * (12 * d * d + 13 * d)
    conf = dict(XL_STREAM_CONFIG, zero_optimization=dict(
        XL_STREAM_CONFIG["zero_optimization"],
        stage3_max_live_parameters=budget))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, XL_MICRO, XL_SEQ)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    streamed = deepspeed_tpu_torch.initialize(model=device_gpt2(cfg, seed=0),
                                              config_params=conf)[0]
    runner = streamed.stream_runner
    assert len(runner.groups) > 1, runner.groups
    # the reference: every leaf a view of one bf16 copy of the host
    # parameters on the card (the masters rounded), at the layout's
    # offsets, the segments run group for group
    flat = streamed.flat
    assert torch.equal(flat.params, flat.master.to(torch.bfloat16))
    dev = flat.params.to(streamed.device)
    tree = {n: dev[o:o + int(np.prod(sh))].view(sh) for n, o, sh in
            zip(flat.names, flat.offsets, flat.shapes)}
    spec = streamed.module.stream_spec
    x_ids = torch.as_tensor(ids[0], device=streamed.device)
    with torch.no_grad():
        e, blocks, h = spec.split(tree)
        x = spec.embed_apply(e, (x_ids, x_ids), None, True)
        for start, stop in runner.groups:
            for bt in blocks[start:stop]:
                x = spec.block_apply(bt, x, None, True)
    with torch.enable_grad():
        ref = float(spec.head_apply(h, x, (x_ids, x_ids), None, True))
    del dev, tree, x
    losses = {"streamed": [], "classic": []}
    losses["streamed"] = [float(streamed.train_batch(batch=batch))
                          for _ in range(steps)]
    bit_equal = losses["streamed"][0] == ref
    streamed.eval()
    evals = {"streamed": float(streamed(x_ids, x_ids))}
    del streamed, runner, flat
    torch.cuda.empty_cache()
    classic = deepspeed_tpu_torch.initialize(model=device_gpt2(cfg, seed=0),
                                             config_params=XL_CONFIG)[0]
    losses["classic"] = [float(classic.train_batch(batch=batch))
                         for _ in range(steps)]
    classic.eval()
    evals["classic"] = float(classic(x_ids, x_ids))
    del classic
    torch.cuda.empty_cache()
    rel = _rel(losses["streamed"], losses["classic"])
    eval_rel = abs(evals["streamed"] - evals["classic"]) / \
        abs(evals["classic"])
    result = {"phase": "train_stream_parity", "model": "gpt2_xl",
              "layers": layers, "steps": steps, "budget": budget,
              "groups": len(stream_plan(cfg, budget)),
              "segment_reference_loss": ref,
              "bit_equal_to_segment_reference": bit_equal,
              "losses": losses, "loss_max_rel_diff": rel, "evals": evals,
              "eval_rel_diff": eval_rel, "tolerance": tol}
    assert bit_equal, result
    assert rel <= tol and eval_rel <= tol, result
    return result


def _offload_parity_engine(cfg, zero, steps, batch, sub_group=None,
                           overlap=True, keep_at=None, keep_init=False,
                           **adam):
    """``steps`` steps of ``batch`` on a fresh engine at ``zero``: losses,
    the final masters, the work chunks; with ``keep_at`` also the masters
    after that many steps, with ``keep_init`` the initial ones; ``adam``
    overrides the optimizer's params (a control)."""
    import torch
    import deepspeed_tpu_torch
    conf = dict(XL_CONFIG, zero_optimization=dict(zero))
    if adam:
        conf["optimizer"] = {"type": "Adam", "params": dict(
            XL_CONFIG["optimizer"]["params"], **adam)}
    if sub_group:
        conf["zero_optimization"]["sub_group_size"] = sub_group
    engine = deepspeed_tpu_torch.initialize(model=device_gpt2(cfg, seed=0),
                                            config_params=conf)[0]
    if engine.offload is not None:
        engine.offload.overlap = overlap
    out = {"losses": []}
    if keep_init:
        out["init"] = _leaf_items(engine.get_master_params())
    for step in range(steps):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        if step + 1 == keep_at:
            out["master_at"] = _leaf_items(engine.get_master_params())
    out["master"] = _leaf_items(engine.get_master_params())
    out["chunks"] = engine.offload_work_chunks
    del engine
    torch.cuda.empty_cache()
    return out


def phase_train_offload_parity(layers=OFFLOAD_PARITY_LAYERS,
                               steps=OFFLOAD_PARITY_STEPS, bit_steps=2,
                               loss_tol=1e-4, moved_rtol=OFFLOAD_MOVED_RTOL,
                               key_bias_atol=1e-3, control_lr=1.05):
    """gpt2_xl width at ``layers`` layers, ``steps`` steps of
    train_xl_offload's batch and config: ZeRO-Offload (stage 3, the host
    Adam) against a stage-2 engine with the state on the card (the CUDA
    Adam kernel, fp32 moments). Losses within ``loss_tol`` relative;
    masters by how far they moved, the difference's norm within
    ``moved_rtol`` of the device engine's move by leaf (the qkv biases'
    key part, whose exact gradient is 0, elementwise within
    ``key_bias_atol``, about steps x lr). The two Adams order their
    arithmetic differently (the kernel's FMAs against the host op's
    separate roundings), so the two paths agree to a tolerance, not bit
    for bit. Two controls hold the tolerance to a wrong host step: the
    offload engine with its step ``control_lr`` times too long must fall
    outside ``moved_rtol``; the reading with eps 10 times too large is
    reported. Then the offload step serial, and overlapped at a second
    ``sub_group_size`` (4M against 16M elements), ``bit_steps`` steps
    each: equal bits to the first run's losses and masters there."""
    cfg = _xl_cfg(layers)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, XL_MICRO, XL_SEQ)) \
        .astype(np.int64)
    batch = (ids, ids.copy())
    offload = XL_CONFIG["zero_optimization"]
    lr = XL_CONFIG["optimizer"]["params"]["lr"]
    device = _offload_parity_engine(cfg, {"stage": 2}, steps, batch,
                                    keep_init=True)
    ref = _offload_parity_engine(cfg, offload, steps, batch, 1 << 24,
                                 keep_at=bit_steps)
    runs = {"serial_sub16M": _offload_parity_engine(
                cfg, offload, bit_steps, batch, 1 << 24, overlap=False),
            "overlap_sub4M": _offload_parity_engine(
                cfg, offload, bit_steps, batch, 1 << 22)}
    controls = {"lr_x{}".format(control_lr): _offload_parity_engine(
                    cfg, offload, steps, batch, 1 << 24,
                    lr=lr * control_lr),
                "eps_x10": _offload_parity_engine(
                    cfg, offload, steps, batch, 1 << 24, eps=1e-7)}

    def reading(run):
        return dict(_master_diff(run["master"], device["master"],
                                 cfg.d_model, device["init"]),
                    loss_rel=max(abs(a - b) / abs(b) for a, b in
                                 zip(run["losses"], device["losses"])))

    sound = reading(ref)
    control = {name: reading(run) for name, run in controls.items()}
    assert sound["loss_rel"] <= loss_tol, (ref["losses"], device["losses"])
    assert sound["moved_rel"] <= moved_rtol, sound
    assert sound["key_bias_max_abs"] <= key_bias_atol, sound
    # the tolerance lies between the sound reading and a wrong step's
    assert control["lr_x{}".format(control_lr)]["moved_rel"] > moved_rtol, \
        control
    bit_equal = {}
    for name, run in runs.items():
        bit_equal[name] = run["losses"] == ref["losses"][:bit_steps] and \
            all(np.array_equal(run["master"][k], w)
                for k, w in ref["master_at"].items())
        assert bit_equal[name], name
    assert runs["overlap_sub4M"]["chunks"] > ref["chunks"]
    return {"phase": "train_offload_parity", "model": "gpt2_xl",
            "layers": layers, "steps": steps, "bit_steps": bit_steps,
            "offload_losses": ref["losses"],
            "device_losses": device["losses"],
            "loss_rel": sound["loss_rel"], "loss_tol": loss_tol,
            "master_diff": sound, "controls": control,
            "tolerances": {"moved_rel": moved_rtol,
                           "key_bias_max_abs": key_bias_atol},
            "work_chunks": dict({k: r["chunks"] for k, r in runs.items()},
                                overlap_sub16M=ref["chunks"]),
            "bit_equal_to_overlap_sub16M": bit_equal}


def dp3_rank(rank, world, spec):
    """One rank of ``train_dp3``: for each of stage 2, stage 3, stage 2
    with cpu_offload and stage 3 with cpu_offload, the GPT-2 example's
    config (without clipping) on gpt2_medium at ``spec["layers"]`` layers,
    this data coordinate's rows of one global batch, ``spec["steps"]``
    steps from one init; stage 3 compared with stage 2 here (losses and
    the gathered masters, bit for bit), each run's parameter and state
    bytes and launches."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf["steps_per_print"] = 10 ** 9
    # no clipping: the norm's summation order follows the layout, and a
    # clip coefficient an ulp apart would part the stages' bits
    conf.pop("gradient_clipping", None)
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT,
                          n_layers=spec["layers"])
    mesh = build_mesh(data=world)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(
        1, DP_MICRO * world, TRAIN_SEQ)).astype(np.int64)
    counters = _dp_counters()[:4]
    runs, masters = {}, {}
    for name, zero in (("s2", {"stage": 2}), ("s3", {"stage": 3}),
                       ("s2_offload", {"stage": 2, "cpu_offload": True}),
                       ("s3_offload", {"stage": 3, "cpu_offload": True})):
        engine = deepspeed_tpu_torch.initialize(
            model=device_gpt2(cfg, seed=0), mesh=mesh,
            config_params=dict(conf, zero_optimization=zero))[0]
        batch = dp_rows((ids, ids.copy()), engine.dp_rank, DP_MICRO)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(engine.train_batch(batch=batch))
                  for _ in range(spec["steps"])]
        wall = time.perf_counter() - t0
        masters[name] = _leaf_items(engine.get_master_params())
        flat = engine.flat
        runs[name] = {"losses": losses, "step_ms": wall * 1e3 /
                      spec["steps"], "param_bytes": flat.param_bytes(),
                      "state_bytes": flat.state_bytes(),
                      "master_on": str(flat.master.device),
                      "launches": {c.__name__: c.launches
                                   for c in counters},
                      "gathers": engine.zero3.gathers if engine.zero3
                      else 0}
        del engine, flat
        torch.cuda.empty_cache()
    equal = {}
    for a, b in (("s3", "s2"), ("s3_offload", "s2_offload")):
        equal[a] = runs[a]["losses"] == runs[b]["losses"] and all(
            np.array_equal(masters[a][k], w) for k, w in masters[b].items())
    return {"rank": rank, "runs": runs, "bit_equal_to_stage2": equal,
            "transport": torch.distributed.get_backend(),
            "whole_param_bytes": 2 * sum(int(np.prod(w.shape))
                                         for w in masters["s2"].values())}


def dp3_spec(layers=DP3_LAYERS, steps=DP3_STEPS):
    return {"layers": layers, "steps": steps}


def phase_train_dp3(world=DP, spec=None, ranks=None):
    """ZeRO-3 over a data group: two spawned ranks sharing this card over
    gloo (train_dp's config, gpt2_medium at ``layers`` layers): stage 3
    equals stage 2 bit for bit in losses and masters, with and without
    cpu_offload; a rank's compute-dtype parameter bytes at stage 3 about
    1/2 of the whole (its pieces of each unit, plus the persistent leaves
    whole); the launches of each run. ``ranks``: the ranks' returns when
    train_dp_parity's ranks ran them (:func:`dp3_spec`)."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    spec = spec or dp3_spec()
    layers, steps = spec["layers"], spec["steps"]
    if ranks is None:
        ranks = spawn(dp3_rank, world, args=(spec,), timeout_s=600)
    for r in ranks:
        assert all(r["bit_equal_to_stage2"].values()), r
        s3 = r["runs"]["s3"]
        share = s3["param_bytes"] / r["whole_param_bytes"]
        assert share < 0.55, share
        r["param_share_stage3"] = share
        for run in r["runs"].values():
            assert run["losses"][-1] < run["losses"][0], run
        assert r["runs"]["s3_offload"]["master_on"] == "cpu"
        assert r["runs"]["s3"]["launches"]["fused_adam"] == steps
        assert r["runs"]["s3_offload"]["launches"]["fused_adam"] == 0
    assert ranks[0]["runs"]["s3"]["losses"] == \
        ranks[1]["runs"]["s3"]["losses"]
    return {"phase": "train_dp3", "model": "gpt2_medium", "layers": layers,
            "seq": TRAIN_SEQ, "micro_batch_per_rank": DP_MICRO,
            "data": world, "config": EXAMPLE_CONFIG + " without clipping",
            "transport": ranks[0]["transport"], "steps": steps,
            "ranks": ranks}


ZEROPP_LAYERS, ZEROPP_STEPS = 2, 2
# the quantized legs against plain stage 3, at the CPU tests' tolerances
# (tests/test_torch_zeropp.py against the JAX engine): losses relative,
# each leaf's move by norm (the qkv biases' key part apart), that key
# part elementwise; inside the JAX package's own loss bound of 0.05
ZEROPP_LOSS_RTOL, ZEROPP_MOVED_RTOL, ZEROPP_KEY_BIAS_ATOL = 5e-4, 0.25, 1e-2
# qwZ's gather bytes over plain's: int8 lanes and an fp32 scale a block
# of 200-256 lanes against bf16 lanes (0.504 at d 1024, 0.505 at 1600)
QWZ_GATHER_SHARE = (0.45, 0.56)
QWZ = {"zero_quantized_weights": True}
ZEROPP_ALL = {"zero_quantized_weights": True,
              "zero_hierarchical_partition": 2,
              "zero_quantized_gradients": True}
# (name, zero_optimization keys over stage 3, collective_matmul section)
ZEROPP_LEGS = (("s3", {}, None), ("qwz", QWZ, None),
               ("qgz", {"zero_quantized_gradients": True}, None),
               ("ring", {}, {"zero_gather": True}),
               ("ring_qwz", QWZ, {"zero_gather": True}),
               ("all", ZEROPP_ALL, None))
ZEROPP_DP4_LEGS = (("s3", {}, None),
                   ("hpz", {"zero_hierarchical_partition": 2}, None))
# the legs the CPU tests find bit-equal to another (the ring gather moves
# the same bits; hpZ partitions the same pieces), and the quantized ones
ZEROPP_BIT_EQUAL = {"ring": "s3", "ring_qwz": "qwz", "hpz": "s3",
                    "stage3_ring": "stage3"}
ZEROPP_QUANTIZED = ("qwz", "qgz", "ring_qwz", "all", "stage3_qwz",
                    "stage3_qgz", "stage3_ring_qwz", "stage3_all")


def _zeropp_modes(zero, cm):
    """The modes a leg's keys turn on, as the engine's accessors report
    them: [qwZ, hpZ degree (0: off), qgZ, the ring gather]."""
    return [bool(zero.get("zero_quantized_weights")),
            int(zero.get("zero_hierarchical_partition", 0)),
            bool(zero.get("zero_quantized_gradients")),
            bool(cm and cm.get("zero_gather"))]


def _zeropp_leg_checks(where, name, run, vs, base, failed):
    """One ZeRO++ leg held to the legs before it; failures appended to
    ``failed`` under ``where``. ``run``: its ``modes``, ``want_modes``
    (:func:`_zeropp_modes` of its keys), ``prefetched_gathers`` and
    ``wire_bytes_per_step``; ``vs``: its readings against plain stage 3
    (``base``, the run of that leg) and, for a leg ZEROPP_BIT_EQUAL
    names, against that leg (``vs_equal``, with its gather bytes). A ring
    leg moves the same gather bytes as the leg it equals, and served
    gathers from posted rings; a quantized leg differs from plain stage 3 and follows it to
    the CPU tests' tolerances; qwZ without hpZ hands over about half of
    plain's gather bytes."""
    if run["modes"] != run["want_modes"]:
        failed.append((where, name, "modes", run["modes"],
                       run["want_modes"]))
    qwz, hpz, _, ring = run["want_modes"]
    if ring and not run["prefetched_gathers"] > 0:
        failed.append((where, name, "no ring posted"))
    gathered = run["wire_bytes_per_step"].get("allgather", 0.0)
    plain = base["wire_bytes_per_step"].get("allgather", 0.0)
    if name in ZEROPP_BIT_EQUAL:
        got = vs["vs_equal"]
        if not got["bit_equal"]:
            failed.append((where, name, "not bit-equal to",
                           ZEROPP_BIT_EQUAL[name]))
        if ring and gathered != got["allgather"]:
            failed.append((where, name, "gather bytes", gathered,
                           got["allgather"]))
    if name in ZEROPP_QUANTIZED:
        got = vs["vs_base"]
        if got["bit_equal"] or not got["max_abs"] > 0:
            failed.append((where, name, "equal to plain stage 3"))
        for key, tol in (("loss_rel", ZEROPP_LOSS_RTOL),
                         ("moved_rel", ZEROPP_MOVED_RTOL),
                         ("key_bias_max_abs", ZEROPP_KEY_BIAS_ATOL)):
            if not got[key] <= tol:
                failed.append((where, name, key, got[key], tol))
    if qwz and hpz <= 1:
        share = gathered / plain
        if not QWZ_GATHER_SHARE[0] <= share <= QWZ_GATHER_SHARE[1]:
            failed.append((where, name, "qwZ gather bytes over plain",
                           share, QWZ_GATHER_SHARE))


def zeropp_rank(rank, world, spec):
    """One rank of ``train_zeropp``: for each leg of ``spec["legs"]``, ZeRO
    stage 3 with the leg's ZeRO++ keys on train_dp3's config (the GPT-2
    example's, without clipping) at gpt2_medium width and
    ``spec["layers"]`` layers over ``build_mesh(data=world)``, this data
    coordinate's rows of one global batch, one warm-up and
    ``spec["steps"]`` timed steps from one init (counts, the wire tally
    and the peak reset just before them): losses, step ms, unit gathers
    and the bytes handed to ``torch.distributed`` (``quantize.WIRE``, by
    kind) a step, peak GB, parameter bytes, launches; each leg against
    the first (plain stage 3): the masters' difference and whether they
    and the losses agree bit for bit."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.comm.quantize import WIRE
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf["steps_per_print"] = 10 ** 9
    conf.pop("gradient_clipping", None)
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT,
                          n_layers=spec["layers"])
    mesh = build_mesh(data=world)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(
        1, DP_MICRO * world, TRAIN_SEQ)).astype(np.int64)
    counters = _dp_counters()[:4]
    steps = spec["steps"]
    runs, kept, init = {}, {}, None
    for name, extra, cm in spec["legs"]:
        leg_conf = dict(conf, zero_optimization=dict({"stage": 3}, **extra))
        if cm is not None:
            leg_conf["comm"] = {"collective_matmul": dict(
                {"enabled": True}, **cm)}
        engine = deepspeed_tpu_torch.initialize(
            model=device_gpt2(cfg, seed=0), mesh=mesh,
            config_params=leg_conf)[0]
        if init is None:
            init = _leaf_items(engine.get_master_params())
        batch = dp_rows((ids, ids.copy()), engine.dp_rank, DP_MICRO)
        losses = [float(engine.train_batch(batch=batch))]
        for c in counters:
            c.launches = 0
        WIRE.reset()
        gathers = engine.zero3.gathers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += [float(engine.train_batch(batch=batch))
                   for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        master = _leaf_items(engine.get_master_params())
        flat = engine.flat
        run = {"losses": losses, "step_ms": wall * 1e3 / steps,
               "gathers_per_step": (engine.zero3.gathers - gathers) / steps,
               "prefetched_gathers": engine.zero3.prefetched,
               "wire_bytes_per_step": {k: v / steps for k, v in
                                       WIRE.by_kind.items()},
               "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "param_bytes": flat.param_bytes(),
               "shard_world": flat.shard_world,
               "modes": [engine.zero_quantized_weights(),
                         engine.zero_hierarchical_partition(),
                         engine.zero_quantized_gradients(),
                         engine._cm_zero3],
               "want_modes": _zeropp_modes(extra, cm),
               "launches": {c.__name__: c.launches for c in counters}}
        for other in {spec["legs"][0][0], ZEROPP_BIT_EQUAL.get(name)}:
            if other in kept:
                want_losses, want = kept[other]
                run["vs_" + other] = dict(
                    _master_diff(master, want, cfg.d_model, init),
                    loss_rel=_rel(losses, want_losses),
                    bit_equal=losses == want_losses and all(
                        np.array_equal(master[k], w)
                        for k, w in want.items()))
        if name == spec["legs"][0][0] or \
                name in ZEROPP_BIT_EQUAL.values():
            kept[name] = (losses, master)
        runs[name] = run
        del engine, flat, master
        torch.cuda.empty_cache()
    return {"rank": rank, "runs": runs,
            "transport": torch.distributed.get_backend()}


def zeropp_spec(legs=ZEROPP_LEGS, layers=ZEROPP_LAYERS, steps=ZEROPP_STEPS):
    return {"legs": legs, "layers": layers, "steps": steps}


def _zeropp_checks(ranks, steps, failed):
    """The legs held to plain stage 3 (see :func:`phase_train_zeropp`);
    failures appended to ``failed``."""
    base = ranks[0]["runs"]
    first = next(iter(base))
    for r in ranks:
        for name, run in r["runs"].items():
            if run["losses"] != base[name]["losses"]:
                failed.append((r["rank"], name, "ranks' losses differ"))
            if not all(np.isfinite(run["losses"])):
                failed.append((r["rank"], name, "loss not finite"))
            counts = run["launches"]
            if counts["fused_adam"] != steps or \
                    counts["flash_fwd"] != 2 * counts["flash_bwd_dq"] or \
                    counts["flash_fwd"] == 0:
                failed.append((r["rank"], name, "launches", counts))
            if run["gathers_per_step"] != \
                    r["runs"][first]["gathers_per_step"]:
                failed.append((r["rank"], name, "gathers"))
            equal = ZEROPP_BIT_EQUAL.get(name)
            vs = {"vs_base": run.get("vs_" + first)}
            if equal in r["runs"]:
                vs["vs_equal"] = dict(
                    run["vs_" + equal], allgather=r["runs"][equal][
                        "wire_bytes_per_step"].get("allgather", 0.0))
            _zeropp_leg_checks(r["rank"], name, run, vs, r["runs"][first],
                               failed)


def phase_train_zeropp(spec=None, ranks=None, dp4_spec=None, dp4_ranks=None,
                       world=DP):
    """ZeRO++ and the ring gather on the stage-3 path: two spawned ranks
    sharing this card over gloo (train_dp_parity's, after its runs), ZeRO
    stage 3 on train_dp3's config at gpt2_medium width (d 1024) and 2
    layers, each leg from one init against plain stage 3: the ring gather
    (``comm.collective_matmul.zero_gather``) bit for bit, with qwZ against
    qwZ bit for bit; qwZ, qgZ, ring + qwZ and the three modes together
    (qwZ, hpZ 2, qgZ) held to plain stage 3 as
    :func:`_zeropp_leg_checks` says (``ZEROPP_LOSS_RTOL``,
    ``ZEROPP_MOVED_RTOL``, ``ZEROPP_KEY_BIAS_ATOL``: the CPU tests'
    tolerances against the JAX engine); then hpZ 2 at DP 4 (train_dp_tp_parity's four ranks, after their runs)
    against flat stage 3 at DP 4 bit for bit, each rank keeping about half
    the parameter pieces. Each leg: step ms (gloo on one card: the times
    only show that the path runs), unit gathers, bytes and peak GB a step,
    and the flash and Adam launches (the flash forward twice a layer:
    the unit's recompute)."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    spec = spec or zeropp_spec()
    dp4_spec = dp4_spec or zeropp_spec(ZEROPP_DP4_LEGS)
    if ranks is None:
        ranks = spawn(zeropp_rank, world, args=(spec,), timeout_s=600)
    if dp4_ranks is None:
        dp4_ranks = spawn(zeropp_rank, 4, args=(dp4_spec,), timeout_s=600)
    failed = []
    _zeropp_checks(ranks, spec["steps"], failed)
    _zeropp_checks(dp4_ranks, dp4_spec["steps"], failed)
    for r in dp4_ranks:
        hpz, s3 = r["runs"]["hpz"], r["runs"]["s3"]
        if hpz["shard_world"] != 2 or s3["shard_world"] != 4:
            failed.append((r["rank"], "shard groups"))
        share = hpz["param_bytes"] / (2 * s3["param_bytes"])
        r["hpz_param_bytes_over_twice_flat"] = share
        if not 0.9 < share <= 1.0:
            failed.append((r["rank"], "hpz param bytes", share))
    assert not failed, (failed, ranks, dp4_ranks)
    legs = {name: {k: v for k, v in run.items() if k != "launches"}
            for name, run in ranks[0]["runs"].items()}
    return {"phase": "train_zeropp", "model": "gpt2_medium",
            "layers": spec["layers"], "seq": TRAIN_SEQ,
            "micro_batch_per_rank": DP_MICRO, "data": world,
            "config": EXAMPLE_CONFIG + " without clipping, stage 3",
            "transport": ranks[0]["transport"], "steps": spec["steps"],
            "tolerance_quantized": {"loss_rel": ZEROPP_LOSS_RTOL,
                                    "moved_rel": ZEROPP_MOVED_RTOL,
                                    "key_bias_max_abs":
                                    ZEROPP_KEY_BIAS_ATOL},
            "legs_rank0": legs,
            "launches_rank0": {name: run["launches"] for name, run in
                               ranks[0]["runs"].items()},
            "dp4_hpz_rank0": dp4_ranks[0]["runs"],
            "step_ms_note": "ranks share one card over gloo: the times "
                            "only show that the path runs"}


def phase_train_offload_ckpt(layers=OFFLOAD_CKPT_LAYERS, steps=2):
    """Checkpoints of ZeRO-Offload at gpt2_medium width, ``layers``
    layers: an offload engine (stage 3) saves after ``steps`` steps and
    takes ``steps`` more; a fresh one from another seed loads the tag and
    takes the same: losses, master and moments equal bit for bit. A
    stage-2 engine with the state on the card loads that tag (master and
    moments equal to the saved ones), saves its own after a step, and an
    offload engine loads it, the same."""
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf["steps_per_print"] = 10 ** 9
    off = dict(conf, zero_optimization={"stage": 3, "cpu_offload": True})
    dev = dict(conf, zero_optimization={"stage": 2})
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, n_layers=layers)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(1, DP_MICRO, TRAIN_SEQ)) \
        .astype(np.int64)
    batch = (ids, ids.copy())

    def engine(c, seed):
        return deepspeed_tpu_torch.initialize(
            model=device_gpt2(cfg, seed=seed), config_params=c)[0]

    def state(e):
        opt = e.get_optimizer_state()
        return (_leaf_items(e.get_master_params()),
                _leaf_items(opt["exp_avg"]), _leaf_items(opt["exp_avg_sq"]))

    def same(a, b):
        return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b)
                   for k in y)

    out = {"phase": "train_offload_ckpt", "model": "gpt2_medium",
           "layers": layers, "steps": steps}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_offload_") as tmp:
        a = engine(off, 0)
        for _ in range(steps):
            a.train_batch(batch=batch)
        t0 = time.perf_counter()
        a.save_checkpoint(tmp, tag="offload")
        out["save_s"] = time.perf_counter() - t0
        saved = state(a)
        want = [float(a.train_batch(batch=batch)) for _ in range(steps)]
        want_state = state(a)
        del a
        b = engine(off, 1)
        t0 = time.perf_counter()
        b.load_checkpoint(tmp, tag="offload")
        out["load_s"] = time.perf_counter() - t0
        got = [float(b.train_batch(batch=batch)) for _ in range(steps)]
        out["resume_bit_equal"] = got == want and same(state(b),
                                                       want_state)
        del b
        c = engine(dev, 1)
        c.load_checkpoint(tmp, tag="offload")
        out["device_loads_offload_tag"] = same(state(c), saved)
        c.train_batch(batch=batch)
        c.save_checkpoint(tmp, tag="device")
        saved = state(c)
        del c
        d = engine(off, 2)
        d.load_checkpoint(tmp, tag="device")
        out["offload_loads_device_tag"] = same(state(d), saved)
        out["next_loss_finite"] = bool(np.isfinite(
            float(d.train_batch(batch=batch))))
        del d
    torch.cuda.empty_cache()
    for key in ("resume_bit_equal", "device_loads_offload_tag",
                "offload_loads_device_tag", "next_loss_finite"):
        assert out[key], (key, out)
    out["losses"] = want
    return out


def _whole_master(flat):
    """``{name: fp32 leaf on the card}`` of a partition's master, whole
    (every rank of its data group must call)."""
    whole = flat.whole(flat.master).to(flat.device)
    return {name: whole[off:off + int(np.prod(shape))]
            for name, off, shape in zip(flat.names, flat.offsets,
                                        flat.shapes)}


def _master_diff_on_card(got, want, d_model, init):
    """:func:`_master_diff` on leaves that stay on the card (gpt2_xl's
    whole masters are 6.2 GB each), and the same over the whole model
    (``moved_rel_model``: the difference's norm over every leaf against
    the move's)."""
    import torch
    worst, key_bias, moved, diff2, move2 = 0.0, 0.0, 0.0, 0.0, 0.0
    for name, w in want.items():
        a, b, i = got[name], w, init[name]
        if name.endswith("qkv_bias"):
            key = slice(d_model, 2 * d_model)
            key_bias = max(key_bias, float((a[key] - b[key]).abs().max()))
            a, b, i = (torch.cat([t[:d_model], t[2 * d_model:]])
                       for t in (a, b, i))
        worst = max(worst, float((a - b).abs().max()))
        norm = float((b - i).double().norm())
        diff = float((a - b).double().norm())
        diff2, move2 = diff2 + diff ** 2, move2 + norm ** 2
        if norm > 0:
            moved = max(moved, diff / norm)
    return {"max_abs": worst, "key_bias_max_abs": key_bias,
            "moved_rel": moved, "moved_rel_model": (diff2 / move2) ** 0.5}


XL_ZERO3_LEGS = (("stage2", {"stage": 2}, None),
                 ("stage3", {"stage": 3}, None),
                 ("stage3_offload", {"stage": 3, "cpu_offload": True}, None))
# the ZeRO++ legs, each against stage 3 (ZEROPP_BIT_EQUAL, ZEROPP_QUANTIZED)
XL_ZEROPP_LEGS = (("stage3_qwz", dict(QWZ, stage=3), None),
                  ("stage3_qgz", {"stage": 3,
                                  "zero_quantized_gradients": True}, None),
                  ("stage3_ring", {"stage": 3}, {"zero_gather": True}),
                  ("stage3_ring_qwz", dict(QWZ, stage=3),
                   {"zero_gather": True}),
                  ("stage3_all", dict(ZEROPP_ALL, stage=3), None))
XL_COMPARE = dict({"stage3": "stage2", "stage3_offload": "stage3"},
                  **{name: "stage3" for name, _, _ in XL_ZEROPP_LEGS})


def nccl_zero3_rank(rank, world, spec):
    """One rank of ``dp_nccl_zero3``: gpt2_xl at full depth over
    ``build_mesh(data=world)`` (NCCL, one rank a card), bench_gpt2_xl.py's
    config and batch shape a rank, one run per leg of ``spec["legs"]``
    (stage 2, the reference; stage 3; stage 3 with cpu_offload; the ZeRO++
    legs), from one init: step ms, the rank's peak (with the whole masters
    this harness keeps on the card, ``reference_masters_gb``) and
    parameter bytes,
    the bytes handed to ``torch.distributed`` a step (``quantize.WIRE``, by
    kind), a profiled step's all-gather, reduce-scatter and send/recv
    (the ring gather's hops) kernel ms; each run against the one
    ``XL_COMPARE`` names: losses (relative) and the whole masters after
    the last step (:func:`_master_diff_on_card`), and whether they agree
    bit for bit."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.comm.quantize import WIRE
    cfg = _xl_cfg()
    mesh = build_mesh(data=world)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(
        1, XL_MICRO * world, XL_SEQ)).astype(np.int64)
    out = {"rank": rank, "compared": {}}
    legs = spec["legs"]
    refs = {XL_COMPARE.get(name) for name, _, _ in legs}
    masters, init = {}, None
    for name, zero, cm in legs:
        conf = dict(XL_CONFIG, zero_optimization=zero)
        if cm is not None:
            conf["comm"] = {"collective_matmul": dict({"enabled": True},
                                                      **cm)}
        engine = deepspeed_tpu_torch.initialize(
            model=device_gpt2(cfg, seed=0), mesh=mesh,
            config_params=conf)[0]
        if init is None:
            init = _whole_master(engine.flat)
        batch = dp_rows((ids, ids.copy()), engine.dp_rank, XL_MICRO)
        # the whole masters this harness keeps on the card for its
        # comparisons, inside the peak below
        held = sum(t.numel() * t.element_size() for tree in
                   [init] + list(masters.values()) for t in tree.values())
        losses = [float(engine.train_batch(batch=batch))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        WIRE.reset()
        t0 = time.perf_counter()
        losses += [float(engine.train_batch(batch=batch))
                   for _ in range(spec["steps"])]
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wire = {k: v / spec["steps"] for k, v in WIRE.by_kind.items()}
        prof = train_profile(engine, batch, steps=1,
                             span_names=ZERO3_SPANS,
                             kernel_groups=("AllGather", "ReduceScatter",
                                            "AllReduce", "SendRecv",
                                            "flash_"))
        master = _whole_master(engine.flat)
        out[name] = {"losses": losses,
                     "step_ms": wall * 1e3 / spec["steps"],
                     "peak_memory_gb": peak_gb,
                     "reference_masters_gb": held / 2 ** 30,
                     "param_bytes": engine.flat.param_bytes(),
                     "state_bytes": engine.flat.state_bytes(),
                     "wire_bytes_per_step": wire,
                     "modes": [engine.zero_quantized_weights(),
                               engine.zero_hierarchical_partition(),
                               engine.zero_quantized_gradients(),
                               engine._cm_zero3],
                     "want_modes": _zeropp_modes(zero, cm),
                     "prefetched_gathers": engine.zero3.prefetched
                     if engine.zero3 else 0,
                     "collective_kernel_ms_per_step":
                     prof.get("kernel_ms_per_step_by_group"),
                     "host_ms_per_step_in_spans":
                     prof.get("host_ms_per_step_in_spans"),
                     "device_busy_share": prof["device_busy_share"],
                     "offload_ms": dict(engine.offload.last_times)
                     if engine.offload else None}
        del engine
        ref = XL_COMPARE.get(name)
        if ref in masters:
            want = masters[ref]
            out["compared"]["{}_vs_{}".format(name, ref)] = dict(
                _master_diff_on_card(master, want, cfg.d_model, init),
                loss_rel=max(abs(x - y) / abs(y) for x, y in
                             zip(losses, out[ref]["losses"])),
                bit_equal=losses == out[ref]["losses"] and all(
                    torch.equal(master[k], w) for k, w in want.items()))
        if name in refs:
            masters[name] = master
        del master
        torch.cuda.empty_cache()
    del masters, init
    torch.cuda.empty_cache()
    out["transport"] = torch.distributed.get_backend()
    return out


def _nccl_zero3_checks(ranks, names, loss_tol=1e-4,
                       leaf_moved_rtol=DEEP_LEAF_MOVED_RTOL,
                       model_moved_rtol=OFFLOAD_MOVED_RTOL,
                       key_bias_atol=1e-3):
    """:func:`phase_dp_nccl_zero3`'s checks of the runs ``names`` (stage 3
    first when a ZeRO++ leg is among them): a list of the failures."""
    failed = []
    for r in ranks:
        for name in names:
            if not all(np.isfinite(r[name]["losses"])):
                failed.append((r["rank"], name, "loss not finite"))
            if r[name]["losses"] != ranks[0][name]["losses"]:
                failed.append((r["rank"], name, "ranks' losses differ"))
            if name in ZEROPP_BIT_EQUAL or name in ZEROPP_QUANTIZED:
                equal = ZEROPP_BIT_EQUAL.get(name)
                vs = {"vs_base": r["compared"][name + "_vs_stage3"]}
                if equal is not None:
                    vs["vs_equal"] = dict(
                        r["compared"]["{}_vs_{}".format(name, equal)],
                        allgather=r[equal]["wire_bytes_per_step"].get(
                            "allgather", 0.0))
                _zeropp_leg_checks(r["rank"], name, r[name], vs,
                                   r["stage3"], failed)
        for pair, got in r["compared"].items():
            leg = pair.split("_vs_")[0]
            if leg in ZEROPP_BIT_EQUAL or leg in ZEROPP_QUANTIZED:
                continue
            for key, tol in (("loss_rel", loss_tol),
                             ("moved_rel", leaf_moved_rtol),
                             ("moved_rel_model", model_moved_rtol),
                             ("key_bias_max_abs", key_bias_atol)):
                if not got[key] <= tol:
                    failed.append((r["rank"], pair, key, got[key], tol))
        if "stage2" in names and not r["stage3"]["param_bytes"] < \
                1.2 / len(ranks) * r["stage2"]["param_bytes"]:
            failed.append((r["rank"], "param_bytes"))
    return failed


def phase_dp_nccl_zero3(world=4, steps=2, loss_tol=1e-4,
                        leaf_moved_rtol=DEEP_LEAF_MOVED_RTOL,
                        model_moved_rtol=OFFLOAD_MOVED_RTOL,
                        key_bias_atol=1e-3):
    """``--dp-nccl``'s ZeRO-3 part: gpt2_xl at full depth, DP 4 over NCCL,
    one rank per card: stage 3 and stage 3 with cpu_offload, each held to
    the run before it (stage 3 to stage 2, the offload run to stage 3):
    losses within ``loss_tol`` relative; masters by how far they moved,
    within ``leaf_moved_rtol`` on each leaf and ``model_moved_rtol`` over
    the whole model; the qkv biases' key part within ``key_bias_atol``.
    Stage 3 cuts each unit over the ranks where stage 2 cuts the whole
    layout, so an element's four gradients reach it in another order: the
    two agree to a tolerance at DP 4 (bit for bit at DP 2, train_dp3),
    and the run reports whether they agreed bit for bit. Then the ZeRO++
    legs against stage 3 (:func:`_zeropp_leg_checks`): each leg's modes
    as its keys name them; the ring gather bit for bit, with stage 3's
    gather bytes and gathers served by posted rings; qwZ, qgZ, the ring
    with qwZ and the three modes (qwZ, hpZ 2, qgZ) apart from stage 3 but
    within the CPU tests' tolerances of it, qwZ's gathers about half
    stage 3's bytes."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    legs = XL_ZERO3_LEGS + XL_ZEROPP_LEGS
    ranks = spawn(nccl_zero3_rank, world,
                  args=({"steps": steps, "legs": legs},), timeout_s=2400)
    failed = _nccl_zero3_checks(ranks, [name for name, _, _ in legs],
                                loss_tol, leaf_moved_rtol, model_moved_rtol,
                                key_bias_atol)
    # every check read before any fails, so a failure shows all readings
    assert not failed, (failed, [r["compared"] for r in ranks])
    return {"phase": "dp_nccl_zero3", "model": "gpt2_xl", "data": world,
            "seq": XL_SEQ, "micro_batch_per_rank": XL_MICRO,
            "transport": ranks[0]["transport"], "steps": steps,
            "tolerances": {"loss_rel": loss_tol,
                           "moved_rel": leaf_moved_rtol,
                           "moved_rel_model": model_moved_rtol,
                           "key_bias_max_abs": key_bias_atol,
                           "zeropp_quantized": {
                               "loss_rel": ZEROPP_LOSS_RTOL,
                               "moved_rel": ZEROPP_MOVED_RTOL,
                               "key_bias_max_abs": ZEROPP_KEY_BIAS_ATOL}},
            "ranks": ranks}


PIPE_LAYERS, PIPE_M, PIPE_WARMUP, PIPE_STEPS = 24, 8, 2, 3
# train_pipe's depth on one card (the script's time limit; the
# four-card --pp-nccl runs PIPE_LAYERS)
PIPE_ONE_CARD_LAYERS = 12
PIPE_PARITY_LAYERS, PIPE_PARITY_M, PIPE_PARITY_STEPS = 4, 4, 3
PIPE_MOVED_RTOL = 0.1


def _pipe_chip():
    """``probes/pipe_chip.py``: the pipeline phases' rank bodies."""
    import os
    probes = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "probes")
    if probes not in sys.path:
        sys.path.insert(0, probes)
    import pipe_chip
    return pipe_chip


def phase_train_pipe(world=2, stages=2, dp=1, tp=1, stage=2,
                     layers=PIPE_LAYERS, M=PIPE_M, steps=PIPE_STEPS,
                     parity=None, seed=None):
    """The pipeline main path: ``world`` spawned ranks, ``stages`` x ``dp``
    x ``tp`` (one card: every rank on it over gloo, so the step time only
    shows that the path runs; four cards: NCCL, one rank a card). Every
    rank launches each flash kernel at the counts the recompute schedule
    gives (``pipe_chip.expected_launches``) and Adam once a step, the ring
    kernels under TP; the ranks of a pipe line report the same losses,
    finite and falling; the tied embedding's two copies are equal bit for
    bit (sha256 of the master leaves). With ``parity``
    (:func:`pipe_parity_spec`) the same ranks then run train_pipe_parity's
    runs, returned under "parity_ranks". ``seed`` None: each rank draws
    its own layers from the torch RNG, seeded per layer (the dense init's
    numpy draws of all 24 layers take ~14 s a rank); an int: the dense
    model's seeded weights, for a comparison with the dense engine."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    pc = _pipe_chip()
    spec = {"S": stages, "dp": dp, "tp": tp, "stage": stage,
            "layers": layers, "M": M, "warmup": PIPE_WARMUP,
            "steps": steps, "seed": seed, "profile": True,
            "parity": parity, "t_spawn": time.time()}
    ranks = spawn(pc.train_rank, world, args=(spec,), timeout_s=900)
    parity_ranks = [r.pop("parity") for r in ranks] if parity else None
    for r in ranks:
        assert all(np.isfinite(r["losses"])), r["losses"]
        assert r["losses"] == ranks[0]["losses"], "ranks disagree"
        assert r["views"] and r["device"].startswith("cuda"), r
        for name, n in r["expected"].items():
            assert r["launches"][name] == n * steps, (name, r["launches"],
                                                      r["expected"])
        for name in RING_NAMES:
            assert (r["launches"][name] > 0) == (tp > 1), r["launches"]
    digests = {}
    for r in ranks:
        if r["tied_digest"] is not None:
            digests.setdefault(r["rank"] % (dp * tp), set()).add(
                r["tied_digest"])
    assert digests and all(len(d) == 1 for d in digests.values()), digests
    from deepspeed_tpu_torch.models import gpt2
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          n_layers=layers)
    step_ms = max(r["step_ms"] for r in ranks)
    tokens = M * pc.MICRO * dp * TRAIN_SEQ
    cards = 1 if ranks[0]["transport"] == "gloo" else world
    mfu = tokens / step_ms * 1e3 * xl_flops_per_token(cfg) / \
        (BF16_FLOPS_PER_S * cards)
    per_rank = {name: [r["launches"][name] // steps for r in ranks]
                for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                             "fused_adam") + RING_NAMES}
    return {"phase": "train_pipe", "config": pc.EXAMPLE_CONFIG,
            "model": "gpt2_medium", "layers": layers, "seq": TRAIN_SEQ,
            "micro_batch_per_rank": pc.MICRO, "micro_batches": M,
            "stages": stages, "data": dp, "tp": tp, "zero_stage": stage,
            "parts": ranks[0]["parts"], "transport": ranks[0]["transport"],
            "devices": [r["device"] for r in ranks], "steps": steps,
            "step_ms": step_ms, "step_ms_per_rank":
                [r["step_ms"] for r in ranks],
            "step_ms_note": "ranks share one card and cross host memory "
                            "for every hop over gloo: this time only shows "
                            "that the path runs"
            if cards == 1 else "one rank a card, NCCL",
            "tokens_per_s": tokens / step_ms * 1e3, "mfu": mfu,
            "mfu_formula": "tokens/s * (6 N + 12 L d s) / (989e12 x {} "
                           "card(s)), recompute not counted".format(cards),
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
            "p2p_host_ms_per_step_per_rank":
                [r["p2p_host_ms_per_step"] for r in ranks],
            "tied_reduce_ms_per_step_per_rank":
                [r["tied_reduce_ms_per_step"] for r in ranks],
            "device_busy_share_per_rank":
                [r["train_profile"]["device_busy_share"] for r in ranks],
            "kernel_ms_per_step_by_group_per_rank":
                [r["train_profile"]["kernel_ms_per_step_by_group"]
                 for r in ranks],
            "host_ms_per_step_in_spans_rank0":
                ranks[0]["train_profile"]["host_ms_per_step_in_spans"],
            "launches_per_rank_per_step": per_rank,
            "losses": ranks[0]["losses"],
            "stats_rank0": ranks[0]["stats"],
            "parity_ranks": parity_ranks,
            "ranks": [{k: v for k, v in r.items() if k != "train_profile"}
                      for r in ranks]}


def pipe_parity_spec(layers=PIPE_PARITY_LAYERS, M=PIPE_PARITY_M,
                     steps=PIPE_PARITY_STEPS, lr=1e-4):
    """train_pipe_parity's rank spec: its runs (v1's last step is its
    peak-memory step at M; the resumed run is the check of v = 2 against
    v = 1) and a temporary directory for the tag (the caller removes it
    with ``pipe_chip.remove``)."""
    pc = _pipe_chip()
    base = {"S": 2, "layers": layers, "M": M, "seed": 1,
            "constant_lr": lr}
    return {"seed": 2, "dir": pc.temp_dir(), "base": base, "steps": steps,
            "runs": [
                ("v1", dict(base), [1, "save"] + [1] * (steps - 2) +
                 ["peak", "master"]),
                ("control", dict(base, no_tied_sum=True),
                 [steps, "master"]),
                ("save", dict(base, save=True), [steps, "master"]),
                ("v2_resume", dict(base, v=2),
                 ["load", steps - 1, "master"]),
                ("peak_2m", dict(base, M=2 * M), ["peak"])]}


def phase_train_pipe_parity(spec=None, ranks=None,
                            moved_rtol=PIPE_MOVED_RTOL):
    """PP 2 at gpt2_medium width with ``layers`` layers, bf16, the
    example's config at a constant ``lr``, TF32 off, from the dense
    model's seeded weights, two gloo ranks on the card (one spawn):

    * against the one-rank engine on the same micro-batches
      (``gradient_accumulation_steps`` = M): the first loss within 1e-6
      relative, each master leaf's move within ``moved_rtol`` of the dense
      run's (``_master_diff``; the tied ``wte`` sums its two uses in fp32
      here and in bf16 there); the control, the same run with the
      tied-gradient sum skipped, must exceed ``moved_rtol``;
    * ``save_stage_residuals`` against the default: bit for bit;
    * v = 2 against v = 1: a tag saved at v = 1 after one step, resumed
      at v = 2, against the v = 1 run that kept going: the losses within
      1e-6 relative and the masters' move within 1e-3 (bit for bit but
      for the clipping coefficient, whose global norm sums the stages'
      squares in another grouping), whether bit-equal reported (the CPU
      tests hold v = 2 from the start against v = 1 bit for bit);
    * each rank's peak memory of one step at M (v = 1's last step) and
      at 2 M within 10%.

    ``spec`` (:func:`pipe_parity_spec`) and ``ranks``: the runs already
    made by train_pipe's ranks (one spawn for both phases); without them
    the phase spawns its own two ranks."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    pc = _pipe_chip()
    if ranks is None:
        spec = pipe_parity_spec()
        try:
            ranks = spawn(pc.parity_rank, 2, args=(spec,), timeout_s=900)
        finally:
            pc.remove(spec["dir"])
    base, steps = spec["base"], spec["steps"]
    layers, M, lr = base["layers"], base["M"], base["constant_lr"]
    dense_losses, init, dense = pc.dense_reference(
        dict(base, batch_seed=spec["seed"]), layers, M, steps, base["seed"])
    torch.cuda.empty_cache()
    r0 = ranks[0]
    for r in ranks:
        for name in r0:
            assert r[name]["losses"] == r0[name]["losses"], name
    from deepspeed_tpu_torch.models import gpt2
    d_model = gpt2.SIZES["gpt2_medium"]["d_model"]
    master = {name: r0[name]["masters"][-1] for name in
              ("v1", "control", "save", "v2_resume")}
    vs_dense = {name: _master_diff(master[name], dense, d_model, init)
                for name in ("v1", "control")}
    vs_v1 = {name: _master_diff(master[name], master["v1"], d_model, init)
             for name in ("save", "v2_resume")}
    bit_equal = {name: all(np.array_equal(v, master["v1"][k])
                           for k, v in master[name].items()) and
                 r0[name]["losses"] == r0["v1"]["losses"][
                     -len(r0[name]["losses"]):]
                 for name in ("save", "v2_resume")}
    peaks = [(r["v1"]["peak_gb"], r["peak_2m"]["peak_gb"]) for r in ranks]
    rel = {"first loss: pp2 vs dense": abs(
        r0["v1"]["losses"][0] - dense_losses[0]) / abs(dense_losses[0]),
        "pp2 vs dense": _rel(r0["v1"]["losses"], dense_losses),
        "v2 resumed vs v1 kept going": _rel(r0["v2_resume"]["losses"],
                                            r0["v1"]["losses"][1:])}
    result = {"phase": "train_pipe_parity", "layers": layers,
              "d_model": d_model, "seq": TRAIN_SEQ, "micro_batches": M,
              "micro_batch_per_rank": pc.MICRO, "steps": steps, "lr": lr,
              "losses": {"dense": dense_losses,
                         **{n: r0[n]["losses"] for n in r0}},
              "loss_rel_diff": rel, "master_vs_dense": vs_dense,
              "master_vs_v1": vs_v1, "bit_equal_to_v1": bit_equal,
              "peak_gb_per_rank_m_2m": peaks,
              "launches_rank0": {n: r0[n]["launches"] for n in r0},
              "run_s_rank0": {n: r0[n]["run_s"] for n in r0},
              "tolerance": {"first_loss_rel": 1e-6,
                            "moved_rel": moved_rtol,
                            "layout_loss_rel": 1e-6,
                            "layout_moved_rel": 1e-3, "peak_ratio": 1.10}}
    assert rel["first loss: pp2 vs dense"] <= 1e-6, result
    assert vs_dense["v1"]["moved_rel"] <= moved_rtol, result
    assert vs_dense["control"]["moved_rel"] > moved_rtol, result
    assert bit_equal["save"], result
    assert rel["v2 resumed vs v1 kept going"] <= 1e-6, result
    assert vs_v1["v2_resume"]["moved_rel"] <= 1e-3, result
    for m, m2 in peaks:
        assert m2 <= 1.10 * m, result
    return result


def pipe3_spec(layers=PIPE_PARITY_LAYERS, M=PIPE_PARITY_M, steps=2,
               lr=1e-4):
    """train_pipe3's rank spec (PP 2 x DP 2, gpt2_medium width at
    ``layers`` layers) and a temporary directory for its tag (the caller
    removes it with ``pipe_chip.remove``)."""
    pc = _pipe_chip()
    return {"seed": 2, "dir": pc.temp_dir(), "steps": steps,
            "base": {"S": 2, "dp": 2, "layers": layers, "M": M, "seed": 1,
                     "constant_lr": lr}}


def phase_train_pipe3(spec=None, ranks=None, moved_rtol=PIPE_MOVED_RTOL):
    """ZeRO stage 3 under pipeline parallelism: PP 2 x DP 2 at gpt2_medium
    width with ``layers`` layers, four gloo ranks on the card (by default
    the ranks of train_dp_tp_parity's spawn), the example's config at a
    constant learning rate, TF32 off, from the dense model's seeded
    weights, 2 steps: stage 3 against stage 2 at train_pipe_parity's
    limits (the first loss within 1e-6 relative, each master leaf's move
    within ``moved_rtol``; every loss's difference and whether the
    masters are bit-equal reported: on the CPU they are, on the card the
    two runs' kernels may sum in other orders); every rank launches the
    flash kernels at the counts it states (``pipe_chip.
    expected_launches``: at stage 3 the forward twice a layer and
    micro-batch on every stage, the backward kernels once) and Adam once
    a step; then a pipeline tag under ``cpu_offload`` (stage 3, the host
    Adam) saved after one step and resumed by a fresh engine: the
    resumed losses and masters equal the run that kept going, bit for
    bit."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    pc = _pipe_chip()
    if ranks is None:
        spec = pipe3_spec()
        try:
            ranks = spawn(pc.pipe3_rank, 4, args=(spec,), timeout_s=900)
        finally:
            pc.remove(spec["dir"])
    torch.cuda.empty_cache()
    base, steps = spec["base"], spec["steps"]
    runs = ("s2", "s3", "offload_save", "offload_resume")
    r0 = ranks[0]
    # the losses are the same on every rank (the pipe group's sum)
    for r in ranks:
        for name in runs:
            assert r[name]["losses"] == r0[name]["losses"], name
    s2, s3 = r0["s2"]["losses"], r0["s3"]["losses"]
    first_rel = abs(s3[0] - s2[0]) / abs(s2[0])
    moved = max(r["master_s3_vs_s2"]["moved_rel"] for r in ranks)
    save, resume = r0["offload_save"], r0["offload_resume"]
    resumed_equal = resume["losses"] == save["losses"][1:] and \
        all(r["resumed_equal"] for r in ranks)
    result = {"phase": "train_pipe3", "layers": base["layers"],
              "d_model": 1024, "seq": TRAIN_SEQ, "stages": 2, "data": 2,
              "micro_batches": base["M"], "micro_batch_per_rank": pc.MICRO,
              "steps": steps, "lr": base["constant_lr"],
              "losses": {n: r0[n]["losses"] for n in runs},
              "first_loss_rel_stage3_vs_stage2": first_rel,
              "loss_max_rel_stage3_vs_stage2": _rel(s3, s2),
              "master_stage3_vs_stage2_per_rank":
                  [r["master_s3_vs_s2"] for r in ranks],
              "bit_equal_stage3_vs_stage2": s3 == s2 and
              all(r["bit_equal_s3_vs_s2"] for r in ranks),
              "offload_resumed_equal_kept_going": resumed_equal,
              "launches_per_rank": [{n: r[n]["launches"] for n in runs}
                                    for r in ranks],
              "expected_per_step_per_rank": [r["s3"]["expected"]
                                             for r in ranks],
              "gathers_per_rank_stage3": [r["s3"]["gathers"] for r in ranks],
              "run_s_rank0": {n: r0[n]["run_s"] for n in runs},
              "tolerance": {"first_loss_rel": 1e-6,
                            "moved_rel": moved_rtol}}
    for r in ranks:
        for name in ("s2", "s3", "offload_save"):
            run = r[name]
            for kernel, n in run["expected"].items():
                assert run["launches"][kernel] == n * run["launch_steps"], \
                    (name, kernel, run["launches"], run["expected"])
    assert first_rel <= 1e-6, result
    assert moved <= moved_rtol, result
    assert resumed_equal, result
    assert all(np.isfinite(s3)), result
    return result


def main_pp_nccl():
    """``--pp-nccl``: the pipeline main path with one rank per card over
    NCCL (needs 4 cards) at full depth: PP 4, PP 2 x DP 2 (ZeRO-2) and
    PP 2 x TP 2 (ZeRO-1, collective matmul); each with the step, each
    rank's busy share and the NCCL kernels' time a step; then the dense
    DP 4 engine on PP 2 x DP 2's global batch from the same seeded
    weights, the losses within 2e-3 relative (bf16 runs that sum in other
    groupings)."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    count = torch.cuda.device_count()
    assert count >= 4, "--pp-nccl needs 4 cards, found {}".format(count)
    pc = _pipe_chip()
    results = {}
    for name, (stages, dp, tp, stage) in (("pp4", (4, 1, 1, 2)),
                                          ("pp2_dp2", (2, 2, 1, 2)),
                                          ("pp2_dp2_s3", (2, 2, 1, 3)),
                                          ("pp2_tp2", (2, 1, 2, 1))):
        # PP 2 x DP 2 from the dense model's seeded weights, for the
        # comparison with the dense DP 4 engine below and of stage 3
        # with stage 2
        res = phase_train_pipe(world=4, stages=stages, dp=dp, tp=tp,
                               stage=stage,
                               seed=0 if name.startswith("pp2_dp2")
                               else None)
        assert res["transport"] == "nccl", res["transport"]
        res["phase"] = "pp_nccl_" + name
        res.pop("parity_ranks")
        results[name] = res
        emit(res)
    spec = {"layers": PIPE_LAYERS, "M": PIPE_M, "dp": 2, "micro": pc.MICRO,
            "gas": PIPE_M * 2 // 4, "seed": 0, "warmup": PIPE_WARMUP,
            "steps": PIPE_STEPS}
    dense = spawn(pc.dense_dp_rank, 4, args=(spec,), timeout_s=900)
    pipe = results["pp2_dp2"]["losses"]
    losses = dense[0]["losses"]
    rel = _rel(pipe, losses)
    result = {"phase": "pp_nccl_vs_dp4", "pp2_dp2_losses": pipe,
              "dp4_losses": losses, "loss_max_rel_diff": rel,
              "tolerance": 2e-3,
              "dp4_step_ms_same_batch": max(r["step_ms"] for r in dense),
              "step_ms": {n: r["step_ms"] for n, r in results.items()}}
    emit(result)
    assert rel <= 2e-3, result
    s3 = results["pp2_dp2_s3"]
    zero3 = {"phase": "pp_nccl_zero3", "stage2_losses": pipe,
             "stage3_losses": s3["losses"],
             "loss_max_rel_diff": _rel(s3["losses"], pipe),
             "bit_equal_losses": s3["losses"] == pipe,
             "step_ms": {"stage2": results["pp2_dp2"]["step_ms"],
                         "stage3": s3["step_ms"]},
             "nccl_kernel_ms_per_step_per_rank": {
                 "stage2": results["pp2_dp2"][
                     "kernel_ms_per_step_by_group_per_rank"],
                 "stage3": s3["kernel_ms_per_step_by_group_per_rank"]},
             "peak_memory_gb_per_rank": {
                 "stage2": results["pp2_dp2"]["peak_memory_gb_per_rank"],
                 "stage3": s3["peak_memory_gb_per_rank"]},
             "tolerance": 1e-3}
    emit(zero3)
    assert zero3["loss_max_rel_diff"] <= 1e-3, zero3


# --------------------------------------------------- compressed communication


# the 1-bit Adam tutorial's optimizer block (docs/_tutorials/onebit-adam.md),
# freeze_step 2; ZeRO stage 0 (the JAX engine refuses weight decay above it)
ONEBIT_PARAMS = {"lr": 4e-4, "betas": [0.9, 0.999], "weight_decay": 0.01,
                 "freeze_step": 2}
ONEBIT_FROZEN, QC_STEPS = 3, 3
# lanes of gpt2_medium's fused exchange buffer: its 354,871,296 parameters
# (vocabulary 50304, 24 layers, d 1024, 1024 positions), no padding
GPT2_MEDIUM_NUMEL = 354_871_296
COMM_SPANS = ("comm.quantized_exchange", "onebit.exchange",
              "onebit.warmup_average", "zero.all_reduce", "zero.all_gather",
              "zero.reduce_scatter")
NCCL_GROUPS = ("AllReduce", "AllGather", "ReduceScatter", "SendRecv",
               "nccl")
# the card's exchange against the port's code on CPU tensors: scales (the
# norm sums in another order) within SCALE_RTOL; a lane re-signed by the
# server phase may differ where |chunk mean + server error| is within
# SIGN_RTOL of the server scale
EXCHANGE_SCALE_RTOL, EXCHANGE_SIGN_RTOL = 1e-5, 1e-4
WARMUP_LOSS_RTOL, WARMUP_MOVED_RTOL = 5e-4, 1e-3
QC_LOSS_RTOL = 1e-3


def _onebit_conf(micro, freeze=None, stage=0):
    return {"train_micro_batch_size_per_gpu": micro,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": "OneBitAdam", "params": dict(
                ONEBIT_PARAMS, **({} if freeze is None else
                                  {"freeze_step": freeze}))},
            "bf16": {"enabled": True}, "zero_optimization": {"stage": stage},
            "transformer": {"flash_attention": "auto"}}


def _plain_adam_conf(micro):
    """Stage 0 Adam in plain math with OneBitAdam's hyperparameters: L2
    weight decay (adam_w_mode off), the plain version of the update."""
    conf = _onebit_conf(micro)
    params = dict(ONEBIT_PARAMS, adam_w_mode=False, fused_kernel="xla")
    params.pop("freeze_step")
    conf["optimizer"] = {"type": "Adam", "params": params}
    return conf


def _qc_conf(micro, hierarchical=None):
    conf = _example_conf(micro)
    if hierarchical is not None:
        conf["comm"] = {"quantized_collectives": {
            "enabled": True, "hierarchical": hierarchical}}
    return conf


def _capture_exchange(opt, store):
    """Wrap ``opt.exchange`` to keep the inputs and outputs of its next call
    on the host (the card's exchange, for the CPU recompute)."""
    real = opt.exchange

    def exchange(g_fused, wd_fused=None):
        cpu = lambda t: None if t is None else t.detach().cpu().clone()
        store["in"] = {"g": cpu(g_fused), "wd": cpu(wd_fused),
                       "m": cpu(opt.exp_avg), "we": cpu(opt.worker_error),
                       "se": cpu(opt.server_error)}
        real(g_fused, wd_fused)
        store["out"] = {"m": cpu(opt.exp_avg), "we": cpu(opt.worker_error),
                        "se": cpu(opt.server_error)}
        opt.exchange = real

    opt.exchange = exchange


def _exchange_on_cpu(opt, captured, group):
    """The captured frozen step's exchange again, by the port's code on CPU
    tensors over the same gloo group; its comparison with the card's
    result."""
    import torch
    from deepspeed_tpu_torch.runtime.comm.onebit import (
        onebit_all_gather_local, onebit_reduce_scatter_local)
    inp, out = captured["in"], captured["out"]
    layout = opt.layout
    beta1 = np.float32(opt.betas[0])
    g = inp["g"] if inp["wd"] is None else inp["g"] + inp["wd"]
    m_w = float(beta1) * inp["m"] + float(np.float32(1.0) - beta1) * g
    mean, cmask, ccount, we = onebit_reduce_scatter_local(
        m_w, inp["we"], group, real_size=layout.numel)
    full, se = onebit_all_gather_local(mean, inp["se"], group, cmask,
                                       ccount)
    full = full * (torch.arange(layout.padded) < layout.numel).float()
    rank = opt.rank
    chunk = layout.padded // opt.world_size
    own = slice(rank * chunk, (rank + 1) * chunk)
    server_in = (mean + inp["se"]).abs()
    # every chunk's server scale: |m| of its lanes
    scales = full.abs().reshape(opt.world_size, chunk).amax(dim=1)
    my_scale = float(scales[rank])
    near = server_in <= EXCHANGE_SIGN_RTOL * max(my_scale, 1e-30)
    card_m, card_we, card_se = out["m"], out["we"], out["se"]
    worker_scale = float((inp["we"] + m_w).abs().max())
    we_err = float((card_we - we).abs().max())
    se_err = (card_se - se).abs()
    m_diff = (card_m - full).abs().reshape(opt.world_size, chunk)
    flips = (card_m >= 0) != (full >= 0)
    card_scales = card_m.abs().reshape(opt.world_size, chunk).amax(dim=1)
    res = {"lanes": layout.numel, "padded": layout.padded,
           "server_scales_card": card_scales.tolist(),
           "server_scales_cpu": scales.tolist(),
           "scale_max_rel_err": float(((card_scales - scales).abs() /
                                       scales.clamp(min=1e-30)).max()),
           "worker_error_max_abs_err": we_err,
           "worker_error_tol": EXCHANGE_SCALE_RTOL * worker_scale,
           "sign_flips": int(flips.sum()),
           "sign_flips_in_my_chunk_away_from_0": int(
               (flips[own] & ~near).sum()),
           "lanes_near_0_in_my_chunk": int(near.sum()),
           "server_error_max_abs_err_away_from_0": float(
               se_err[~near].max()) if bool((~near).any()) else 0.0,
           "momentum_max_abs_err_unflipped": float(
               m_diff.reshape(-1)[~flips].max())}
    res["ok"] = (res["scale_max_rel_err"] <= EXCHANGE_SCALE_RTOL and
                 we_err <= res["worker_error_tol"] and
                 res["sign_flips_in_my_chunk_away_from_0"] == 0 and
                 res["server_error_max_abs_err_away_from_0"] <=
                 EXCHANGE_SCALE_RTOL * my_scale and
                 res["momentum_max_abs_err_unflipped"] <=
                 EXCHANGE_SCALE_RTOL * float(scales.max()))
    return res


def _comm_engine(conf, layers, data, seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cfg = gpt2.config_for("gpt2_medium", max_seq_len=TRAIN_SEQ,
                          loss_chunk=128, remat=TRAIN_REMAT, n_layers=layers)
    model = seeded_gpt2(cfg, seed)
    return deepspeed_tpu_torch.initialize(
        model=model, mesh=build_mesh(data=data), config_params=conf)[0]


def _comm_batch(engine, data, seed=0):
    micro = engine.train_micro_batch_size_per_gpu()
    ids = np.random.RandomState(seed).randint(
        0, 50304, size=(1, micro * data, TRAIN_SEQ)).astype(np.int64)
    return dp_rows((ids, ids.copy()), engine.dp_rank, micro)


def _timed_steps(engine, batch, steps):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch=batch) for _ in range(steps)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], (time.perf_counter() - t0) * 1e3 / \
        steps


def _codec_ms(numel):
    """The codec on the card over ``numel`` fp32 lanes (one buffer of the
    gpt2_medium exchange's size): quantize, dequantize (256-lane blocks),
    sign pack and unpack; CUDA events, median of 10, L2 flushed; beside
    each, the bound of its bytes (each input read once, each output
    written once) at the card's memory rate."""
    import torch
    from deepspeed_tpu_torch.runtime.comm.quantize import (
        dequantize_blockwise, pack_signs, quantize_blockwise, unpack_signs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(numel, generator=gen, device="cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    q, s = quantize_blockwise(x)
    packed = pack_signs(x)
    scale = torch.tensor(0.5, device="cuda")
    nb = numel // 256
    cases = {
        "quantize": (lambda: quantize_blockwise(x), numel * 4 + numel +
                     nb * 4),
        "dequantize": (lambda: dequantize_blockwise(q, s, numel),
                       numel + nb * 4 + numel * 4),
        "pack_signs": (lambda: pack_signs(x), numel * 4 + numel // 8),
        "unpack_signs": (lambda: unpack_signs(packed, scale),
                         numel // 8 + numel * 4)}
    out = {}
    for name, (fn, nbytes) in cases.items():
        ms = time_ms(fn, flush, reps=10)
        out[name] = {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bytes": nbytes}
    del x, q, s, packed, flush
    torch.cuda.empty_cache()
    return out


def comm_rank(rank, world, spec):
    """The compressed-communication runs of one rank, each on this data
    coordinate's rows of one global batch at gpt2_medium width and
    ``spec["layers"]`` deep: per run of ``spec["runs"]`` (name, kind,
    warmup, steps) the losses, the step ms, the launches a step, the bytes
    handed to torch.distributed a step; a profile step; for OneBitAdam the
    captured exchange recomputed on the CPU, the error state after a
    frozen step and after a forced overflow; with ``spec["codec"]``, rank
    0 times the codec at the exchange's full size."""
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.runtime.comm import WIRE
    data = spec["data"]
    counters = _dp_counters()[:4]
    out = {"rank": rank, "transport": dist.get_backend(), "runs": {}}
    # the CPU recompute of the exchange crosses a gloo group
    cpu_group = dist.new_group(list(range(world)), backend="gloo")
    for name, kind, warmup, steps in spec["runs"]:
        micro = DP_MICRO
        conf = {"onebit": lambda: _onebit_conf(micro, spec.get("freeze")),
                "plain_adam": lambda: _plain_adam_conf(micro),
                "baseline": lambda: _qc_conf(micro),
                "qc": lambda: _qc_conf(micro, 0),
                "qc_hier": lambda: _qc_conf(micro, 2)}[kind]()
        t0 = time.perf_counter()
        engine = _comm_engine(conf, spec["layers"], data)
        init_s = time.perf_counter() - t0
        assert engine.device.type == "cuda"
        assert engine.flash_attention_backend == "pallas"
        batch = _comm_batch(engine, data)
        run = {"init_s": init_s, "mode": engine._local_grad_mode()}
        captured = {}
        for c in counters:
            c.launches = 0
        if kind == "onebit":
            run["numel"] = engine.optimizer.layout.numel
            losses, _ = _timed_steps(engine, batch, warmup)
            warm_master = engine.flat.master.detach().clone()
            # the second frozen step's exchange (non-zero errors), then the
            # bytes of the third
            losses += _timed_steps(engine, batch, 1)[0]
            _capture_exchange(engine.optimizer, captured)
            more, step_ms = _timed_steps(engine, batch, 1)
            WIRE.reset()
            last, step_ms2 = _timed_steps(engine, batch, 1)
            run["wire_bytes_per_step"] = WIRE.bytes
            run["wire_calls_per_step"] = WIRE.calls
            losses += more + last
            # the captured step also copies its inputs to the host
            run["frozen_step_ms"] = step_ms2
            run["captured_frozen_step_ms"] = step_ms
            run["warm_master"] = warm_master
            opt = engine.optimizer
            run["errors_after_frozen"] = [float(opt.worker_error.abs().sum()),
                                          float(opt.server_error.abs().sum())]
            run["launches_per_step"] = {c.__name__: c.launches /
                                        (warmup + steps) for c in counters}
            run["exchange_vs_cpu"] = _exchange_on_cpu(opt, captured,
                                                      cpu_group)
            # a forced overflow: the step is skipped and the errors zeroed
            master = engine.flat.master.detach().clone()
            skipped = engine.skipped_steps
            xs = tuple(torch.as_tensor(x[0]) for x in batch)
            loss = engine(*xs)
            engine.backward(loss)
            engine.flat.acc.fill_(float("inf"))
            engine.step()
            run["overflow"] = {
                "skipped": engine.skipped_steps - skipped,
                "master_unchanged": bool(torch.equal(master,
                                                     engine.flat.master)),
                "errors": [float(opt.worker_error.abs().sum()),
                           float(opt.server_error.abs().sum())]}
            run["frozen_at_end"] = engine._onebit_frozen()
            del master
        else:
            losses = _timed_steps(engine, batch, warmup)[0] if warmup \
                else []
            if kind == "plain_adam":
                run["warm_master"] = engine.flat.master.detach().clone()
            WIRE.reset()
            for c in counters:
                c.launches = 0
            more, step_ms = _timed_steps(engine, batch, steps)
            losses += more
            run["step_ms"] = step_ms
            run["wire_bytes_per_step"] = WIRE.bytes / steps
            run["launches_per_step"] = {c.__name__: c.launches / steps
                                        for c in counters}
            if kind.startswith("qc"):
                run["numel"] = engine._qc_layout.numel
        run["losses"] = losses
        if spec.get("profile") and kind != "plain_adam":
            prof = train_profile(engine, batch, steps=1,
                                 span_names=COMM_SPANS,
                                 kernel_groups=NCCL_GROUPS)
            run["host_ms_per_step_in_spans"] = prof.get(
                "host_ms_per_step_in_spans")
            run["collective_kernel_ms_per_step"] = prof.get(
                "kernel_ms_per_step_by_group")
            run["device_busy_share"] = prof["device_busy_share"]
            run["profile_wall_s_per_step"] = prof["wall_s_per_step"]
        run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["runs"][name] = run
        del engine
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # OneBitAdam's warmup against stage 0 Adam in plain math
    runs = out["runs"]
    if "onebit" in runs and "plain_adam" in runs:
        a = runs["onebit"].pop("warm_master")
        b = runs["plain_adam"].pop("warm_master")
        out["warm_master_max_abs_diff"] = float((a - b).abs().max())
    for run in runs.values():
        run.pop("warm_master", None)
    dist.barrier()
    if spec.get("codec") and rank == 0:
        out["codec"] = _codec_ms(spec["codec"])
    dist.barrier()
    return out


def _comm_checks(ranks, layers, data, frozen_steps):
    """Shared assertions and summaries of a comm_rank result set."""
    from deepspeed_tpu_torch.runtime.comm.wire import (
        onebit_exchange_bytes, quantized_allreduce_bytes)
    r0 = ranks[0]["runs"]
    summary = {}
    for name, run in r0.items():
        losses = run["losses"]
        assert all(np.isfinite(losses)), (name, losses)
        for r in ranks[1:]:
            assert r["runs"][name]["losses"] == losses, name
        lp = run["launches_per_step"]
        for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            assert lp[k] == layers, (name, lp)
        row = {"losses": losses, "mode": run["mode"],
               "launches_per_step": lp, "init_s": run["init_s"],
               "peak_memory_gb": max(r["runs"][name]["peak_memory_gb"]
                                     for r in ranks)}
        for key in ("step_ms", "frozen_step_ms", "captured_frozen_step_ms",
                    "host_ms_per_step_in_spans",
                    "collective_kernel_ms_per_step", "device_busy_share",
                    "profile_wall_s_per_step"):
            if key in run:
                row[key] = run[key]
        for key in ("step_ms", "frozen_step_ms"):
            if key in run:
                row[key] = max(r["runs"][name][key] for r in ranks)
        if name.startswith("qc"):
            levels = (2, data // 2) if name == "qc_hier" else None
            formula = quantized_allreduce_bytes(run["numel"], data,
                                                levels=levels)
            row["wire_bytes_per_step"] = {"count": run["wire_bytes_per_step"],
                                          "formula": formula}
            assert all(r["runs"][name]["wire_bytes_per_step"] == formula
                       for r in ranks), (name, formula)
            assert lp["fused_adam"] == 1, lp
        if name == "onebit":
            formula = onebit_exchange_bytes(run["numel"], data)
            row["wire_bytes_per_step"] = {"count": run["wire_bytes_per_step"],
                                          "formula": formula,
                                          "calls": run["wire_calls_per_step"]}
            assert all(r["runs"][name]["wire_bytes_per_step"] == formula
                       for r in ranks), (name, formula)
            assert lp["fused_adam"] == 0, lp
            for r in ranks:
                rr = r["runs"][name]
                assert rr["exchange_vs_cpu"]["ok"], rr["exchange_vs_cpu"]
                assert min(rr["errors_after_frozen"]) > 0, rr
                assert rr["overflow"]["skipped"] == 1, rr["overflow"]
                assert rr["overflow"]["master_unchanged"], rr["overflow"]
                assert rr["overflow"]["errors"] == [0.0, 0.0], rr["overflow"]
            row["exchange_vs_cpu_by_rank"] = [r["runs"][name][
                "exchange_vs_cpu"] for r in ranks]
            row["errors_after_frozen_by_rank"] = [
                r["runs"][name]["errors_after_frozen"] for r in ranks]
            row["overflow_by_rank"] = [r["runs"][name]["overflow"]
                                       for r in ranks]
        summary[name] = row
    return summary


def phase_train_comm(world=DP, layers=ONE_CARD_LAYERS, freeze=2,
                     frozen=ONEBIT_FROZEN, qc_steps=QC_STEPS):
    """``train_onebit`` and ``train_qc``: two spawned ranks sharing this
    card over gloo (every collective through host memory: the times only
    show that the paths run), gpt2_medium width, ``layers`` deep, micro 8
    a rank, seq 1024, one global batch; one spawn for both. Returns their
    two lines."""
    from deepspeed_tpu_torch.utils.distributed import spawn
    t0 = time.perf_counter()
    spec = {"layers": layers, "data": world, "freeze": freeze,
            "profile": False, "codec": GPT2_MEDIUM_NUMEL,
            "runs": [("onebit", "onebit", freeze, frozen),
                     ("plain_adam", "plain_adam", freeze, 1),
                     ("qc", "qc", 0, qc_steps),
                     ("baseline", "baseline", 0, qc_steps)]}
    ranks = spawn(comm_rank, world, args=(spec,), timeout_s=600)
    wall = time.perf_counter() - t0
    summary = _comm_checks(ranks, layers, world, frozen)
    ob, plain = summary["onebit"], ranks[0]["runs"]["plain_adam"]
    # the warmup steps: the losses before the frozen regime, and the
    # masters after the warmup, against stage 0 Adam in plain math
    warm = [_rel([a], [b]) for a, b in zip(ob["losses"][:freeze + 1],
                                           plain["losses"][:freeze + 1])]
    moved = ranks[0]["warm_master_max_abs_diff"]
    assert max(warm) <= WARMUP_LOSS_RTOL, (warm, ob["losses"],
                                           plain["losses"])
    # the loss falls over the warmup; in the frozen regime at freeze_step
    # 2 the variance of two steps is tiny on many lanes, the update lr * m
    # / sqrt(v) large there, and the loss rises in the JAX package too
    # (PERF.md): that regime is held to the JAX package's exchange and to
    # finite losses
    assert ob["losses"][freeze] < ob["losses"][0], ob["losses"]
    onebit = {"phase": "train_onebit", "model": "gpt2_medium",
              "layers": layers, "seq": TRAIN_SEQ,
              "micro_batch_per_rank": DP_MICRO, "data": world,
              "transport": ranks[0]["transport"], "zero_stage": 0,
              "optimizer": dict(ONEBIT_PARAMS, freeze_step=freeze),
              "warmup_steps": freeze, "frozen_steps": frozen,
              "warmup_loss_rel_diff_vs_plain_adam": warm,
              "warmup_loss_tol": WARMUP_LOSS_RTOL,
              "warm_master_max_abs_diff_vs_plain_adam": moved,
              "seconds_both_phases": wall, **ob,
              "step_ms_note": "ranks share one card over gloo: the times "
                              "only show that the path runs"}
    qc, base = summary["qc"], summary["baseline"]
    rel = _rel(qc["losses"], base["losses"])
    assert rel <= QC_LOSS_RTOL, (qc["losses"], base["losses"])
    codec = ranks[0]["codec"]
    train_qc = {"phase": "train_qc", "config": EXAMPLE_CONFIG,
                "comm": {"quantized_collectives": {"enabled": True}},
                "model": "gpt2_medium", "layers": layers, "seq": TRAIN_SEQ,
                "micro_batch_per_rank": DP_MICRO, "data": world,
                "zero_stage": 2, "transport": ranks[0]["transport"],
                "loss_max_rel_diff_vs_fp32_exchange": rel,
                "loss_tol": QC_LOSS_RTOL, "fp32_exchange": base, **qc,
                "codec_ms_at_numel": {"numel": GPT2_MEDIUM_NUMEL, **codec},
                "step_ms_note": "ranks share one card over gloo: the times "
                                "only show that the path runs"}
    return onebit, train_qc


def main_comm_nccl():
    """``--comm-nccl``: DP 4 over NCCL, one rank a card (needs 4 cards),
    gpt2_medium at full depth, micro 8 a rank: the example's config with
    the fp32 exchange (the reference run), with ``quantized_collectives``
    flat and with ``hierarchical: 2``, and OneBitAdam (``train_onebit``'s
    block at stage 0, ``freeze_step`` 3, 3 frozen steps); each the step
    ms, the NCCL kernels' ms a step, the bytes a step by formula and by
    count, and its losses against the reference run's."""
    import torch
    from deepspeed_tpu_torch.utils.distributed import spawn
    count = torch.cuda.device_count()
    assert count >= 4, "--comm-nccl needs 4 cards, found {}".format(count)
    spec = {"layers": 24, "data": 4, "freeze": 3, "profile": True,
            "runs": [("baseline", "baseline", 2, QC_STEPS),
                     ("qc", "qc", 2, QC_STEPS),
                     ("qc_hier", "qc_hier", 2, QC_STEPS),
                     ("onebit", "onebit", 3, ONEBIT_FROZEN)]}
    t0 = time.perf_counter()
    ranks = spawn(comm_rank, 4, args=(spec,), timeout_s=1500)
    summary = _comm_checks(ranks, 24, 4, ONEBIT_FROZEN)
    assert ranks[0]["transport"] == "nccl", ranks[0]["transport"]
    base = summary["baseline"]["losses"]
    for name, row in summary.items():
        row["loss_rel_diff_vs_reference"] = [
            _rel([a], [b]) for a, b in zip(row["losses"], base)]
    emit({"phase": "comm_nccl", "model": "gpt2_medium", "layers": 24,
          "seq": TRAIN_SEQ, "micro_batch_per_rank": DP_MICRO, "data": 4,
          "transport": "nccl", "config": EXAMPLE_CONFIG,
          "onebit_optimizer": dict(ONEBIT_PARAMS, freeze_step=3),
          "seconds": time.perf_counter() - t0, "runs": summary})




KERNELS = [
    # name, source, the TPU kernel it replaces, the path that launches it
    ("paged_attention",
     "deepspeed_tpu_torch/ops/paged_attention/csrc/paged_attention.cu",
     "deepspeed_tpu/ops/pallas/paged_attention.py:141", "serve"),
    ("flash_fwd",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:518 (_fwd_packed), "
     ":442 (_fwd)", "train"),
    ("flash_bwd_dkdv",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:756 "
     "(_bwd_fused_packed), :897 (_bwd_split_packed, dk/dv call :962), "
     ":471 (_bwd)", "train"),
    ("flash_bwd_dq",
     "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu",
     "deepspeed_tpu/ops/transformer/flash_attention.py:756 "
     "(_bwd_fused_packed), :897 (_bwd_split_packed, dq call :937), "
     ":471 (_bwd)", "train"),
    ("fused_adam", "deepspeed_tpu_torch/ops/adam/csrc/fused_adam.cu",
     "deepspeed_tpu/ops/adam/pallas_adam.py:45", "train"),
    ("block_sparse_fwd", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:730 "
     "(_fwd_pk), :906 (_fwd)", "train_sparse"),
    ("block_sparse_bwd_dq", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:770 "
     "(_bwd_pk, dq call :792), :943 (_bwd, dq call :959)", "train_sparse"),
    ("block_sparse_bwd_dkdv", SPARSE_SOURCE,
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:770 "
     "(_bwd_pk, dk/dv call :823), :943 (_bwd, dk/dv call :988)",
     "train_sparse"),
    ("fused_lamb", LAMB_SOURCE,
     "deepspeed_tpu/ops/lamb/pallas_lamb.py:65 (_lamb_stage1_flat, "
     "pallas_call :74) with stage 2's norms and trust ratio (:120-125)",
     "train_bert"),
    ("fused_lamb_apply", LAMB_SOURCE,
     "deepspeed_tpu/ops/lamb/pallas_lamb.py:127 (stage 2's apply, XLA ops "
     "after the :74 pallas_call)", "train_bert"),
    ("ring_ag_gemm", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:170 (ag_matmul_pallas, "
     "pallas_call :188, body _ag_kernel :145)", "train_tp"),
    ("ring_rs_gemm_add", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:239 (matmul_rs_pallas, "
     "pallas_call :258, body _rs_kernel :208)", "train_tp"),
    ("ring_gc_gemm_acc", RING_SOURCE,
     "deepspeed_tpu/ops/pallas/ring_gemm.py:303 (gather_contract_pallas, "
     "pallas_call :321, body _gc_kernel :279)", "train_tp"),
]


OPTIMIZER_NAMES = ("fused_adam",) + LAMB_NAMES


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    from deepspeed_tpu_torch.ops import cuda_build, dataio
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam import cpu_adam
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.lamb import fused_lamb, fused_lamb_apply
    from deepspeed_tpu_torch.ops.paged_attention import paged_attention
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    import tempfile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # each kernel's wrapper holds its launch count
    wrappers = {"paged_attention": paged_attention,
                "flash_fwd": fa.flash_fwd, "flash_bwd_dkdv": fa.flash_bwd_dkdv,
                "flash_bwd_dq": fa.flash_bwd_dq, "fused_adam": fused_adam,
                "fused_lamb": fused_lamb, "fused_lamb_apply": fused_lamb_apply}
    wrappers.update((name, getattr(bsa, name)) for name in SPARSE_NAMES)
    wrappers.update((name, getattr(rg, name)) for name in RING_NAMES)
    sources = sorted({src for _, src, _, _ in KERNELS})
    t0 = time.perf_counter()
    # every nvcc and the host op's g++ started together
    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        hosts = [pool.submit(dataio.build), pool.submit(cpu_adam.build)]
        records = list(pool.map(cuda_build.build, sources))
        hosts = [h.result() for h in hosts]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [{"source": src, "seconds": r.seconds,
                       "ptxas": [line.strip() for line in r.log.splitlines()
                                 if "registers" in line or "spill" in line]}
                      for src, r in zip(sources, records)],
          "host_sources": [{"source": src,
                            "flags": list(dataio.host_build.flags(
                                dataio.host_build.compiler())),
                            "seconds": h.seconds}
                           for src, h in zip(("csrc/ds_dataio.cpp",
                                              "csrc/cpu_adam.cpp"), hosts)]})
    modes = {"--tp-nccl": main_tp_nccl, "--dp-nccl": main_dp_nccl,
             "--pp-nccl": main_pp_nccl, "--comm-nccl": main_comm_nccl}
    if any(flag in sys.argv[1:] for flag in modes):
        for flag, run in modes.items():
            if flag in sys.argv[1:]:
                run()
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel = phase_kernel(flush)
    emit(kernel)
    flash = phase_flash(flush)
    emit(flash)
    torch.cuda.empty_cache()
    flash_bert = phase_flash_bert(flush)
    emit(flash_bert)
    torch.cuda.empty_cache()
    emit(phase_flash3d(flush))
    torch.cuda.empty_cache()
    emit(phase_flash_fp32_repeats())
    emit(phase_flash_fp16())
    torch.cuda.empty_cache()
    adam = phase_adam(flush)
    emit(adam)
    torch.cuda.empty_cache()
    emit(phase_cpu_adam())
    lamb = phase_lamb(flush)
    emit(lamb)
    torch.cuda.empty_cache()
    sparse = phase_sparse(flush)
    emit(sparse)
    torch.cuda.empty_cache()
    ring = phase_ring_gemm(flush)
    emit(ring)
    del flush
    torch.cuda.empty_cache()

    train_counters = [wrappers[name] for name, _, _, path in KERNELS
                      if path == "train"]
    train = phase_train(train_counters)
    emit(train)
    torch.cuda.empty_cache()
    emit(phase_train_parity())
    torch.cuda.empty_cache()
    # the example twin's path (fp32 moments, the example's config), on
    # synthetic tokens and then on a written corpus
    emit(phase_train_example(train_counters))
    torch.cuda.empty_cache()
    emit(phase_train_example_data(train_counters))
    torch.cuda.empty_cache()

    # the BERT path: every dense-training kernel's count, so Adam is seen
    # not to launch there
    bert_counters = [wrappers[name] for name, _, _, path in KERNELS
                     if path in ("train", "train_bert")]
    train_bert = phase_train_bert(bert_counters)
    emit(train_bert)
    torch.cuda.empty_cache()
    emit(phase_train_bert_parity(
        [wrappers[name] for name in ("flash_fwd", "flash_bwd_dkdv",
                                     "flash_bwd_dq") + LAMB_NAMES]))
    torch.cuda.empty_cache()

    # the long-context path: every training kernel's count, so the flash
    # kernels are seen not to launch there
    train_sparse = phase_train_sparse(
        [wrappers[name] for name, _, _, path in KERNELS
         if path in ("train", "train_sparse")])
    emit(train_sparse)
    torch.cuda.empty_cache()
    emit(phase_train_sparse_parity())
    torch.cuda.empty_cache()

    serve = phase_serve([wrappers["paged_attention"]])
    emit(serve)
    torch.cuda.empty_cache()
    emit(phase_parity())
    torch.cuda.empty_cache()
    # the paged kernel at the verify width (s = k + 1) and over a TP
    # rank's heads
    serve_spec = phase_serve_spec([wrappers["paged_attention"]])
    emit(serve_spec)
    torch.cuda.empty_cache()
    emit(phase_serve_spec_parity([wrappers["paged_attention"]]))
    torch.cuda.empty_cache()
    serve_tp = phase_serve_tp()
    emit(serve_tp)

    # the tensor-parallel path: two ranks on this card (gloo), each with
    # its own counts, reset just before its timed steps
    train_tp = phase_train_tp(layers=ONE_CARD_LAYERS)
    emit(train_tp)
    lamb_spec = tp_lamb_spec()
    tp_parity = phase_train_tp_parity(lamb=lamb_spec)
    lamb_ranks = tp_parity.pop("lamb_ranks")
    emit(tp_parity)
    emit(phase_train_tp_lamb(lamb_spec, ranks=lamb_ranks))

    # the data-parallel path: two ranks on this card (gloo), each with its
    # own counts, reset just before its timed steps
    emit(phase_train_dp(layers=ONE_CARD_LAYERS))
    # train_dp_parity's ranks also save train_dp_ckpt's DP 2 tag; DP 1
    # resumes it here
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_ckpt_") as tmp:
        dp_ckpt = dp_ckpt_spec(tmp)
        dp3 = dp3_spec()
        zeropp = zeropp_spec()
        parity = phase_train_dp_parity(ckpt=dp_ckpt, dp3=dp3, zeropp=zeropp)
        dp_ckpt_ranks = parity.pop("dp_ckpt_ranks")
        dp3_ranks = parity.pop("dp3_ranks")
        zeropp_ranks = parity.pop("zeropp_ranks")
        emit(parity)
        emit(phase_train_dp_ckpt(train_counters, spec=dp_ckpt,
                                 ranks=dp_ckpt_ranks))
    # DP 2 x TP 2 (with its stage-3 and sparse legs); the same four ranks
    # then run train_pipe3 (PP 2 x DP 2 at stage 3, the offload tag)
    pipe3 = pipe3_spec()
    zeropp_dp4 = zeropp_spec(ZEROPP_DP4_LEGS)
    try:
        dp_tp = phase_train_dp_tp_parity(pipe3=pipe3, zeropp=zeropp_dp4)
    finally:
        _pipe_chip().remove(pipe3["dir"])
    pipe3_ranks = dp_tp.pop("pipe3_ranks")
    zeropp_dp4_ranks = dp_tp.pop("zeropp_ranks")
    emit(dp_tp)
    train_pipe3 = phase_train_pipe3(pipe3, pipe3_ranks)
    emit(train_pipe3)
    # ZeRO++ and the ring gather: train_dp_parity's two ranks and
    # train_dp_tp_parity's four ran the legs
    train_zeropp = phase_train_zeropp(zeropp, zeropp_ranks, zeropp_dp4,
                                      zeropp_dp4_ranks)
    emit(train_zeropp)

    # checkpoints on the train path: save and resume; then bench.py's
    # remat rung under both policies
    emit(phase_train_ckpt(train_counters, layers=ONE_CARD_LAYERS))
    torch.cuda.empty_cache()
    emit(phase_train_remat(train_counters))
    torch.cuda.empty_cache()

    # ZeRO-3 and ZeRO-Offload: BASELINE config 4 at full depth, then the
    # offload step against the device state, stage 3 over two ranks, and
    # the offload checkpoints
    xl_offload = phase_train_xl_offload(train_counters)
    emit(xl_offload)
    torch.cuda.empty_cache()
    # the same configuration with streamed parameter offload, its peak
    # held under train_xl_offload's; then the streamed step's checks
    train_xl_stream = phase_train_xl_stream(train_counters,
                                            offload=xl_offload)
    emit(train_xl_stream)
    torch.cuda.empty_cache()
    emit(phase_train_stream_parity())
    torch.cuda.empty_cache()
    emit(phase_train_offload_parity())
    torch.cuda.empty_cache()
    emit(phase_train_dp3(spec=dp3, ranks=dp3_ranks))
    emit(phase_train_offload_ckpt())
    torch.cuda.empty_cache()

    # BASELINE config 5: GPT-2 as a pipeline, two stages on this card;
    # train_pipe's ranks then make train_pipe_parity's runs
    pipe_parity = pipe_parity_spec()
    try:
        train_pipe = phase_train_pipe(parity=pipe_parity,
                                      layers=PIPE_ONE_CARD_LAYERS)
    finally:
        _pipe_chip().remove(pipe_parity["dir"])
    pipe_parity_ranks = train_pipe.pop("parity_ranks")
    emit(train_pipe)
    emit(phase_train_pipe_parity(pipe_parity, pipe_parity_ranks))

    # compressed communication: OneBitAdam and the int8 gradient exchange,
    # two ranks on this card, one spawn
    train_onebit, train_qc = phase_train_comm(layers=COMM_ONE_CARD_LAYERS)
    emit(train_onebit)
    emit(train_qc)

    measured = {"paged_attention": dict(
        kernel, max_abs_err=kernel["max_abs_err"])}
    # rows at the GPT-2 train shape; the error over both modes (causal,
    # and BERT's non-causal with the key bias)
    grads = {"flash_fwd": ("out",), "flash_bwd_dq": ("dq",),
             "flash_bwd_dkdv": ("dk", "dv")}
    for name, row in flash["kernels"].items():
        err = max(mode["errors"][g + "_abs"] for mode in (flash, flash_bert)
                  for g in grads[name])
        measured[name] = dict(row, max_abs_err=err)
    # the optimizer rows at the variant the main paths run: bf16 moments
    measured["fused_adam"] = adam["variants"]["bf16"]
    measured.update(lamb["variants"]["bf16"]["kernels"])
    # rows at the main path's (shared) layout; the error over both layouts
    grads = {"block_sparse_fwd": ("out",), "block_sparse_bwd_dq": ("dq",),
             "block_sparse_bwd_dkdv": ("dk", "dv")}
    for name in SPARSE_NAMES:
        err = max(lay["errors"][g + "_abs"] for lay in
                  sparse["layouts"].values() for g in grads[name])
        measured[name] = dict(sparse["layouts"]["shared"]["kernels"][name],
                              max_abs_err=err)
    launches = dict(serve["launches"], **train["launches"])
    launches.update((name, train_sparse["launches"][name])
                    for name in SPARSE_NAMES)
    launches.update((name, train_bert["launches"][name])
                    for name in LAMB_NAMES)
    # the ring kernels' rows: sums over one ring step of each of one
    # layer's four sites; launches over both ranks
    measured.update(ring["kernels"])
    launches.update((name, train_tp["launches"][name])
                    for name in RING_NAMES)
    # the paged kernel's launches on the other serving paths
    # the pipeline path's launches a step, per rank (rows 2-4 and 14)
    extra = {name: {"launches_by_path": {
        "train": launches[name], "train_pipe_per_rank_per_step":
            train_pipe["launches_per_rank_per_step"][name],
        "train_onebit_per_rank_per_step":
            train_onebit["launches_per_step"][name],
        "train_qc_per_rank_per_step": train_qc["launches_per_step"][name],
        "train_xl_stream_per_step":
            train_xl_stream["launches_per_step"][name],
        "train_pipe3_stage3_per_rank_per_step": [
            r["s3"][name] // train_pipe3["steps"]
            for r in train_pipe3["launches_per_rank"]],
        "train_dp_tp_parity_stage3_rank0":
            dp_tp["launches_rank0"]["bf16_s3"][name],
        "train_zeropp_rank0_per_leg": {
            leg: counts[name] for leg, counts in
            train_zeropp["launches_rank0"].items()}}}
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                     "fused_adam")}
    for name in RING_NAMES:
        extra[name] = {"launches_by_path": {
            "train_tp": launches[name],
            "train_dp_tp_parity_stage2_rank0":
                dp_tp["launches_rank0"]["bf16"][name],
            "train_dp_tp_parity_stage3_rank0":
                dp_tp["launches_rank0"]["bf16_s3"][name]}}
    extra["paged_attention"] = {"launches_by_path": {
        "serve": serve["launches"]["paged_attention"],
        "serve_spec_ngram": serve_spec["ngram"]["paged_attention_launches"],
        "serve_spec_model":
        serve_spec["model_drafter"]["paged_attention_launches"],
        "serve_tp_per_rank": [r["launches"] for r in serve_tp["ranks"]]}}
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["kernel_ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        "library_ms": measured[name]["library_ms"],
        **({"moments": "bf16"} if name in OPTIMIZER_NAMES else {}),
        **extra.get(name, {})}
        for name, source, replaces, _ in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
