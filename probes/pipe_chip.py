"""Rank bodies of ``chip_smoke.py``'s pipeline phases (``train_pipe``,
``train_pipe_parity``, ``--pp-nccl``), spawned by
``deepspeed_tpu_torch.utils.distributed.spawn``: on one card every rank
shares it over gloo (the hops and the tied reduction through host
memory), on four cards each rank has its own over NCCL. Inputs arrive as
plain values and numpy arrays, results leave the same way.

Each rank builds GPT-2 as a pipeline (``models.gpt2_pipe.
make_gpt2_pipeline``, its stage only, the dense model's seeded weights)
and trains it through ``deepspeed_tpu_torch.initialize(...).train_batch``
on the GPT-2 example's ``examples/gpt2/ds_config_zero2.json`` (bf16,
Adam betas (0.9, 0.95), weight decay 0.1, clipping 1.0), micro 4 a rank.
"""
import functools
import hashlib
import json
import os
import tempfile
import time

import numpy as np

EXAMPLE_CONFIG = "examples/gpt2/ds_config_zero2.json"
SEQ, MICRO = 1024, 4
PIPE_SPANS = ("pipe.p2p", "pipe.tied_reduce", "pipe.fwd", "pipe.bwd")


_INIT_PARAMS = []


@functools.lru_cache(maxsize=2)
def _dense_tree(vocab, seq, layers, d_model, seed):
    from deepspeed_tpu_torch.models import gpt2
    return _INIT_PARAMS[0](gpt2.GPT2Config(
        vocab_size=vocab, max_seq_len=seq, n_layers=layers,
        d_model=d_model), seed=seed)


def cache_dense_init():
    """``gpt2.init_params`` through a cache of the last two shapes: the
    phases build the same seeded weights again and again (the draws take
    seconds at gpt2_medium size and depend only on the vocabulary,
    sequence, depth and width)."""
    from deepspeed_tpu_torch.models import gpt2
    if not _INIT_PARAMS:
        _INIT_PARAMS.append(gpt2.init_params)
        gpt2.init_params = lambda config, seed=0: _dense_tree(
            config.vocab_size, config.max_seq_len, config.n_layers,
            config.d_model, seed)


def counters():
    """The kernel wrappers the pipeline's path launches (each holds its
    launch count)."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam,
            rg.ring_ag_gemm, rg.ring_rs_gemm_add, rg.ring_gc_gemm_acc]


def example_conf(spec):
    with open(EXAMPLE_CONFIG) as f:
        conf = json.load(f)
    conf.update(steps_per_print=10 ** 9,
                train_micro_batch_size_per_gpu=spec.get("micro", MICRO),
                gradient_accumulation_steps=spec["M"],
                transformer={"flash_attention": "auto"})
    conf["zero_optimization"] = dict({"stage": spec.get("stage", 2)},
                                     **spec.get("zero", {}))
    if spec.get("tp", 1) > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "pallas"}}
    if spec.get("constant_lr"):
        # the parity runs: a constant learning rate, so three steps move
        # the weights measurably (the example warms up over 2000 steps)
        conf.pop("scheduler")
        conf["optimizer"]["params"]["lr"] = spec["constant_lr"]
    return conf


def gpt2_config(layers):
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.config_for("gpt2_medium", max_seq_len=SEQ, loss_chunk=128,
                           n_layers=layers)


def build_engine(spec):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2_pipe
    cache_dense_init()
    net = gpt2_pipe.make_gpt2_pipeline(
        config=gpt2_config(spec["layers"]), num_stages=spec["S"],
        num_dp=spec.get("dp", 1), num_mp=spec.get("tp", 1),
        activation_checkpoint_interval=spec.get("aci", 0),
        num_virtual_stages=spec.get("v", 1),
        save_stage_residuals=spec.get("save", False), seed=spec.get("seed"))
    engine = deepspeed_tpu_torch.initialize(model=net,
                                            config_params=example_conf(spec))[0]
    assert engine.device.type == "cuda", engine.device
    assert engine.flash_attention_backend == "pallas"
    # the CUDA Adam, or under cpu_offload the host Adam
    assert engine.fused_optimizer_kernel == (
        "host" if engine.offload is not None else "pallas")
    return engine


def global_batch(spec, seed=0):
    """``(ids, ids)`` of the global batch ``(M, micro * dp, SEQ)``."""
    rows = spec.get("micro", MICRO) * spec.get("dp", 1)
    ids = np.random.RandomState(seed).randint(
        0, 50304, size=(spec["M"], rows, SEQ)).astype(np.int64)
    return ids, ids


def rank_rows(batch, engine, micro=MICRO):
    d = engine.dp_rank
    return tuple(np.ascontiguousarray(x[:, d * micro:(d + 1) * micro])
                 for x in batch)


def tied_digest(engine):
    """sha256 of this stage's tied master leaves (every rank of the data
    and model groups must call)."""
    state = engine._full_tree(engine.flat.master)
    h = hashlib.sha256()
    for key in sorted(k for k in state if k.startswith("tied.")):
        h.update(state[key].numpy().tobytes())
    return h.hexdigest() if any(k.startswith("tied.") for k in state) \
        else None


def expected_launches(engine, M):
    """Launches a step of this rank's flash and Adam kernels: the flash
    forward once a layer and micro-batch in the forward phase (not on the
    last virtual stage, whose backward recomputes it anyway) and once in
    the backward's recompute (once in all with ``save_stage_residuals``;
    at ZeRO stage 3 twice on every stage: the forward phase, then each
    unit call's recompute); each backward kernel once; Adam once (never
    under ``cpu_offload``). The ring kernels (under TP) are only required
    to launch."""
    module = engine.module
    S, r, v = module.num_stages, module.stage_id, module.num_virtual
    fwd = 0
    for c in range(v):
        n = len(module.body[c])
        last = r == S - 1 and c == v - 1
        once = (last or module.save_residuals) and engine.zero3 is None
        fwd += n * (1 if once else 2)
    layers = sum(len(chunk) for chunk in module.body)
    return {"flash_fwd": fwd * M, "flash_bwd_dkdv": layers * M,
            "flash_bwd_dq": layers * M,
            "fused_adam": 0 if engine.offload is not None else 1}


def train_rank(rank, world, spec):
    """The pipeline main path on this rank: warm-up, then timed steps with
    every count set to 0 just before and read just after; the peak
    memory; the hop and tied-reduction host time a step; a profile step
    (device busy share, the NCCL or gloo kernels' time); the tied copies'
    digest."""
    import torch
    import chip_smoke
    t0 = time.perf_counter()
    engine = build_engine(spec)
    init_s = time.perf_counter() - t0
    batch = rank_rows(global_batch(spec), engine)
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(spec["warmup"])]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cs = counters()
    for c in cs:
        c.launches = 0
    p2p_s = tied_s = 0.0
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        losses.append(engine.train_batch(batch=batch))
        p2p_s += engine.pipe_stats.get("p2p_s", 0.0)
        tied_s += engine.pipe_stats.get("tied_reduce_s", 0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in cs}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    out = {"rank": rank, "stage": engine.stage_id, "dp_rank": engine.dp_rank,
           "losses": losses, "init_s": init_s, "warmup_s": warm_s,
           "spawn_to_init_s": time.time() - spec["t_spawn"] - init_s -
           warm_s - wall,
           "step_ms": wall * 1e3 / spec["steps"],
           "p2p_host_ms_per_step": p2p_s * 1e3 / spec["steps"],
           "tied_reduce_ms_per_step": tied_s * 1e3 / spec["steps"],
           "launches": launches,
           "expected": expected_launches(engine, spec["M"]),
           "peak_memory_gb": peak_gb, "parts": list(engine.module.parts),
           "transport": torch.distributed.get_backend(),
           "device": str(engine.device), "views": engine.flat.check_views(),
           "stats": dict(engine.pipe_stats)}
    if spec.get("profile"):
        groups = ("flash_", "SendRecv", "AllReduce", "ReduceScatter",
                  "AllGather", "ring_", "Memcpy")
        t0 = time.perf_counter()
        out["train_profile"] = chip_smoke.train_profile(
            engine, batch, steps=1, span_names=PIPE_SPANS,
            kernel_groups=groups)
        out["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tied_digest"] = tied_digest(engine)
    out["digest_s"] = time.perf_counter() - t0
    if spec.get("parity"):
        del engine
        torch.cuda.empty_cache()
        out["parity"] = parity_rank(rank, world, spec["parity"])
    return out


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix[:-1]: np.asarray(tree, np.float32)}
    out = {}
    for key, child in items:
        out.update(_leaf_items(child, "{}{}.".format(prefix, key)))
    return out


def dense_names(module, tree):
    """A pipeline master tree -> ``{dense model's dotted name: array}``
    (the real body layers at their global index)."""
    from deepspeed_tpu_torch.runtime.pipe.module import global_to_slot
    flat = _leaf_items(tree)
    layout = module.layout()
    out = {"wte": flat["tied.embed.wte"], "wpe": flat["tied.embed.wpe"],
           "ln_f.scale": flat["post.0.scale"], "ln_f.bias": flat["post.0.bias"]}
    for key, leaf in flat.items():
        if key.startswith("body."):
            inner = key[len("body."):]
            for g in range(module.parts[-1]):
                out["blocks.{}.{}".format(g, inner)] = \
                    leaf[global_to_slot(layout, g)]
    return out


def parity_rank(rank, world, spec):
    """Every run of ``spec["runs"]`` (name, run spec, actions) on this
    rank: "train" n steps (losses), "save" / "load" a tag in
    ``spec["dir"]``, "master" (rank 0 keeps the whole master as the dense
    model's names), "peak" (one step's peak memory after a reset);
    TF32 off. A run with ``no_tied_sum`` skips the tied-gradient sum: the
    control run."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cs = counters()
    for name, run, actions in spec["runs"]:
        t0 = time.perf_counter()
        engine = build_engine(run)
        if run.get("no_tied_sum"):
            engine._reduce_tied_grads = lambda: None
        batch = rank_rows(global_batch(run, seed=spec["seed"]), engine)
        res = {"losses": [], "stage": engine.stage_id}
        for c in cs:
            c.launches = 0
        for action in actions:
            if action == "master":
                tree = engine.get_master_params()
                if rank == 0:
                    res.setdefault("masters", []).append(
                        dense_names(engine.module, tree))
            elif action == "save":
                engine.save_checkpoint(spec["dir"], tag="pipe")
            elif action == "load":
                path, _ = engine.load_checkpoint(spec["dir"], tag="pipe")
                assert path is not None
            elif action == "peak":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                res["losses"].append(float(engine.train_batch(batch=batch)))
                torch.cuda.synchronize()
                res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            else:
                for _ in range(action):
                    res["losses"].append(float(engine.train_batch(
                        batch=batch)))
        res["launches"] = {c.__name__: c.launches for c in cs}
        res["run_s"] = time.perf_counter() - t0
        out[name] = res
        del engine
        torch.cuda.empty_cache()
    return out


def pipe3_rank(rank, world, spec):
    """train_pipe3's runs on this rank (PP 2 x DP 2): ZeRO stage 2 and
    stage 3 from the dense model's seeded weights, ``spec["steps"]``
    steps each with the counts set to 0 just before and read just after
    (and the launches the stage should make a step); then stage 3 with
    ``cpu_offload``: one step, a tag saved, the rest of the steps; and a
    fresh offload engine that loads the tag and takes the same steps. The
    masters are compared here, on this stage's leaves (gathered over the
    data group): stage 3 against stage 2 from stage 2's start
    (``chip_smoke._master_diff``, bit for bit too), the resumed run
    against the one that kept going, bit for bit. TF32 off."""
    import torch
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base, steps = spec["base"], spec["steps"]
    offload = {"cpu_offload": True}
    runs = [("s2", dict(base, stage=2), [steps]),
            ("s3", dict(base, stage=3), [steps]),
            ("offload_save", dict(base, stage=3, zero=offload),
             [1, "save", steps - 1]),
            ("offload_resume", dict(base, stage=3, zero=offload),
             ["load", steps - 1])]
    cs = counters()
    out, masters = {}, {}

    def local_master(engine):
        return {k: v.numpy() for k, v in
                engine._full_tree(engine.flat.master).items()}

    for name, run, actions in runs:
        t0 = time.perf_counter()
        engine = build_engine(run)
        batch = rank_rows(global_batch(run, seed=spec["seed"]), engine)
        res = {"losses": [], "stage": engine.stage_id,
               "expected": expected_launches(engine, run["M"]),
               "gathers": engine.zero3.gathers if engine.zero3 else 0}
        if name == "s2":
            masters["init"] = local_master(engine)
        for c in cs:
            c.launches = 0
        for action in actions:
            if action == "save":
                engine.save_checkpoint(spec["dir"], tag="pipe3")
            elif action == "load":
                path, _ = engine.load_checkpoint(spec["dir"], tag="pipe3")
                assert path is not None
            else:
                for _ in range(action):
                    res["losses"].append(float(engine.train_batch(
                        batch=batch)))
        res["launches"] = {c.__name__: c.launches for c in cs}
        res["launch_steps"] = sum(a for a in actions if isinstance(a, int))
        if engine.zero3 is not None:
            res["gathers"] = engine.zero3.gathers - res["gathers"]
        masters[name] = local_master(engine)
        res["run_s"] = time.perf_counter() - t0
        out[name] = res
        del engine
        torch.cuda.empty_cache()
    d_model = gpt2_config(1).d_model
    out["master_s3_vs_s2"] = chip_smoke._master_diff(
        masters["s3"], masters["s2"], d_model, masters["init"])
    out["bit_equal_s3_vs_s2"] = all(
        np.array_equal(v, masters["s2"][k]) for k, v in masters["s3"].items())
    out["resumed_equal"] = all(
        np.array_equal(v, masters["offload_save"][k])
        for k, v in masters["offload_resume"].items())
    return out


def pipe3_repeat_rank(rank, world, spec):
    """The train_pipe3 question on this rank (PP 2 x DP 2, train_pipe3's
    config): stage 2 twice and stage 3 twice from the same seeded
    weights, ``spec["steps"]`` steps each, TF32 off; after every step the
    stage's masters (gathered over the data group) and the step's
    gradient before the update (the accumulator, gathered) are kept, so
    the runs can be compared step by step: whether each stage repeats
    itself, and at which step and in which leaves stage 3 parts from
    stage 2; each step's global gradient norm (the clip's input). With ``spec["deterministic"]`` the runs go under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and the
    names of the operations PyTorch warns about are returned."""
    import warnings
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base, steps = spec["base"], spec["steps"]
    caught = []
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    runs = [("s2a", 2), ("s2b", 2), ("s3a", 3), ("s3b", 3)]
    trace = {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for name, stage in runs:
            engine = build_engine(dict(base, stage=stage))
            batch = rank_rows(global_batch(dict(base, stage=stage),
                                           seed=spec["seed"]), engine)
            steps_out = []
            apply = engine._apply_step
            grads = {}

            def capture(apply=apply, engine=engine, grads=grads):
                grads["acc"] = {k: v.numpy() for k, v in engine._full_tree(
                    engine.flat.acc).items()}
                return apply()

            engine._apply_step = capture
            for _ in range(steps):
                loss = float(engine.train_batch(batch=batch))
                norm = engine._step_metrics.get("grad_norm")
                steps_out.append({"loss": loss, "grad": grads.pop("acc"),
                                  "grad_norm": None if norm is None
                                  else float(norm),
                                  "master": {k: v.numpy() for k, v in
                                             engine._full_tree(
                                                 engine.flat.master).items()}})
            trace[name] = steps_out
            del engine
            torch.cuda.empty_cache()
        caught = sorted({str(w.message).split("\n")[0][:200]
                         for w in seen if "deterministic" in
                         str(w.message).lower()})
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(False)

    def parting(a, b):
        """The first step where runs a and b differ: the loss, the
        leaves whose gradient differs, those whose master does."""
        for i, (x, y) in enumerate(zip(trace[a], trace[b])):
            grad = sorted(k for k, v in x["grad"].items()
                          if not np.array_equal(v, y["grad"][k]))
            master = sorted(k for k, v in x["master"].items()
                            if not np.array_equal(v, y["master"][k]))
            if x["loss"] != y["loss"] or grad or master:
                worst = max((float(np.abs(x["grad"][k] - y["grad"][k])
                                   .max()) for k in grad), default=0.0)
                return {"step": i, "loss_equal": x["loss"] == y["loss"],
                        "grad_leaves": grad[:12], "n_grad_leaves": len(grad),
                        "grad_max_abs": worst, "master_leaves": master[:12],
                        "n_master_leaves": len(master)}
        return None

    return {"rank": rank, "losses": {n: [s["loss"] for s in t]
                                     for n, t in trace.items()},
            "grad_norms": {n: [s["grad_norm"] for s in t]
                           for n, t in trace.items()},
            "s2_repeats": parting("s2a", "s2b"),
            "s3_repeats": parting("s3a", "s3b"),
            "s3_vs_s2": parting("s3a", "s2a"),
            "nondeterministic_ops": caught}


def dense_reference(spec, layers, M, steps, seed):
    """The one-rank engine (the dense GPT2Model of the same seed) on the
    same micro-batches, gradient_accumulation_steps = M: losses and the
    master after ``steps``, TF32 off."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache_dense_init()
    model = gpt2.make_gpt2_model(config=gpt2_config(layers), seed=seed)
    run = dict(spec, M=M)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config_params=example_conf(run))[0]
    batch = global_batch(run, seed=spec["batch_seed"])
    init = _leaf_items(engine.get_master_params())
    losses = [float(engine.train_batch(batch=batch)) for _ in range(steps)]
    master = _leaf_items(engine.get_master_params())
    del engine, model
    torch.cuda.empty_cache()
    return losses, init, master


def dense_dp_rank(rank, world, spec):
    """A rank of the dense data-parallel engine on the same global batch
    as a PP x DP run: the global batch ``(M, rows, SEQ)`` regrouped into
    ``gas`` micro-steps of ``micro`` rows a rank."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    cache_dense_init()
    model = gpt2.make_gpt2_model(config=gpt2_config(spec["layers"]),
                                 seed=spec["seed"])
    run = dict(spec, M=spec["gas"])
    engine = deepspeed_tpu_torch.initialize(
        model=model, mesh=build_mesh(data=world),
        config_params=example_conf(run))[0]
    ids = global_batch(spec)[0].reshape(spec["gas"], -1, SEQ)
    micro = spec["micro"]
    rows = np.ascontiguousarray(ids[:, rank * micro:(rank + 1) * micro])
    losses = [float(engine.train_batch(batch=(rows, rows)))
              for _ in range(spec["warmup"] + spec["steps"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(batch=(rows, rows))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    return {"losses": losses, "step_ms": step_ms}


def temp_dir():
    return tempfile.mkdtemp(prefix="chip_smoke_pipe_")


def remove(path):
    import shutil
    if path and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
