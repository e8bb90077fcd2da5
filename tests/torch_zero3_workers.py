"""Rank bodies for the port's ZeRO-3 and ZeRO-Offload data-parallel
tests, run by ``deepspeed_tpu_torch.utils.distributed.spawn`` in gloo
processes on the CPU. This module imports nothing of JAX: the test files
hold the JAX side and compare in the parent process. Inputs arrive as
numpy arrays (the global batch; each rank takes its data coordinate's
rows) and results leave as numpy arrays and plain values."""
import numpy as np
import torch
from torch import nn

from torch_tp_workers import single_threaded


class Linear(nn.Module):
    """``tests/unit/test_zero_offload.py``'s model: ``mean((x @ w - y) **
    2)`` over the named parameters (``w`` (32, 8) zeros by default; more
    through ``shapes``), with the JAX-tree converters the engine's
    ``get_master_params`` reads from this module (the tree is the
    ``state_dict``)."""

    def __init__(self, shapes=(("w", (32, 8)),), fill=0.0):
        super().__init__()
        for name, shape in shapes:
            self.register_parameter(name, nn.Parameter(
                torch.full(shape, float(fill))))

    def forward(self, x, y):
        return ((x.float() @ self.w.float() - y.float()) ** 2).mean()


def params_to_jax(state, keep_dtype=False):
    return {k: (v if keep_dtype else v.float().numpy()) for k, v in
            state.items()}


def params_from_jax(tree):
    return {k: v.float() if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


def optimizer_state_to_jax(state):
    return {"step": state["step"],
            "exp_avg": params_to_jax(state["exp_avg"]),
            "exp_avg_sq": params_to_jax(state["exp_avg_sq"])}


def optimizer_state_from_jax(state):
    return {"step": int(np.asarray(state["step"])),
            "exp_avg": params_from_jax(state["exp_avg"]),
            "exp_avg_sq": params_from_jax(state["exp_avg_sq"])}


def zero_config(spec):
    conf = {"train_micro_batch_size_per_gpu": spec["micro"],
            "gradient_accumulation_steps": spec.get("gas", 1),
            "optimizer": {"type": spec.get("optimizer", "Adam"),
                          "params": {"lr": spec.get("lr", 1e-3)}},
            "bf16": {"enabled": True},
            "zero_optimization": dict(spec["zero"]),
            "steps_per_print": 10 ** 9}
    if spec.get("backend"):
        conf["transformer"] = {"flash_attention": spec["backend"]}
    if spec.get("tp", 1) > 1 or spec.get("cm") is not None:
        conf["comm"] = {"collective_matmul": dict(
            {"enabled": True, "backend": "pallas"}, **(spec.get("cm") or {}))}
    return conf


def _rows(batch, coord, micro):
    return tuple(np.ascontiguousarray(x[:, coord * micro:(coord + 1) * micro])
                 for x in batch)


def _counters():
    """The kernel wrappers these paths launch (each holds its count)."""
    from deepspeed_tpu_torch.ops import ring_gemm as rg
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam,
            rg.ring_ag_gemm, rg.ring_rs_gemm_add, rg.ring_gc_gemm_acc]


def zero_engine(rank, world, specs):
    """Per spec: ``build_mesh(data=spec["data"], model=spec["tp"])`` (a
    model axis runs through ``comm.collective_matmul``; ``spec["sparse"]``
    turns on the sparse embedding-gradient exchange over the mesh; with
    ``spec["expect_error"]`` only the engine's ValueError is returned),
    the seeded GPT-2 of
    ``spec["model"]`` (built inside ``zero.Init`` with ``spec["init"]``),
    the engine on ``spec["zero"]``, ``spec["steps"]`` steps on this data
    coordinate's rows of ``spec["batch"]``; then, where asked, a save to
    / load from ``spec["save"]`` / ``spec["load"]`` and ``spec["after"]``
    more steps. Returns the losses, the gathered master tree and moments,
    the rank's parameter and state bytes, the partition's persistence
    lists and its unit layout, and the gathers."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    results = []
    for spec in specs:
        tp = spec.get("tp", 1)
        mesh = build_mesh(data=spec["data"], model=tp if tp > 1 else None)
        cfg = gpt2.GPT2Config(**spec["model"])
        if spec.get("sparse"):
            cfg.sparse_embedding_grads = True
            cfg.embedding_grad_mesh = mesh
        if spec.get("init") is not None:
            with zero.Init(mesh=mesh, device="cpu", **spec["init"]):
                model = gpt2.make_gpt2_model(config=cfg, seed=spec["seed"])
            init_bytes = sum(p.numel() * p.element_size()
                             for p in model.parameters())
        else:
            model = gpt2.make_gpt2_model(config=cfg, seed=spec["seed"])
            init_bytes = None
        device = spec.get("device", "cpu")
        if spec.get("expect_error"):
            try:
                deepspeed_tpu_torch.initialize(
                    model=model, mesh=mesh, config_params=zero_config(spec),
                    device=device)
                results.append({"error": None})
            except ValueError as err:
                results.append({"error": str(err)})
            continue
        engine = deepspeed_tpu_torch.initialize(
            model=model, mesh=mesh, config_params=zero_config(spec),
            device=device)[0]
        coord = engine.dp_rank
        batch = _rows(spec["batch"], coord, spec["micro"])
        res = {"init_bytes": init_bytes}
        if spec.get("load"):
            if spec.get("wait_for"):
                _wait_for(spec["wait_for"])
            engine.load_checkpoint(spec["load"], tag=spec.get("load_tag"))
            res["loaded_qg_error"] = _qg_tree(engine)
        counters = _counters()
        for c in counters:
            c.launches = 0
        from deepspeed_tpu_torch.runtime.comm import quantize, wire
        quantize.WIRE.reset()
        losses = [float(engine.train_batch(batch=batch))
                  for _ in range(spec["steps"])]
        res["wire"] = dict(quantize.WIRE.by_kind)
        res["launches"] = {c.__name__: c.launches for c in counters}
        res["census"] = wire.estimate_engine_comm_bytes(engine)
        if spec.get("overflow"):
            res["overflow"] = _overflow_step(engine, batch)
        if spec.get("save"):
            engine.save_checkpoint(spec["save"], tag=spec.get("save_tag",
                                                              "t"))
            losses += [float(engine.train_batch(batch=batch))
                       for _ in range(spec.get("after", 0))]
        flat = engine.flat
        opt = engine.get_optimizer_state()
        res.update(
            losses=losses, master=engine.get_master_params(),
            exp_avg=opt["exp_avg"], step=opt["step"],
            param_bytes=flat.param_bytes(), state_bytes=flat.state_bytes(),
            numel=flat.numel, part_numel=flat.part_numel,
            persistent=list(flat.persistent), demoted=list(flat.demoted),
            units=[(u[0], u[2]) for u in flat.units],
            views=flat.check_views(),
            gathers=engine.zero3.gathers if engine.zero3 else 0,
            own_replicated=list(flat.own_replicated),
            csr=sorted(engine.csr_tensor_module_names),
            offload_chunks=engine.offload_work_chunks,
            master_device=str(flat.master.device),
            exp_avg_sq=opt["exp_avg_sq"], qg_error=_qg_tree(engine),
            modes=(engine.zero_quantized_weights(),
                   engine.zero_hierarchical_partition(),
                   engine.zero_quantized_gradients(), engine._cm_zero3),
            shard_world=flat.shard_world,
            prefetched=engine.zero3.prefetched if engine.zero3 else 0)
        results.append(res)
    return results


def _wait_for(path, timeout_s=120.0):
    import os
    import time
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)


def _qg_tree(engine):
    """The qgZ error feedback as the JAX-shaped tree (every rank calls),
    or None."""
    flat = engine.flat
    if flat.qg_error is None:
        return None
    return engine._jax_tree(flat.qg_error)


def _overflow_step(engine, batch):
    """One micro-step per accumulation step with the accumulator poisoned
    (an inf) before the apply: the step is skipped and qgZ's residual
    reset. Returns its norm before and after, and the skip count."""
    before = float(engine.flat.qg_error.norm())
    for m in range(engine.gradient_accumulation_steps()):
        loss = engine(*(x[m] for x in batch))
        engine.backward(loss)
        if engine.is_gradient_accumulation_boundary():
            engine.flat.acc[0] = float("inf")
        engine.step()
    return dict(before=before, after=float(engine.flat.qg_error.norm()),
                skipped=engine.skipped_steps)


def gather_cases(rank, world, cases):
    """Unit gathers of ``Linear`` models at stage 3 over ``world`` ranks:
    per case ``(leaves [(name, numpy fp32 array)], quantized, ring, hpz)``
    the leaves of one unit (bf16, every leaf data-sharded) gathered by the
    partition's ``gatherer``; returns each leaf's gathered values as fp32
    numpy arrays."""
    from deepspeed_tpu_torch.parallel.topology import (
        DATA_AXIS, DATA_REPLICA_AXIS, DATA_SHARD_AXIS, build_mesh,
        factor_data_axis)
    from deepspeed_tpu_torch.runtime.zero.partition import FlatPartition
    single_threaded()
    out = []
    for leaves, quantized, ring, hpz in cases:
        mesh = build_mesh(data=world)
        shard = replica = None
        if hpz:
            mesh = factor_data_axis(mesh, hpz)
            shard = mesh.get_group(DATA_SHARD_AXIS)
            replica = mesh.get_group(DATA_REPLICA_AXIS)
        model = Linear(shapes=[(n, a.shape) for n, a in leaves])
        with torch.no_grad():
            for n, a in leaves:
                getattr(model, n).copy_(torch.from_numpy(a))
        flat = FlatPartition(
            model, torch.device("cpu"), torch.bfloat16,
            group=mesh.get_group(DATA_AXIS), stage=3,
            units=[("u", [n for n, _ in leaves])], persistence_threshold=0,
            train_state=False, shard_group=shard, replica_group=replica)
        assert flat.persist_unit is None
        flat.configure_gather(quantized=quantized, ring=ring)
        flat.gather_unit(0)
        out.append({n: getattr(model, n).detach().float().numpy().copy()
                    for n, _ in leaves})
        flat.release_unit(0)
    return out


def reduce_scatter_cases(rank, world, rows, errors):
    """``quantized_reduce_scatter_local`` over the data group: this rank's
    row of ``rows`` (numpy fp32), without and with its row of ``errors``;
    returns the summed chunks and the new error."""
    from deepspeed_tpu_torch.parallel.topology import DATA_AXIS, build_mesh
    from deepspeed_tpu_torch.runtime.comm.quantize import \
        quantized_reduce_scatter_local
    single_threaded()
    group = build_mesh(data=world).get_group(DATA_AXIS)
    x = torch.from_numpy(rows[rank])
    plain, _ = quantized_reduce_scatter_local(x, group)
    fed, err = quantized_reduce_scatter_local(
        x, group, error=torch.from_numpy(errors[rank]))
    return plain.numpy(), fed.numpy(), err.numpy()


def context_cases(rank, world):
    """``tests/unit/test_zero_context.py``'s cases that need a data group
    of ``world`` ranks, on ``Linear`` models; returns plain values."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    mesh = build_mesh(data=world)
    out = {}
    # partitioned at construction: w (128, 16) in pieces, b (4,) whole
    with zero.Init(mesh=mesh, device="cpu", param_persistence_threshold=64):
        model = Linear(shapes=(("w", (128, 16)), ("b", (4,))))
    store = model._zero3_store
    out["sharded"] = dict(
        ds_sharded=bool(getattr(model, "ds_sharded", False)),
        w_numel=model.w.numel(), w_shape=list(model.w.ds_shape),
        b_numel=model.b.numel(), local=store.local.numel(),
        persistent=list(store.flat.persistent))
    # read and modify through GatheredParameters
    with zero.Init(mesh=mesh, device="cpu", param_persistence_threshold=0):
        model = Linear(shapes=(("w", (64, 8)),), fill=1.0)
    with zero.GatheredParameters(model, modifier_rank=0) as full:
        out["read"] = full["w"].numpy().copy()
        full["w"][:] = 7.0 if rank == 0 else 5.0
    with zero.GatheredParameters(model) as full:
        out["after_modify"] = full["w"].numpy().copy()
        full["w"][:] = 3.0
    with zero.GatheredParameters(model) as full:
        out["after_discard"] = full["w"].numpy().copy()
    out["modified_numel"] = model.w.numel()
    # on the host: the same layout
    with zero.Init(mesh=mesh, remote_device="cpu",
                   param_persistence_threshold=0):
        model = Linear(shapes=(("w", (64, 8)),), fill=1.0)
    out["remote"] = dict(device=str(model._zero3_store.local.device),
                         local=model._zero3_store.local.numel(),
                         w_numel=model.w.numel())
    # a zero.Init model trains through the engine at stage 3
    with zero.Init(mesh=mesh, device="cpu", param_persistence_threshold=0):
        model = Linear()
    engine = deepspeed_tpu_torch.initialize(
        model=model, mesh=mesh, device="cpu", config_params={
            "train_batch_size": 16,
            "optimizer": {"type": "Adam", "params": {"lr": 5e-2}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3,
                                  "stage3_param_persistence_threshold": 0}
        })[0]
    rs = np.random.RandomState(0)
    w_true = rs.randn(32, 8).astype(np.float32)
    x = rs.randn(16, 32).astype(np.float32)
    y = x @ w_true
    rows = slice(engine.dp_rank * 8, engine.dp_rank * 8 + 8)
    losses = []
    for _ in range(60):
        loss = engine(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    out["train"] = dict(losses=losses, gathers=engine.zero3.gathers,
                        param_bytes=engine.flat.param_bytes())
    return out
