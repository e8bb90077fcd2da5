"""Rank bodies for the port's compressed-communication tests (the int8
in-collective exchange, the 1-bit exchange, OneBitAdam and the
``quantized_collectives`` engine path), run by
``deepspeed_tpu_torch.utils.distributed.spawn`` in gloo processes on the
CPU. This module imports nothing of JAX: the test files hold the JAX side
and compare in the parent process. Inputs arrive as numpy arrays, results
leave as numpy arrays and plain values."""
import os
import time

import numpy as np
import torch
from torch import nn

from torch_tp_workers import single_threaded


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def exchange_case(rank, world, case):
    """One exchange body on this rank's row of ``case``'s inputs: its
    outputs and the bytes it handed to ``torch.distributed``."""
    from deepspeed_tpu_torch.parallel.topology import (
        DATA_AXIS, DATA_REPLICA_AXIS, DATA_SHARD_AXIS, build_mesh,
        factor_data_axis)
    from deepspeed_tpu_torch.runtime.comm import (
        WIRE, CompressedBackend, QuantizedCollectives,
        compressed_allreduce_local, onebit_reduce_scatter_local,
        quantized_all_gather_local, quantized_all_reduce_local,
        ring_reduce_scatter_inline)
    mesh = build_mesh(data=world)
    group = mesh.get_group(DATA_AXIS)
    kind = case["kind"]
    x = _t(case["x"][rank])
    block = case.get("block", 256)
    WIRE.reset()
    if kind == "ring_rs":
        out = {"out": ring_reduce_scatter_inline(x, group, block)}
    elif kind == "all_gather":
        out = {"out": quantized_all_gather_local(x, group, block)}
    elif kind == "all_reduce":
        out = {"out": quantized_all_reduce_local(x, group, block)}
    elif kind == "hierarchical":
        fmesh = factor_data_axis(mesh, case["shard"])
        qc = QuantizedCollectives(fmesh, block_size=block)
        WIRE.reset()
        out = {"out": qc.all_reduce(x), "hierarchical": qc.hierarchical,
               "shard_rank": torch.distributed.get_rank(
                   fmesh.get_group(DATA_SHARD_AXIS)),
               "replica_rank": torch.distributed.get_rank(
                   fmesh.get_group(DATA_REPLICA_AXIS))}
    elif kind == "onebit":
        we, se = _t(case["we"][rank]), _t(case["se"][rank])
        res, nwe, nse = compressed_allreduce_local(
            x, we, se, group, real_size=case["real_size"])
        mean, cmask, ccount, _ = onebit_reduce_scatter_local(
            x, we, group, real_size=case["real_size"])
        out = {"out": res, "we": nwe, "se": nse, "chunk_mean": mean,
               "chunk_mask": cmask, "chunk_count": float(ccount)}
        WIRE.reset()
        compressed_allreduce_local(x, we, se, group,
                                   real_size=case["real_size"])
    elif kind == "backend":
        res, nwe, nse = CompressedBackend(mesh).compressed_allreduce(x)
        out = {"out": res, "we": nwe, "se": nse}
    else:
        raise ValueError(kind)
    out["wire_bytes"] = WIRE.bytes
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def exchanges(rank, world, cases):
    single_threaded()
    return [exchange_case(rank, world, case) for case in cases]


# --------------------------------------------------------------- engines


class Quadratic(nn.Module):
    """``tests/unit/test_onebit_adam.py``'s model: ``mean((x @ w - y)
    ** 2)`` with ``w`` (16, out_dim) zeros, in fp32 as the JAX model
    computes (the weights cast to the input's dtype)."""

    def __init__(self, out_dim=4):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(16, out_dim))

    def forward(self, x, y):
        return ((x.float() @ self.w.float() - y.float()) ** 2).mean()


def params_to_jax(state_dict, keep_dtype=False):
    from deepspeed_tpu_torch.models import _tree
    return _tree.params_to_jax(state_dict, keep_dtype)


def params_from_jax(tree):
    from deepspeed_tpu_torch.models import _tree
    return _tree.params_from_jax(tree)


def optimizer_state_to_jax(state):
    from deepspeed_tpu_torch.models import _tree
    return _tree.optimizer_state_to_jax(state, params_to_jax)


def optimizer_state_from_jax(state):
    from deepspeed_tpu_torch.models import _tree
    return _tree.optimizer_state_from_jax(state, params_from_jax)


def _model(spec):
    if spec.get("quadratic"):
        return Quadratic(spec.get("out_dim", 4))
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.make_gpt2_model(config=gpt2.GPT2Config(**spec["model"]),
                                seed=spec.get("seed", 0))


def _rows(batch, coord, micro):
    return tuple(np.ascontiguousarray(x[:, coord * micro:(coord + 1) * micro])
                 for x in batch)


def _state_np(engine):
    """Master tree (dotted names) and the optimizer state, numpy."""
    master = engine.get_master_params()
    opt = engine.get_optimizer_state()
    return master, opt


def _flat_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat_tree(tree[k], prefix + str(k) + "."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_tree(v, prefix + str(i) + "."))
    else:
        out[prefix[:-1]] = np.asarray(tree, np.float32)
    return out


def _module_state(engine):
    return {k: v.float().numpy().copy()
            for k, v in engine.flat.tree_of(engine.flat.params).items()}


def engine_run(rank, world, spec):
    """One engine per spec over ``build_mesh(data=spec["data"],
    model=spec.get("tp", 1))``, the seeded model (``expect_error``: only
    the message ``initialize`` raises), and a list of ``actions``:
    ``("train", n)`` steps on this rank's rows of ``spec["batch"]`` (or
    the step's batch of ``spec["series"]``), ``("zero_errors",)`` the
    error rows before each later step (the control: the engine's state,
    no config key), ``("overflow",)`` one step whose accumulated grads
    are inf, ``("save", dir, tag)``, ``("load", dir, tag)``, ``("wait_for",
    dir, tag, seconds)`` until another spawn's tag is whole,
    ``("load_jax", master, opt, global_steps)``, ``("record", name)`` the
    master tree,
    optimizer state, module state, counters and errors' sums."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    data = spec["data"]
    tp = spec.get("tp", 1)
    mesh = build_mesh(data=data, model=tp) if world > 1 else None
    model = _model(spec)
    kwargs = {"mesh": mesh} if mesh is not None else {}
    if spec.get("expect_error"):
        try:
            deepspeed_tpu_torch.initialize(
                model=model, config_params=spec["config"], device="cpu",
                **kwargs)
        except (ValueError, NotImplementedError) as err:
            return {"error": "{}: {}".format(type(err).__name__, err)}
        return {"error": None}
    engine = deepspeed_tpu_torch.initialize(
        model=model, config_params=spec["config"], device="cpu",
        **kwargs)[0]
    micro = engine.train_micro_batch_size_per_gpu()
    out = {"losses": [], "records": {}, "dp_rank": engine.dp_rank,
           "mode": engine._local_grad_mode()}
    zero_errors = False
    step_i = 0

    def batch_of(i):
        if spec.get("series") is not None:
            xs = tuple(s[i:i + 1] for s in spec["series"])
        else:
            xs = spec["batch"]
        return _rows(xs, engine.dp_rank, micro) if data > 1 else xs

    for action in spec["actions"]:
        op = action[0]
        if op == "train":
            for _ in range(action[1]):
                if zero_errors and engine._onebit_mode:
                    engine.optimizer.reset_error_state()
                out["losses"].append(float(engine.train_batch(
                    batch=batch_of(step_i))))
                step_i += 1
        elif op == "zero_errors":
            zero_errors = True
        elif op == "overflow":
            xs = batch_of(step_i)
            loss = engine(*(x[0] for x in xs))
            engine.backward(loss)
            engine.flat.acc.fill_(float("inf"))
            engine.step()
            step_i += 1
            out["overflow_skipped"] = engine.skipped_steps
        elif op == "save":
            engine.save_checkpoint(action[1], tag=action[2])
        elif op == "load":
            path, _ = engine.load_checkpoint(action[1], tag=action[2])
            assert path is not None
        elif op == "wait_for":
            # a tag another spawn writes: its manifest lands last
            deadline = time.monotonic() + action[3]
            manifest = os.path.join(action[1], action[2], "manifest.json")
            while not os.path.exists(manifest):
                assert time.monotonic() < deadline, manifest
                time.sleep(0.2)
        elif op == "load_jax":
            engine.load_state_from_jax(master=action[1],
                                       optimizer_state=action[2])
            # the regime follows the attempted steps, which the state
            # does not carry
            engine.global_steps = action[3]
        elif op == "record":
            master, opt = _state_np(engine)
            rec = {"master": _flat_tree(master),
                   "opt": opt, "global_steps": engine.global_steps,
                   "frozen": engine._onebit_frozen(),
                   "module": _module_state(engine)}
            if engine._onebit_mode:
                rec["pristine"] = engine._onebit_pristine
            out["records"][action[1]] = rec
        else:
            raise ValueError(op)
    return out


def engines(rank, world, specs):
    single_threaded()
    return [engine_run(rank, world, spec) for spec in specs]
