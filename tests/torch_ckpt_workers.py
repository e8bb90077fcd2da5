"""Rank bodies for the port's checkpoint tests, run in gloo processes by
``deepspeed_tpu_torch.utils.distributed.spawn`` (or in the test process at
one rank). This module imports nothing of JAX: the workers are the port
alone; the test file holds the JAX side and compares in the parent
process. Inputs arrive as numpy arrays and plain values; results leave as
numpy arrays and plain values."""
import torch

from torch_dp_workers import _rows, train_config
from torch_tp_workers import single_threaded


def state_bits(engine):
    """The engine's full master tree and moments, gathered (every rank
    must call): ``{"master": {name: fp32}, "exp_avg": {name: bits},
    "exp_avg_sq": ..., "step"}``; bf16 moments as their int16 patterns,
    fp32 ones as they are."""
    def host(t):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    flat = engine.flat
    return {"master": {k: host(v) for k, v in
                       engine._full_tree(flat.master).items()},
            "exp_avg": {k: host(v) for k, v in engine._full_tree(
                flat.exp_avg, keep_dtype=True).items()},
            "exp_avg_sq": {k: host(v) for k, v in engine._full_tree(
                flat.exp_avg_sq, keep_dtype=True).items()},
            "step": flat.step}


def ckpt_engine(rank, world, specs):
    """Per spec: a mesh of ``spec["data"]`` x ``spec.get("tp", 1)``, the
    seeded GPT-2 (``spec["seed"]``), the engine, then ``spec["actions"]``
    in order: ``("train", n)`` n steps on this data coordinate's rows of
    ``spec["batch"]`` (the losses kept), ``("save", dir, tag)``,
    ``("load", dir, tag)`` (the returned path kept), ``("record",)`` the
    gathered state (:func:`state_bits`). Returns per spec ``{"losses",
    "paths", "records", "dp_rank"}``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    results = []
    for spec in specs:
        mesh = build_mesh(data=spec["data"], model=spec.get("tp", 1))
        model = gpt2.make_gpt2_model(config=gpt2.GPT2Config(**spec["model"]),
                                     seed=spec["seed"])
        engine = deepspeed_tpu_torch.initialize(
            model=model, mesh=mesh, config_params=train_config(spec),
            device="cpu")[0]
        batch = _rows(spec["batch"], engine.dp_rank, spec["micro"])
        res = {"losses": [], "paths": [], "records": [],
               "dp_rank": engine.dp_rank}
        for action, *args in spec["actions"]:
            if action == "train":
                res["losses"] += [float(engine.train_batch(batch=batch))
                                  for _ in range(args[0])]
            elif action == "save":
                engine.save_checkpoint(args[0], tag=args[1])
            elif action == "load":
                path, _ = engine.load_checkpoint(args[0], tag=args[1])
                res["paths"].append(path)
            elif action == "record":
                res["records"].append(state_bits(engine))
            else:
                raise ValueError(action)
        results.append(res)
    return results


def mlp(w1, w2, x):
    """``tests/unit/test_activation_checkpointing.py``'s ``_mlp``."""
    h = torch.tanh(x @ w1)
    return torch.sum(torch.tanh(h @ w2) ** 2)


def partitioned_rank(rank, world, arrays):
    """Each rank of a model group of ``world``: :func:`mlp` through
    ``checkpoint`` with partitioned activations; the saved inputs' shapes
    and whether the gradients equal the plain function's."""
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as act
    single_threaded()
    act.configure(build_mesh(model=world), partition_activations=True)
    w1, w2, x = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out = act.checkpoint(mlp, w1, w2, x)
    saved = [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    got = torch.autograd.grad(out, (w1, w2, x))
    want = torch.autograd.grad(mlp(w1, w2, x), (w1, w2, x))
    return {"saved": saved,
            "equal": [bool(torch.equal(a, b)) for a, b in zip(got, want)]}
