"""Rank bodies for the port's tensor-parallel tests, run by
``deepspeed_tpu_torch.utils.distributed.spawn`` in gloo processes on the
CPU. This module imports nothing of JAX: the workers are the port alone;
the test files hold the JAX side and compare in the parent process.
Inputs arrive as numpy arrays and results leave as numpy arrays."""
import logging
import time

import torch
import torch.distributed as dist


def single_threaded():
    """One intra-op thread in this rank: the ranks of several test files
    share the host's cores with each other (pytest-xdist workers x ranks x
    8 threads), and the tests' bit-for-bit comparisons should not depend on
    how an op splits its work across threads."""
    torch.set_num_threads(1)


def shard_operands(kind, x, w, rank, world):
    """This rank's shards of a global (x, w): column sites take rows of x
    and columns of w, row sites columns of x and rows of w."""
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    if kind == "column":
        return (x.chunk(world, dim=-2)[rank].contiguous(),
                w.chunk(world, dim=1)[rank].contiguous())
    return (x.chunk(world, dim=-1)[rank].contiguous(),
            w.chunk(world, dim=0)[rank].contiguous())


def ring_ops(rank, world, cases):
    """Every case through tp_column_matmul / tp_row_matmul on both
    backends: the local output and, where asked, the gradients of
    ``sum(y ** 2)``; then a rank-4 input on the kernel backend."""
    from deepspeed_tpu_torch.parallel import collective_matmul as cm
    single_threaded()
    out = {}
    for backend in ("pallas", "ppermute"):
        for name, (kind, x, w, policy, grad) in cases.items():
            bind = cm.CollectiveMatmulBinding(group=dist.group.WORLD,
                                              backend=backend, dtype=policy)
            xs, ws = shard_operands(kind, x, w, rank, world)
            xs.requires_grad_(grad)
            ws.requires_grad_(grad)
            op = cm.tp_column_matmul if kind == "column" else \
                cm.tp_row_matmul
            y = op(xs, ws, bind)
            res = {"y": y.detach().numpy()}
            if grad:
                (y ** 2).sum().backward()
                res.update(dx=xs.grad.numpy(), dw=ws.grad.numpy())
            out[(backend, name)] = res

    # a rank-4 x on the kernel backend: no warning, and every ring step
    # goes through the kernel wrapper (its plain version on CPU tensors)
    from deepspeed_tpu_torch.ops.ring_gemm import ring_gemm as rgm
    seen, steps = [], []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("DeepSpeedTPUTorch")
    logger.addHandler(handler)
    wrapper = rgm.ring_ag_gemm

    def counted(*args, **kwargs):
        steps.append(1)
        return wrapper(*args, **kwargs)

    rgm.ring_ag_gemm = counted
    try:
        kind, x, w, _, _ = cases["column_fwd"]
        xs, ws = shard_operands(kind, x, w, rank, world)
        bind = cm.CollectiveMatmulBinding(group=dist.group.WORLD,
                                          backend="pallas")
        ys = [cm.tp_column_matmul(xs[None], ws, bind)[0] for _ in range(2)]
    finally:
        rgm.ring_ag_gemm = wrapper
        logger.removeHandler(handler)
    out["rank4"] = {"y": ys[1].detach().numpy(), "kernel_steps": len(steps),
                    "warnings": len(seen)}
    return out


def _train_config(spec):
    conf = {"train_micro_batch_size_per_gpu": spec["micro"],
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": spec.get("optimizer", "Adam"),
                          "params": {"lr": 1e-3}},
            "steps_per_print": 10 ** 9}
    if spec["backend"] is not None:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": spec["backend"]}}
    if spec["prec"] == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": 2}
    return conf


def scale_fc_left_half(model, factor):
    """Scale the left half of the columns of every ``fc_kernel`` (rank
    0's shard at TP 2) by ``factor``, in place: shards of unequal norms."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("fc_kernel"):
                t[:, :t.shape[1] // 2] *= factor


def tp_engine(rank, world, specs):
    """Per spec: train a TP engine over the whole group from the seeded
    full init (its fc kernels' left halves scaled by ``scale_fc`` where
    given); return the losses, the gathered master tree, and, after
    loading the given JAX state, the gathered master again and the next
    loss."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    results = []
    for spec in specs:
        cfg = gpt2.GPT2Config(**spec["model"])
        model = gpt2.make_gpt2_model(config=cfg, seed=spec["seed"])
        if spec.get("scale_fc"):
            scale_fc_left_half(model, spec["scale_fc"])
        engine = deepspeed_tpu_torch.initialize(
            model=model,
            mesh=build_mesh(model=world), config_params=_train_config(spec),
            device="cpu")[0]
        assert engine.mp_world_size == world and engine._cm_tp
        assert engine.comm_transport == "gloo"
        ids = spec["ids"]
        losses = [float(engine.train_batch(batch=(ids, ids)))
                  for _ in range(spec["steps"])]
        res = {"losses": losses, "master": engine.get_master_params(),
               "opt_step": int(engine.get_optimizer_state()["step"]),
               "views": engine.flat.check_views()}
        if spec.get("load") is not None:
            master, opt = spec["load"]
            engine.load_state_from_jax(master=master, optimizer_state=opt)
            res["reloaded"] = engine.get_master_params()
            res["reloaded_opt"] = engine.get_optimizer_state()
            res["next_loss"] = float(engine.train_batch(batch=(ids, ids)))
        results.append(res)
    return results


def hang(rank, world):
    """Rank 0 waits on a receive that rank 1, asleep, never sends."""
    if rank == 0:
        dist.recv(torch.zeros(1), src=1)
    else:
        time.sleep(600)
    return rank


def fail(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return rank


def rotate(rank, world, chunks):
    """One ring hop at each ``chunks``, exact and through a bf16 wire."""
    from deepspeed_tpu_torch.parallel.ring import ring_context, ring_rotate
    n, idx, perm = ring_context(dist.group.WORLD)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * idx + \
        0.001
    return {c: (ring_rotate(x, dist.group.WORLD, perm, c).numpy(),
                ring_rotate(x, dist.group.WORLD, perm, c,
                            wire_dtype=torch.bfloat16).numpy())
            for c in chunks}
