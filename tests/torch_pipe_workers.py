"""Rank bodies for the port's pipeline tests, run by
``deepspeed_tpu_torch.utils.distributed.spawn`` in gloo processes on the
CPU. This module imports nothing of JAX: the test files hold the JAX side
and compare in the parent process. Inputs arrive as numpy arrays (the
global batch; each rank takes its data coordinate's rows; the JAX
module's weights as its numpy tree) and results leave as numpy arrays and
plain values."""
import weakref

import numpy as np
import torch
from torch import nn

from torch_tp_workers import single_threaded

DIM = 16


class TanhLinear(nn.Module):
    """``tests/unit/test_pipe.py::TanhLinear``: tanh(x @ w + b)."""

    def __init__(self, dim=DIM):
        super().__init__()
        self.w = nn.Parameter(torch.randn(dim, dim) * 0.3)
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return torch.tanh(x @ self.w.to(x.dtype) + self.b.to(x.dtype))


def mse_loss(out, labels):
    return ((out.float() - labels.float()) ** 2).mean()


def config(spec):
    conf = {"train_micro_batch_size_per_gpu": spec["micro"],
            "gradient_accumulation_steps": spec["M"],
            "optimizer": {"type": "Adam", "params": dict(
                {"lr": spec.get("lr", 1e-3)}, **spec.get("opt_params", {}))},
            "steps_per_print": 10 ** 9}
    if spec.get("clip"):
        conf["gradient_clipping"] = spec["clip"]
    if spec.get("tp", 1) > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "pallas"}}
    if spec["prec"] in ("bf16", "fp16"):
        conf[spec["prec"]] = dict({"enabled": True}, **spec.get("fp16", {}))
        conf["zero_optimization"] = dict({"stage": spec.get("stage", 0)},
                                         **spec.get("zero", {}))
    conf.update(spec.get("extra", {}))
    return conf


def build(spec):
    """The rank's stage: GPT-2 (``spec["gpt2"]``, flash backend "pallas":
    the kernels' plain versions on the CPU) or ``spec["tanh"]``
    TanhLinear layers; the JAX module's tree loaded when given."""
    from deepspeed_tpu_torch.models import gpt2, gpt2_pipe
    from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule
    kw = dict(num_stages=spec["S"], num_dp=spec.get("dp", 1),
              num_mp=spec.get("tp", 1),
              num_virtual_stages=spec.get("v", 1),
              save_stage_residuals=spec.get("save", False))
    if "gpt2" in spec:
        cfg = gpt2.GPT2Config(**dict(spec["gpt2"],
                                     flash_attention_backend="pallas"))
        net = gpt2_pipe.make_gpt2_pipeline(
            config=cfg, activation_checkpoint_interval=spec.get("aci", 0),
            seed=spec.get("seed", 0), **kw)
    else:
        net = PipelineModule(
            layers=[LayerSpec(TanhLinear, DIM) for _ in range(spec["tanh"])],
            loss_fn=mse_loss, **kw)
    if spec.get("tree") is not None:
        net.load_pipe_tree(spec["tree"], spec.get("tree_layout"))
    return net


def rows(batch, engine, micro):
    d = engine.dp_rank
    return tuple(np.ascontiguousarray(x[:, d * micro:(d + 1) * micro])
                 for x in batch)


class _Saved:
    __slots__ = ("tensor", "__weakref__")

    def __init__(self, tensor):
        self.tensor = tensor


class SavedBytes:
    """Bytes of the tensors autograd holds for the backward, live and at
    their peak (a ``saved_tensors_hooks`` pair whose packed handle gives
    its bytes back when the graph frees it)."""

    def __init__(self):
        self.live = self.peak = 0

    def __enter__(self):
        def pack(t):
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            handle = _Saved(t)
            weakref.finalize(handle, self._free, n)
            return handle

        self._ctx = torch.autograd.graph.saved_tensors_hooks(
            pack, lambda handle: handle.tensor)
        self._ctx.__enter__()
        return self

    def _free(self, n):
        self.live -= n

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def _tied_copies(engine):
    """This stage's tied master leaves (fp32, full)."""
    state = engine._full_tree(engine.flat.master)
    return {k: v.numpy() for k, v in state.items() if k.startswith("tied.")}


def pipe_rank(rank, world, spec):
    """Run ``spec["runs"]``: each builds an engine on the rank's stage and
    plays its actions — ("train", batch, steps), ("eval", batch),
    ("master",), ("tied",), ("save", dir), ("load", dir), ("saved_bytes",
    batch), ("overflow_on_stage", s, batch), ("steps",) (the optimizer
    step count and whether the host Adam runs) — returning per run the
    losses, evals, the whole master tree (rank 0), the tied copies, the
    engine's pipe stats and counters."""
    import deepspeed_tpu_torch
    import torch.distributed as dist
    single_threaded()
    out = {}
    for name, run in spec["runs"]:
        net = build(run)
        engine = deepspeed_tpu_torch.initialize(
            model=net, config_params=config(run), device="cpu")[0]
        res = {"losses": [], "evals": [], "stage": engine.stage_id,
               "parts": list(net.parts), "kinds": type(engine).__name__}
        for action in run["actions"]:
            kind = action[0]
            if kind == "train":
                for _ in range(action[2]):
                    res["losses"].append(float(engine.train_batch(
                        batch=rows(action[1], engine, run["micro"]))))
                    res.setdefault("grad_norms", []).append(
                        engine.get_global_grad_norm())
            elif kind == "eval":
                res["evals"].append(float(engine.eval_batch(
                    batch=rows(action[1], engine, run["micro"]))))
            elif kind == "master":
                tree = engine.get_master_params()
                if rank == 0:
                    res["master"] = tree
                    res.setdefault("masters", []).append(tree)
            elif kind == "tied":
                res.setdefault("tied", []).append(_tied_copies(engine))
            elif kind == "save":
                engine.save_checkpoint(action[1], client_state={"k": 7})
            elif kind == "load":
                path, client = engine.load_checkpoint(action[1])
                res["loaded"] = (path is not None, client.get("k"),
                                 client.get("pipe_layout"))
            elif kind == "saved_bytes":
                with SavedBytes() as counter:
                    engine.train_batch(batch=rows(action[1], engine,
                                                  run["micro"]))
                res.setdefault("saved_peak", []).append(counter.peak)
                res.setdefault("peak_stash", []).append(
                    engine.pipe_stats["peak_stash"])
            elif kind == "overflow_on_stage":
                if engine.stage_id == action[1]:
                    fold = engine.flat.fold_grads

                    def poisoned():
                        engine.flat.grads[0] = float("inf")
                        fold()
                    engine.flat.fold_grads = poisoned
                before = {k: v.copy() for k, v in
                          _tied_copies(engine).items()}
                master0 = engine.flat.master.clone()
                scale0 = engine.loss_scale()
                engine.train_batch(batch=rows(action[2], engine,
                                              run["micro"]))
                res["overflow"] = {
                    "skipped": engine.skipped_steps,
                    "scale": (scale0, engine.loss_scale()),
                    "master_unchanged": bool(torch.equal(
                        master0, engine.flat.master)),
                    "tied_unchanged": all(
                        np.array_equal(v, before[k]) for k, v in
                        _tied_copies(engine).items())}
                engine.flat.__dict__.pop("fold_grads", None)
            elif kind == "steps":
                res["opt_step"] = engine.flat.step
                res["offload"] = engine.offload is not None
        res["stats"] = dict(engine.pipe_stats)
        res["state_numel"] = engine.flat.master.numel()
        out[name] = res
        del engine, net
        dist.barrier()
    return out


def refused_rank(rank, world, spec):
    """Build each of ``spec["confs"]`` (name, run spec) on the rank's stage
    and return what initialize raised: (type name, message), or None."""
    import deepspeed_tpu_torch
    single_threaded()
    out = {}
    for name, run in spec["confs"]:
        try:
            deepspeed_tpu_torch.initialize(model=build(run),
                                           config_params=config(run),
                                           device="cpu")
            out[name] = None
        except Exception as err:                       # noqa: BLE001
            out[name] = (type(err).__name__, str(err))
    return out


def p2p_rank(rank, world):
    """Two ranks: ``send`` / ``recv`` one tensor; then both send and
    receive in one matched batch (``post_p2p``), each rank posting its
    receive first; then one cycle of a pipeline ``Hop`` over
    ``build_mesh(pipe=2)``'s pair group, the activation forward and the
    gradient back at once."""
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.pipe.p2p import Hop
    from deepspeed_tpu_torch.utils.distributed import (post_p2p, recv, send,
                                                       wait_p2p)
    single_threaded()
    peer = 1 - rank
    out = {}
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    if rank == 0:
        send(x, 1)
    else:
        out["recv"] = recv(torch.empty(3), 0).tolist()
    buf = torch.empty(3)
    wait_p2p([post_p2p([(x + 100, peer)], [(buf, peer)], None)])
    out["exchange"] = buf.tolist()
    hop = Hop(build_mesh(pipe=2), rank, 2)
    act, grad = torch.empty(2, 2), torch.empty(2, 2)
    if rank == 0:
        hop.send_forward(torch.full((2, 2), 1.0))
        hop.recv_backward(grad)
    else:
        hop.recv_forward(act)
        hop.send_backward(torch.full((2, 2), -1.0))
    hop.run()
    out["hop"] = (grad if rank == 0 else act).tolist()
    return out
