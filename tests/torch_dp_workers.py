"""Rank bodies for the port's data-parallel (ZeRO-1/2) and sparse-gradient
tests, run by ``deepspeed_tpu_torch.utils.distributed.spawn`` in gloo
processes on the CPU. This module imports nothing of JAX: the workers are
the port alone; the test files hold the JAX side and compare in the
parent process. Inputs arrive as numpy arrays (the global batch; each
rank takes its data coordinate's rows) and results leave as numpy arrays
and plain values."""
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from torch_tp_workers import single_threaded


class SimpleModel(nn.Module):
    """``tests/unit/simple_model.py::make_simple_model``'s MLP, the same
    draws: ``layer_{i}.w`` (h, h) * 0.1 and zero ``layer_{i}.b``; relu
    between layers, in the input's dtype (fp32) as the JAX model computes;
    ``forward(x, y)`` is the mean squared error."""

    def __init__(self, hidden, nlayers=2, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.layers = nlayers
        for i in range(nlayers):
            w = torch.from_numpy((rng.randn(hidden, hidden) * 0.1)
                                 .astype(np.float32))
            self.register_parameter("layer_{}_w".format(i), nn.Parameter(w))
            self.register_parameter("layer_{}_b".format(i), nn.Parameter(
                torch.zeros(hidden)))

    def forward(self, x, y):
        # the JAX model casts the weights to the input's dtype (fp32)
        h = x.float()
        for i in range(self.layers):
            w = getattr(self, "layer_{}_w".format(i))
            b = getattr(self, "layer_{}_b".format(i))
            h = h @ w.float() + b.float()
            if i < self.layers - 1:
                h = torch.relu(h)
        return ((h.float() - y.float()) ** 2).mean()


class UnbalancedModel(nn.Module):
    """``tests/unit/test_zero.py::test_zero_unbalanced_shapes``'s model:
    ``w_odd`` (7, 5) and ``w_even`` (16, 16), 0.1 * normal from seed 0."""

    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(0)
        self.w_odd = nn.Parameter(torch.from_numpy(
            (rng.randn(7, 5) * 0.1).astype(np.float32)))
        self.w_even = nn.Parameter(torch.from_numpy(
            (rng.randn(16, 16) * 0.1).astype(np.float32)))

    def forward(self, x, y):
        h = x.float() @ self.w_even.float()
        h2 = h[:, :7] @ self.w_odd.float()
        return ((h2.float() - y[:, :5].float()) ** 2).mean()


def train_config(spec):
    conf = {"train_micro_batch_size_per_gpu": spec["micro"],
            "gradient_accumulation_steps": spec.get("gas", 1),
            "optimizer": {"type": spec.get("optimizer", "Adam"),
                          "params": dict({"lr": spec.get("lr", 1e-3)},
                                         **spec.get("opt_params", {}))},
            "steps_per_print": 10 ** 9}
    if spec.get("clip"):
        conf["gradient_clipping"] = spec["clip"]
    if spec.get("tp", 1) > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True,
                                              "backend": "pallas"}}
    if spec.get("backend"):
        # the kernels ("pallas") or the plain versions ("xla")
        conf["optimizer"]["params"]["fused_kernel"] = spec["backend"]
        conf["transformer"] = {"flash_attention": spec["backend"]}
    if spec.get("moments"):
        conf["optimizer"]["params"]["moments_dtype"] = spec["moments"]
    if spec["prec"] == "bf16":
        conf["bf16"] = {"enabled": True}
        conf["zero_optimization"] = {"stage": spec.get("stage", 0)}
    if spec.get("sparse_gradients"):
        conf["sparse_gradients"] = True
    return conf


def scale_straddling_leaf(model, lo, factor):
    """Scale by ``factor`` the part before flat offset ``lo`` of the leaf
    whose elements straddle ``lo`` in the engine's layout (one rank's half
    of a leaf, the other rank holding the rest); returns its name."""
    from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
    off = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if off < lo < off + p.numel():
                p.view(-1)[:lo - off] *= factor
                return name
            off += -(-p.numel() // ALIGN) * ALIGN
    raise ValueError("no leaf straddles offset {}".format(lo))


def _model(spec, mesh):
    from deepspeed_tpu_torch.models import gpt2
    if spec.get("simple"):
        return SimpleModel(spec["hidden"], seed=spec["seed"])
    if spec.get("unbalanced"):
        return UnbalancedModel()
    cfg = gpt2.GPT2Config(**spec["model"])
    if spec.get("sparse_embedding_grads"):
        cfg.sparse_embedding_grads = True
        cfg.embedding_grad_mesh = mesh
    return gpt2.make_gpt2_model(config=cfg, seed=spec["seed"])


def _counters():
    """The kernel wrappers whose launches the engine's path counts."""
    from deepspeed_tpu_torch.ops.adam.fused_adam import fused_adam
    from deepspeed_tpu_torch.ops.lamb import fused_lamb, fused_lamb_apply
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return [fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq, fused_adam,
            fused_lamb, fused_lamb_apply]


def _rows(batch, coord, micro):
    """This data coordinate's rows of a global batch ``(gas, rows, ...)``."""
    return tuple(np.ascontiguousarray(x[:, coord * micro:(coord + 1) * micro])
                 for x in batch)


def dp_engine(rank, world, specs):
    """Per spec: a mesh of ``spec["data"]`` x ``spec.get("tp", 1)`` over the
    group, the seeded model (``scale_half``: the leaf straddling rank 1's
    range scaled by that before rank 1's first element), the engine
    trained on this data coordinate's rows of ``spec["batch"]`` for
    ``steps`` steps (or of each step's batch of ``spec["series"]``);
    returns the losses, the gathered master tree (GPT-2: the JAX tree;
    otherwise ``{name: array}``), the optimizer step, the views check,
    the per-rank state bytes and layout, and where asked the state after
    loading a JAX state, the next loss, and the ValueError of a batch of
    the wrong row count."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    results = []
    for spec in specs:
        tp = spec.get("tp", 1)
        mesh = build_mesh(data=spec["data"], model=tp)
        model = _model(spec, mesh)
        res = {}
        if spec.get("scale_half"):
            # rank 1's range starts at half the padded layout
            from deepspeed_tpu_torch.runtime.zero.partition import ALIGN
            numel = sum(-(-p.numel() // ALIGN) * ALIGN
                        for p in model.parameters())
            unit = ALIGN * spec["data"]
            half = -(-numel // unit) * unit // spec["data"]
            res["scaled"] = scale_straddling_leaf(model, half,
                                                  spec["scale_half"])
        engine = deepspeed_tpu_torch.initialize(
            model=model, mesh=mesh, config_params=train_config(spec),
            device=spec.get("device", "cpu"))[0]
        assert engine.dp_world_size == spec["data"]
        coord = engine.dp_rank
        if spec.get("series") is not None:
            # one global batch a step: (steps, rows, ...) arrays
            steps = [_rows(tuple(a[i][None] for a in spec["series"]), coord,
                           spec["micro"])
                     for i in range(len(spec["series"][0]))]
            batch = steps[-1]
        else:
            batch = _rows(spec["batch"], coord, spec["micro"])
            steps = [batch] * spec["steps"]
        counters = _counters()
        for c in counters:
            c.launches = 0
        losses = [float(engine.train_batch(batch=b)) for b in steps]
        res["launches"] = {c.__name__: c.launches for c in counters}
        flat = engine.flat
        res.update(
            losses=losses, dp_rank=coord, views=flat.check_views(),
            opt_step=flat.step,
            state_bytes=flat.state_bytes(), numel=flat.numel,
            part_numel=flat.part_numel, lo=flat.lo, hi=flat.hi,
            params_numel=flat.params.numel(), grads_numel=flat.grads.numel(),
            adam_numel=flat.master.numel(), device=str(engine.device),
            csr=sorted(engine.csr_tensor_module_names))
        if spec.get("simple") or spec.get("unbalanced"):
            res["master"] = {k: v.numpy() for k, v in
                             flat.tree_of(flat.master).items()}
            res["params"] = {k: v.numpy() for k, v in
                             flat.tree_of(flat.params).items()}
        else:
            res["master"] = engine.get_master_params()
        if spec.get("load") is not None:
            master, opt = spec["load"]
            engine.load_state_from_jax(master=master, optimizer_state=opt)
            res["reloaded"] = engine.get_master_params()
            res["reloaded_opt"] = engine.get_optimizer_state()
            res["next_loss"] = float(engine.train_batch(batch=batch))
        if spec.get("wrong_rows"):
            try:
                engine.train_batch(batch=tuple(np.asarray(x)
                                               for x in spec["batch"]))
            except ValueError as err:
                res["wrong_rows"] = str(err)
        results.append(res)
    return results


def collectives(rank, world):
    """The data-parallel collectives on gloo: a bf16 all-reduce and the
    all-reduce-and-slice reduce-scatter (against gloo's own
    ``reduce_scatter_tensor``, NCCL's semantics), an fp32 one too, and
    ``all_gather_into`` from a view of its output."""
    from deepspeed_tpu_torch.utils.distributed import (all_gather_into,
                                                       all_reduce_,
                                                       reduce_scatter)
    single_threaded()
    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(rank)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(8 * world, generator=gen).to(dtype)
        out[str(dtype)] = {
            "x": x.float().numpy(),
            "all_reduce": all_reduce_(x.clone(), group).float().numpy(),
            "all_reduce_dtype": str(all_reduce_(x.clone(), group).dtype),
            "reduce_scatter": reduce_scatter(x, group).float().numpy(),
            "reduce_scatter_dtype": str(reduce_scatter(x, group).dtype)}
        want = torch.empty(8, dtype=dtype)
        dist.reduce_scatter_tensor(want, x.clone(), group=group)
        out[str(dtype)]["reduce_scatter_tensor"] = want.float().numpy()
    full = torch.zeros(4 * world)
    full[4 * rank:4 * rank + 4] = torch.arange(4.0) + 10 * rank
    all_gather_into(full, full[4 * rank:4 * rank + 4], group)
    out["all_gather_into"] = full.numpy()
    return out


def sparse_lookup(rank, world, cases):
    """Per case ``(wte, ids, loss)``: this rank's rows of ``ids``, the
    lookup through ``sparse_embedding_lookup`` over a ``build_mesh(
    data=world)`` and through ``wte[ids]``; returns the outputs, each
    table gradient of the local loss (``"sum_cos"``: sum(out * cos(out));
    ``"sum"``: sum(out)) and whether the exchange ran."""
    from deepspeed_tpu_torch.ops import sparse_grads
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    single_threaded()
    mesh = build_mesh(data=world)
    out = []
    for wte, ids, loss in cases:
        rows = ids.shape[0] // world
        local = torch.from_numpy(ids[rank * rows:(rank + 1) * rows]).long()
        res = {}
        for name, fn in (("sparse", lambda w: sparse_grads.
                          sparse_embedding_lookup(w, local, mesh=mesh)),
                         ("dense", lambda w: w[local])):
            w = torch.from_numpy(wte).clone().requires_grad_(True)
            y = fn(w)
            res[name + "_exchanged"] = type(y.grad_fn).__name__.startswith(
                "_SparseLookup")
            total = (y * torch.cos(y)).sum() if loss == "sum_cos" \
                else y.sum()
            total.backward()
            res[name] = y.detach().numpy()
            res[name + "_grad"] = w.grad.numpy()
        out.append(res)
    return out
