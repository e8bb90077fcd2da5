"""zero.Init / GatheredParameters: construct-time parameter partitioning.

Port of ``deepspeed_tpu/runtime/zero/init_ctx.py`` (``Init`` :51,
``GatheredParameters`` :169, ``register_external_parameter`` :223).

The JAX package places each leaf of a ``Model`` built inside ``with
zero.Init(...)`` with the stage-3 plan's sharding. Here the module is an
``nn.Module``: inside the context ``nn.Module.__init__`` records every
module built, and on exit each outermost one with parameters is
partitioned as the engine's stage 3 lays it out
(``FlatPartition(stage=3, train_state=False)`` over the data group of
``mesh``: the model's ``zero3_units``, the persistence threshold), on
``device``: each partitioned leaf becomes an empty placeholder with its
shape in ``ds_shape`` and the rank's pieces live in the module's
``_zero3_store``; the leaves the plan keeps whole view one gathered
buffer. The host held each leaf whole while the model was built (as the
JAX package's host-side init does); the device holds only the rank's
pieces. ``initialize`` takes such a module: where its own stage-3 layout
is the store's (the same group and threshold) it starts from the pieces
as they are; otherwise it gathers the leaves first.

``remote_device="cpu"`` keeps the pieces in host memory, the same
layout; ``pin_memory`` is accepted and has no effect.
"""
import weakref

import torch
from torch import nn

from ...inference.engine import resolve_device
from ...parallel.topology import DATA_AXIS, build_mesh
from ...utils.distributed import broadcast_
from ...utils.logging import logger
from .constants import ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT
from .partition import FlatPartition


def _threshold_from_config(ds_config):
    default = ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT
    if ds_config is None:
        return default
    if isinstance(ds_config, dict):
        zero_cfg = ds_config.get("zero_optimization", {})
        # canonical stage3_-prefixed spelling wins; short alias accepted
        return zero_cfg.get(
            "stage3_param_persistence_threshold",
            zero_cfg.get("param_persistence_threshold", default))
    zc = getattr(ds_config, "zero_config", None)
    if zc is not None and getattr(zc, "param_persistence_threshold",
                                  None) is not None:
        return zc.param_persistence_threshold
    return default


def _units_of(module):
    """The model's ``zero3_units`` (from the module that defines its
    class), or one unit of every parameter."""
    import inspect
    fn = getattr(inspect.getmodule(type(module)), "zero3_units", None)
    if fn is not None:
        return fn(module)
    return [("module", [n for n, _ in module.named_parameters()])]


class Zero3Store:
    """A ``zero.Init`` module's partitioned parameters: the stage-3
    layout (a ``FlatPartition`` without training state) and this rank's
    pieces (``local``, in the parameters' dtype)."""

    def __init__(self, module, group, device, dtype, threshold):
        self.flat = FlatPartition(
            module, device, dtype, group=group, stage=3,
            units=_units_of(module), persistence_threshold=threshold,
            train_state=False)
        self.local = self.flat.params

    def layout_key(self):
        return self.flat.layout_key()

    def gather_full(self):
        """``{name: tensor}`` of every leaf, whole (every rank of the
        group must call)."""
        return self.flat.tree_of(self.flat.params, keep_dtype=True)

    def scatter_full(self, state):
        """Whole leaves ``{name: tensor}`` -> this rank's pieces, and the
        persistent leaves re-gathered."""
        self.flat.load(self.flat.params, state)
        self.flat.gather_persistent()


class Init:
    """Context manager: modules built inside hold only this rank's pieces
    of their parameters (``with zero.Init(mesh=mesh, device="cpu"): model
    = make_gpt2_model(...)``)."""

    def __init__(self, module=None, data_parallel_group=None, mesh=None,
                 mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config=None, enabled=True, dtype=None,
                 param_persistence_threshold=None, device=None):
        self.enabled = enabled
        self.mesh = mesh if mesh is not None else build_mesh()
        if data_parallel_group is None and \
                int(self.mesh.shape.get(DATA_AXIS, 1)) > 1:
            data_parallel_group = self.mesh.get_group(DATA_AXIS)
        self.group = data_parallel_group
        self.dtype = dtype
        self.threshold = (param_persistence_threshold
                          if param_persistence_threshold is not None
                          else _threshold_from_config(config))
        self.device = None
        if enabled:
            self.device = torch.device("cpu") if remote_device == "cpu" \
                else resolve_device(device)
        self._saved_init = None
        self._built = []
        if module is not None and enabled:
            self.partition(module)

    def partition(self, module):
        """Partition ``module``'s parameters in place (see the module
        docstring); returns the module."""
        if getattr(module, "ds_sharded", False):
            return module
        first = next(module.parameters())
        dtype = self.dtype or first.dtype
        module._zero3_store = Zero3Store(module, self.group, self.device,
                                         dtype, self.threshold)
        module.ds_sharded = True
        return module

    def __enter__(self):
        if not self.enabled:
            return self
        self._saved_init = nn.Module.__init__
        ctx, saved = self, self._saved_init

        def patched_init(module, *args, **kwargs):
            saved(module, *args, **kwargs)
            ctx._built.append(weakref.ref(module))

        nn.Module.__init__ = patched_init
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if not self.enabled:
            return False
        nn.Module.__init__ = self._saved_init
        built = [r() for r in self._built]
        built = [m for m in built if m is not None]
        self._built = []
        if exc_type is not None:
            return False
        inner = {id(c) for m in built for c in m.modules() if c is not m}
        for module in built:
            if id(module) not in inner and \
                    next(module.parameters(), None) is not None:
                self.partition(module)
        return False


class GatheredParameters:
    """Temporarily materialize full parameter values.

    ``with GatheredParameters(model) as full:`` yields ``{name: tensor}``,
    every leaf whole (every rank of the data group enters). On exit, when
    ``modifier_rank`` is given, that rank's (possibly modified) values
    are broadcast and written back: into the ``zero.Init`` store's pieces,
    or, for a module an engine trains at stage 3, into its pieces and its
    fp32 master; without it the values are discarded. A module that is
    not partitioned yields copies of its parameters (written back the same
    way), and a plain dict of tensors or arrays is yielded as it is, its
    in-place changes kept."""

    def __init__(self, target, modifier_rank=None, fwd_module=None,
                 enabled=True):
        self.enabled = enabled
        self.modifier_rank = modifier_rank
        self.target = target
        self._full = None

    def _owner(self):
        t = self.target
        if isinstance(t, nn.Module):
            if getattr(t, "_zero3", None) is not None:
                return "engine"
            if getattr(t, "_zero3_store", None) is not None:
                return "store"
            return "module"
        return "tree"

    def __enter__(self):
        if not self.enabled:
            return self.target
        kind = self._owner()
        t = self.target
        if kind == "engine":
            self._full = t._zero3.full_state()
        elif kind == "store":
            self._full = t._zero3_store.gather_full()
        elif kind == "module":
            self._full = {n: p.detach().clone()
                          for n, p in t.named_parameters()}
        else:
            self._full = t
        return self._full

    def __exit__(self, exc_type, exc_val, exc_tb):
        if not self.enabled or exc_type is not None or \
                self.modifier_rank is None:
            return False
        kind = self._owner()
        if kind == "tree":
            return False
        state = self._full
        group = None
        if kind in ("engine", "store"):
            flat = self.target._zero3.flat if kind == "engine" else \
                self.target._zero3_store.flat
            group = flat.group
        if group is not None:
            src = torch.distributed.get_global_rank(group,
                                                    self.modifier_rank)
            for value in state.values():
                broadcast_(value, src=src, group=group)
        if kind == "store":
            self.target._zero3_store.scatter_full(state)
        elif kind == "engine":
            flat = self.target._zero3.flat
            flat.load(flat.master, {k: v.float() for k, v in state.items()})
            flat.refresh_params()
        else:
            with torch.no_grad():
                for name, p in self.target.named_parameters():
                    p.copy_(state[name])
        return False


def register_external_parameter(module, parameter):
    """Does nothing, as in the JAX package. The reference registers a
    parameter one module uses from another so its coordinator gathers it;
    here a model names the units each of its calls gathers (GPT-2's head
    borrows the embedding unit for the tied ``wte``), so there is nothing
    to register."""
    logger.debug("register_external_parameter: nothing to register")
