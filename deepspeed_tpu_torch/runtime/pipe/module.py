"""PipelineModule: a model as a list of layers, cut into pipeline stages.

Port of ``deepspeed_tpu/runtime/pipe/module.py`` (reference:
deepspeed/runtime/pipe/module.py, LayerSpec :23, TiedLayerSpec :71,
PipelineModule :85, partitioning :348-403). The partitioning is the JAX
package's, rule for rule: the pipelined body is the maximal run of
layers of one class (``partition_method`` "uniform", "parameters" or
"type:regex"), the layers before it (the embedding) and after it (the
final norm, the head) are hoisted onto the first and the last stage,
``parts`` and ``stage_depths`` come out equal to the JAX module's for the
same layer list, ragged stages included, and with ``num_virtual_stages``
= v virtual stage j = c * S + r (chunk c) lives on rank r.

The difference: the JAX module holds every stage's parameters, stacked
``(S, L, ...)`` (``(S, v, L, ...)`` interleaved) with each stage padded
to the deepest one and sharded on the ``pipe`` axis. Here a rank builds
and holds only its own stage: ``tied`` (the tied layers this stage uses:
the first stage for those in the head of the list, the last for those in
its tail; both copies are kept equal by the engine), ``pre`` (first
stage), ``body[c]`` (chunk c's real layers, no padding) and ``post``
(last stage), as ``nn.Module``\\ s. Layers are prototyped on the
``meta`` device to find the body and count parameters, so nothing of
another stage is ever allocated.

Layers are ``nn.Module``\\ s whose ``forward(x)`` maps the activation
(a body layer may take ``seed=`` for its dropout). A :class:`LayerSpec`
defers construction; each layer is built with the torch RNG seeded by
``base_seed`` + its index in the list, so its initial weights do not
depend on the partition (the JAX module draws from ``jax.random``, which
the port cannot reproduce: the tests carry JAX's weights across with
:meth:`PipelineModule.load_pipe_tree`). A tied entry with ``forward_fn``
runs ``forward_fn(tied_module, x)``.

:meth:`load_pipe_tree` and :meth:`pipe_tree` convert between this
stage's parameters and the JAX module's tree ``{"tied", "pre", "post",
"body"}`` (padded slots dropped one way, refilled with a copy of the
stage's first layer the other way, as the JAX module's ``_init_params``
fills them).
"""
import contextlib
import copy
import inspect
import re
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...parallel.topology import (MeshGrid, PIPE_AXIS,
                                  PipeDataParallelTopology,
                                  PipeModelDataParallelTopology)
from ...utils.logging import logger
from ..utils import call_to_str, partition_balanced, partition_uniform


class LayerSpec:
    """Defers layer construction (reference :23-68). ``typename`` is a class
    or factory; building yields the layer (an ``nn.Module``)."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not callable(typename):
            raise RuntimeError("LayerSpec requires a callable type/factory")

    def build(self, log=False):
        if log:
            logger.info("building {}".format(repr(self)))
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return call_to_str(getattr(self.typename, "__name__",
                                   str(self.typename)),
                           *self.module_args, **self.module_kwargs)


class TiedLayerSpec(LayerSpec):
    """A layer whose parameters are shared with every other TiedLayerSpec of
    the same ``key`` (reference :71-82)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="wte", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


class Layer(nn.Module):
    """Adapter making an ``(init_fn, apply_fn)`` pair a pipeline layer:
    ``init_fn()`` returns ``{name: tensor}`` (drawn from the torch RNG),
    registered as parameters; ``forward(x)`` is ``apply_fn(params, x)``
    with ``params`` that dict of parameters."""

    def __init__(self, init_fn, apply_fn, name="layer"):
        super().__init__()
        self._apply_fn = apply_fn
        self.name = name
        for key, value in init_fn().items():
            self.register_parameter(key, nn.Parameter(torch.as_tensor(value)))

    def forward(self, x, **kwargs):
        return self._apply_fn(dict(self.named_parameters()), x, **kwargs)


def _call_accepting(fn, *args, **kwargs):
    """``fn(*args)`` with only the kwargs its signature (a module's:
    its ``forward``'s) takes."""
    if kwargs:
        try:
            params = inspect.signature(
                fn.forward if isinstance(fn, nn.Module) else fn).parameters
            if not any(q.kind == inspect.Parameter.VAR_KEYWORD
                       for q in params.values()):
                kwargs = {k: v for k, v in kwargs.items() if k in params}
        except (TypeError, ValueError):
            kwargs = {}
    return fn(*args, **kwargs)


@contextlib.contextmanager
def _seeded(seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def _world():
    return dist.get_world_size() if dist.is_initialized() else None


# ------------------------------------------------------------ tree helpers


def _nest(flat):
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def _get(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            else tree[key]
    return tree


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def global_to_slot(layout, layer_id):
    """Global body-layer id -> its index in the stacked JAX body under
    ``layout`` (``parts``, ``num_virtual``, number of stages): (stage,
    slot) at v=1, (stage, chunk, slot) interleaved (virtual stage j =
    chunk * S + stage owns [parts[j], parts[j+1]))."""
    parts, v = layout["parts"], int(layout.get("num_virtual", 1))
    S = (len(parts) - 1) // v
    for j in range(S * v):
        if parts[j] <= layer_id < parts[j + 1]:
            slot = layer_id - parts[j]
            return (j, slot) if v == 1 else (j % S, j // S, slot)
    raise IndexError(layer_id)


class PipelineModule(nn.Module):
    """Partition a layer list across pipeline stages (reference :85) and
    hold this rank's stage.

    Args follow the JAX package: ``layers`` (LayerSpecs, layer modules or
    stateless callables), ``num_stages`` or ``topology``, ``loss_fn``,
    ``partition_method`` ('uniform' | 'parameters' | 'type:regex'),
    ``activation_checkpoint_interval`` (N > 0: the stage's layers run in
    groups of N under ``torch.utils.checkpoint``), ``base_seed`` (every
    layer is built under the torch RNG seeded ``base_seed`` + its index,
    so ``seed_layers`` is accepted and always in effect), ``num_dp``,
    ``num_mp``, ``num_virtual_stages``,
    ``save_stage_residuals`` (the engine keeps each micro-batch's
    autograd graph instead of re-running the stage in the backward).
    Inside a process group the topology must cover it, and the stage is
    this rank's pipe coordinate; without one, ``stage_id`` (default 0)
    picks the stage to build."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seed_layers=False, base_seed=1234,
                 partition_method="parameters",
                 activation_checkpoint_interval=0, num_dp=None, num_mp=None,
                 num_virtual_stages=1, save_stage_residuals=False,
                 stage_id=None):
        super().__init__()
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        assert num_virtual_stages >= 1
        self.num_virtual = int(num_virtual_stages)
        self.save_residuals = bool(save_stage_residuals)

        if topology is None:
            assert num_stages is not None, \
                "must provide num_stages or topology"
            n_dev = _world() or num_stages * (num_dp or 1) * (num_mp or 1)
            if num_dp is None and num_mp is None:
                assert n_dev % num_stages == 0
                num_dp, num_mp = n_dev // num_stages, 1
            num_dp = num_dp or 1
            num_mp = num_mp or 1
            if num_mp > 1:
                topology = PipeModelDataParallelTopology(
                    num_pp=num_stages, num_mp=num_mp, num_dp=num_dp)
            else:
                topology = PipeDataParallelTopology(num_pp=num_stages,
                                                    num_dp=num_dp)
        self._topo = topology
        self.num_stages = topology.get_dim(PIPE_AXIS)
        self._grid = MeshGrid(topology=topology)
        self.stage_id = self._grid.get_stage_id() if stage_id is None \
            else int(stage_id)
        if not 0 <= self.stage_id < self.num_stages:
            raise ValueError("stage_id {} outside {} stages".format(
                self.stage_id, self.num_stages))

        self._layer_specs = list(layers)
        self._build_layers()
        self._partition_layers()
        self._build_stage()

    def mpu(self):
        return self._grid

    @property
    def topology(self):
        return self._topo

    def forward(self, *args, **kwargs):
        raise RuntimeError("a PipelineModule runs through its engine's "
                           "train_batch() / eval_batch()")

    # ------------------------------------------------------------ build
    @staticmethod
    def _prototype(spec):
        """The layer built on the meta device (shapes only); a factory the
        meta device refuses is built for real."""
        try:
            with torch.device("meta"):
                return spec.build()
        except Exception:                               # noqa: BLE001
            return spec.build()

    def _build_layers(self):
        self.layers = []
        self.tied_keys = {}
        self._tied_index = {}
        for i, spec in enumerate(self._layer_specs):
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in self.tied_keys:
                    self.tied_keys[spec.key] = self._prototype(spec)
                    self._tied_index[spec.key] = i
                self.layers.append(("tied", spec.key, spec))
            elif isinstance(spec, LayerSpec):
                self.layers.append(("layer", None, self._prototype(spec)))
            elif isinstance(spec, nn.Module):
                self.layers.append(("layer", None, spec))
            elif callable(spec):
                # stateless function layer
                self.layers.append(("fn", None, spec))
            else:
                raise TypeError("Unsupported layer spec: {}".format(spec))

    def _layer_weight(self, entry):
        """Parameter count, used by partition_method='parameters'
        (reference partition by trainable parameters :378-403), from the
        meta prototype."""
        kind, _, layer = entry
        if kind != "layer":
            return 0
        return sum(p.numel() for p in layer.parameters())

    def _partition_layers(self):
        """Decide the pipelined body vs hoisted head/tail (the JAX
        module's rules, its ``_partition_layers``)."""
        method = self.partition_method.lower()
        entries = self.layers
        n = len(entries)

        if method.startswith("type:"):
            pattern = method[len("type:"):]
            body_mask = [
                kind == "layer" and
                re.search(pattern, type(layer).__name__, re.IGNORECASE)
                is not None
                for kind, _, layer in entries]
        else:
            # body = longest run of same-class plain layers
            body_mask = [False] * n
            best_start, best_len = 0, 0
            i = 0
            while i < n:
                kind, _, layer = entries[i]
                if kind != "layer":
                    i += 1
                    continue
                j = i
                while (j < n and entries[j][0] == "layer" and
                       type(entries[j][2]) is type(layer)):
                    j += 1
                if j - i > best_len:
                    best_start, best_len = i, j - i
                i = j
            for i in range(best_start, best_start + best_len):
                body_mask[i] = True

        body_idx = [i for i, m in enumerate(body_mask) if m]
        assert body_idx, "no pipelineable body found in layer list"
        assert body_idx == list(range(body_idx[0], body_idx[-1] + 1)), \
            "pipelined body must be contiguous"
        n_body = len(body_idx)
        assert n_body >= self.num_stages, \
            "pipelined body of {} layers is shallower than num_stages={}" \
            .format(n_body, self.num_stages)
        self.body_start = body_idx[0]
        self.body_end = body_idx[-1] + 1
        self.pre_layers = entries[:self.body_start]
        self.body_layers = entries[self.body_start:self.body_end]
        self.post_layers = entries[self.body_end:]

        n_virtual = self.num_stages * self.num_virtual
        assert len(self.body_layers) >= n_virtual, \
            "pipelined body of {} layers is shallower than {} virtual " \
            "stages ({} stages x {} chunks)".format(
                len(self.body_layers), n_virtual, self.num_stages,
                self.num_virtual)
        if self.partition_method == "parameters":
            weights = [self._layer_weight(e) for e in self.body_layers]
            self.parts = partition_balanced(weights, n_virtual)
            if min(self.parts[j + 1] - self.parts[j]
                   for j in range(n_virtual)) < 1:
                logger.warning(
                    "parameter-balanced partition left an empty stage "
                    "(parts={}); using uniform split".format(self.parts))
                self.parts = partition_uniform(len(self.body_layers),
                                               n_virtual)
        else:
            self.parts = partition_uniform(len(self.body_layers), n_virtual)
        depths = np.array(
            [self.parts[j + 1] - self.parts[j] for j in range(n_virtual)],
            dtype=np.int32)
        assert int(depths.min()) >= 1, \
            "partitioning produced an empty stage: parts={}".format(self.parts)
        if self.num_virtual == 1:
            self.stage_depths = depths
        else:
            # virtual stage j = c*S + s -> [s, c]
            self.stage_depths = depths.reshape(
                self.num_virtual, self.num_stages).T.copy()
        self.layers_per_stage = int(depths.max())

    def _real(self, index, fallback):
        """Entry ``index`` of the layer list built for this stage: the
        spec's layer under the torch RNG seeded ``base_seed + index``, or
        the module given in the list."""
        spec = self._layer_specs[index]
        if not isinstance(spec, LayerSpec):
            return fallback
        with _seeded(self.base_seed + index):
            return spec.build()

    def _build_stage(self):
        """This rank's modules (tied first, so their parameters lead the
        engine's flat layout)."""
        S, r = self.num_stages, self.stage_id
        first, last = r == 0, r == S - 1
        here = set()
        if first:
            here |= {key for kind, key, _ in self.pre_layers
                     if kind == "tied"}
        if last:
            here |= {key for kind, key, _ in self.post_layers
                     if kind == "tied"}
        self.tied = nn.ModuleDict(OrderedDict(
            (key, self._real(self._tied_index[key], None))
            for key in self.tied_keys if key in here))
        self.pre = nn.ModuleDict()
        if first:
            for i, (kind, _, layer) in enumerate(self.pre_layers):
                if kind == "layer":
                    self.pre[str(i)] = self._real(i, layer)
        self.body = nn.ModuleList()
        for c in range(self.num_virtual):
            j = c * S + r
            self.body.append(nn.ModuleList(
                self._real(self.body_start + g, self.body_layers[g][2])
                for g in range(self.parts[j], self.parts[j + 1])))
        self.post = nn.ModuleDict()
        if last:
            for i, (kind, _, layer) in enumerate(self.post_layers):
                if kind == "layer":
                    self.post[str(i)] = self._real(self.body_end + i, layer)

    # ----------------------------------------------------------- apply
    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.num_stages - 1

    def tied_owner(self, key):
        """The stage that counts tied key ``key`` in the gradient norm and
        writes it to checkpoints: the first stage that holds it."""
        if any(k == key for kind, k, _ in self.pre_layers if kind == "tied"):
            return 0
        return self.num_stages - 1

    def body_ids(self, c):
        """Global body-layer ids of this rank's chunk ``c``."""
        j = c * self.num_stages + self.stage_id
        return range(self.parts[j], self.parts[j + 1])

    def _apply_entry(self, entries, mods, i, x):
        kind, key, layer = entries[i]
        if kind == "tied":
            if layer.forward_fn is not None:
                return layer.forward_fn(self.tied[key], x)
            return self.tied[key](x)
        if kind == "fn":
            return layer(x)
        return mods[str(i)](x)

    def _zero3_runtime(self):
        """The engine's ZeRO-3 gather runtime (``Stage3``) when this
        stage's parameters are partitioned over its data group, else
        None."""
        return self.__dict__.get("_zero3")

    def _entry_units(self, entries, kind, i):
        """(units, borrowed units) of entry ``i`` of the pre or post
        layers under ZeRO-3: a layer's own unit; a tied layer's, borrowed
        by the head when this stage also holds the embedding (the
        embedding's call, whose backward runs last, reduces it)."""
        what, key, _ = entries[i]
        if what == "fn":
            return (), ()
        if what == "layer":
            return ("{}.{}".format(kind, i),), ()
        unit = "tied." + key
        if kind == "post" and any(k == key for w, k, _ in self.pre_layers
                                  if w == "tied") and self.is_first_stage:
            return (), (unit,)
        return (unit,), ()

    def apply_pre(self, x):
        """The hoisted head layers (e.g. the embedding): first stage.
        Under ZeRO-3 each layer runs as one ``Stage3.call`` over its
        unit."""
        z3 = self._zero3_runtime()
        for i in range(len(self.pre_layers)):
            units, borrow = self._entry_units(self.pre_layers, "pre", i) \
                if z3 is not None else ((), ())
            if not units and not borrow:
                x = self._apply_entry(self.pre_layers, self.pre, i, x)
                continue
            x = z3.call(lambda h, i=i: self._apply_entry(
                self.pre_layers, self.pre, i, h), x, units=units,
                borrow=borrow)
        return x

    def apply_post(self, x):
        """The hoisted tail layers (final norm, head): last stage."""
        for i in range(len(self.post_layers)):
            x = self._apply_entry(self.post_layers, self.post, i, x)
        return x

    def post_loss(self, x, labels):
        """``loss(apply_post(x), labels)``; under ZeRO-3 one
        ``Stage3.call`` over the tail layers' units (the head's output is
        the tied table and the hidden states, which only the loss
        reads)."""
        z3 = self._zero3_runtime()
        if z3 is None:
            return self.loss(self.apply_post(x), labels)
        units, borrow = [], []
        for i in range(len(self.post_layers)):
            u, b = self._entry_units(self.post_layers, "post", i)
            units += u
            borrow += b
        return z3.call(lambda h, lab: self.loss(self.apply_post(h), lab),
                       x, labels, units=tuple(units), borrow=tuple(borrow))

    def run_chunk(self, c, x, seeds=None):
        """This rank's chunk ``c`` of the body on ``x``; ``seeds`` (one
        per layer, or None) reach the layers that take ``seed=``. With
        ``activation_checkpoint_interval`` N > 0 and gradients on, every
        N layers run under ``torch.utils.checkpoint`` (reference forward
        :292-346). Under ZeRO-3 each layer runs as one ``Stage3.call``
        over its unit (which recomputes it in the backward: no other
        checkpoint)."""
        layers = list(self.body[c])
        seeds = seeds if seeds is not None else [None] * len(layers)
        z3 = self._zero3_runtime()
        if z3 is not None:
            for j, (layer, seed) in enumerate(zip(layers, seeds)):
                x = z3.call(lambda h, layer=layer, seed=seed:
                            _call_accepting(layer, h, seed=seed), x,
                            units=("body.{}.{}".format(c, j),))
            return x

        def run(lo, hi, h):
            for layer, seed in zip(layers[lo:hi], seeds[lo:hi]):
                h = _call_accepting(layer, h, seed=seed)
            return h

        interval = self.activation_checkpoint_interval
        if not (interval and interval > 0 and torch.is_grad_enabled()):
            return run(0, len(layers), x)
        interval = min(interval, len(layers))
        for lo in range(0, len(layers), interval):
            x = checkpoint(run, lo, lo + interval, x, use_reentrant=False)
        return x

    @staticmethod
    def zero3_units(module):
        """ZeRO stage 3's gather units of this stage: each tied layer,
        each pre and post layer, each body layer (``body.c.j``)."""
        names = [n for n, _ in module.named_parameters()]
        prefixes = ["tied." + k for k in module.tied] + \
            ["pre." + k for k in module.pre] + \
            ["body.{}.{}".format(c, j) for c in range(len(module.body))
             for j in range(len(module.body[c]))] + \
            ["post." + k for k in module.post]
        units = [(p, [n for n in names if n.startswith(p + ".")])
                 for p in prefixes]
        return [u for u in units if u[1]]

    def loss(self, out, labels):
        if self.loss_fn is not None:
            return self.loss_fn(out, labels)
        return out.float().mean()

    # ------------------------------------------------------ names, layers
    def _layer_of(self, name):
        """A parameter name of this stage -> (layer module, its name
        inside the layer, the JAX tree path of the full leaf, the body
        layer's (chunk, slot) or None)."""
        head, rest = name.split(".", 1)
        if head == "body":
            c, j, inner = rest.split(".", 2)
            c, j = int(c), int(j)
            return self.body[c][j], inner, "body." + inner, (c, j)
        key, inner = rest.split(".", 1)
        mods = {"tied": self.tied, "pre": self.pre, "post": self.post}[head]
        return mods[key], inner, name, None

    def partition_spec_fn(self, name, shape):
        """Tensor-parallel spec of a stage parameter: its layer's
        ``partition_spec_fn`` on the name inside the layer; None (whole on
        every model rank) for layers without one, as the JAX module's."""
        layer, inner, _, _ = self._layer_of(name)
        fn = getattr(layer, "partition_spec_fn", None)
        return fn(inner, shape) if fn is not None else None

    def _per_layer(self, state):
        groups = OrderedDict()
        for name, t in state.items():
            layer, inner, _, _ = self._layer_of(name)
            prefix = name[:len(name) - len(inner)]
            groups.setdefault(prefix, (layer, {}))[1][inner] = t
        return groups

    def tp_shard_state_dict(self, state, rank, size):
        """Rank ``rank``'s shard of a full stage ``state`` (each layer's
        own ``tp_shard_state_dict``; whole where it has none)."""
        out = {}
        for prefix, (layer, part) in self._per_layer(state).items():
            fn = getattr(layer, "tp_shard_state_dict", None)
            part = fn(part, rank, size) if fn is not None else part
            out.update((prefix + k, v) for k, v in part.items())
        return out

    def tp_gather_state_dicts(self, shards):
        """Every model rank's stage state -> the full stage state."""
        out = {}
        for prefix, (layer, _) in self._per_layer(shards[0]).items():
            parts = [{k[len(prefix):]: v for k, v in s.items()
                      if k.startswith(prefix)} for s in shards]
            fn = getattr(layer, "tp_gather_state_dicts", None)
            whole = fn(parts) if fn is not None else parts[0]
            out.update((prefix + k, v) for k, v in whole.items())
        return out

    def tp_full_boxes(self, name, shard_shape, box, rank, size):
        """``tp_full_boxes`` of the parameter's layer (one box, as it is,
        where the layer has none)."""
        layer, inner, _, _ = self._layer_of(name)
        fn = getattr(layer, "tp_full_boxes", None)
        if fn is None:
            return tuple(shard_shape), [(tuple(box), ())]
        return fn(inner, shard_shape, box, rank, size)

    def tensor_parallel_shard(self, binding):
        """This stage with each layer replaced by its
        ``tensor_parallel_shard(binding)`` (layers without one stay, whole
        on every model rank); this module stays as it is."""
        def shard(layer):
            fn = getattr(layer, "tensor_parallel_shard", None)
            return fn(binding) if fn is not None else layer

        out = copy.copy(self)
        out._parameters, out._buffers = OrderedDict(), OrderedDict()
        out._modules = OrderedDict()
        out.tied = nn.ModuleDict(OrderedDict(
            (k, shard(m)) for k, m in self.tied.items()))
        out.pre = nn.ModuleDict(OrderedDict(
            (k, shard(m)) for k, m in self.pre.items()))
        out.body = nn.ModuleList(nn.ModuleList(shard(m) for m in chunk)
                                 for chunk in self.body)
        out.post = nn.ModuleDict(OrderedDict(
            (k, shard(m)) for k, m in self.post.items()))
        config = getattr(self, "config", None)
        if config is not None and hasattr(config, "collective_matmul"):
            out.config = copy.copy(config)
            out.config.collective_matmul = binding
        return out

    # ------------------------------------------------- the JAX tree layout
    def layout(self):
        """The stage layout a checkpoint records (``pipe_layout``)."""
        return {"parts": list(self.parts),
                "layers_per_stage": self.layers_per_stage,
                "num_virtual": self.num_virtual}

    def _param_shapes(self, layer):
        return OrderedDict((n, tuple(p.shape))
                           for n, p in layer.named_parameters())

    def pipe_tree_template(self):
        """The JAX module's tree of every stage (``{"tied", "pre",
        "post", "body"}``) with each leaf's full shape as a tuple."""
        S, v, L = self.num_stages, self.num_virtual, self.layers_per_stage
        lead = (S, L) if v == 1 else (S, v, L)

        def entry_tree(entries):
            return [_nest(self._param_shapes(layer))
                    if kind == "layer" and any(True for _ in
                                               layer.parameters())
                    else None for kind, _, layer in entries]

        proto = self.body_layers[0][2]
        return {
            "tied": {key: _nest(self._param_shapes(layer))
                     for key, layer in self.tied_keys.items()},
            "pre": entry_tree(self.pre_layers),
            "post": entry_tree(self.post_layers),
            "body": _nest(OrderedDict(
                (n, lead + s) for n, s in self._param_shapes(proto).items())),
        }

    def stage_state_from_tree(self, tree, layout=None):
        """The JAX module's tree (numpy arrays or tensors; stacked under
        ``layout``, default this module's) -> this stage's ``{name:
        tensor}`` with full (unsharded) leaves."""
        layout = layout or self.layout()
        out = OrderedDict()
        for name, _ in self.named_parameters():
            _, inner, path, slot = self._layer_of(name)
            if slot is None:
                out[name] = _tensor(_get(tree, path))
                continue
            c, j = slot
            g = self.body_ids(c)[j]
            idx = global_to_slot(layout, g)
            leaf = _get(tree, path)
            out[name] = _tensor(leaf[idx])
        return out

    def pipe_tree(self, stage_states):
        """Every stage's full ``{name: tensor}`` (``stage_states[s]``) ->
        the JAX module's tree in this module's layout (numpy; padded slots
        hold a copy of their stage's first layer, as the JAX module's
        ``_init_params`` fills them)."""
        S, v, L = self.num_stages, self.num_virtual, self.layers_per_stage
        template = self.pipe_tree_template()
        flat = {}
        body = {}
        for s, state in enumerate(stage_states):
            for name, value in state.items():
                value = np.asarray(value) if not isinstance(
                    value, torch.Tensor) else value.detach().cpu()
                head, rest = name.split(".", 1)
                if head != "body":
                    if head == "tied" and \
                            self.tied_owner(rest.split(".")[0]) != s:
                        continue
                    flat[name] = value
                    continue
                c, j, inner = rest.split(".", 2)
                body.setdefault(inner, {})[(s, int(c), int(j))] = value
        for inner, slots in body.items():
            shape = _get(template["body"], inner)
            first = next(iter(slots.values()))
            buf = torch.zeros(shape, dtype=first.dtype) \
                if isinstance(first, torch.Tensor) else \
                np.zeros(shape, first.dtype)
            for (s, c, j), value in slots.items():
                depth = self.parts[c * S + s + 1] - self.parts[c * S + s]
                for jj in [j] + (list(range(depth, L)) if j == 0 else []):
                    buf[(s, jj) if v == 1 else (s, c, jj)] = value
            flat["body." + inner] = buf
        tree = _nest(flat)
        out = {"tied": tree.get("tied", {}), "body": tree.get("body", {})}
        for head in ("pre", "post"):
            got = tree.get(head, {})
            out[head] = [got.get(str(i)) if t is not None else None
                         for i, t in enumerate(template[head])]
        return out

    def load_pipe_tree(self, tree, layout=None):
        """Load this stage's weights from the JAX module's tree (stacked
        under ``layout``, default this module's)."""
        return self.load_stage_state(self.stage_state_from_tree(tree, layout))

    def load_stage_state(self, state):
        """Copy ``{name: tensor or array}`` (every parameter of this stage)
        into the stage's parameters."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(_tensor(state[name]).reshape(p.shape).to(p.dtype))
        return self
