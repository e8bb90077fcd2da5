"""ZeRO stages 0-3 as flat-buffer partitions.

Port of ``deepspeed_tpu/runtime/zero/partition.py::ZeroShardingPlan``,
re-expressed for PyTorch. The JAX package shards each leaf of the train
state over the mesh's ``data`` axis (stage 1: master + optimizer state;
stage 2: + gradients; stage 3: + the compute-dtype parameters). Here the
state is a few flat buffers:

* one fp32 master buffer, the gradient accumulator (fp32, or bf16 with
  ``data_types.grad_accum_dtype``) and the optimizer moments
  (``exp_avg`` / ``exp_avg_sq``, Adam's, LAMB's or SGD's; fp32, or bf16
  with ``optimizer.params.moments_dtype``, as the JAX package's
  ``adam_init`` stores them): the optimizer works on each whole, with one
  kernel launch (Adam) or one per pass (LAMB's stage 1 and apply);
* the compute-dtype parameters: one flat buffer of which every
  ``nn.Parameter`` of the module is a view (at fp32 compute and a whole
  master it is the master buffer itself);
* the compute-dtype gradients: one flat buffer of which every
  parameter's ``.grad`` is a view, so autograd accumulates into it in
  place (a tied weight sums both uses there) and one ``add_`` (or one
  reduce-scatter) folds a micro-step into the accumulator.

Each parameter starts at a multiple of :data:`ALIGN` elements (padding
stays zero in every buffer: Adam and LAMB map p = g = m = v = 0 to zeros,
so padding adds nothing to a LAMB norm either).

Data parallelism over a ``group`` of ``dp_world`` ranks, stages 0-2: the
buffers' length is padded to a multiple of ``dp_world * ALIGN`` and rank
r owns ``[lo, hi) = [r * P, (r + 1) * P)``, P = numel / dp_world. From
stage 1 the master and both moments hold only the owned range; from stage
2 the accumulator too (the engine reduce-scatters each micro-step's
gradients into it). The compute-dtype ``params`` and ``grads`` stay
whole: the forward reads every parameter and autograd writes every
gradient. :meth:`refresh_params` all-gathers the updated owned ranges
into ``params`` (the reference's stage-1/2 parameter all-gather,
``stage1.py:624-708``). At stage 0, or one rank, the owned range is the
whole buffer and nothing is gathered.

Stage 3: the layout is cut into gather units (``units``: the model's
``zero3_units``, e.g. GPT-2's embedding, each block and ``ln_f``; one
unit of every parameter otherwise), each laid out whole and padded to a
multiple of ``dp_world * ALIGN``, and rank r owns the r-th 1/dp_world
piece of each unit: its owned part is one piece a unit (``spans``: the
``(global lo, global hi, local offset)`` of each), and the master,
moments, accumulator AND the compute-dtype ``params`` hold only those
pieces, concatenated. A unit's full parameters exist only while
``runtime/zero/stage3.py`` has gathered it (one ``all_gather_into`` a
unit); the leaves the JAX plan keeps replicated (under
``stage3_param_persistence_threshold``, or with no dimension the data
degree divides; ``stage3_max_live_parameters`` demotes the largest of
them first, :func:`stage3_persistence`) form one more unit, laid out
first, that stays gathered in ``persist`` between steps. Each unit's
gradient is reduce-scattered into the rank's accumulator piece as soon
as its backward ends (:meth:`deposit`, :meth:`reduce_unit`); the
persistent unit's once a micro-step (:meth:`fold_grads`). Every stage
sums in the accumulator's dtype, so stage 3 gives stage 2's bits. At one
rank the JAX plan shards no leaf, so the engine builds stage 2's layout
there; a ``zero.Init`` store keeps this layout at any size.

ZeRO-Offload (``offload``): the master and both moments (fp32) live in
host memory, this rank's owned part only; the accumulator and the
compute-dtype parameters stay on the device, and
``runtime/zero/offload.py`` steps the host state. Streamed parameter
offload (``streamed``, one rank, stage 2's whole layout) keeps the
compute-dtype parameters in host memory too (pinned when the device is
CUDA) and the fp32 accumulator there: no parameter has a resident device
copy, and ``runtime/zero/stream.py`` uploads them a layer group at a
time.

``segments`` is the segment table of the owned part, one ``(offset,
numel)`` per parameter (per JAX leaf), offsets local to the owned part
and each parameter clipped to it (0 elements where the rank holds none
of it), so entry i names the same leaf on every rank: LAMB takes one
trust ratio per segment from its sums over the data group.

Under tensor parallelism each rank's module holds its own shards, and
each rank keeps one such set of buffers over them. The parameters every
rank holds whole (``replicated``: layer norms, ``wpe``, the proj biases)
are laid out first (stages 0-2: ``[0, replicated_end)`` of the layout;
stage 3: first within each unit), so they are a few slices the engine
all-reduces over the ring and counts once in the global norm:
``own_replicated``, ranges of the owned part (stages 0-2 one,
``[0, own_replicated_end)``). Model ranks at one data coordinate hold the
same layout and so own the same ranges.

ZeRO++ (``runtime/zero/zeropp.py``). hpZ (``shard_group`` and
``replica_group``, the data group factored as ``factor_data_axis`` does:
data rank r is shard ``r % N`` of replica ``r // N``): the master,
moments and accumulator keep the pieces above, one per rank of the whole
data group, while the compute-dtype parameters are held by the N-rank
shard group: rank r keeps the primary pieces of its replica group (the
ranks of its shard index), ``param_rows`` ``(R, part_numel)``, row rho
the pieces of rank ``rho * N + r % N`` and ``params`` its own row. A
unit's gather then runs over the shard group and one transpose puts the
pieces in unit order; after the apply step each rank's updated pieces
reach the others of its replica group in one all-gather. The unit
reduce-scatter stays over the whole data group. Without hpZ the shard
group is the data group and ``param_rows`` one row. ``gatherer``
(:class:`~.zeropp.UnitGather`) gathers the units: one all-gather, qwZ's
int8 lanes with their scales, or a ring. qgZ (``grad_codec``,
:class:`~.zeropp.GradCodec`): each reduce-scattered gradient piece goes
through the error-compensated int8 codec (``qg_error``, fp32, partitioned
like the accumulator) before it is added.

Held leaves (:meth:`hold`, stage 3): the gradients of the named leaves
(a pipeline's tied embedding) bypass their unit's reduce-scatter and sum
whole, in fp32, in ``held_acc``, as stage 2 keeps the pipeline's tied
slice whole; the engine reduces them and adds the owned parts into the
accumulator (:meth:`fold_held`).
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ...utils.distributed import (GLOO, all_gather, all_gather_into,
                                  reduce_scatter)
from ..comm.quantize import WIRE
from .zeropp import GradCodec, UnitGather

ALIGN = 64      # elements: 128-byte aligned bf16 views, 256-byte fp32


def _numel(shape):
    return int(np.prod(shape)) if shape else 1


def _padded(n, unit=ALIGN):
    return -(-n // unit) * unit


# ---------------------------------------- the JAX plan's host logic (copy)


def jax_path(name):
    """A ``state_dict`` name -> the JAX tree path the plan keys on
    (``blocks.0.attn.qkv_bias`` -> ``blocks/0/attn/qkv_bias``)."""
    return name.replace(".", "/")


def data_sharded(shape, threshold, ways):
    """Whether the JAX plan shards a stage-3 leaf of ``shape`` over a data
    degree of ``ways`` (``ZeroShardingPlan._zero_spec`` without a
    tensor-parallel spec): not under ``max(threshold, ways)`` elements,
    not a scalar, and some dimension ``ways`` divides."""
    if ways <= 1 or not shape or _numel(shape) < max(threshold, ways):
        return False
    return any(size % ways == 0 for size in shape)


def stage3_persistence(named_shapes, threshold, ways, max_live=None):
    """The leaves the JAX plan keeps whole at stage 3, and the live
    budget's demotions (``ZeroShardingPlan.configure_live_budget``):
    persistent leaves are demoted to data-sharded, largest first (ties by
    JAX path), while their elements exceed ``max_live``; a leaf no
    dimension of which the degree divides cannot be demoted. Returns
    ``(persistent names in the given order, sorted demoted JAX paths,
    persistent elements or None when no budget applies)``."""
    persistent = [(name, shape) for name, shape in named_shapes
                  if not data_sharded(shape, threshold, ways)]
    if max_live is None:
        return [n for n, _ in persistent], (), None
    entries = [(_numel(shape), jax_path(name), data_sharded(shape, 0, ways))
               for name, shape in persistent]
    total = sum(n for n, _, _ in entries)
    demoted = set()
    for numel, path, demotable in sorted(entries, reverse=True):
        if total <= max_live:
            break
        if not demotable:
            continue
        demoted.add(path)
        total -= numel
    keep = [n for n, _ in persistent if jax_path(n) not in demoted]
    return keep, tuple(sorted(demoted)), total


# ------------------------------------------------------------ the buffers


class FlatPartition:
    """The flat buffers of one module's parameters and their views, and
    this rank's share of them over a data-parallel ``group``."""

    def __init__(self, module, device, compute_dtype,
                 accum_dtype=torch.float32, replicated=(),
                 moments_dtype=torch.float32, group=None, stage=0,
                 offload=False, units=None, persistence_threshold=100000,
                 max_live_parameters=None, train_state=True,
                 local_grads=False, streamed=False, shard_group=None,
                 replica_group=None):
        self.device, self.compute_dtype = device, compute_dtype
        self.group = group
        self.stage = stage
        self.streamed = bool(streamed)
        self.offload = bool(offload) or self.streamed
        self.dp_world = dist.get_world_size(group) if group is not None \
            else 1
        self.dp_rank = dist.get_rank(group) if group is not None else 0
        self.stage3 = stage >= 3
        # hpZ: the compute-dtype pieces over the shard group of N ranks
        hpz = shard_group is not None and self.stage3
        self.gather_group = shard_group if hpz else group
        self.shard_world = dist.get_world_size(shard_group) if hpz \
            else self.dp_world
        self.replicas = self.dp_world // self.shard_world
        self.replica_group = replica_group if hpz else None
        self.replica_rank = self.dp_rank // self.shard_world
        named = list(module.named_parameters())
        shape_of = {n: tuple(getattr(p, "ds_shape", p.shape))
                    for n, p in named}
        self.names, self.shapes, self.offsets = [], [], []
        self.persistent, self.demoted, self.persistent_numel = [], (), None
        replicated = set(replicated)
        if self.stage3:
            groups = self._stage3_groups(named, shape_of, units,
                                         persistence_threshold,
                                         max_live_parameters, replicated,
                                         self.shard_world)
        else:
            groups = [("all", [n for n, _ in named if n in replicated] +
                       [n for n, _ in named if n not in replicated])]
        params_by_name = dict(named)
        unit = ALIGN * self.dp_world
        # each unit: (name, start, padded numel, [leaf indices])
        self.units = []
        self.replicated_end = 0
        # per unit, one past its replicated leaves (they lead the unit)
        unit_rep_end = []
        total = 0
        for uname, leaf_names in groups:
            start, leaves = total, []
            rep_end = start
            for name in leaf_names:
                leaves.append(len(self.names))
                self.names.append(name)
                self.shapes.append(shape_of[name])
                self.offsets.append(total)
                total += _padded(_numel(shape_of[name]))
                if name in replicated:
                    rep_end = total
                    if not self.stage3:
                        self.replicated_end = total
            total = start + _padded(total - start, unit)
            self.units.append((uname, start, total - start, leaves))
            unit_rep_end.append(rep_end)
        self.numel = total
        self.sharded = self.dp_world > 1 and stage >= 1
        # (global lo, global hi, local offset) of each owned piece
        self.spans = self._spans_of(self.dp_rank)
        self.part_numel = sum(hi - lo for lo, hi, _ in self.spans)
        if self.stage3:
            self.lo = self.hi = None
        else:
            self.lo, self.hi = self.spans[0][0], self.spans[0][1]
        self.own_replicated_end = 0 if self.stage3 else min(
            max(self.replicated_end - self.lo, 0), self.part_numel)
        # the replicated leaves' ranges of the owned part
        self.own_replicated = []
        for (_, start, _, _), (lo, hi, local), rep_end in zip(
                self.units, self.spans, unit_rep_end):
            a, b = max(lo, start), min(hi, rep_end)
            if a < b:
                self.own_replicated.append((local + a - lo, local + b - lo))
        # the indices of the leaves a rank holds a shard of (stage 3's
        # LAMB trust ratios over the ring)
        self.sharded_leaves = tuple(i for i, n in enumerate(self.names)
                                    if n not in replicated)
        self.unit_of = {}
        for u, (_, _, _, leaves) in enumerate(self.units):
            for i in leaves:
                self.unit_of[self.names[i]] = u
        self.mixed = compute_dtype != torch.float32
        module_params = [params_by_name[n] for n in self.names]
        own = self._initial_own(module, module_params)
        self.segments = torch.tensor(
            [self._clip(i) for i in range(len(self.names))],
            dtype=torch.int64, device=device).reshape(-1, 2)
        host = torch.device("cpu")
        if self.stage3:
            # the pieces of this rank's replica group, own row included
            self.param_rows = own.to(compute_dtype).reshape(
                self.replicas, self.part_numel)
            self.params = self.param_rows[self.replica_rank]
            own = own.reshape(self.replicas, -1)[self.replica_rank]
            self.master = own.to(host) if self.offload else \
                (own if self.replicas == 1 else own.clone())
        elif self.streamed:
            # one rank: the whole layout, already in host memory
            self.master = own
            self.params = torch.empty(
                self.numel, dtype=compute_dtype,
                pin_memory=torch.device(device).type == "cuda")
            self.params.copy_(own)
        else:
            whole = own
            own = whole[self.lo:self.hi]
            self.master = own.to(host, copy=True) if self.offload else \
                (own.clone() if self.sharded else whole)
            self.params = whole.to(compute_dtype) if self.mixed else whole
        del own
        state_device = host if self.offload else device
        if self.offload:
            moments_dtype = torch.float32
        # local_grads (OneBitAdam): the accumulator stays whole and this
        # rank's own; nothing is reduced when a micro-step is folded
        self.grads_sharded = self.sharded and stage >= 2 and not local_grads
        # the in-collective exchange (comm.quantized_collectives): a
        # callable averaging the whole compute-dtype grads over the group
        # in place, which fold_grads runs in place of the reduce-scatter
        self.exchange = None
        if train_state:
            self.acc = torch.zeros(self.part_numel if self.grads_sharded or
                                   self.stage3 else self.numel,
                                   dtype=accum_dtype,
                                   device=host if self.streamed else device)
            self.exp_avg = torch.zeros(self.part_numel, dtype=moments_dtype,
                                       device=state_device)
            self.exp_avg_sq = torch.zeros(self.part_numel,
                                          dtype=moments_dtype,
                                          device=state_device)
        else:
            # the parameters only (zero.Init's store)
            self.master = self.acc = self.exp_avg = self.exp_avg_sq = None
        self.step = 0
        self._module_params = module_params
        self._pending = {}
        self.held, self.held_acc = {}, None
        # qgZ (enable_grad_codec) and the unit gather (stage 3)
        self.grad_codec = self.qg_error = None
        self.qg_scale = 1.0
        self.gatherer = None
        if self.stage3:
            self.gatherer = UnitGather(self)
            self._init_stage3_views(module_params)
        elif self.streamed:
            # no resident device copy: the leaves hold an empty placeholder
            self.grads = None
            placeholder = torch.empty(0, dtype=compute_dtype, device=device)
            for p, shape in zip(module_params, self.shapes):
                p.grad = None
                p.data = placeholder
                p.ds_shape = shape
        else:
            self.grads = torch.zeros(self.numel, dtype=compute_dtype,
                                     device=device)
            for p, off, shape in zip(module_params, self.offsets,
                                     self.shapes):
                n = _numel(shape)
                p.data = self.params[off:off + n].view(shape)
                p.grad = self.grads[off:off + n].view(shape)

    # ------------------------------------------------------------- layout

    def _stage3_groups(self, named, shape_of, units, threshold, max_live,
                       replicated=(), ways=None):
        """Stage 3's units: the persistent leaves first (one unit), then
        each of ``units``' ``(name, [parameter names])`` with its
        data-sharded leaves (units left empty dropped); within each unit
        the ``replicated`` leaves (tensor parallelism) lead."""
        names = [n for n, _ in named]
        if units is None:
            units = [("module", names)]
        listed = [n for _, members in units for n in members]
        if sorted(listed) != sorted(names):
            raise ValueError(
                "zero3 units must list every parameter once: missing {}, "
                "extra {}".format(sorted(set(names) - set(listed))[:5],
                                  sorted(set(listed) - set(names))[:5]))
        keep, self.demoted, self.persistent_numel = stage3_persistence(
            [(n, shape_of[n]) for n in names], threshold,
            self.dp_world if ways is None else ways, max_live)
        self.persistent = keep
        persistent = set(keep)
        groups = [("persistent", keep)] if keep else []
        groups += [(uname, [n for n in members if n not in persistent])
                   for uname, members in units]
        return [(uname, [n for n in members if n in replicated] +
                 [n for n in members if n not in replicated])
                for uname, members in groups if members]

    def _initial_own(self, module, module_params):
        """The fp32 values of the owned part (stage 3) or of the whole
        layout (stages 0-2), on the device: from the module's parameters,
        or from a ``zero.Init`` module's partitioned store (its own pieces
        when its layout is this one, else its gathered leaves)."""
        store = getattr(module, "_zero3_store", None)
        if store is not None and self.stage3 and \
                store.layout_key() == self.layout_key():
            return store.local.to(self.device, torch.float32, copy=True)
        values = store.gather_full() if store is not None else None
        whole = torch.zeros(self.numel, dtype=torch.float32,
                            device="cpu" if self.streamed else self.device)
        for name, p, off, shape in zip(self.names, module_params,
                                       self.offsets, self.shapes):
            src = values[name] if values is not None else p.detach()
            whole[off:off + _numel(shape)].copy_(src.reshape(-1))
        if not self.stage3:
            return whole
        # stage 3: this rank's pieces, or (hpZ) its replica group's, by row
        first = self.dp_rank - self.replica_rank * self.shard_world
        return torch.cat([whole[lo:hi] for rho in range(self.replicas)
                          for lo, hi, _ in self._spans_of(
                              rho * self.shard_world + first)])

    def _spans_of(self, rank):
        """``spans`` of data rank ``rank``: the rank-th 1/dp_world piece of
        each unit (stages 0-2: of the one unit, the layout)."""
        spans, local = [], 0
        for _, start, n, _ in self.units:
            part = n // self.dp_world if self.sharded else n
            lo = start + rank * part if self.sharded else start
            spans.append((lo, lo + part, local))
            local += part
        return spans

    def secondary_ranges(self, u, shard):
        """The ranges of unit ``u`` (unit offsets) that shard rank
        ``shard`` holds, in its piece's order: the primary pieces of its
        replica group."""
        n = self.units[u][2] // self.dp_world
        return [((rho * self.shard_world + shard) * n,
                 (rho * self.shard_world + shard + 1) * n)
                for rho in range(self.replicas)]

    def secondary_numel(self, u):
        return self.units[u][2] // self.shard_world

    def secondary_piece(self, u):
        """This rank's compute-dtype piece of unit ``u`` over the shard
        group, contiguous (a copy under hpZ)."""
        lo, hi, local = self.spans[u]
        rows = self.param_rows[:, local:local + hi - lo]
        return rows[0] if self.replicas == 1 else rows.reshape(-1)

    def unit_order(self, u, lanes):
        """A unit gathered over the shard group (each rank's piece in
        group order) -> unit order: under hpZ the ``(shard, replica,
        piece)`` blocks transposed."""
        if self.replicas == 1:
            return lanes
        n = self.units[u][2] // self.dp_world
        return lanes.view(self.shard_world, self.replicas, n).transpose(
            0, 1).reshape(-1)

    def configure_gather(self, quantized=False, ring=None):
        """Unit gathers with qwZ (``quantized``) and/or as a ring of
        ``ring`` chunks a hop (``zeropp.UnitGather``)."""
        self.gatherer = UnitGather(self, quantized=quantized, ring=ring)

    def enable_grad_codec(self):
        """qgZ: every reduce-scattered gradient piece through the
        error-compensated codec, ``qg_error`` (fp32, the accumulator's
        size) carrying the residual."""
        self.grad_codec = GradCodec(self)
        self.qg_error = torch.zeros(self.acc.numel(), dtype=torch.float32,
                                    device=self.acc.device)

    def _qgz(self, u, piece, err):
        """A summed gradient piece through qgZ (as is without it), in the
        accumulator's dtype."""
        if self.grad_codec is None:
            return piece
        return self.grad_codec.apply(u, piece, err, self.qg_scale).to(
            self.acc.dtype)

    def layout_key(self):
        """What two partitions must share for one's pieces to be the
        other's: names, shapes, units and the rank's place."""
        return (tuple(self.names), tuple(self.shapes),
                tuple((u[1], u[2]) for u in self.units), self.dp_world,
                self.dp_rank, self.stage3, self.shard_world)

    def _clip(self, i):
        """Parameter i's ``(offset, numel)`` in the owned part (offset
        local to it)."""
        off, n = self.offsets[i], _numel(self.shapes[i])
        lo, hi, local = self.spans[self.unit_of[self.names[i]]]
        a = min(max(off, lo), hi)
        b = min(max(off + n, lo), hi)
        return local + a - lo, b - a

    def layout_signature(self):
        """What the model ranks of one data coordinate must share: the
        layout's size, the owned pieces and the replicated ranges."""
        return [self.numel, self.part_numel] + \
            [x for span in self.spans for x in span] + \
            [x for r in self.own_replicated for x in r]

    def owned_ranges(self, indices):
        """The ranges ``[(a, b), ...]`` of the owned part that hold the
        leaves ``indices`` (local offsets)."""
        out = []
        for i in indices:
            off, n = self.offsets[i], _numel(self.shapes[i])
            for lo, hi, local in self.spans:
                a, b = max(off, lo), min(off + n, hi)
                if a < b:
                    out.append((local + a - lo, local + b - lo))
        return sorted(out)

    def state_bytes(self):
        """Bytes this rank holds of master, moments and accumulator."""
        return {name: t.numel() * t.element_size() for name, t in (
            ("master", self.master), ("exp_avg", self.exp_avg),
            ("exp_avg_sq", self.exp_avg_sq), ("acc", self.acc))}

    def param_bytes(self):
        """Bytes of compute-dtype parameters this rank keeps between
        steps: the whole buffer (stages 0-2), or its pieces plus the
        gathered persistent unit (stage 3)."""
        if self.streamed:
            return 0
        params = self.param_rows if self.stage3 else self.params
        size = params.numel() * params.element_size()
        if self.stage3 and self.sharded and self.persist is not None:
            size += self.persist.numel() * self.persist.element_size()
        return size

    # ------------------------------------------------------------ stage 3

    def _init_stage3_views(self, module_params):
        """Persistent leaves view the gathered persistent unit; the others
        hold an empty placeholder until their unit is gathered."""
        self.grads = None
        self.persist_unit = 0 if self.persistent else None
        self._placeholder = torch.empty(0, dtype=self.compute_dtype,
                                        device=self.device)
        self.persist = self.persist_grads = None
        if self.persist_unit is not None:
            _, start, n, _ = self.units[0]
            if self.sharded:
                self.persist = torch.empty(n, dtype=self.compute_dtype,
                                           device=self.device)
            else:
                self.persist = self.params[:n]
            self.persist_grads = torch.zeros(n, dtype=self.compute_dtype,
                                             device=self.device)
            self.gather_persistent()
        for i, p in enumerate(module_params):
            p.grad = None
            p.ds_shape = self.shapes[i]
            if self.unit_of[self.names[i]] == self.persist_unit:
                off = self.offsets[i]
                p.data = self.persist[off:off + _numel(self.shapes[i])].view(
                    self.shapes[i])
            else:
                p.data = self._placeholder

    def unit_leaves(self, u):
        """``[(parameter, offset in the unit, shape)]`` of unit ``u``."""
        _, start, _, leaves = self.units[u]
        return [(self._module_params[i], self.offsets[i] - start,
                 self.shapes[i]) for i in leaves]

    def gather_persistent(self):
        """The persistent unit's pieces all-gathered into ``persist``."""
        if self.persist_unit is None or not self.sharded:
            return
        piece = self.secondary_piece(0)
        with record_function("zero3.all_gather"):
            if self.replicas == 1:
                all_gather_into(self.persist, piece, self.gather_group)
            else:
                self.persist.copy_(self.unit_order(
                    0, all_gather(piece, self.gather_group)))

    def gather_unit(self, u, pending=None):
        """Unit ``u``'s full compute-dtype buffer: its pieces gathered over
        the shard group by ``gatherer`` (``pending``: its gather already
        started, ``gatherer.start(u)``); its leaves are then views of it.
        (The engine partitions only over two or more ranks: at one rank
        stage 3 is stage 2's layout.)"""
        if u == self.persist_unit:
            return self.persist
        with record_function("zero3.all_gather"):
            if pending is None:
                pending = self.gatherer.start(u)
            full = pending.finish()
        for p, off, shape in self.unit_leaves(u):
            p.data = full[off:off + _numel(shape)].view(shape)
        return full

    def release_unit(self, u):
        """Unit ``u``'s leaves back to the placeholder (the gathered
        buffer frees with its last reference)."""
        if u == self.persist_unit:
            return
        for p, _, _ in self.unit_leaves(u):
            p.data = self._placeholder

    def hold(self, names):
        """Keep the gradients of the leaves ``names`` whole, in fp32, in
        ``held_acc`` (stage 3; see the module docstring)."""
        self.held, total = {}, 0
        for name in names:
            i = self.names.index(name)
            self.held[i] = (total, _numel(self.shapes[i]))
            total += _numel(self.shapes[i])
        self.held_acc = torch.zeros(total, dtype=torch.float32,
                                    device=self.device)

    def fold_held(self):
        """The held gradients' owned parts added into the accumulator (in
        its dtype), then ``held_acc`` zeroed."""
        for i, (o, n) in self.held.items():
            off = self.offsets[i]
            for lo, hi, local in self.spans:
                a, b = max(off, lo), min(off + n, hi)
                if a < b:
                    self.acc[local + a - lo:local + b - lo].add_(
                        self.held_acc[o + a - off:o + b - off].to(
                            self.acc.dtype))
        self.held_acc.zero_()

    def deposit(self, u, grads):
        """Add the gradients ``grads`` (one per leaf of unit ``u``, None
        where unused) into the unit's compute-dtype gradient buffer, as
        autograd adds into a ``.grad`` (a held leaf's into ``held_acc``)."""
        if self.held:
            rest = []
            for i, g in zip(self.units[u][3], grads):
                if i in self.held and g is not None:
                    o, n = self.held[i]
                    self.held_acc[o:o + n].add_(g.reshape(-1))
                    g = None
                rest.append(g)
            grads = rest
            if all(g is None for g in grads):
                return
        if u == self.persist_unit:
            buf = self.persist_grads
        else:
            buf = self._pending.get(u)
            if buf is None:
                buf = self._pending[u] = torch.zeros(
                    self.units[u][2], dtype=self.compute_dtype,
                    device=self.device)
        for (_, off, shape), g in zip(self.unit_leaves(u), grads):
            if g is not None:
                buf[off:off + _numel(shape)].view(shape).add_(g)

    def reduce_unit(self, u):
        """Unit ``u``'s summed gradient reduce-scattered, in the
        accumulator's dtype, into the rank's accumulator piece; the
        unit's buffer freed."""
        buf = self._pending.pop(u, None)
        if buf is not None:
            self._fold_unit(u, buf)

    def _fold_unit(self, u, buf):
        lo, hi, local = self.spans[u]
        with record_function("zero3.reduce_scatter"):
            part = reduce_scatter(buf.to(self.acc.dtype), self.group)
        WIRE.add((self.dp_world - 1) * part.numel() * part.element_size(),
                 kind="reduce")
        err = self.qg_error[local:local + hi - lo] \
            if self.qg_error is not None else None
        self.acc[local:local + hi - lo].add_(self._qgz(u, part, err))

    # ------------------------------------------------------------ updates

    def own(self, flat):
        """The owned part of a whole buffer (a partition-sized one as it
        is)."""
        return flat if flat.numel() == self.part_numel else \
            flat[self.lo:self.hi]

    def fold_grads(self):
        """acc += grads (one add), then zero the compute-dtype grads. At
        stage 2 over a group the grads are first reduce-scattered over it
        in the accumulator's dtype, the dtype every stage sums in (one
        collective a micro-step, the reference's IPG bucket
        reduce-scatter), and the owned slice of the sum is added. With an
        ``exchange`` (the int8 ring) the grads are averaged by it instead
        and the owned part of the average added. At
        stage 3 every gather unit was reduced when its backward ended:
        the persistent unit's gradients are folded here."""
        if self.stage3:
            if self._pending:
                raise RuntimeError(
                    "zero3: units {} were never reduced (their backward "
                    "did not end)".format(sorted(self._pending)))
            if self.persist_unit is not None:
                self._fold_unit(self.persist_unit, self.persist_grads)
                self.persist_grads.zero_()
            return
        if self.exchange is not None:
            with record_function("comm.quantized_exchange"):
                mean = self.exchange(self.grads)
            self.acc.add_(mean[self.lo:self.hi] if self.grads_sharded
                          else mean)
        elif self.grads_sharded:
            with record_function("zero.reduce_scatter"):
                part = reduce_scatter(self.grads.to(self.acc.dtype),
                                      self.group)
            self.acc.add_(self._qgz(0, part, self.qg_error))
        elif self.grad_codec is not None:
            self.acc.add_(self._qgz(0, self.grads, self.qg_error))
        else:
            self.acc.add_(self.grads)
        self.grads.zero_()

    def own_params(self):
        """The compute-dtype parameters of the owned part (a view)."""
        return self.params if self.stage3 else self.params[self.lo:self.hi]

    def gather_params(self):
        """After the owned part of ``params`` changed: every rank's part
        all-gathered into the whole buffer (stages 1-2), or the
        persistent unit re-gathered (stage 3)."""
        if self.stage3:
            if self.replicas > 1:
                with record_function("zero3.hpz_all_gather"):
                    all_gather_into(self.param_rows.view(-1), self.params,
                                    self.replica_group)
            self.gather_persistent()
        elif self.sharded:
            with record_function("zero.all_gather"):
                all_gather_into(self.params, self.own_params(), self.group)

    def refresh_params(self):
        """master -> compute-dtype params: the owned part cast (from host
        memory under offload), then (when partitioned) gathered. A no-op
        at fp32 compute when the params are views of the whole master."""
        if self.sharded or self.stage3 or self.offload:
            self.own_params().copy_(self.master)
            self.gather_params()
        elif self.mixed:
            self.params.copy_(self.master)

    def check_views(self):
        """True while every parameter and ``.grad`` still views the flat
        buffers (autograd accumulated in place); at stage 3, while the
        persistent leaves view ``persist``, the others hold the
        placeholder and no ``.grad`` exists."""
        if self.stage3:
            _, start, _, _ = self.units[0]
            for i, p in enumerate(self._module_params):
                if p.grad is not None:
                    return False
                if self.unit_of[self.names[i]] == self.persist_unit:
                    ok = p.data_ptr() == \
                        self.persist[self.offsets[i] - start:].data_ptr()
                else:
                    ok = p.numel() == 0
                if not ok:
                    return False
            return True
        return all(
            p.data_ptr() == self.params[off:].data_ptr() and
            p.grad is not None and
            p.grad.data_ptr() == self.grads[off:].data_ptr()
            for p, off in zip(self._module_params, self.offsets))

    # ------------------------------------------------------- JAX-shaped

    def whole(self, flat):
        """A buffer over the whole layout: a partition-sized one gathered
        over the data group (every rank of it must call; a host buffer
        crosses an NCCL group through the device), a whole one as it
        is."""
        if not self.sharded or flat.numel() != self.part_numel:
            return flat
        src = flat.detach()
        if src.device.type == "cpu" and \
                dist.get_backend(self.group) != GLOO:
            src = src.to(self.device)
        gathered = all_gather(src, self.group)
        if not self.stage3:
            return gathered
        rows = gathered.view(self.dp_world, self.part_numel)
        out = torch.empty(self.numel, dtype=gathered.dtype,
                          device=gathered.device)
        for (_, start, n, _), (lo, hi, local) in zip(self.units,
                                                     self.spans):
            out[start:start + n] = rows[:, local:local + hi - lo].reshape(-1)
        return out

    def tree_of(self, flat, keep_dtype=False):
        """A flat buffer (whole, or this rank's partition: then gathered
        over the data group, every rank must call) -> ``{dotted name:
        fp32 CPU tensor}`` (the ``state_dict`` naming of the module; a bf16
        buffer's values are exact in fp32), or in the buffer's own dtype
        with ``keep_dtype``."""
        host = self.whole(flat).detach()
        host = host.cpu() if keep_dtype else host.float().cpu()
        out = {}
        for name, off, shape in zip(self.names, self.offsets, self.shapes):
            out[name] = host[off:off + _numel(shape)].reshape(shape).clone()
        return out

    def load(self, flat, state):
        """``{dotted name: tensor}`` (whole tensors) -> into a flat buffer,
        whole or this rank's partition (each parameter sliced to the
        owned part), cast to its dtype: values a bf16 buffer can hold
        load bit for bit."""
        spans = self.spans if flat.numel() == self.part_numel \
            else [(0, self.numel, 0)]
        for i, (name, off, shape) in enumerate(zip(self.names, self.offsets,
                                                   self.shapes)):
            n = _numel(shape)
            for lo, hi, local in spans:
                a, b = max(off, lo), min(off + n, hi)
                if a < b:
                    src = torch.as_tensor(state[name]).reshape(-1)[
                        a - off:b - off]
                    flat[local + a - lo:local + b - lo].copy_(
                        src.to(flat.dtype))
