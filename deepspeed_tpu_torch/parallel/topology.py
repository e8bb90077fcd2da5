"""Named-axis meshes of ``torch.distributed`` process groups.

Port of ``deepspeed_tpu/parallel/topology.py``: the axis names,
``build_mesh(data=, model=, pipe=)``, the rank <-> coordinate maps
(``ProcessTopology`` and its pipe-data(-model) forms) and ``MeshGrid``,
the ``mpu`` a ``PipelineModule`` hands to the engine. Where the JAX
package builds one ``jax.sharding.Mesh`` whose axis names address
collectives inside ``jit``, here a :class:`ProcessMesh` holds one process
group per axis coordinate. Axis order is the JAX package's: ``pipe``
outermost, then ``data``, then ``model`` innermost, so the ranks of one
model group are adjacent (rank = p * data * model + d * model + m).
"""
from collections import namedtuple
from itertools import product as cartesian_product

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
# the data axis factored into (replica, shard) sub-axes, shard inner
# (stride 1 in data order), as the JAX package's factor_data_axis
DATA_REPLICA_AXIS = "data_replica"
DATA_SHARD_AXIS = "data_shard"


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


class ProcessMesh:
    """A ``(pipe, data, model)`` grid over the default group's ranks.
    ``shape`` maps axis name -> size as ``jax.sharding.Mesh.shape`` does
    (``pipe`` only when it is > 1); :meth:`get_group` is this rank's group
    along an axis. With a pipe axis the mesh also holds, along each
    ``(data, model)`` line, one two-rank group for each pair of adjacent
    stages, the last and the first stage included (the interleaved
    pipeline's wrap hop, and the tied embedding's pair):
    :meth:`pair_group`."""

    def __init__(self, data, model, pipe=1):
        world = _world()
        if data * model * pipe != world:
            raise ValueError(
                "mesh pipe={} x data={} x model={} needs {} ranks, the "
                "process group has {}".format(pipe, data, model,
                                              pipe * data * model, world))
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        if pipe > 1:
            self.shape = {PIPE_AXIS: pipe, DATA_AXIS: data, MODEL_AXIS: model}
        rank = dist.get_rank() if dist.is_initialized() else 0
        dm = data * model
        self._coords = {PIPE_AXIS: rank // dm, DATA_AXIS: rank % dm // model,
                        MODEL_AXIS: rank % model}
        self._groups = {}
        self._pairs = {}
        if not dist.is_initialized():
            return
        me_p, me_d, me_m = (self._coords[a] for a in
                            (PIPE_AXIS, DATA_AXIS, MODEL_AXIS))

        def rank_of(p, d, m):
            return p * dm + d * model + m

        # every rank creates every group, in the same order
        for p in range(pipe):
            for d in range(data):
                group = self._new_group([rank_of(p, d, m)
                                         for m in range(model)])
                if (p, d) == (me_p, me_d):
                    self._groups[MODEL_AXIS] = group
        for p in range(pipe):
            for m in range(model):
                group = self._new_group([rank_of(p, d, m)
                                         for d in range(data)])
                if (p, m) == (me_p, me_m):
                    self._groups[DATA_AXIS] = group
        if pipe == 1:
            return
        for d in range(data):
            for m in range(model):
                group = self._new_group([rank_of(p, d, m)
                                         for p in range(pipe)])
                if (d, m) == (me_d, me_m):
                    self._groups[PIPE_AXIS] = group
        pairs = sorted({tuple(sorted((p, (p + 1) % pipe)))
                        for p in range(pipe)})
        for d in range(data):
            for m in range(model):
                for a, b in pairs:
                    ranks = [rank_of(a, d, m), rank_of(b, d, m)]
                    group = self._new_group(ranks)
                    if (d, m) == (me_d, me_m):
                        self._pairs[(a, b)] = (group, tuple(ranks))

    @staticmethod
    def _new_group(ranks):
        if len(ranks) == dist.get_world_size():
            return dist.group.WORLD
        return dist.new_group(ranks)

    def get_group(self, axis):
        """This rank's process group along ``axis`` (None without a
        process group, where every axis has size 1)."""
        return self._groups.get(axis)

    def stage_rank(self, stage):
        """The global rank of pipe stage ``stage`` on this rank's
        ``(data, model)`` line."""
        dm = self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]
        rank = dist.get_rank() if dist.is_initialized() else 0
        return stage * dm + rank % dm

    def pair_group(self, a, b):
        """``(group, (global rank of a, global rank of b))`` of stages
        ``a`` and ``b`` (adjacent, or the last and the first) on this rank's
        line; ``(None, None)`` without a process group or a pipe axis."""
        key = tuple(sorted((a, b)))
        return self._pairs.get(key, (None, None))


def factor_data_axis(mesh, shard_size):
    """Factor ``mesh``'s data axis into ``(data_replica, data_shard)`` of
    sizes ``(data // shard_size, shard_size)``, as the JAX package's
    ``factor_data_axis`` (shard inner: data coordinate d is shard d %
    shard of replica d // shard): a copy of the mesh whose ``shape`` gains
    both sizes and which holds both sub-groups; every rank and group keeps
    its number, and the given mesh is unchanged. Every rank must call (it
    makes the sub-groups)."""
    import copy
    data = mesh.shape[DATA_AXIS]
    shard_size = int(shard_size)
    if shard_size <= 1 or data % shard_size:
        raise ValueError(
            "the data shard size {} must be >1 and divide the "
            "data-parallel degree {}".format(shard_size, data))
    replica = data // shard_size
    model = mesh.shape[MODEL_AXIS]
    pipe = mesh.shape.get(PIPE_AXIS, 1)
    out = copy.copy(mesh)
    out._groups = dict(mesh._groups)
    out.shape = dict(mesh.shape, **{DATA_REPLICA_AXIS: replica,
                                    DATA_SHARD_AXIS: shard_size})
    if not dist.is_initialized():
        return out
    me = mesh._coords
    dm = data * model
    for p in range(pipe):
        for m in range(model):
            for r in range(replica):
                group = mesh._new_group([
                    p * dm + (r * shard_size + s) * model + m
                    for s in range(shard_size)])
                if (p, m, r) == (me[PIPE_AXIS], me[MODEL_AXIS],
                                 me[DATA_AXIS] // shard_size):
                    out._groups[DATA_SHARD_AXIS] = group
            for s in range(shard_size):
                group = mesh._new_group([
                    p * dm + (r * shard_size + s) * model + m
                    for r in range(replica)])
                if (p, m, s) == (me[PIPE_AXIS], me[MODEL_AXIS],
                                 me[DATA_AXIS] % shard_size):
                    out._groups[DATA_REPLICA_AXIS] = group
    return out


def build_mesh(data=None, model=None, pipe=None, topology=None):
    """A :class:`ProcessMesh` over the default group: from ``topology``
    (a :class:`ProcessTopology`) when given, else ``model`` and ``pipe``
    default to 1 and ``data`` to the ranks left."""
    if topology is not None:
        pipe = max(topology.get_dim(PIPE_AXIS), 1)
        data = max(topology.get_dim(DATA_AXIS), 1)
        model = max(topology.get_dim(MODEL_AXIS), 1)
        return ProcessMesh(data, model, pipe)
    world = _world()
    model = model or 1
    pipe = pipe or 1
    if data is None:
        if world % (model * pipe):
            raise ValueError("world size {} does not divide by model={} x "
                             "pipe={}".format(world, model, pipe))
        data = world // (model * pipe)
    return ProcessMesh(data, model, pipe)


# ---------------------------------------------- the JAX package's topology


def _prime_factors(N):
    """Prime factorization in ascending order (reference topology.py)."""
    if N <= 0:
        raise ValueError("Factorize on non-positive number: {}".format(N))
    primes = []
    while N % 2 == 0:
        primes.append(2)
        N //= 2
    p = 3
    while p * p <= N:
        while N % p == 0:
            primes.append(p)
            N //= p
        p += 2
    if N > 1:
        primes.append(N)
    return primes


class ProcessTopology:
    """Cartesian rank <-> coordinate mapping over named axes.

    The axes are ordered outermost-first: the LAST axis has stride 1 in rank
    order (so put the bandwidth-hungry axis last — the reference makes 'data'
    innermost for the same reason).
    """

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        assert len(self.axes) == len(self.dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        for coord in cartesian_product(*[range(d) for d in self.dims]):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = len(self.mapping)

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError("get_rank() does not support slices, use filter_match()")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, "coord {} not in topology".format(key)
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_",
                      outer_sep="-"):
        """String like 'model_00' identifying a rank's non-omitted coords
        (used for checkpoint file naming)."""
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append("{}{}{:02d}".format(ax, inner_sep, ax_rank))
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError("rank {} not found in topology".format(rank))

    def get_axis_comm_lists(self, axis):
        """Lists of ranks that vary only along ``axis`` (the reference's
        per-axis communicator groups)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for other_coord in cartesian_product(
                *[range(self.get_dim(a)) for a in other_axes]):
            fixed = dict(zip(other_axes, other_coord))
            ranks = [self.get_rank(**{axis: i, **fixed})
                     for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        """Ranks whose coordinates match all given axis=value filters."""
        def matches(coord):
            return all(getattr(coord, key) == val
                       for key, val in filter_kwargs.items())
        return [rank for coord, rank in self.mapping.items() if matches(coord)]

    def get_axis_list(self, axis, idx):
        return [rank for coord, rank in self.mapping.items()
                if getattr(coord, axis) == idx]

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """['pipe', 'data'] topology: DP innermost to keep gradient reductions on
    the fastest links (reference topology.py:235-241)."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=[PIPE_AXIS, DATA_AXIS], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """['pipe', 'data', 'model'] 3D topology (reference topology.py:246)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=[PIPE_AXIS, DATA_AXIS, MODEL_AXIS],
                         dims=[num_pp, num_dp, num_mp])


class MeshGrid:
    """MPU-compatible view of a topology and its process groups.

    The JAX package's ``MeshGrid`` (the reference's PipelineParallelGrid,
    topology.py:252-455): ``get_{data,model,pipe}_parallel_{rank,
    world_size}``, the stage id and the stage helpers. Its ``mesh`` is the
    :class:`ProcessMesh` of the topology over the default group (the
    engine reads it as ``mpu.mesh``), and the ``get_*_group`` methods
    return its process groups. Without a process group (one process) the
    mesh is None and ``process_rank`` (default 0) places this process in
    the topology, so a stage can be built alone."""

    def __init__(self, topology=None, mesh=None, process_rank=None):
        if topology is None:
            topology = PipeDataParallelTopology(num_pp=1, num_dp=_world())
        self._topo = topology
        if mesh is None and dist.is_initialized():
            mesh = build_mesh(topology=topology)
        self.mesh = mesh
        if process_rank is None:
            process_rank = dist.get_rank() if dist.is_initialized() else 0
        self.global_rank = process_rank
        self.world_size = topology.world_size()

        self.data_parallel_size = max(topology.get_dim(DATA_AXIS), 1)
        self.pipe_parallel_size = max(topology.get_dim(PIPE_AXIS), 1)
        self.model_parallel_size = max(topology.get_dim(MODEL_AXIS), 1)
        assert self._is_grid_valid(), "Invalid Grid"

    def _is_grid_valid(self):
        ranks = self.data_parallel_size * self.pipe_parallel_size * \
            self.model_parallel_size
        return ranks == self._topo.world_size()

    @property
    def topology(self):
        return self._topo

    def _coord(self, rank=None):
        rank = self.global_rank if rank is None else rank
        return self._topo.get_coord(rank)

    def get_stage_id(self, rank=None):
        if PIPE_AXIS not in self._topo.get_axis_names():
            return 0
        return getattr(self._coord(rank), PIPE_AXIS)

    def get_pipe_parallel_rank(self, rank=None):
        return self.get_stage_id(rank)

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_rank(self, rank=None):
        if DATA_AXIS not in self._topo.get_axis_names():
            return 0
        return getattr(self._coord(rank), DATA_AXIS)

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_rank(self, rank=None):
        if MODEL_AXIS not in self._topo.get_axis_names():
            return 0
        return getattr(self._coord(rank), MODEL_AXIS)

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_global_rank(self):
        return self.global_rank

    def _group(self, axis):
        return self.mesh.get_group(axis) if self.mesh is not None else None

    def get_data_parallel_group(self):
        return self._group(DATA_AXIS)

    def get_model_parallel_group(self):
        return self._group(MODEL_AXIS)

    def get_pipe_parallel_group(self):
        return self._group(PIPE_AXIS)

    def is_first_stage(self, rank=None):
        return self.get_stage_id(rank) == 0

    def is_last_stage(self, rank=None):
        return self.get_stage_id(rank) == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id, data=0, model=0):
        kwargs = {}
        axes = self._topo.get_axis_names()
        if PIPE_AXIS in axes:
            kwargs[PIPE_AXIS] = stage_id
        if DATA_AXIS in axes:
            kwargs[DATA_AXIS] = data
        if MODEL_AXIS in axes:
            kwargs[MODEL_AXIS] = model
        return self._topo.get_rank(**kwargs)
