"""Named-axis meshes of ``torch.distributed`` process groups.

Port of the part of ``deepspeed_tpu/parallel/topology.py`` that the
tensor-parallel path uses: the axis names and ``build_mesh(data=,
model=)``. Where the JAX package builds one ``jax.sharding.Mesh`` whose
axis names address collectives inside ``jit``, here a :class:`ProcessMesh`
holds one process group per axis coordinate. Axis order is the JAX
package's: ``data`` outer, ``model`` inner, so the ranks of one model
group are adjacent (rank = d * model + m).
"""
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class ProcessMesh:
    """A ``(data, model)`` grid over the default group's ranks. ``shape``
    maps axis name -> size as ``jax.sharding.Mesh.shape`` does;
    :meth:`get_group` is this rank's group along an axis."""

    def __init__(self, data, model):
        world = dist.get_world_size() if dist.is_initialized() else 1
        if data * model != world:
            raise ValueError(
                "mesh data={} x model={} needs {} ranks, the process group "
                "has {}".format(data, model, data * model, world))
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        rank = dist.get_rank() if dist.is_initialized() else 0
        self._coords = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}
        self._groups = {}
        if not dist.is_initialized():
            return
        # every rank creates every group, in the same order
        for d in range(data):
            group = self._new_group([d * model + m for m in range(model)])
            if d == self._coords[DATA_AXIS]:
                self._groups[MODEL_AXIS] = group
        for m in range(model):
            group = self._new_group([d * model + m for d in range(data)])
            if m == self._coords[MODEL_AXIS]:
                self._groups[DATA_AXIS] = group

    @staticmethod
    def _new_group(ranks):
        if len(ranks) == dist.get_world_size():
            return dist.group.WORLD
        return dist.new_group(ranks)

    def get_group(self, axis):
        """This rank's process group along ``axis`` (None without a
        process group, where every axis has size 1)."""
        return self._groups.get(axis)


def build_mesh(data=None, model=None):
    """A :class:`ProcessMesh` over the default group: ``model`` defaults to
    1 and ``data`` to the ranks left."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if data is None:
        if world % model:
            raise ValueError("world size {} does not divide by model={}"
                             .format(world, model))
        data = world // model
    return ProcessMesh(data, model)
