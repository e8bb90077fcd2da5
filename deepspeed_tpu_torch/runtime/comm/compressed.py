"""CompressedBackend: the 1-bit allreduce over a process group.

Port of ``deepspeed_tpu/runtime/comm/compressed.py`` (the reference's
``NcclBackend``). The codec and the two exchange phases live in
``onebit.py`` (shared with OneBitAdam); this class owns the padding, the
zero error state and, per buffer size, the real-lane count.
"""
import torch

from ...parallel.topology import DATA_AXIS
from .onebit import compressed_allreduce_local, onebit_padded_size
from .quantize import group_size


class CompressedBackend:
    """``compressed_allreduce(values, worker_error, server_error)`` over a
    mesh's data group (or a process ``group``): each rank passes its own
    ``(n,)`` buffer and gets back ``(averaged (n,), new worker error
    (padded,), new server error (padded / world,))``. The error state is
    the caller's, as the reference keeps it on the optimizer."""

    def __init__(self, mesh=None, group=None, axis=DATA_AXIS):
        if group is None and mesh is not None:
            group = mesh.get_group(axis)
        self.group = group
        self.world_size = group_size(group)
        self._sizes = {}

    def padded_size(self, n):
        size = self._sizes.get(n)
        if size is None:
            size = self._sizes[n] = onebit_padded_size(n, self.world_size)
        return size

    def compressed_allreduce(self, values, worker_error=None,
                             server_error=None):
        n = values.numel()
        padded = self.padded_size(n)
        flat = torch.zeros(padded, dtype=torch.float32,
                           device=values.device)
        flat[:n] = values.reshape(-1)
        if worker_error is None:
            worker_error = torch.zeros_like(flat)
        if server_error is None:
            server_error = torch.zeros(padded // self.world_size,
                                       dtype=torch.float32,
                                       device=values.device)
        out, we, se = compressed_allreduce_local(
            flat, worker_error, server_error, self.group, real_size=n)
        return out[:n], we, se
