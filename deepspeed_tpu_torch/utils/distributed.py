"""Process groups: rendezvous, the transport choice, host-staged
collectives and a spawn helper with a deadline.

Port of ``deepspeed_tpu/utils/distributed.py::init_distributed``. The JAX
package joins processes with ``jax.distributed.initialize``; here each
process is one rank of a ``torch.distributed`` group:

* rank r runs on ``cuda:(r % device_count)``;
* the transport is NCCL when every rank of the host has a card of its own,
  and gloo when ranks share a card (NCCL refuses two ranks on one GPU).
  Under gloo, CUDA tensors cross through host memory (:func:`host_staged`):
  that is the shared-card transport, not a fallback. An NCCL failure
  raises; nothing retries on gloo.

:func:`all_to_all` exchanges equal chunks (the 1-bit exchange's worker
phase). :func:`post_p2p` / :func:`wait_p2p` (and :func:`send` / :func:`recv`)
move one tensor to or from a rank, for the pipeline's stage hops.

:func:`spawn` starts ``world_size`` ranks on this host, each with its
group initialised, and joins them under a deadline: a rank that raises
or a ring that hangs fails the call within the deadline, and every child
is killed before it returns or raises.
"""
import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .logging import logger

NCCL, GLOO = "nccl", "gloo"


def local_world_size(world_size):
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun) or the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def choose_backend(world_size):
    """NCCL when CUDA is up and every local rank has a card of its own,
    else gloo."""
    if torch.cuda.is_available() and \
            local_world_size(world_size) <= torch.cuda.device_count():
        return NCCL
    return GLOO


def init_distributed(rank=None, world_size=None, init_method=None,
                     backend=None, timeout_s=300.0, verbose=True):
    """Join the default process group (a no-op when it is already up).

    Explicit arguments first, then the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets
    them). A single process with nothing given stays ungrouped. Sets this
    rank's CUDA device when CUDA is up. Returns the backend name (None
    when no group was made)."""
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if world_size is None or world_size <= 1 and init_method is None:
        if verbose:
            logger.info("single-process run: no process group")
        return None
    if init_method is None:
        init_method = "env://"
    backend = backend or choose_backend(world_size)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if verbose:
        logger.info("rank %d of %d joined over %s (%s)", rank, world_size,
                    backend, init_method)
    return backend


def host_staged(group, tensor):
    """True when ``tensor`` must cross ``group`` through host memory: a
    CUDA tensor on a gloo group (ranks sharing one card)."""
    return tensor.is_cuda and dist.get_backend(group) == GLOO


def host_copy(tensor):
    """A pinned host copy of a CUDA ``tensor`` (one device-to-host copy)."""
    return torch.empty(tensor.shape, dtype=tensor.dtype,
                       pin_memory=True).copy_(tensor)


def all_reduce_(tensor, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of ``tensor`` over ``group``."""
    if host_staged(group, tensor):
        host = host_copy(tensor)
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast_(tensor, src=0, group=None):
    """In-place broadcast of ``tensor`` from global rank ``src``."""
    if host_staged(group, tensor):
        host = host_copy(tensor)
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def all_gather(tensor, group, dim=0):
    """Every rank's ``tensor`` concatenated along ``dim`` in rank order,
    for any dtype both transports carry (the compressed exchanges gather
    int8 blocks and uint8 sign bytes); a 0-dim tensor gathers as one
    element a rank."""
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    n = dist.get_world_size(group)
    staged = host_staged(group, tensor)
    src = host_copy(tensor) if staged else tensor.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(tensor.device) if staged else out


def all_to_all(tensor, group):
    """``tensor``'s ``world`` equal chunks along dim 0 exchanged over
    ``group`` (``all_to_all_single``): chunk i goes to rank i, and chunk i
    of the result is what rank i sent this rank. NCCL moves the card's
    tensor directly; on gloo a CUDA tensor crosses through host memory."""
    staged = host_staged(group, tensor)
    src = host_copy(tensor) if staged else tensor.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(tensor.device) if staged else out


def all_gather_into(out, part, group):
    """Every rank's ``part`` (1-D, of equal lengths) written into ``out``
    in rank order: NCCL gathers into ``out`` directly; gloo gathers a list
    (through host memory for CUDA tensors) and copies it in. ``part`` may
    be a view of ``out``."""
    if dist.get_backend(group) == GLOO:
        out.copy_(all_gather(part, group))
    else:
        dist.all_gather_into_tensor(out, part.clone(), group=group)
    return out


def reduce_scatter(tensor, group, dim=0):
    """The sum over ``group`` of ``tensor``, this rank's 1/n slice along
    ``dim``: rank r gets the sum of every rank's chunk r, in ``tensor``'s
    dtype (a bf16 buffer sums in bf16 on both transports). gloo has no
    reduce-scatter on every torch version: it all-reduces and slices."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == GLOO:
        # through host memory for a CUDA tensor: only this rank's slice
        # comes back to the card
        full = host_copy(tensor) if tensor.is_cuda else tensor.clone()
        dist.all_reduce(full, group=group)
        return full.chunk(n, dim=dim)[r].to(tensor.device).contiguous()
    out = torch.empty_like(tensor.chunk(n, dim=dim)[r])
    if dim == 0 and tensor.is_contiguous():
        dist.reduce_scatter_tensor(out, tensor, group=group)
    else:
        dist.reduce_scatter(out, [c.contiguous()
                                  for c in tensor.chunk(n, dim)], group=group)
    return out


# ------------------------------------------------------- point-to-point


def post_p2p(sends, recvs, group):
    """Post the sends ``[(tensor, global dst[, tag])]`` and receives
    ``[(tensor, global src[, tag])]`` of one process ``group`` as one
    matched batch
    (``batch_isend_irecv``: a rank that sends and receives in the same
    batch cannot deadlock on its peer's order). Over NCCL the tensors stay
    on the card; over gloo a CUDA tensor crosses through pinned host
    memory. Returns a handle for :func:`wait_p2p`."""
    ops, back = [], []
    for tensor, dst, *tag in sends:
        src = host_copy(tensor) if host_staged(group, tensor) \
            else tensor.contiguous()
        ops.append(dist.P2POp(dist.isend, src, dst, group, *tag))
    for tensor, src, *tag in recvs:
        buf = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True) \
            if host_staged(group, tensor) else tensor
        ops.append(dist.P2POp(dist.irecv, buf, src, group, *tag))
        back.append((tensor, buf))
    return (dist.batch_isend_irecv(ops) if ops else [], back)


def wait_p2p(handles):
    """Wait for every batch :func:`post_p2p` posted; a host-staged receive
    is copied to its CUDA tensor."""
    for works, back in handles:
        for work in works:
            work.wait()
        for tensor, buf in back:
            if buf is not tensor:
                tensor.copy_(buf)


def send(tensor, dst, group=None):
    """Send ``tensor`` to global rank ``dst`` (its receive is
    :func:`recv`); blocks until the transfer is posted and done."""
    wait_p2p([post_p2p([(tensor, dst)], [], group)])


def recv(tensor, src, group=None):
    """Receive into ``tensor`` from global rank ``src``."""
    wait_p2p([post_p2p([], [(tensor, src)], group)])
    return tensor


# ------------------------------------------------------------ spawning


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, world_size, init_method, backend, timeout_s, args,
           results):
    try:
        init_distributed(rank, world_size, init_method, backend=backend,
                         timeout_s=timeout_s, verbose=False)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class SpawnError(RuntimeError):
    """A spawned rank raised, died, or missed the deadline."""


def spawn(fn, world_size, args=(), timeout_s=120.0, backend=None):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined over ``tcp://localhost`` and return the results in
    rank order. ``fn`` and its results must pickle (a module-level
    function; numpy arrays and plain values). Raises :class:`SpawnError`
    when a rank raises or dies, or when the ranks have not all returned
    within ``timeout_s``; every child is killed before this returns or
    raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = "tcp://127.0.0.1:{}".format(free_port())
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world_size, init_method, backend,
                               timeout_s, tuple(args), results))
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise SpawnError(
                    "spawn: ranks {} did not finish within {:.0f} s".format(
                        sorted(set(range(world_size)) - set(out)),
                        timeout_s))
            try:
                rank, ok, value = results.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise SpawnError("spawn: ranks {} died with exit codes "
                                     "{}".format(dead, [procs[i].exitcode
                                                        for i in dead]))
                continue
            if not ok:
                raise SpawnError("spawn: rank {} raised:\n{}".format(
                    rank, value))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        results.close()
        results.join_thread()
    return [out[r] for r in range(world_size)]
