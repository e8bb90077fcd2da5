"""The ring idiom: the one-hop permutation and the hop itself.

Port of ``deepspeed_tpu/parallel/ring.py``. The JAX package moves a
buffer one hop with ``lax.ppermute`` inside ``shard_map``; here every rank
of a process group runs the same loop and a hop is one
``dist.batch_isend_irecv``: send to the right neighbour, receive from the
left one. :func:`ring_rotate_start` starts a hop and returns a handle
whose ``wait()`` yields what arrived, so a caller can put compute between
the two (the collective matmuls start the next hop before the current
step's product). :func:`ring_rotate` is both halves at once.

Transports: NCCL moves CUDA tensors between cards, and ``wait()`` makes
the current stream wait for the transfer. On a gloo group (ranks sharing
one card) a CUDA payload crosses through pinned host buffers: copied out
before the send, copied in after the receive. That is the shared-card
transport, stated as such; a hop there costs two host copies and the
loopback socket, so its time says nothing about a ring between cards.
CPU tensors go over gloo as they are.
"""
import torch
import torch.distributed as dist

from ..utils.distributed import host_copy, host_staged


def ring_perm(n):
    """The one-hop rotation over a ring of ``n`` ranks: ``[(src, dst)]``
    pairs moving every shard to its next neighbour."""
    return [(j, (j + 1) % n) for j in range(n)]


def ring_context(group):
    """``(n, idx, perm)`` for the ring over ``group``: its size, this
    rank's position in it, and the forward one-hop perm. Without a process
    group the ring has one member."""
    if group is None or not dist.is_initialized():
        return 1, 0, ring_perm(1)
    n = dist.get_world_size(group)
    return n, dist.get_rank(group), ring_perm(n)


def even_chunk_count(size, chunks):
    """Largest divisor of ``size`` that is <= ``chunks``: the number of
    equal pieces a payload of ``size`` elements splits into."""
    parts = max(1, min(int(chunks), int(size)))
    while size % parts:
        parts -= 1
    return parts


class RingHop:
    """One hop in flight; :meth:`wait` returns the received tensor in the
    payload's original dtype."""

    def __init__(self, reqs, recv, host_recv, orig_dtype, keep):
        self._reqs, self._recv, self._host = reqs, recv, host_recv
        self._dtype, self._keep = orig_dtype, keep

    def wait(self):
        for req in self._reqs:
            req.wait()
        if self._host is not None:
            self._recv.copy_(self._host)
        self._keep = None
        out = self._recv
        return out if out.dtype == self._dtype else out.to(self._dtype)


def ring_rotate_start(x, group, perm, chunks=1, wire_dtype=None, out=None):
    """Start one ring hop of ``x`` over ``group`` per ``perm``.

    ``chunks > 1`` splits the payload into that many equal contiguous
    pieces (``even_chunk_count`` of its elements), each its own send and
    receive: the bytes on the wire are the same. ``wire_dtype`` casts the
    payload for the hop only; ``wait()`` casts it back to ``x``'s dtype.
    ``out`` (the payload's shape, in the wire dtype) is the receive slot;
    a fresh one is allocated when None."""
    n, idx, _ = ring_context(group)
    dst = dict(perm)[idx]
    src = next(s for s, d in perm if d == idx)
    orig = x.dtype
    wire = x if wire_dtype is None or wire_dtype == orig \
        else x.to(wire_dtype)
    wire = wire.contiguous()
    recv = torch.empty_like(wire) if out is None else out
    if tuple(recv.shape) != tuple(wire.shape) or recv.dtype != wire.dtype \
            or not recv.is_contiguous():
        raise ValueError("ring_rotate: receive slot {} {} does not match the "
                         "payload {} {}".format(tuple(recv.shape), recv.dtype,
                                                tuple(wire.shape),
                                                wire.dtype))
    host_recv = None
    send_buf, recv_buf = wire, recv
    if host_staged(group, wire):
        send_buf = host_copy(wire)
        host_recv = torch.empty(wire.shape, dtype=wire.dtype,
                                pin_memory=True)
        recv_buf = host_recv
    parts = even_chunk_count(send_buf.numel(), chunks)
    sends = send_buf.reshape(-1).chunk(parts)
    recvs = recv_buf.reshape(-1).chunk(parts)
    peer_dst = dist.get_global_rank(group, dst)
    peer_src = dist.get_global_rank(group, src)
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, peer_dst, group))
        ops.append(dist.P2POp(dist.irecv, r, peer_src, group))
    reqs = dist.batch_isend_irecv(ops)
    return RingHop(reqs, recv, host_recv, orig, keep=(send_buf, wire))


def ring_rotate(x, group, perm, chunks=1, wire_dtype=None):
    """One ring hop of ``x``: what the left neighbour sent, in ``x``'s
    dtype (see :func:`ring_rotate_start`)."""
    return ring_rotate_start(x, group, perm, chunks, wire_dtype).wait()
