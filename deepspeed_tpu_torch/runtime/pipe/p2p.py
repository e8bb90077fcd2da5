"""Stage-to-stage activation and gradient transfer.

Port of ``deepspeed_tpu/runtime/pipe/p2p.py`` (reference:
deepspeed/runtime/pipe/p2p.py). The JAX package moves a stage's output
with ``lax.ppermute`` over the ``pipe`` mesh axis inside its one program;
here every stage is a process and a hop is a send and its receive
(``utils.distributed.post_p2p``) over the two-rank group of the stage
pair (``ProcessMesh.pair_group``). One :class:`Hop` collects a cycle's
transfers — the activation one stage forward, the input gradient one
stage back, and at chunk boundaries of an interleaved pipeline the wrap
hops (last stage -> first forward, first -> last backward) — and posts
them as one matched batch per pair group, the groups in one global
order, so two neighbours that send to each other in the same cycle never
wait on each other. The permutation lists are the JAX package's.
"""
from ...utils.distributed import post_p2p, wait_p2p


class Hop:
    """One cycle's transfers of pipe stage ``stage`` of ``num_stages`` on
    ``mesh`` (a ``ProcessMesh`` with a pipe axis): queue sends and
    receives, then :meth:`run` posts and waits for them all."""

    def __init__(self, mesh, stage, num_stages):
        self.mesh, self.stage, self.num_stages = mesh, stage, num_stages
        self._ops = {}       # pair key -> ([sends], [recvs])
        # a hop that stays on this stage (one stage, interleaved):
        # direction -> [sent, receive buffer]
        self._local = {}

    def _queue(self, peer, tensor, is_send, direction):
        if peer == self.stage:
            self._local.setdefault(direction, [None, None])[
                0 if is_send else 1] = tensor
            return
        group, ranks = self.mesh.pair_group(self.stage, peer)
        key = tuple(sorted((self.stage, peer)))
        rank = ranks[0] if key[0] == peer else ranks[1]
        sends, recvs = self._ops.setdefault(key, (group, [], []))[1:]
        # a tag per direction: the activation and the gradient between one
        # pair may travel the same way in one cycle (two stages,
        # interleaved)
        (sends if is_send else recvs).append(
            (tensor, rank, 1 if direction == "f" else 2))

    def send_forward(self, tensor):
        """``tensor`` to the next stage (stage S-1 wraps to 0)."""
        self._queue((self.stage + 1) % self.num_stages, tensor, True, "f")

    def send_backward(self, tensor):
        """``tensor`` to the previous stage (stage 0 wraps to S-1)."""
        self._queue((self.stage - 1) % self.num_stages, tensor, True, "b")

    def recv_forward(self, tensor):
        """Receive into ``tensor`` the previous stage's forward send."""
        self._queue((self.stage - 1) % self.num_stages, tensor, False, "f")
        return tensor

    def recv_backward(self, tensor):
        """Receive into ``tensor`` the next stage's backward send."""
        self._queue((self.stage + 1) % self.num_stages, tensor, False, "b")
        return tensor

    def run(self):
        """Post every queued batch (one per pair group, in the pair order
        every rank shares) and wait for all of them."""
        for sent, buf in self._local.values():
            buf.copy_(sent)
        handles = [post_p2p(sends, recvs, group) for _, (group, sends, recvs)
                   in sorted(self._ops.items())]
        wait_p2p(handles)
        self._ops, self._local = {}, {}
