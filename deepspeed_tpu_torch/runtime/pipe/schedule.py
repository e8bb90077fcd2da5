"""Pipeline instruction schedules and the executor's cycle tables.

Copy of ``deepspeed_tpu/runtime/pipe/schedule.py`` (plain Python and
numpy; the tests hold every instruction stream and table equal to the
original's). Reference parity: deepspeed/runtime/pipe/schedule.py
(PipeSchedule ABC :6, TrainSchedule :182, InferenceSchedule :129,
instruction vocabulary :336-474). The port's ``PipelineEngine``
(``runtime/pipe/engine.py``) runs each rank's loop from
``interleaved_train_schedule_tables`` (training) and
``packed_inference_schedule_tables`` (``eval_batch``): the same tables
the JAX package's one-program executor indexes, here one process per
stage walking its own row; ``TrainSchedule`` stays the reference-parity
spec. The docstrings below are the original's and speak of its SPMD
executor.
"""
import numpy as np

from ..utils import call_to_str


class PipeInstruction:
    """A single step directive for one pipeline stage."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        return call_to_str(self.name, **self.kwargs)

    def __eq__(self, other):
        return (self.__class__ == other.__class__ and
                self.kwargs == other.kwargs)


class OptimizerStep(PipeInstruction):
    """Apply the optimizer (all stages, end of batch)."""


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction."""


class ReduceTiedGrads(PipeInstruction):
    """Reduce gradients of tied modules across owning stages."""


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


class PipeSchedule:
    """Yields, per engine step, the list of instructions for this stage
    (reference :6-126)."""

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    def steps(self):
        raise NotImplementedError

    def num_pipe_buffers(self):
        return self.micro_batches

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    def __iter__(self):
        self.it = iter(self.steps())
        return self.it

    def __next__(self):
        return next(self.it)


class InferenceSchedule(PipeSchedule):
    """Forward-only fill-drain (reference :129): M + S - 1 steps, two
    alternating buffers."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            micro_batch_id = step_id - self.stage_id
            cmds = []
            buf = step_id % 2
            if self._valid_micro_batch(micro_batch_id):
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buf))
                else:
                    cmds.append(RecvActivation(buf))
                cmds.append(ForwardPass(buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buf))
            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved fill-drain training schedule (reference :182).

    2*(M + S - 1) half-steps; stages alternate forward/backward phases with
    even/odd staggering so a stage's forward of microbatch m and backward of
    microbatch m-(S-stage) interleave in steady state. Ends with
    ReduceTiedGrads, ReduceGrads, OptimizerStep.
    """

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            cmds = []

            # Alternate send/recv with the neighbor touched by this phase.
            if self._valid_micro_batch(prev_micro_batch_id):
                if is_forward:
                    # previous phase was a backward: its grad goes upstream
                    if not self.is_first_stage:
                        cmds.append(SendGrad(
                            self._buffer_idx(prev_micro_batch_id)))
                else:
                    if not self.is_last_stage:
                        cmds.append(SendActivation(
                            self._buffer_idx(prev_micro_batch_id)))
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    if self.is_first_stage:
                        cmds.append(LoadMicroBatch(
                            self._buffer_idx(micro_batch_id)))
                    else:
                        cmds.append(RecvActivation(
                            self._buffer_idx(micro_batch_id)))
                    cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                else:
                    if not self.is_last_stage:
                        cmds.append(RecvGrad(self._buffer_idx(micro_batch_id)))
                    cmds.append(BackwardPass(self._buffer_idx(micro_batch_id)))

            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def _step_to_micro_batch(self, step_id):
        """Map a half-step to (micro_batch_id, is_forward) with the even/odd
        stage staggering of the reference (:249-289)."""
        def _is_even(x):
            return x % 2 == 0

        if _is_even(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._even_step_forward_id(step_id)
            is_forward = True
        elif not _is_even(step_id) and not _is_even(self.stage_id):
            micro_batch_id = self._odd_step_forward_id(step_id)
            is_forward = True
        elif _is_even(step_id) and not _is_even(self.stage_id):
            micro_batch_id = self._even_step_backward_id(step_id)
            is_forward = False
        else:
            micro_batch_id = self._odd_step_backward_id(step_id)
            is_forward = False
        return micro_batch_id, is_forward

    def _even_step_forward_id(self, step_id):
        base = step_id // 2
        return base - self.stage_id // 2

    def _odd_step_forward_id(self, step_id):
        base = (step_id - 1) // 2
        return base - self.stage_id // 2

    def _even_step_backward_id(self, step_id):
        base = step_id // 2
        return base - self.stages + (self.stage_id + 1) // 2

    def _odd_step_backward_id(self, step_id):
        base = ((step_id - 1) // 2) - self.stages + 1
        return base + (self.stage_id + 1) // 2

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def num_pipe_buffers(self):
        """min(S - stage + 1, M) buffers (reference :243-247)."""
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)


class UniformTrainSchedule(PipeSchedule):
    """Collective-uniform 1F1B schedule (round-3 executor semantics; the
    executor now runs the phase-split generalization of these tables —
    see interleaved_train_schedule_tables, whose v=1 microbatch tables
    are identical).

    TrainSchedule's even/odd stagger has different stages running different
    phases at the same half-step. A per-process interpreter (the torch
    reference) handles that trivially; a ONE-program SPMD executor cannot —
    branching some ranks into ForwardPass while others take BackwardPass
    wraps data-dependent branches around the auto-partitioned collectives
    inside the stage body (TP all-reduces, resharding permutes), and XLA
    collectives deadlock unless every device executes the same collective
    sequence. So the executed schedule makes every cycle structurally
    identical on every stage: one (maybe-masked) ForwardPass phase, then
    one (maybe-masked) BackwardPass phase —

        forward  of microbatch m on stage s at cycle m + s
        backward of microbatch m on stage s at cycle m + 2(S-1) - s

    M + 2(S-1) cycles total. The memory property that makes 1F1B matter is
    kept: in-flight forward activations per stage are capped at
    min(2(S - stage_id) - 1, M) — ``num_pipe_buffers`` — independent of
    micro_batches (reference TrainSchedule bound: min(S - stage_id + 1, M),
    schedule.py:243-247). The price vs the staggered reference is bubble
    2(S-1)/M instead of (S-1)/M — the SPMD-uniformity tax, paid in compile-
    time-known idle cycles rather than deadlocks.
    """

    def steps(self):
        fwd, bwd = uniform_train_schedule_tables(self.micro_batches,
                                                 self.stages)
        for k in range(fwd.shape[1]):
            cmds = []
            m_f = int(fwd[self.stage_id, k])
            m_b = int(bwd[self.stage_id, k])
            if m_f >= 0:
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(self._buffer_idx(m_f)))
                else:
                    cmds.append(RecvActivation(self._buffer_idx(m_f)))
                cmds.append(ForwardPass(self._buffer_idx(m_f)))
                if not self.is_last_stage:
                    cmds.append(SendActivation(self._buffer_idx(m_f)))
            if m_b >= 0:
                if not self.is_last_stage:
                    cmds.append(RecvGrad(self._buffer_idx(m_b)))
                cmds.append(BackwardPass(self._buffer_idx(m_b)))
                if not self.is_first_stage:
                    cmds.append(SendGrad(self._buffer_idx(m_b)))
            if k == fwd.shape[1] - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            yield cmds

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def num_pipe_buffers(self):
        """Stage-input slots the executor's recompute buffer needs: a
        forward saved at cycle m + s is consumed at cycle m + 2(S-1) - s,
        so at most 2(S - s) - 1 microbatches are in flight."""
        return max(1, min(2 * (self.stages - self.stage_id) - 1,
                          self.micro_batches))


def uniform_train_schedule_tables(micro_batches, stages):
    """Dense (stages, C) cycle->microbatch tables for UniformTrainSchedule.

    ``fwd[s, k]`` / ``bwd[s, k]`` hold the microbatch stage ``s`` forwards /
    backwards at cycle ``k`` (-1 = bubble). The 1F1B executor
    (pipe/engine.py) ships each stage its row and indexes it per loop step —
    this function IS the schedule the SPMD program runs.

    The tables satisfy the executor's ppermute alignment: stage s+1's
    forward of m lands exactly one cycle after stage s's (activations ride
    one hop per cycle), and stage s-1's backward of m one cycle after stage
    s's (grads likewise); tests/unit/test_pipe_schedule.py asserts this and
    the in-flight bound.
    """
    C = micro_batches + 2 * (stages - 1)
    cycles = np.arange(C, dtype=np.int64)[None, :]
    stage = np.arange(stages, dtype=np.int64)[:, None]
    fwd = cycles - stage
    bwd = cycles - (2 * (stages - 1) - stage)
    fwd = np.where((fwd >= 0) & (fwd < micro_batches), fwd, -1)
    bwd = np.where((bwd >= 0) & (bwd < micro_batches), bwd, -1)
    return fwd.astype(np.int32), bwd.astype(np.int32)


def interleaved_train_schedule_tables(micro_batches, stages, num_chunks=1):
    """Cycle tables for the (optionally interleaved) collective-uniform
    1F1B executor, plus its phase boundaries and buffer bound.

    With ``num_chunks`` = v virtual stages per rank (Megatron interleaving,
    reference analogue: the staggered TrainSchedule is v=1 only), the model
    is cut into vS virtual stages; virtual stage j = c*S + r (chunk c,
    rank r). Writing microbatch m = g*S + q:

        forward  of (c, m) on rank r at cycle  g*vS + c*S + q + r
        backward of (c, m) on rank r at cycle  vS-1 + g*vS + (v-1-c)*S
                                                + q + (S-1-r)

    Both satisfy the one-hop-per-cycle ppermute alignment (chunk
    transitions wrap rank S-1 -> 0 forward, 0 -> S-1 backward) and give
    each rank at most one forward and one backward per cycle. At v=1 they
    reduce exactly to ``uniform_train_schedule_tables``.

    The executor splits the cycle range into three compile-time phases —
    cycles before ``warmup_end`` run a forward phase only, cycles in
    [warmup_end, steady_end) run forward+backward, and the rest run
    backward only. Structural collective uniformity is only required
    ACROSS RANKS WITHIN a cycle, so dropping the dead phase from the
    warmup/drain cycles is legal — and it is where the bubble shrinks:
    per-rank idle falls from 2(S-1) full cycles (round-3 executor) to
    2(S-1) HALF-cycles at v=1 (reference 1F1B parity, bubble (S-1)/M)
    and (2S-2)/v half-cycle equivalents at v>1 — bubble (S-1)/(vM),
    beating the reference's (S-1)/M from v=2 up.

    Returns a dict: fwd_m/fwd_c/bwd_m/bwd_c ((S, T) int32, -1 = bubble),
    total_cycles, warmup_end, steady_end, buffer_slots (W: per-(rank,
    chunk) stage-input slots such that slot = m % W never collides among
    in-flight microbatches).

    M need not divide by S: the construction stays valid (tables are
    injective per rank-cycle for any M), the ragged tail just adds
    bubbles — pick M a multiple of S for the advertised bubble.
    """
    M, S, v = micro_batches, stages, num_chunks
    assert v >= 1 and S >= 1 and M >= 1
    t_f = np.empty((S, v, M), np.int64)
    t_b = np.empty((S, v, M), np.int64)
    g, q = np.arange(M) // S, np.arange(M) % S
    for r in range(S):
        for c in range(v):
            t_f[r, c] = g * v * S + c * S + q + r
            t_b[r, c] = (v * S - 1 + g * v * S + (v - 1 - c) * S
                         + q + (S - 1 - r))
    T = int(t_b.max()) + 1
    fwd_m = -np.ones((S, T), np.int32)
    fwd_c = -np.ones((S, T), np.int32)
    bwd_m = -np.ones((S, T), np.int32)
    bwd_c = -np.ones((S, T), np.int32)
    for r in range(S):
        for c in range(v):
            for m in range(M):
                kf, kb = t_f[r, c, m], t_b[r, c, m]
                assert fwd_m[r, kf] < 0 and bwd_m[r, kb] < 0, \
                    "schedule collision"
                fwd_m[r, kf] = m
                fwd_c[r, kf] = c
                bwd_m[r, kb] = m
                bwd_c[r, kb] = c
    # phase boundaries: the fwd-active and bwd-active cycle windows are
    # contiguous by construction; warmup = cycles before any backward,
    # drain = cycles after every forward
    warmup_end = int(t_b.min())
    steady_end = int(t_f.max()) + 1
    assert warmup_end <= steady_end
    # W: max in-flight microbatches per (rank, chunk), interval closed on
    # the backward cycle (its buffer read happens AFTER that cycle's
    # forward phase may have stored a new entry)
    W = 1
    for r in range(S):
        for c in range(v):
            events = np.zeros(T + 1, np.int64)
            for m in range(M):
                events[t_f[r, c, m]] += 1
                events[t_b[r, c, m] + 1] -= 1
            W = max(W, int(np.cumsum(events).max()))
    return {
        "fwd_m": fwd_m, "fwd_c": fwd_c, "bwd_m": bwd_m, "bwd_c": bwd_c,
        "total_cycles": T, "warmup_end": warmup_end,
        "steady_end": steady_end, "buffer_slots": min(W, M),
    }


def packed_inference_schedule_tables(micro_batches, stages, num_chunks=1):
    """Packed forward-only cycle tables for the SPMD eval/inference loop
    (the interleaved analogue of the reference InferenceSchedule,
    schedule.py:129-179).

    Forward of (chunk c, microbatch m = g*S + q) on rank r at cycle

        g*vS + c*S + q + r

    — microbatch groups of S stream back-to-back through the vS virtual
    stages with no 1F1B spacing and no backward cycles. Total cycles:

        T = M*v + S - 1                      when S | M
        T = vS*ceil(M/S) + (M-1) % S - S + 1 + S - 1   (ragged tail)

    and T is OPTIMAL for the executor's one-hop-per-cycle ppermute
    structure: each rank does M*v forwards, chunk hops force S-cycle
    spacing between a microbatch's chunks, and the construction tiles
    every rank's cycle lattice with no internal gaps (the ragged tail
    adds (v-1)*(S - M%S) unavoidable bubble cycles; pick M a multiple of
    S for the advertised count). The tables satisfy the same hop
    alignment as the training tables — stage s+1 consumes at s's cycle
    +1, chunk transitions wrap S-1 -> 0 — which
    tests/unit/test_pipe_schedule.py asserts.

    Returns {fwd_m, fwd_c ((S, T) int32, -1 = bubble), total_cycles}.
    Eval walks ONLY these T cycles instead of slicing the training
    tables (whose array width is the full fwd+bwd cycle range).
    """
    M, S, v = micro_batches, stages, num_chunks
    assert v >= 1 and S >= 1 and M >= 1
    g, q = np.arange(M) // S, np.arange(M) % S
    T = 0
    t_f = np.empty((S, v, M), np.int64)
    for r in range(S):
        for c in range(v):
            t_f[r, c] = g * v * S + c * S + q + r
    T = int(t_f.max()) + 1
    fwd_m = -np.ones((S, T), np.int32)
    fwd_c = -np.ones((S, T), np.int32)
    for r in range(S):
        for c in range(v):
            for m in range(M):
                k = t_f[r, c, m]
                assert fwd_m[r, k] < 0, "schedule collision"
                fwd_m[r, k] = m
                fwd_c[r, k] = c
    return {"fwd_m": fwd_m, "fwd_c": fwd_c, "total_cycles": T}


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (reference :476)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1
