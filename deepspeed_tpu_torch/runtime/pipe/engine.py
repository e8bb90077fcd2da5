"""PipelineEngine: pipeline-parallel training, one process a stage.

Port of ``deepspeed_tpu/runtime/pipe/engine.py`` (reference:
deepspeed/runtime/pipe/engine.py, PipelineEngine :45, train_batch :244,
the instruction interpreter :1135). The JAX package compiles the 1F1B
schedule into one SPMD program over the ``pipe`` mesh axis; here each
rank is one stage (``PipelineModule`` builds only its layers) and walks
its own row of the same cycle tables
(``schedule.interleaved_train_schedule_tables``):

* each cycle k runs this rank's forward of micro-batch ``fwd_m[r, k]``
  (chunk ``fwd_c[r, k]``), then its backward of ``bwd_m[r, k]``, then
  one hop (``p2p.Hop``): the forward's output one stage on, the
  backward's input gradient one stage back (wrapping S-1 <-> 0 between
  chunks when interleaved, ``num_virtual_stages`` > 1). The tables put
  each receive exactly one cycle after its send, so a rank knows from
  its neighbours' rows what arrives, and every micro-batch meets each
  layer in the JAX executor's order;
* the backward, by default, re-runs the stage forward from its saved
  input (the JAX default: at most ``buffer_slots`` inputs live per chunk,
  flat in the number of micro-batches; the forward phase runs without
  autograd, and the last virtual stage skips it: its backward recomputes
  it anyway). ``save_stage_residuals=True`` keeps each micro-batch's
  autograd graph from the forward phase instead; both give the same
  gradients;
* the last virtual stage seeds the backward with ``loss * loss_scale /
  M`` (M micro-batches, the batch's mean, as the JAX executor), the
  first stage's embedding takes the gradient of its output, and after
  each backward the compute-dtype gradients fold into the fp32
  accumulator (``FlatPartition.fold_grads``: at ZeRO stage 2 the
  reduce-scatter over the stage's data group).

At the batch's end the shared apply step (``DeepSpeedEngine._apply_step``)
runs with the pipeline's hooks: the tied parameters (the embedding the
first stage reads and the head of the last stage) have their gradients
summed over the two stages before the data-parallel reduction (the
reference's ReduceTiedGrads; their flat slice leads each stage's layout,
and at stage 2 it is kept whole in fp32 until then), the overflow flag
and the squares of the global gradient norm are reduced over the pipe
group too (a tied parameter counted once, on the first stage that holds
it), so every stage skips or clips alike and the two tied copies stay
equal bit for bit. ``train_batch`` returns the mean loss over the
micro-batches on every rank (the last stage's, summed over the pipe
group: the reference's ``_aggregate_total_loss``) and the data group.
``eval_batch`` runs forward only through
``schedule.packed_inference_schedule_tables`` with dropout off.

ZeRO stages 0-3 partition each stage's flat buffers over its data group
(with ``cpu_offload`` the host Adam steps them); tensor parallelism
inside a stage runs through ``comm.collective_matmul`` as in the dense
engine. At stage 3 each stage's units (``PipelineModule.zero3_units``:
the tied layer, each pre, body and post layer) are gathered over the
stage's data group around their calls (``Stage3.call``): the forward
phase runs under autograd, keeping only each unit call's input, and the
backward phase back-propagates from the stashed output, so each layer
runs its forward twice a micro-batch (the phase, the call's recompute)
on every stage, the last included. The tied leaves' gradients are kept
whole (``FlatPartition.hold``) and summed over the two stages, then the
data group, as at stage 2. Refused, as in the JAX package: ``forward``/
``backward``/``step`` (:class:`PipelineError`), ZeRO stage >= 2 under PP
x TP, elasticity. Checkpoints are the JAX engine's tags with
``client_state["pipe_layout"]`` and one ``layer_NN-model_00-model_states.pt``
per real body layer; a tag written at one (S, v) loads at another. Under
``cpu_offload`` each rank's zero file holds its host state as
``offload_shards`` (the stacked body's boxes) and the model file also
carries the gathered master and optimizer trees, as the single-process
JAX pipeline engine writes them, so the tag loads in either package.
"""
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ...parallel.topology import PIPE_AXIS
from ...utils.distributed import all_reduce_, broadcast_
from ...utils.logging import log_dist
from .. import checkpointing as ckpt
from ..comm.config import warn_or_raise_noop
from ..engine import DeepSpeedEngine
from . import p2p
from .module import PipelineModule, _nest
from .schedule import (interleaved_train_schedule_tables,
                       packed_inference_schedule_tables)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_MAX_DIMS = 6


class PipelineError(Exception):
    pass


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


class PipelineEngine(DeepSpeedEngine):
    """Train a :class:`PipelineModule`; batches only move through
    :meth:`train_batch` / :meth:`eval_batch` (reference restricts the same
    way). Every rank of the world calls them with the whole batch of its
    data coordinate, ``(inputs, labels)`` each stacked ``(M, micro,
    ...)`` with M = ``gradient_accumulation_steps``."""

    def __init__(self, args=None, model=None, mpu=None, config_params=None,
                 **kwargs):
        assert isinstance(model, PipelineModule), \
            "PipelineEngine requires a PipelineModule"
        self.pipe_module = model
        self._ckpt_layout = None
        self._saving = False
        self._act_meta = {}
        self.pipe_stats = {}
        _refuse_elasticity(*self._resolve_config(args, config_params))
        if model.num_stages > 1 and not dist.is_initialized():
            raise RuntimeError(
                "a pipeline of {} stages runs one process a stage: call "
                "utils.distributed.init_distributed (or run under torchrun) "
                "first".format(model.num_stages))
        super().__init__(args=args, model=model,
                         mpu=mpu if mpu is not None else model.mpu(),
                         config_params=config_params, **kwargs)
        self.num_stages = model.num_stages
        self.stage_id = model.stage_id
        self.micro_batches = self.gradient_accumulation_steps()
        log_dist("PipelineEngine: stages={} micro_batches={} mesh={} "
                 "parts={}".format(self.num_stages, self.micro_batches,
                                   self.mesh.shape, model.parts), ranks=[0])

    # ------------------------------------------------------------ setup
    def _configure_zero(self):
        """The dense engine's resolution (hpZ raises under a pipe axis),
        then qwZ and qgZ: the JAX pipeline's step gathers no weight
        through the qwZ codec and feeds no gradient through qgZ's, so here
        they warn that they have no effect (raise under
        ``zero_optimization.strict``) and stay off."""
        super()._configure_zero()
        strict = bool(getattr(self._config.zero_config, "strict", False))
        for key, live in (("zero_quantized_weights", "_qwz_enabled"),
                          ("zero_quantized_gradients", "_qgz_enabled")):
            if getattr(self, live):
                warn_or_raise_noop(
                    "zero_optimization.{} has NO effect under pipeline "
                    "parallelism: the pipeline step gathers and reduces "
                    "its stages' parameters without the ZeRO++ "
                    "codecs".format(key), strict,
                    flag="zero_optimization.strict")
                setattr(self, live, False)

    def _configure_mesh(self, mpu, mesh):
        super()._configure_mesh(mpu, mesh)
        if self.pipe_module.num_stages > 1:
            self._pipe_group = self.mesh.get_group(PIPE_AXIS)

    def _module_fn(self, name):
        if not hasattr(self.module, name):
            raise NotImplementedError("PipelineModule has no {}".format(name))
        return getattr(self.module, name)

    def _module_attr(self, name):
        return getattr(self.module, name, None)

    def _init_state(self):
        stage = self.zero_optimization_stage()
        if stage >= 2 and self.mp_world_size > 1:
            # the JAX engine's certified-combination guard
            # (docs/_tutorials/parallelism.md), kept with its message
            raise PipelineError(
                "ZeRO stage {} with pipeline + tensor parallelism is not "
                "a certified combination (the stage>=2 data-axis "
                "resharding deadlocks against the pipe loop's collectives "
                "under one-program SPMD). Use ZeRO stage 1 with PP x TP, "
                "or drop tensor parallelism for ZeRO stage 2/3 under PP. "
                "See docs/_tutorials/parallelism.md for the support "
                "matrix.".format(stage))
        super()._init_state()
        if self.zero3 is not None:
            # the unit calls recompute each layer: no checkpoint inside
            for chunk in self.module.body:
                for layer in chunk:
                    cfg = getattr(layer, "config", None)
                    if getattr(cfg, "remat", False):
                        layer.config = dataclasses.replace(cfg, remat=False)
        self._configure_tied()

    def _configure_tied(self):
        """The tied parameters' slice of the flat layout (it leads it), the
        group of the two stages that hold them, and whether this stage
        counts them in the norm."""
        module, flat = self.module, self.flat
        S, r = module.num_stages, module.stage_id
        both = {k for kind, k, _ in module.pre_layers if kind == "tied"} & \
            {k for kind, k, _ in module.post_layers if kind == "tied"}
        tied = [i for i, n in enumerate(flat.names) if n.startswith("tied.")]
        self._tied_end = 0
        self._tied_ranges = flat.owned_ranges(tied)
        if tied and not flat.stage3:
            last = max(tied)
            if tied != list(range(last + 1)):
                raise RuntimeError("tied parameters must lead the flat "
                                   "layout: {}".format(flat.names[:4]))
            self._tied_end = flat.offsets[last] + int(np.prod(
                flat.shapes[last]))
        self._tied_group = None
        if both and S > 1 and r in (0, S - 1):
            self._tied_group = self.mesh.pair_group(0, S - 1)[0]
        # the norm counts a tied element once: on the stage that owns it
        self._tied_skip = bool(tied) and any(
            module.tied_owner(k) != r for k in module.tied)
        self._tied_acc = None
        if self._tied_group is not None and flat.stage3:
            # stage 3: the tied leaves' gradients bypass their unit's
            # reduce-scatter, whole in fp32 until the pair sum
            flat.hold([flat.names[i] for i in tied])
        elif self._tied_group is not None and flat.grads_sharded:
            # at stage 2 the tied slice is kept whole (fp32) through the
            # micro-steps, so the pair sum precedes the data reduction
            self._tied_acc = torch.zeros(self._tied_end, dtype=torch.float32,
                                         device=self.device)

    # --------------------------------------------------- the apply hooks
    def _fold(self):
        """One backward's gradients into the accumulator."""
        flat = self.flat
        if self._tied_acc is not None:
            head = flat.grads[:self._tied_end]
            self._tied_acc.add_(head)
            head.zero_()
        flat.fold_grads()

    def _reduce_tied_grads(self):
        if self._tied_group is None:
            return
        t0 = time.perf_counter()
        flat, end = self.flat, self._tied_end
        with record_function("pipe.tied_reduce"):
            if flat.held:
                all_reduce_(flat.held_acc, self._tied_group)
                if self._dp_group is not None:
                    all_reduce_(flat.held_acc, self._dp_group)
                flat.fold_held()
            elif self._tied_acc is None:
                all_reduce_(flat.acc[:end], self._tied_group)
            else:
                all_reduce_(self._tied_acc, self._tied_group)
                if self._dp_group is not None:
                    all_reduce_(self._tied_acc, self._dp_group)
                a, b = max(flat.lo, 0), min(flat.hi, end)
                if a < b:
                    flat.acc[a - flat.lo:b - flat.lo].add_(
                        self._tied_acc[a:b].to(flat.acc.dtype))
                self._tied_acc.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pipe_stats["tied_reduce_s"] = time.perf_counter() - t0

    def _grad_squares(self, grads, rep_ranges):
        if not self._tied_skip:
            return super()._grad_squares(grads, rep_ranges)
        if self.flat.stage3:
            # no TP under PP at stage 3: every owned element but the tied
            # leaves' ranges
            return (self._squares(grads, self._complement(
                self._tied_ranges, grads.numel())),
                grads.new_zeros((), dtype=torch.float64))
        rep_end = rep_ranges[0][1] if rep_ranges else 0
        # the tied slice leads the layout: [0, b) in owned coordinates
        b = min(max(self._tied_end - self.flat.lo, 0), grads.numel())
        return (self._squares(grads, [(max(rep_end, b), grads.numel())]),
                self._squares(grads, [(b, rep_end)]))

    # --------------------------------------------------------- the API
    def forward(self, *args, **kwargs):
        raise PipelineError(
            "Only train_batch() / eval_batch() are accessible in pipeline mode")

    def backward(self, *args, **kwargs):
        raise PipelineError(
            "Only train_batch() / eval_batch() are accessible in pipeline mode")

    def step(self, *args, **kwargs):
        raise PipelineError(
            "Only train_batch() / eval_batch() are accessible in pipeline mode")

    def is_gradient_accumulation_boundary(self):
        return True

    def _stack_microbatches(self, data_iter):
        micro = [tuple(next(data_iter)) for _ in range(self.micro_batches)]
        return tuple(np.stack([np.asarray(m[i]) for m in micro])
                     for i in range(2))

    def _batch(self, data_iter, batch):
        if batch is None:
            assert data_iter is not None, \
                "train_batch needs batch= or data_iter="
            batch = self._stack_microbatches(data_iter)
        inputs, labels = (self._to_device(x) for x in batch)
        if inputs.shape[0] != self.micro_batches:
            raise ValueError(
                "a pipeline batch stacks gradient_accumulation_steps={} "
                "micro-batches, got {}".format(self.micro_batches,
                                               inputs.shape[0]))
        if self._dp_group is not None:
            self._check_rows((inputs, labels), 1)
        return inputs, labels

    def _activation_meta(self, inputs):
        """Shape and dtype of the activation between stages for inputs of
        this shape: the first stage runs its head layers on micro-batch 0
        and broadcasts them over the pipe group (once per input shape)."""
        key = (tuple(inputs.shape[1:]), str(inputs.dtype))
        if key not in self._act_meta:
            meta = torch.zeros(_MAX_DIMS + 2, dtype=torch.int64,
                               device=self.device)
            if self.stage_id == 0:
                with torch.no_grad():
                    x = self.module.apply_pre(inputs[0])
                meta[0], meta[-1] = x.dim(), _DTYPES.index(x.dtype)
                meta[1:1 + x.dim()] = torch.tensor(x.shape)
            if self._pipe_group is not None:
                broadcast_(meta, src=self.mesh.stage_rank(0),
                           group=self._pipe_group)
            meta = meta.tolist()
            self._act_meta[key] = (tuple(meta[1:1 + meta[0]]),
                                   _DTYPES[meta[-1]])
        return self._act_meta[key]

    def _layer_seeds(self, base, m, c):
        """Dropout seeds of chunk ``c``'s layers for micro-batch ``m``
        (None without dropout): a function of the batch's draw, the
        micro-batch, the virtual stage and the layer, so the backward's
        recompute redraws the forward's masks."""
        if base is None:
            return None
        j = (m * self.module.num_virtual + c) * self.num_stages + \
            self.stage_id
        return [(base * 1000003 + j * 1009 + i) % (2 ** 62)
                for i in range(len(self.module.body[c]))]

    def _dropout_base(self):
        config = getattr(self.module, "config", None)
        if not self.module.training or \
                getattr(config, "dropout", 1.0) <= 0.0:
            return None
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=self._generator))

    def train_batch(self, data_iter=None, batch=None):
        """One batch of M = ``gradient_accumulation_steps`` micro-batches
        through the pipeline, then the optimizer step on every stage
        (reference train_batch :244). Returns the mean loss over the
        micro-batches and the data group, a 0-dim fp32 tensor, on every
        rank."""
        inputs, labels = self._batch(data_iter, batch)
        self.module.train()
        loss = self._run_train(inputs, labels)
        self._take_model_step()
        self.micro_steps += self.micro_batches
        self.global_samples += self.train_batch_size()
        return loss

    def _mean_loss(self, loss_sum):
        total = loss_sum.reshape(1)
        if self._pipe_group is not None:
            all_reduce_(total, self._pipe_group)
        total = total / self.micro_batches
        if self._dp_group is not None:
            total = all_reduce_(total, self._dp_group) / self.dp_world_size
        return total[0]

    def _run_train(self, inputs, labels):
        module = self.module
        S, r, v, M = self.num_stages, self.stage_id, module.num_virtual, \
            self.micro_batches
        tabs = interleaved_train_schedule_tables(M, S, v)
        fwd_m, fwd_c = tabs["fwd_m"], tabs["fwd_c"]
        bwd_m, bwd_c = tabs["bwd_m"], tabs["bwd_c"]
        W = tabs["buffer_slots"]
        shape, dtype = self._activation_meta(inputs)
        # stage 3: the forward phase keeps each unit call's input (its
        # recompute is the checkpoint), so nothing runs a third time
        save = module.save_residuals or self.zero3 is not None
        seed_scale = self.scaler.cur_scale / M
        base = self._dropout_base()
        hop = p2p.Hop(self.mesh, r, S)
        first = lambda c: r == 0 and c == 0          # noqa: E731
        last = lambda s, c: s == S - 1 and c == v - 1  # noqa: E731

        def embed(m):
            return module.apply_pre(inputs[m])

        def run(c, x, m):
            return module.run_chunk(c, x, self._layer_seeds(base, m, c))

        stash = {}
        recv_f = recv_b = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        p2p_s, peak_stash = 0.0, 0
        for k in range(tabs["total_cycles"]):
            m, c = int(fwd_m[r, k]), int(fwd_c[r, k])
            if m >= 0:
                slot = (c, m % W)
                assert slot not in stash, "schedule slot reused"
                if save:
                    with torch.enable_grad(), record_function("pipe.fwd"):
                        x = embed(m) if first(c) else recv_f.requires_grad_()
                        y = run(c, x, m)
                    stash[slot] = (x, y)
                else:
                    stash[slot] = None if first(c) else recv_f
                    if not last(r, c):
                        # the backward recomputes the stage, so the last
                        # virtual stage skips this forward
                        with torch.no_grad(), record_function("pipe.fwd"):
                            y = run(c, embed(m) if first(c) else recv_f, m)
                if not last(r, c):
                    hop.send_forward(y.detach())
                peak_stash = max(peak_stash, len(stash))
            m, c = int(bwd_m[r, k]), int(bwd_c[r, k])
            if m >= 0:
                entry = stash.pop((c, m % W))
                with torch.enable_grad(), record_function("pipe.bwd"):
                    if save:
                        x, y = entry
                    else:
                        x = embed(m) if first(c) else \
                            entry.detach().requires_grad_()
                        y = run(c, x, m)
                    if last(r, c):
                        loss = module.post_loss(y, labels[m])
                        torch.autograd.backward(loss.float() * seed_scale)
                        loss_sum += loss.detach().float()
                    else:
                        torch.autograd.backward(y, grad_tensors=recv_b)
                if not first(c):
                    hop.send_backward(x.grad)
                del x, y, entry
                self._fold()
            # what the neighbours sent this cycle arrives for the next one
            recv_f = recv_b = None
            prev, nxt = (r - 1) % S, (r + 1) % S
            if fwd_m[prev, k] >= 0 and not last(prev, int(fwd_c[prev, k])):
                recv_f = hop.recv_forward(torch.empty(
                    shape, dtype=dtype, device=self.device))
            if bwd_m[nxt, k] >= 0 and not (nxt == 0 and bwd_c[nxt, k] == 0):
                recv_b = hop.recv_backward(torch.empty(
                    shape, dtype=dtype, device=self.device))
            t0 = time.perf_counter()
            with record_function("pipe.p2p"):
                hop.run()
            p2p_s += time.perf_counter() - t0
        assert not stash, "micro-batches left without a backward"
        self.pipe_stats.update(p2p_s=p2p_s, cycles=tabs["total_cycles"],
                               peak_stash=peak_stash, buffer_slots=W)
        return self._mean_loss(loss_sum)

    def eval_batch(self, data_iter=None, batch=None):
        """Forward-only evaluation through the pipeline (reference
        InferenceSchedule, schedule.py:129-179), over the packed
        forward-only tables; each stage touches only its own layers, and
        dropout is off. Returns the mean loss, as :meth:`train_batch`."""
        inputs, labels = self._batch(data_iter, batch)
        module = self.module
        S, r, v, M = self.num_stages, self.stage_id, module.num_virtual, \
            self.micro_batches
        tabs = packed_inference_schedule_tables(M, S, v)
        fwd_m, fwd_c = tabs["fwd_m"], tabs["fwd_c"]
        shape, dtype = self._activation_meta(inputs)
        was_training = module.training
        module.train(False)
        hop = p2p.Hop(self.mesh, r, S)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        recv_f = None
        try:
            with torch.no_grad():
                for k in range(tabs["total_cycles"]):
                    m, c = int(fwd_m[r, k]), int(fwd_c[r, k])
                    if m >= 0:
                        x = module.apply_pre(inputs[m]) \
                            if r == 0 and c == 0 else recv_f
                        y = module.run_chunk(c, x)
                        if r == S - 1 and c == v - 1:
                            loss_sum += module.post_loss(
                                y, labels[m]).float()
                        else:
                            hop.send_forward(y)
                    recv_f = None
                    prev = (r - 1) % S
                    if fwd_m[prev, k] >= 0 and not (
                            prev == S - 1 and fwd_c[prev, k] == v - 1):
                        recv_f = hop.recv_forward(torch.empty(
                            shape, dtype=dtype, device=self.device))
                    hop.run()
        finally:
            module.train(was_training)
        return self._mean_loss(loss_sum)

    # ---------------------------------------------------- JAX-shaped trees
    def _tree_converters(self):
        module = self.module

        def from_jax(tree):
            return module.stage_state_from_tree(tree, self._ckpt_layout)

        def opt_from_jax(state):
            return {"step": int(np.asarray(state["step"])),
                    "exp_avg": from_jax(state["exp_avg"]),
                    "exp_avg_sq": from_jax(state["exp_avg_sq"])}

        def refuse(*_):
            raise NotImplementedError(
                "a pipeline stage alone has no whole tree: use the "
                "engine's get_master_params()")

        return {"params_from_jax": from_jax, "params_to_jax": refuse,
                "optimizer_state_from_jax": opt_from_jax,
                "optimizer_state_to_jax": refuse}

    def _jax_tree(self, buf, keep_dtype=False):
        """A flat buffer's whole JAX pipeline tree ``{"tied", "pre",
        "post", "body"}``, every stage's part gathered over the data and
        model groups and then the pipe group (every rank must call):
        numpy fp32, or CPU tensors of the buffer's dtype with
        ``keep_dtype``."""
        state = self._full_tree(buf, keep_dtype)
        states = [state]
        if self._pipe_group is not None and self._saving:
            # a save needs the tree on global rank 0 only (it writes the
            # model file): the other pipe lines gather nothing
            root = self.mesh.stage_rank(0)
            if root != 0:
                return None
            states = [None] * self.num_stages if self.global_rank == 0 \
                else None
            dist.gather_object(state, states, dst=0, group=self._pipe_group)
            if states is None:
                return None
        elif self._pipe_group is not None:
            states = [None] * self.num_stages
            dist.all_gather_object(states, state, group=self._pipe_group)
        tree = self.module.pipe_tree(states)
        return tree if keep_dtype else _to_numpy(tree)

    def get_master_params(self):
        """The fp32 master weights as the JAX pipeline's tree of numpy
        arrays (``{"tied", "pre", "post", "body"}``, the body stacked
        ``(S, L, ...)`` or ``(S, v, L, ...)`` with padded slots holding
        their stage's first layer); every rank must call."""
        return self._jax_tree(self.flat.master)

    def get_optimizer_state(self):
        return {"step": self.flat.step,
                "exp_avg": self._jax_tree(self.flat.exp_avg),
                "exp_avg_sq": self._jax_tree(self.flat.exp_avg_sq)}

    def _jax_leaf_names(self):
        """The whole pipeline tree's leaf paths in the JAX flatten order
        (the per-leaf order of the zero files)."""
        return [".".join(map(str, path)) for path, _ in
                ckpt.tree_leaves_with_paths(_Shapes.wrap(
                    self.module.pipe_tree_template()))]

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_save=False):
        """The JAX engine's pipeline tag (every rank must call): the
        engine's files with the whole pipeline tree, ``client_state
        ["pipe_layout"]`` (parts, layers_per_stage, num_virtual), and one
        ``layer_NN-model_00-model_states.pt`` per real body layer (the
        compute-dtype layer tree), written by each stage's first data and
        model rank; the manifest and ``latest`` only after every file."""
        client_state = dict(client_state or {})
        client_state["pipe_layout"] = self.module.layout()
        self._saving = True
        try:
            return super().save_checkpoint(save_dir, tag=tag,
                                           client_state=client_state,
                                           save_latest=save_latest,
                                           async_save=async_save)
        finally:
            self._saving = False

    def _gathered_offload(self):
        return True

    def _save_extra_files(self, save_dir, tag, note, async_save):
        state = self._full_tree(self.flat.params, keep_dtype=True)
        tp_rank = dist.get_rank(self._tp_group) \
            if self._tp_group is not None else 0
        if self.dp_rank or tp_rank:
            return
        module = self.module
        for c in range(module.num_virtual):
            for j, g in enumerate(module.body_ids(c)):
                prefix = "body.{}.{}.".format(c, j)
                layer = _nest({k[len(prefix):]: v for k, v in state.items()
                               if k.startswith(prefix)})
                note(ckpt.save_state_dict(
                    ckpt.layer_ckpt_name(save_dir, tag, g), layer,
                    async_save=async_save))

    def _zero_shard_payload(self):
        """This rank's zero file (``device_shards``; under offload
        ``offload_shards``): its owned range of the master and the moments
        as boxes of the whole pipeline tree's leaves. A body layer's boxes sit at its stage (and chunk) and slot
        of the stacked leaf; its stage's padded slots (ragged partitions)
        get the first layer's boxes, as the JAX module fills them; a tied
        leaf is written by the stage that owns it, a leaf every model rank
        holds whole by model rank 0, so no two ranks write one
        element."""
        flat, module = self.flat, self.module
        S, r, v = module.num_stages, module.stage_id, module.num_virtual
        L = module.layers_per_stage
        tp = self._tp_place()
        order = self._jax_leaf_names()
        shapes = dict(zip(order, (
            leaf.shape for _, leaf in ckpt.tree_leaves_with_paths(
                _Shapes.wrap(module.pipe_tree_template())))))

        def boxes(name, shape, box):
            _, _, path, slot = module._layer_of(name)
            if name.startswith("tied.") and \
                    module.tied_owner(name.split(".")[1]) != r:
                return []
            if tp is None:
                parts = [(tuple(box), ())]
            else:
                rank, size, full_boxes, spec_fn = tp
                if rank != 0 and spec_fn(name, shape) is None:
                    return []
                parts = full_boxes(name, shape, box, rank, size)[1]
            if slot is None:
                return [(path, full, index) for full, index in parts]
            c, j = slot
            jv = c * S + r
            depth = module.parts[jv + 1] - module.parts[jv]
            out = []
            for jj in [j] + (list(range(depth, L)) if j == 0 else []):
                lead = ((r, r + 1), (jj, jj + 1)) if v == 1 else \
                    ((r, r + 1), (c, c + 1), (jj, jj + 1))
                out += [(path, lead + tuple(full), index)
                        for full, index in parts]
            return out

        bufs = {key: flat.own(getattr(flat, key)).detach().cpu()
                for key in ("master", "exp_avg", "exp_avg_sq")}
        lists = {key: {path: [] for path in order} for key in bufs}
        for name, off, shape in zip(flat.names, flat.offsets, flat.shapes):
            n = int(np.prod(shape)) if shape else 1
            for lo, hi, local in flat.spans:
                a, b = max(off, lo), min(off + n, hi)
                for box, blo, bhi in ckpt.flat_range_boxes(shape, a - off,
                                                           b - off):
                    dims = tuple(z - y for y, z in box)
                    for path, full, index in boxes(name, shape, box):
                        key = ckpt.shard_key(tuple(slice(y, z)
                                                   for y, z in full))
                        for what, host in bufs.items():
                            data = host[local + off + blo - lo:
                                        local + off + bhi - lo]
                            lists[what][path].append(
                                (key, data.view(dims)[index]))

        def as_lists(what):
            return [(shapes[path], lists[what][path]) for path in order]

        if self.offload is not None:
            # (key, master, exp_avg, exp_avg_sq), each the box's shape of
            # the stacked leaf, as the JAX engine's host shards
            def host(t, key):
                return np.ascontiguousarray(t.float().numpy()).reshape(
                    tuple(b - a for a, b, _ in key))

            return {"offload_shards": [
                [(key, host(p, key), host(m, key), host(v, key))
                 for (key, p), (_, m), (_, v) in zip(
                     lists["master"][path], lists["exp_avg"][path],
                     lists["exp_avg_sq"][path])]
                for path in order],
                "offload_step": int(flat.step),
                "torn_step": self.offload.torn_step}
        return {"device_shards": {
            "master": as_lists("master"),
            "opt": {"step": np.asarray(flat.step, np.int32),
                    "exp_avg": as_lists("exp_avg"),
                    "exp_avg_sq": as_lists("exp_avg_sq")},
            "qg_error": None}}

    def _adapt_state_dict(self, sd):
        """Read the tag's stage layout (``pipe_layout``; a tag without one
        was written at this module's): the stage's layers are picked from
        the stacked leaves under it, so a tag written at one (S, v, ragged
        or not) loads at another."""
        layout = sd.get("pipe_layout") or self.module.layout()
        if layout["parts"][-1] != self.module.parts[-1]:
            raise RuntimeError(
                "checkpoint holds {} body layers, the module {}".format(
                    layout["parts"][-1], self.module.parts[-1]))
        self._ckpt_layout = layout
        return sd

    def _zero_state(self, load_dir, tag, sd, load_optimizer_states):
        master, opt = super()._zero_state(load_dir, tag, sd,
                                          load_optimizer_states)
        conv = self._tree_converters()["params_from_jax"]
        if master is not None:
            master = conv(_nest(master))
        if opt is not None:
            opt = dict(opt, exp_avg=conv(_nest(opt["exp_avg"])),
                       exp_avg_sq=conv(_nest(opt["exp_avg_sq"])))
        return master, opt

    def _load_checkpoint_tag(self, *args, **kwargs):
        try:
            return super()._load_checkpoint_tag(*args, **kwargs)
        finally:
            self._ckpt_layout = None


class _Shapes:
    """A leaf of a shape template (a tuple would read as a subtree)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    @classmethod
    def wrap(cls, tree):
        if isinstance(tree, dict):
            return {k: cls.wrap(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cls.wrap(v) for v in tree]
        if isinstance(tree, tuple):
            return cls(tree)
        return tree


def _refuse_elasticity(json_file, param_dict):
    """Elasticity with pipeline parallelism raises (the JAX engine's
    refusal, reference pipe/engine.py:57-58)."""
    if param_dict is None and json_file is not None and \
            os.path.isfile(json_file):
        with open(json_file) as f:
            param_dict = json.load(f)
    section = (param_dict or {}).get("elasticity")
    if section and (not isinstance(section, dict) or
                    section.get("enabled", True) is not False):
        raise PipelineError(
            "Elasticity is not supported with pipeline parallelism "
            "(reference restriction, pipe/engine.py:57-58)")
