"""DeepSpeedEngine: the training engine, on one device or data- and
tensor-parallel over ``torch.distributed``.

Port of ``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``, returned by
``deepspeed_tpu_torch.initialize()``. The same step anatomy and method
names:

* micro step (``forward`` + ``backward``): the loss times ``loss_scale /
  gradient_accumulation_steps`` is back-propagated into the flat
  compute-dtype gradient buffer (every ``.grad`` is a view of it), then
  one ``add_`` folds it into the fp32 accumulator;
* apply step (``step`` at an accumulation boundary): overflow check,
  unscale, clip or norm, the optimizer update over the flat fp32 master
  partition (Adam/AdamW: one launch of its CUDA kernel; LAMB: its stage-1
  and apply kernels, one trust ratio per entry of the partition's segment
  table, i.e. per parameter), overflow skip, master -> compute-dtype
  params, zero the accumulator, loss-scale update, and the
  ``progressive_layer_drop`` schedule when the section is on;
* ``train_batch(batch=(...))``: all micro steps of one global batch, each
  input stacked ``(gas, global_batch, ...)`` as the JAX package takes it,
  then the apply step.

Where the JAX engine keeps the overflow flag on the device and selects the
old state branchlessly, this engine reads the flag on the host once per
optimizer step (one small synchronisation) and skips the update.

The model is an ``nn.Module`` whose ``forward(*batch)`` returns the loss
(``models.gpt2.GPT2Model``, ``models.bert.BertModel``); a ``generator``
keyword, when the forward takes one, receives the engine's dropout
generator, and ``progressive_layer_drop`` / ``pld_theta``, when it takes
them, the PLD state. Its parameters become views of the engine's flat
buffers on ``device``, CUDA unless the caller asks for the CPU. The JAX-tree
methods (``get_master_params``, ``get_optimizer_state``,
``load_state_from_jax``) use the converters of the model's own module
(``params_to_jax`` and friends).

Data parallelism (ZeRO stages 0-2): inside a process group the mesh's
``data`` axis (``mesh=``, ``mpu``, or every rank on it) is the data
group. Each rank passes its own rows, ``(gas, micro, ...)`` to
:meth:`train_batch` and ``(micro, ...)`` to :meth:`forward`, as the JAX
engine's multi-process path feeds each process; another row count raises
``ValueError``. The flat buffers are partitioned over the data group
(``runtime/zero/partition.py``): stage 0 keeps every buffer whole and
all-reduces the accumulator at the boundary; stage 1 keeps only the
owned range of the master and the moments, all-reduces the accumulator
and steps the owned range; stage 2 also keeps only the owned range of the
accumulator, into which each micro-step's gradients are reduce-scattered.
Every stage scales the summed gradients once by ``1 / dp_world`` (the
mean over the global batch, as the JAX engine's loss; it has no
predivide), takes the overflow flag and the global norm over the group
(from the owned ranges when partitioned), and after the step all-gathers
the updated owned ranges into the compute-dtype parameters. Every stage
sums the gradients over the group in the accumulator's dtype, so the
stages give the same bits at one micro-step a step. The loss
:meth:`train_batch` returns is the mean over the data group.

Tensor parallelism: with an ``mpu`` (Megatron style, or an object with a
``.mesh``) or a ``mesh=`` whose ``model`` axis n > 1, and the ds_config
``comm.collective_matmul`` section on, the engine swaps the module for
this rank's shard (``tensor_parallel_shard``), whose own copy of the
config carries a ``CollectiveMatmulBinding`` over the model group; the
four TP sites of each block then run the ring ops. After the micro steps
it all-reduces the gradients of the parameters every rank holds whole
over the group, reduces the overflow flag (max) and the global gradient
norm (each sharded square once, each replicated one once), so every rank
takes the same decisions and issues the same hops. With both axes the
data reduction runs first, over the data group, and the model ranks of
one data coordinate own the same range of the same layout. The JAX-tree
methods gather or slice the full tree (over the data group, then the
model group).

The rest of the API, as the JAX engine: a client optimizer
handle (``optimizer=``: the port's ``FusedAdam``, ``FusedLamb`` or
``SGD``), an LR schedule (``lr_scheduler=``, or the ds_config
``scheduler`` section, ``runtime/lr_schedules.py``) stepped after every
apply step that was not skipped, ``training_data=`` through
:meth:`deepspeed_io`, and ``model_parameters=`` as initial weights.

ZeRO stage 3 (``runtime/zero/stage3.py``) gathers each unit over the
data group around its call; under tensor parallelism the units hold the
rank's TP shards (the replicated leaves' ranges of each unit,
``FlatPartition.own_replicated``, are all-reduced over the model group
and counted once in the norm). Streamed parameter offload
(``zero_optimization.cpu_offload_params``, one process; the JAX engine's
refusals with its messages) keeps every parameter in host memory:
``forward`` runs the runner's streamed forward and backward
(``runtime/zero/stream.py``, ``stream_runner``), ``backward`` is
bookkeeping, and the apply step is its host Adam
(``offload_phase_times`` holds the step's phase clocks).

Pipeline parallelism (``runtime/pipe/engine.py``) subclasses this
engine: its stage's parameters fill the flat buffers, and the apply step
and the checkpoints call the hooks it overrides (``_reduce_tied_grads``
before the data reduction, ``_grad_squares``, the pipe group in the
flag's and the norm's reduction, ``_save_extra_files``,
``_adapt_state_dict``); here they do nothing.

Checkpoints (:meth:`save_checkpoint`, :meth:`load_checkpoint`) are the
JAX engine's tags (``runtime/checkpointing.py``): a tag either package
writes loads in the other, at any data- and tensor-parallel layout. The
``activation_checkpointing`` section configures
``deepspeed_tpu_torch.checkpointing``. Telemetry comes with a later
slice.
"""
import inspect
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..inference.engine import resolve_device
from ..ops.adam.fused_adam import FusedAdam
from ..ops.lamb.fused_lamb import FusedLamb
from ..ops.sgd import SGD
from ..ops.transformer.attention import resolve_flash_backend
from ..parallel.collective_matmul import CollectiveMatmulBinding
from ..parallel.topology import (DATA_AXIS, DATA_REPLICA_AXIS,
                                 DATA_SHARD_AXIS, MODEL_AXIS, PIPE_AXIS,
                                 build_mesh, factor_data_axis)
from ..utils.distributed import (all_gather, all_reduce_, broadcast_,
                                 local_world_size)
from ..utils.logging import log_dist, logger
from ..utils.timer import ThroughputTimer
from . import checkpointing as ckpt
from . import utils as rt_utils
from .comm.config import warn_or_raise_noop
from .comm.quantize import (FusedFlatLayout, fma,
                            hierarchical_all_reduce_local, qc_padded_size,
                            quantized_all_reduce_local)
from .config import DeepSpeedConfig
from .constants import (ADAM_OPTIMIZER, LAMB_OPTIMIZER, MAX_GRAD_NORM,
                        ONEBIT_ADAM_OPTIMIZER, ROUTE_TRAIN)
from .dataloader import DeepSpeedDataLoader
from .fp16 import loss_scaler as ls
from .fp16.onebit_adam import OnebitAdam
from .lr_schedules import SCHEDULE_CLASSES
from .progressive_layer_drop import ProgressiveLayerDrop
from .zero.offload import HostOffload
from .zero.partition import FlatPartition
from .zero.stage3 import Stage3
from .zero.stream import StreamedOffloadRunner

FUSED_KERNEL_MODES = ("auto", "pallas", "xla")


class DeepSpeedEngine:
    """Train a module with ZeRO stages 0-3 over a data-parallel group,
    optionally tensor-parallel over a ``model`` group, mixed precision
    over fp32 master weights and Adam/AdamW, LAMB or SGD; ZeRO-Offload
    and streamed parameter offload on the host."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device=None,
                 mesh=None):
        assert model is not None, "deepspeed.initialize requires a model"
        self.collate_fn = collate_fn
        self.device = resolve_device(device)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training_dataloader = None
        self.lr_scheduler = None
        self._configure_mesh(mpu, mesh)
        # the batch triple is checked against the data-parallel world: the
        # mesh's data axis
        self._config = DeepSpeedConfig(*self._resolve_config(
            args, config_params), world_size=self.dp_world_size)
        self.module = model
        self._load_model_parameters(model_parameters)
        self.flash_attention_backend = None
        self.fused_optimizer_kernel = None
        self._configure_precision()
        self._apply_transformer_overrides()
        self._configure_zero()
        self._configure_comm()
        self._configure_optimizer(optimizer)
        self._configure_lr_scheduler(lr_scheduler)
        self._configure_pld()
        self._configure_activation_checkpointing(mpu)
        ckpt.set_retry_policy(
            retries=self._config.checkpoint_io_retries,
            backoff_seconds=self._config.checkpoint_io_backoff_seconds)
        self._ckpt_futures = []
        self._init_state()
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.dp_world_size,
            steps_per_output=self.steps_per_print(), monitor_memory=False,
            device=self.device)
        self._generator = torch.Generator().manual_seed(
            int(os.environ.get("DEEPSPEED_SEED", 42)))
        self._forward_kwargs = set(inspect.signature(
            model.forward).parameters)
        self._pending_backward = False
        # train_batch's micro-step is the last before the apply step
        self._last_micro = None
        self._step_metrics = {}
        self._configure_sparse_gradients()
        self.module.train()
        if self._config.dump_state:
            self._config.print("DeepSpeedEngine configuration")
        log_dist("DeepSpeedEngine ready: params={:,} zero_stage={} dtype={} "
                 "device={} offload={}".format(
                     self._num_params, self.zero_optimization_stage(),
                     self.compute_dtype, self.device,
                     "streamed" if self.stream_runner is not None
                     else self.offload is not None), ranks=[0])

    # ----------------------------------------------------------------- setup

    @staticmethod
    def _resolve_config(args, config_params):
        if config_params is not None:
            if isinstance(config_params, (str, os.PathLike)):
                return str(config_params), None
            return None, config_params
        if args is not None and getattr(args, "deepspeed_config", None):
            return args.deepspeed_config, None
        raise AssertionError(
            "DeepSpeed requires --deepspeed_config or a config dict")

    def _configure_mesh(self, mpu, mesh):
        """The ``(data, model)`` process mesh, as the JAX engine's
        ``_configure_mesh``: ``mesh=``, else ``mpu.mesh``, else a
        Megatron-style ``mpu``'s model-parallel degree (and its group when
        it has one), else all ranks on the data axis."""
        tp_group = None
        if mesh is None and mpu is not None and hasattr(mpu, "mesh"):
            mesh = mpu.mesh
        if mesh is None and mpu is not None and \
                hasattr(mpu, "get_model_parallel_world_size"):
            mp = int(mpu.get_model_parallel_world_size())
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world % mp:
                raise ValueError("world size {} not divisible by model "
                                 "parallel size {}".format(world, mp))
            mesh = build_mesh(data=world // mp, model=mp)
            if hasattr(mpu, "get_model_parallel_group"):
                tp_group = mpu.get_model_parallel_group()
        if mesh is None:
            mesh = build_mesh()
        self.mesh = mesh
        self.dp_world_size = int(mesh.shape.get(DATA_AXIS, 1))
        self.mp_world_size = int(mesh.shape.get(MODEL_AXIS, 1))
        self._dp_group = mesh.get_group(DATA_AXIS) \
            if self.dp_world_size > 1 else None
        self.dp_rank = dist.get_rank(self._dp_group) \
            if self._dp_group is not None else 0
        self._tp_group = None
        # the pipeline engine's stage group (runtime/pipe/engine.py)
        self._pipe_group = None
        if self.mp_world_size > 1:
            self._tp_group = tp_group if tp_group is not None \
                else mesh.get_group(MODEL_AXIS)
        self.global_rank = dist.get_rank() if dist.is_initialized() else 0

    def _configure_zero(self):
        """The ZeRO++ modes, resolved as the JAX engine's
        ``_configure_zero`` with its warnings and errors: hpZ
        (``zero_hierarchical_partition`` N > 1 at stage 3) factors the data
        axis into ``(data_replica, data_shard)`` (``factor_data_axis``) so
        the compute-dtype pieces are partitioned over the N-rank shard
        group while the master, moments and accumulator stay partitioned
        over the whole data group; qwZ (``zero_quantized_weights``, stage
        3) gathers the units' data-sharded leaves as int8 blocks; qgZ
        (``zero_quantized_gradients``, stage >= 2) passes each
        reduce-scattered gradient piece through the error-compensated
        codec."""
        zc = self._config.zero_config
        stage = self.zero_optimization_stage()
        zero_enabled = self._config.zero_enabled
        hpz = int(zc.hierarchical_partition or 0)
        self._hpz = 0
        if hpz > 1 and not zero_enabled:
            logger.warning(
                "zero_hierarchical_partition=%d ignored: ZeRO is "
                "disabled (zero_optimization.stage=0)", hpz)
        if hpz > 1 and zero_enabled:
            if stage < 3:
                logger.warning(
                    "zero_hierarchical_partition=%d has no effect below "
                    "ZeRO stage 3 (params are not data-sharded); ignoring",
                    hpz)
            elif PIPE_AXIS in self.mesh.shape:
                raise ValueError(
                    "zero_hierarchical_partition is not a certified "
                    "combination with pipeline parallelism (the pipe "
                    "loop's shard_map specs name the flat 'data' axis)")
            elif DATA_AXIS not in self.mesh.shape or \
                    DATA_SHARD_AXIS in self.mesh.shape:
                raise ValueError(
                    "zero_hierarchical_partition needs a 'data' mesh axis "
                    "to factor; mesh has {}".format(dict(self.mesh.shape)))
            else:
                if self.dp_world_size % hpz:
                    raise ValueError(
                        "zero_hierarchical_partition={} must be >1 and "
                        "divide the data-parallel degree {}".format(
                            hpz, self.dp_world_size))
                self.mesh = factor_data_axis(self.mesh, hpz)
                self._hpz = hpz
        qc = self._config.comm_config.quantized_collectives
        if qc.enabled and qc.hierarchical >= 2 and \
                DATA_SHARD_AXIS in self.mesh.shape and \
                int(self.mesh.shape[DATA_SHARD_AXIS]) != qc.hierarchical:
            raise ValueError(
                "comm.quantized_collectives.hierarchical={} conflicts with "
                "the hpZ-factored mesh (data_shard={}); use "
                "hierarchical=0 to follow the mesh".format(
                    qc.hierarchical, int(self.mesh.shape[DATA_SHARD_AXIS])))
        # the JAX plan's param_data_axes != (): a data axis to shard over
        self._qwz_enabled = bool(zc.quantized_weights) and stage >= 3 and \
            DATA_AXIS in self.mesh.shape
        if zc.quantized_weights and stage < 3:
            logger.warning(
                "zero_quantized_weights has no effect below ZeRO stage 3 "
                "(there is no per-step weight all-gather); ignoring")
        self._qgz_enabled = bool(zc.quantized_gradients) and \
            zero_enabled and stage >= 2
        if zc.quantized_gradients and not self._qgz_enabled:
            logger.warning(
                "zero_quantized_gradients needs ZeRO stage >= 2 (the "
                "gradient reduce-scatter partition); ignoring")
        if (self._qwz_enabled or self._qgz_enabled) and \
                self.mp_world_size > 1:
            # the port's own divergence, not a JAX engine message
            logger.warning(
                "zero_quantized_weights / zero_quantized_gradients under a "
                "model axis of %d: this port's int8 blocks tile each rank's "
                "tensor-parallel shard, not the whole leaf as the JAX "
                "engine's do, so the quantized values differ from its",
                self.mp_world_size)

    def _configure_comm(self):
        """comm.collective_matmul, as the JAX engine's
        ``_configure_comm``: ``_cm_zero3``, the stage-3 unit gather as a
        ring of one-hop rotations over the data group (the shard group
        under hpZ), carrying qwZ's int8 blocks and scales when both are on
        (``runtime/zero/zeropp.py``); ``_cm_tp``, with a ``model`` axis >
        1, this rank's shard of the module, bound to a
        CollectiveMatmulBinding over the model group (the caller's model
        and config stay unbound). Tensor parallelism runs only through the
        ring ops here: a ``model`` axis > 1 without the section raises."""
        self._configure_quantized_collectives()
        cm = self._config.comm_config.collective_matmul
        self._cm = cm
        self._cm_tp = False
        self._cm_zero3 = False
        self.comm_transport = None
        if self.mp_world_size > 1 and not (cm.enabled and
                                           cm.tensor_parallel):
            raise NotImplementedError(
                "a model axis of {} runs through comm.collective_matmul in "
                "this port: set \"comm\": {{\"collective_matmul\": "
                "{{\"enabled\": true}}}} (backend \"ppermute\" or "
                "\"pallas\")".format(self.mp_world_size))
        if not cm.enabled:
            return
        zc = self._config.zero_config
        # the JAX engine runs the ring gather in no pipeline (it refuses
        # the section under a pipe axis, where the port runs its TP rings)
        self._cm_zero3 = bool(
            cm.zero_gather and self.zero_optimization_stage() >= 3 and
            DATA_AXIS in self.mesh.shape and PIPE_AXIS not in self.mesh.shape
            and not bool(zc.cpu_offload_params))
        if cm.tensor_parallel and self.mp_world_size > 1:
            if hasattr(getattr(self.module, "config", None),
                       "collective_matmul") and \
                    hasattr(self.module, "tensor_parallel_shard"):
                self.module = self.module.tensor_parallel_shard(
                    CollectiveMatmulBinding(
                        group=self._tp_group, axis=MODEL_AXIS,
                        chunks=int(cm.chunks), dtype=cm.dtype,
                        backend=cm.backend))
                self._cm_tp = True
                self.comm_transport = dist.get_backend(self._tp_group)
            else:
                raise NotImplementedError(
                    "model {} has no tensor-parallel layout (a "
                    "collective_matmul config field and "
                    "tensor_parallel_shard)".format(
                        type(self.module).__name__))
        if not (self._cm_zero3 or self._cm_tp):
            warn_or_raise_noop(
                "comm.collective_matmul is enabled but no fusion site "
                "is live (needs ZeRO stage >= 3 data-sharded params "
                "without cpu_offload_params, and/or a model mesh axis "
                "> 1 on a binding-aware model)", cm.strict,
                flag="comm.collective_matmul.strict")
        else:
            log_dist("collective_matmul ON: zero3_ring_gather={} "
                     "tp_fused={} tp={} chunks={} dtype={} backend={} "
                     "transport={}".format(
                         self._cm_zero3, self._cm_tp, self.mp_world_size,
                         cm.chunks, cm.dtype, cm.backend,
                         self.comm_transport), ranks=[0])

    def _certify_local_grad_comm(self, feature):
        """The JAX engine's gate for the features that exchange each
        worker's LOCAL gradients (``comm.quantized_collectives``,
        OneBitAdam): no model or pipe axis > 1 (the JAX body runs the model
        fully manual over the data axis). ZeRO stage 3 and qgZ are refused
        with the config (``config.reject_local_grad_combinations``)."""
        for axis in (PIPE_AXIS, MODEL_AXIS):
            if int(self.mesh.shape.get(axis, 1)) > 1:
                raise ValueError(
                    "{} is not a certified combination with the '{}' mesh "
                    "axis (the local-grad exchange runs the model fully "
                    "manual over the data axis only)".format(feature, axis))

    def _configure_quantized_collectives(self):
        """``comm.quantized_collectives``, as the JAX engine's
        ``_configure_quantized_collectives``: each micro-step's local
        gradients are averaged through the in-collective int8 ring in
        place of the fp32 reduction (``FlatPartition.exchange``).
        ``hierarchical: N`` factors the data group (dp / N, N) for the
        two-level form and must divide the data degree; a data degree of
        1 is a warned no-op (raises under ``strict``)."""
        qc = self._config.comm_config.quantized_collectives
        self._qc = qc
        self._qc_enabled = False
        self._qc_exchange = None
        if not qc.enabled:
            return
        dp = self.dp_world_size
        if qc.hierarchical >= 2 and dp > 1 and dp % qc.hierarchical:
            raise ValueError(
                "comm.quantized_collectives.hierarchical={} must divide the "
                "data-parallel degree {}".format(qc.hierarchical, dp))
        self._certify_local_grad_comm("comm.quantized_collectives")
        if bool(self._config.zero_config.cpu_offload_params):
            raise ValueError(
                "comm.quantized_collectives is not a certified "
                "combination with cpu_offload_params (the streamed "
                "runner owns its own gradient path)")
        if dp <= 1:
            warn_or_raise_noop(
                "comm.quantized_collectives has NO effect: the mesh has no "
                "data-parallel degree to exchange over", qc.strict,
                flag="comm.quantized_collectives.strict")
            return
        block = qc.block_size
        if qc.hierarchical >= 2:
            if DATA_SHARD_AXIS not in self.mesh.shape:
                self.mesh = factor_data_axis(self.mesh, qc.hierarchical)
            shard = self.mesh.get_group(DATA_SHARD_AXIS)
            replica = self.mesh.get_group(DATA_REPLICA_AXIS)
            self._qc_exchange = lambda flat: hierarchical_all_reduce_local(
                flat, shard, replica, block)
        else:
            group = self._dp_group
            self._qc_exchange = lambda flat: quantized_all_reduce_local(
                flat, group, block)
        self._qc_enabled = True
        log_dist("quantized_collectives ON: dtype={} block_size={} "
                 "hierarchical={} dp={}".format(
                     qc.dtype, block, qc.hierarchical or "flat", dp),
                 ranks=[0])

    def _local_grad_mode(self):
        """Which local-gradient variant is live, as the JAX engine:
        "stacked" (OneBitAdam: each rank keeps its own accumulated
        gradients for the 1-bit momentum exchange), "exchange"
        (``quantized_collectives`` with a plain optimizer: each micro-step
        averages through the int8 ring), or None."""
        if getattr(self, "_onebit_mode", False):
            return "stacked"
        if getattr(self, "_qc_enabled", False):
            return "exchange"
        return None

    def _resolve_onebit_mode(self):
        """OneBitAdam's certified combinations (the JAX engine's
        ``_resolve_onebit_mode``): not under a model or pipe axis, not
        with ``cpu_offload``, not with ``gradient_clipping`` (the global
        norm is never formed in the compressed regime), weight decay only
        at stage 0 (the L2 term feeds the fused momentum from the whole
        master)."""
        self._onebit_mode = isinstance(self.optimizer, OnebitAdam)
        if not self._onebit_mode:
            return
        self._certify_local_grad_comm("OneBitAdam")
        if self.zero_cpu_offload():
            raise ValueError(
                "OneBitAdam is not compatible with cpu_offload (the "
                "compressed exchange runs on device; the host step is "
                "plain Adam)")
        if self.gradient_clipping():
            raise ValueError(
                "OneBitAdam does not support gradient_clipping: the global "
                "grad norm is never materialized in the compressed regime "
                "(grads stay per-worker local)")
        if float(self.optimizer.weight_decay or 0.0) and \
                self.zero_optimization_stage() >= 1:
            raise ValueError(
                "OneBitAdam weight_decay needs replicated params (the L2 "
                "term feeds the fused flat momentum on every worker); use "
                "ZeRO stage 0 or weight_decay=0")
        self.optimizer.configure_comm(self._dp_group)

    def _onebit_frozen(self):
        """Whether the next optimizer step runs OneBitAdam's compressed
        regime: ``global_steps`` (attempted steps, skipped ones included)
        at or past ``freeze_step``."""
        return getattr(self, "_onebit_mode", False) and \
            self.optimizer.frozen_at(self.global_steps)

    def _configure_sparse_gradients(self):
        """The sparse embedding-gradient exchange, as the JAX engine: a
        model opts in through its config (``GPT2Config.
        sparse_embedding_grads`` with ``embedding_grad_mesh``, routing the
        lookup through ``ops/sparse_grads.py``); the engine records the
        module names where the exchange is live and warns where the config
        and the model disagree."""
        self.csr_tensor_module_names = set()
        model_cfg = getattr(self.module, "config", None)
        if getattr(model_cfg, "sparse_embedding_grads", False):
            grad_mesh = getattr(model_cfg, "embedding_grad_mesh", None)
            axis_size = int(grad_mesh.shape.get(DATA_AXIS, 1)) \
                if grad_mesh is not None else 1
            if axis_size > 1:
                self.csr_tensor_module_names.add("wte")
            else:
                logger.warning(
                    "sparse_embedding_grads is set but embedding_grad_mesh "
                    "has no nontrivial '%s' axis — the lookup falls back "
                    "to dense gradients", DATA_AXIS)
        if self.sparse_gradients_enabled() and \
                not self.csr_tensor_module_names:
            logger.warning(
                "sparse_gradients is enabled in ds_config but the model "
                "does not route any embedding through "
                "sparse_embedding_lookup (e.g. "
                "GPT2Config.sparse_embedding_grads=True with "
                "embedding_grad_mesh); gradients stay dense")

    def _configure_precision(self):
        if self._config.bf16_enabled or self._config.amp_enabled:
            self.compute_dtype = torch.bfloat16
        elif self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.mixed_precision = self.compute_dtype != torch.float32

    def _apply_transformer_overrides(self):
        """``transformer.flash_attention``: resolve the tri-state for this
        engine's device and pin it on the model config."""
        flash = self._config.transformer_flash_attention
        if flash is None:
            return
        resolved = resolve_flash_backend(flash, self.device)
        self.flash_attention_backend = resolved
        model_cfg = getattr(self.module, "config", None)
        if hasattr(model_cfg, "flash_attention_backend"):
            if hasattr(model_cfg, "use_flash_attention"):
                model_cfg.use_flash_attention = resolved != "xla"
            model_cfg.flash_attention_backend = resolved
            log_dist("transformer.flash_attention={} resolved to {!r}".format(
                flash, resolved), ranks=[0])
        else:
            logger.warning("transformer.flash_attention has NO effect: the "
                           "model exposes no flash_attention_backend field")

    def _load_model_parameters(self, model_parameters):
        """``initialize(model_parameters=...)``, as ``as_model`` reads it
        where an ``nn.Module`` allows: a tree of initial weights (the
        model's JAX-shaped tree, or a ``state_dict`` of its parameter
        names) loaded into the module; or the module's own parameters
        (``model.parameters()``, DeepSpeed's usual argument), which changes
        nothing. Anything else (a subset of them: frozen parameters; torch
        param groups) has no counterpart and raises."""
        if model_parameters is None:
            return
        named = dict(self.module.named_parameters())
        if isinstance(model_parameters, dict):
            state = model_parameters if set(model_parameters) == set(named) \
                else self._tree_converters()["params_from_jax"](
                    model_parameters)
            missing = sorted(set(named) - set(state))
            if missing:
                raise ValueError("model_parameters has no weights for {}"
                                 .format(", ".join(missing[:5])))
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(torch.as_tensor(np.asarray(state[name]))
                            .reshape(p.shape))
            return
        if {id(p) for p in model_parameters} != \
                {id(p) for p in named.values()}:
            raise NotImplementedError(
                "model_parameters must be all of the module's parameters "
                "(or a tree of weights): training a subset (frozen "
                "parameters) or param groups is not ported; the JAX "
                "package's engine steps the whole tree with one set of "
                "hyperparameters too")

    def _configure_optimizer(self, client_optimizer=None):
        offload = self.zero_cpu_offload()
        if client_optimizer is not None:
            if offload and \
                    getattr(client_optimizer, "adam_w_mode", None) is None:
                # the host step implements Adam only; a client optimizer
                # without Adam semantics would be silently replaced by it
                raise ValueError(
                    "zero_optimization.cpu_offload requires an Adam-family "
                    "optimizer; got client optimizer {}".format(
                        type(client_optimizer).__name__))
            if isinstance(client_optimizer, torch.optim.Optimizer) or \
                    not (hasattr(client_optimizer, "step_flat") and
                         hasattr(client_optimizer, "hyperparams")):
                raise TypeError(
                    "optimizer={}: the engine takes a port optimizer handle "
                    "(deepspeed_tpu_torch.ops: FusedAdam, FusedLamb or SGD, "
                    "as the JAX engine takes its own handles); a "
                    "torch.optim.Optimizer has no counterpart in the JAX "
                    "package".format(type(client_optimizer).__name__))
            if self.zero_optimization() and \
                    not getattr(client_optimizer, "supports_zero", True):
                raise ValueError(
                    "{} is not compatible with ZeRO (zero_optimization."
                    "stage >= 1)".format(type(client_optimizer).__name__))
            self.optimizer = client_optimizer
            log_dist("Using client optimizer {}".format(
                type(client_optimizer).__name__), ranks=[0])
            self._resolve_onebit_mode()
            return
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        if name not in (ADAM_OPTIMIZER, "adamw", LAMB_OPTIMIZER, "sgd",
                        ONEBIT_ADAM_OPTIMIZER):
            raise ValueError("Unknown optimizer: {}".format(name))
        if offload and name not in (ADAM_OPTIMIZER, "adamw"):
            # the host step is Adam-only (the JAX engine's refusal)
            raise ValueError(
                "zero_optimization.cpu_offload requires the Adam/AdamW "
                "optimizer, got '{}'".format(name))
        params = dict(self._config.optimizer_params or {})
        max_grad_norm = params.pop(MAX_GRAD_NORM, None)
        if max_grad_norm and not self._config.gradient_clipping:
            self._config.gradient_clipping = float(max_grad_norm)
        fused_kernel = params.pop("fused_kernel", None)
        if fused_kernel is not None and (
                not isinstance(fused_kernel, str) or
                fused_kernel.lower() not in FUSED_KERNEL_MODES):
            raise ValueError("optimizer.params.fused_kernel must be one of "
                             "auto|pallas|xla, got {!r}".format(fused_kernel))
        mode = (fused_kernel or "auto").lower()
        self.fused_optimizer_kernel = \
            ("pallas" if self.device.type == "cuda" else "xla") \
            if mode == "auto" else mode
        use_kernel = self.fused_optimizer_kernel == "pallas"
        if name == LAMB_OPTIMIZER:
            self.optimizer = FusedLamb(use_kernel=use_kernel, **params)
        elif name == ONEBIT_ADAM_OPTIMIZER:
            # plain math, as the JAX package's OnebitAdam
            if fused_kernel is not None:
                logger.warning("optimizer.params.fused_kernel has NO "
                               "effect: OneBitAdam has no kernel")
            self.fused_optimizer_kernel = None
            self.optimizer = OnebitAdam(**params)
        elif name == "sgd":
            if fused_kernel is not None:
                logger.warning("optimizer.params.fused_kernel has NO "
                               "effect: SGD has no kernel")
            self.fused_optimizer_kernel = None
            self.optimizer = SGD(**params)
        else:
            if name == "adamw":
                params.setdefault("adam_w_mode", True)
            self.optimizer = FusedAdam(use_kernel=use_kernel, **params)
            if offload:
                # the step runs in the host op (csrc/cpu_adam.cpp)
                self.fused_optimizer_kernel = "host"
        self._resolve_onebit_mode()
        log_dist("Using DeepSpeed optimizer: {} (apply: {})".format(
            name, self.fused_optimizer_kernel), ranks=[0])

    def _configure_lr_scheduler(self, client_lr_scheduler):
        """A client schedule (anything with ``step()``), else the ds_config
        ``scheduler`` section's, over the optimizer handle, else None."""
        if client_lr_scheduler is not None:
            if not callable(getattr(client_lr_scheduler, "step", None)):
                raise TypeError(
                    "lr_scheduler={}: a schedule needs a step() method "
                    "(runtime/lr_schedules.py's schedules have one)".format(
                        type(client_lr_scheduler).__name__))
            self.lr_scheduler = client_lr_scheduler
            return
        name = self._config.scheduler_name
        if name is None:
            self.lr_scheduler = None
            return
        cls = SCHEDULE_CLASSES.get(name)
        if cls is None:
            raise ValueError("Unknown lr schedule: {}".format(name))
        self.lr_scheduler = cls(self.optimizer,
                                **(self._config.scheduler_params or {}))
        log_dist("DeepSpeed using configured LR scheduler = {}".format(name),
                 ranks=[0])

    def _configure_pld(self):
        if self._config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                **(self._config.pld_params or {}))
        else:
            self.progressive_layer_drop = None

    def _configure_activation_checkpointing(self, mpu):
        """The ``activation_checkpointing`` section, as the JAX engine
        applies it: when present and the module is not configured yet (a
        user's own ``configure()`` call wins); a section ``configure``
        refuses (contiguous memory without partitioned activations) warns:
        such a section needs the explicit call."""
        if "activation_checkpointing" not in (self._config._param_dict or {}):
            return
        from .activation_checkpointing import checkpointing as act_ckpt
        if act_ckpt.is_configured():
            return
        try:
            act_ckpt.configure(mpu if mpu is not None else self.mesh,
                               deepspeed_config=self._config)
        except (AssertionError, ValueError) as err:
            logger.warning(
                "activation_checkpointing config could not be applied "
                "(%s); call deepspeed_tpu_torch.checkpointing.configure() "
                "with explicit kwargs", err)

    def _validate_zero_keys(self, zc):
        """The zero_optimization keys the port cannot give a meaning warn,
        or raise under ``zero_optimization.strict``, as the JAX engine's
        ``_validate_zero_keys``; the live ones drive the partition
        (``stage3_param_persistence_threshold``,
        ``stage3_max_live_parameters``) and the offload step
        (``sub_group_size``, ``stage3_prefetch_bucket_size``)."""
        from .zero.constants import \
            ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT
        strict = bool(getattr(zc, "strict", False))
        if zc.max_reuse_distance is not None and zc.max_reuse_distance != \
                ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT:
            warn_or_raise_noop(
                "zero_optimization.stage3_max_reuse_distance has NO effect "
                "in this port: stage 3 gathers each unit just before its "
                "use and frees it just after, in the forward and again in "
                "the backward; no gathered unit is kept for reuse",
                strict, flag="zero_optimization.strict")
        if zc.cpu_offload_use_pin_memory:
            warn_or_raise_noop(
                "zero_optimization.cpu_offload_use_pin_memory has NO "
                "effect in this port: the offload step always pins its "
                "transfer staging buffers and never the host master and "
                "moments", strict, flag="zero_optimization.strict")

    def zero_cpu_offload(self):
        """ZeRO-Offload live: ``cpu_offload`` at a ZeRO stage (the flag is
        ignored at stage 0, as the JAX engine does), or streamed parameter
        offload (its optimizer state lives in host memory by
        construction)."""
        return bool(self.zero_optimization() and
                    (self._config.zero_config.cpu_offload or
                     self.zero_params_offload()))

    def zero_quantized_weights(self):
        """qwZ live: stage-3 unit gathers carry int8 blocks."""
        return getattr(self, "_qwz_enabled", False)

    def zero_hierarchical_partition(self):
        """hpZ live: the secondary partition's (shard group's) size, or
        0."""
        return getattr(self, "_hpz", 0)

    def zero_quantized_gradients(self):
        """qgZ live: reduce-scattered gradients pass the
        error-compensated codec."""
        return getattr(self, "_qgz_enabled", False)

    def zero_params_offload(self):
        """Streamed parameter offload live (``cpu_offload_params``): the
        compute parameters live in host memory and are uploaded a layer
        group at a time inside the step (``runtime/zero/stream.py``)."""
        return bool(self.zero_optimization() and
                    self._config.zero_config.cpu_offload_params)

    def _check_params_offload(self, zc, stage):
        """The JAX engine's refusals of ``cpu_offload_params``, with its
        messages (the single-process and model ones are the runner's)."""
        if zc.cpu_offload_params and not self.zero_optimization():
            raise ValueError(
                "zero_optimization.cpu_offload_params requires ZeRO "
                "(zero_optimization.stage=3)")
        if not self.zero_params_offload():
            return
        if stage < 3:
            raise ValueError(
                "zero_optimization.cpu_offload_params is a ZeRO-3 "
                "feature (params must be partitionable); got stage {}"
                .format(stage))
        if not zc.cpu_offload:
            log_dist(
                "cpu_offload_params without cpu_offload: the fp32 master "
                "and Adam moments are host-resident anyway (the streamed "
                "step's optimizer runs on host)", ranks=[0])

    def _init_state(self):
        zc = self._config.zero_config
        stage = self.zero_optimization_stage()
        self._check_params_offload(zc, stage)
        streamed = self.zero_params_offload()
        offload = self.zero_cpu_offload()
        if zc.cpu_offload and not offload:
            logger.warning("zero_optimization.cpu_offload is ignored at "
                           "stage 0 (offload is a ZeRO feature)")
        self._validate_zero_keys(zc)
        accum = torch.bfloat16 if self._config.grad_accum_dtype == "bf16" \
            else torch.float32
        moments = getattr(self.optimizer, "moments_dtype", torch.float32)
        if offload:
            # the JAX engine's warnings: the host step consumes fp32
            if accum != torch.float32:
                logger.warning(
                    "data_types.grad_accum_dtype=bf16 ignored: the host "
                    "offload step consumes fp32 accumulated grads")
                accum = torch.float32
            if moments != torch.float32:
                logger.warning(
                    "optimizer moments_dtype=bf16 ignored under "
                    "cpu_offload: host shard moments are fp32")
                moments = torch.float32
        onebit = self._onebit_mode
        if onebit and accum != torch.float32:
            logger.warning(
                "grad_accum_dtype=bf16 ignored under OneBitAdam: the "
                "compressed exchange consumes fp32 local grads")
            accum = torch.float32
        if accum == torch.bfloat16 and self.gradient_accumulation_steps() > 1:
            logger.warning(
                "grad_accum_dtype=bf16 with gradient_accumulation_steps=%d: "
                "bf16 summation across micro-steps is lossy",
                self.gradient_accumulation_steps())
        replicated = ()
        if self._cm_tp:
            # the parameters every model rank holds whole (stage 3: the
            # rank's units hold its TP shards, partitioned over the data
            # group)
            spec = self._module_fn("partition_spec_fn")
            replicated = [name for name, p in self.module.named_parameters()
                          if spec(name, tuple(getattr(p, "ds_shape",
                                                      p.shape))) is None]
        units = None
        model_units = self._module_attr("zero3_units")
        if stage >= 3:
            units = model_units(self.module) if model_units else \
                [("module", [n for n, _ in self.module.named_parameters()])]
        self._num_params = sum(
            int(np.prod(getattr(p, "ds_shape", p.shape)))
            for p in self.module.parameters())
        max_live = int(zc.max_live_parameters) if stage >= 3 and \
            zc.max_live_parameters is not None else None
        # at one rank the JAX plan keeps every leaf whole (no data degree
        # to shard over): stage 3 there is stage 2's layout, with no
        # gathers and nothing recomputed; streamed offload is one rank
        partitioned = stage >= 3 and self.dp_world_size > 1 and \
            not streamed
        self.flat = FlatPartition(
            self.module, self.device, self.compute_dtype, accum_dtype=accum,
            replicated=replicated, moments_dtype=moments,
            group=self._dp_group, stage=stage if partitioned else
            min(stage, 2), offload=offload, units=units,
            persistence_threshold=zc.param_persistence_threshold,
            max_live_parameters=max_live, local_grads=onebit,
            streamed=streamed,
            shard_group=self.mesh.get_group(DATA_SHARD_AXIS)
            if self._hpz and partitioned else None,
            replica_group=self.mesh.get_group(DATA_REPLICA_AXIS)
            if self._hpz and partitioned else None)
        if partitioned and (self._qwz_enabled or self._cm_zero3):
            self.flat.configure_gather(
                quantized=self._qwz_enabled,
                ring=int(self._cm.chunks) if self._cm_zero3 else None)
        if self._qgz_enabled and not streamed:
            self.flat.enable_grad_codec()
        self._configure_local_grad_state()
        # a zero.Init module's pieces now live in the engine's buffers
        self.module.__dict__.pop("_zero3_store", None)
        self.zero3 = None
        if partitioned:
            self.zero3 = Stage3(self.flat, units)
            # a model that knows its units runs its loss unit by unit;
            # any other module's forward is one call (forward())
            self._zero3_in_model = model_units is not None
            if self._zero3_in_model:
                self.module._zero3 = self.zero3
        if stage >= 3 and not streamed:
            flat = self.flat
            # unpartitioned, every leaf is persistent
            persistent_numel = flat.persistent_numel if partitioned else \
                (self._num_params if max_live is not None else None)
            if flat.demoted:
                log_dist(
                    "stage3_max_live_parameters={:,}: demoted {} persistent "
                    "leaves to data-sharded (persistent set now {:,} "
                    "elements)".format(max_live, len(flat.demoted),
                                       persistent_numel), ranks=[0])
            if persistent_numel is not None and persistent_numel > max_live:
                warn_or_raise_noop(
                    "zero_optimization.stage3_max_live_parameters has NO "
                    "effect here: un-shardable persistent parameters alone "
                    "hold {:,} elements > budget {:,}".format(
                        persistent_numel, max_live),
                    bool(getattr(zc, "strict", False)),
                    flag="zero_optimization.strict")
        self.offload = HostOffload(
            self.flat, zc.sub_group_size, zc.prefetch_bucket_size,
            host_ranks=local_world_size(self._world())) \
            if offload and not streamed else None
        self.stream_runner = StreamedOffloadRunner(self) if streamed \
            else None
        # the streamed step's phase clocks (the JAX engine's name)
        self.offload_phase_times = {}
        if self._cm_tp and self.flat.sharded:
            # the model ranks of one data coordinate must own the same
            # ranges of the same layout: the ring's reductions pair them up
            mine = torch.tensor(self.flat.layout_signature(),
                                dtype=torch.int64, device=self.device)
            seen = all_gather(mine, self._tp_group).view(
                self.mp_world_size, -1)
            if not bool((seen == mine).all()):
                raise RuntimeError(
                    "model ranks hold different flat layouts (numel, owned "
                    "pieces, replicated ranges): {}".format(seen.tolist()))
        self.scaler = ls.loss_scaler_from_config(self._config)

    def _jax_leaves(self):
        """``(name, shape)`` of every parameter in the JAX package's tree
        flatten order: through the model module's ``params_to_jax``, or as
        nested dicts of the dotted names when it has no converters."""
        module = inspect.getmodule(type(self.module))
        to_jax = getattr(module, "params_to_jax", None)
        if to_jax is None:
            from ..models._tree import params_to_jax as to_jax
        order = ckpt.jax_leaf_order(to_jax, self.flat.names)
        shapes = dict(zip(self.flat.names, self.flat.shapes))
        return [(name, shapes[name]) for name in order]

    def _configure_local_grad_state(self):
        """The fused layouts of the local-gradient features and their
        bridges from the flat partition (``FlatBridge``): OneBitAdam's
        momentum layout (``onebit_padded_size``) and its state, and the
        int8 exchange's layout (``qc_padded_size``), which at "exchange"
        mode becomes the partition's ``exchange``."""
        flat = self.flat
        self._onebit_bridge = self._qc_bridge = None
        # OneBitAdam's elastic sidecar: the original per-worker error rows
        # of a resharded load, re-emitted by a save before any step
        self._onebit_pristine = None
        if not (self._onebit_mode or self._qc_enabled):
            return
        leaves = self._jax_leaves()
        offsets = dict(zip(flat.names, flat.offsets))
        if self._onebit_mode:
            layout = self.optimizer.init_flat_state(leaves, self.device)
            self._onebit_bridge = layout.bridge(offsets)
            # the momentum in the flat layout, for the update of the owned
            # range (the alignment gaps stay zero)
            self._onebit_m_flat = torch.zeros(flat.numel,
                                              dtype=torch.float32,
                                              device=self.device)
            # the momentum is OneBitAdam's fused buffer
            flat.exp_avg = torch.zeros(0, dtype=torch.float32,
                                       device=self.device)
        if self._qc_enabled:
            dp, block = self.dp_world_size, self._qc.block_size
            self._qc_layout = FusedFlatLayout(
                leaves, lambda n: qc_padded_size(n, dp, block))
            self._qc_bridge = self._qc_layout.bridge(offsets)
            if not self._onebit_mode:
                flat.exchange = self._qc_average

    def _qc_average(self, grads):
        """The int8 exchange of a whole flat buffer: its fused form summed
        over the data group through the in-collective ring, times ``1 /
        dp``, written back over ``grads`` in their dtype (the JAX engine's
        ``unflatten_like``); returns ``grads``."""
        fused = self._qc_bridge.to_fused(grads)
        mean = self._qc_exchange(fused) * np.float32(1.0 / self.dp_world_size)
        return self._qc_bridge.from_fused(mean, grads)

    # ------------------------------------------------------------ training

    def train(self, mode=True):
        self.module.train(mode)

    def eval(self):
        self.module.train(False)

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _check_rows(self, inputs, dim):
        """Over a data group each rank passes the micro batch's rows."""
        micro = self.train_micro_batch_size_per_gpu()
        for x in inputs:
            if x.dim() > dim and x.shape[dim] != micro:
                raise ValueError(
                    "each of the {} data-parallel ranks takes its own {} rows "
                    "(train_micro_batch_size_per_gpu), got a batch of {} "
                    "rows".format(self.dp_world_size, micro, x.shape[dim]))

    def forward(self, *inputs, **kwargs):
        """Run a micro-batch -> the loss. In train mode the graph is kept
        for :meth:`backward`; in eval mode it runs without gradients. Over
        a data group each rank passes its own ``micro`` rows."""
        if len(inputs) == 1 and isinstance(inputs[0], (tuple, list)):
            inputs = tuple(inputs[0])
        inputs = tuple(self._to_device(x) for x in inputs)
        if self._dp_group is not None and self.module.training:
            self._check_rows(inputs, 0)
        if "generator" in self._forward_kwargs and self.module.training:
            kwargs.setdefault("generator", self._generator)
        if self.progressive_layer_drop and self.module.training:
            # as the JAX engine: only the kwargs the forward takes
            for key, value in self.progressive_layer_drop.get_state().items():
                if key in self._forward_kwargs:
                    kwargs.setdefault(key, value)
        if self.stream_runner is not None:
            # the forward AND the backward run as one streamed pass (the
            # gradients land in the host accumulator); backward() is
            # bookkeeping
            if not self.module.training:
                return self.stream_runner.eval_loss(inputs)
            loss = self.stream_runner.micro_step(
                inputs, self.stream_runner.layer_seeds(
                    kwargs.get("generator")))
            self._pending_backward = True
            return loss
        if not self.module.training:
            with torch.no_grad():
                return self._run_module(inputs, kwargs)
        loss = self._run_module(inputs, kwargs)
        self._pending_backward = True
        return loss

    def _run_module(self, inputs, kwargs):
        """The module's forward; at stage 3 on a module that does not run
        its own units, one call with every parameter gathered."""
        if self.zero3 is not None:
            self.zero3.begin_pass()
        if self.zero3 is None or self._zero3_in_model:
            return self.module(*inputs, **kwargs)
        return self.zero3.call(lambda *xs: self.module(*xs, **kwargs),
                               *inputs, units=("module",))

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Back-propagate ``loss * loss_scale / gas`` into the flat
        gradient buffer and fold it into the accumulator (at stage 2 over
        a data group: reduce-scattered into the owned slice)."""
        assert self._pending_backward, \
            "backward() called without a prior train-mode forward()"
        self._pending_backward = False
        if self.stream_runner is not None:
            return loss
        scale = self.scaler.cur_scale / self.gradient_accumulation_steps()
        # qgZ's residual is kept in the JAX engine's units: the loss
        # scale, and the data degree the port's summed gradients carry
        self.flat.qg_scale = self.scaler.cur_scale * self.dp_world_size
        if self.zero3 is not None:
            last = self._last_micro
            self.zero3.last_backward = \
                self.is_gradient_accumulation_boundary() if last is None \
                else last
        (loss.float() * scale).backward()
        self.flat.fold_grads()
        return loss

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None):
        """The optimizer step at gradient-accumulation boundaries;
        ``lr_kwargs`` go to the LR schedule's ``step``."""
        if self.is_gradient_accumulation_boundary():
            self._take_model_step(lr_kwargs)
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * \
            self.dp_world_size

    def _apply_step(self):
        """Reduce over the data group (stages 0/1), overflow check,
        unscale and average, clip, the optimizer over the owned range,
        params refresh (the all-gather when partitioned), zero acc."""
        if self._onebit_mode:
            return self._onebit_apply_step()
        if self.stream_runner is not None:
            return self._stream_apply_step()
        flat = self.flat
        self._drop_posted()
        tp = self._tp_group if self._cm_tp else None
        dp = self._dp_group
        pipe = self._pipe_group
        # "exchange" mode: the accumulator already holds the average
        exchanged = self._qc_enabled
        self._reduce_tied_grads()
        if dp is not None and not flat.grads_sharded and not exchanged:
            with record_function("zero.all_reduce"):
                all_reduce_(flat.acc, dp)
        acc = flat.own(flat.acc)
        rep_ranges = flat.own_replicated
        if tp is not None:
            # the whole-on-every-rank parameters saw only this rank's rows
            self._tp_reduce_replicated(acc, rep_ranges, tp)
        grads = acc if acc.dtype == torch.float32 else acc.float()
        overflow = rt_utils.CheckOverflow.has_overflow(grads)
        scale = self.scaler.cur_scale
        # one division after the sum: the mean over the global batch
        inv = 1.0 / scale / (1 if exchanged else self.dp_world_size)
        if inv != 1.0:
            grads.mul_(inv)
        total_norm = None
        if flat.sharded or tp is not None or pipe is not None:
            # the flag and the squares in one collective a group: each
            # owned range's squares once over the data group, each TP
            # shard's once per model rank, each replicated element once,
            # each pipeline stage's once
            stats = torch.stack([overflow.double(),
                                 *self._grad_squares(grads, rep_ranges)])
            if flat.sharded:
                all_reduce_(stats, dp)
            if tp is not None:
                all_reduce_(stats[:2], tp)
            if pipe is not None:
                all_reduce_(stats, pipe)
            overflow = stats[0] > 0
            total_norm = (stats[1] + stats[2]).sqrt().float()
        overflow = bool(overflow)
        clip = self.gradient_clipping()
        if clip > 0:
            grad_norm = rt_utils.clip_grad_norm_(grads, clip,
                                                 total_norm=total_norm)
        else:
            grad_norm = total_norm if total_norm is not None \
                else rt_utils.get_grad_norm(grads)
        if not overflow and self.offload is not None:
            # the host step (runtime/zero/offload.py): the gradients down
            # and the weights up in chunks, then the gather (below stage
            # 3: every rank's updated piece; at stage 3: the persistent
            # unit)
            opt = self.optimizer
            with record_function("zero.offload_step"):
                self.offload.step(
                    grads, opt.hyperparams(), flat.step + 1,
                    bias_correction=getattr(opt, "bias_correction", True),
                    adam_w_mode=getattr(opt, "adam_w_mode", True))
            flat.step += 1
            flat.gather_params()
        elif not overflow:
            # the segments a TP rank holds a shard of (stage 3: the
            # unreplicated leaves, interleaved with the others)
            self.optimizer.step_flat(
                flat.master, grads, flat.exp_avg, flat.exp_avg_sq,
                flat.step + 1, segments=flat.segments, group=tp,
                sharded_from=flat.sharded_leaves if flat.stage3
                else flat.own_replicated_end,
                **({"dp_group": dp} if flat.sharded else {}))
            flat.step += 1
            flat.refresh_params()
        flat.acc.zero_()
        if overflow and flat.qg_error is not None:
            # the overflowed window quantized inf/nan gradients: the qgZ
            # residual is reset with the skip, as the JAX engine does
            flat.qg_error.zero_()
        metrics = {"overflow": overflow, "grad_norm": grad_norm,
                   "loss_scale": scale}
        self.scaler = ls.update_scale(self.scaler, overflow)
        return metrics

    def _drop_posted(self):
        """A ring posted ahead carries the parameters it read: finish and
        drop it before they change."""
        if self.zero3 is not None:
            self.zero3.drop_posted()

    def _onebit_apply_step(self):
        """OneBitAdam's apply step (the JAX engine's OneBitAdam branch):
        the overflow flag over the data group; the local gradients
        unscaled; warmup: averaged over the group (the fp32 all-reduce, or
        the int8 ring with ``quantized_collectives``) and exact Adam on the
        average; frozen: this rank's own gradients feed the 1-bit momentum
        exchange and the variance stays frozen, the grad norm the RMS over
        workers ``sqrt(sum_w ||g_w||^2 / w)``. Each rank steps its owned
        range of the master from the whole momentum, then the parameters
        are refreshed (all-gathered when partitioned). An overflowed step
        is skipped and zeroes the worker and server errors."""
        flat, opt, dp = self.flat, self.optimizer, self._dp_group
        world = self.dp_world_size
        frozen = self._onebit_frozen()
        grads = flat.acc
        overflow = rt_utils.CheckOverflow.has_overflow(grads).float()
        if dp is not None:
            overflow = all_reduce_(overflow.reshape(1), dp,
                                   op=dist.ReduceOp.MAX)[0]
        overflow = bool(overflow > 0)
        scale = self.scaler.cur_scale
        inv = float(np.float32(1.0) / np.float32(scale))
        if inv != 1.0:
            grads.mul_(inv)
        if frozen:
            sq = grads.pow(2).sum().reshape(1)
            if dp is not None:
                all_reduce_(sq, dp)
            grad_norm = sq[0].sqrt() / float(np.sqrt(np.float32(world)))
        else:
            if dp is not None:
                with record_function("onebit.warmup_average"):
                    if self._qc_enabled:
                        self._qc_average(grads)
                    else:
                        all_reduce_(grads, dp)
                        grads.div_(torch.tensor(float(world),
                                                device=grads.device))
            grad_norm = rt_utils.get_grad_norm(grads)
        if not overflow:
            lo, hi = (flat.lo, flat.hi) if flat.sharded else \
                (0, flat.numel)
            master, v = flat.master, flat.exp_avg_sq
            bridge = self._onebit_bridge
            wd = float(opt.weight_decay or 0.0)
            if frozen:
                wd_fused = bridge.to_fused(master) * np.float32(wd) \
                    if wd else None
                with record_function("onebit.exchange"):
                    opt.exchange(bridge.to_fused(grads), wd_fused)
            else:
                # the L2 term in one rounding, as XLA fuses it (and as the
                # plain Adam's fma_f32)
                g = fma(master, torch.tensor(np.float32(wd),
                                             device=master.device),
                        grads) if wd else grads
                opt.warmup_momentum(bridge.to_fused(g))
                opt.warmup_variance(v, g[lo:hi])
            m = bridge.from_fused(opt.exp_avg, self._onebit_m_flat)
            opt.apply_update(master, m[lo:hi], v, flat.step + 1)
            flat.step += 1
            flat.refresh_params()
        else:
            opt.reset_error_state()
        flat.acc.zero_()
        metrics = {"overflow": overflow, "grad_norm": grad_norm,
                   "loss_scale": scale}
        self.scaler = ls.update_scale(self.scaler, overflow)
        return metrics

    def _stream_apply_step(self):
        """The streamed offload's apply step (the host Adam over the host
        accumulator) and the loss scaler's update; its phase clocks move
        to ``offload_phase_times``, the name the JAX engine gives them."""
        metrics = self.stream_runner.apply_step()
        self.scaler = ls.update_scale(self.scaler, metrics["overflow"])
        self.offload_phase_times = self.stream_runner.phase_times
        self.stream_runner.phase_times = {}
        return metrics

    @staticmethod
    def _tp_reduce_replicated(acc, ranges, group):
        """The replicated leaves' ranges of ``acc`` summed over the model
        group (one all-reduce: the ranges packed when there are several)."""
        if len(ranges) == 1:
            a, b = ranges[0]
            all_reduce_(acc[a:b], group)
        elif ranges:
            packed = torch.cat([acc[a:b] for a, b in ranges])
            all_reduce_(packed, group)
            at = 0
            for a, b in ranges:
                acc[a:b].copy_(packed[at:at + b - a])
                at += b - a

    def _reduce_tied_grads(self):
        """Before the data-parallel reduction: the tied parameters'
        gradients summed over the stages that hold them (the pipeline
        engine's; nothing here)."""

    @staticmethod
    def _squares(grads, ranges):
        """The sum of the squares over ``ranges``, accumulated in fp64:
        the owned ranges follow the layout (stage 2's one range, stage 3's
        piece a unit), and an fp32 sum over them rounds by the layout, so
        the norm and the clip coefficient would part the stages in the
        last bits; in fp64 they round alike to fp32."""
        total = grads.new_zeros((), dtype=torch.float64)
        for a, b in ranges:
            if a < b:
                total = total + grads[a:b].pow(2).sum(dtype=torch.float64)
        return total

    @staticmethod
    def _complement(ranges, n):
        out, at = [], 0
        for a, b in sorted(ranges):
            out.append((at, a))
            at = b
        out.append((at, n))
        return [(a, b) for a, b in out if a < b]

    def _grad_squares(self, grads, rep_ranges):
        """The squares of the owned gradients this rank counts in the
        global norm: ``(outside the replicated ranges, in them)``."""
        return (self._squares(grads, self._complement(rep_ranges,
                                                      grads.numel())),
                self._squares(grads, rep_ranges))

    def _take_model_step(self, lr_kwargs=None):
        metrics = self._apply_step()
        self._step_metrics = metrics
        if metrics["overflow"]:
            self.skipped_steps += 1
            log_dist("OVERFLOW! Skipping step. Attempted loss scale: "
                     "{}".format(metrics["loss_scale"]), ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        if self.progressive_layer_drop:
            self.progressive_layer_drop.update_state(self.global_steps)
        self.global_steps += 1
        if self.global_steps % self.steps_per_print() == 0:
            log_dist("step={}, lr={}, loss_scale={}".format(
                self.global_steps, self.get_lr(), self.scaler.cur_scale),
                ranks=[0])

    def train_batch(self, data_iter=None, batch=None):
        """One global batch: ``batch`` is a tuple of arrays stacked
        ``(gas, batch, ...)`` (or ``data_iter`` yields ``gas``
        micro-batches); every micro step, then the apply step. At one
        rank the batch is the global one; over a data group each rank
        passes its own ``micro`` rows. Returns the mean loss over the
        global batch (the same on every rank of the data group), a 0-dim
        fp32 tensor on the device."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            assert data_iter is not None, \
                "train_batch needs batch= or data_iter="
            micro = [tuple(next(data_iter)) for _ in range(gas)]
            batch = tuple(np.stack([np.asarray(m[i]) for m in micro])
                          for i in range(len(micro[0])))
        batch = tuple(self._to_device(x) for x in batch)
        if self._dp_group is not None:
            self._check_rows(batch, 1)
        self.module.train()
        losses = []
        for i in range(gas):
            loss = self.forward(*(x[i] for x in batch))
            self._last_micro = i == gas - 1
            self.backward(loss)
            losses.append(loss.detach().float())
        self._last_micro = None
        self._take_model_step()
        self.micro_steps += gas
        self.global_samples += self.train_batch_size()
        loss = torch.stack(losses).mean()
        if self._dp_group is not None:
            loss = all_reduce_(loss.reshape(1), self._dp_group)[0] / \
                self.dp_world_size
        return loss

    # ----------------------------------------------------------- accessors

    @property
    def offload_work_chunks(self):
        """The offload step's work chunks (``sub_group_size``), as the JAX
        engine counts them; None without offload."""
        return self.offload.work_chunks if self.offload is not None \
            else None

    @property
    def h2d_batches(self):
        """Host-to-device copies of the last offload step
        (``stage3_prefetch_bucket_size``); None without offload."""
        return self.offload.h2d_batches if self.offload is not None \
            else None

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def sparse_attention_config(self):
        """The parsed ds_config "sparse_attention" dict, or None. The engine
        does not push it into the model: the caller builds
        ``GPT2Config(sparse_attention=engine.sparse_attention_config())``,
        as with the JAX package."""
        return self._config.sparse_attention

    def sparse_gradients_enabled(self):
        return bool(self._config.sparse_gradients_enabled)

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bf16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def get_lr(self):
        return [float(getattr(self.optimizer, "lr", 0.0))]

    def get_mom(self):
        betas = getattr(self.optimizer, "betas", None)
        return [betas] if betas is not None else None

    # ---------------------------------------------------------------- data

    def deepspeed_io(self, dataset, batch_size=None, route=ROUTE_TRAIN,
                     data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        """A :class:`DeepSpeedDataLoader` over ``dataset`` (anything with
        ``__len__`` and ``__getitem__``), as the JAX engine's: batches of
        the micro batch from this rank's contiguous share of the dataset
        (rank ``dp_rank`` of the data group), shuffled for the train
        route."""
        if batch_size is None:
            batch_size = self.train_micro_batch_size_per_gpu()
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size,
            collate_fn=collate_fn or self.collate_fn,
            data_parallel_world_size=self.dp_world_size,
            data_parallel_rank=self.dp_rank,
            shuffle=(route == ROUTE_TRAIN))

    def loss_scale(self):
        return float(self.scaler.cur_scale)

    def get_global_grad_norm(self):
        gn = self._step_metrics.get("grad_norm")
        return float(gn) if gn is not None else None

    def _tree_converters(self):
        """The model module's JAX-tree converters (``params_to_jax``,
        ``params_from_jax``, ``optimizer_state_to_jax``,
        ``optimizer_state_from_jax``), e.g. ``models.gpt2``'s or
        ``models.bert``'s."""
        module = inspect.getmodule(type(self.module))
        names = ("params_to_jax", "params_from_jax", "optimizer_state_to_jax",
                 "optimizer_state_from_jax")
        missing = [n for n in names if not hasattr(module, n)]
        if missing:
            raise NotImplementedError(
                "{} has no JAX-tree converters ({}): the model's module must "
                "define them".format(getattr(module, "__name__", module),
                                     ", ".join(missing)))
        return {n: getattr(module, n) for n in names}

    def _module_attr(self, name):
        """The model's module's ``name``, or None when it has none."""
        return getattr(inspect.getmodule(type(self.module)), name, None)

    def _module_fn(self, name):
        module = inspect.getmodule(type(self.module))
        if not hasattr(module, name):
            raise NotImplementedError("{} has no {}".format(
                getattr(module, "__name__", module), name))
        return getattr(module, name)

    def _full_tree(self, flat, keep_dtype=False):
        """A flat buffer -> the full model's ``{dotted name: fp32 CPU
        tensor}`` (the buffer's dtype with ``keep_dtype``): a partition is
        gathered over the data group, then under tensor parallelism every
        rank's buffer over the model group (one all-gather each; every
        rank must call) and the shards joined (the module's
        ``tp_gather_state_dicts``)."""
        flat = self.flat.whole(flat)
        if not self._cm_tp:
            return self.flat.tree_of(flat, keep_dtype)
        parts = all_gather(flat.detach(), self._tp_group, dim=0)
        shards = [self.flat.tree_of(p, keep_dtype) for p in
                  parts.chunk(self.mp_world_size)]
        return self._module_fn("tp_gather_state_dicts")(shards)

    def _own_shard(self, state):
        """A full ``state_dict`` -> this rank's shard of it."""
        if not self._cm_tp:
            return state
        return self._module_fn("tp_shard_state_dict")(
            state, dist.get_rank(self._tp_group), self.mp_world_size)

    def get_master_params(self):
        """The fp32 master weights as the JAX-shaped tree of numpy arrays
        (the model module's ``params_to_jax`` naming); over a data or a
        model group the full tree, gathered (every rank must call)."""
        to_jax = self._tree_converters()["params_to_jax"]
        return to_jax(self._full_tree(self.flat.master))

    def get_optimizer_state(self):
        """``{"step", "exp_avg", "exp_avg_sq"}`` as JAX-shaped trees (Adam's,
        LAMB's and SGD's state have the same shape); full trees, as
        :meth:`get_master_params`. bf16 moments come out as fp32 arrays of
        the same values (numpy has no bf16), which cast back to bf16 bit
        for bit."""
        to_jax = self._tree_converters()["optimizer_state_to_jax"]
        if self._onebit_mode:
            return to_jax(self._onebit_state())
        return to_jax({
            "step": self.flat.step,
            "exp_avg": self._full_tree(self.flat.exp_avg),
            "exp_avg_sq": self._full_tree(self.flat.exp_avg_sq)})

    def _rows(self, row):
        """Every data rank's ``row`` stacked ``(world, ...)`` (an all-gather
        over the data group; every rank must call)."""
        if self._dp_group is None:
            return row.detach().reshape(1, -1).cpu()
        return all_gather(row.detach(), self._dp_group).reshape(
            self.dp_world_size, -1).cpu()

    def _onebit_state(self, keep_dtype=False):
        """OneBitAdam's state as the JAX engine holds it (``step``; the
        fused ``exp_avg``; ``exp_avg_sq`` as a state_dict; the worker and
        server error rows of every rank, ``(world, ...)``), CPU tensors
        (every rank must call)."""
        opt = self.optimizer
        return {"step": self.flat.step,
                "exp_avg": {"_flat": opt.exp_avg.detach().cpu()},
                "exp_avg_sq": self._full_tree(self.flat.exp_avg_sq,
                                              keep_dtype),
                "worker_error": {"_flat": self._rows(opt.worker_error)},
                "server_error": {"_flat": self._rows(opt.server_error)}}

    def _load_onebit_state(self, state, saved_world=None, pristine=None):
        """OneBitAdam's state (``optimizer_state_from_jax``'s form: the
        fused buffers ``{"_flat": tensor}``, the error rows ``(world,
        ...)``) into the optimizer and the partition; a state saved at
        another world goes through ``reshard_state`` first (the JAX
        engine's elastic restore, with the ``onebit_pristine`` sidecar)."""
        opt = self.optimizer
        fused = ("exp_avg", "worker_error", "server_error")
        if saved_world is not None and int(saved_world) != self.dp_world_size:
            numpy_state = {k: ({"_flat": state[k]["_flat"].numpy()}
                               if k in fused else state[k])
                           for k in state}
            state = dict(numpy_state)
            state.update(opt.reshard_state(numpy_state, int(saved_world),
                                           pristine=pristine))
            pristine = opt._reshard_pristine
        if pristine is not None:
            self._onebit_pristine = {"payload": pristine, "steps": None}
        dev = self.device
        flat_of = {k: torch.as_tensor(np.asarray(state[k]["_flat"]),
                                      dtype=torch.float32)
                   for k in fused if k in state}
        if "exp_avg" in flat_of:
            opt.exp_avg = flat_of["exp_avg"].reshape(-1).to(dev).clone()
        for key in ("worker_error", "server_error"):
            if key in flat_of:
                rows = flat_of[key].reshape(self.dp_world_size, -1)
                setattr(opt, key, rows[self.dp_rank].to(dev).clone())
        self.flat.load(self.flat.exp_avg_sq, state["exp_avg_sq"])
        self.flat.step = int(state["step"])

    def load_state_from_jax(self, master=None, optimizer_state=None):
        """Start from a JAX engine's state: an fp32 master tree and/or an
        optimizer state ``{"step", "exp_avg", "exp_avg_sq"}`` (numpy
        trees, whole; bf16 moments, as the JAX engine's
        ``moments_dtype="bf16"`` holds them, load bit for bit). Each rank
        keeps its model shard's owned range, and the compute-dtype
        parameters are refreshed from the whole master tree."""
        conv = self._tree_converters()
        if master is not None:
            self._drop_posted()
            self.flat.load(self.flat.master,
                           self._own_shard(conv["params_from_jax"](master)))
            self.flat.refresh_params()
        if optimizer_state is not None and self._onebit_mode:
            self._load_onebit_state(
                conv["optimizer_state_from_jax"](optimizer_state))
        elif optimizer_state is not None:
            state = conv["optimizer_state_from_jax"](optimizer_state)
            self.flat.load(self.flat.exp_avg,
                           self._own_shard(state["exp_avg"]))
            self.flat.load(self.flat.exp_avg_sq,
                           self._own_shard(state["exp_avg_sq"]))
            self.flat.step = state["step"]

    # ---------------------------------------------------------- checkpoints

    def _get_ckpt_tag(self, tag):
        return tag if tag is not None else "global_step{}".format(
            self.global_steps)

    @staticmethod
    def _world():
        return dist.get_world_size() if dist.is_initialized() else 1

    def _barrier(self):
        if self._world() > 1:
            dist.barrier()

    def _validate_tag(self, tag):
        """Every rank must save under one tag: rank 0's first 32 bytes of
        it are broadcast and compared (``checkpoint.tag_validation``:
        Warn logs a mismatch, Fail raises, Ignore skips)."""
        if not self._config.checkpoint_tag_validation_enabled or \
                self._world() == 1:
            return
        mine = torch.tensor(list(str(tag).encode()[:32].ljust(32)),
                            dtype=torch.uint8, device=self.device)
        agreed = broadcast_(mine.clone(), src=0)
        if not torch.equal(agreed, mine):
            msg = "Checkpoint tag '{}' differs across processes".format(tag)
            if self._config.checkpoint_tag_validation_fail:
                raise ValueError(msg)
            logger.warning(msg)

    def _jax_leaf_names(self):
        """The full model's parameter names in the JAX flatten order."""
        return ckpt.jax_leaf_order(
            self._tree_converters()["params_to_jax"], self.flat.names)

    def _tp_place(self):
        """(this rank's model rank, the ring size, the module's
        ``tp_full_boxes``, its ``partition_spec_fn``) under tensor
        parallelism, else None."""
        if not self._cm_tp:
            return None
        return (dist.get_rank(self._tp_group), self.mp_world_size,
                self._module_fn("tp_full_boxes"),
                self._module_fn("partition_spec_fn"))

    def _full_shapes(self):
        """name -> the full leaf's shape (a TP shard's grown back)."""
        tp = self._tp_place()
        if tp is None:
            return dict(zip(self.flat.names, self.flat.shapes))
        rank, size, full_boxes, _ = tp
        return {name: full_boxes(name, shape, tuple((0, n) for n in shape),
                                 rank, size)[0]
                for name, shape in zip(self.flat.names, self.flat.shapes)}

    def _zero_shard_payload(self):
        """This rank's zero file (``checkpointing.zero_payload``): its
        owned range of the master and the moments as boxes of the full
        leaves; under TP the module's ``tp_full_boxes`` moves them, and a
        leaf every model rank holds whole is written by model rank 0
        only, so no two ranks write one element."""
        flat, tp = self.flat, self._tp_place()
        box_map = None
        if tp is not None:
            rank, size, full_boxes, spec_fn = tp

            def box_map(name, shape, box):
                if rank != 0 and spec_fn(name, shape) is None:
                    return []
                return full_boxes(name, shape, box, rank, size)[1]
        keys = ("master", "exp_avg_sq") if self._onebit_mode else \
            ("master", "exp_avg", "exp_avg_sq")
        if flat.qg_error is not None and self.offload is None:
            keys += ("qg_error",)
        bufs = {key: flat.own(getattr(flat, key)).detach().cpu()
                for key in keys}
        layout = (flat.names, flat.offsets, flat.shapes, flat.spans)
        if self.offload is not None:
            return ckpt.offload_payload(self._jax_leaf_names(), layout, bufs,
                                        flat.step, self.offload.torn_step)
        payload = ckpt.zero_payload(self._jax_leaf_names(), layout, bufs,
                                    flat.step, self._full_shapes(), box_map)
        if self._onebit_mode:
            # the fused momentum once (rank 0), each rank its error rows
            opt, opt_sd = self.optimizer, payload["device_shards"]["opt"]
            opt_sd["exp_avg"] = ckpt.fused_entry(
                opt.exp_avg.detach().cpu(), self.global_rank == 0)
            for key in ("worker_error", "server_error"):
                opt_sd[key] = ckpt.row_entry(
                    getattr(opt, key).detach().cpu(), self.dp_rank,
                    self.dp_world_size)
        return payload

    def _jax_tree(self, buf, keep_dtype=False):
        """A flat buffer's full JAX-shaped tree (every rank must call)."""
        return self._tree_converters()["params_to_jax"](
            self._full_tree(buf, keep_dtype), keep_dtype=keep_dtype)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_save=False):
        """Save the model, optimizer, scheduler and counters as a tag the
        JAX package reads (its ``save_checkpoint``; every rank must call).

        Global rank 0 writes ``mp_rank_00_model_states.pt``: the
        compute-dtype ``module`` tree (bf16 stays bf16; at stage 3 the
        gathered module), the scaler, the LR schedule's state, the
        counters, the world sizes and ``client_state``'s keys; without
        ZeRO, and under ZeRO-Offload on one rank, also the fp32
        ``master`` (mixed precision or offload) and the ``optimizer``
        state, full trees. Under device-state ZeRO every rank writes
        ``zero_pp_rank_{global rank}_mp_rank_00_optim_states.pt``, its
        owned part of the master and the moments as boxes of the full
        leaves (``device_shards``), and the model file carries neither;
        under ZeRO-Offload over a data group the zero files hold the
        host state as the JAX engine writes it (``offload_shards``,
        ``offload_step``, ``torn_step``).
        After a barrier rank 0 writes ``manifest.json`` (each file's CRC32
        and size), moves ``latest`` and prunes to
        ``checkpoint.keep_last_n``; a second barrier precedes the return.
        ``async_save`` (one process only) pickles and writes on the
        module's background writer once the state is on the host."""
        tag = self._get_ckpt_tag(tag)
        self._validate_tag(tag)
        client_state = client_state or {}
        async_save = async_save and self._world() == 1
        self._drain_ckpt_writes()
        ckpt.wait_pending_writes()
        offload = self.offload is not None or \
            self.stream_runner is not None
        # the JAX engine's choice: device-state ZeRO and a partitioned
        # offload write the state only into the zero files (a pipeline
        # under offload also writes the gathered trees: _gathered_offload)
        zero = (self.zero_optimization() and not offload) or \
            (offload and self._world() > 1)
        gathered = not zero or (offload and self._gathered_offload())
        flat = self.flat
        if not gathered:
            optimizer = None
        elif self._onebit_mode:
            state = self._onebit_state(keep_dtype=True)
            optimizer = dict(
                state, step=np.asarray(flat.step, np.int32),
                exp_avg_sq=self._tree_converters()["params_to_jax"](
                    state["exp_avg_sq"], keep_dtype=True))
        else:
            optimizer = dict(
                step=np.asarray(flat.step, np.int32),
                exp_avg=self._jax_tree(flat.exp_avg, keep_dtype=True),
                exp_avg_sq=self._jax_tree(flat.exp_avg_sq, keep_dtype=True))
        sd = {
            "module": self._jax_tree(flat.params, keep_dtype=True),
            "optimizer": optimizer,
            "master": self._jax_tree(flat.master)
            if (self.mixed_precision or offload) and gathered else None,
            "scaler": {
                "cur_scale": np.asarray(self.scaler.cur_scale, np.float32),
                "cur_hysteresis": np.asarray(self.scaler.cur_hysteresis,
                                             np.int32),
                "last_overflow_iter": np.asarray(
                    self.scaler.last_overflow_iter, np.int32),
                "cur_iter": np.asarray(self.scaler.cur_iter, np.int32)},
            "lr_scheduler": self.lr_scheduler.state_dict()
            if hasattr(self.lr_scheduler, "state_dict") else None,
            # qgZ's residual: the gathered tree here, the zero files' shard
            # lists under device-state ZeRO (as the JAX engine)
            "qg_error": self._jax_tree(flat.qg_error)
            if flat.qg_error is not None and gathered else None,
            "csr_tensor_module_names": set(self.csr_tensor_module_names),
            "skipped_steps": self.skipped_steps,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "dp_world_size": self.dp_world_size,
            "mp_world_size": self.mp_world_size,
        }
        if self.offload is not None and self.offload.torn_step is not None:
            sd["torn_offload_step"] = self.offload.torn_step
        pristine = self._onebit_pristine
        if pristine is not None and pristine.get("steps") == \
                self.global_steps:
            # no step has consumed the folded worker residuals since the
            # resharded load: the original rows are still the truth
            sd["onebit_pristine"] = pristine["payload"]
        sd.update(client_state)
        futures, records = [], []

        def note(res):
            (futures if hasattr(res, "result") else records).append(res)

        if self.global_rank == 0:
            path = ckpt.model_ckpt_name(save_dir, tag)
            note(ckpt.save_state_dict(path, sd, async_save=async_save))
            logger.info("Saved checkpoint: {}".format(path))
        if zero:
            note(ckpt.save_state_dict(
                ckpt.zero_ckpt_name(save_dir, tag, dp_rank=self.global_rank),
                self._zero_shard_payload(), async_save=async_save))
        self._save_extra_files(save_dir, tag, note, async_save)
        # every rank's files land before the manifest and `latest` move
        self._barrier()
        if self.global_rank == 0:
            self._finalize_ckpt_tag(save_dir, tag, records, futures,
                                    save_latest, async_save)
        self._ckpt_futures = futures
        # no rank goes on (and perhaps loads) before the tag is whole
        self._barrier()
        return True

    def _gathered_offload(self):
        """Whether an offload tag written over several ranks also carries
        the gathered master and optimizer trees in its model file (the
        pipeline engine's; not here, as the JAX engine)."""
        return False

    def _save_extra_files(self, save_dir, tag, note, async_save):
        """More files of the tag, written before the manifest (the
        pipeline engine's per-layer files; none here)."""

    def _adapt_state_dict(self, sd):
        """A loaded model file's state, adapted to this engine (the
        pipeline engine reads its stage layout; as it is here)."""
        return sd

    def _finalize_ckpt_tag(self, save_dir, tag, records, futures,
                           save_latest, async_save):
        """manifest.json last among the tag's files, then ``latest``, then
        retention; async, each queued behind everything before it and
        refused if any of it failed."""
        meta = {"global_step": int(self.global_steps),
                "dp_world_size": int(self.dp_world_size),
                "mp_world_size": int(self.mp_world_size)}
        if async_save:
            futures.append(ckpt.write_manifest_after(save_dir, tag, futures,
                                                     meta))
        else:
            records.append(ckpt.write_manifest(save_dir, tag, records, meta))
        if not save_latest:
            return
        if async_save:
            futures.append(ckpt.save_latest_after(save_dir, tag, futures))
        else:
            ckpt.save_latest(save_dir, tag)
        keep_last_n = self._config.checkpoint_keep_last_n
        if keep_last_n:
            if async_save:
                futures.append(ckpt.prune_after(save_dir, keep_last_n,
                                                futures))
            else:
                ckpt.prune_checkpoints(save_dir, keep_last_n)

    def wait_pending_writes(self):
        """Block until every queued checkpoint write has landed, raising
        the first failure of this engine's async saves."""
        self._drain_ckpt_writes()
        ckpt.wait_pending_writes()

    def _drain_ckpt_writes(self):
        futures, self._ckpt_futures = self._ckpt_futures, []
        first_err = None
        for fut in futures:
            try:
                fut.result()
            except BaseException as err:  # noqa: BLE001 - re-raised below
                first_err = first_err or err
        if first_err is not None:
            raise first_err

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_from_fp32_weights=True):
        """Load a tag written by either package at any data- and
        tensor-parallel layout; returns ``(path, client_state)`` (every
        rank must call). The JAX engine's ``load_checkpoint``:

        * the tag's manifest and checksums are verified first. With
          ``tag=None`` the tag ``latest`` names is tried, then the newest
          complete one (every rejection logged); a tag named explicitly
          that fails gives ``(None, None)``, never another tag's weights.
          A tag predating manifests loads unverified, with a warning;
        * under ZeRO the full leaves are reassembled from every zero file
          (the JAX engine's ``device_shards`` or ``offload_shards``) and
          each rank keeps its range, through ``load_state_from_jax``'s
          path;
        * the fp32 master comes from the tag's fp32 leaves when
          ``load_from_fp32_weights`` (else it is recast from ``module``);
          the compute-dtype parameters are refreshed from it;
        * the moments keep the live engine's dtype (the JAX engine casts
          them to fp32 on load; a bf16 tag loads bit for bit here).

        A file the process cannot unpickle for want of a module raises
        ``CheckpointEnvironmentError``; it never falls back."""
        self._drain_ckpt_writes()
        ckpt.wait_pending_writes()
        requested = tag
        if tag is None:
            tag = ckpt.read_latest(load_dir)

        def _reject(bad_tag, why):
            logger.error("checkpoint tag %r under %s rejected: %s",
                         bad_tag, load_dir, why)

        tried = []
        verified_by_scan = False
        while True:
            if tag is None:
                if requested is not None:
                    break
                tag = ckpt.newest_complete_tag(load_dir, exclude=tried,
                                               on_reject=_reject)
                if tag is None:
                    break
                verified_by_scan = True
                logger.warning(
                    "falling back to newest complete checkpoint tag %r "
                    "under %s", tag, load_dir)
            tried.append(tag)
            ok, reason = (True, None) if verified_by_scan \
                else ckpt.verify_tag(load_dir, tag)
            if ok or reason == ckpt.NO_MANIFEST:
                if not ok:
                    logger.warning(
                        "checkpoint %s/%s predates the manifest format — "
                        "loading without integrity verification",
                        load_dir, tag)
                try:
                    return self._load_checkpoint_tag(
                        load_dir, tag, load_module_strict,
                        load_optimizer_states, load_lr_scheduler_states,
                        load_from_fp32_weights)
                except ckpt.CheckpointCorruptionError as err:
                    if ok:
                        # the bytes verified, yet the load failed: every
                        # other tag would fail the same way
                        raise
                    _reject(tag, err)
            else:
                _reject(tag, reason)
            tag = None
        logger.warning(
            "Unable to find a loadable checkpoint under {} (requested "
            "tag: {}); pass a valid tag or check the rejection log "
            "above".format(load_dir, requested if requested is not None
                           else "latest"))
        return None, None

    def _zero_state(self, load_dir, tag, sd, load_optimizer_states):
        """The full master and moment leaves of a ZeRO tag from every zero
        file (``checkpointing.zero_state``), None where it has none."""
        import glob
        paths = sorted(glob.glob(os.path.join(
            load_dir, str(tag), "zero_pp_rank_*_mp_rank_00_optim_states.pt")))
        if not paths:
            if load_optimizer_states:
                logger.warning(
                    "checkpoint %s/%s carries no optimizer state (no "
                    "gathered tree, no zero shard files) — optimizer "
                    "state starts fresh", load_dir, tag)
            return None, None
        payloads = [ckpt.load_state_dict(p) for p in paths]
        self._loaded_qg_error = ckpt.zero_qg_error(payloads,
                                                   self._jax_leaf_names())
        for path, payload in zip(paths, payloads):
            if payload.get("torn_step") is not None:
                logger.warning(
                    "zero file %s records a torn offload step (%s): that "
                    "rank's masters were partly stepped when it was "
                    "written", path, payload["torn_step"])
        fused = ("exp_avg", "worker_error", "server_error") \
            if self._onebit_mode else ()
        return ckpt.zero_state(payloads, self._jax_leaf_names(),
                               sd["module"], load_optimizer_states,
                               fused_keys=fused)

    def _checked(self, state, what, strict):
        """A full state_dict from a tag, its names and shapes checked
        against the model (missing names raise under ``strict``)."""
        shapes = self._full_shapes()
        missing = sorted(set(shapes) - set(state))
        unexpected = sorted(set(state) - set(shapes))
        if (missing and strict) or unexpected:
            raise RuntimeError(
                "checkpoint {} does not fit the model: missing {}, "
                "unexpected {}".format(what, missing[:5], unexpected[:5]))
        for name, t in state.items():
            if tuple(t.shape) != tuple(shapes[name]):
                raise RuntimeError(
                    "checkpoint {} {} has shape {}, the model {}".format(
                        what, name, tuple(t.shape), tuple(shapes[name])))
        return state

    def _load_checkpoint_tag(self, load_dir, tag, load_module_strict,
                             load_optimizer_states,
                             load_lr_scheduler_states,
                             load_from_fp32_weights):
        path = ckpt.model_ckpt_name(load_dir, tag)
        if not os.path.isfile(path):
            raise ckpt.CheckpointCorruptionError(
                "model states file {} does not exist".format(path))
        sd = self._adapt_state_dict(ckpt.load_state_dict(path))
        conv = self._tree_converters()
        master, opt = None, None
        self._loaded_qg_error = None
        if sd.get("master") is not None:
            master = conv["params_from_jax"](sd["master"])
        if sd.get("optimizer") is not None:
            opt = dict(conv["optimizer_state_from_jax"](sd["optimizer"]))
        else:
            master, opt = self._zero_state(load_dir, tag, sd,
                                           load_optimizer_states)
        module = self._checked(conv["params_from_jax"](sd["module"]),
                               "module", load_module_strict)
        if master is not None:
            master = self._checked(master, "master", load_module_strict)
        src = master if load_from_fp32_weights and master is not None \
            else module
        flat = self.flat
        self._drop_posted()
        flat.load(flat.master, self._own_shard(
            {k: v.float() for k, v in src.items()}))
        flat.refresh_params()
        qg = conv["params_from_jax"](sd["qg_error"]) \
            if sd.get("qg_error") is not None else self._loaded_qg_error
        if qg is not None and flat.qg_error is not None:
            flat.load(flat.qg_error, self._own_shard(self._checked(
                {k: torch.as_tensor(np.asarray(v, np.float32))
                 if not isinstance(v, torch.Tensor) else v.float()
                 for k, v in qg.items()}, "qg_error", load_module_strict)))
        self._onebit_pristine = None
        if load_optimizer_states and opt is not None and self._onebit_mode:
            if all(k in opt and isinstance(opt[k], dict) and "_flat" in
                   opt[k] for k in ("exp_avg", "worker_error",
                                    "server_error")):
                self._checked(opt["exp_avg_sq"], "exp_avg_sq",
                              load_module_strict)
                self._load_onebit_state(
                    opt, saved_world=sd.get("dp_world_size"),
                    pristine=sd.get("onebit_pristine"))
            else:
                logger.warning(
                    "checkpoint %s carries no OneBitAdam state (saved under "
                    "a different optimizer) — optimizer state starts fresh",
                    path)
        elif load_optimizer_states and opt is not None:
            for key in ("exp_avg", "exp_avg_sq"):
                flat.load(getattr(flat, key), self._own_shard(
                    self._checked(opt[key], key, load_module_strict)))
            flat.step = int(opt["step"])
        sc = sd.get("scaler")
        if sc is not None:
            self.scaler = self.scaler._replace(
                cur_scale=float(np.asarray(sc["cur_scale"])),
                cur_hysteresis=int(np.asarray(sc["cur_hysteresis"])),
                last_overflow_iter=int(np.asarray(sc["last_overflow_iter"])),
                cur_iter=int(np.asarray(sc["cur_iter"])))
        sched = self.lr_scheduler
        if load_lr_scheduler_states and sd.get("lr_scheduler") is not None \
                and hasattr(sched, "load_state_dict"):
            sched.load_state_dict(sd["lr_scheduler"])
            if getattr(sched, "last_batch_iteration", -1) >= 0:
                # the learning rate the saving run would step with next
                sched.step(sched.last_batch_iteration)
        self.global_steps = int(sd.get("global_steps", 0))
        if self._onebit_pristine is not None:
            self._onebit_pristine["steps"] = self.global_steps
        self.global_samples = int(sd.get(
            "global_samples", self.global_steps * self.train_batch_size()))
        self.skipped_steps = int(sd.get("skipped_steps", 0))
        self.loaded_checkpoint_dp_world_size = sd.get("dp_world_size")
        if sd.get("torn_offload_step") is not None:
            logger.warning(
                "checkpoint %s records a torn offload step (%s): the host "
                "masters were partly stepped when it was written",
                path, sd["torn_offload_step"])
        known = {"module", "optimizer", "master", "scaler", "lr_scheduler",
                 "qg_error", "onebit_pristine", "csr_tensor_module_names",
                 "skipped_steps", "global_steps", "global_samples",
                 "dp_world_size", "mp_world_size", "torn_offload_step"}
        client_state = {k: v for k, v in sd.items() if k not in known}
        logger.info("Loaded checkpoint: {} @ global_step={}".format(
            path, self.global_steps))
        return path, client_state
