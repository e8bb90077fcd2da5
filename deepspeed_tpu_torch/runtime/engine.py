"""DeepSpeedEngine: the training engine on one device.

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

Tensor parallelism: with an ``mpu`` (Megatron style, or an object with a
``.mesh``) or a ``mesh=`` whose ``model`` axis n > 1, and the ds_config
``comm.collective_matmul`` section on, the engine swaps the module for
this rank's shard (``tensor_parallel_shard``), whose own copy of the
config carries a ``CollectiveMatmulBinding`` over the model group; the
four TP sites of each block then run the ring ops. After the micro steps
it all-reduces the gradients of the parameters every rank holds whole
over the group, reduces the overflow flag (max) and the global gradient
norm (each sharded square once, each replicated one once), so every rank
takes the same decisions and issues the same hops. The JAX-tree methods
gather or slice the full tree. Client optimizers and LR schedulers,
checkpoints, telemetry and data-parallel worlds above 1 come with later
slices and raise ``NotImplementedError``.
"""
import inspect
import os

import numpy as np
import torch
import torch.distributed as dist

from ..inference.engine import resolve_device
from ..ops.adam.fused_adam import FusedAdam
from ..ops.lamb.fused_lamb import FusedLamb
from ..ops.transformer.attention import resolve_flash_backend
from ..parallel.collective_matmul import CollectiveMatmulBinding
from ..parallel.topology import DATA_AXIS, MODEL_AXIS, build_mesh
from ..utils.distributed import all_gather, all_reduce_
from ..utils.logging import log_dist, logger
from . import utils as rt_utils
from .comm.config import warn_or_raise_noop
from .config import DeepSpeedConfig
from .constants import ADAM_OPTIMIZER, LAMB_OPTIMIZER, MAX_GRAD_NORM
from .fp16 import loss_scaler as ls
from .progressive_layer_drop import ProgressiveLayerDrop
from .zero.partition import FlatPartition

FUSED_KERNEL_MODES = ("auto", "pallas", "xla")


class DeepSpeedEngine:
    """Train a module with ZeRO stages 0-2 at data-parallel world size 1,
    optionally tensor-parallel over a ``model`` group, mixed precision
    over fp32 master weights and Adam/AdamW or LAMB."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device=None,
                 mesh=None):
        for name, value, later in (
                ("optimizer", optimizer, "a client optimizer"),
                ("lr_scheduler", lr_scheduler, "the LR-schedule slice"),
                ("training_data", training_data, "the data-loader slice"),
                ("model_parameters", model_parameters,
                 "a later slice (the module's own parameters are used)")):
            if value is not None:
                raise NotImplementedError(
                    "initialize({}=...) is not ported yet: it comes with "
                    "{}".format(name, later))
        assert model is not None, "deepspeed.initialize requires a model"
        self.device = resolve_device(device)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training_dataloader = None
        self.lr_scheduler = None
        self._configure_mesh(mpu, mesh)
        # the batch triple is checked against the data-parallel world: the
        # process group's, divided by the model axis
        self._config = DeepSpeedConfig(*self._resolve_config(
            args, config_params), world_size=self.dp_world_size
            if self.mp_world_size > 1 else None)
        self.dp_world_size = self._config.world_size
        if self.dp_world_size != 1:
            raise NotImplementedError(
                "data-parallel world size {} is not ported yet: ZeRO over "
                "several GPUs comes with the multi-GPU ZeRO slice "
                "(torch.distributed)".format(self.dp_world_size))
        self.module = model
        self.flash_attention_backend = None
        self.fused_optimizer_kernel = None
        self._configure_precision()
        self._apply_transformer_overrides()
        self._configure_comm()
        self._configure_optimizer()
        self._configure_pld()
        self._init_state()
        self._generator = torch.Generator().manual_seed(
            int(os.environ.get("DEEPSPEED_SEED", 42)))
        self._forward_kwargs = set(inspect.signature(
            model.forward).parameters)
        self._pending_backward = False
        self._step_metrics = {}
        self.module.train()
        if self._config.dump_state:
            self._config.print("DeepSpeedEngine configuration")
        log_dist("DeepSpeedEngine ready: params={:,} zero_stage={} dtype={} "
                 "device={}".format(
                     rt_utils.count_parameters(model),
                     self.zero_optimization_stage(), self.compute_dtype,
                     self.device), ranks=[0])

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
        self._tp_group = None
        if self.mp_world_size > 1:
            self._tp_group = tp_group if tp_group is not None \
                else mesh.get_group(MODEL_AXIS)
        self.global_rank = dist.get_rank() if dist.is_initialized() else 0

    def _configure_comm(self):
        """comm.collective_matmul, as the JAX engine's
        ``_configure_comm``: with the section on and a ``model`` axis > 1,
        swap in this rank's shard of the module, bound to a
        CollectiveMatmulBinding over the model group (the caller's model
        and config stay unbound). The ZeRO-3 ring
        gather has no site at stages 0-2. Tensor parallelism runs only
        through the ring ops here: a ``model`` axis > 1 without the
        section raises."""
        cm = self._config.comm_config.collective_matmul
        self._cm = cm
        self._cm_tp = False
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
        if not self._cm_tp:
            warn_or_raise_noop(
                "comm.collective_matmul is enabled but no fusion site is "
                "live (needs a model mesh axis > 1 on a binding-aware "
                "model; the ZeRO-3 ring gather needs stage 3)", cm.strict,
                flag="comm.collective_matmul.strict")
        else:
            log_dist("collective_matmul ON: tp_fused=True tp={} chunks={} "
                     "dtype={} backend={} transport={}".format(
                         self.mp_world_size, cm.chunks, cm.dtype,
                         cm.backend, self.comm_transport), ranks=[0])

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

    def _configure_optimizer(self):
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        if name not in (ADAM_OPTIMIZER, "adamw", LAMB_OPTIMIZER):
            raise NotImplementedError(
                "optimizer {!r} is not ported yet: this slice runs Adam, "
                "AdamW and LAMB (OneBitAdam comes with the "
                "compressed-communication slice)".format(name))
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
        else:
            if name == "adamw":
                params.setdefault("adam_w_mode", True)
            self.optimizer = FusedAdam(use_kernel=use_kernel, **params)
        log_dist("Using DeepSpeed optimizer: {} (apply: {})".format(
            name, self.fused_optimizer_kernel), ranks=[0])

    def _configure_pld(self):
        if self._config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                **(self._config.pld_params or {}))
        else:
            self.progressive_layer_drop = None

    def _init_state(self):
        accum = torch.bfloat16 if self._config.grad_accum_dtype == "bf16" \
            else torch.float32
        if accum == torch.bfloat16 and self.gradient_accumulation_steps() > 1:
            logger.warning(
                "grad_accum_dtype=bf16 with gradient_accumulation_steps=%d: "
                "bf16 summation across micro-steps is lossy",
                self.gradient_accumulation_steps())
        replicated = ()
        if self._cm_tp:
            spec = self._module_fn("partition_spec_fn")
            replicated = [name for name, p in self.module.named_parameters()
                          if spec(name, tuple(p.shape)) is None]
        self.flat = FlatPartition(self.module, self.device,
                                  self.compute_dtype,
                                  world_size=self.dp_world_size,
                                  accum_dtype=accum, replicated=replicated)
        self.scaler = ls.loss_scaler_from_config(self._config)

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

    def forward(self, *inputs, **kwargs):
        """Run a micro-batch -> the loss. In train mode the graph is kept
        for :meth:`backward`; in eval mode it runs without gradients."""
        if len(inputs) == 1 and isinstance(inputs[0], (tuple, list)):
            inputs = tuple(inputs[0])
        inputs = tuple(self._to_device(x) for x in inputs)
        if "generator" in self._forward_kwargs and self.module.training:
            kwargs.setdefault("generator", self._generator)
        if self.progressive_layer_drop and self.module.training:
            # as the JAX engine: only the kwargs the forward takes
            for key, value in self.progressive_layer_drop.get_state().items():
                if key in self._forward_kwargs:
                    kwargs.setdefault(key, value)
        if not self.module.training:
            with torch.no_grad():
                return self.module(*inputs, **kwargs)
        loss = self.module(*inputs, **kwargs)
        self._pending_backward = True
        return loss

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Back-propagate ``loss * loss_scale / gas`` into the flat
        gradient buffer and fold it into the fp32 accumulator."""
        assert self._pending_backward, \
            "backward() called without a prior train-mode forward()"
        self._pending_backward = False
        scale = self.scaler.cur_scale / self.gradient_accumulation_steps()
        (loss.float() * scale).backward()
        self.flat.fold_grads()
        return loss

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None):
        """The optimizer step at gradient-accumulation boundaries."""
        if self.is_gradient_accumulation_boundary():
            self._take_model_step()
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * \
            self.dp_world_size

    def _apply_step(self):
        """Overflow check, unscale, clip, the optimizer, params refresh,
        zero acc."""
        flat = self.flat
        group = self._tp_group if self._cm_tp else None
        if group is not None:
            # the whole-on-every-rank parameters saw only this rank's rows
            all_reduce_(flat.acc[:flat.replicated_end], group)
        grads = flat.acc
        if grads.dtype != torch.float32:
            grads = grads.float()
        overflow = rt_utils.CheckOverflow.has_overflow(grads)
        if group is not None:
            overflow = all_reduce_(overflow.float().reshape(1), group,
                                   dist.ReduceOp.MAX)[0] > 0
        overflow = bool(overflow)
        scale = self.scaler.cur_scale
        if scale != 1.0:
            grads.mul_(1.0 / scale)
        total_norm = None
        if group is not None:
            rep_end = flat.replicated_end
            sq = grads[rep_end:].pow(2).sum().reshape(1)
            total_norm = (all_reduce_(sq, group)[0] +
                          grads[:rep_end].pow(2).sum()).sqrt()
        clip = self.gradient_clipping()
        if clip > 0:
            grad_norm = rt_utils.clip_grad_norm_(grads, clip,
                                                 total_norm=total_norm)
        else:
            grad_norm = total_norm if total_norm is not None \
                else rt_utils.get_grad_norm(grads)
        if not overflow:
            self.optimizer.step_flat(flat.master, grads, flat.exp_avg,
                                     flat.exp_avg_sq, flat.step + 1,
                                     segments=flat.segments, group=group,
                                     sharded_from=flat.replicated_end)
            flat.step += 1
            flat.refresh_params()
        flat.acc.zero_()
        metrics = {"overflow": overflow, "grad_norm": grad_norm,
                   "loss_scale": scale}
        self.scaler = ls.update_scale(self.scaler, overflow)
        return metrics

    def _take_model_step(self):
        metrics = self._apply_step()
        self._step_metrics = metrics
        if metrics["overflow"]:
            self.skipped_steps += 1
            log_dist("OVERFLOW! Skipping step. Attempted loss scale: "
                     "{}".format(metrics["loss_scale"]), ranks=[0])
        if self.progressive_layer_drop:
            self.progressive_layer_drop.update_state(self.global_steps)
        self.global_steps += 1
        if self.global_steps % self.steps_per_print() == 0:
            log_dist("step={}, lr={}, loss_scale={}".format(
                self.global_steps, self.get_lr(), self.scaler.cur_scale),
                ranks=[0])

    def train_batch(self, data_iter=None, batch=None):
        """One global batch: ``batch`` is a tuple of arrays stacked
        ``(gas, global_batch, ...)`` (or ``data_iter`` yields ``gas``
        micro-batches); every micro step, then the apply step. Returns the
        mean loss, a 0-dim fp32 tensor on the device."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            assert data_iter is not None, \
                "train_batch needs batch= or data_iter="
            micro = [tuple(next(data_iter)) for _ in range(gas)]
            batch = tuple(np.stack([np.asarray(m[i]) for m in micro])
                          for i in range(len(micro[0])))
        batch = tuple(self._to_device(x) for x in batch)
        self.module.train()
        losses = []
        for i in range(gas):
            loss = self.forward(*(x[i] for x in batch))
            self.backward(loss)
            losses.append(loss.detach().float())
        self._take_model_step()
        self.micro_steps += gas
        self.global_samples += self.train_batch_size()
        return torch.stack(losses).mean()

    # ----------------------------------------------------------- accessors

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
        return [float(self.optimizer.lr)]

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

    def _module_fn(self, name):
        module = inspect.getmodule(type(self.module))
        if not hasattr(module, name):
            raise NotImplementedError("{} has no {}".format(
                getattr(module, "__name__", module), name))
        return getattr(module, name)

    def _full_tree(self, flat):
        """A flat buffer -> the full model's ``{dotted name: fp32 CPU
        tensor}``: under tensor parallelism every rank's buffer is
        gathered over the group (one all-gather; every rank must call)
        and the shards joined (the module's ``tp_gather_state_dicts``)."""
        if not self._cm_tp:
            return self.flat.tree_of(flat)
        parts = all_gather(flat.detach(), self._tp_group, dim=0)
        shards = [self.flat.tree_of(p) for p in
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
        (the model module's ``params_to_jax`` naming); under tensor
        parallelism the full tree, gathered (every rank must call)."""
        to_jax = self._tree_converters()["params_to_jax"]
        return to_jax(self._full_tree(self.flat.master))

    def get_optimizer_state(self):
        """``{"step", "exp_avg", "exp_avg_sq"}`` as JAX-shaped trees (Adam's
        and LAMB's state have the same shape); full trees, as
        :meth:`get_master_params`."""
        to_jax = self._tree_converters()["optimizer_state_to_jax"]
        return to_jax({
            "step": self.flat.step,
            "exp_avg": self._full_tree(self.flat.exp_avg),
            "exp_avg_sq": self._full_tree(self.flat.exp_avg_sq)})

    def load_state_from_jax(self, master=None, optimizer_state=None):
        """Start from a JAX engine's state: an fp32 master tree and/or an
        optimizer state ``{"step", "exp_avg", "exp_avg_sq"}`` (numpy
        trees)."""
        conv = self._tree_converters()
        if master is not None:
            self.flat.load(self.flat.master,
                           self._own_shard(conv["params_from_jax"](master)))
            self.flat.refresh_params()
        if optimizer_state is not None:
            state = conv["optimizer_state_from_jax"](optimizer_state)
            self.flat.load(self.flat.exp_avg,
                           self._own_shard(state["exp_avg"]))
            self.flat.load(self.flat.exp_avg_sq,
                           self._own_shard(state["exp_avg_sq"]))
            self.flat.step = state["step"]
