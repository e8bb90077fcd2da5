"""DeepSpeedEngine: the training engine on one device.

Port of ``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``, returned by
``deepspeed_tpu_torch.initialize()``. The same step anatomy and method
names:

* micro step (``forward`` + ``backward``): the loss times ``loss_scale /
  gradient_accumulation_steps`` is back-propagated into the flat
  compute-dtype gradient buffer (every ``.grad`` is a view of it), then
  one ``add_`` folds it into the fp32 accumulator;
* apply step (``step`` at an accumulation boundary): overflow check,
  unscale, clip or norm, the Adam update over the flat fp32 master
  partition (one launch of the CUDA kernel), overflow skip, master ->
  compute-dtype params, zero the accumulator, loss-scale update;
* ``train_batch(batch=(ids, labels))``: all micro steps of one global
  batch, stacked ``(gas, global_batch, ...)`` as the JAX package takes
  it, then the apply step.

Where the JAX engine keeps the overflow flag on the device and selects the
old state branchlessly, this engine reads the flag on the host once per
optimizer step (one small synchronisation) and skips the update.

The model is an ``nn.Module`` whose ``forward(*batch)`` returns the loss
(``models.gpt2.GPT2Model``; a ``generator`` keyword, when the forward
takes one, receives the engine's dropout generator). Its parameters
become views of the engine's flat buffers on ``device``, CUDA unless the
caller asks for the CPU. Client optimizers and LR schedulers, checkpoints,
telemetry and world sizes above 1 come with later slices and raise
``NotImplementedError``.
"""
import inspect
import os

import numpy as np
import torch

from ..inference.engine import resolve_device
from ..ops.adam.fused_adam import FusedAdam
from ..ops.transformer.attention import resolve_flash_backend
from ..utils.logging import log_dist, logger
from . import utils as rt_utils
from .config import DeepSpeedConfig
from .constants import ADAM_OPTIMIZER, MAX_GRAD_NORM
from .fp16 import loss_scaler as ls
from .zero.partition import FlatPartition

FUSED_KERNEL_MODES = ("auto", "pallas", "xla")


class DeepSpeedEngine:
    """Train a module with ZeRO stages 0-2 at world size 1, mixed precision
    over fp32 master weights and Adam/AdamW."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device=None):
        for name, value, later in (
                ("optimizer", optimizer, "a client optimizer"),
                ("lr_scheduler", lr_scheduler, "the LR-schedule slice"),
                ("training_data", training_data, "the data-loader slice"),
                ("mpu", mpu, "the tensor-parallel slice"),
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
        self._config = DeepSpeedConfig(*self._resolve_config(
            args, config_params))
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
        self._configure_optimizer()
        self._init_state()
        self._generator = torch.Generator().manual_seed(
            int(os.environ.get("DEEPSPEED_SEED", 42)))
        self._takes_generator = "generator" in inspect.signature(
            model.forward).parameters
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
            model_cfg.use_flash_attention = resolved != "xla"
            model_cfg.flash_attention_backend = resolved
            log_dist("transformer.flash_attention={} resolved to {!r}".format(
                flash, resolved), ranks=[0])
        else:
            logger.warning("transformer.flash_attention has NO effect: the "
                           "model exposes no flash_attention_backend field")

    def _configure_optimizer(self):
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        if name not in (ADAM_OPTIMIZER, "adamw"):
            raise NotImplementedError(
                "optimizer {!r} is not ported yet: this slice runs Adam and "
                "AdamW (LAMB comes with the BERT slice, OneBitAdam with the "
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
        if name == "adamw":
            params.setdefault("adam_w_mode", True)
        self.optimizer = FusedAdam(
            use_kernel=self.fused_optimizer_kernel == "pallas", **params)
        log_dist("Using DeepSpeed optimizer: {} (apply: {})".format(
            name, self.fused_optimizer_kernel), ranks=[0])

    def _init_state(self):
        accum = torch.bfloat16 if self._config.grad_accum_dtype == "bf16" \
            else torch.float32
        if accum == torch.bfloat16 and self.gradient_accumulation_steps() > 1:
            logger.warning(
                "grad_accum_dtype=bf16 with gradient_accumulation_steps=%d: "
                "bf16 summation across micro-steps is lossy",
                self.gradient_accumulation_steps())
        self.flat = FlatPartition(self.module, self.device,
                                  self.compute_dtype,
                                  world_size=self.dp_world_size,
                                  accum_dtype=accum)
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
        if self._takes_generator and self.module.training:
            kwargs.setdefault("generator", self._generator)
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
        """Overflow check, unscale, clip, Adam, params refresh, zero acc."""
        flat = self.flat
        grads = flat.acc
        if grads.dtype != torch.float32:
            grads = grads.float()
        overflow = bool(rt_utils.CheckOverflow.has_overflow(grads))
        scale = self.scaler.cur_scale
        if scale != 1.0:
            grads.mul_(1.0 / scale)
        clip = self.gradient_clipping()
        if clip > 0:
            grad_norm = rt_utils.clip_grad_norm_(grads, clip)
        else:
            grad_norm = rt_utils.get_grad_norm(grads)
        if not overflow:
            self.optimizer.step_flat(flat.master, grads, flat.exp_avg,
                                     flat.exp_avg_sq, flat.step + 1)
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

    def get_master_params(self):
        """The fp32 master weights as the JAX-shaped tree of numpy arrays
        (``models.gpt2.params_to_jax`` naming)."""
        from ..models.gpt2 import params_to_jax
        return params_to_jax(self.flat.tree_of(self.flat.master))

    def get_optimizer_state(self):
        """``{"step", "exp_avg", "exp_avg_sq"}`` as JAX-shaped trees."""
        from ..models.gpt2 import optimizer_state_to_jax
        return optimizer_state_to_jax({
            "step": self.flat.step,
            "exp_avg": self.flat.tree_of(self.flat.exp_avg),
            "exp_avg_sq": self.flat.tree_of(self.flat.exp_avg_sq)})

    def load_state_from_jax(self, master=None, optimizer_state=None):
        """Start from a JAX engine's state: an fp32 master tree and/or an
        Adam state ``{"step", "exp_avg", "exp_avg_sq"}`` (numpy trees)."""
        from ..models.gpt2 import params_from_jax, optimizer_state_from_jax
        if master is not None:
            self.flat.load(self.flat.master, params_from_jax(master))
            self.flat.refresh_params()
        if optimizer_state is not None:
            state = optimizer_state_from_jax(optimizer_state)
            self.flat.load(self.flat.exp_avg, state["exp_avg"])
            self.flat.load(self.flat.exp_avg_sq, state["exp_avg_sq"])
            self.flat.step = state["step"]
