"""``ds_config.json`` parser for training.

Port of ``deepspeed_tpu/runtime/config.py::DeepSpeedConfig``: the same
JSON surface, the batch-triple inference (any two of train_batch_size,
train_micro_batch_size_per_gpu and gradient_accumulation_steps determine
the third), the duplicate-key rejection, the same assertions and the
unknown-key validation (warn by default, ``"config_validation":
"strict"`` raises, ``"ignore"`` is silent). ``world_size`` is the
data-parallel world: ``torch.distributed``'s when a process group is up,
else 1, or the caller's.

This slice runs ``bf16`` / ``fp16`` / ``amp`` mixed precision,
``zero_optimization`` stages 0-2, Adam/AdamW and LAMB (``optimizer.params``
including ``fused_kernel``), ``gradient_clipping``,
``progressive_layer_drop`` (the keep-probability schedule),
``data_types.grad_accum_dtype``, ``steps_per_print``,
``transformer.flash_attention`` and ``sparse_attention`` (parsed per mode
as the JAX package does; the model reads it through
``engine.sparse_attention_config()``). Every other section the JAX package
accepts parses here too, but switching it on raises
``NotImplementedError`` naming the later slice that brings it
(:data:`UNPORTED_SECTIONS`).
"""
import json

from .constants import *  # noqa: F401,F403
from .config_utils import (get_scalar_param,
                           dict_raise_error_on_duplicate_keys)
from .zero.config import DeepSpeedZeroConfig
from .zero.constants import MAX_STAGE_ZERO_OPTIMIZATION
from ..inference.config import DeepSpeedInferenceConfig, INFERENCE
from ..utils.logging import logger

TENSOR_CORE_ALIGN_SIZE = 8

TRANSFORMER = "transformer"
TRANSFORMER_FLASH_ATTENTION = "flash_attention"
TRANSFORMER_FLASH_ATTENTION_MODES = ("auto", "pallas", "xla")

# ds_config sections of the JAX package that this slice does not run, with
# the later slice of the port that brings each. A section that is present
# and switched on raises NotImplementedError; ``{"enabled": false}`` or
# ``false`` is accepted.
UNPORTED_SECTIONS = {
    SCHEDULER: "the LR-schedule slice",
    CHECKPOINT: "the checkpoint slice",
    SPARSE_GRADIENTS: "the multi-GPU ZeRO slice",
    "elasticity": "the elastic-training slice",
    "activation_checkpointing": "the activation-checkpointing slice",
    "flops_profiler": "the observability slice",
    WALL_CLOCK_BREAKDOWN: "the observability slice",
    MEMORY_BREAKDOWN: "the observability slice",
    TENSORBOARD: "the observability slice",
    "telemetry": "the observability slice",
    "analysis": "the observability slice",
    "controller": "the observability and control slice",
    "comm": "the multi-GPU communication slice",
    "runtime": "the offload and executor slice",
}


class DeepSpeedConfigError(Exception):
    pass


def _section_on(value):
    if isinstance(value, dict):
        return value.get("enabled", True) is not False
    return bool(value)


def get_fp16_enabled(param_dict):
    if FP16 in param_dict:
        return get_scalar_param(param_dict[FP16], FP16_ENABLED,
                                FP16_ENABLED_DEFAULT)
    return False


def get_bf16_enabled(param_dict):
    if BF16 in param_dict:
        return get_scalar_param(param_dict[BF16], BF16_ENABLED,
                                BF16_ENABLED_DEFAULT)
    return False


def get_amp_enabled(param_dict):
    if AMP in param_dict:
        return get_scalar_param(param_dict[AMP], AMP_ENABLED,
                                AMP_ENABLED_DEFAULT)
    return False


def get_loss_scale(param_dict):
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[FP16], FP16_LOSS_SCALE,
                                FP16_LOSS_SCALE_DEFAULT)
    return FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    if get_fp16_enabled(param_dict):
        initial_scale_power = get_scalar_param(
            param_dict[FP16], FP16_INITIAL_SCALE_POWER,
            FP16_INITIAL_SCALE_POWER_DEFAULT)
    else:
        initial_scale_power = FP16_INITIAL_SCALE_POWER_DEFAULT
    return 2 ** initial_scale_power


def get_dynamic_loss_scale_args(param_dict):
    loss_scale_args = None
    if get_fp16_enabled(param_dict):
        fp16_dict = param_dict[FP16]
        dynamic_keys = (FP16_INITIAL_SCALE_POWER, FP16_LOSS_SCALE_WINDOW,
                        FP16_MIN_LOSS_SCALE, FP16_HYSTERESIS)
        if any(key in fp16_dict for key in dynamic_keys):
            init_scale = get_scalar_param(fp16_dict, FP16_INITIAL_SCALE_POWER,
                                          FP16_INITIAL_SCALE_POWER_DEFAULT)
            scale_window = get_scalar_param(fp16_dict, FP16_LOSS_SCALE_WINDOW,
                                            FP16_LOSS_SCALE_WINDOW_DEFAULT)
            delayed_shift = get_scalar_param(fp16_dict, FP16_HYSTERESIS,
                                             FP16_HYSTERESIS_DEFAULT)
            min_loss_scale = get_scalar_param(fp16_dict, FP16_MIN_LOSS_SCALE,
                                              FP16_MIN_LOSS_SCALE_DEFAULT)
            loss_scale_args = {
                "init_scale": 2 ** init_scale,
                "scale_window": scale_window,
                "delayed_shift": delayed_shift,
                "min_scale": min_loss_scale,
            }
    return loss_scale_args


def get_grad_accum_dtype(param_dict):
    """data_types.grad_accum_dtype: storage dtype of the gradient
    accumulator ("bf16" or "fp32"; None keeps fp32)."""
    sub = param_dict.get("data_types") or {}
    if not isinstance(sub, dict):
        raise DeepSpeedConfigError(
            f"data_types must be a dict, got {type(sub).__name__}")
    val = sub.get("grad_accum_dtype")
    if val is None:
        return None
    norm = str(val).lower()
    if norm not in ("fp32", "float32", "bf16", "bfloat16"):
        raise DeepSpeedConfigError(
            f"data_types.grad_accum_dtype={val!r}: want fp32 or bf16")
    return "bf16" if norm in ("bf16", "bfloat16") else "fp32"


def get_transformer_flash_attention(param_dict):
    """``transformer.flash_attention``: ``None`` (absent), or one of
    "auto" | "pallas" | "xla" (bools: true -> "auto", false -> "xla"). An
    unknown spelling raises."""
    sub = param_dict.get(TRANSFORMER) or {}
    if not isinstance(sub, dict):
        raise DeepSpeedConfigError(
            "transformer must be a dict, got {}".format(type(sub).__name__))
    val = sub.get(TRANSFORMER_FLASH_ATTENTION)
    if val is None:
        return None
    if isinstance(val, bool):
        return "auto" if val else "xla"
    if not isinstance(val, str) or \
            val.lower() not in TRANSFORMER_FLASH_ATTENTION_MODES:
        raise DeepSpeedConfigError(
            "transformer.{} must be a bool, null or one of {}, got {!r}"
            .format(TRANSFORMER_FLASH_ATTENTION,
                    "|".join(TRANSFORMER_FLASH_ATTENTION_MODES), val))
    return val.lower()


def get_sparse_attention(param_dict):
    """The ``sparse_attention`` section parsed per its mode into a dict of
    every key of that mode, defaults filled; None when absent."""
    if SPARSE_ATTENTION not in param_dict:
        return None
    sparsity = param_dict[SPARSE_ATTENTION]
    mode = get_scalar_param(sparsity, SPARSE_MODE, SPARSE_MODE_DEFAULT)
    getters = {
        SPARSE_DENSE_MODE: get_sparse_dense_config,
        SPARSE_FIXED_MODE: get_sparse_fixed_config,
        SPARSE_VARIABLE_MODE: get_sparse_variable_config,
        SPARSE_BIGBIRD_MODE: get_sparse_bigbird_config,
        SPARSE_BSLONGFORMER_MODE: get_sparse_bslongformer_config,
        SPARSE_SLIDING_WINDOW_MODE: get_sparse_sliding_window_config,
    }
    if mode not in getters:
        raise NotImplementedError(
            "Given sparsity mode, {}, has not been implemented yet!".format(
                mode))
    return getters[mode](sparsity)


def _sparse_params(sparsity, mode, keys):
    """{mode, key: value or its default} for ``keys`` (constants' names
    without the SPARSE_ prefix)."""
    g = globals()
    out = {SPARSE_MODE: mode}
    for key in keys:
        out[g["SPARSE_" + key]] = get_scalar_param(
            sparsity, g["SPARSE_" + key], g["SPARSE_" + key + "_DEFAULT"])
    return out


def get_sparse_dense_config(sparsity):
    return _sparse_params(sparsity, SPARSE_DENSE_MODE, ("BLOCK",))


def get_sparse_fixed_config(sparsity):
    return _sparse_params(sparsity, SPARSE_FIXED_MODE, (
        "BLOCK", "DIFFERENT_LAYOUT_PER_HEAD", "NUM_LOCAL_BLOCKS",
        "NUM_GLOBAL_BLOCKS", "ATTENTION_TYPE", "HORIZONTAL_GLOBAL_ATTENTION",
        "NUM_DIFFERENT_GLOBAL_PATTERNS"))


def get_sparse_variable_config(sparsity):
    return _sparse_params(sparsity, SPARSE_VARIABLE_MODE, (
        "BLOCK", "DIFFERENT_LAYOUT_PER_HEAD", "NUM_RANDOM_BLOCKS",
        "LOCAL_WINDOW_BLOCKS", "GLOBAL_BLOCK_INDICES",
        "GLOBAL_BLOCK_END_INDICES", "ATTENTION_TYPE",
        "HORIZONTAL_GLOBAL_ATTENTION"))


def get_sparse_bigbird_config(sparsity):
    return _sparse_params(sparsity, SPARSE_BIGBIRD_MODE, (
        "BLOCK", "DIFFERENT_LAYOUT_PER_HEAD", "NUM_RANDOM_BLOCKS",
        "NUM_SLIDING_WINDOW_BLOCKS", "NUM_GLOBAL_BLOCKS"))


def get_sparse_sliding_window_config(sparsity):
    return _sparse_params(sparsity, SPARSE_SLIDING_WINDOW_MODE, (
        "BLOCK", "NUM_SLIDING_WINDOW_BLOCKS"))


def get_sparse_bslongformer_config(sparsity):
    return _sparse_params(sparsity, SPARSE_BSLONGFORMER_MODE, (
        "BLOCK", "DIFFERENT_LAYOUT_PER_HEAD", "NUM_SLIDING_WINDOW_BLOCKS",
        "GLOBAL_BLOCK_INDICES", "GLOBAL_BLOCK_END_INDICES"))


def get_pld_enabled(param_dict):
    if PROGRESSIVE_LAYER_DROP in param_dict:
        return get_scalar_param(param_dict[PROGRESSIVE_LAYER_DROP], PLD_ENABLED,
                                PLD_ENABLED_DEFAULT)
    return False


def get_pld_params(param_dict):
    if PROGRESSIVE_LAYER_DROP in param_dict:
        pld_params = dict(param_dict[PROGRESSIVE_LAYER_DROP])
        pld_params.pop(PLD_ENABLED, None)
        return pld_params
    return False


def get_optimizer_name(param_dict):
    if OPTIMIZER in param_dict and TYPE in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][TYPE]
    return OPTIMIZER_TYPE_DEFAULT


def get_optimizer_params(param_dict):
    if get_optimizer_name(param_dict) is not None and \
            OPTIMIZER_PARAMS in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][OPTIMIZER_PARAMS]
    return None


def _world_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedConfig(object):
    """Typed view of a ``ds_config`` dict (or JSON file path)."""

    # The accepted surface: the JAX package's (one config drives both).
    KNOWN_TOP_LEVEL_KEYS = {
        "train_batch_size", "train_micro_batch_size_per_gpu",
        "gradient_accumulation_steps", "optimizer", "scheduler",
        "fp16", "bf16", "amp", "gradient_clipping",
        "zero_optimization", "zero_allow_untested_optimizer",
        "steps_per_print", "wall_clock_breakdown", "dump_state",
        "memory_breakdown", "tensorboard", "flops_profiler",
        "activation_checkpointing", "sparse_attention",
        "progressive_layer_drop", "elasticity", "checkpoint",
        "sparse_gradients", "prescale_gradients",
        "gradient_predivide_factor", "disable_allgather", "fp32_allreduce",
        "vocabulary_size", "config_validation", "data_types",
        INFERENCE, "telemetry", "comm", TRANSFORMER, "analysis", "runtime",
        "controller", "allgather_size",
    }
    KNOWN_SUBDICT_KEYS = {
        "fp16": {"enabled", "loss_scale", "initial_scale_power",
                 "loss_scale_window", "hysteresis", "min_loss_scale"},
        "bf16": {"enabled"},
        "zero_optimization": {
            "stage", "allgather_partitions", "allgather_bucket_size",
            "overlap_comm", "reduce_scatter",
            "reduce_bucket_size", "contiguous_gradients", "cpu_offload",
            "cpu_offload_params", "cpu_offload_use_pin_memory",
            "sub_group_size", "stage3_prefetch_bucket_size",
            "stage3_max_live_parameters", "stage3_max_reuse_distance",
            "stage3_param_persistence_threshold", "elastic_checkpoint",
            "load_from_fp32_weights",
            "stage3_gather_fp16_weights_on_model_save",
            "zero_quantized_weights", "zero_hierarchical_partition",
            "zero_quantized_gradients", "strict",
            "param_persistence_threshold"},
        "data_types": {"grad_accum_dtype"},
        PROGRESSIVE_LAYER_DROP: {PLD_ENABLED, PLD_THETA, PLD_GAMMA},
        TRANSFORMER: {TRANSFORMER_FLASH_ATTENTION},
        INFERENCE: DeepSpeedInferenceConfig.KNOWN_KEYS,
    }

    def __init__(self, json_file, param_dict=None, world_size=None,
                 inference_only=False):
        self._inference_only = inference_only
        if param_dict is None:
            with open(json_file, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        else:
            self._param_dict = param_dict
        self.global_rank = 0
        self.world_size = int(world_size) if world_size is not None \
            else _world_size()
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._validate_known_keys()
        self._reject_unported()
        self._do_sanity_check()

    def _initialize_params(self, param_dict):
        g = lambda key, default: get_scalar_param(param_dict, key, default)
        self.train_batch_size = g(TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = g(
            TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = g(
            GRADIENT_ACCUMULATION_STEPS, GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = g(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.dump_state = g(DUMP_STATE, DUMP_STATE_DEFAULT)
        self.disable_allgather = g(DISABLE_ALLGATHER,
                                   DISABLE_ALLGATHER_DEFAULT)
        self.allreduce_always_fp32 = g(FP32_ALLREDUCE, FP32_ALLREDUCE_DEFAULT)
        self.prescale_gradients = g(PRESCALE_GRADIENTS,
                                    PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = g(GRADIENT_PREDIVIDE_FACTOR,
                                           GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = g(SPARSE_GRADIENTS,
                                          SPARSE_GRADIENTS_DEFAULT)

        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0
        self.inference_config = DeepSpeedInferenceConfig(param_dict)
        self.transformer_flash_attention = \
            get_transformer_flash_attention(param_dict)
        self.sparse_attention = get_sparse_attention(param_dict)

        self.gradient_clipping = g(GRADIENT_CLIPPING,
                                   GRADIENT_CLIPPING_DEFAULT)
        self.grad_accum_dtype = get_grad_accum_dtype(param_dict)
        self.fp16_enabled = get_fp16_enabled(param_dict)
        self.bf16_enabled = get_bf16_enabled(param_dict)
        self.amp_enabled = get_amp_enabled(param_dict)
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(param_dict)

        self.optimizer_name = get_optimizer_name(param_dict)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(param_dict)
        self.zero_allow_untested_optimizer = g(
            ZERO_ALLOW_UNTESTED_OPTIMIZER,
            ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.wall_clock_breakdown = g(WALL_CLOCK_BREAKDOWN,
                                      WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = g(MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT)
        self.pld_enabled = get_pld_enabled(param_dict)
        self.pld_params = get_pld_params(param_dict)

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, \
            "Train batch size: {} has to be greater than 0".format(train_batch)
        assert micro_batch > 0, \
            "Micro batch size per device: {} has to be greater than 0".format(
                micro_batch)
        assert grad_acc > 0, \
            "Gradient accumulation steps: {} has to be greater than 0".format(
                grad_acc)
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            "Check batch related parameters. train_batch_size is not equal to "
            "micro_batch_per_gpu * gradient_acc_step * world_size: "
            "{} != {} * {} * {}".format(train_batch, micro_batch, grad_acc,
                                        self.world_size))

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if all(v is not None for v in (train_batch, micro_batch, grad_acc)):
            return
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        elif self._inference_only:
            self.train_micro_batch_size_per_gpu = 1
            self.gradient_accumulation_steps = 1
            self.train_batch_size = self.world_size
        else:
            raise AssertionError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _validate_known_keys(self):
        mode = str(self._param_dict.get("config_validation", "warn")).lower()
        if mode not in ("warn", "strict", "ignore"):
            raise DeepSpeedConfigError(
                "config_validation must be one of warn|strict|ignore, got "
                "{!r}".format(mode))
        if mode == "ignore":
            return
        problems = ["unknown top-level key {!r}".format(key)
                    for key in self._param_dict
                    if key not in self.KNOWN_TOP_LEVEL_KEYS]
        for section, known in self.KNOWN_SUBDICT_KEYS.items():
            sub = self._param_dict.get(section)
            if isinstance(sub, dict):
                problems += ["unknown key {!r} in {!r}".format(key, section)
                             for key in sub if key not in known]
        if not problems:
            return
        msg = ("DeepSpeedConfig: {} (set \"config_validation\": \"ignore\" "
               "to bypass)").format("; ".join(problems))
        if mode == "strict":
            raise DeepSpeedConfigError(msg)
        logger.warning(msg)

    def _reject_unported(self):
        for key, later in UNPORTED_SECTIONS.items():
            if key in self._param_dict and _section_on(self._param_dict[key]):
                raise NotImplementedError(
                    "the {!r} ds_config section is not ported yet: it comes "
                    "with {}".format(key, later))

    def _do_sanity_check(self):
        assert self.train_micro_batch_size_per_gpu, \
            "DeepSpeedConfig: {} is not defined".format(
                TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        assert self.gradient_accumulation_steps, \
            "DeepSpeedConfig: {} is not defined".format(
                GRADIENT_ACCUMULATION_STEPS)
        if self.zero_enabled:
            assert self.fp16_enabled or self.bf16_enabled, \
                "DeepSpeedConfig: ZeRO is only supported if fp16/bf16 is " \
                "enabled"
            assert self.zero_optimization_stage <= \
                MAX_STAGE_ZERO_OPTIMIZATION, \
                "DeepSpeedConfig: Maximum supported ZeRO stage is {}".format(
                    MAX_STAGE_ZERO_OPTIMIZATION)
        vocabulary_size = self._param_dict.get(VOCABULARY_SIZE,
                                               VOCABULARY_SIZE_DEFAULT)
        if vocabulary_size and vocabulary_size % TENSOR_CORE_ALIGN_SIZE != 0:
            logger.warning(
                "DeepSpeedConfig: vocabulary size {} is not aligned to {}, "
                "may impact tensor-core utilization.".format(
                    vocabulary_size, TENSOR_CORE_ALIGN_SIZE))
        if self.optimizer_params is not None and \
                MAX_GRAD_NORM in self.optimizer_params and \
                self.optimizer_params[MAX_GRAD_NORM] > 0 and \
                not (self.fp16_enabled or self.zero_enabled):
            logger.warning(
                "DeepSpeedConfig: In FP32 mode, DeepSpeed does not permit "
                "MAX_GRAD_NORM ({}) > 0, setting to zero".format(
                    self.optimizer_params[MAX_GRAD_NORM]))
            self.optimizer_params[MAX_GRAD_NORM] = 0.0

    def print(self, name):
        logger.info("{}:".format(name))
        for arg in sorted(vars(self)):
            if arg != "_param_dict":
                dots = "." * (29 - len(arg))
                logger.info("  {} {} {}".format(arg, dots, getattr(self, arg)))
