"""ZeRO sub-config parser.

Port of ``deepspeed_tpu/runtime/zero/config.py``: the same keys,
defaults and deprecated boolean form. The port runs stages 0-3 over
flat buffers partitioned over the data group
(``runtime/zero/partition.py``; stage 3 gathers each unit of the
compute-dtype parameters around its use, ``runtime/zero/stage3.py``) and
ZeRO-Offload (``cpu_offload``: the fp32 master and moments in host memory
and the host Adam, ``runtime/zero/offload.py``) and streamed parameter
offload (``cpu_offload_params``, ``runtime/zero/stream.py``; the engine
refuses it below stage 3, as the JAX engine does); ``sub_group_size``,
``stage3_max_live_parameters``, ``stage3_prefetch_bucket_size`` and
``stage3_param_persistence_threshold`` are live, and the engine warns on
(or under ``strict`` refuses) ``stage3_max_reuse_distance`` and
``cpu_offload_use_pin_memory``. The ZeRO++ keys
(``zero_quantized_weights``, ``zero_hierarchical_partition``,
``zero_quantized_gradients``) are live: the engine resolves them as the
JAX engine's ``_configure_zero`` does (``runtime/zero/zeropp.py``). The
bucket, overlap and contiguity keys (``reduce_bucket_size``,
``allgather_bucket_size``, ``overlap_comm``, ``reduce_scatter``,
``allgather_partitions``, ``contiguous_gradients``) are parsed and
satisfied by the design, as in the JAX engine: the gradients and the
state are contiguous flat buffers, stage 2 reduce-scatters each
micro-step's whole gradient buffer in one collective and the updated
ranges come back in one all-gather; there is no bucket to size.
"""
from ..config_utils import get_scalar_param
from .constants import *  # noqa: F401,F403
from ...utils.logging import logger

class DeepSpeedZeroConfig(object):
    def __init__(self, param_dict):
        if ZERO_OPTIMIZATION in param_dict:
            zero_config_dict = param_dict[ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                zero_config_dict = self.read_zero_config_deprecated(param_dict)
        else:
            zero_config_dict = {}
        self._initialize(zero_config_dict)

    def read_zero_config_deprecated(self, param_dict):
        zero_config_dict = {
            ZERO_OPTIMIZATION_STAGE:
                1 if param_dict[ZERO_OPTIMIZATION] else 0
        }
        if zero_config_dict[ZERO_OPTIMIZATION_STAGE] > 0:
            zero_config_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE] = \
                get_scalar_param(
                    param_dict,
                    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        logger.warning(
            "DeepSpeedConfig: this format of ZeRO optimization setup is "
            "deprecated. Please use the following format: {}".format(
                ZERO_FORMAT))
        return zero_config_dict

    def _initialize(self, zero_config_dict):
        g = lambda key, default: get_scalar_param(zero_config_dict, key,
                                                  default)
        self.stage = g(ZERO_OPTIMIZATION_STAGE,
                       ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.contiguous_gradients = g(
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = g(ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                                    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT)
        self.reduce_scatter = g(ZERO_OPTIMIZATION_REDUCE_SCATTER,
                                ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = g(ZERO_OPTIMIZATION_OVERLAP_COMM,
                              ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)
        self.allgather_partitions = g(
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = g(
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.cpu_offload = g(ZERO_OPTIMIZATION_CPU_OFFLOAD,
                             ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.cpu_offload_params = g(
            ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS,
            ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT)
        self.cpu_offload_use_pin_memory = g(
            ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY,
            ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY_DEFAULT)
        self.sub_group_size = g(ZERO_OPTIMIZATION_SUB_GROUP_SIZE,
                                ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT)
        self.max_live_parameters = g(
            ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS,
            ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT)
        self.max_reuse_distance = g(
            ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE,
            ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT)
        self.prefetch_bucket_size = g(
            ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE,
            ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT)
        self.param_persistence_threshold = g(
            ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD,
            zero_config_dict.get(
                "param_persistence_threshold",
                ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT))
        self.gather_fp16_weights_on_model_save = g(
            ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE,
            ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT)
        self.elastic_checkpoint = g(ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                                    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT)
        self.load_from_fp32_weights = g(
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT)
        self.quantized_weights = bool(g(
            ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS,
            ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS_DEFAULT))
        hpz = g(ZERO_OPTIMIZATION_HIERARCHICAL_PARTITION,
                ZERO_OPTIMIZATION_HIERARCHICAL_PARTITION_DEFAULT)
        if isinstance(hpz, bool) or not isinstance(hpz, int) or hpz < 0:
            raise ValueError(
                "zero_optimization.{} must be an int >= 0 (the secondary "
                "partition size; 0/1 disables), got {!r}".format(
                    ZERO_OPTIMIZATION_HIERARCHICAL_PARTITION, hpz))
        self.hierarchical_partition = hpz
        self.quantized_gradients = bool(g(
            ZERO_OPTIMIZATION_QUANTIZED_GRADIENTS,
            ZERO_OPTIMIZATION_QUANTIZED_GRADIENTS_DEFAULT))
        self.strict = bool(g(ZERO_OPTIMIZATION_STRICT,
                             ZERO_OPTIMIZATION_STRICT_DEFAULT))

    def repr(self):
        return self.__dict__

    def __repr__(self):
        import json
        return json.dumps(self.__dict__, indent=4, sort_keys=True)
