"""deepspeed_tpu_torch.zero: the ZeRO namespace (the JAX package's
``deepspeed_tpu/zero.py``).

``zero.Init`` partitions a model's parameters as it is built;
``zero.GatheredParameters`` gathers them whole for a while;
``zero.register_external_parameter`` does nothing, as in the JAX
package; ``zero.stage3_persistence`` is the stage-3 plan's choice of the
leaves kept whole (the JAX ``ZeroShardingPlan``'s rule and live-budget
demotion, copied).
"""
from .runtime.zero.init_ctx import (GatheredParameters, Init,
                                    register_external_parameter)
from .runtime.zero.partition import stage3_persistence
