from .fused_adam import (FusedAdam, adam_init, adam_update, fused_adam,
                         fused_adam_reference, bias_corrections, build,
                         fma_f32)
