from .fused_lamb import (FusedLamb, LambPlan, lamb_init, lamb_update,
                         fused_lamb, fused_lamb_apply, fused_lamb_reference,
                         fused_lamb_apply_reference, build)
