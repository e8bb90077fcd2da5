from .fused_ops import (fused_bias_dropout_residual, fused_bias_gelu,
                        fused_layer_norm)
from .flash_attention import (flash_fwd, flash_bwd_dkdv, flash_bwd_dq,
                              flash_bwd, flash_fwd_reference,
                              flash_bwd_dq_reference,
                              flash_bwd_dkdv_reference,
                              fused_ln_qkv_attention, flash_attention_bshd)
from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer, TransformerConfig,
                          init_transformer_params, transformer_layer_forward)
