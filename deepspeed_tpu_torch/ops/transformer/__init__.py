from .fused_ops import fused_bias_gelu, fused_layer_norm
