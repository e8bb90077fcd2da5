"""Elementwise transformer ops.

Port of ``deepspeed_tpu/ops/transformer/fused_ops.py``
(``fused_layer_norm``, ``fused_bias_gelu``). In the JAX package these
are compositions that XLA fuses; they are no Pallas kernels, so here
they are plain PyTorch with the same arithmetic: statistics and the
tanh GeLU in fp32, the result cast back to the input dtype.
"""
import torch


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim; stats in fp32 for bf16/fp16 inputs."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_bias_gelu(x, bias):
    """x + bias then tanh-approx GeLU, evaluated in fp32."""
    y = (x + bias.to(x.dtype)).float()
    out = 0.5 * y * (1.0 + torch.tanh(0.7978845608028654 *
                                      (y + 0.044715 * y * y * y)))
    return out.to(x.dtype)
