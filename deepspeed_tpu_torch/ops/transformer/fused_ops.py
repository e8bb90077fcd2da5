"""Elementwise transformer ops.

Port of ``deepspeed_tpu/ops/transformer/fused_ops.py``
(``fused_layer_norm``, ``fused_bias_gelu``,
``fused_bias_dropout_residual``). In the JAX package these
are compositions that XLA fuses; they are no Pallas kernels, so here
they are plain PyTorch with the same arithmetic: statistics and the
tanh GeLU in fp32, the result cast back to the input dtype.

Under autograd the GeLU is one ``torch.autograd.Function`` that saves
only its input ``x + bias`` (in the input dtype, which is exactly what
the fp32 math reads) and takes the derivative in fp32, instead of
keeping the composite's several fp32 intermediates alive until the
backward: at the GPT-2-350M training shape that is about 1 GB per layer.
"""
import torch

_GELU_C = 0.7978845608028654          # sqrt(2 / pi)
_GELU_A = 0.044715


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim; stats in fp32 for bf16/fp16 inputs."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _gelu(y):
    return 0.5 * y * (1.0 + torch.tanh(_GELU_C * (y + _GELU_A * y * y * y)))


class _BiasGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bias):
        xb = x + bias.to(x.dtype)
        ctx.save_for_backward(xb)
        ctx.bias_dtype = bias.dtype
        return _gelu(xb.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        (xb,) = ctx.saved_tensors
        y = xb.float()
        t = torch.tanh(_GELU_C * (y + _GELU_A * y * y * y))
        dy = 0.5 * (1.0 + t) + \
            0.5 * y * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * y * y)
        gx = (grad.float() * dy).to(xb.dtype)
        gb = gx.reshape(-1, gx.shape[-1]).sum(0).to(ctx.bias_dtype)
        return gx, gb


def fused_bias_gelu(x, bias):
    """x + bias then tanh-approx GeLU, evaluated in fp32."""
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return _BiasGelu.apply(x, bias)
    return _gelu((x + bias.to(x.dtype)).float()).to(x.dtype)


def fused_bias_dropout_residual(x, bias, residual, rate, generator,
                                train=True):
    """(x + bias) -> inverted dropout -> + residual. The keep mask is drawn
    from ``generator`` (a ``torch.Generator``, as ``jax.random.bernoulli``
    draws from its key); no dropout when not ``train``, at rate 0 or
    without a generator."""
    y = x + bias.to(x.dtype)
    if train and rate > 0.0 and generator is not None:
        keep = torch.rand(y.shape, generator=generator, device=y.device,
                          dtype=torch.float32) < (1.0 - rate)
        y = torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))
    return y + residual
