"""Gradient norm, clipping and overflow checks over flat buffers.

Port of ``deepspeed_tpu/runtime/utils.py`` (``get_grad_norm``,
``clip_grad_norm_``, ``CheckOverflow``). The JAX functions walk a grad
pytree; the port's engine keeps its gradients in one flat fp32 buffer, so
each function takes a tensor or a list of tensors and returns device
tensors (no host synchronisation).
"""
import math

import torch


def _tensors(grads):
    return [grads] if isinstance(grads, torch.Tensor) else list(grads)


def get_grad_norm(grads, norm_type=2.0):
    """The global ``norm_type`` norm over every tensor in ``grads``, an fp32
    0-dim device tensor."""
    ts = _tensors(grads)
    if not ts:
        return torch.zeros(())
    if math.isinf(norm_type):
        return torch.stack([t.float().abs().max() for t in ts]).max()
    total = sum(t.float().abs().pow(norm_type).sum() for t in ts)
    return total ** (1.0 / norm_type)


def clip_grad_norm_(grads, max_norm, norm_type=2.0, total_norm=None):
    """Scale ``grads`` IN PLACE so their global norm is <= ``max_norm``
    (coefficient ``min(max_norm / (norm + 1e-6), 1)``, as the JAX
    function). Returns the norm before clipping."""
    if total_norm is None:
        total_norm = get_grad_norm(grads, norm_type)
    coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    for t in _tensors(grads):
        t.mul_(coef.to(t.dtype))
    return total_norm


class CheckOverflow:
    """inf/nan detection (reference CheckOverflow); returns a bool device
    tensor."""

    @staticmethod
    def has_overflow(grads):
        ts = _tensors(grads)
        if not ts:
            return torch.zeros((), dtype=torch.bool)
        return torch.stack([~torch.isfinite(t).all() for t in ts]).any()


def count_parameters(module):
    return sum(p.numel() for p in module.parameters())
