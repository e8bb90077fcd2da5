"""Gradient norm, clipping and overflow checks over flat buffers, and the
pipeline's partition helpers.

Port of ``deepspeed_tpu/runtime/utils.py`` (``get_grad_norm``,
``clip_grad_norm_``, ``CheckOverflow``). The JAX functions walk a grad
pytree; the port's engine keeps its gradients in one flat fp32 buffer, so
each function takes a tensor or a list of tensors and returns device
tensors (no host synchronisation). ``partition_uniform``,
``partition_balanced`` and ``call_to_str`` are copies of the JAX
package's (plain Python, held equal to them by the tests).
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


def call_to_str(base, *args, **kwargs):
    """``name(arg1, arg2, kw=val)`` as a string (reference :24)."""
    name = "{}(".format(base)
    if args:
        name += ", ".join(str(arg) for arg in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join("{}={}".format(key, kwargs[key]) for key in kwargs)
    name += ")"
    return name


def partition_uniform(num_items, num_parts):
    """Boundaries of ``num_parts`` near-equal contiguous chunks of ``num_items``.

    Returns a list of length ``num_parts + 1``; part p owns
    ``[parts[p], parts[p+1])``. Matches reference semantics: uniform chunking
    with the remainder spread one-per-part from the front.
    """
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    residual = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunksize + (1 if p < residual else 0)
    return parts


def prefix_sum_inc(weights):
    """Inclusive prefix sum."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def _is_valid_partition(prefix, num_parts, bottleneck):
    """Greedy check: can weights (given by inclusive prefix sums) split into
    num_parts contiguous chunks each weighing <= bottleneck?"""
    parts_used = 0
    chunk_start = 0.0
    idx = 0
    n = len(prefix)
    while idx < n:
        if prefix[idx] - chunk_start > bottleneck:
            # weight idx starts a new chunk; a single item heavier than the
            # bottleneck makes the bottleneck infeasible
            prev = prefix[idx - 1] if idx > 0 else 0.0
            if prefix[idx] - prev > bottleneck:
                return False
            parts_used += 1
            chunk_start = prev
            if parts_used >= num_parts:
                return False
        else:
            idx += 1
    return parts_used + 1 <= num_parts


def partition_balanced(weights, num_parts, eps=1e-3):
    """Contiguous partition of ``weights`` into ``num_parts`` chunks minimizing
    the heaviest chunk (binary search on the bottleneck, reference :378)."""
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)

    prefix = prefix_sum_inc([float(w) for w in weights])
    total = prefix[-1]
    lower = max(total / num_parts, max(float(w) for w in weights) * (1 - eps))
    upper = total

    while upper - lower > eps * max(total, 1.0):
        mid = (lower + upper) / 2
        if _is_valid_partition(prefix, num_parts, mid):
            upper = mid
        else:
            lower = mid

    # Greedily materialize boundaries for the found bottleneck.
    bottleneck = upper * (1 + eps)
    parts = [0]
    chunk_start = 0.0
    for idx in range(num_items):
        if prefix[idx] - chunk_start > bottleneck and len(parts) < num_parts:
            parts.append(idx)
            chunk_start = prefix[idx - 1] if idx > 0 else 0.0
    while len(parts) < num_parts:
        parts.append(num_items)
    parts.append(num_items)
    # Ensure monotone boundaries covering all items.
    for i in range(1, len(parts)):
        parts[i] = max(parts[i], parts[i - 1])
    parts[-1] = num_items
    return parts
