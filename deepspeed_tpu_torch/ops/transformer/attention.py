"""Attention dispatch: the CUDA flash kernels or the plain reference.

Port of ``deepspeed_tpu/ops/transformer/attention.py``
(``reference_causal_attention``, ``resolve_flash_backend``,
``causal_attention``). The backend names are the JAX package's:

* ``"xla"``: the plain dense reference (the numerics oracle);
* ``"pallas"``: the flash kernels (``flash_attention.py``) on CUDA
  tensors, and their plain tiled versions on CPU tensors, which stand
  where the JAX package runs its Pallas interpreter;
* ``"auto"`` resolves to ``"pallas"`` on a CUDA device and to ``"xla"``
  on the CPU, as the Adam and paged-attention settings do. The kernels
  are built for sm_90a: on another card their build or launch raises.
"""
import torch

NEG_INF = -1e30

FLASH_BACKEND_MODES = ("auto", "pallas", "xla")


def reference_causal_attention(q, k, v, sm_scale=None):
    """Plain attention, (b, s, h, d) layout, in fp32, the result cast to
    q's dtype: numerically the spec for the flash kernels."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    qf = q.float() * scale
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return ctx.to(q.dtype)


def resolve_flash_backend(requested, device):
    """The ``transformer.flash_attention`` tri-state resolved for
    ``device``: ``"pallas"`` (the kernels; on a CPU device their plain
    versions) or ``"xla"`` (the reference). ``"auto"`` takes the kernels
    exactly on a CUDA device."""
    if isinstance(requested, bool):
        requested = "auto" if requested else "xla"
    if requested not in FLASH_BACKEND_MODES:
        raise ValueError(
            "flash_attention backend {!r}: want a bool or one of {}".format(
                requested, FLASH_BACKEND_MODES))
    if requested != "auto":
        return requested
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def causal_attention(q, k, v, use_flash=True, sm_scale=None, backend=None):
    """(b, s, h, d) in, (b, s, h, d) out. ``backend``: a resolved
    ``"pallas"`` | ``"xla"``; None takes the flash path when ``use_flash``
    and the tensors are on CUDA."""
    if backend is None:
        backend = "pallas" if use_flash and q.device.type == "cuda" \
            else "xla"
    if backend == "xla":
        return reference_causal_attention(q, k, v, sm_scale)
    from .flash_attention import flash_attention_bshd
    return flash_attention_bshd(q, k, v, sm_scale, True)
