"""Paged attention for decode: the CUDA kernel, its wrapper and its plain
version.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py::paged_attention``.
Attention of ``s`` new queries per slot over the slot's keys in the paged
KV pool ``(pages + 1, layers, heads, page_size, d_head)``, read through
its page table. The cache writes for the same tokens must already have
landed (``models/gpt2.py::_paged_attn_ctx`` scatters them first, on the
same stream).

* :func:`paged_attention` validates its inputs, then on CUDA tensors
  launches the hand-written kernel ``csrc/paged_attention.cu`` on the
  current stream and adds one to ``paged_attention.launches``; on CPU
  tensors it returns :func:`paged_attention_reference`. A build or
  launch failure raises; nothing falls back.
* :func:`paged_attention_reference` is the plain PyTorch version:
  gather each slot's pages back into contiguous rows, then the shared
  masked attention ``models/gpt2.py::_attend_cache_rows`` — exactly the
  JAX package's ``xla`` read path.

Masking, in both: key ``k_pos`` counts for query ``q_pos = pos + j`` only
if ``k_pos <= q_pos``; V is zeroed past the live window ``pos +
valid_len - 1`` (the kernel never loads those rows at all), so stale or
NaN-poisoned recycled pages and the garbage page 0 never reach a sum.
"""
import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256


def build():
    """Compile the kernel library (reused when already built from this
    source); returns the :class:`cuda_build.BuildRecord`."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded kernel library with its C signatures declared; built
    and loaded once per process (a decode step launches 24 times)."""
    lib = cuda_build.load(SOURCE)
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pool, v_pool, page_tables, positions, valid_lens,
           layer_idx, page_size):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_tables": page_tables, "positions": positions,
               "valid_lens": valid_lens}
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError("paged_attention: unsupported device {}".format(
            device))
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError("paged_attention: {} is on {}, q on {}".format(
                name, t.device, device))
        if not t.is_contiguous():
            raise ValueError("paged_attention: {} must be contiguous".format(
                name))
    if q.dim() != 4 or k_pool.dim() != 5:
        raise ValueError(
            "paged_attention: q must be (b, s, h, dh) and the pools "
            "(pages, layers, h, page_size, dh); got {} and {}".format(
                tuple(q.shape), tuple(k_pool.shape)))
    b, s, h, dh = q.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError("paged_attention: k_pool {} != v_pool {}".format(
            tuple(k_pool.shape), tuple(v_pool.shape)))
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise ValueError(
            "paged_attention: q and the pools must share one of {}; got "
            "{}, {}, {}".format(sorted(str(d) for d in _DTYPE_CODES),
                                q.dtype, k_pool.dtype, v_pool.dtype))
    _, layers, ph, ps, pdh = k_pool.shape
    if (ph, pdh) != (h, dh) or ps != page_size:
        raise ValueError(
            "paged_attention: pool (h, page_size, dh) = {} does not match "
            "q's (h, dh) = {} and page_size {}".format(
                (ph, ps, pdh), (h, dh), page_size))
    if not 0 <= layer_idx < layers:
        raise ValueError("paged_attention: layer_idx {} outside [0, {})"
                         .format(layer_idx, layers))
    if page_tables.dim() != 2 or page_tables.shape[0] != b or \
            positions.shape != (b,) or valid_lens.shape != (b,):
        raise ValueError(
            "paged_attention: page_tables must be (b, max_pages) and "
            "positions/valid_lens (b,) for b = {}; got {}, {}, {}".format(
                b, tuple(page_tables.shape), tuple(positions.shape),
                tuple(valid_lens.shape)))
    for name in ("page_tables", "positions", "valid_lens"):
        if tensors[name].dtype != torch.int32:
            raise ValueError("paged_attention: {} must be int32, got {}"
                             .format(name, tensors[name].dtype))
    if device.type == "cuda":
        vec = 16 // q.element_size()
        if dh > _MAX_HEAD_DIM or dh % vec:
            raise ValueError(
                "paged_attention: the kernel takes d_head <= {} and a "
                "multiple of {} for {}; got {}".format(
                    _MAX_HEAD_DIM, vec, q.dtype, dh))
        for name in ("k_pool", "v_pool"):
            if tensors[name].data_ptr() % 16:
                raise ValueError("paged_attention: {} must be 16-byte "
                                 "aligned".format(name))


def paged_attention(q, k_pool, v_pool, page_tables, positions, valid_lens,
                    *, layer_idx, page_size):
    """Paged attention for ``s`` new queries per slot against the pool.

    ``q``: (b, s, h, dh); ``k_pool``/``v_pool``: (pages + 1, layers, h,
    page_size, dh), the same dtype as ``q`` (float32, bfloat16 or
    float16); ``page_tables``: (b, max_pages) int32; ``positions`` /
    ``valid_lens``: (b,) int32; all contiguous, on one device. Returns
    the fp32 context (b, s, h, dh), allocated here. On CUDA the kernel
    runs on the current stream, without a synchronise."""
    _check(q, k_pool, v_pool, page_tables, positions, valid_lens,
           layer_idx, page_size)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, page_tables, positions, valid_lens,
            layer_idx=layer_idx, page_size=page_size)
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), positions.data_ptr(), valid_lens.data_ptr(),
        out.data_ptr(), b, s, h, dh, page_size, page_tables.shape[1],
        k_pool.shape[1], layer_idx, 1.0 / math.sqrt(dh),
        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           "error {} ({})".format(
                               err, lib.paged_attention_error_string(err)
                               .decode()))
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_reference(q, k_pool, v_pool, page_tables, positions,
                              valid_lens, *, layer_idx, page_size):
    """The plain PyTorch version: gather every slot's pages into
    contiguous logical rows (b, h, max_pages * page_size, dh), then the
    shared masked attention of the slot layout. Any device."""
    from ...models.gpt2 import _attend_cache_rows
    b, _, h, dh = q.shape
    max_pages = page_tables.shape[1]
    index = page_tables.long()

    def rows_of(pool):
        # (P, h, ps, dh) --gather--> (b, max_pages, h, ps, dh)
        gathered = pool[:, layer_idx][index]
        return gathered.permute(0, 2, 1, 3, 4).reshape(
            b, h, max_pages * page_size, dh)

    return _attend_cache_rows(q, rows_of(k_pool), rows_of(v_pool),
                              positions, dh, valid_lens=valid_lens)
