"""The native data-IO op: the repo's ``csrc/ds_dataio.cpp`` (mmap'd
indexed token dataset, OpenMP gather, double-buffered prefetch thread)
built with ``host_build.py`` and bound with ``ctypes``.

Port of ``deepspeed_tpu/ops/op_builder/dataio.py``: the same C interface
and argument types. The source is built as it stands in the checkout's
``csrc/``; a missing source, a failed build or a failed load raises.
"""
import ctypes
import functools
from pathlib import Path

from . import host_build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ds_dataio.cpp"

# (name, restype, argtypes) of the ds_dataio_* C interface
SIGNATURES = [
    ("ds_dataio_open", ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p]),
    ("ds_dataio_num_docs", ctypes.c_int64, [ctypes.c_void_p]),
    ("ds_dataio_num_tokens", ctypes.c_int64, [ctypes.c_void_p]),
    ("ds_dataio_doc_len", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64]),
    ("ds_dataio_get_doc", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]),
    ("ds_dataio_batch", None,
     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_void_p]),
    ("ds_dataio_start_prefetch", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]),
    ("ds_dataio_next", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    ("ds_dataio_stop", None, [ctypes.c_void_p]),
    ("ds_dataio_close", None, [ctypes.c_void_p]),
]


def build(source=SOURCE):
    """Compile the op (reused when already built from these bytes);
    returns the ``cuda_build.BuildRecord``."""
    return host_build.build(source)


def bind(lib):
    """Declare the C signatures on a loaded library; returns it."""
    for name, restype, argtypes in SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def load(source=SOURCE):
    """The loaded, bound library; built and loaded once per process."""
    return bind(host_build.load(source))
