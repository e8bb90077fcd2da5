"""Build a CUDA C++ kernel source into a shared library and load it.

The port's kernels take the plain route: ``nvcc`` compiles each ``.cu``
file, which exposes a C interface, into its own shared library for
Hopper (``sm_90a``), and ``ctypes`` loads it. No PyTorch header is
compiled, so a build takes seconds. Libraries land in ``_build/`` next
to this file (listed in ``.gitignore``), named by a hash of the source
bytes and the flags, so an edited source rebuilds and an unchanged one
is reused. Sources may include the shared headers of ``include/`` next
to this file (``#include "sm90_mma.cuh"``); their bytes are part of every
library's hash. A failed build raises with the compiler's output; nothing
falls back to another implementation.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class BuildRecord:
    """What one :func:`build` call produced: the library path, the
    compile seconds (0.0 when an existing library was reused) and the
    compiler's report (``-Xptxas=-v``: registers, shared memory and
    spills per kernel)."""

    def __init__(self, path, seconds, log):
        self.path, self.seconds, self.log = path, seconds, log


def nvcc_path():
    """The ``nvcc`` to build with: the one on ``PATH``, else the CUDA
    toolkit's under ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError(
        "nvcc not found on PATH or under {}: the CUDA kernels are "
        "compiled from source at first use and need the CUDA "
        "toolkit".format(home))


def library_path(source):
    source = Path(source)
    headers = b"".join(h.read_bytes()
                       for h in sorted(INCLUDE_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers +
        " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / "{}_{}.so".format(source.stem, digest[:16])


def build(source):
    """Compile ``source`` unless a library built from the same bytes
    exists. Returns a :class:`BuildRecord`; raises
    :class:`KernelBuildError` with nvcc's stderr when the build fails."""
    out = library_path(source)
    if out.exists():
        return BuildRecord(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: concurrent builds of one
    # source never load a half-written library
    tmp = out.with_name("{}.{}.{}.tmp".format(
        out.name, os.getpid(), threading.get_ident()))
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
           str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("nvcc failed with exit code {}:\n{}\n{}{}"
                               .format(proc.returncode, " ".join(cmd),
                                       proc.stdout, proc.stderr))
    os.replace(tmp, out)
    return BuildRecord(out, seconds, proc.stdout + proc.stderr)


def load(source):
    """``ctypes.CDLL`` of ``source``'s library, building it if needed."""
    return ctypes.CDLL(str(build(source).path))
