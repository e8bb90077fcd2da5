"""Build a host C++ source into a shared library and load it.

The counterpart of ``cuda_build.py`` for the ops that run on the host:
``g++`` (``$CXX`` when set) compiles one ``.cpp`` file that exposes a C
interface into a shared library, and ``ctypes`` loads it. Libraries land
in ``_build/`` next to this file (listed in ``.gitignore``), named by a
hash of the source bytes, the flags and the compiler's version, so an
edited source rebuilds and an unchanged one is reused. No
``-march=native``: one checkout's libraries may be loaded on another
host. ``-fopenmp`` is passed where the compiler can build and link an
OpenMP library with it (a toolchain without libgomp cannot; the
sources' ``#pragma omp`` loops then run on one thread), as the JAX
package's op builder probes it. A failed build raises with the
compiler's output; nothing falls back to another implementation.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .cuda_build import BUILD_DIR, BuildRecord

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
OPENMP_FLAG = "-fopenmp"


class HostBuildError(RuntimeError):
    """The C++ compiler is missing or refused a source."""


def compiler():
    """The C++ compiler to build with: ``$CXX``, else ``g++``."""
    name = os.environ.get("CXX", "g++")
    path = shutil.which(name)
    if path is None:
        raise HostBuildError(
            "C++ compiler {!r} not found on PATH: the host ops are "
            "compiled from source at first use".format(name))
    return path


def _compiler_version(cxx):
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return proc.stdout.splitlines()[0] if proc.stdout else cxx


@functools.lru_cache(maxsize=None)
def flags(cxx):
    """The flags ``cxx`` builds with: :data:`CXX_FLAGS`, and
    ``-fopenmp`` when a one-line OpenMP library builds and links with
    it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = BUILD_DIR / "openmp_probe.{}.{}".format(os.getpid(),
                                                   threading.get_ident())
    src, lib = stem.with_suffix(".cpp"), stem.with_suffix(".so")
    src.write_text("int openmp_probe() { return 0; }\n")
    try:
        ok = subprocess.run([cxx, *CXX_FLAGS, OPENMP_FLAG, "-o", str(lib),
                             str(src)], capture_output=True).returncode == 0
    finally:
        src.unlink(missing_ok=True)
        lib.unlink(missing_ok=True)
    return CXX_FLAGS + ((OPENMP_FLAG,) if ok else ())


def library_path(source, cxx):
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags(cxx)).encode() +
        _compiler_version(cxx).encode()).hexdigest()
    return BUILD_DIR / "{}_{}.so".format(source.stem, digest[:16])


def build(source):
    """Compile ``source`` unless a library built from the same bytes,
    flags and compiler exists. Returns a ``cuda_build.BuildRecord``;
    raises :class:`HostBuildError` with the compiler's output when the
    build fails."""
    source = Path(source)
    if not source.exists():
        raise HostBuildError("host op source {} is missing".format(source))
    cxx = compiler()
    out = library_path(source, cxx)
    if out.exists():
        return BuildRecord(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: concurrent builds of one
    # source never load a half-written library
    tmp = out.with_name("{}.{}.{}.tmp".format(
        out.name, os.getpid(), threading.get_ident()))
    cmd = [cxx, *flags(cxx), "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostBuildError("{} failed with exit code {}:\n{}\n{}{}".format(
            os.path.basename(cxx), proc.returncode, " ".join(cmd),
            proc.stdout, proc.stderr))
    os.replace(tmp, out)
    return BuildRecord(out, seconds,
                       " ".join(cmd) + "\n" + proc.stdout + proc.stderr)


def load(source):
    """``ctypes.CDLL`` of ``source``'s library, building it if needed."""
    return ctypes.CDLL(str(build(source).path))
