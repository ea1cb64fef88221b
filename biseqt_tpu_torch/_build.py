"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, in this package's git-ignored
``build/`` directory, on first use, and loads with ctypes.  No PyTorch
headers are involved, so a build takes seconds.  The library name
carries a hash of the source and the flags, so an edited source never
loads a stale build.  ``nvcc -Xptxas -v`` output (registers, shared
memory, spills per kernel) is kept beside each library as ``.log``.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["load", "check", "build_log", "so_path", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# --fmad=false: the DP's direction bits come from float EQUALITY tests
# and its drift constants are products; contracting a*b+c into one FMA
# would round differently from the plain PyTorch twin and the JAX
# reference, flipping ties.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LIBS = {}


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit (``CUDA_HOME``,
    default ``/usr/local/cuda``)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled on first use "
            "and need the CUDA toolkit")
    return nvcc


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.join(BUILD_DIR, "%s-%s" % (name, key.hexdigest()[:16]))
    return src, stem + ".so", stem + ".log"


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed;
    ``declare(lib)`` sets the ctypes signatures of its entry points
    once, when it is first loaded."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src, so, log = _paths(name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            with open(log, "w") as f:
                f.write(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on %s:\n%s"
                                   % (src, proc.stdout[-4000:]))
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(so)
    lib.bst_cuda_error_string.restype = ctypes.c_char_p
    lib.bst_cuda_error_string.argtypes = [ctypes.c_int]
    declare(lib)
    _LIBS[name] = lib
    return lib


def so_path(name: str) -> str:
    """The path of the current build of ``csrc/<name>.cu``."""
    return _paths(name)[1]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``) for the current build of ``name``."""
    _, _, log = _paths(name)
    with open(log) as f:
        return f.read()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, rc, lib.bst_cuda_error_string(rc).decode()))
