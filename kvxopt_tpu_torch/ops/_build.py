"""Build and load the port's CUDA kernels.

At first use the sources in ``kvxopt_tpu_torch/csrc`` are compiled with
``nvcc`` for Hopper (sm_90a) into a shared library with a plain C
interface, under ``kvxopt_tpu_torch/build/``, and loaded with ctypes.
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt.  A missing ``nvcc`` or a failed compile
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO = {"seconds": None, "path": None, "log": ""}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "kvxopt_tpu_torch cannot be built")
    return path


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def load_library():
    """The loaded kernel library, building it first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs, digest = _sources()
    out = BUILD_DIR / f"libkvx_kernels_{digest}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *FLAGS, "-o", tmp, *map(str, srcs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + proc.stderr[-8000:])
            BUILD_INFO["log"] = proc.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _LIB = ctypes.CDLL(str(out))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(out)
    return _LIB
