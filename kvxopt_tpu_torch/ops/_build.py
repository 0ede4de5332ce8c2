"""Build and load the port's CUDA kernels.

At first use each source in ``kvxopt_tpu_torch/csrc`` is compiled with
``nvcc`` for Hopper (sm_90a) into an object, one ``nvcc`` per source and
all started together, and the objects are linked into a shared library
with a plain C interface under ``kvxopt_tpu_torch/build/``, loaded with
ctypes.  The library's file name carries a hash of the sources, headers
and flags, so an edited source is rebuilt.  A missing ``nvcc`` or a
failed compile raises: there is no fallback.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _compile(nvcc, srcs, out):
    """One nvcc per source into objects, run in parallel, then one link."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        logs = []
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            logs.append(err)
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                raise RuntimeError(f"nvcc failed on {s.name}:\n"
                                   + err[-8000:])
        lib = Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + proc.stderr[-8000:])
        os.replace(lib, out)
    return "".join(logs)


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
        BUILD_INFO["log"] = _compile(_nvcc(), srcs, out)
    _LIB = ctypes.CDLL(str(out))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(out)
    return _LIB
