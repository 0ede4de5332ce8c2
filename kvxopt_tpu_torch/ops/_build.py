"""Build and load the port's CUDA kernels.

At first use each source in ``kvxopt_tpu_torch/csrc`` is compiled with
``nvcc`` for Hopper (sm_90a) into an object, one ``nvcc`` per source and
all started together, and the objects are linked into a shared library
with a plain C interface under ``kvxopt_tpu_torch/build/``, loaded with
ctypes.  The library's file name carries a hash of the sources, headers
and flags, so an edited source is rebuilt.  A missing ``nvcc`` or a
failed compile raises: there is no fallback.

Beside the build, what every kernel wrapper shares: the table of C entry
points, typed once at load (_lib), the current stream, the check of a
returned CUDA error code, the device check that sends CPU tensors to the
plain versions, the card's SM count, and the launch count.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO = {"seconds": None, "path": None, "log": ""}

# The argument types of the library's C entry points; each returns a CUDA
# error code (int), except K6's occupancy query, which returns a count, or
# minus the error code.
_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DB = ctypes.c_double
_ARGTYPES = {
    "kvx_chol_ls": [_VP, _VP, _VP, _CI, _CI, _CI, _VP],              # K1
    "kvx_chol_solve": [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _LL, _LL,
                       _CI, _VP],                                   # K2
    "kvx_tri": [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _LL, _LL, _CI, _CI,
                _VP],                                               # K3
    "kvx_chol": [_VP, _VP, _VP, _CI, _CI, _CI, _VP],                 # K4
    "kvx_chol_solve64": [_VP, _VP, _VP, _CI, _CI, _CI, _LL, _LL, _LL,
                         _CI, _CI, _CI, _CI, _VP],                  # K5
    "kvx_chol64": [_VP, _VP, _CI, _CI, _CI, _VP],                    # K6
    "kvx_chol64_clusters": [_CI],
    "kvx_gram64": [_VP, _LL, _CI, _VP, _VP, _VP, _LL, _DB, _VP, _CI, _CI,
                   _CI, _CI, _VP],                                  # K7
}

# Kernel launches per kernel, counted by each wrapper where it launches
# its kernel, and the same launches by (kernel, n, k): n the matrix
# order, k the right-hand sides (0 for a factor).
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0,
            "K7": 0}
LAUNCH_SHAPES = collections.Counter()


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
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _CI
    _LIB = lib
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(out)
    return _LIB


def _lib():
    return _LIB if _LIB is not None else load_library()


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _on_cpu(*ts):
    """True where every tensor is on the CPU (the plain versions), False
    where every one is on a CUDA device (the kernels); else raises."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {devs}")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_launch(kernel, n, k=0):
    LAUNCHES[kernel] += 1
    LAUNCH_SHAPES[(kernel, n, k)] += 1


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()
