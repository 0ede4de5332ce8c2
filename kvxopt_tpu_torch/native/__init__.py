"""ctypes loader for the native host library (built from host.cpp, a copy
of kvxopt_tpu/native/host.cpp): AMD and minimum-degree ordering, the
simplicial LDL' and LDL^H, and the left-looking sparse LU.

`lib` is a lazy handle: the first attribute read compiles host.cpp with
g++ into ``kvxopt_tpu_torch/build/`` (the file name carries a hash of the
source and the flags, so an edited source is rebuilt), loads it and
declares every function's argument and result types.  Importing this
module compiles nothing.  A missing g++ or a failed compile raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "host.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

c_i64 = ctypes.c_longlong
c_i64_p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
c_f64_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
c_c128_p = np.ctypeslib.ndpointer(np.complex128, flags="C_CONTIGUOUS")
c_void = ctypes.c_void_p


def _gxx():
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native host library of "
                           "kvxopt_tpu_torch cannot be built")
    return path


def _build():
    """Path of the built library, compiling it first where it is missing."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = BUILD_DIR / f"libkvxhost_{h.hexdigest()[:16]}.so"
    if not out.exists():
        gxx = _gxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = Path(tmp) / "lib.so"
            proc = subprocess.run([gxx, *FLAGS, "-o", str(so), str(_SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("g++ failed on host.cpp:\n"
                                   + proc.stderr[-8000:])
            os.replace(so, out)
    return out


def _declare(lib):
    lib.mindeg_order.argtypes = [c_i64, c_i64_p, c_i64_p, c_i64_p]
    lib.amd_order.argtypes = [c_i64, c_i64_p, c_i64_p, c_i64_p]
    for sfx, vp in (("", c_f64_p), ("_z", c_c128_p)):
        f = getattr(lib, f"ldl_factor{sfx}")
        f.restype = c_void
        f.argtypes = [c_i64, c_i64_p, c_i64_p, vp, ctypes.POINTER(c_i64)]
        f = getattr(lib, f"ldl_refactor{sfx}")
        f.restype = c_i64
        f.argtypes = [c_void, c_i64, c_i64_p, c_i64_p, vp]
        getattr(lib, f"ldl_free{sfx}").argtypes = [c_void]
        f = getattr(lib, f"ldl_lnnz{sfx}")
        f.restype = c_i64
        f.argtypes = [c_void]
        getattr(lib, f"ldl_get{sfx}").argtypes = [c_void, c_i64_p, c_i64_p,
                                                  vp, c_f64_p]
        getattr(lib, f"ldl_solve{sfx}").argtypes = [c_void, vp, c_i64, c_i64]
        getattr(lib, f"ldl_diag{sfx}").argtypes = [c_void, c_f64_p]
    for sfx, vp in (("d", c_f64_p), ("z", c_c128_p)):
        f = getattr(lib, f"lu_factor_{sfx}")
        f.restype = c_void
        f.argtypes = [c_i64, c_i64_p, c_i64_p, vp, c_i64_p,
                      ctypes.POINTER(c_i64), ctypes.c_double]
        f = getattr(lib, f"lu_refactor_{sfx}")
        f.restype = c_i64
        f.argtypes = [c_void, c_i64, c_i64_p, c_i64_p, vp]
        getattr(lib, f"lu_solve_{sfx}").argtypes = [c_void, vp, c_i64, c_i64]
        getattr(lib, f"lu_det_{sfx}").argtypes = [c_void, vp]
        getattr(lib, f"lu_logdet_{sfx}").argtypes = [
            c_void, ctypes.POINTER(ctypes.c_double), vp]
        getattr(lib, f"lu_sizes_{sfx}").argtypes = [
            c_void, ctypes.POINTER(c_i64), ctypes.POINTER(c_i64)]
        getattr(lib, f"lu_get_{sfx}").argtypes = [
            c_void, c_i64_p, c_i64_p, vp, c_i64_p, c_i64_p, vp, c_i64_p,
            c_i64_p]
        f = getattr(lib, f"lu_singular_{sfx}")
        f.restype = c_i64
        f.argtypes = [c_void]
        getattr(lib, f"lu_free_{sfx}").argtypes = [c_void]


class _Lazy:
    """The loaded library, built and typed at the first attribute read."""

    _cdll = None

    def __getattr__(self, name):
        if _Lazy._cdll is None:
            cdll = ctypes.CDLL(str(_build()))
            _declare(cdll)
            _Lazy._cdll = cdll
        return getattr(_Lazy._cdll, name)


lib = _Lazy()
