"""kvxopt_tpu_torch: the PyTorch/CUDA port of kvxopt_tpu.

Module paths and function names mirror kvxopt_tpu.  The package imports
torch and never jax; its CUDA kernels (csrc/) are built for Hopper at
first use (ops/_build.py), and its native host library (native/host.cpp:
orderings, sparse LDL' and LU) with g++ at first use (native/__init__.py).

The facade is kvxopt_tpu's (reference src/python/__init__.py):
matrix/spmatrix/sparse/spdiag, the elementwise math, the random
generators with seed control (normal, uniform, setseed, getseed; gsl.py),
min/max/mul/div and __version__.  The modeling layer is
kvxopt_tpu_torch.modeling.  Every module of kvxopt_tpu has its
counterpart here under the same path, among them the host facades blas,
lapack and fftw (numpy/scipy on the host, as in the JAX package), misc
and misc_solvers (the cone algebra and KKT factors on single vectors),
info and _version, and parallel's multi-device modules over
torch.distributed (make_mesh, spawn, sharded, arrow, dist_chol).
"""

import time as _time

_t0 = _time.perf_counter_ns()

import numpy as _np  # noqa: E402

from . import trace  # noqa: E402
from . import config  # noqa: E402,F401  (turns TF32 off first)
from . import cones, kkt, ops, parallel, solvers  # noqa: E402,F401
from .cones import ConeDims  # noqa: E402,F401
from .base import (  # noqa: E402,F401
    matrix, spmatrix, sparse, spdiag, fromfile,
    exp, log, sqrt, sin, cos, tan, asin, acos, atan, sinh, cosh, tanh,
    conj, emul, ediv, emin, emax, norm,
    gemv, gemm, syrk, symv, axpy)
from .gsl import normal, uniform, setseed, getseed  # noqa: E402,F401
from . import printing  # noqa: E402,F401
from ._version import __version__  # noqa: E402,F401

_pymin, _pymax = min, max


def min(*args):
    """Elementwise min of matrices/scalars; with a single matrix argument,
    the minimum element (reference __init__.py:203-302)."""
    if len(args) == 1:
        a = args[0]
        if isinstance(a, (matrix, spmatrix)):
            return float(_np.asarray(a).min())
        return _pymin(a)
    out = args[0]
    for b in args[1:]:
        out = emin(out, b)
    return out


def max(*args):
    """Elementwise max (see min)."""
    if len(args) == 1:
        a = args[0]
        if isinstance(a, (matrix, spmatrix)):
            return float(_np.asarray(a).max())
        return _pymax(a)
    out = args[0]
    for b in args[1:]:
        out = emax(out, b)
    return out


def mul(*args):
    """Elementwise product of the arguments (reference __init__.py mul)."""
    out = args[0]
    for b in args[1:]:
        out = emul(out, b)
    return out


def div(*args):
    """Elementwise division (reference __init__.py div)."""
    out = args[0]
    for b in args[1:]:
        out = ediv(out, b)
    return out


__all__ = [
    "matrix", "spmatrix", "sparse", "spdiag", "normal", "uniform",
    "setseed", "getseed", "exp", "log", "sqrt", "sin", "cos", "tan",
    "mul", "div", "min", "max", "norm", "ConeDims", "printing", "solvers",
]

trace.IMPORT_NS = (_t0, _time.perf_counter_ns())
