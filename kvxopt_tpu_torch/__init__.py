"""kvxopt_tpu_torch: the PyTorch/CUDA port of kvxopt_tpu.

Module paths and function names mirror kvxopt_tpu.  The package imports
torch and never jax; its CUDA kernels (csrc/) are built for Hopper at
first use (ops/_build.py).
"""

from . import config  # noqa: F401  (turns TF32 off first)
from . import cones, kkt, ops, parallel, solvers  # noqa: F401
from .cones import ConeDims  # noqa: F401
