"""Interior-point solvers (so far the batched cone-QP core)."""

from .coneprog import Options  # noqa: F401
