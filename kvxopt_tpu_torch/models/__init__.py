"""Modeling layer: the PWL DSL and MPS I/O (copy of
kvxopt_tpu/models/__init__.py)."""

from .modeling import (  # noqa: F401
    variable, affine, constraint, op, dot, sum, max, min, pwl)
