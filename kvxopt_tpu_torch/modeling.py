"""Alias module: kvxopt_tpu_torch.modeling mirrors the reference's
kvxopt.modeling import path (src/python/modeling.py).  Copy of
kvxopt_tpu/modeling.py."""

from .models.modeling import (  # noqa: F401
    variable, affine, constraint, op, dot, sum, max, min, pwl,
    pwl_scalar)
