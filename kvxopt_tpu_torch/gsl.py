"""Random matrix generators (reference src/C/gsl.c: normal / uniform /
weibull / setseed / getseed).

Counterpart of kvxopt_tpu/gsl.py.  The reference wraps GSL's Mersenne
generator and the JAX package jax.random; here every draw comes from one
torch.Generator on the CPU, in config.default_dtype, so a seed gives the
same numbers on every machine whatever its device.  `normal`, `uniform`
and `weibull` return dense `matrix` objects; the *_torch variants return
the same draws as tensors on config.default_device (the card unless the
caller names another).
"""

import torch

from . import config
from .base import matrix

_seed = 0
_gen = None  # made at the first draw or setseed


def setseed(value=0):
    """Set the RNG seed (reference gsl.c setseed)."""
    global _seed, _gen
    _seed = int(value)
    _gen = torch.Generator().manual_seed(_seed)


def getseed():
    """Return the current seed (reference gsl.c getseed)."""
    return _seed


def _generator():
    if _gen is None:
        setseed(_seed)
    return _gen


def _normal(nrows, ncols, mean, std):
    return mean + std * torch.randn((nrows, ncols), generator=_generator(),
                                    dtype=config.default_dtype)


def _uniform(nrows, ncols, a, b):
    u = torch.rand((nrows, ncols), generator=_generator(),
                   dtype=config.default_dtype)
    return a + (b - a) * u


def _weibull(nrows, ncols, a, b):
    # inverse-CDF sampling: X = b * (-log(1-U))^{1/a}
    u = torch.rand((nrows, ncols), generator=_generator(),
                   dtype=config.default_dtype)
    return b * (-torch.log1p(-u)) ** (1.0 / a)


def normal_torch(nrows, ncols=1, mean=0.0, std=1.0):
    """Like `normal` but returns a tensor on config.default_device
    (advances the module generator)."""
    return _normal(nrows, ncols, mean, std).to(config.default_device)


def uniform_torch(nrows, ncols=1, a=0.0, b=1.0):
    """Like `uniform` but returns a tensor on config.default_device
    (advances the module generator)."""
    return _uniform(nrows, ncols, a, b).to(config.default_device)


def weibull_torch(nrows, ncols=1, a=1.0, b=1.0):
    """Weibull(a, b) samples as a tensor on config.default_device
    (advances the module generator)."""
    return _weibull(nrows, ncols, a, b).to(config.default_device)


def normal(nrows, ncols=1, mean=0.0, std=1.0):
    """nrows-by-ncols matrix of N(mean, std^2) samples."""
    return matrix(_normal(nrows, ncols, mean, std).numpy())


def uniform(nrows, ncols=1, a=0.0, b=1.0):
    """nrows-by-ncols matrix of U[a, b) samples."""
    return matrix(_uniform(nrows, ncols, a, b).numpy())


def weibull(nrows, ncols=1, a=1.0, b=1.0):
    """nrows-by-ncols matrix of Weibull(a, b) samples."""
    return matrix(_weibull(nrows, ncols, a, b).numpy())
