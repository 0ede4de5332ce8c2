"""The hot cone kernels under the reference's C-module name (reference
src/C/misc_solvers.c table :1156-1171: scale, scale2, pack, pack2,
unpack, symm, sdot, snrm2, sprod, sinv, max_step, trisc/triusc).

Counterpart of kvxopt_tpu/misc_solvers.py: it re-exports the port's
misc (batched torch on the data's device) with the C module's names, so
`from kvxopt_tpu_torch import misc_solvers` is a drop-in for
`from kvxopt import misc_solvers`.  trisc and triusc are copies of the
JAX module's numpy functions."""

from .misc import (  # noqa: F401
    scale, scale2, pack, pack2, unpack, symm, sdot, snrm2, sprod, sinv,
    max_step, compute_scaling, update_scaling)

import numpy as _np


def trisc(x, dims, offset=0):
    """Zero the strict upper triangles of the 's' blocks and scale the
    strict lower by 2 (reference misc_solvers.c trisc)."""
    from .cones import ConeDims
    d = ConeDims.from_dict(dims)
    x = _np.asarray(x).copy()
    for ofs, m in zip(d.sofs, d.s):
        X = x[offset + ofs:offset + ofs + m * m].reshape(m, m)
        X2 = 2.0 * _np.tril(X, -1) + _np.diag(_np.diagonal(X))
        x[offset + ofs:offset + ofs + m * m] = X2.reshape(-1)
    return x


def triusc(x, dims, offset=0):
    """Inverse-ish of trisc: halve the strict lower triangles
    (reference misc_solvers.c triusc)."""
    from .cones import ConeDims
    d = ConeDims.from_dict(dims)
    x = _np.asarray(x).copy()
    for ofs, m in zip(d.sofs, d.s):
        X = x[offset + ofs:offset + ofs + m * m].reshape(m, m)
        X2 = 0.5 * _np.tril(X, -1) + _np.triu(X)
        x[offset + ofs:offset + ofs + m * m] = X2.reshape(-1)
    return x
