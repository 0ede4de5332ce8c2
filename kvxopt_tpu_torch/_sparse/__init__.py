"""Sparse subsystem: host-side CSC canonicalization and the symbolic /
numeric factorization objects shared by the amd/umfpack/klu/cholmod API
modules (copy of kvxopt_tpu/_sparse)."""

import numpy as np
import scipy.sparse as _sp


def canon_csc(A, dtype=None):
    """Return (n_rows, n_cols, colptr[int64], rowind[int64], values) from an
    spmatrix / scipy sparse / dense array."""
    from ..base import spmatrix as _spmatrix
    if isinstance(A, _spmatrix):
        csc = A.to_scipy()
    elif _sp.issparse(A):
        csc = A.tocsc()
    else:
        csc = _sp.csc_matrix(np.asarray(A))
    csc.sort_indices()
    vals = csc.data
    if dtype is not None:
        vals = vals.astype(dtype)
    elif vals.dtype.kind == "c":
        vals = vals.astype(np.complex128)
    else:
        vals = vals.astype(np.float64)
    return (csc.shape[0], csc.shape[1],
            csc.indptr.astype(np.int64), csc.indices.astype(np.int64),
            np.ascontiguousarray(vals))


def perm_spmatrix(p):
    """Permutation matrix P (as spmatrix) with (P x)[k] = x[p[k]]."""
    from ..base import spmatrix as _spmatrix
    n = len(p)
    return _spmatrix(np.ones(n), np.arange(n), np.asarray(p, dtype=np.int64),
                     size=(n, n))
