"""Fill-reducing ordering (reference src/C/amd.c: order(A, uplo='L') and
the amd.options dict).

Backed by the native approximate-minimum-degree implementation in
kvxopt_tpu_torch/native/host.cpp (amd_order: quotient graph, approximate
external degrees, element absorption, supervariable merging — the AMD
algorithm the reference links from SuiteSparse) operating on the
pattern of A + A'.  Set options['method'] = 'mindeg' for the exact
minimum-degree variant.  Copy of kvxopt_tpu/amd.py."""

import numpy as np

from .base import matrix
from ._sparse import canon_csc
from .native import lib

options = {}


def order_array(A, uplo="L"):
    """Permutation as a numpy int64 array."""
    import scipy.sparse as sp
    m, n, cp, ri, vx = canon_csc(A)
    if m != n:
        raise TypeError("A must be square")
    csc = sp.csc_matrix((np.ones(len(ri)), ri, cp), shape=(n, n))
    if uplo == "L":
        csc = sp.tril(csc).tocsc()
    elif uplo == "U":
        csc = sp.triu(csc).tocsc()
    full = (csc + csc.T).tocsc()
    full.sort_indices()
    perm = np.zeros(n, dtype=np.int64)
    fn = (lib.mindeg_order if options.get("method") == "mindeg"
          else lib.amd_order)
    fn(n, full.indptr.astype(np.int64), full.indices.astype(np.int64),
       perm)
    return perm


def order(A, uplo="L"):
    """Minimum-degree ordering of A: returns the permutation as an 'i'
    matrix (reference amd.c order)."""
    return matrix(order_array(A, uplo).reshape(-1, 1))
