"""KLU-style sparse LU with fast refactorization (reference src/C/klu.c,
the fork's flagship module): linsolve, symbolic, numeric, solve,
get_numeric, get_det.

The key feature mirrored from the reference: `numeric(A, Fs, N=None)` with
a prior numeric object N reuses its pattern and pivot sequence and only
recomputes values (klu_refactor), falling back to a full factorization on
numerical failure (klu.c:296-302) — the workhorse for repeated solves with
fixed sparsity (power-flow Jacobians etc.).

Like the reference, the pipeline is the full KLU one: maximum
transversal + strongly-connected components put A into block upper
triangular form (BTF), each diagonal block factors independently, and
off-diagonal entries land in F.  Rows are scaled by their max-abs value
(KLU's default scale mode) before factoring.  The factor identity
(klu.c:382) holds exactly: R*P*A*Q = L*U + F with R = diag(1/s[p]) and
r the block boundaries.  Copy of kvxopt_tpu/klu.py."""

import numpy as np

from .base import matrix, spmatrix
from ._sparse import perm_spmatrix
from ._sparse.btf import BTFSymbolic, BTFNumeric

options = {}


def symbolic(A):
    """Symbolic analysis: BTF permutations + per-block orderings
    (klu.c:234)."""
    return BTFSymbolic(A)


def numeric(A, Fs, N=None):
    """Numeric factorization; with N given, attempt fast per-block
    refactorization reusing N's patterns and pivots, with automatic
    fallback to full factorization (klu.c:296-302)."""
    return BTFNumeric(A, Fs, refactor_from=N)


def _solve_into(B, Fn, trans):
    if not isinstance(B, matrix):
        raise TypeError("B must be a dense matrix")
    arr = np.asarray(B)
    out = Fn.solve_inplace(arr, trans)
    B._a = np.asfortranarray(out.reshape(B._a.shape).astype(B._a.dtype))


def solve(A, Fs, Fn, B, trans="N"):
    """In-place solve with existing factors (klu.c:569)."""
    _solve_into(B, Fn, trans)


def linsolve(A, B, trans="N"):
    """One-shot factor + solve (klu.c:74)."""
    Fs = symbolic(A)
    Fn = numeric(A, Fs)
    _solve_into(B, Fn, trans)


def get_numeric(A, Fs, Fn):
    """Export factors (L, U, P, Q, R, F, r) with R*P*A*Q = L*U + F
    (klu.c:382).  R = diag(1/s[p]) is the row scaling over permuted rows
    (R applied after P, as in the reference's identity); r holds the BTF
    block boundaries."""
    L, U, p, q, F, r = Fn.get_factors()
    n = Fn.n
    P = perm_spmatrix(p)
    Q = perm_spmatrix(q).T
    R = spmatrix(1.0 / Fn.s[p], np.arange(n), np.arange(n), size=(n, n))
    Fsp = spmatrix._from_csc(F)
    return (spmatrix._from_csc(L), spmatrix._from_csc(U), P, Q, R, Fsp,
            matrix(np.asarray(r, dtype=np.int64).reshape(-1, 1)))


def get_det(A, Fs, Fn):
    """Determinant (klu.c:693, fork extra)."""
    return Fn.det()
