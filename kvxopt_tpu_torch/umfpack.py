"""General sparse LU (reference src/C/umfpack.c): linsolve, symbolic,
numeric, solve, get_numeric, get_det.

Same API contract as the reference's UMFPACK wrapper — opaque
symbolic/numeric factor objects, in-place multi-RHS solves with trans
'N'/'T'/'C', factor export satisfying P*R*A*Q = L*U, determinants
(get_det, the fork's addition, umfpack.c:671) — implemented on the native
left-looking LU in kvxopt_tpu_torch/native/host.cpp.  Rows are scaled by the
sum of their absolute values before factoring (UMFPACK's default
row scaling); R = diag(1/s) is exported from get_numeric.  Copy of
kvxopt_tpu/umfpack.py."""

import numpy as np

from .base import matrix, spmatrix
from ._sparse import perm_spmatrix
from ._sparse.lu import SymbolicLU, NumericLU


def symbolic(A):
    """Symbolic analysis of a square sparse matrix (umfpack.c:232)."""
    return SymbolicLU(A)


def numeric(A, Fs):
    """Numeric factorization using a prior symbolic object
    (umfpack.c:292).  Raises ArithmeticError on singular matrices."""
    return NumericLU(A, Fs, row_scale="sum")


def _solve_into(B, Fn, trans):
    if not isinstance(B, matrix):
        raise TypeError("B must be a dense matrix")
    arr = np.asarray(B)
    out = Fn.solve_inplace(arr, trans)
    if np.iscomplexobj(out) and B.typecode != "z":
        raise TypeError("complex factor requires a complex B")
    B._a = np.asfortranarray(out.astype(B._a.dtype))


def solve(A, Fn, B, trans="N"):
    """Solve A X = B (or A^T/A^H X = B) in place using a numeric factor
    (umfpack.c:559)."""
    _solve_into(B, Fn, trans)


def linsolve(A, B, trans="N"):
    """One-shot factor + solve, overwriting B (umfpack.c:78)."""
    Fs = symbolic(A)
    Fn = numeric(A, Fs)
    _solve_into(B, Fn, trans)


def get_numeric(A, Fn):
    """Export factors (L, U, P, Q, R) with P*R*A*Q = L*U
    (umfpack.c:369).  R = diag(1/s) with s the per-row sum-abs scale
    factors, indexed by original row (R applied before P, as in the
    reference's identity)."""
    L, U, p, q = Fn.get_factors()
    n = Fn.n
    Lsp = spmatrix._from_csc(L)
    Usp = spmatrix._from_csc(U)
    # P A Q = L U where row k of the product is row p[k] of A:
    # P = perm matrix with (P x)[k] = x[p[k]]
    P = perm_spmatrix(p)
    Q = perm_spmatrix(q).T
    rdiag = np.ones(n) if Fn.s is None else 1.0 / Fn.s
    R = spmatrix(rdiag, np.arange(n), np.arange(n), size=(n, n))
    return Lsp, Usp, P, Q, R


def get_det(A, Fs, Fn):
    """Determinant from the LU factors (umfpack.c:671, fork extra)."""
    return Fn.det()
