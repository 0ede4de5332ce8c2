"""BLAS-style operations on dense matrices (reference src/C/blas.c, 34
routines, table blas.c:3840-3873).

Same calling conventions as the reference: operations are IN PLACE on
`matrix` objects, with the BLAS-level m/n/k, ld*, inc* and offset*
arguments exposed (the reference's IPM layer addresses cone blocks through
these, e.g. blas.c:882).  Implemented over numpy strided views of the
column-major buffers, so offset/ld/inc semantics are exact; the heavy
lifting (gemm etc.) is numpy's BLAS on the host, by design: device-side
compute in this package goes through torch on the card (kvxopt_tpu_torch.kkt
/ solvers), never through this facade, and no solver calls it.

Supported typecodes: 'd' and 'z' (like the reference).

Copy of kvxopt_tpu/blas.py: numpy on the host, over the port's
base.matrix."""

import numpy as np

from .base import matrix

__all__ = ["swap", "scal", "copy", "axpy", "dot", "dotu", "nrm2", "asum",
           "iamax", "gemv", "gbmv", "symv", "hemv", "sbmv", "hbmv",
           "trmv", "tbmv", "trsv", "tbsv", "ger", "geru", "syr", "her",
           "syr2", "her2", "gemm", "symm", "hemm", "syrk", "herk",
           "syr2k", "her2k", "trmm", "trsm"]


def _flat(x):
    if not isinstance(x, matrix):
        raise TypeError("arguments must be dense matrices")
    return x._a.reshape(-1, order="F")


def _vec(x, n=None, inc=1, offset=0):
    f = _flat(x)
    if n is None:
        n = (len(f) - offset - 1) // abs(inc) + 1 if len(f) > offset else 0
    idx = offset + inc * np.arange(n)
    return f, idx


def _mat(A, m, n, ld, offset):
    """Column-major (m x n) strided view at `offset` with leading dim ld."""
    f = _flat(A)
    if ld is None:
        ld = A.size[0]
    if m is None:
        m = A.size[0]
    if n is None:
        n = A.size[1]
    itemsize = f.dtype.itemsize
    if m == 0 or n == 0:
        return np.zeros((m, n), dtype=f.dtype), ld
    need = offset + (n - 1) * ld + m
    if need > len(f):
        raise ValueError("buffer too small for given dimensions")
    view = np.lib.stride_tricks.as_strided(
        f[offset:], shape=(m, n), strides=(itemsize, ld * itemsize))
    return view, ld


def _op(Av, trans):
    if trans in ("T",):
        return Av.T
    if trans in ("C",):
        return Av.conj().T
    return Av


def _sym(Av, uplo, her=False):
    # Hermitian handling is exact per-type: real input stays real
    # end-to-end (reference blas.c:882 arg handling dispatches 'd'
    # inputs to dsymv, never building complex intermediates).
    her = her and Av.dtype.kind == "c"
    if uplo == "L":
        F = np.tril(Av) + np.tril(Av, -1).T
        if her:
            F = np.tril(Av) + np.tril(Av, -1).conj().T
    else:
        F = np.triu(Av) + np.triu(Av, 1).T
        if her:
            F = np.triu(Av) + np.triu(Av, 1).conj().T
    if her:
        F = F - 1j * np.imag(np.diag(np.diag(Av)))
    return F


def _tri(Av, uplo, diag):
    T = np.tril(Av) if uplo == "L" else np.triu(Av)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    return T


# --- level 1 ---------------------------------------------------------------

def swap(x, y, n=None, incx=1, incy=1, offsetx=0, offsety=0):
    """Interchange two vectors: x <-> y.

    n entries are exchanged (default: as many as fit), addressed as
    x[offsetx + incx*i] and y[offsety + incy*i].  In place on both.
    """
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n if n is not None else None, incy, offsety)
    if n is None:
        k = min(len(ix), len(iy))
        ix, iy = ix[:k], iy[:k]
    tmp = fx[ix].copy()
    fx[ix] = fy[iy]
    fy[iy] = tmp


def scal(alpha, x, n=None, inc=1, offset=0):
    """Scale a vector: x := alpha*x.

    Operates on the n entries x[offset + inc*i]; n=None means every
    entry reachable from offset with stride inc.  In place.
    """
    f, idx = _vec(x, n, inc, offset)
    f[idx] = alpha * f[idx]


def copy(x, y, n=None, incx=1, incy=1, offsetx=0, offsety=0):
    """Copy a vector: y := x.

    n entries (default: as many as fit), source addressed by
    (offsetx, incx), destination by (offsety, incy).  In place on y.
    """
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    k = min(len(ix), len(iy)) if n is None else len(ix)
    fy[iy[:k]] = fx[ix[:k]]


def axpy(x, y, alpha=1.0, n=None, incx=1, incy=1, offsetx=0, offsety=0):
    """Constant times a vector plus a vector: y := alpha*x + y.

    n entries (default: as many as fit), x addressed by
    (offsetx, incx), y by (offsety, incy).  In place on y.
    """
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    k = min(len(ix), len(iy)) if n is None else len(ix)
    fy[iy[:k]] += alpha * fx[ix[:k]]


def dot(x, y, n=None, incx=1, incy=1, offsetx=0, offsety=0):
    """Inner product x^H y (conjugated for 'z'; plain x^T y for 'd').

    Returns a Python float (or complex).  n entries addressed by
    (offsetx, incx) / (offsety, incy); n=None uses the shorter of the
    two reachable lengths.
    """
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    k = min(len(ix), len(iy)) if n is None else len(ix)
    return np.vdot(fx[ix[:k]], fy[iy[:k]]).item() \
        if fx.dtype.kind == "c" else float(np.dot(fx[ix[:k]], fy[iy[:k]]))


def dotu(x, y, n=None, incx=1, incy=1, offsetx=0, offsety=0):
    """Unconjugated inner product x^T y (blas.c dotu).

    Same addressing as `dot`; for 'd' matrices dot and dotu agree.
    """
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    k = min(len(ix), len(iy)) if n is None else len(ix)
    v = np.dot(fx[ix[:k]], fy[iy[:k]])
    return v.item() if fx.dtype.kind == "c" else float(v)


def nrm2(x, n=None, inc=1, offset=0):
    """Euclidean norm ||x||_2 of the n addressed entries.

    Entries x[offset + inc*i]; returns a Python float.
    """
    f, idx = _vec(x, n, inc, offset)
    return float(np.linalg.norm(f[idx]))


def asum(x, n=None, inc=1, offset=0):
    """1-norm-style sum: sum_i |Re x_i| + |Im x_i| (BLAS asum).

    Entries x[offset + inc*i]; returns a Python float.
    """
    f, idx = _vec(x, n, inc, offset)
    v = f[idx]
    if v.dtype.kind == "c":
        return float(np.abs(v.real).sum() + np.abs(v.imag).sum())
    return float(np.abs(v).sum())


def iamax(x, n=None, inc=1, offset=0):
    """Index of the entry with largest |Re| + |Im| (BLAS iamax).

    Returns a 0-based index into the addressed subvector (the
    reference's convention, blas.c:772).
    """
    f, idx = _vec(x, n, inc, offset)
    v = f[idx]
    if v.dtype.kind == "c":
        mags = np.abs(v.real) + np.abs(v.imag)
    else:
        mags = np.abs(v)
    return int(np.argmax(mags)) if len(mags) else 0


# --- level 2 ---------------------------------------------------------------

def gemv(A, x, y, trans="N", alpha=1.0, beta=0.0, m=None, n=None, ldA=None,
         incx=1, incy=1, offsetA=0, offsetx=0, offsety=0):
    """General matrix-vector product:

        y := alpha*A*x + beta*y    (trans = 'N')
        y := alpha*A^T*x + beta*y  (trans = 'T')
        y := alpha*A^H*x + beta*y  (trans = 'C')

    A is an m-by-n block read from A's buffer at offsetA with leading
    dimension ldA (defaults: m, n = A.size; ldA = A.size[0]); x and y
    are strided vectors addressed by (offsetx, incx) / (offsety, incy).
    In place on y.
    """
    Av, _ = _mat(A, m, n, ldA, offsetA)
    rows = Av.shape[0] if trans == "N" else Av.shape[1]
    cols = Av.shape[1] if trans == "N" else Av.shape[0]
    fx, ix = _vec(x, cols, incx, offsetx)
    fy, iy = _vec(y, rows, incy, offsety)
    fy[iy] = alpha * (_op(Av, trans) @ fx[ix]) + beta * fy[iy]


def symv(A, x, y, uplo="L", alpha=1.0, beta=0.0, n=None, ldA=None,
         incx=1, incy=1, offsetA=0, offsetx=0, offsety=0):
    """Symmetric matrix-vector product: y := alpha*A*x + beta*y.

    Only the uplo ('L' lower / 'U' upper) triangle of the n-by-n block
    at offsetA (leading dimension ldA) is referenced; the other
    triangle is taken by symmetry.  In place on y.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    F = _sym(Av, uplo)
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    fy[iy] = alpha * (F @ fx[ix]) + beta * fy[iy]


def hemv(A, x, y, uplo="L", alpha=1.0, beta=0.0, n=None, ldA=None,
         incx=1, incy=1, offsetA=0, offsetx=0, offsety=0):
    """Hermitian matrix-vector product: y := alpha*A*x + beta*y.

    Like `symv` but the mirrored triangle is conjugated ('z'); for 'd'
    matrices hemv and symv agree.  In place on y.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    F = _sym(Av, uplo, her=True)
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    fy[iy] = alpha * (F @ fx[ix]) + beta * fy[iy]


def _band_to_dense(Av, m, n, kl, ku):
    """General band storage (BLAS gb format) to dense."""
    D = np.zeros((m, n), dtype=Av.dtype)
    for j in range(n):
        for i in range(max(0, j - ku), min(m, j + kl + 1)):
            D[i, j] = Av[ku + i - j, j]
    return D


def gbmv(A, m, kl, x, y, trans="N", alpha=1.0, beta=0.0, n=None,
         ku=None, ldA=None, incx=1, incy=1, offsetA=0, offsetx=0,
         offsety=0):
    """General BAND matrix-vector product (blas.c:986).

    y := alpha*A*x + beta*y (or A^T/A^H for trans='T'/'C') where A is an
    m-by-n band matrix with kl subdiagonals and ku superdiagonals stored
    in the BLAS 'gb' format (row kl+ku+1-band layout, leading dimension
    ldA >= kl+ku+1).  Reference argument order: gbmv(A, m, kl, x, y,
    ...) with ku defaulting to A.size[0] - kl - 1.  In place on y.
    """
    if n is None:
        n = A.size[1]
    if ku is None:
        ku = A.size[0] - kl - 1
    Av, _ = _mat(A, kl + ku + 1, n, ldA if ldA else A.size[0], offsetA)
    D = _band_to_dense(Av, m, n, kl, ku)
    rows = m if trans == "N" else n
    cols = n if trans == "N" else m
    fx, ix = _vec(x, cols, incx, offsetx)
    fy, iy = _vec(y, rows, incy, offsety)
    fy[iy] = alpha * (_op(D, trans) @ fx[ix]) + beta * fy[iy]


def _sband_to_dense(Av, n, k, uplo, her=False):
    D = np.zeros((n, n), dtype=Av.dtype)
    for j in range(n):
        if uplo == "L":
            for i in range(j, min(n, j + k + 1)):
                D[i, j] = Av[i - j, j]
        else:
            for i in range(max(0, j - k), j + 1):
                D[i, j] = Av[k + i - j, j]
    mirror = (lambda M: M.conj().T) if her else (lambda M: M.T)
    if uplo == "L":
        out = np.tril(D) + mirror(np.tril(D, -1))
    else:
        out = np.triu(D) + mirror(np.triu(D, 1))
    if her:
        out[np.arange(n), np.arange(n)] = out.diagonal().real
    return out


def _sbmv_impl(A, x, y, uplo, alpha, beta, n, k, ldA, incx, incy,
               offsetA, offsetx, offsety, her):
    if n is None:
        n = A.size[1]
    if k is None:
        k = max(0, A.size[0] - 1)
    Av, _ = _mat(A, k + 1, n, ldA if ldA else A.size[0], offsetA)
    D = _sband_to_dense(Av, n, k, uplo, her=her)
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    fy[iy] = alpha * (D @ fx[ix]) + beta * fy[iy]


def sbmv(A, x, y, uplo="L", alpha=1.0, beta=0.0, n=None, k=None, ldA=None,
         incx=1, incy=1, offsetA=0, offsetx=0, offsety=0):
    """Symmetric BAND matrix-vector product: y := alpha*A*x + beta*y.

    A is an n-by-n symmetric band matrix with k off-diagonals stored in
    the BLAS 'sb' format with leading dimension ldA >= k+1, uplo
    selecting which triangle the bands describe.  In place on y.
    """
    _sbmv_impl(A, x, y, uplo, alpha, beta, n, k, ldA, incx, incy,
               offsetA, offsetx, offsety, her=False)


def hbmv(A, x, y, uplo="L", alpha=1.0, beta=0.0, n=None, k=None, ldA=None,
         incx=1, incy=1, offsetA=0, offsetx=0, offsety=0):
    """Hermitian BAND matrix-vector product (blas.c hbmv).

    Same band storage as `sbmv` but the mirrored triangle is
    conjugated.  In place on y.
    """
    _sbmv_impl(A, x, y, uplo, alpha, beta, n, k, ldA, incx, incy,
               offsetA, offsetx, offsety, her=True)


def trmv(A, x, uplo="L", trans="N", diag="N", n=None, ldA=None, incx=1,
         offsetA=0, offsetx=0):
    """Triangular matrix-vector product: x := A*x (trans='N'),
    A^T*x ('T') or A^H*x ('C').

    A is the n-by-n uplo triangle at offsetA (leading dimension ldA);
    diag='U' treats the diagonal as unit (ones, not read).  In place
    on x.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    T = _tri(Av, uplo, diag)
    f, idx = _vec(x, n, incx, offsetx)
    f[idx] = _op(T, trans) @ f[idx]


def trsv(A, x, uplo="L", trans="N", diag="N", n=None, ldA=None, incx=1,
         offsetA=0, offsetx=0):
    """Triangular solve: x := A^{-1}*x (trans='N'), A^{-T}*x ('T')
    or A^{-H}*x ('C').

    Same addressing as `trmv`; raises ArithmeticError on a zero
    diagonal entry (singular triangle), like the reference.  In place
    on x.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    T = _tri(Av, uplo, diag)
    f, idx = _vec(x, n, incx, offsetx)
    f[idx] = np.linalg.solve(_op(T, trans), f[idx])


def tbmv(A, x, uplo="L", trans="N", diag="N", n=None, k=None, ldA=None,
         incx=1, offsetA=0, offsetx=0):
    """Triangular BAND matrix-vector product: x := A*x / A^T*x /
    A^H*x.

    A is an n-by-n triangular band matrix with k off-diagonals in 'tb'
    storage (leading dimension ldA >= k+1).  In place on x.
    """
    if n is None:
        n = A.size[1]
    if k is None:
        k = max(0, A.size[0] - 1)
    Av, _ = _mat(A, k + 1, n, ldA if ldA else A.size[0], offsetA)
    D = np.zeros((n, n), dtype=Av.dtype)
    for j in range(n):
        if uplo == "L":
            for i in range(j, min(n, j + k + 1)):
                D[i, j] = Av[i - j, j]
        else:
            for i in range(max(0, j - k), j + 1):
                D[i, j] = Av[k + i - j, j]
    if diag == "U":
        np.fill_diagonal(D, 1.0)
    f, idx = _vec(x, n, incx, offsetx)
    f[idx] = _op(D, trans) @ f[idx]


def tbsv(A, x, uplo="L", trans="N", diag="N", n=None, k=None, ldA=None,
         incx=1, offsetA=0, offsetx=0):
    """Triangular BAND solve: x := A^{-1}*x / A^{-T}*x / A^{-H}*x.

    Same storage as `tbmv`.  In place on x.
    """
    if n is None:
        n = A.size[1]
    if k is None:
        k = max(0, A.size[0] - 1)
    Av, _ = _mat(A, k + 1, n, ldA if ldA else A.size[0], offsetA)
    D = np.zeros((n, n), dtype=Av.dtype)
    for j in range(n):
        if uplo == "L":
            for i in range(j, min(n, j + k + 1)):
                D[i, j] = Av[i - j, j]
        else:
            for i in range(max(0, j - k), j + 1):
                D[i, j] = Av[k + i - j, j]
    if diag == "U":
        np.fill_diagonal(D, 1.0)
    f, idx = _vec(x, n, incx, offsetx)
    f[idx] = np.linalg.solve(_op(D, trans), f[idx])


def ger(x, y, A, alpha=1.0, m=None, n=None, incx=1, incy=1, ldA=None,
        offsetx=0, offsety=0, offsetA=0):
    """General rank-1 update: A := A + alpha*x*y^H (conjugated).

    A is the m-by-n block at offsetA (leading dimension ldA); x, y are
    strided vectors.  In place on A.
    """
    Av, _ = _mat(A, m, n, ldA, offsetA)
    fx, ix = _vec(x, Av.shape[0], incx, offsetx)
    fy, iy = _vec(y, Av.shape[1], incy, offsety)
    Av += alpha * np.outer(fx[ix], fy[iy].conj())


def geru(x, y, A, alpha=1.0, m=None, n=None, incx=1, incy=1, ldA=None,
         offsetx=0, offsety=0, offsetA=0):
    """Unconjugated rank-1 update: A := A + alpha*x*y^T.

    Same addressing as `ger`.  In place on A.
    """
    Av, _ = _mat(A, m, n, ldA, offsetA)
    fx, ix = _vec(x, Av.shape[0], incx, offsetx)
    fy, iy = _vec(y, Av.shape[1], incy, offsety)
    Av += alpha * np.outer(fx[ix], fy[iy])


def _update_tri(Av, upd, uplo):
    n = Av.shape[0]
    if uplo == "L":
        idx = np.tril_indices(n)
    else:
        idx = np.triu_indices(n)
    Av[idx] += upd[idx]


def syr(x, A, uplo="L", alpha=1.0, n=None, incx=1, ldA=None, offsetx=0,
        offsetA=0):
    """Symmetric rank-1 update: A := A + alpha*x*x^T.

    Only the uplo triangle of the n-by-n block is updated.  In place
    on A.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    f, idx = _vec(x, n, incx, offsetx)
    _update_tri(Av, alpha * np.outer(f[idx], f[idx]), uplo)


def her(x, A, uplo="L", alpha=1.0, n=None, incx=1, ldA=None, offsetx=0,
        offsetA=0):
    """Hermitian rank-1 update: A := A + alpha*x*x^H (alpha real).

    Only the uplo triangle is updated.  In place on A.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    f, idx = _vec(x, n, incx, offsetx)
    _update_tri(Av, alpha * np.outer(f[idx], f[idx].conj()), uplo)


def syr2(x, y, A, uplo="L", alpha=1.0, n=None, incx=1, incy=1, ldA=None,
         offsetx=0, offsety=0, offsetA=0):
    """Symmetric rank-2 update: A := A + alpha*(x*y^T + y*x^T).

    Only the uplo triangle of the n-by-n block is updated.  In place
    on A.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    upd = alpha * (np.outer(fx[ix], fy[iy]) + np.outer(fy[iy], fx[ix]))
    _update_tri(Av, upd, uplo)


def her2(x, y, A, uplo="L", alpha=1.0, n=None, incx=1, incy=1, ldA=None,
         offsetx=0, offsety=0, offsetA=0):
    """Hermitian rank-2 update: A := A + alpha*x*y^H +
    conj(alpha)*y*x^H.

    Only the uplo triangle is updated.  In place on A.
    """
    if n is None:
        n = A.size[0]
    Av, _ = _mat(A, n, n, ldA, offsetA)
    fx, ix = _vec(x, n, incx, offsetx)
    fy, iy = _vec(y, n, incy, offsety)
    upd = alpha * np.outer(fx[ix], fy[iy].conj()) + \
        np.conj(alpha) * np.outer(fy[iy], fx[ix].conj())
    _update_tri(Av, upd, uplo)


# --- level 3 ---------------------------------------------------------------

def gemm(A, B, C, transA="N", transB="N", alpha=1.0, beta=0.0, m=None,
         n=None, k=None, ldA=None, ldB=None, ldC=None, offsetA=0,
         offsetB=0, offsetC=0):
    """General matrix-matrix product:

        C := alpha*op(A)*op(B) + beta*C

    with op(X) = X, X^T or X^H per transA/transB in 'N'/'T'/'C'.
    op(A) is m-by-k, op(B) k-by-n, C m-by-n; each operand is a
    column-major block read at its offset* with leading dimension ld*
    (defaults from the matrix sizes).  In place on C.
    """
    if m is None:
        m = A.size[0] if transA == "N" else A.size[1]
    if n is None:
        n = B.size[1] if transB == "N" else B.size[0]
    if k is None:
        k = A.size[1] if transA == "N" else A.size[0]
    Av, _ = _mat(A, m if transA == "N" else k,
                 k if transA == "N" else m, ldA, offsetA)
    Bv, _ = _mat(B, k if transB == "N" else n,
                 n if transB == "N" else k, ldB, offsetB)
    Cv, _ = _mat(C, m, n, ldC, offsetC)
    Cv[:] = alpha * (_op(Av, transA) @ _op(Bv, transB)) + beta * Cv


def symm(A, B, C, side="L", uplo="L", alpha=1.0, beta=0.0, m=None, n=None,
         ldA=None, ldB=None, ldC=None, offsetA=0, offsetB=0, offsetC=0):
    """Symmetric matrix-matrix product:

        C := alpha*A*B + beta*C   (side = 'L', A symmetric m-by-m)
        C := alpha*B*A + beta*C   (side = 'R', A symmetric n-by-n)

    Only the uplo triangle of A is referenced.  In place on C.
    """
    if m is None:
        m = B.size[0]
    if n is None:
        n = B.size[1]
    na = m if side == "L" else n
    Av, _ = _mat(A, na, na, ldA, offsetA)
    Bv, _ = _mat(B, m, n, ldB, offsetB)
    Cv, _ = _mat(C, m, n, ldC, offsetC)
    F = _sym(Av, uplo)
    Cv[:] = alpha * (F @ Bv if side == "L" else Bv @ F) + beta * Cv


def hemm(A, B, C, side="L", uplo="L", alpha=1.0, beta=0.0, m=None, n=None,
         ldA=None, ldB=None, ldC=None, offsetA=0, offsetB=0, offsetC=0):
    """Hermitian matrix-matrix product: like `symm` with the
    mirrored triangle of A conjugated.  In place on C.
    """
    if m is None:
        m = B.size[0]
    if n is None:
        n = B.size[1]
    na = m if side == "L" else n
    Av, _ = _mat(A, na, na, ldA, offsetA)
    Bv, _ = _mat(B, m, n, ldB, offsetB)
    Cv, _ = _mat(C, m, n, ldC, offsetC)
    F = _sym(Av, uplo, her=True)
    Cv[:] = alpha * (F @ Bv if side == "L" else Bv @ F) + beta * Cv


def syrk(A, C, uplo="L", trans="N", alpha=1.0, beta=0.0, n=None, k=None,
         ldA=None, ldC=None, offsetA=0, offsetC=0):
    """Symmetric rank-k update:

        C := alpha*A*A^T + beta*C    (trans = 'N')
        C := alpha*A^T*A + beta*C    (trans = 'T')

    C is n-by-n, only its uplo triangle is updated; A is n-by-k
    ('N') or k-by-n ('T').  In place on C.
    """
    if n is None:
        n = A.size[0] if trans == "N" else A.size[1]
    if k is None:
        k = A.size[1] if trans == "N" else A.size[0]
    Av, _ = _mat(A, n if trans == "N" else k,
                 k if trans == "N" else n, ldA, offsetA)
    Cv, _ = _mat(C, n, n, ldC, offsetC)
    upd = Av @ Av.T if trans == "N" else Av.T @ Av
    idx = np.tril_indices(n) if uplo == "L" else np.triu_indices(n)
    Cv[idx] = alpha * upd[idx] + beta * Cv[idx]


def herk(A, C, uplo="L", trans="N", alpha=1.0, beta=0.0, n=None, k=None,
         ldA=None, ldC=None, offsetA=0, offsetC=0):
    """Hermitian rank-k update: C := alpha*A*A^H + beta*C ('N') or
    alpha*A^H*A + beta*C ('C'); alpha, beta real.

    Only the uplo triangle of C is updated.  In place on C.
    """
    if n is None:
        n = A.size[0] if trans == "N" else A.size[1]
    if k is None:
        k = A.size[1] if trans == "N" else A.size[0]
    Av, _ = _mat(A, n if trans == "N" else k,
                 k if trans == "N" else n, ldA, offsetA)
    Cv, _ = _mat(C, n, n, ldC, offsetC)
    upd = Av @ Av.conj().T if trans == "N" else Av.conj().T @ Av
    idx = np.tril_indices(n) if uplo == "L" else np.triu_indices(n)
    Cv[idx] = alpha * upd[idx] + beta * Cv[idx]


def syr2k(A, B, C, uplo="L", trans="N", alpha=1.0, beta=0.0, n=None,
          k=None, ldA=None, ldB=None, ldC=None, offsetA=0, offsetB=0,
          offsetC=0):
    """Symmetric rank-2k update:

        C := alpha*(A*B^T + B*A^T) + beta*C   (trans = 'N')
        C := alpha*(A^T*B + B^T*A) + beta*C   (trans = 'T')

    Only the uplo triangle of C is updated.  In place on C.
    """
    if n is None:
        n = A.size[0] if trans == "N" else A.size[1]
    if k is None:
        k = A.size[1] if trans == "N" else A.size[0]
    sh = (n, k) if trans == "N" else (k, n)
    Av, _ = _mat(A, sh[0], sh[1], ldA, offsetA)
    Bv, _ = _mat(B, sh[0], sh[1], ldB, offsetB)
    if trans == "N":
        upd = Av @ Bv.T + Bv @ Av.T
    else:
        upd = Av.T @ Bv + Bv.T @ Av
    Cv, _ = _mat(C, n, n, ldC, offsetC)
    idx = np.tril_indices(n) if uplo == "L" else np.triu_indices(n)
    Cv[idx] = alpha * upd[idx] + beta * Cv[idx]


def her2k(A, B, C, uplo="L", trans="N", alpha=1.0, beta=0.0, n=None,
          k=None, ldA=None, ldB=None, ldC=None, offsetA=0, offsetB=0,
          offsetC=0):
    """Hermitian rank-2k update: C := alpha*A*B^H +
    conj(alpha)*B*A^H + beta*C ('N'; 'C' transposes the operands);
    beta real.  Only the uplo triangle of C is updated.  In place on
    C.
    """
    if n is None:
        n = A.size[0] if trans == "N" else A.size[1]
    if k is None:
        k = A.size[1] if trans == "N" else A.size[0]
    sh = (n, k) if trans == "N" else (k, n)
    Av, _ = _mat(A, sh[0], sh[1], ldA, offsetA)
    Bv, _ = _mat(B, sh[0], sh[1], ldB, offsetB)
    if trans == "N":
        upd = alpha * (Av @ Bv.conj().T) + np.conj(alpha) * (
            Bv @ Av.conj().T)
    else:
        upd = alpha * (Av.conj().T @ Bv) + np.conj(alpha) * (
            Bv.conj().T @ Av)
    Cv, _ = _mat(C, n, n, ldC, offsetC)
    idx = np.tril_indices(n) if uplo == "L" else np.triu_indices(n)
    Cv[idx] = upd[idx] + beta * Cv[idx]


def trmm(A, B, side="L", uplo="L", transA="N", diag="N", alpha=1.0,
         m=None, n=None, ldA=None, ldB=None, offsetA=0, offsetB=0):
    """Triangular matrix-matrix product:

        B := alpha*op(A)*B   (side = 'L')
        B := alpha*B*op(A)   (side = 'R')

    op per transA; A is the uplo triangle (diag='U' = unit diagonal).
    In place on B.
    """
    if m is None:
        m = B.size[0]
    if n is None:
        n = B.size[1]
    na = m if side == "L" else n
    Av, _ = _mat(A, na, na, ldA, offsetA)
    Bv, _ = _mat(B, m, n, ldB, offsetB)
    T = _op(_tri(Av, uplo, diag), transA)
    Bv[:] = alpha * (T @ Bv if side == "L" else Bv @ T)


def trsm(A, B, side="L", uplo="L", transA="N", diag="N", alpha=1.0,
         m=None, n=None, ldA=None, ldB=None, offsetA=0, offsetB=0):
    """Triangular matrix-matrix solve:

        B := alpha*op(A)^{-1}*B   (side = 'L')
        B := alpha*B*op(A)^{-1}   (side = 'R')

    op per transA; A is the uplo triangle (diag='U' = unit diagonal).
    Raises ArithmeticError on a singular triangle.  In place on B.
    """
    if m is None:
        m = B.size[0]
    if n is None:
        n = B.size[1]
    na = m if side == "L" else n
    Av, _ = _mat(A, na, na, ldA, offsetA)
    Bv, _ = _mat(B, m, n, ldB, offsetB)
    T = _op(_tri(Av, uplo, diag), transA)
    if side == "L":
        Bv[:] = alpha * np.linalg.solve(T, Bv)
    else:
        Bv[:] = alpha * np.linalg.solve(T.T, Bv.T).T
