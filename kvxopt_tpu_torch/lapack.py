"""LAPACK-style routines on dense matrices (reference src/C/lapack.c, 60
routines, table lapack.c:7341-7400).

Same in-place calling conventions as the reference: factors overwrite A,
solutions overwrite B, eigen/singular values fill the provided matrices,
pivot vectors fill 'i' matrices.  Backed by scipy's LAPACK (the same
native library the reference links against), on the host by design:
device-side factorizations in this package go through torch on the card
(kvxopt_tpu_torch.kkt), never through this facade, and no solver calls it.

Raises ArithmeticError on singular / non-positive-definite inputs, like
the reference.

Copy of kvxopt_tpu/lapack.py: numpy and scipy on the host, over the
port's base.matrix."""

import numpy as np
import scipy.linalg as sla
import scipy.linalg.lapack as _lp

from .base import matrix

__all__ = [
    "getrf", "getrs", "getri", "gesv", "gbtrf", "gbtrs", "gbsv",
    "gttrf", "gttrs", "gtsv", "potrf", "potrs", "potri", "posv",
    "pbtrf", "pbtrs", "pbsv", "pttrf", "pttrs", "ptsv",
    "sytrf", "sytrs", "sytri", "sysv", "hetrf", "hetrs", "hetri", "hesv",
    "trtrs", "trtri", "tbtrs",
    "gels", "geqrf", "ormqr", "unmqr", "orgqr", "ungqr",
    "gelqf", "ormlq", "unmlq", "orglq", "unglq", "geqp3",
    "syev", "heev", "syevx", "heevx", "syevd", "heevd", "syevr", "heevr",
    "sygv", "hegv", "gesvd", "gesdd", "gees", "gges",
    "lacpy", "larfg", "larfx",
]


def _arr(X):
    if not isinstance(X, matrix):
        raise TypeError("arguments must be dense matrices")
    return X._a


def _set(X, val):
    X._a = np.asfortranarray(np.asarray(val).reshape(X._a.shape,
                                                     order="F")
                             if np.asarray(val).ndim == 1 else
                             np.asarray(val)).astype(X._a.dtype)


def _write(X, val):
    a = np.asarray(val)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    X._a = np.asfortranarray(a.astype(a.dtype))


def _complexkind(X):
    return _arr(X).dtype.kind == "c"


def _check(info, what="factorization"):
    if info < 0:
        raise ValueError(f"invalid argument {-info} in {what}")
    if info > 0:
        raise ArithmeticError(f"{what} failed (info={info})")


# --- LU --------------------------------------------------------------------

def getrf(A, ipiv):
    """LU factorization with partial pivoting: A = P*L*U.

    On exit A holds L (unit lower, below the diagonal) and U; ipiv
    (integer matrix, length >= min(m,n)) receives the 1-based pivot
    indices.  Raises ArithmeticError if U is exactly singular.
    """
    a = _arr(A)
    lu, piv, info = (_lp.zgetrf if a.dtype.kind == "c"
                     else _lp.dgetrf)(a)
    _check(info, "getrf")
    _write(A, lu)
    ipiv._a = np.asfortranarray(
        (piv.astype(np.int64) + 1).reshape(ipiv._a.shape, order="F"))


def getrs(A, ipiv, B, trans="N"):
    """Solve op(A)*X = B from a `getrf` factorization, in place on
    B.  trans in 'N'/'T'/'C' selects op; B may hold multiple
    right-hand-side columns.
    """
    a = _arr(A)
    piv = np.asarray(ipiv).reshape(-1).astype(np.int32) - 1
    tr = {"N": 0, "T": 1, "C": 2}[trans]
    fn = _lp.zgetrs if a.dtype.kind == "c" else _lp.dgetrs
    x, info = fn(a, piv, np.asarray(B).reshape(a.shape[0], -1),
                 trans=tr)
    _check(info, "getrs")
    _write(B, x.reshape(np.asarray(B).shape))


def getri(A, ipiv):
    """Matrix inverse from a `getrf` factorization, in place on A
    (A := A^{-1}).
    """
    a = _arr(A)
    piv = np.asarray(ipiv).reshape(-1).astype(np.int32) - 1
    fn = _lp.zgetri if a.dtype.kind == "c" else _lp.dgetri
    inv, info = fn(a, piv)
    _check(info, "getri")
    _write(A, inv)


def gesv(A, B, ipiv=None):
    """Solve A*X = B by LU with partial pivoting.  On exit A holds
    the factors (as `getrf`) and B the solution; ipiv optionally
    receives the pivots.  Raises ArithmeticError if singular.
    """
    a = _arr(A)
    lu, piv, info = (_lp.zgetrf if a.dtype.kind == "c"
                     else _lp.dgetrf)(a)
    _check(info, "gesv")
    fn = _lp.zgetrs if a.dtype.kind == "c" else _lp.dgetrs
    x, info = fn(lu, piv, np.asarray(B).reshape(a.shape[0], -1))
    _check(info, "gesv")
    # reference semantics (lapack.c:648): A is overwritten with the LU
    # factors only when ipiv is supplied; without ipiv, A is unchanged
    if ipiv is not None:
        _write(A, lu)
        ipiv._a = np.asfortranarray(
            (piv.astype(np.int64) + 1).reshape(ipiv._a.shape, order="F"))
    _write(B, x.reshape(np.asarray(B).shape))


# --- banded / tridiagonal --------------------------------------------------

class _BandFactor:
    pass


def gbtrf(A, m, kl, ipiv, n=None, ldA=None, offsetA=0):
    """LU factorization of an m-by-n BAND matrix with kl
    subdiagonals, stored in the BLAS/LAPACK 'gb' format with
    2*kl+ku+1 rows (ldA >= 2*kl+ku+1; ku defaults from the storage).
    On exit A holds the band factors and ipiv the pivots.
    """
    a = _arr(A)
    if n is None:
        n = a.shape[1]
    ku = a.shape[0] - 2 * kl - 1
    fn = _lp.zgbtrf if a.dtype.kind == "c" else _lp.dgbtrf
    lu, piv, info = fn(a, kl, ku)
    _check(info, "gbtrf")
    _write(A, lu)
    ipiv._a = np.asfortranarray(
        (piv.astype(np.int64) + 1).reshape(ipiv._a.shape, order="F"))


def gbtrs(A, kl, ipiv, B, trans="N"):
    """Solve op(A)*X = B from a `gbtrf` band factorization, in
    place on B.
    """
    a = _arr(A)
    ku = a.shape[0] - 2 * kl - 1
    piv = np.asarray(ipiv).reshape(-1).astype(np.int32) - 1
    fn = _lp.zgbtrs if a.dtype.kind == "c" else _lp.dgbtrs
    tr = {"N": 0, "T": 1, "C": 2}[trans]
    x, info = fn(a, kl, ku, np.asarray(B).reshape(a.shape[1], -1), piv,
                 trans=tr)
    _check(info, "gbtrs")
    _write(B, x.reshape(np.asarray(B).shape))


def gbsv(A, kl, B, ipiv=None, ku=None):
    """Solve A*X = B for a band matrix A ('gb' storage with kl
    subdiagonals, ku superdiagonals).  Factorization + solve in one
    call; in place on A (factors) and B (solution).
    """
    a = _arr(A)
    fn = _lp.zgbsv if a.dtype.kind == "c" else _lp.dgbsv
    if ipiv is not None:
        if ku is None:
            ku = a.shape[0] - 2 * kl - 1
        lub, piv, x, info = fn(kl, ku, a, np.asarray(B).reshape(
            a.shape[1], -1))
        _check(info, "gbsv")
        _write(A, lub)
        ipiv._a = np.asfortranarray(
            (piv.astype(np.int64) + 1).reshape(ipiv._a.shape, order="F"))
    else:
        if ku is None:
            ku = a.shape[0] - kl - 1
        ab = np.zeros((2 * kl + ku + 1, a.shape[1]), dtype=a.dtype)
        ab[kl:, :] = a[: kl + ku + 1, :]
        lub, piv, x, info = fn(kl, ku, ab, np.asarray(B).reshape(
            a.shape[1], -1))
        _check(info, "gbsv")
    _write(B, x.reshape(np.asarray(B).shape))


def gttrf(dl, d, du, du2, ipiv):
    """LU factorization of a TRIDIAGONAL matrix given by its
    subdiagonal dl (n-1), diagonal d (n), superdiagonal du (n-1).
    On exit the vectors hold the factors, du2 (n-2) the second
    superdiagonal of U, ipiv the pivots.
    """
    fn = _lp.zgttrf if _complexkind(d) else _lp.dgttrf
    dl2, d2, du_2, du2_2, piv, info = fn(
        np.asarray(dl).reshape(-1), np.asarray(d).reshape(-1),
        np.asarray(du).reshape(-1))
    _check(info, "gttrf")
    _write(dl, dl2); _write(d, d2); _write(du, du_2); _write(du2, du2_2)
    # scipy's gttrf already returns LAPACK's 1-based pivots (unlike
    # getrf, whose scipy wrapper converts to 0-based)
    ipiv._a = np.asfortranarray(
        piv.astype(np.int64).reshape(ipiv._a.shape, order="F"))


def gttrs(dl, d, du, du2, ipiv, B, trans="N"):
    """Solve op(A)*X = B from a `gttrf` tridiagonal factorization,
    in place on B.
    """
    fn = _lp.zgttrs if _complexkind(d) else _lp.dgttrs
    piv = np.asarray(ipiv).reshape(-1).astype(np.int32)
    n = np.asarray(d).size
    tr = {"N": "N", "T": "T", "C": "C"}[trans]
    x, info = fn(np.asarray(dl).reshape(-1), np.asarray(d).reshape(-1),
                 np.asarray(du).reshape(-1), np.asarray(du2).reshape(-1),
                 piv, np.asarray(B).reshape(n, -1), trans=tr)
    _check(info, "gttrs")
    _write(B, x.reshape(np.asarray(B).shape))


def gtsv(dl, d, du, B):
    """Solve A*X = B for tridiagonal A given by dl/d/du;
    factorization + solve, in place on the vectors and B.
    """
    n = np.asarray(d).size
    fn = _lp.zgtsv if _complexkind(d) else _lp.dgtsv
    dl2, d2, du2, x, info = fn(np.asarray(dl).reshape(-1),
                               np.asarray(d).reshape(-1),
                               np.asarray(du).reshape(-1),
                               np.asarray(B).reshape(n, -1))
    _check(info, "gtsv")
    _write(B, x.reshape(np.asarray(B).shape))


# --- Cholesky --------------------------------------------------------------

def potrf(A, uplo="L"):
    """Cholesky factorization of a symmetric/Hermitian positive
    definite matrix: A = L*L^H (uplo='L') or A = U^H*U ('U').

    Only the uplo triangle is referenced and overwritten with the
    factor.  Raises ArithmeticError if A is not positive definite.
    """
    a = _arr(A)
    fn = _lp.zpotrf if a.dtype.kind == "c" else _lp.dpotrf
    c, info = fn(a, lower=(uplo == "L"), clean=0)
    _check(info, "potrf")
    _write(A, c)


def potrs(A, B, uplo="L"):
    """Solve A*X = B from a `potrf` Cholesky factor, in place on
    B.
    """
    a = _arr(A)
    fn = _lp.zpotrs if a.dtype.kind == "c" else _lp.dpotrs
    x, info = fn(a, np.asarray(B).reshape(a.shape[0], -1),
                 lower=(uplo == "L"))
    _check(info, "potrs")
    _write(B, x.reshape(np.asarray(B).shape))


def potri(A, uplo="L"):
    """Inverse from a `potrf` Cholesky factor, in place on A
    (only the uplo triangle is formed).
    """
    a = _arr(A)
    fn = _lp.zpotri if a.dtype.kind == "c" else _lp.dpotri
    inv, info = fn(a, lower=(uplo == "L"))
    _check(info, "potri")
    _write(A, inv)


def posv(A, B, uplo="L"):
    """Solve A*X = B for positive definite A: Cholesky factorize
    (in place on A) then solve (in place on B).
    """
    potrf(A, uplo)
    potrs(A, B, uplo)


def pbtrf(A, uplo="L"):
    """Cholesky factorization of a positive definite BAND matrix
    in 'pb' storage (kd+1 band rows).  In place on A.
    """
    a = _arr(A)
    fn = _lp.zpbtrf if a.dtype.kind == "c" else _lp.dpbtrf
    c, info = fn(a, lower=(uplo == "L"))
    _check(info, "pbtrf")
    _write(A, c)


def pbtrs(A, B, uplo="L"):
    """Solve from a `pbtrf` band Cholesky factor, in place on
    B.
    """
    a = _arr(A)
    fn = _lp.zpbtrs if a.dtype.kind == "c" else _lp.dpbtrs
    x, info = fn(a, np.asarray(B).reshape(a.shape[1], -1),
                 lower=(uplo == "L"))
    _check(info, "pbtrs")
    _write(B, x.reshape(np.asarray(B).shape))


def pbsv(A, B, uplo="L"):
    """Factorize + solve for a positive definite band matrix, in
    place on A and B.
    """
    pbtrf(A, uplo)
    pbtrs(A, B, uplo)


def pttrf(d, e):
    """L*D*L^H factorization of a positive definite TRIDIAGONAL
    matrix given by diagonal d and off-diagonal e; in place.
    """
    fn = _lp.zpttrf if _complexkind(e) else _lp.dpttrf
    d2, e2, info = fn(np.asarray(d).reshape(-1).real,
                      np.asarray(e).reshape(-1))
    _check(info, "pttrf")
    _write(d, d2); _write(e, e2)


def pttrs(d, e, B, uplo="L"):
    """Solve from a `pttrf` factorization, in place on B.  uplo
    states whether e was the sub- ('L') or superdiagonal ('U') for
    complex data.
    """
    n = np.asarray(d).size
    if _complexkind(e):
        x, info = _lp.zpttrs(np.asarray(d).reshape(-1).real,
                             np.asarray(e).reshape(-1),
                             np.asarray(B).reshape(n, -1),
                             lower=(uplo == "L"))
    else:
        x, info = _lp.dpttrs(np.asarray(d).reshape(-1),
                             np.asarray(e).reshape(-1),
                             np.asarray(B).reshape(n, -1))
    _check(info, "pttrs")
    _write(B, x.reshape(np.asarray(B).shape))


def ptsv(d, e, B):
    """Factorize + solve for a positive definite tridiagonal
    matrix; in place on d, e, B.
    """
    pttrf(d, e)
    pttrs(d, e, B)


# --- symmetric indefinite --------------------------------------------------

def sytrf(A, ipiv, uplo="L"):
    """Bunch-Kaufman factorization of a symmetric indefinite
    matrix: A = L*D*L^T (uplo='L') or U*D*U^T ('U'), D block-diagonal
    with 1x1/2x2 pivots.  In place on A; ipiv receives the pivot
    structure.
    """
    a = _arr(A)
    fn = _lp.zsytrf if a.dtype.kind == "c" else _lp.dsytrf
    ldu, piv, info = fn(a, lower=(uplo == "L"))
    _check(info, "sytrf")
    _write(A, ldu)
    ipiv._a = np.asfortranarray(
        np.where(piv >= 0, piv.astype(np.int64) + 1,
                 piv.astype(np.int64) - 0).reshape(ipiv._a.shape,
                                                   order="F"))
    ipiv._raw = piv  # keep the raw scipy pivots for sytrs/sytri


def _rawpiv(ipiv):
    if hasattr(ipiv, "_raw"):
        return ipiv._raw
    piv = np.asarray(ipiv).reshape(-1).astype(np.int32)
    return np.where(piv > 0, piv - 1, piv)


def sytrs(A, ipiv, B, uplo="L"):
    """Solve A*X = B from a `sytrf` factorization, in place on
    B.
    """
    a = _arr(A)
    fn = _lp.zsytrs if a.dtype.kind == "c" else _lp.dsytrs
    x, info = fn(a, _rawpiv(ipiv), np.asarray(B).reshape(a.shape[0], -1),
                 lower=(uplo == "L"))
    _check(info, "sytrs")
    _write(B, x.reshape(np.asarray(B).shape))


def sytri(A, ipiv, uplo="L"):
    """Inverse from a `sytrf` factorization, in place on A.
    """
    a = _arr(A)
    fn = _lp.zsytri if a.dtype.kind == "c" else _lp.dsytri
    inv, info = fn(a, _rawpiv(ipiv), lower=(uplo == "L"))
    _check(info, "sytri")
    _write(A, inv)


def sysv(A, B, ipiv=None, uplo="L"):
    """Solve A*X = B for symmetric indefinite A: Bunch-Kaufman
    factorize (in place on A, pivots in ipiv if given) then solve (in
    place on B).
    """
    if ipiv is None:
        from .base import matrix as _m
        Ac = _m(np.array(_arr(A)))
        tmp = _m(np.zeros((_arr(A).shape[0], 1), dtype=np.intc))
        sytrf(Ac, tmp, uplo)
        sytrs(Ac, tmp, B, uplo)
    else:
        sytrf(A, ipiv, uplo)
        sytrs(A, ipiv, B, uplo)


def hetrf(A, ipiv, uplo="L"):
    """Bunch-Kaufman factorization of a HERMITIAN indefinite
    matrix (A = L*D*L^H).  For 'd' data identical to `sytrf`.
    """
    a = _arr(A)
    if a.dtype.kind != "c":
        return sytrf(A, ipiv, uplo)
    ldu, piv, info = _lp.zhetrf(a, lower=(uplo == "L"))
    _check(info, "hetrf")
    _write(A, ldu)
    ipiv._a = np.asfortranarray(
        (piv.astype(np.int64) + 1).reshape(ipiv._a.shape, order="F"))
    ipiv._raw = piv


def hetrs(A, ipiv, B, uplo="L"):
    """Solve from a `hetrf` factorization, in place on B.
    """
    a = _arr(A)
    if a.dtype.kind != "c":
        return sytrs(A, ipiv, B, uplo)
    x, info = _lp.zhetrs(a, _rawpiv(ipiv),
                         np.asarray(B).reshape(a.shape[0], -1),
                         lower=(uplo == "L"))
    _check(info, "hetrs")
    _write(B, x.reshape(np.asarray(B).shape))


def hetri(A, ipiv, uplo="L"):
    """Inverse from a `hetrf` factorization, in place on A.
    """
    a = _arr(A)
    if a.dtype.kind != "c":
        return sytri(A, ipiv, uplo)
    inv, info = _lp.zhetri(a, _rawpiv(ipiv), lower=(uplo == "L"))
    _check(info, "hetri")
    _write(A, inv)


def hesv(A, B, ipiv=None, uplo="L"):
    """Factorize + solve for Hermitian indefinite A, in place on A
    and B.
    """
    if ipiv is None:
        from .base import matrix as _m
        Ac = _m(np.array(_arr(A)))
        tmp = _m(np.zeros((_arr(A).shape[0], 1), dtype=np.intc))
        hetrf(Ac, tmp, uplo)
        hetrs(Ac, tmp, B, uplo)
    else:
        hetrf(A, ipiv, uplo)
        hetrs(A, ipiv, B, uplo)


# --- triangular ------------------------------------------------------------

def trtrs(A, B, uplo="L", trans="N", diag="N"):
    """Triangular solve op(A)*X = B with the uplo triangle of A
    (diag='U' = unit diagonal), in place on B.  Raises
    ArithmeticError on a zero diagonal (singular).
    """
    a = _arr(A)
    fn = _lp.ztrtrs if a.dtype.kind == "c" else _lp.dtrtrs
    x, info = fn(a, np.asarray(B).reshape(a.shape[0], -1),
                 lower=(uplo == "L"),
                 trans={"N": 0, "T": 1, "C": 2}[trans],
                 unitdiag=(diag == "U"))
    _check(info, "trtrs")
    _write(B, x.reshape(np.asarray(B).shape))


def trtri(A, uplo="L", diag="N"):
    """Triangular inverse, in place on the uplo triangle of A.
    """
    a = _arr(A)
    fn = _lp.ztrtri if a.dtype.kind == "c" else _lp.dtrtri
    inv, info = fn(a, lower=(uplo == "L"), unitdiag=(diag == "U"))
    _check(info, "trtri")
    _write(A, inv)


def tbtrs(A, B, uplo="L", trans="N", kd=None, diag="N"):
    """Triangular BAND solve op(A)*X = B with A in 'tb' band
    storage (kd off-diagonals), in place on B.
    """
    a = _arr(A)
    if kd is None:
        kd = a.shape[0] - 1
    fn = _lp.ztbtrs if a.dtype.kind == "c" else _lp.dtbtrs
    x, info = fn(a, np.asarray(B).reshape(a.shape[1], -1),
                 uplo=uplo, trans=trans, diag=diag)
    _check(info, "tbtrs")
    _write(B, x.reshape(np.asarray(B).shape))


# --- least squares / orthogonal --------------------------------------------

def gels(A, B, trans="N"):
    """Least-squares / minimum-norm solve of op(A)*X = B for full-
    rank A via QR/LQ: overdetermined systems get the least-squares
    solution, underdetermined the minimum-norm one.  In place on B
    (the leading rows hold X on exit); A is overwritten with its
    factorization.
    """
    a = _arr(A)
    b = np.asarray(B)
    m, n = a.shape
    op = a if trans == "N" else (a.conj().T if trans == "C" else a.T)
    x, res, rank, sv = np.linalg.lstsq(op, b.reshape(op.shape[0], -1),
                                       rcond=None)
    out = b.copy()
    out[: x.shape[0], :] = x
    _write(B, out)


def geqrf(A, tau):
    """QR factorization A = Q*R.  On exit A holds R (upper
    triangle) and the Householder vectors below it; tau (length
    min(m,n)) the scalar reflector coefficients.
    """
    a = _arr(A)
    fn = _lp.zgeqrf if a.dtype.kind == "c" else _lp.dgeqrf
    qr, t, work, info = fn(a)
    _check(info, "geqrf")
    _write(A, qr)
    _write(tau, t)


def ormqr(A, tau, C, side="L", trans="N"):
    """Multiply a real matrix by Q from a `geqrf` factorization:
    C := op(Q)*C (side='L') or C*op(Q) ('R'), op per trans in
    'N'/'T'.  In place on C.
    """
    a = _arr(A)
    t = np.asarray(tau).reshape(-1)
    fn = _lp.dormqr
    cc = np.asarray(C)
    tr = "T" if trans in ("T", "C") else "N"
    out, work, info = fn(side, tr, a, t,
                         np.asfortranarray(cc.reshape(cc.shape[0], -1)),
                         max(1, 64 * cc.size))
    _check(info, "ormqr")
    _write(C, out.reshape(cc.shape))


def unmqr(A, tau, C, side="L", trans="N"):
    """Complex counterpart of `ormqr` (op in 'N'/'C'); for 'd'
    data the two agree.  In place on C.
    """
    a = _arr(A)
    if a.dtype.kind != "c":
        return ormqr(A, tau, C, side, trans)
    t = np.asarray(tau).reshape(-1)
    cc = np.asarray(C)
    tr = "C" if trans == "C" else "N"
    out, work, info = _lp.zunmqr(side, tr, a, t,
                                 np.asfortranarray(
                                     cc.reshape(cc.shape[0], -1)),
                                 max(1, 64 * cc.size))
    _check(info, "unmqr")
    _write(C, out.reshape(cc.shape))


def orgqr(A, tau):
    """Form the leading columns of Q explicitly from a `geqrf`
    factorization, in place on A.
    """
    a = _arr(A)
    t = np.asarray(tau).reshape(-1)
    fn = _lp.zungqr if a.dtype.kind == "c" else _lp.dorgqr
    q, work, info = fn(a, t)
    _check(info, "orgqr")
    _write(A, q)


ungqr = orgqr


def gelqf(A, tau):
    """LQ factorization A = L*Q.  On exit A holds L (lower
    triangle) and the Householder vectors; tau the coefficients.
    """
    a = _arr(A)
    qf, rf = np.linalg.qr(a.conj().T, mode="complete")
    k = min(a.shape)
    # A = (Q_full R)^H = R^H Q_full^H; rows of Qfull^H beyond k complete
    # the orthogonal basis (needed to apply the full implicit Q)
    A._lq = (rf[:k, :].conj().T, qf.conj().T)   # (L (m,k), Qfull (n,n))
    L, Qf = A._lq
    out = a.copy()
    out[: L.shape[0], : L.shape[1]] = np.tril(L)
    _write(A, out)
    _write(tau, np.zeros(k, dtype=a.dtype))


def ormlq(A, tau, C, side="L", trans="N"):
    """Multiply by Q from a `gelqf` factorization: C := op(Q)*C
    or C*op(Q).  In place on C.
    """
    if not hasattr(A, "_lq"):
        raise ValueError("ormlq requires a gelqf-factored A")
    _, Qf = A._lq
    cc = np.asarray(C)
    op = Qf if trans == "N" else Qf.conj().T
    out = op @ cc if side == "L" else cc @ op
    _write(C, out)


unmlq = ormlq


def orglq(A, tau):
    """Form the leading rows of Q explicitly from a `gelqf`
    factorization, in place on A.
    """
    if not hasattr(A, "_lq"):
        raise ValueError("orglq requires a gelqf-factored A")
    _, Qf = A._lq
    a = _arr(A)
    out = a.copy()
    rows = min(a.shape[0], Qf.shape[0])
    out[:rows, :] = np.asarray(Qf)[:rows, : a.shape[1]]
    _write(A, out)


unglq = orglq


def geqp3(A, jpvt, tau):
    """QR factorization WITH COLUMN PIVOTING: A*P = Q*R.  jpvt
    (integer matrix, length n) on entry marks leading columns (nonzero
    = move to front), on exit holds the 1-based permutation; tau the
    reflector coefficients.  In place on A.
    """
    a = _arr(A)
    fn = _lp.zgeqp3 if a.dtype.kind == "c" else _lp.dgeqp3
    qr, piv, t, work, info = fn(a)
    _check(info, "geqp3")
    _write(A, qr)
    jpvt._a = np.asfortranarray(
        piv.astype(np.int64).reshape(jpvt._a.shape, order="F"))
    _write(tau, t)


# --- eigen / SVD / Schur ---------------------------------------------------

def _sy_eig(A, W, jobz, uplo, driver):
    a = _arr(A)
    herm = a.dtype.kind == "c"
    w, v = np.linalg.eigh(_full_sym(a, uplo, herm))
    _write(W, w)
    if jobz == "V":
        _write(A, v)


def _full_sym(a, uplo, herm):
    if uplo == "L":
        F = np.tril(a) + np.tril(a, -1).conj().T if herm else \
            np.tril(a) + np.tril(a, -1).T
    else:
        F = np.triu(a) + np.triu(a, 1).conj().T if herm else \
            np.triu(a) + np.triu(a, 1).T
    if herm:
        F[np.diag_indices_from(F)] = F.diagonal().real
    return F


def syev(A, W, jobz="N", uplo="L"):
    """Symmetric eigenvalue decomposition: eigenvalues of the uplo
    triangle of A into W (ascending); jobz='V' additionally overwrites
    A with the orthonormal eigenvectors (one per column).
    """
    _sy_eig(A, W, jobz, uplo, "ev")


def syevd(A, W, jobz="N", uplo="L"):
    """Divide-and-conquer variant of `syev` (same interface).
    """
    _sy_eig(A, W, jobz, uplo, "evd")


heev = syev
heevd = syevd


def syevx(A, W, jobz="N", range="A", uplo="L", vl=0.0, vu=0.0, il=1,
          iu=None, Z=None):
    """Selected symmetric eigenvalues/eigenvectors: range='A' for
    all, 'V' for those in (vl, vu], 'I' for index range [il, iu]
    (1-based).  Eigenvalues land in W; with jobz='V' the eigenvectors
    are written to Z (or A).  Returns the number found.
    """
    a = _arr(A)
    herm = a.dtype.kind == "c"
    w, v = np.linalg.eigh(_full_sym(a, uplo, herm))
    n = a.shape[0]
    if range == "A":
        sel = np.arange(n)
    elif range == "V":
        sel = np.where((w > vl) & (w <= vu))[0]
    elif range == "I":
        iu_ = iu if iu is not None else n
        sel = np.arange(il - 1, iu_)
    else:
        raise ValueError("range must be 'A', 'V' or 'I'")
    m = len(sel)
    wv = np.asarray(W).reshape(-1).copy()
    wv[:m] = w[sel]
    _write(W, wv)
    if jobz == "V" and Z is not None:
        zv = np.asarray(Z).copy()
        zv[:, :m] = v[:, sel]
        _write(Z, zv)
    return m


heevx = syevx


def syevr(A, W, jobz="N", range="A", uplo="L", vl=0.0, vu=0.0, il=1,
          iu=None, Z=None):
    """RRR variant of `syevx` (same interface; the reference's
    recommended driver, lapack.c syevr).
    """
    return syevx(A, W, jobz, range, uplo, vl, vu, il, iu, Z)


heevr = syevr


def sygv(A, B, W, itype=1, jobz="N", uplo="L"):
    """Generalized symmetric-definite eigenproblem
    (itype=1: A*x = lambda*B*x).  B must be positive definite; on
    exit W holds the eigenvalues, A the eigenvectors (jobz='V'), and
    B its Cholesky factor.
    """
    a, b = _arr(A), _arr(B)
    herm = a.dtype.kind == "c"
    Af = _full_sym(a, uplo, herm)
    Bf = _full_sym(b, uplo, herm)
    w, v = sla.eigh(Af, Bf, type=itype)
    _write(W, w)
    if jobz == "V":
        _write(A, v)
    # B is overwritten with its Cholesky factor, as LAPACK does
    c = np.linalg.cholesky(Bf) if uplo == "L" else \
        np.linalg.cholesky(Bf).conj().T
    _write(B, c)


hegv = sygv


def gesvd(A, S, jobu="N", jobvt="N", U=None, Vt=None):
    """Singular value decomposition A = U*diag(S)*Vt.  S receives
    the singular values (descending); jobu/jobvt in 'N'/'A'/'S'/'O'
    control whether/where U and Vt are formed (into the optional U /
    Vt arguments).  In place on A for the 'O' variants.
    """
    a = _arr(A)
    u, s, vt = np.linalg.svd(a, full_matrices=(jobu == "A" or
                                               jobvt == "A"))
    sv = np.asarray(S).reshape(-1).copy()
    sv[: len(s)] = s
    _write(S, sv)
    if jobu in ("A", "S") and U is not None:
        uu = np.asarray(U).copy()
        uu[:, : u.shape[1]] = u[:, : uu.shape[1]]
        _write(U, uu)
    if jobvt in ("A", "S") and Vt is not None:
        vv = np.asarray(Vt).copy()
        vv[: vt.shape[0], :] = vt[: vv.shape[0], :]
        _write(Vt, vv)
    if jobu == "O":
        _write(A, u[:, : min(a.shape)])
    elif jobvt == "O":
        _write(A, vt[: min(a.shape), :])


gesdd = gesvd


def gees(A, w, V=None, select=None):
    """Schur decomposition A = V*T*V^H: on exit A holds the
    (quasi-)triangular Schur form T, w the eigenvalues, and V (if
    given) the Schur vectors.  An optional `select` callable orders
    selected eigenvalues to the top-left; returns the number
    selected.
    """
    a = _arr(A)
    if a.dtype.kind == "c":
        if select is not None:
            T, Z, sdim = sla.schur(a, output="complex", sort=select)
        else:
            T, Z = sla.schur(a, output="complex")
            sdim = 0
    else:
        if select is not None:
            T, Z, sdim = sla.schur(a, output="real", sort=select)
        else:
            T, Z = sla.schur(a, output="real")
            sdim = 0
    _write(A, T)
    ev = sla.eigvals(T)
    wv = np.asarray(w).reshape(-1).astype(np.complex128)
    wv[: len(ev)] = ev
    _write(w, wv)
    if V is not None:
        _write(V, Z)
    return int(sdim) if not isinstance(sdim, np.ndarray) else 0


def gges(A, B, a=None, b=None, Vl=None, Vr=None, select=None):
    """Generalized Schur decomposition of the pencil (A, B):
    A = Vl*S*Vr^H, B = Vl*T*Vr^H.  a and b (if given) receive the
    generalized eigenvalue numerators/denominators; Vl/Vr the left/
    right Schur vectors; `select` orders selected pairs first.
    Returns the number selected.
    """
    Aa, Bb = _arr(A), _arr(B)
    out = sla.qz(Aa, Bb, output="complex"
                 if Aa.dtype.kind == "c" else "real")
    S, T, Q, Z = out
    _write(A, S)
    _write(B, T)
    if a is not None or b is not None:
        n = S.shape[0]
        alpha = np.zeros(n, np.complex128)
        beta = np.zeros(n, np.complex128)
        i = 0
        while i < n:
            if Aa.dtype.kind != "c" and i + 1 < n and S[i + 1, i] != 0:
                # 2x2 block: complex conjugate generalized eigenpair
                lam = sla.eigvals(S[i:i + 2, i:i + 2],
                                  T[i:i + 2, i:i + 2])
                alpha[i:i + 2] = lam
                beta[i:i + 2] = 1.0
                i += 2
            else:
                alpha[i] = S[i, i]
                beta[i] = T[i, i]
                i += 1
    if a is not None:
        av = np.asarray(a).reshape(-1).astype(np.complex128)
        av[: len(alpha)] = alpha
        _write(a, av)
    if b is not None:
        bv = np.asarray(b).reshape(-1).astype(np.complex128)
        bv[: len(beta)] = beta.real if bv.dtype.kind != "c" else beta
        _write(b, bv)
    if Vl is not None:
        _write(Vl, Q)
    if Vr is not None:
        _write(Vr, Z)
    return 0


# --- auxiliary -------------------------------------------------------------

def lacpy(A, B, uplo=None):
    """Copy all of A (uplo=None) or its uplo triangle into B, in
    place on B.
    """
    a = _arr(A)
    bv = np.asarray(B).copy()
    if uplo == "L":
        idx = np.tril_indices(min(a.shape[0], bv.shape[0]))
        bv[idx] = a[idx]
    elif uplo == "U":
        idx = np.triu_indices(min(a.shape[0], bv.shape[0]))
        bv[idx] = a[idx]
    else:
        bv[: a.shape[0], : a.shape[1]] = a
    _write(B, bv)


def larfg(alpha, x):
    """Generate an elementary Householder reflector H with
    H*[alpha; x] = [beta; 0]: alpha (1x1 matrix) receives beta, x the
    reflector vector v; returns tau.
    """
    a = np.asarray(alpha).reshape(-1)[0]
    xv = np.asarray(x).reshape(-1)
    fn = _lp.zlarfg if np.iscomplexobj(xv) or np.iscomplexobj(a) \
        else _lp.dlarfg
    res = fn(len(xv) + 1, a, xv)
    al, v, tau = res
    _write(x, v)
    _write(alpha, np.asarray([al]))
    return tau


def larfx(V, tau, C, side="L"):
    """Apply an elementary reflector H = I - tau*V*V^H to C from
    the given side, in place on C.
    """
    v = np.asarray(V).reshape(-1, 1)
    cc = np.asarray(C)
    H = np.eye(len(v)) - tau * (v @ v.conj().T)
    out = H @ cc if side == "L" else cc @ H
    _write(C, out)
