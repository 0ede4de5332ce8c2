"""kvxopt_tpu_torch.blas and .lapack against kvxopt_tpu's: the 19 cases of
tests/test_blas_lapack.py run on each package, each on that package's
own matrix type built from the same numpy arrays (each blas rejects the
other's matrix).  A case returns every buffer it wrote, every pivot
vector and every return value; the two packages' agree to 1e-12 (the
same numpy and scipy calls on both sides), and each package passes the
case's own oracle checks."""

import types

import numpy as np
import pytest
import scipy.linalg as sla

import kvxopt_tpu as jpkg
import kvxopt_tpu_torch as tpkg
from kvxopt_tpu import blas as jblas, lapack as jlapack
from kvxopt_tpu_torch import blas as tblas, lapack as tlapack

PKGS = {
    "jax": types.SimpleNamespace(matrix=jpkg.matrix, blas=jblas,
                                 lapack=jlapack),
    "torch": types.SimpleNamespace(matrix=tpkg.matrix, blas=tblas,
                                   lapack=tlapack),
}


def arr(x):
    return np.asarray(x).copy()


def randn(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n))


def c_level1(k):
    blas, matrix = k.blas, k.matrix
    x = matrix([1.0, -3.0, 2.0])
    y = matrix([1.0, 1.0, 1.0])
    out = [blas.nrm2(x), blas.asum(x), blas.iamax(x), blas.dot(x, y)]
    assert out[0] == pytest.approx(np.sqrt(14)) and out[2] == 1
    blas.axpy(x, y, alpha=2.0)
    out.append(arr(y))
    blas.scal(0.5, y)
    out.append(arr(y))
    np.testing.assert_allclose(arr(y).reshape(-1), [1.5, -2.5, 2.5])
    z = matrix([0.0, 0.0, 0.0])
    blas.copy(x, z)
    blas.swap(x, z)
    return out + [arr(x), arr(z)]


def c_iamax_inc_offset(k):
    x = k.matrix([1.0, 9.0, 2.0, -10.0, 3.0, 4.0])
    out = [k.blas.iamax(x), k.blas.iamax(x, n=3, inc=2, offset=0),
           k.blas.iamax(x, n=3, inc=2, offset=1),
           k.blas.iamax(x, n=2, inc=1, offset=1)]
    assert out == [3, 2, 1, 0]
    return out


def c_dot_complex_conjugation(k):
    x = k.matrix([1 + 1j, 2.0 + 0j])
    y = k.matrix([1 + 0j, 1 + 1j])
    out = [k.blas.dot(x, y), k.blas.dotu(x, y)]
    assert out[0] == pytest.approx((1 - 1j) + 2 * (1 + 1j))
    return out


def c_gemv_gemm(k):
    matrix, blas = k.matrix, k.blas
    A, x = matrix(randn(3, 4, 1)), matrix(randn(4, 1, 2))
    y = matrix(0.0, (3, 1))
    blas.gemv(A, x, y, alpha=2.0)
    np.testing.assert_allclose(arr(y)[:, 0], 2.0 * arr(A) @ arr(x)[:, 0])
    yt = matrix(0.0, (4, 1))
    blas.gemv(A, matrix(arr(y)), yt, trans="T")
    C = matrix(0.0, (3, 2))
    blas.gemm(A, matrix(randn(4, 2, 3)), C)
    return [arr(y), arr(yt), arr(C)]


def c_gemm_offsets(k):
    matrix, blas = k.matrix, k.blas
    A, B = matrix(randn(4, 4, 4)), matrix(randn(4, 4, 5))
    C = matrix(0.0, (2, 2))
    blas.gemm(A, B, C, m=2, n=2, k=2, ldA=4, ldB=4, ldC=2)
    out = [arr(C)]
    blas.gemm(A, B, C, m=2, n=2, k=2, ldA=4, ldB=4, ldC=2, offsetA=10,
              offsetB=10)
    np.testing.assert_allclose(arr(C), arr(A)[2:, 2:] @ arr(B)[2:, 2:])
    return out + [arr(C)]


def c_syrk_trsm(k):
    matrix, blas = k.matrix, k.blas
    A = matrix(randn(3, 5, 6))
    C = matrix(0.0, (3, 3))
    blas.syrk(A, C)
    L = matrix(np.tril(randn(3, 3, 7)) + 3 * np.eye(3))
    B = matrix(randn(3, 2, 8))
    blas.trsm(L, B)
    np.testing.assert_allclose(arr(L) @ arr(B), randn(3, 2, 8), atol=1e-12)
    return [arr(C), arr(B)]


def c_symv_her(k):
    matrix, blas = k.matrix, k.blas
    A, x = matrix(randn(4, 4, 9)), matrix(randn(4, 1, 10))
    y = matrix(0.0, (4, 1))
    blas.symv(A, x, y)
    Z = matrix(np.zeros((3, 3), dtype=complex))
    blas.her(matrix(np.array([1 + 1j, 2.0, 1j])), Z, alpha=2.0)
    return [arr(y), arr(Z)]


def c_gesv_getrf_getrs(k):
    matrix, lapack = k.matrix, k.lapack
    A0, B0 = randn(5, 5, 11), randn(5, 2, 12)
    A, B = matrix(A0), matrix(B0)
    ipiv = matrix(0, (5, 1), tc="i")
    lapack.gesv(A, B, ipiv)
    np.testing.assert_allclose(A0 @ arr(B), B0, atol=1e-10)
    A2, ipiv2 = matrix(A0), matrix(0, (5, 1), tc="i")
    lapack.getrf(A2, ipiv2)
    out = [arr(A), arr(B), arr(ipiv), arr(A2), arr(ipiv2)]
    B2 = matrix(B0)
    lapack.getrs(A2, ipiv2, B2)
    lapack.getri(A2, ipiv2)
    return out + [arr(B2), arr(A2)]


def c_potrf_posv(k):
    matrix, lapack = k.matrix, k.lapack
    A = randn(5, 5, 13)
    S0 = A @ A.T + 5 * np.eye(5)
    S, B = matrix(S0), matrix(randn(5, 1, 14))
    lapack.posv(S, B)
    np.testing.assert_allclose(S0 @ arr(B), randn(5, 1, 14), atol=1e-10)
    with pytest.raises(ArithmeticError):
        lapack.potrf(matrix(np.array([[1.0, 0.0], [0.0, -1.0]])))
    return [arr(S), arr(B)]


def c_sytrf_sysv(k):
    rng = np.random.default_rng(15)
    A = rng.standard_normal((6, 6))
    S, B = k.matrix(A + A.T), k.matrix(rng.standard_normal((6, 1)))
    ipiv = k.matrix(0, (6, 1), tc="i")
    k.lapack.sysv(S, B, ipiv)
    return [arr(S), arr(B), arr(ipiv)]


def c_syev_family(k):
    matrix, lapack = k.matrix, k.lapack
    A = np.random.default_rng(16).standard_normal((5, 5))
    S = A + A.T
    out = []
    for driver in (lapack.syev, lapack.syevd):
        M, W = matrix(S.copy()), matrix(0.0, (5, 1))
        driver(M, W, jobz="V")
        np.testing.assert_allclose(arr(W)[:, 0], np.linalg.eigvalsh(S),
                                   atol=1e-10)
        out += [arr(M), arr(W)]
    M, W, Z = matrix(S.copy()), matrix(0.0, (5, 1)), matrix(0.0, (5, 2))
    m = lapack.syevx(M, W, jobz="V", range="I", il=1, iu=2, Z=Z)
    assert m == 2
    return out + [m, arr(W), arr(Z)]


def c_sygv(k):
    rng = np.random.default_rng(17)
    A = rng.standard_normal((4, 4))
    B = rng.standard_normal((4, 4))
    Ma, Mb = k.matrix(A + A.T), k.matrix(B @ B.T + 4 * np.eye(4))
    W = k.matrix(0.0, (4, 1))
    k.lapack.sygv(Ma, Mb, W, jobz="V")
    np.testing.assert_allclose(
        arr(W)[:, 0], sla.eigh(A + A.T, B @ B.T + 4 * np.eye(4),
                               eigvals_only=True), atol=1e-9)
    return [arr(Ma), arr(Mb), arr(W)]


def c_gesvd(k):
    matrix = k.matrix
    A = matrix(randn(4, 3, 18))
    S, U, Vt = matrix(0.0, (3, 1)), matrix(0.0, (4, 4)), matrix(0.0, (3, 3))
    k.lapack.gesvd(A, S, jobu="A", jobvt="A", U=U, Vt=Vt)
    rec = arr(U)[:, :3] * arr(S)[:, 0][None, :] @ arr(Vt)
    np.testing.assert_allclose(rec, randn(4, 3, 18), atol=1e-9)
    return [arr(A), arr(S), arr(U), arr(Vt)]


def c_geqrf_orgqr_ormqr(k):
    matrix, lapack = k.matrix, k.lapack
    A, tau = matrix(randn(5, 3, 19)), matrix(0.0, (3, 1))
    lapack.geqrf(A, tau)
    Q = matrix(arr(A))
    lapack.orgqr(Q, tau)
    np.testing.assert_allclose(arr(Q)[:, :3] @ np.triu(arr(A))[:3, :],
                               randn(5, 3, 19), atol=1e-10)
    C = matrix(np.eye(5))
    lapack.ormqr(matrix(arr(A)), tau, C)
    return [arr(A), arr(tau), arr(Q), arr(C)]


def c_gels(k):
    B = k.matrix(randn(6, 1, 21))
    k.lapack.gels(k.matrix(randn(6, 3, 20)), B)
    return [arr(B)]


def c_trtrs_trtri(k):
    L0 = np.tril(randn(4, 4, 22)) + 4 * np.eye(4)
    L, B = k.matrix(L0), k.matrix(randn(4, 1, 23))
    k.lapack.trtrs(L, B)
    out = [arr(B)]
    k.lapack.trtri(L)
    np.testing.assert_allclose(arr(L) @ L0, np.eye(4), atol=1e-10)
    return out + [arr(L)]


def c_gtsv_tridiag(k):
    n, rng = 6, np.random.default_rng(24)
    dl, d = rng.standard_normal(n - 1), rng.standard_normal(n) + 5.0
    du, b = rng.standard_normal(n - 1), rng.standard_normal(n)
    B = k.matrix(b.copy())
    k.lapack.gtsv(k.matrix(dl.copy()), k.matrix(d.copy()),
                  k.matrix(du.copy()), B)
    T = np.diag(d) + np.diag(dl, -1) + np.diag(du, 1)
    np.testing.assert_allclose(T @ arr(B)[:, 0], b, atol=1e-10)
    return [arr(B)]


def c_gees_schur(k):
    matrix = k.matrix
    A, w, V = matrix(randn(4, 4, 25)), matrix(0.0 + 0j, (4, 1)), \
        matrix(0.0, (4, 4))
    out = k.lapack.gees(A, w, V)
    np.testing.assert_allclose(arr(V) @ arr(A) @ arr(V).T, randn(4, 4, 25),
                               atol=1e-9)
    return [out, arr(A), arr(w), arr(V)]


def c_lacpy(k):
    A, B = k.matrix(randn(3, 3, 26)), k.matrix(0.0, (3, 3))
    k.lapack.lacpy(A, B, uplo="L")
    return [arr(B)]


CASES = {f.__name__[2:]: f for f in (
    c_level1, c_iamax_inc_offset, c_dot_complex_conjugation, c_gemv_gemm,
    c_gemm_offsets, c_syrk_trsm, c_symv_her, c_gesv_getrf_getrs,
    c_potrf_posv, c_sytrf_sysv, c_syev_family, c_sygv, c_gesvd,
    c_geqrf_orgqr_ormqr, c_gels, c_trtrs_trtri, c_gtsv_tridiag,
    c_gees_schur, c_lacpy)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(name):
    outs = {p: CASES[name](k) for p, k in PKGS.items()}
    assert len(outs["jax"]) == len(outs["torch"])
    for a, b in zip(outs["torch"], outs["jax"]):
        if a is None or b is None:
            assert a is b
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max(initial=0.0) <= 1e-12 * (
            1.0 + np.abs(b).max(initial=0.0))


def test_matrix_types_do_not_mix():
    with pytest.raises(TypeError):
        tblas.nrm2(jpkg.matrix([1.0, 2.0]))
    with pytest.raises(TypeError):
        jblas.nrm2(tpkg.matrix([1.0, 2.0]))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_potrf_not_spd_raises(pkg):
    k = PKGS[pkg]
    with pytest.raises(ArithmeticError):
        k.lapack.potrf(k.matrix(np.array([[1.0, 2.0], [2.0, 1.0]])))
