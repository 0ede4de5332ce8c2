"""The port's cvxbook problems of kvxopt_tpu_torch.examples.book.examples1
(huber, tv, basispursuit, regsel, maxent, expdesign, covsel) against the
JAX package's, as tests/test_book_examples.py solves them, on the CPU.

Each case makes the problem's numpy data once (<name>_data, seeded as
the JAX test seeds it), solves it through the port under
config.using_device("cpu") and through the JAX package (x64, on the
CPU), the JAX side restating the JAX test's model on that data, and
holds the port to the JAX result (status, iterations within 1, x within
1e-6 (1 + |x|), the primal objective within 1e-7 (1 + |obj|)) and to the
JAX test's own oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch.examples.book import examples1 as ex

from .torch_example_parity import close_x, compare, host


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


# ---------------------------------------------------------------------------
# The QPs: the JAX side is jax's qp on the same matrices

def test_huber_robust_regression():
    from scipy.optimize import minimize
    data = ex.huber_data()
    sol = ex.huber(data)
    ref = jsolvers.qp(*ex.huber_problem(data))
    assert sol["status"] == "optimal"
    compare(sol, ref)
    A, v = data

    def huber_loss(x):
        r = A @ x - v
        a = np.abs(r)
        return np.sum(np.where(a <= 1.0, r * r, 2 * a - 1.0))

    oracle = minimize(huber_loss, np.zeros(2), method="Nelder-Mead",
                      options={"xatol": 1e-10, "fatol": 1e-12,
                               "maxiter": 5000})
    np.testing.assert_allclose(host(sol["x"])[:2], oracle.x, atol=1e-4)


def test_basispursuit_lasso():
    data = ex.basispursuit_data()
    sol = ex.basispursuit(data)
    compare(sol, jsolvers.qp(*ex.basispursuit_problem(data)))
    A, y = data
    K = A.shape[1]
    x = host(sol["x"])[:K]
    g = 2.0 * A.T @ (A @ x - y)
    assert np.all(np.abs(g) <= 1.0 + 1e-5)
    nz = np.abs(x) > 1e-6
    np.testing.assert_allclose(g[nz], -np.sign(x[nz]), atol=1e-5)


def test_regsel_tradeoff():
    data = ex.regsel_data()
    sols = ex.regsel(data)
    probs = ex.regsel_problems(data)
    A, b = data
    n = A.shape[1]
    res = []
    for sol, (alpha, prob) in zip(sols, probs):
        assert sol["status"] == "optimal"
        compare(sol, jsolvers.qp(*prob))
        x = host(sol["x"])[:n]
        assert np.abs(x).sum() <= alpha + 1e-6
        res.append(np.linalg.norm(A @ x - b))
    assert all(res[i] >= res[i + 1] - 1e-8 for i in range(len(res) - 1))
    xln = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(res[-1], np.linalg.norm(A @ xln - b),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# tv: operator-form P and G with the tridiagonal custom kktsolver; the
# JAX side is the JAX test's operators and kktsolver

def jax_tv(data):
    corr, delta = data
    n = len(corr)
    nv = 2 * n - 1
    qv = np.concatenate([-corr, delta * np.ones(n - 1)])

    def Pop(u):
        return jnp.zeros_like(u).at[:n].set(u[:n])

    def Gop(u, trans=False):
        if not trans:
            y = u[1:n] - u[:n - 1]
            return jnp.concatenate([y - u[n:], -y - u[n:]])
        y = u[:n - 1] - u[n - 1:]
        v = jnp.zeros(nv, dtype=u.dtype)
        v = v.at[:n - 1].add(-y).at[1:n].add(y)
        return v.at[n:].add(-(u[:n - 1] + u[n - 1:]))

    def kktsolver(W, **kw):
        di = 1.0 / W.d
        d1, d2 = di[:n - 1] ** 2, di[n - 1:] ** 2
        d = 4.0 * d1 * d2 / (d1 + d2)
        S = jnp.diag(jnp.ones(n).at[:n - 1].add(d).at[1:].add(d)) + \
            jnp.diag(-d, 1) + jnp.diag(-d, -1)

        def Dtmul(y):
            return jnp.zeros(n, dtype=y.dtype).at[:-1].add(-y).at[1:].add(y)

        def solve(bx, by, bz):
            y = ((d1 - d2) / (d1 + d2)) * bx[n:] + \
                0.5 * d * (bz[:n - 1] - bz[n - 1:])
            x1 = jnp.linalg.solve(S, bx[:n] + Dtmul(y))
            Dx = x1[1:] - x1[:-1]
            x2 = (bx[n:] - d1 * bz[:n - 1] - d2 * bz[n - 1:] +
                  (d1 - d2) * Dx) / (d1 + d2)
            return (jnp.concatenate([x1, x2]), jnp.zeros(0, dtype=bx.dtype),
                    jnp.concatenate([d1 * (Dx - x2 - bz[:n - 1]),
                                     d2 * (-Dx - x2 - bz[n - 1:])]))
        return solve

    return jsolvers.coneqp(Pop, qv, Gop, np.zeros(2 * (n - 1)),
                           {"l": 2 * (n - 1)}, kktsolver=kktsolver)


def test_tv_smoothing_custom_kkt():
    data = ex.tv_data()
    n = len(data[0])
    sol = ex.tv(data)
    assert sol["status"] == "optimal"
    compare(sol, jax_tv(data))
    # the JAX test's oracle: the same QP through dense matrices
    dense = jsolvers.qp(*ex.tv_problem(data))
    np.testing.assert_allclose(host(sol["x"])[:n], host(dense["x"])[:n],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# maxent and expdesign: cp with the JAX test's oracles restated

def jax_maxent(data):
    G, h, A, b = data
    n = G.shape[1]

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.full((n,), 1.0)
        if float(jnp.min(x)) <= 0.0:
            return None
        f = jnp.array([jnp.dot(x, jnp.log(x))])
        grad = (1.0 + jnp.log(x)).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, jnp.diag(z[0] / x)

    return jsolvers.cp(F, G, h, A=A, b=b)


def test_maxent_distribution():
    from scipy.optimize import minimize
    data = ex.maxent_data()
    G, h, _, _ = data
    n = G.shape[1]
    sol = ex.maxent(data)
    assert sol["status"] == "optimal"
    compare(sol, jax_maxent(data))
    p = host(sol["x"])
    assert np.all(p > 0) and abs(p.sum() - 1.0) < 1e-6
    assert np.all(G @ p <= h + 1e-6)
    oracle = minimize(
        lambda x: np.sum(x * np.log(np.maximum(x, 1e-300))),
        np.full(n, 1.0 / n), method="SLSQP",
        jac=lambda x: 1.0 + np.log(np.maximum(x, 1e-300)),
        bounds=[(1e-9, 1.0)] * n,
        constraints=[{"type": "eq", "fun": lambda x: x.sum() - 1.0},
                     {"type": "ineq", "fun": lambda x: h - G @ x}],
        options={"maxiter": 500, "ftol": 1e-12})
    assert oracle.success
    assert abs(float(sol["primal objective"]) - oracle.fun) < 1e-5


def jax_expdesign(V):
    n = V.shape[1]
    Vj = jnp.asarray(V)

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.full((n,), 1.0)
        X = (Vj * x[None, :]) @ Vj.T
        if float(jnp.linalg.det(X)) <= 0:
            return None
        Xi = jnp.linalg.inv(X)
        f = jnp.array([-jnp.log(jnp.linalg.det(X))])
        gradf = -jnp.sum(Vj * (Xi @ Vj), axis=0).reshape(1, -1)
        if z is None:
            return f, gradf
        return f, gradf, z[0] * (Vj.T @ Xi @ Vj) ** 2

    return jsolvers.cp(F, -np.eye(n), np.zeros(n), A=np.ones((1, n)),
                       b=np.array([1.0]))


def test_expdesign_d_optimal():
    V = ex.expdesign_data()
    sol = ex.expdesign(V)
    assert sol["status"] == "optimal"
    compare(sol, jax_expdesign(V))
    x = host(sol["x"])
    assert np.all(x >= -1e-7) and abs(x.sum() - 1.0) < 1e-6
    Xi = np.linalg.inv((V * x[None, :]) @ V.T)
    w = np.sum(V * (Xi @ V), axis=0)
    assert np.max(w) <= 2.0 + 1e-4          # duality: w_i <= dim
    np.testing.assert_allclose(w[x > 1e-5], 2.0, atol=1e-3)


# ---------------------------------------------------------------------------
# covsel: the Newton loop over cholmod; the JAX side is the JAX test's
# loop over kvxopt_tpu's cholmod on the same data

def jax_covsel(data, maxiters=60):
    import scipy.sparse as sp
    from kvxopt_tpu import cholmod
    from kvxopt_tpu.base import matrix, spmatrix
    Yd, Ii2, Jj2 = data["Y"], data["rows"], data["cols"]
    Iis, Jjs = data["lower"]
    n, nc = Yd.shape[0], len(data["lower"][0])
    Bs = np.zeros((nc, n, n))
    Bs[np.arange(nc), Iis, Jjs] = 1.0
    Bs[np.arange(nc), Jjs, Iis] = 1.0
    F = cholmod.symbolic(spmatrix._from_csc(sp.csc_matrix(
        (np.where(Ii2 == Jj2, 1.0, 1e-8), (Ii2, Jj2)), shape=(n, n))))

    def numeric(Kd):
        cholmod.numeric(spmatrix._from_csc(sp.csc_matrix(
            (Kd[Ii2, Jj2], (Ii2, Jj2)), shape=(n, n))), F)

    Kcur = np.eye(n)
    for it in range(maxiters):
        numeric(Kcur)
        Kinv_m = matrix(np.eye(n))
        cholmod.solve(F, Kinv_m)
        Kinv = np.asarray(Kinv_m)
        grad = np.einsum("kij,ij->k", Bs, Yd - Kinv)
        T = np.einsum("ip,kpq,qj->kij", Kinv, Bs, Kinv)
        hess = np.einsum("kij,lij->kl", Bs, T)
        v = np.linalg.solve(hess + 1e-13 * np.eye(nc), -grad)
        sqntdecr = -grad @ v
        if sqntdecr < 1e-12:
            break
        dK = np.einsum("k,kij->ij", v, Bs)
        f = (Kcur * Yd).sum() - 2.0 * np.log(
            np.asarray(cholmod.diag(F))).sum()
        s = 1.0
        for _ in range(50):
            Kn = Kcur + s * dK
            try:
                numeric(Kn)
            except ArithmeticError:
                s *= 0.5
                continue
            fn = (Kn * Yd).sum() - 2.0 * np.log(
                np.asarray(cholmod.diag(F))).sum()
            if fn < f - 0.01 * s * sqntdecr:
                break
            s *= 0.5
        Kcur = Kcur + s * dK
    return dict(K=Kcur, iterations=it, decrement=float(sqntdecr))


def test_covsel_sparse_newton():
    data = ex.covsel_data()
    out = ex.covsel(data)
    ref = jax_covsel(data)
    assert out["iterations"] == ref["iterations"]
    close_x(out["K"], ref["K"])
    assert out["decrement"] < 1e-10
    Kinv = np.linalg.inv(out["K"])
    rows, cols = data["rows"], data["cols"]
    np.testing.assert_allclose(Kinv[rows, cols], data["Y"][rows, cols],
                               atol=1e-6)
    assert np.linalg.eigvalsh(out["K"]).min() > 0
