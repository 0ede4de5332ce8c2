"""The port's problems of kvxopt_tpu_torch.examples.book.examples3 (l2ac,
logreg, penalties, cvxfit, smoothrec) against the JAX package's, as
tests/test_book_examples3.py solves them, on the CPU.

The same numpy data goes through the port (config.using_device("cpu"))
and the JAX package (x64, the JAX test's model restated on that data);
the port is held to JAX's result (status, iterations within 1, x within
1e-6 (1 + |x|), the primal objective within 1e-7 (1 + |obj|)) and to the
JAX test's own oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.examples.book import examples3 as ex

from .torch_example_parity import (close_obj, close_x, compare, host,
                                   recorded_lp)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


# ---------------------------------------------------------------------------
# l2ac: the JAX test's dense oracle and its inversion-lemma kktsolver

def jax_l2ac(data):
    A_np, b_np = data
    m, n = A_np.shape
    A, b = jnp.asarray(A_np), jnp.asarray(b_np)

    def F_dense(x=None, z=None):
        if x is None:
            return 0, jnp.zeros(n)
        x = jnp.asarray(x)
        if float(jnp.max(jnp.abs(x))) >= 1.0:
            return None
        r = A @ x - b
        w = x ** 2
        f = jnp.array([0.5 * jnp.dot(r, r) - jnp.sum(jnp.log(1 - w))])
        grad = (A.T @ r + 2 * x / (1 - w)).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, z[0] * (A.T @ A + jnp.diag(2 * (1 + w) /
                                                  (1 - w) ** 2))

    state = {}

    def F_rec(x=None, z=None):
        if x is None:
            return F_dense()
        out = F_dense(x) if z is None else F_dense(x, z)
        if out is None or z is None:
            return out
        state["x"], state["z0"] = jnp.asarray(x), float(z[0])
        f, grad, _ = out
        w = jnp.asarray(x) ** 2
        d = 2 * z[0] * (1 + w) / (1 - w) ** 2
        return f, grad, lambda u: z[0] * (A.T @ (A @ u)) + d * u

    def kktsolver(W, H=None, Df=None):
        x, z0 = state["x"], state["z0"]
        w = x ** 2
        dsi = 1.0 / jnp.sqrt(2.0 * (1 + w) / (1 - w) ** 2)
        Asc = A * dsi[None, :]
        S = jnp.eye(m) + Asc @ Asc.T
        d0 = W.d[0]
        g = A.T @ (A @ x - b) + 2 * x / (1 - w)

        def solve(bx, by, bz):
            bx_x, bx_t = bx[:n], bx[n]
            t_ = dsi * (bx_x + bx_t * g) / z0
            v = jnp.linalg.solve(S, Asc @ t_)
            ux = dsi * (t_ - Asc.T @ v)
            ut = jnp.dot(g, ux) - bz[0] + d0 * d0 * bx_t
            return (jnp.concatenate([ux, ut[None]]), by,
                    jnp.asarray([-bx_t]))
        return solve

    return jsolvers.cp(F_dense), jsolvers.cp(F_rec, kktsolver=kktsolver)


def test_l2ac_custom_kkt_inversion_lemma():
    data = ex.l2ac_data()
    dense, custom = ex.l2ac(data)
    jdense, jcustom = jax_l2ac(data)
    assert dense["status"] == custom["status"] == "optimal"
    compare(dense, jdense)
    compare(custom, jcustom)
    np.testing.assert_allclose(host(custom["x"]), host(dense["x"]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# logreg

def jax_logreg(data):
    Aj, cj = jnp.asarray(data[0]), jnp.asarray(data[1])

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.zeros(2)
        x = jnp.asarray(x)
        w = jnp.exp(Aj @ x)
        f = jnp.array([jnp.dot(cj, x) + jnp.sum(jnp.log1p(w))])
        p = w / (1 + w)
        grad = (cj + Aj.T @ p).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, z[0] * (Aj.T * (p * (1 - p))[None, :]) @ Aj

    return jsolvers.cp(F)


def test_logreg_cp():
    from scipy.optimize import minimize
    data = ex.logreg_data()
    A, c = data
    sol = ex.logreg(data)
    assert sol["status"] == "optimal"
    compare(sol, jax_logreg(data))
    oracle = minimize(lambda x: c @ x + np.sum(np.log1p(np.exp(A @ x))),
                      np.zeros(2), method="BFGS", options={"gtol": 1e-10})
    np.testing.assert_allclose(host(sol["x"]), oracle.x, atol=1e-4)


# ---------------------------------------------------------------------------
# penalties: the two DSL problems and the barrier cp

def jax_penalties(data, b_barrier):
    from kvxopt_tpu.models.modeling import op, variable
    from kvxopt_tpu.models.modeling import max as mmax
    from kvxopt_tpu.models.modeling import sum as msum
    A, b = data
    n = A.shape[1]
    x1 = variable(n)
    p1 = op(msum(abs(A * x1 + b)))
    p1.solve()
    x2 = variable(n)
    p2 = op(msum(mmax(abs(A * x2 + b) - 0.5, 0.0)))
    p2.solve()
    Aj, bj = jnp.asarray(A), jnp.asarray(b_barrier)

    def F(x=None, z=None):
        if x is None:
            return 0, jnp.zeros(n)
        y = Aj @ jnp.asarray(x) + bj
        if float(jnp.max(jnp.abs(y))) >= 1.0:
            return None
        f = jnp.array([-jnp.sum(jnp.log(1.0 - y ** 2))])
        grad = (2.0 * Aj.T @ (y / (1 - y ** 2))).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, (Aj.T * (2.0 * z[0] * (1 + y ** 2) /
                                 (1 - y ** 2) ** 2)[None, :]) @ Aj

    return dict(l1=(p1, x1), deadzone=(p2, x2), barrier=jsolvers.cp(F))


def test_penalties_dsl_and_logbarrier():
    data = ex.penalties_data()
    A, b = data
    n = A.shape[1]
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        out = ex.penalties(data)
        ref = jax_penalties(data, out["b_barrier"])
    np.testing.assert_allclose(out["b_barrier"],
                               b * (0.9 / np.abs(b).max()))
    for k, key in enumerate(("l1", "deadzone")):
        (p, x), (jp, jx) = out[key], ref[key]
        assert p.status == jp.status == "optimal"
        compare(lps[k], jlps[k])
        close_x(np.asarray(x.value), np.asarray(jx.value))
        close_obj(np.asarray(p.objective.value()).ravel()[0],
                  np.asarray(jp.objective.value()).ravel()[0])
    r1 = A @ np.asarray(out["l1"][1].value).reshape(-1) + b
    assert np.sum(np.abs(r1) < 1e-6) >= n - 1
    r2 = A @ np.asarray(out["deadzone"][1].value).reshape(-1) + b
    assert np.sum(np.abs(r2) <= 0.5 + 1e-6) >= n - 1
    sol = out["barrier"]
    assert sol["status"] == "optimal"
    compare(sol, ref["barrier"])
    assert np.all(np.abs(A @ host(sol["x"]) + out["b_barrier"]) < 1.0)


# ---------------------------------------------------------------------------
# cvxfit and smoothrec

def test_cvxfit_qp():
    from scipy.optimize import minimize
    data = ex.cvxfit_data()
    P, q, G, h = ex.cvxfit_problem(data)
    sol = ex.cvxfit(data)
    assert sol["status"] == "optimal"
    compare(sol, jsolvers.qp(P, q, G, h))
    yhat, y = host(sol["x"]), data[1]
    assert np.all(G @ yhat <= 1e-7)
    oracle = minimize(lambda v: np.sum((v - y) ** 2), y, method="SLSQP",
                      constraints=[{"type": "ineq", "fun": lambda v: -G @ v}],
                      options={"maxiter": 500, "ftol": 1e-12})
    assert oracle.success
    np.testing.assert_allclose(np.sum((yhat - y) ** 2), oracle.fun,
                               atol=1e-6)


def test_smoothrec_ptsv():
    from kvxopt_tpu import lapack, matrix
    data = ex.smoothrec_data()
    corr, delta = data
    n = len(corr)
    x = ex.smoothrec(data)
    d = 1.0 + delta * np.concatenate([[1.0], 2.0 * np.ones(n - 2), [1.0]])
    xm = matrix(corr.reshape(-1, 1).copy())
    lapack.ptsv(matrix(d.copy()), matrix(-delta * np.ones(n - 1)), xm)
    np.testing.assert_allclose(x, np.asarray(xm).reshape(-1), rtol=1e-12,
                               atol=1e-14)
    D = np.diff(np.eye(n), axis=0)
    xref = np.linalg.solve(np.eye(n) + delta * D.T @ D, corr)
    np.testing.assert_allclose(x, xref, atol=1e-9)
