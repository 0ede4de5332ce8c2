"""The port's cvxbook problems of kvxopt_tpu_torch.examples.book.examples2
(linsep, chernoff, placement, centers) against the JAX package's, as
tests/test_book_examples2.py solves them, on the CPU.

The same numpy data goes through the port (config.using_device("cpu"))
and the JAX package (x64, the JAX test's model restated on that data);
the port is held to JAX's result (status, iterations within 1, x within
1e-6 (1 + |x|), the primal objective within 1e-7 (1 + |obj|)) and to the
JAX test's own oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.examples.book import examples2 as ex

from .torch_example_parity import (close_obj, close_x, compare, host,
                                   recorded_lp)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def jax_linsep(data):
    from kvxopt_tpu.models.modeling import op, variable
    from kvxopt_tpu.models.modeling import sum as msum
    X, Y = data
    a, b = variable(2), variable()
    u, v = variable(X.shape[1]), variable(Y.shape[1])
    prob = op(msum(u) + msum(v),
              [X.T * a - b >= 1 - u, Y.T * a - b <= -1 + v, u >= 0, v >= 0])
    prob.solve()
    return prob, a, b


def test_linsep_lp_discrimination():
    from scipy.optimize import linprog
    data = ex.linsep_data()
    X, Y = data
    N, M = X.shape[1], Y.shape[1]
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        prob, a, b = ex.linsep(data)
        jprob, ja, jb = jax_linsep(data)
    assert prob.status == jprob.status == "optimal"
    compare(lps[0], jlps[0])
    close_x(np.asarray(a.value), np.asarray(ja.value))
    close_x(np.asarray(b.value), np.asarray(jb.value))
    obj = float(prob.objective.value()[0])
    close_obj(obj, float(jprob.objective.value()[0]))
    nv = 3 + N + M
    cvec = np.zeros(nv)
    cvec[3:] = 1.0
    A_ub, b_ub = np.zeros((N + M, nv)), -np.ones(N + M)
    A_ub[:N, :2] = -X.T; A_ub[:N, 2] = 1.0; A_ub[:N, 3:3 + N] = -np.eye(N)
    A_ub[N:, :2] = Y.T; A_ub[N:, 2] = -1.0; A_ub[N:, 3 + N:] = -np.eye(M)
    res = linprog(cvec, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * 3 + [(0, None)] * (N + M),
                  method="highs")
    assert res.status == 0
    np.testing.assert_allclose(obj, res.fun, atol=1e-6)
    assert obj < 1e-6
    av = np.asarray(a.value).reshape(-1)
    bv = float(np.asarray(b.value).reshape(-1)[0])
    assert np.all(X.T @ av - bv >= 1 - 1e-6)
    assert np.all(Y.T @ av - bv <= -1 + 1e-6)


def test_chernoff_qp_distances():
    from scipy.optimize import minimize
    data = ex.chernoff_data()
    for sol, (A, b, x0) in zip(ex.chernoff(data), data):
        assert sol["status"] == "optimal"
        compare(sol, jsolvers.qp(np.eye(2), np.zeros(2), A, b))
        x = host(sol["x"])
        oracle = minimize(lambda x: x @ x, x0, jac=lambda x: 2 * x,
                          constraints=[{"type": "ineq",
                                        "fun": lambda x: b - A @ x}],
                          method="SLSQP", options={"ftol": 1e-12})
        assert oracle.success
        np.testing.assert_allclose(x @ x, oracle.x @ oracle.x, atol=1e-6)


def test_placement_quadratic():
    data = ex.placement_data()
    A, B = data
    for d, (sol, prob) in enumerate(zip(ex.placement(data),
                                        ex.placement_problems(data))):
        assert sol["status"] == "optimal"
        compare(sol, jsolvers.qp(*prob))
        xref = np.linalg.lstsq(A, -B[:, d], rcond=None)[0]
        np.testing.assert_allclose(host(sol["x"]), xref, atol=1e-5)


def jax_centers(data):
    G, h, x0 = data
    m = G.shape[0]
    Gj, hj = jnp.asarray(G), jnp.asarray(h)

    def full(y):
        L = jnp.array([[y[0], 0.0], [y[1], y[2]]])
        norms = jnp.sqrt(jnp.sum((Gj @ L) ** 2, axis=1) + 1e-300)
        return jnp.concatenate([jnp.array([-jnp.log(y[0]) - jnp.log(y[2])]),
                                norms + Gj @ y[3:5] - hj])

    def F(x=None, z=None):
        if x is None:
            return m, jnp.asarray(x0)
        x = jnp.asarray(x)
        if float(x[0]) <= 0 or float(x[2]) <= 0:
            return None
        f, Df = full(x), jax.jacfwd(full)(x)
        if z is None:
            return f, Df
        return f, Df, jax.hessian(lambda y: jnp.dot(jnp.asarray(z),
                                                    full(y)))(x)

    return jsolvers.cp(F)


def test_centers_max_volume_ellipsoid():
    from scipy.optimize import linprog
    data = ex.centers_data()
    G, h, _ = data
    sol = ex.centers(data)
    assert sol["status"] == "optimal"
    compare(sol, jax_centers(data))
    x = host(sol["x"])
    L = np.array([[x[0], 0.0], [x[1], x[2]]])
    assert np.all(np.linalg.norm(G @ L, axis=1) + G @ x[3:5] <= h + 1e-6)
    cv = np.zeros(3)
    cv[2] = -1.0
    A_ub = np.hstack([G, np.linalg.norm(G, axis=1)[:, None]])
    res = linprog(cv, A_ub=A_ub, b_ub=h,
                  bounds=[(None, None)] * 2 + [(0, None)], method="highs")
    assert res.status == 0
    r = res.x[2]
    assert abs(np.linalg.det(L)) >= r * r * (1.0 - 1e-6)
