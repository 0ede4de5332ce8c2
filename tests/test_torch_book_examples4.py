"""The port's cvxbook problems of kvxopt_tpu_torch.examples.book.examples4
(robls, ellipsoids, polapprox) against the JAX package's, as
tests/test_book_examples4.py solves them, on the CPU.

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
from kvxopt_tpu_torch.examples.book import examples4 as ex

from .torch_example_parity import compare, host


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def robust_residual(A, Aps, b, x, nsamp=400):
    """max over ||u|| <= 1 of ||(A + sum u_i Ap_i) x - b||, bounded below
    by polished sampling (tests/test_book_examples4.py's _robust_obj)."""
    r0 = A @ x - b
    P = np.stack([Ap @ x for Ap in Aps], axis=1)
    rng = np.random.default_rng(0)
    best = np.linalg.norm(r0)
    for _ in range(nsamp):
        u = rng.standard_normal(P.shape[1])
        u /= np.linalg.norm(u)
        for _ in range(50):
            g = P.T @ (r0 + P @ u)
            nv = np.linalg.norm(g)
            if nv < 1e-14:
                break
            u2 = g / nv
            if np.linalg.norm(u2 - u) < 1e-12:
                u = u2
                break
            u = u2
        best = max(best, np.linalg.norm(r0 + P @ u))
    return best


def test_robls_sdp():
    data = ex.robls_data()
    A, Aps, b = data
    n = A.shape[1]
    c, Gs, hs = ex.robls_problem(data)
    sol = ex.robls(data)
    assert sol["status"] == "optimal"
    compare(sol, jsolvers.sdp(c, Gs=[Gs], hs=[hs]))
    x_rob = host(sol["x"])[:n]
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    r_rob = robust_residual(A, Aps, b, x_rob)
    assert r_rob <= robust_residual(A, Aps, b, x_ls) + 1e-8
    assert r_rob ** 2 <= float(sol["primal objective"]) + 1e-6


def jax_ellipsoids(pts):
    mpts = pts.shape[0]

    def full(y):
        L = jnp.array([[y[0], 0.0], [y[1], y[2]]])
        r = pts @ L.T + y[3:5][None, :]
        return jnp.concatenate([jnp.array([-jnp.log(y[0]) - jnp.log(y[2])]),
                                jnp.sum(r * r, axis=1) - 1.0])

    def F(x=None, z=None):
        if x is None:
            return mpts, jnp.asarray([0.1, 0.0, 0.1, -0.1, 0.05])
        x = jnp.asarray(x)
        if float(x[0]) <= 0 or float(x[2]) <= 0:
            return None
        f = full(x)
        if not bool(jnp.all(jnp.isfinite(f[1:]))):
            return None
        Df = jax.jacfwd(full)(x)
        if z is None:
            return f, Df
        return f, Df, jax.hessian(lambda y: jnp.dot(jnp.asarray(z),
                                                    full(y)))(x)

    return jsolvers.cp(F)


def test_ellipsoids_min_volume_cover():
    pts = ex.ellipsoids_data()
    sol = ex.ellipsoids(pts)
    assert sol["status"] == "optimal"
    compare(sol, jax_ellipsoids(pts))
    x = host(sol["x"])
    L = np.array([[x[0], 0.0], [x[1], x[2]]])
    nrm = np.linalg.norm(pts @ L.T + x[3:5][None, :], axis=1)
    assert np.all(nrm <= 1.0 + 1e-6)
    assert np.sum(nrm > 1.0 - 1e-4) >= 2
    R = np.max(np.linalg.norm(pts - pts.mean(axis=0), axis=1))
    assert np.pi / np.linalg.det(L) <= np.pi * R * R * 1.0001


def test_polapprox_chebyshev_lp():
    from scipy.optimize import linprog
    data = ex.polapprox_data()
    V, y = data
    c, G, h = ex.polapprox_problem(data)
    sol = ex.polapprox(data)
    assert sol["status"] == "optimal"
    compare(sol, jsolvers.lp(c, G, h))
    t = float(sol["primal objective"])
    res = linprog(c, A_ub=G, b_ub=h, bounds=[(None, None)] * len(c),
                  method="highs")
    assert res.status == 0
    np.testing.assert_allclose(t, res.fun, atol=1e-7)
    a = host(sol["x"])[:V.shape[1]]
    np.testing.assert_allclose(np.max(np.abs(V @ a - y)), t, atol=1e-6)
