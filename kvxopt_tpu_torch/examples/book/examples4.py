"""cvxbook examples on the port (the problems of the JAX package's
tests/test_book_examples4.py): book/chap6/robls (robust least squares
with structured uncertainty as an SDP), book/chap8/ellipsoids (the
minimum-volume covering ellipsoid by cp with a log-det objective, the
oracle's derivatives by torch.func) and book/chap6/polapprox (a
Chebyshev-norm polynomial fit as an LP).  Data synthesized."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice
from kvxopt_tpu_torch.solvers import cp, lp, sdp


# ---------------------------------------------------------------------------
# robls (book/chap6/robls.py)

def robls_data(seed=5, m=8, n=4, p=3):
    """(A (m, n), [Ap_j (m, n)] p perturbation directions, b (m,))."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    Aps = [0.35 * rng.standard_normal((m, n)) for _ in range(p)]
    b = A @ rng.standard_normal(n) + 0.5 * rng.standard_normal(m)
    return A, Aps, b


def robls_problem(data):
    """minimize t + v over (x, v, t) s.t.
        [ I       P(x)   r(x) ]
        [ P(x)'   v*I    0    ]  >= 0,  r(x) = A x - b
        [ r(x)'   0      t    ]
    -> (c, Gs (M*M, n + 2), hs (M, M)), M = m + p + 1."""
    A, Aps, b = data
    m, n = A.shape
    p = len(Aps)
    M = m + p + 1
    Gs = np.zeros((M * M, n + 2))
    for k in range(n):
        S = np.zeros((M, M))
        for j in range(p):
            S[m + j, :m] = Aps[j][:, k]
            S[:m, m + j] = Aps[j][:, k]
        S[M - 1, :m] = A[:, k]
        S[:m, M - 1] = A[:, k]
        Gs[:, k] = -S.reshape(-1)
    Sv = np.zeros((M, M))
    Sv[m:m + p, m:m + p] = np.eye(p)
    Gs[:, n] = -Sv.reshape(-1)
    Gs[M * M - 1, n + 1] = -1.0
    hs = np.zeros((M, M))
    hs[:m, :m] = np.eye(m)
    hs[M - 1, :m] = -b
    hs[:m, M - 1] = -b
    c = np.zeros(n + 2)
    c[n:] = 1.0
    return c, Gs, hs


def robls(data):
    c, Gs, hs = robls_problem(data)
    return sdp(c, Gs=[Gs], hs=[hs])


# ---------------------------------------------------------------------------
# ellipsoids (book/chap8/ellipsoids.py, Loewner-John): the minimum-volume
# ellipsoid {y : ||L y + c|| <= 1} covering points

def ellipsoids_data(seed=6, mpts=30):
    """pts (mpts, 2): an elongated cloud around (1, -0.5)."""
    rng = np.random.default_rng(seed)
    T = np.array([[2.0, 0.6], [0.0, 0.8]])
    return (T @ rng.standard_normal((2, mpts))).T + np.array([1.0, -0.5])


def ellipsoids(pts):
    """cp over x = (l11, l21, l22, c1, c2): minimize -log l11 - log l22
    s.t. ||L p_k + c||^2 <= 1, from a small ball mapped inside."""
    mpts = pts.shape[0]
    on = OnDevice(pts=pts)

    def full(y):
        P = on(y).pts
        L = torch.stack([torch.stack([y[0], torch.zeros_like(y[0])]),
                         torch.stack([y[1], y[2]])])
        r = P @ L.T + y[3:5][None, :]
        return torch.cat([(-torch.log(y[0]) - torch.log(y[2])).reshape(1),
                          (r * r).sum(dim=1) - 1.0])

    def F(x=None, z=None):
        if x is None:
            return mpts, np.array([0.1, 0.0, 0.1, -0.1, 0.05])
        if float(x[0]) <= 0 or float(x[2]) <= 0:
            return None
        f = full(x)
        if not bool(torch.isfinite(f[1:]).all()):
            return None
        Df = torch.func.jacfwd(full)(x)
        if z is None:
            return f, Df
        H = torch.func.hessian(lambda y: torch.dot(z, full(y)))(x)
        return f, Df, H

    return cp(F)


# ---------------------------------------------------------------------------
# polapprox (book/chap6/polapprox.py): polynomial fit in the Chebyshev
# norm, minimize t s.t. -t <= V a - y <= t

def polapprox_data(seed=7, m=40, deg=4):
    """(V (m, deg + 1), y (m,)): the Vandermonde matrix of a grid on
    [-1, 1] and a noisy cos(2u)."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-1, 1, m)
    y = np.cos(2 * u) + 0.05 * rng.standard_normal(m)
    return np.vander(u, deg + 1, increasing=True), y


def polapprox_problem(data):
    V, y = data
    m, k = V.shape
    c = np.zeros(k + 1)
    c[-1] = 1.0
    G = np.zeros((2 * m, k + 1))
    h = np.zeros(2 * m)
    G[:m, :k] = V; G[:m, -1] = -1.0; h[:m] = y
    G[m:, :k] = -V; G[m:, -1] = -1.0; h[m:] = -y
    return c, G, h


def polapprox(data):
    return lp(*polapprox_problem(data))
