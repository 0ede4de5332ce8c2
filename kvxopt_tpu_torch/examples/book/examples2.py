"""cvxbook examples on the port (the problems of the JAX package's
tests/test_book_examples2.py): book/chap8 linsep (linear discrimination
through the modeling DSL), book/chap7 chernoff (distances to polyhedra
by QP), book/chap8 placement (quadratic placement) and book/chap8
centers (the maximum-volume inscribed ellipsoid by cp, its oracle's
derivatives by torch.func).  Data synthesized, as in the JAX tests (the
reference's .bin files are cvxopt pickles)."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice
from kvxopt_tpu_torch.models.modeling import op, variable
from kvxopt_tpu_torch.models.modeling import sum as msum
from kvxopt_tpu_torch.solvers import cp, qp


# ---------------------------------------------------------------------------
# linsep (book/chap8/linsep.py, first figure): approximate linear
# discrimination of two point clouds as an LP

def linsep_data(seed=0, N=25, M=25):
    """(X (2, N), Y (2, M)): two clouds around (2.5, 2.5) and
    (-2.5, -2.5)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((2, N)) + np.array([[2.5], [2.5]])
    Y = rng.standard_normal((2, M)) - np.array([[2.5], [2.5]])
    return X, Y


def linsep(data):
    """The DSL LP: minimize 1'u + 1'v s.t. X'a - b >= 1 - u,
    Y'a - b <= -1 + v, u, v >= 0 -> (op, a, b)."""
    X, Y = data
    a, b = variable(2), variable()
    u, v = variable(X.shape[1]), variable(Y.shape[1])
    prob = op(msum(u) + msum(v),
              [X.T * a - b >= 1 - u, Y.T * a - b <= -1 + v, u >= 0, v >= 0])
    prob.solve()
    return prob, a, b


# ---------------------------------------------------------------------------
# chernoff (book/chap7/chernoff.py core): squared distances from the
# origin to polyhedra, min x'x s.t. Ax <= b

def chernoff_data(seed=1, count=5):
    """[(A (3, 2), b (3,), x0)] for `count` polyhedra, x0 a point inside
    each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        A = rng.standard_normal((3, 2))
        x0 = rng.standard_normal(2) + np.array([2.0, 1.0])
        out.append((A, A @ x0 + rng.uniform(0.1, 1.0, 3), x0))
    return out


def chernoff(data):
    """One QP solution per polyhedron."""
    return [qp(np.eye(2), np.zeros(2), A, b) for A, b, _ in data]


# ---------------------------------------------------------------------------
# placement (book/chap8/placement.py, first part): quadratic placement of
# free points minimizing the total squared wire length

def placement_data(seed=2, nfree=6, nfix=4, nw=18):
    """(A (nw, nfree), B (nw, 2)): wire w joins free point i to free
    point j (A[w] = e_i - e_j) or to a fixed point (B[w] = -its
    position)."""
    rng = np.random.default_rng(seed)
    fixed = rng.standard_normal((nfix, 2)) * 3
    A, B = np.zeros((nw, nfree)), np.zeros((nw, 2))
    for w in range(nw):
        i = rng.integers(nfree)
        if rng.random() < 0.5:
            j = rng.integers(nfree)
            if j == i:
                j = (j + 1) % nfree
            A[w, i] = 1.0
            A[w, j] = -1.0
        else:
            A[w, i] = 1.0
            B[w] = -fixed[rng.integers(nfix)]
    return A, B


def placement_problems(data):
    """The QP of each coordinate, minimize ||A x + B[:, d]||^2 (with a
    loose box), as (P, q, G, h)."""
    A, B = data
    nfree = A.shape[1]
    P = 2.0 * A.T @ A + 1e-9 * np.eye(nfree)
    return [(P, 2.0 * A.T @ B[:, d], -np.eye(nfree), 1e3 * np.ones(nfree))
            for d in range(2)]


def placement(data):
    """The two coordinates' solutions."""
    return [qp(*prob) for prob in placement_problems(data)]


# ---------------------------------------------------------------------------
# centers (book/chap8/centers.py): the maximum-volume ellipsoid
# {L u + c : ||u|| <= 1} inside a polygon {g_k'y <= h_k}, maximizing
# log det L over (l11, l21, l22, c1, c2)

def centers_data(seed=None):
    """(G (5, 2), h (5,), x0): a fixed polygon and a starting ellipsoid
    inside it (no random data)."""
    G = np.array([[1.0, 0.2], [-0.3, 1.0], [-1.0, -0.1],
                  [0.1, -1.0], [0.8, 0.9]])
    h = np.array([2.0, 1.8, 2.2, 1.5, 2.5])
    return G, h, np.array([0.2, 0.0, 0.2, 0.2, 0.1])


def centers(data):
    """cp over f0 = -log l11 - log l22 and the containment constraints
    ||L' g_k|| + g_k'c - h_k <= 0, Df and H by torch.func."""
    G, h, x0 = data
    m = G.shape[0]
    dev_data = OnDevice(G=G, h=h)

    def full(y):
        T = dev_data(y)
        L = torch.stack([torch.stack([y[0], torch.zeros_like(y[0])]),
                         torch.stack([y[1], y[2]])])
        norms = torch.sqrt(((T.G @ L) ** 2).sum(dim=1) + 1e-300)
        fc = norms + T.G @ y[3:5] - T.h
        return torch.cat([(-torch.log(y[0]) - torch.log(y[2])).reshape(1),
                          fc])

    def F(x=None, z=None):
        if x is None:
            return m, x0
        if float(x[0]) <= 0 or float(x[2]) <= 0:
            return None
        f, Df = full(x), torch.func.jacfwd(full)(x)
        if z is None:
            return f, Df
        H = torch.func.hessian(lambda y: torch.dot(z, full(y)))(x)
        return f, Df, H

    return cp(F)
