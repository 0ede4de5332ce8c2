"""Chebyshev center of a polyhedron (reference examples/book chap4):
maximize r s.t. a_i'x + r||a_i|| <= b_i — an LP."""

import numpy as np

from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.solvers import lp


def cheb_center(A, b):
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    m, n = A.shape
    norms = np.linalg.norm(A, axis=1)
    # variables (x, r): maximize r
    c = np.zeros(n + 1)
    c[-1] = -1.0
    G = np.hstack([A, norms.reshape(-1, 1)])
    # keep r >= 0
    G = np.vstack([G, -np.eye(n + 1)[-1:]])
    h = np.concatenate([b, [0.0]])
    sol = lp(c, G, h)
    x = to_numpy(sol["x"])
    return x[:n], float(x[n]), sol


def main():
    rng = np.random.default_rng(11)
    m, n = 30, 2
    A = rng.standard_normal((m, n))
    b = A @ np.array([0.5, -0.2]) + rng.uniform(0.5, 2.0, m)
    xc, r, sol = cheb_center(A, b)
    assert sol["status"] == "optimal"
    # the ball of radius r fits: a_i'xc + r||a_i|| <= b_i
    assert (A @ xc + r * np.linalg.norm(A, axis=1) <= b + 1e-6).all()
    assert r > 0
    return sol


if __name__ == "__main__":
    print(main()["status"])
