"""Robust least squares (reference examples/book chap6 robls): minimize
||Ax - b||_2 as an SOCP, min t s.t. ||Ax - b|| <= t, with one
second-order cone through conelp."""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.solvers import conelp


def norm_min(A, b):
    """minimize ||Ax - b||_2 as an SOCP: min t s.t. ||Ax-b|| <= t."""
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    m, n = A.shape
    # variables (x, t)
    c = np.zeros(n + 1)
    c[-1] = 1.0
    # SOC: s0 = t, s1 = b - Ax
    G = np.zeros((m + 1, n + 1))
    G[0, -1] = -1.0
    G[1:, :n] = A
    h = np.concatenate([[0.0], b])
    sol = conelp(c, G, h, ConeDims(l=0, q=(m + 1,)))
    return to_numpy(sol["x"])[:n], sol


def main():
    rng = np.random.default_rng(12)
    m, n = 40, 8
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x, sol = norm_min(A, b)
    assert sol["status"] == "optimal"
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(x, x_ref, atol=1e-5)
    return sol


if __name__ == "__main__":
    print(main()["status"])
