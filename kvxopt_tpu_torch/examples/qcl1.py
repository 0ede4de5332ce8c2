"""qcl1 (reference examples/doc/chap8/qcl1.py): minimize ||x||_1 subject
to a quadratic constraint ||Ax - b||_2 <= 1, as an SOCP."""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.solvers import conelp


def qcl1(A, b):
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    m, n = A.shape
    # variables (x, u): min 1'u, -u <= x <= u, ||Ax - b|| <= 1
    c = np.concatenate([np.zeros(n), np.ones(n)])
    Gl = np.block([[np.eye(n), -np.eye(n)], [-np.eye(n), -np.eye(n)]])
    hl = np.zeros(2 * n)
    # SOC: s0 = 1, s1 = b - Ax  -> G rows: [0,0; A,0], h = [1; b]
    Gq = np.zeros((m + 1, 2 * n))
    Gq[1:, :n] = A
    hq = np.concatenate([[1.0], b])
    G = np.vstack([Gl, Gq])
    h = np.concatenate([hl, hq])
    dims = ConeDims(l=2 * n, q=(m + 1,))
    return conelp(c, G, h, dims)


def main():
    rng = np.random.default_rng(4)
    m, n = 30, 10
    A = rng.standard_normal((m, n))
    x0 = np.zeros(n)
    x0[:3] = rng.standard_normal(3)
    b = A @ x0 + 0.05 * rng.standard_normal(m)
    sol = qcl1(A, b)
    x = to_numpy(sol["x"])[:n]
    assert np.linalg.norm(A @ x - b) <= 1.0 + 1e-6
    return sol


if __name__ == "__main__":
    print(main()["status"])
