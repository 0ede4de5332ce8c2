"""The quadratic cone program of userguide section 8.2 (reference
examples/doc/chap8/coneqp.py):

    minimize   (1/2) x'A'Ax - b'Ax
    subject to x >= 0,  ||x||_2 <= 1
"""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.solvers import coneqp


def main():
    A = np.array([[0.3, 0.6, -0.3],
                  [-0.4, 1.2, 0.0],
                  [-0.2, -1.7, 0.6],
                  [-0.4, 0.3, -1.2],
                  [1.3, -0.3, -2.0]])
    b = np.array([1.5, 0.0, -1.2, -0.7, 0.0])
    m, n = A.shape
    eye = np.eye(n)
    G = np.vstack([-eye, np.zeros((1, n)), eye])
    h = np.concatenate([np.zeros(n), [1.0], np.zeros(n)])
    dims = ConeDims(l=n, q=(n + 1,))
    sol = coneqp(A.T @ A, -A.T @ b, G, h, dims)
    return sol


if __name__ == "__main__":
    sol = main()
    print("x =", sol["x"].cpu().numpy())
