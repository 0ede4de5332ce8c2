"""Analytic centering (reference examples/book/chap8 acent): maximize
sum(log(b - Ax)) via the nonlinear solver cp with a hand-written
oracle.

F() gives x0 as a numpy array, so cp places it on config.default_device
(or on the CPU where the default thresholds route the solve); the oracle
builds A and b on the device of the x it is handed."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice, to_numpy
from kvxopt_tpu_torch.solvers import cp


def acent(A, b):
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    m, n = A.shape
    data = OnDevice(A=A, b=b)

    def F(x=None, z=None):
        if x is None:
            return 0, np.zeros(n)
        T = data(x)
        y = T.b - T.A @ x
        f = -torch.log(y).sum().reshape(1)
        Df = (T.A.T @ (1.0 / y)).reshape(1, -1)
        if z is None:
            return f, Df
        H = z[0] * (T.A.T * (1.0 / y ** 2)[None, :]) @ T.A
        return f, Df, H

    return cp(F)


def main():
    rng = np.random.default_rng(5)
    m, n = 40, 10
    A = rng.standard_normal((m, n))
    b = np.abs(A @ rng.standard_normal(n)) + rng.uniform(0.5, 2.0, m)
    sol = acent(A, b)
    x = to_numpy(sol["x"])
    assert (b - A @ x > 0).all()
    # optimality: gradient ~ 0
    g = A.T @ (1.0 / (b - A @ x))
    assert np.linalg.norm(g) < 1e-4 * max(1.0, np.linalg.norm(b))
    return sol


if __name__ == "__main__":
    print(main()["status"])
