"""l1-norm approximation (reference examples/doc/chap8/l1.py):
minimize ||A x - b||_1 as an LP with a structure-exploiting custom KKT
solver.

G is an operator and the KKT solver the user's, so the solve is never
routed by size: it runs on config.default_device (the card unless the
caller names another).  The operator and the solver build A on the
device of what they are handed."""

import numpy as np
import torch

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.examples._data import OnDevice, to_numpy
from kvxopt_tpu_torch.solvers import conelp


def l1(A, b):
    """Returns the minimizer of ||Ax - b||_1 using the custom-KKT LP
    formulation."""
    A = np.asarray(A, dtype=float)
    b = np.asarray(b, dtype=float).reshape(-1)
    m, n = A.shape
    c = np.concatenate([np.zeros(n), np.ones(m)])
    h = np.concatenate([b, -b])
    dims = ConeDims(l=2 * m)
    data = OnDevice(A=A)

    def G(v, trans=False):
        A = data(v).A
        if trans:
            z1, z2 = v[:m], v[m:]
            return torch.cat([A.T @ (z1 - z2), -z1 - z2])
        x, u = v[:n], v[n:]
        Ax = A @ x
        return torch.cat([Ax - u, -Ax - u])

    def kktsolver(W, H=None, Df=None):
        d = W.d
        A = data(d).A
        p = 1.0 / d[:m] ** 2
        q = 1.0 / d[m:] ** 2
        S = p + q
        w = 4.0 * p * q / S
        C = torch.linalg.cholesky((A.T * w[None, :]) @ A)

        def solve(bx, by, bz):
            bx_x, bx_u = bx[:n], bx[n:]
            bz1, bz2 = bz[:m], bz[m:]
            cu = bx_u - p * bz1 - q * bz2
            r = bx_x + A.T @ ((p - q) / S * cu + p * bz1 - q * bz2)
            x = torch.cholesky_solve(r[:, None], C)[:, 0]
            Ax = A @ x
            u = (cu + (p - q) * Ax) / S
            return (torch.cat([x, u]), bx.new_zeros((0,)),
                    torch.cat([p * (Ax - u - bz1), q * (-Ax - u - bz2)]))

        return solve

    sol = conelp(c, G, h, dims, kktsolver=kktsolver)
    return to_numpy(sol["x"])[:n], sol


def main():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 30))
    b = rng.standard_normal(100)
    x, sol = l1(A, b)
    return sol


if __name__ == "__main__":
    print(main()["status"])
