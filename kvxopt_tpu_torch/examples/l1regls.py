"""1-norm regularized least squares (userguide section 8.7 "Exploiting
structure"; reference examples/doc/chap8/l1regls.py):

    minimize ||A x - y||_2^2 + ||x||_1

as a coneqp with operator-form P and G and a structure-exploiting custom
KKT solver: the condensed system reduces to an m x m factorization
(A D^-1 A' + I, by torch.linalg.cholesky and torch.cholesky_solve)
instead of the 2n x 2n default, in the port's functional contract
(factor(W) -> solve(bx, by, bz) -> new values).

P and G are operators, so the solve is never routed by size: it runs on
config.default_device at every (m, n)."""

import numpy as np
import torch

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.examples._data import OnDevice, to_numpy
from kvxopt_tpu_torch.solvers import coneqp


def l1regls(A, y):
    A = np.asarray(A, dtype=float)
    y = np.asarray(y, dtype=float).reshape(-1)
    m, n = A.shape
    q = np.concatenate([-2.0 * (A.T @ y), np.ones(n)])
    h = np.zeros(2 * n)
    dims = ConeDims(l=2 * n)
    data = OnDevice(A=A)

    def P(u):
        # 2 [A'A 0; 0 0] u
        A = data(u).A
        return torch.cat([2.0 * (A.T @ (A @ u[:n])), u.new_zeros(n)])

    def G(u, trans=False):
        # [I -I; -I -I], its own transpose
        return torch.cat([u[:n] - u[n:], -u[:n] - u[n:]])

    def kktsolver(W, H=None, Df=None):
        # Eliminate zl and x[n:]: (2A'A + 4 D1 D2 (D1+D2)^-1) x[:n] = rhs,
        # then solve through the m x m system (A D^-1 A' + I) v = ...
        # (reference l1regls.py Fkkt, same elimination).
        A = data(W.d).A
        di = 1.0 / W.d
        d1, d2 = di[:n] ** 2, di[n:] ** 2
        ds = np.sqrt(2.0) * di[:n] * di[n:] / torch.sqrt(d1 + d2)
        d3 = (d2 - d1) / (d1 + d2)
        Asc = A / ds[None, :]
        S = torch.eye(m, dtype=A.dtype, device=A.device) + Asc @ Asc.T
        C = torch.linalg.cholesky(S)

        def solve(bx, by, bz):
            x1 = 0.5 * (bx[:n] - d3 * bx[n:] +
                        d1 * (bz[:n] + d3 * bz[:n]) -
                        d2 * (bz[n:] - d3 * bz[n:]))
            x1 = x1 / ds
            v = torch.cholesky_solve((Asc @ x1)[:, None], C)[:, 0]
            x1 = (x1 - Asc.T @ v) / ds
            x2 = ((bx[n:] - d1 * bz[:n] - d2 * bz[n:]) / (d1 + d2)
                  - d3 * x1)
            # the port's kktsolver contract returns the *unscaled* uz
            # (= W^{-2}(G ux - bz) for the l-cone), unlike the
            # reference's W-scaled exit convention
            z1 = d1 * (x1 - x2 - bz[:n])
            z2 = d2 * (-x1 - x2 - bz[n:])
            return torch.cat([x1, x2]), bx.new_zeros((0,)), \
                torch.cat([z1, z2])

        return solve

    sol = coneqp(P, q, G, h, dims, kktsolver=kktsolver)
    return to_numpy(sol["x"])[:n], sol


def main():
    rng = np.random.default_rng(0)
    m, n = 50, 200
    A = rng.standard_normal((m, n))
    y = rng.standard_normal(m)
    x, sol = l1regls(A, y)
    return x, sol, A, y


if __name__ == "__main__":
    x, sol, A, y = main()
    print("status:", sol["status"])
    print("nnz(x) at 1e-5:", int((np.abs(x) > 1e-5).sum()), "of", len(x))
