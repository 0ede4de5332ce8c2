"""cvxbook and userguide examples on the port (the problems of the JAX
package's tests/test_book_examples3.py): doc/chap9/l2ac (a
matrix-inversion-lemma custom kktsolver for cp), book/chap7/logreg
(logistic regression by cp), book/chap6/penalties (l1 and dead-zone
penalties through the DSL, the log-barrier penalty by cp),
book/chap6/cvxfit (a least-squares fit under convexity constraints, a
QP) and book/chap6/smoothrec (quadratic smoothing by lapack.ptsv, a
host facade as in the JAX package).  Data synthesized."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice
from kvxopt_tpu_torch.models.modeling import op, variable
from kvxopt_tpu_torch.models.modeling import max as mmax
from kvxopt_tpu_torch.models.modeling import sum as msum
from kvxopt_tpu_torch.solvers import cp, qp


# ---------------------------------------------------------------------------
# l2ac (doc/chap9/l2ac.py): minimize (1/2)||Ax - b||^2 - sum log(1 - x_i^2)
# with m << n

def l2ac_data(seed=0, m=8, n=60):
    """(A (m, n), b (m,)) with b = A xs for an xs inside the domain."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    xs = rng.uniform(-0.6, 0.6, n)
    return A, A @ xs


def l2ac(data):
    """Solved twice: with dense H through the default KKT path, and with
    H as an operator and the custom kktsolver that applies the matrix
    inversion lemma to z0 (A'A + D), an m x m factorization -> (dense
    solution, custom solution)."""
    A_np, b_np = data
    m, n = A_np.shape
    on = OnDevice(A=A_np, b=b_np)

    def F_dense(x=None, z=None):
        if x is None:
            return 0, np.zeros(n)
        if float(x.abs().max()) >= 1.0:
            return None
        T = on(x)
        r = T.A @ x - T.b
        w = x ** 2
        f = (0.5 * torch.dot(r, r) - torch.log(1 - w).sum()).reshape(1)
        grad = (T.A.T @ r + 2 * x / (1 - w)).reshape(1, -1)
        if z is None:
            return f, grad
        H = z[0] * (T.A.T @ T.A + torch.diag(2 * (1 + w) / (1 - w) ** 2))
        return f, grad, H

    sol_dense = cp(F_dense)

    state = {}

    def F_op(x=None, z=None):
        # records x and z0 for the factor (the reference kktsolver gets
        # (x, z, W); the port's gets W and H/Df, so they come by closure)
        if x is None:
            return F_dense()
        out = F_dense(x) if z is None else F_dense(x, z)
        if out is None or z is None:
            return out
        f, grad, _ = out
        state["x"], state["z0"] = x, float(z[0])
        A = on(x).A
        w = x ** 2
        d = 2 * z[0] * (1 + w) / (1 - w) ** 2

        def Hmv(u):
            return z[0] * (A.T @ (A @ u)) + d * u

        return f, grad, Hmv

    def kktsolver(W, H=None, Df=None):
        """The extended-epigraph KKT solve by the matrix inversion lemma:
        cp gives the kktsolver the system over (x, t), with one
        nonlinear row f0 - t scaled by d0 = W.d[0]; eliminating
        uz = -bx_t and applying the lemma to z0 (A'A + D) gives the
        reference l2ac's O(m^2 n) solve."""
        x, z0 = state["x"], state["z0"]
        T = on(x)
        w = x ** 2
        dsi = 1.0 / torch.sqrt(2.0 * (1 + w) / (1 - w) ** 2)   # (D/z0)^-1/2
        Asc = T.A * dsi[None, :]
        C = torch.linalg.cholesky(
            torch.eye(m, dtype=x.dtype, device=x.device) + Asc @ Asc.T)
        d0 = W.d[0]
        g = T.A.T @ (T.A @ x - T.b) + 2 * x / (1 - w)    # grad f0 at x

        def solve(bx, by, bz):
            bx_x, bx_t = bx[:n], bx[n]
            t_ = dsi * (bx_x + bx_t * g) / z0
            v = torch.cholesky_solve((Asc @ t_)[:, None], C)[:, 0]
            ux = dsi * (t_ - Asc.T @ v)
            ut = torch.dot(g, ux) - bz[0] + d0 * d0 * bx_t
            return torch.cat([ux, ut.reshape(1)]), by, (-bx_t).reshape(1)

        return solve

    return sol_dense, cp(F_op, kktsolver=kktsolver)


# ---------------------------------------------------------------------------
# logreg (book/chap7/logreg.py): 2-parameter logistic regression by cp

def logreg_data(seed=1, mpts=60):
    """(A (mpts, 2), c (2,)): the design [u, 1] and c = -A'y for 0/1
    outcomes y drawn with probability 1/(1 + exp(-(u - 5)))."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(0, 10, mpts))
    y = (rng.uniform(size=mpts) < 1 / (1 + np.exp(-(u - 5)))).astype(float)
    return np.stack([u, np.ones(mpts)], axis=1), -np.array([u @ y, y.sum()])


def logreg(data):
    """cp: minimize c'x + sum log(1 + exp(A x))."""
    on = OnDevice(A=data[0], c=data[1])

    def F(x=None, z=None):
        if x is None:
            return 0, np.zeros(2)
        T = on(x)
        w = torch.exp(T.A @ x)
        f = (torch.dot(T.c, x) + torch.log1p(w).sum()).reshape(1)
        p = w / (1 + w)
        grad = (T.c + T.A.T @ p).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, z[0] * (T.A.T * (p * (1 - p))[None, :]) @ T.A

    return cp(F)


# ---------------------------------------------------------------------------
# penalties (book/chap6/penalties.py)

def penalties_data(seed=2, m=40, n=10):
    """(A (m, n), b (m,))."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m) * 1.2


def penalties(data):
    """The l1 penalty sum|Ax + b| and the dead-zone penalty
    sum max(|Ax + b| - 0.5, 0) through the DSL, and the log-barrier
    penalty -sum log(1 - (Ax + b)^2) by cp with b scaled into its domain
    (by 0.9 / max|b|) -> dict(l1=(op, x), deadzone=(op, x),
    barrier=solution, b_barrier=the scaled b)."""
    A, b = data
    n = A.shape[1]
    x1 = variable(n)
    p1 = op(msum(abs(A * x1 + b)))
    p1.solve()
    x2 = variable(n)
    p2 = op(msum(mmax(abs(A * x2 + b) - 0.5, 0.0)))
    p2.solve()

    bs = b * (0.9 / float(np.abs(b).max()))
    on = OnDevice(A=A, b=bs)

    def F(x=None, z=None):
        if x is None:
            return 0, np.zeros(n)
        T = on(x)
        y = T.A @ x + T.b
        if float(y.abs().max()) >= 1.0:
            return None
        f = -torch.log(1.0 - y ** 2).sum().reshape(1)
        grad = (2.0 * T.A.T @ (y / (1 - y ** 2))).reshape(1, -1)
        if z is None:
            return f, grad
        H = (T.A.T * (2.0 * z[0] * (1 + y ** 2) /
                      (1 - y ** 2) ** 2)[None, :]) @ T.A
        return f, grad, H

    return dict(l1=(p1, x1), deadzone=(p2, x2), barrier=cp(F),
                b_barrier=bs)


# ---------------------------------------------------------------------------
# cvxfit (book/chap6/cvxfit.py): least-squares fit of a convex function,
# minimize ||yhat - y||^2 s.t. nonnegative second differences

def cvxfit_data(seed=3, m=25):
    """(u, y): exp(u) plus noise on a sorted grid u."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(-1, 1, m))
    return u, np.exp(u) + 0.1 * rng.standard_normal(m)


def cvxfit_problem(data):
    u, y = data
    m = len(u)
    rows = []
    for k in range(1, m - 1):
        r = np.zeros(m)
        d1, d2 = u[k] - u[k - 1], u[k + 1] - u[k]
        r[k - 1] = -1.0 / d1
        r[k] = 1.0 / d1 + 1.0 / d2
        r[k + 1] = -1.0 / d2
        rows.append(-r)     # -(second difference) <= 0
    G = np.stack(rows)
    return 2.0 * np.eye(m), -2.0 * y, G, np.zeros(len(rows))


def cvxfit(data):
    return qp(*cvxfit_problem(data))


# ---------------------------------------------------------------------------
# smoothrec (book/chap6/smoothrec.py): quadratic smoothing
# minimize ||x - corr||^2 + delta ||Dx||^2 by the SPD tridiagonal solver

def smoothrec_data(seed=4, n=200, delta=10.0):
    """(corr, delta): a noisy sine of n samples."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n)
    return np.sin(t) + 0.2 * rng.standard_normal(n), delta


def smoothrec(data):
    """(I + delta D'D) x = corr by lapack.ptsv (the diagonal d and the
    off-diagonal e of the tridiagonal matrix) -> x."""
    from kvxopt_tpu_torch import lapack, matrix
    corr, delta = data
    n = len(corr)
    d = 1.0 + delta * np.concatenate([[1.0], 2.0 * np.ones(n - 2), [1.0]])
    x = matrix(corr.reshape(-1, 1).copy())
    lapack.ptsv(matrix(d), matrix(-delta * np.ones(n - 1)), x)
    return np.asarray(x).reshape(-1)
