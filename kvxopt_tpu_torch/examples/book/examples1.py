"""cvxbook examples on the port (the problems of the JAX package's
tests/test_book_examples.py): examples/book/chap6 huber, tv,
basispursuit, regsel; examples/book/chap7 maxent, expdesign; and
examples/doc/chap7/covsel.

Each problem is `<name>_data(seed)` (numpy data, seeded as the JAX
tests seed it) and `<name>(data)` (the port's solution).  tv runs
operator-form P and G with a tridiagonal custom kktsolver, so it is
never routed by size; covsel drives cholmod's symbolic/numeric/solve/
diag loop, whose tile path runs on config.default_device."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice
from kvxopt_tpu_torch.solvers import coneqp, cp, qp


# ---------------------------------------------------------------------------
# huber (book/chap6/huber.py): robust regression, the QP form of the
# Huber penalty (exercise 4.5)

def huber_data(seed=0):
    """(A, v): a line through m = 60 points with outliers."""
    rng = np.random.default_rng(seed)
    m = 60
    u = np.sort(rng.uniform(-1, 1, m))
    v = u + 0.3 * rng.standard_normal(m)
    v[::7] += 3.0 * rng.standard_normal((m + 6) // 7)   # outliers
    A = np.stack([np.ones(m), u], axis=1)
    return A, v


def huber_problem(data):
    """minimize (1/2) w'w + 1'y  s.t. -w - y <= Ax - v <= w + y,
    0 <= w <= 1, y >= 0; variables x (n), w (m), y (m) -> (P, q, G, h)."""
    A, v = data
    m, n = A.shape
    nv = n + 2 * m
    P = np.zeros((nv, nv))
    P[n:n + m, n:n + m] = np.eye(m)
    q = np.zeros(nv)
    q[n + m:] = 1.0
    I = np.eye(m)
    G = np.zeros((5 * m, nv))
    h = np.zeros(5 * m)
    G[:m, :n] = A; G[:m, n:n + m] = -I; G[:m, n + m:] = -I; h[:m] = v
    G[m:2 * m, :n] = -A; G[m:2 * m, n:n + m] = -I
    G[m:2 * m, n + m:] = -I; h[m:2 * m] = -v
    G[2 * m:3 * m, n:n + m] = -I
    G[3 * m:4 * m, n:n + m] = I; h[3 * m:4 * m] = 1.0
    G[4 * m:, n + m:] = -I
    return P, q, G, h


def huber(data):
    return qp(*huber_problem(data))


# ---------------------------------------------------------------------------
# tv (book/chap6/tv.py): total-variation smoothing with operator-form P
# and G and the tridiagonal custom kktsolver

def tv_data(seed=1, n=120, delta=0.8):
    """(corr, delta): a noisy square wave of n samples."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n)
    corr = np.sign(np.sin(t)) + 0.2 * rng.standard_normal(n)
    return corr, delta


def tv_problem(data):
    """The dense QP of tv, (P, q, G, h), over x (n) and the bounds of
    |D x| (n - 1)."""
    corr, delta = data
    n = len(corr)
    nv = 2 * n - 1
    D = np.diff(np.eye(n), axis=0)
    P = np.zeros((nv, nv))
    P[:n, :n] = np.eye(n)
    q = np.concatenate([-corr, delta * np.ones(n - 1)])
    G = np.block([[D, -np.eye(n - 1)], [-D, -np.eye(n - 1)]])
    return P, q, G, np.zeros(2 * (n - 1))


def tv(data):
    """coneqp with P and G as operators and the kktsolver that factors
    S = I + D' diag(4 d1 d2 / (d1 + d2)) D (tridiagonal)."""
    corr, delta = data
    n = len(corr)
    q = np.concatenate([-corr, delta * np.ones(n - 1)])

    def Pop(u):
        return torch.cat([u[:n], u.new_zeros(n - 1)])

    def Dmul(x):
        return x[1:] - x[:-1]

    def Dtmul(y):
        v = y.new_zeros(len(y) + 1)
        v[:-1] -= y
        v[1:] += y
        return v

    def Gop(u, trans=False):
        if not trans:
            y = Dmul(u[:n])
            return torch.cat([y - u[n:], -y - u[n:]])
        y = u[:n - 1] - u[n - 1:]
        return torch.cat([Dtmul(y), -(u[:n - 1] + u[n - 1:])])

    def kktsolver(W, H=None, Df=None):
        # W.d is the l-cone scaling; d1 = 1/d[:n-1]^2, d2 = 1/d[n-1:]^2
        di = 1.0 / W.d
        d1 = di[:n - 1] ** 2
        d2 = di[n - 1:] ** 2
        d = 4.0 * d1 * d2 / (d1 + d2)
        diag = W.d.new_ones(n)
        diag[:n - 1] += d
        diag[1:] += d
        S = torch.diag(diag) - torch.diag(d, 1) - torch.diag(d, -1)
        L = torch.linalg.cholesky(S)

        def solve(bx, by, bz):
            y = ((d1 - d2) / (d1 + d2)) * bx[n:] + \
                0.5 * d * (bz[:n - 1] - bz[n - 1:])
            r = bx[:n] + Dtmul(y)
            x1 = torch.cholesky_solve(r[:, None], L)[:, 0]
            Dx = Dmul(x1)
            x2 = (bx[n:] - d1 * bz[:n - 1] - d2 * bz[n - 1:] +
                  (d1 - d2) * Dx) / (d1 + d2)
            # unscaled uz = (W'W)^{-1}(G ux - bz), here diag(d1, d2)
            z1 = d1 * (Dx - x2 - bz[:n - 1])
            z2 = d2 * (-Dx - x2 - bz[n - 1:])
            return (torch.cat([x1, x2]), bx.new_zeros(0),
                    torch.cat([z1, z2]))

        return solve

    return coneqp(Pop, q, Gop, np.zeros(2 * (n - 1)), {"l": 2 * (n - 1)},
                  kktsolver=kktsolver)


# ---------------------------------------------------------------------------
# basispursuit (book/chap6/basispursuit.py, scaled down): the lasso
# minimize ||Ax - y||_2^2 + ||x||_1 as a QP

def basispursuit_data(seed=2, N=40, K=80):
    """(A, y): a sparse signal of K entries seen through N measurements."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, K)) / np.sqrt(N)
    x_true = np.zeros(K)
    x_true[[3, 17, 41]] = [2.0, -1.5, 1.0]
    y = A @ x_true + 0.01 * rng.standard_normal(N)
    return A, y


def basispursuit_problem(data):
    A, y = data
    K = A.shape[1]
    P = np.zeros((2 * K, 2 * K))
    P[:K, :K] = 2.0 * A.T @ A
    q = np.concatenate([-2.0 * A.T @ y, np.ones(K)])
    I = np.eye(K)
    G = np.block([[I, -I], [-I, -I]])
    return P, q, G, np.zeros(2 * K)


def basispursuit(data):
    return qp(*basispursuit_problem(data))


# ---------------------------------------------------------------------------
# regsel (book/chap6/regsel.py): regressor selection, the l1-constrained
# least-squares QP swept over the bound alpha

def regsel_data(seed=3, m=20, n=10):
    """(A, b)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def regsel_problems(data):
    """[(alpha, (P, q, G, h))] for alpha = (0.2, 0.5, 0.8, 1.0) times
    the least-squares solution's 1-norm."""
    A, b = data
    n = A.shape[1]
    xln = np.linalg.lstsq(A, b, rcond=None)[0]
    P = np.zeros((2 * n, 2 * n))
    P[:n, :n] = A.T @ A
    q = np.concatenate([-A.T @ b, np.zeros(n)])
    I = np.eye(n)
    G = np.zeros((2 * n + 1, 2 * n))
    G[:n, :n] = I; G[:n, n:] = -I
    G[n:2 * n, :n] = -I; G[n:2 * n, n:] = -I
    G[2 * n, n:] = 1.0
    out = []
    for alpha in np.abs(xln).sum() * np.array([0.2, 0.5, 0.8, 1.0]):
        h = np.zeros(2 * n + 1)
        h[-1] = alpha
        out.append((alpha, (P, q, G, h)))
    return out


def regsel(data):
    """The sweep's solutions, one per alpha."""
    return [qp(*prob) for _, prob in regsel_problems(data)]


# ---------------------------------------------------------------------------
# maxent (book/chap7/maxent.py): the maximum-entropy distribution on 50
# points under the moment and probability bounds of the book's figure

def maxent_data(seed=None, n=50):
    """(G, h, A, b): the constraints of the book figure (no random
    data)."""
    a = -1.0 + 2.0 / (n - 1) * np.arange(n)
    I = a < 0
    G = np.zeros((8, n))
    G[0], G[1] = -a, a
    G[2], G[3] = -a ** 2, a ** 2
    G[4], G[5] = -(3 * a ** 3 - 2 * a), 3 * a ** 3 - 2 * a
    G[6, I], G[7, I] = -1.0, 1.0
    h = np.array([0.1, 0.1, -0.5, 0.6, 0.3, -0.2, -0.3, 0.4])
    return G, h, np.ones((1, n)), np.array([1.0])


def maxent(data):
    """cp: minimize sum x log x over the distributions of maxent_data."""
    G, h, A, b = data
    n = G.shape[1]

    def F(x=None, z=None):
        if x is None:
            return 0, np.ones(n)
        if float(x.min()) <= 0.0:
            return None
        f = torch.dot(x, torch.log(x)).reshape(1)
        grad = (1.0 + torch.log(x)).reshape(1, -1)
        if z is None:
            return f, grad
        return f, grad, torch.diag(z[0] / x)

    return cp(F, G, h, A=A, b=b)


# ---------------------------------------------------------------------------
# expdesign (book/chap7/expdesign.py): D-optimal experiment design,
# minimize -log det V diag(x) V' over the probability simplex

def expdesign_data(seed=None):
    """V (2, 20): the book's test vectors (no random data)."""
    return np.array([
        [-2.1213, -2.2981, -2.4575, -2.5981, -2.7189, -2.8191, -2.8978,
         -2.9544, -2.9886, -3.0000, 1.5000, 1.4772, 1.4095, 1.2990,
         1.1491, 0.9642, 0.7500, 0.5130, 0.2605, 0.0000],
        [2.1213, 1.9284, 1.7207, 1.5000, 1.2679, 1.0261, 0.7765,
         0.5209, 0.2615, 0.0000, 0.0000, -0.2605, -0.5130, -0.7500,
         -0.9642, -1.1491, -1.2990, -1.4095, -1.4772, -1.5000]])


def expdesign(V):
    n = V.shape[1]
    data = OnDevice(V=V)

    def F(x=None, z=None):
        if x is None:
            return 0, np.ones(n)
        V = data(x).V
        X = (V * x[None, :]) @ V.T
        det = torch.linalg.det(X)
        if float(det) <= 0:
            return None
        Xi = torch.linalg.inv(X)
        f = -torch.log(det).reshape(1)
        gradf = -(V * (Xi @ V)).sum(dim=0).reshape(1, -1)
        if z is None:
            return f, gradf
        return f, gradf, z[0] * (V.T @ Xi @ V) ** 2

    return cp(F, -np.eye(n), np.zeros(n), A=np.ones((1, n)),
              b=np.array([1.0]))


# ---------------------------------------------------------------------------
# covsel (doc/chap7/covsel.py): covariance selection by Newton's method
# on a sparse pattern, with cholmod's symbolic/numeric/solve/diag

def covsel_data(seed=5, n=25):
    """dict(Y, rows, cols, lower): Y the sample covariance restricted to a
    banded + random symmetric pattern (rows, cols: the pattern's entries),
    lower the pattern's lower-triangle coordinates (I, J)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, 4 * n))
    C = M @ M.T / (4 * n)
    mask = np.tril(np.abs(np.arange(n)[:, None] -
                          np.arange(n)[None, :]) <= 1)
    extra = sp.random(n, n, 0.05, random_state=7).toarray() != 0
    mask |= np.tril(extra | extra.T)
    full = mask | mask.T
    rows, cols = np.nonzero(full)
    return dict(Y=np.where(full, C, 0.0), rows=rows, cols=cols,
                lower=np.nonzero(mask))


def covsel(data, maxiters=60):
    """Newton's method on -log det K + tr(K Y) over K with the pattern
    of Y, the line search refactoring through cholmod.numeric ->
    dict(K, iterations, decrement)."""
    import scipy.sparse as sp
    from kvxopt_tpu_torch import cholmod
    from kvxopt_tpu_torch.base import matrix, spmatrix

    Yd, rows, cols = data["Y"], data["rows"], data["cols"]
    Iis, Jjs = data["lower"]
    n = Yd.shape[0]
    # Newton coordinates: lower-triangle pattern with symmetric basis
    # matrices B_k (E_ii, or E_ij + E_ji), like the reference's I,J lists
    nc = len(Iis)
    Bs = np.zeros((nc, n, n))
    Bs[np.arange(nc), Iis, Jjs] = 1.0
    Bs[np.arange(nc), Jjs, Iis] = 1.0

    F = cholmod.symbolic(spmatrix._from_csc(sp.csc_matrix(
        (np.where(rows == cols, 1.0, 1e-8), (rows, cols)), shape=(n, n))))

    def numeric(Kd):
        cholmod.numeric(spmatrix._from_csc(sp.csc_matrix(
            (Kd[rows, cols], (rows, cols)), shape=(n, n))), F)

    def logdet():
        return 2.0 * np.log(np.asarray(cholmod.diag(F))).sum()

    Kcur = np.eye(n)
    for it in range(maxiters):
        numeric(Kcur)
        Kinv_m = matrix(np.eye(n))
        cholmod.solve(F, Kinv_m)          # K^{-1} in place
        Kinv = np.asarray(Kinv_m)
        R = Yd - Kinv
        grad = np.einsum("kij,ij->k", Bs, R)
        T = np.einsum("ip,kpq,qj->kij", Kinv, Bs, Kinv)
        hess = np.einsum("kij,lij->kl", Bs, T)
        v = np.linalg.solve(hess + 1e-13 * np.eye(nc), -grad)
        sqntdecr = -grad @ v
        if sqntdecr < 1e-12:
            break
        dK = np.einsum("k,kij->ij", v, Bs)
        f = (Kcur * Yd).sum() - logdet()
        s = 1.0
        for _ in range(50):
            Kn = Kcur + s * dK
            try:
                numeric(Kn)
            except ArithmeticError:
                s *= 0.5
                continue
            if (Kn * Yd).sum() - logdet() < f - 0.01 * s * sqntdecr:
                break
            s *= 0.5
        Kcur = Kcur + s * dK
    return dict(K=Kcur, iterations=it, decrement=float(sqntdecr))
