"""The coneqp and qp front ends of the port against the JAX package's, on
the problems of tests/test_coneqp.py and the l1-regularized least
squares of tests/test_custom_kkt.py (operator-form P and G with a custom
kktsolver written in torch).

Both sides get the same numpy inputs; the port runs on CPU tensors (the
device is set by a fixture).  The bar, unless a test says otherwise: the
same status and result keys, iterations within 1, x, y, s and z within
1e-6 (1 + |.|) of JAX's, the primal and dual objectives within
1e-7 (1 + |obj|).
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import solvers as tsolvers


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def compare(ref, sol, vtol=1e-6, otol=1e-7):
    """The port's result dict `sol` against the JAX package's `ref`."""
    assert set(sol) == set(ref)
    assert sol["status"] == ref["status"]
    assert abs(sol["iterations"] - ref["iterations"]) <= 1, (
        sol["iterations"], ref["iterations"])
    for k in ("x", "y", "s", "z"):
        assert (sol[k] is None) == (ref[k] is None), k
        if ref[k] is None:
            continue
        assert isinstance(sol[k], torch.Tensor), k
        r = np.asarray(ref[k])
        d = np.linalg.norm(sol[k].numpy() - r) / (1 + np.linalg.norm(r))
        assert d <= vtol, (k, d)
    for k in ("primal objective", "dual objective"):
        assert (sol[k] is None) == (ref[k] is None), k
        if ref[k] is not None:
            assert abs(sol[k] - ref[k]) <= otol * (1 + abs(ref[k])), (
                k, sol[k], ref[k])


def both(fn, *args, **kw):
    """(JAX result, port result) of the front end `fn` on the same
    inputs."""
    return (getattr(jsolvers, fn)(*args, **kw),
            getattr(tsolvers, fn)(*args, **kw))


def box():
    rng = np.random.default_rng(0)
    n = 8
    a = rng.standard_normal(n) * 1.5
    G = np.vstack([np.eye(n), -np.eye(n)])
    h = np.concatenate([np.ones(n), np.zeros(n)])
    return np.eye(n), -a, G, h


def with_equalities():
    rng = np.random.default_rng(1)
    n, m, p = 10, 6, 3
    M = rng.standard_normal((n, n))
    P = M @ M.T + np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = rng.standard_normal(m) + 1.0
    A = rng.standard_normal((p, n))
    b = rng.standard_normal(p)
    return P, q, G, h, A, b


def test_qp_box():
    ref, sol = both("qp", *box())
    compare(ref, sol)
    np.testing.assert_allclose(sol["x"].numpy(), np.clip(-box()[1], 0, 1),
                               atol=5e-4)


def test_qp_with_equalities():
    compare(*both("qp", *with_equalities()))


def strategy_problem():
    rng = np.random.default_rng(2)
    n, m = 6, 10
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, G, h


@pytest.mark.parametrize("kktsolver", ["ldl", "ldl2", "chol", "chol2", "qr",
                                       "chol2_mixed"])
def test_qp_all_kkt_strategies(kktsolver):
    """chol2_mixed runs at the relaxed tolerances of tests/test_coneqp.py
    (its f32 factor's refinement floor) on both sides."""
    opts = ({"abstol": 1e-6, "reltol": 1e-5, "feastol": 1e-6}
            if kktsolver == "chol2_mixed" else None)
    ref, sol = both("qp", *strategy_problem(), kktsolver=kktsolver,
                    options=opts)
    assert sol["status"] == "optimal"
    compare(ref, sol)


def test_coneqp_socp_cone():
    rng = np.random.default_rng(3)
    n = 5
    a = rng.standard_normal(n)
    ref, sol = both("coneqp", 2 * np.eye(n), -a, -np.eye(n), np.zeros(n),
                    {"l": 0, "q": [n]})
    assert sol["status"] == "optimal"
    compare(ref, sol)


def test_coneqp_sdp_cone():
    """min tr(X) + ||X - C||_F^2 / 2 over X psd, X in a symmetric basis."""
    rng = np.random.default_rng(4)
    m = 3
    C = rng.standard_normal((m, m))
    C = 0.5 * (C + C.T)
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    basis = []
    for i, j in pairs:
        Bm = np.zeros((m, m))
        Bm[i, j] = Bm[j, i] = 1.0
        basis.append(Bm)
    w = np.array([1.0 if i == j else 2.0 for i, j in pairs])
    q = np.array([(1.0 if i == j else 0.0) - w[k] * C[i, j]
                  for k, (i, j) in enumerate(pairs)])
    G = -np.stack([Bm.ravel() for Bm in basis], axis=1)
    ref, sol = both("coneqp", np.diag(w), q, G, np.zeros(m * m),
                    {"l": 0, "s": [m]})
    assert sol["status"] == "optimal"
    compare(ref, sol)


def initvals_problem():
    rng = np.random.default_rng(5)
    n, m = 5, 8
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    return np.eye(n), q, G, np.ones(m)


@pytest.mark.parametrize("keys", ["xysz", "sz", "x"])
def test_coneqp_initvals(keys):
    """Full and partial initvals: the missing entries default to zero (x,
    y) and to the cone's identity (s, z) on both sides."""
    P, q, G, h = initvals_problem()
    n, m = q.size, h.size
    full = {"x": 0.1 * np.ones(n), "y": np.zeros(0), "s": 2 * np.ones(m),
            "z": 0.5 * np.ones(m)}
    iv = {k: full[k] for k in keys}
    ref, sol = both("coneqp", P, q, G, h, {"l": m}, initvals=iv)
    assert sol["status"] == "optimal"
    compare(ref, sol)


def test_l1regls_operator_form_with_torch_kktsolver():
    """minimize ||Ax - b||^2 + ||x||_1 as a QP in (x, u): dense through
    both packages, and through the port with operator P and G and a
    custom kktsolver that reduces the KKT system to an n x n Cholesky
    (tests/test_custom_kkt.py); the custom solve matches the dense ones."""
    m, n = 40, 25
    rng = np.random.default_rng(1)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    q = np.concatenate([-2.0 * (A.T @ b), np.ones(n)])
    G = np.block([[np.eye(n), -np.eye(n)], [-np.eye(n), -np.eye(n)]])
    P = np.block([[2.0 * A.T @ A, np.zeros((n, n))],
                  [np.zeros((n, n)), np.zeros((n, n))]])
    ref, dense = both("coneqp", P, q, G, np.zeros(2 * n), {"l": 2 * n})
    compare(ref, dense)

    At = torch.from_numpy(A)

    def Pop(v):
        return torch.cat([2.0 * (At.T @ (At @ v[:n])), torch.zeros(n)])

    def Gop(v, trans=False):
        if trans:
            z1, z2 = v[:n], v[n:]
            return torch.cat([z1 - z2, -z1 - z2])
        x, u = v[:n], v[n:]
        return torch.cat([x - u, -x - u])

    def kktsolver(W):
        assert W.d.shape == (2 * n,) and W.beta == () and W.r == ()
        p = 1.0 / W.d[:n] ** 2
        qd = 1.0 / W.d[n:] ** 2
        S = p + qd
        L = torch.linalg.cholesky(2.0 * At.T @ At + torch.diag(4.0 * p * qd /
                                                               S))

        def solve(bx, by, bz):
            bz1, bz2 = bz[:n], bz[n:]
            cu = bx[n:] - p * bz1 - qd * bz2
            r = bx[:n] + (p - qd) / S * cu + p * bz1 - qd * bz2
            x = torch.cholesky_solve(r[:, None], L)[:, 0]
            u = (cu + (p - qd) * x) / S
            return (torch.cat([x, u]), torch.zeros(0, dtype=bx.dtype),
                    torch.cat([p * (x - u - bz1), qd * (-x - u - bz2)]))

        return solve

    custom = tsolvers.coneqp(Pop, torch.from_numpy(q), Gop,
                             torch.zeros(2 * n, dtype=torch.float64),
                             {"l": 2 * n}, kktsolver=kktsolver)
    assert custom["status"] == "optimal"
    compare(ref, custom)
