"""The conelp, lp, socp and sdp front ends of the port against the JAX
package's, on the problems of tests/test_conelp.py and the l1-norm
approximation of tests/test_custom_kkt.py (operator-form G with a custom
kktsolver written in torch).

Both sides get the same numpy inputs; the port runs on CPU tensors (the
device is set by a fixture).  The bar is test_torch_coneqp.compare's:
the same status and result keys, iterations within 1, x, y, s and z
within 1e-6 (1 + |.|), objectives within 1e-7 (1 + |obj|), and None
where JAX has None.
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import cones, config
from kvxopt_tpu_torch import solvers as tsolvers
from .test_torch_coneqp import both, compare


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def userguide_lp():
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    return c, G, np.array([3.0, 3.0, 0.0, 0.0])


def test_lp_userguide():
    ref, sol = both("lp", *userguide_lp())
    compare(ref, sol)
    np.testing.assert_allclose(sol["x"].numpy(), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(sol["primal objective"], -9.0, atol=1e-6)


def test_lp_random_with_equalities():
    rng = np.random.default_rng(0)
    n, m, p = 10, 18, 3
    c = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.2, 2.0, m)
    A = rng.standard_normal((p, n))
    G = np.vstack([G, np.eye(n), -np.eye(n)])
    h = np.concatenate([h, np.abs(x0) + 10.0, np.abs(x0) + 10.0])
    ref, sol = both("lp", c, G, h, A, A @ x0)
    assert sol["status"] == "optimal"
    compare(ref, sol)


def test_lp_primal_infeasible():
    """x <= -1 and x >= 1: z >= 0, G'z = 0, h'z = -1."""
    G, h = np.array([[1.0], [-1.0]]), np.array([-1.0, -1.0])
    ref, sol = both("lp", np.array([1.0]), G, h)
    assert sol["status"] == "primal infeasible"
    compare(ref, sol)
    for k in ref:
        assert (sol[k] is None) == (ref[k] is None), k
    z = sol["z"].numpy()
    assert (z >= -1e-8).all()
    np.testing.assert_allclose(G.T @ z, [0.0], atol=1e-6)
    np.testing.assert_allclose(h @ z, -1.0, atol=1e-6)


def test_lp_dual_infeasible():
    """minimize -x s.t. x >= 0: c'x = -1, Gx + s = 0, s >= 0."""
    c, G = np.array([-1.0]), np.array([[-1.0]])
    ref, sol = both("lp", c, G, np.array([0.0]))
    assert sol["status"] == "dual infeasible"
    compare(ref, sol)
    for k in ref:
        assert (sol[k] is None) == (ref[k] is None), k
    x, s = sol["x"].numpy(), sol["s"].numpy()
    np.testing.assert_allclose(c @ x, -1.0, atol=1e-6)
    np.testing.assert_allclose(G @ x + s, [0.0], atol=1e-6)
    assert (s >= -1e-8).all()


def userguide_socp():
    c = np.array([-2.0, 1.0, 5.0])
    G1 = -np.vstack([[-12.0, -6.0, 5.0], [-13.0, 3.0, 5.0],
                     [-12.0, 12.0, -6.0]])
    h1 = np.array([-12.0, -3.0, -2.0])
    G2 = -np.vstack([[-3.0, 6.0, -10.0], [-3.0, 6.0, 2.0], [1.0, 9.0, 2.0],
                     [-1.0, -19.0, 3.0]])
    h2 = np.array([27.0, 0.0, 3.0, -42.0])
    return c, [G1, G2], [h1, h2]


def test_socp_userguide():
    c, Gq, hq = userguide_socp()
    ref, sol = both("socp", c, Gq=Gq, hq=hq)
    assert sol["status"] == "optimal"
    compare(ref, sol)
    np.testing.assert_allclose(sol["x"].numpy(), [-5.0147, -5.7669, -8.5217],
                               atol=2e-3)
    for k in ("zq", "sq"):
        assert len(sol[k]) == 2
        for a, b in zip(sol[k], ref[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_conelp_small_sdp():
    c = np.array([1.0, 1.0])
    G = np.column_stack([np.diag([-1.0, 0.0]).ravel(),
                         np.diag([0.0, -1.0]).ravel()])
    h = -np.array([[0.0, 1.0], [1.0, 0.0]]).ravel()
    ref, sol = both("conelp", c, G, h, {"l": 0, "s": [2]})
    assert sol["status"] == "optimal"
    compare(ref, sol)
    np.testing.assert_allclose(sol["x"].numpy(), [1.0, 1.0], atol=1e-5)


def test_sdp_wrapper():
    c = np.array([1.0, 1.0])
    Gs = [np.column_stack([np.diag([-1.0, 0.0]).ravel(),
                           np.diag([0.0, -1.0]).ravel()])]
    hs = [np.array([[0.0, -1.0], [-1.0, 0.0]])]
    ref, sol = both("sdp", c, Gs=Gs, hs=hs)
    assert sol["status"] == "optimal"
    compare(ref, sol)
    assert len(sol["zs"]) == 1 and sol["zs"][0].shape == (2, 2)
    assert sol["ss"][0].shape == (2, 2)
    np.testing.assert_allclose(sol["zs"][0].numpy(), np.asarray(ref["zs"][0]),
                               atol=1e-6)


def test_conelp_mixed_cones():
    """l + q + s blocks together (tests/test_conelp.py), with the KKT
    conditions checked on the port's result."""
    rng = np.random.default_rng(7)
    n = 6
    dims = cones.ConeDims(l=4, q=(3,), s=(3,))
    N = dims.size
    Gm = rng.standard_normal((N, n))
    for ofs, m in zip(dims.sofs, dims.s):
        for col in range(n):
            X = Gm[ofs:ofs + m * m, col].reshape(m, m)
            Gm[ofs:ofs + m * m, col] = (0.5 * (X + X.T)).ravel()
    x0 = rng.standard_normal(n)
    s0 = np.zeros(N)
    s0[:4] = rng.uniform(0.5, 1.5, 4)
    s0[4] = 2.0
    s0[5:7] = rng.standard_normal(2) * 0.3
    S = rng.standard_normal((3, 3))
    s0[7:] = (S @ S.T + 3 * np.eye(3)).ravel()
    h = Gm @ x0 + s0
    c = -Gm.T @ np.concatenate([rng.uniform(0.5, 1.5, 4), [2.0, 0.1, 0.1],
                                (np.eye(3) + 0.1 * np.ones((3, 3))).ravel()])
    ref, sol = both("conelp", c, Gm, h, {"l": 4, "q": [3], "s": [3]})
    assert sol["status"] == "optimal"
    compare(ref, sol)
    x, s, z = (sol[k].numpy() for k in "xsz")
    assert np.linalg.norm(Gm.T @ z + c) < 1e-5 * np.linalg.norm(c)
    assert np.linalg.norm(Gm @ x + s - h) < 1e-5 * np.linalg.norm(h)
    ts, tz = cones.max_step2(dims, sol["s"][None], sol["z"][None])
    assert float(ts) < 1e-7 and float(tz) < 1e-7


def test_global_options_dict():
    """The shared solvers.options: maxiters=2 gives 'unknown' after two
    iterations, and a per-call option wins over it."""
    c, G, h = userguide_lp()
    jsolvers.options["maxiters"] = tsolvers.options["maxiters"] = 2
    try:
        ref, sol = both("lp", c, G, h)
        assert sol["status"] == "unknown" and sol["iterations"] <= 2
        compare(ref, sol)
        ref, sol = both("lp", c, G, h, options={"maxiters": 100})
        assert sol["status"] == "optimal"
        compare(ref, sol)
    finally:
        jsolvers.options.clear()
        tsolvers.options.clear()


def test_conelp_warm_start():
    c, G, h = userguide_lp()
    cold = tsolvers.conelp(c, G, h, {"l": 4})
    x0 = cold["x"].numpy()
    starts = dict(primalstart={"x": x0, "s": np.maximum(h - G @ x0, 1e-3)},
                  dualstart={"y": np.zeros(0),
                             "z": np.maximum(cold["z"].numpy(), 1e-3)})
    ref, warm = both("conelp", c, G, h, {"l": 4}, **starts)
    assert warm["status"] == "optimal"
    assert warm["iterations"] <= cold["iterations"]
    compare(ref, warm)
    for one in ("primalstart", "dualstart"):
        compare(*both("conelp", c, G, h, {"l": 4}, **{one: starts[one]}))


def test_lp_equilibrate_badly_scaled():
    """Rows and columns spanning 10 orders of magnitude, Ruiz-scaled
    first; the port's unscaled result satisfies the unscaled LP."""
    rng = np.random.default_rng(13)
    n, m = 6, 12
    rscale = 10.0 ** rng.uniform(-5, 5, m)
    cscale = 10.0 ** rng.uniform(-4, 4, n)
    G = rng.standard_normal((m, n)) * rscale[:, None] * cscale[None, :]
    x0 = rng.standard_normal(n) / cscale
    h = G @ x0 + rscale * rng.uniform(0.5, 1.5, m)
    c = -G.T @ (rng.uniform(0.1, 1.0, m) / rscale)
    ref, sol = both("lp", c, G, h, options={"equilibrate": True})
    assert sol["status"] == "optimal"
    assert set(sol) == set(ref) and sol["iterations"] == ref["iterations"]
    for k in "xsz":
        r = np.asarray(ref[k])
        assert np.linalg.norm(sol[k].numpy() - r) <= 1e-6 * (
            1 + np.linalg.norm(r)), k
    x, z = sol["x"].numpy(), sol["z"].numpy()
    assert (G @ x <= h + 1e-6 * np.abs(h).max()).all()
    assert np.linalg.norm(G.T @ z + c) < 1e-5 * np.linalg.norm(c)


def test_l1_operator_form_with_torch_kktsolver():
    """minimize ||Ax - b||_1 as an LP in (x, u): dense through both
    packages, and through the port with operator G = [A -I; -A -I] and a
    custom kktsolver reducing the KKT system to A' diag(w) A
    (tests/test_custom_kkt.py); the custom solve matches the dense ones."""
    m, n = 60, 20
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    c = np.concatenate([np.zeros(n), np.ones(m)])
    G = np.block([[A, -np.eye(m)], [-A, -np.eye(m)]])
    h = np.concatenate([b, -b])
    ref, dense = both("conelp", c, G, h, {"l": 2 * m})
    compare(ref, dense)

    At = torch.from_numpy(A)

    def Gop(v, trans=False):
        if trans:
            z1, z2 = v[:m], v[m:]
            return torch.cat([At.T @ (z1 - z2), -z1 - z2])
        Ax = At @ v[:n]
        return torch.cat([Ax - v[n:], -Ax - v[n:]])

    def kktsolver(W):
        p = 1.0 / W.d[:m] ** 2
        q = 1.0 / W.d[m:] ** 2
        S = p + q
        L = torch.linalg.cholesky((At.T * (4.0 * p * q / S)[None, :]) @ At)

        def solve(bx, by, bz):
            bz1, bz2 = bz[:m], bz[m:]
            cu = bx[n:] - p * bz1 - q * bz2
            r = bx[:n] + At.T @ ((p - q) / S * cu + p * bz1 - q * bz2)
            x = torch.cholesky_solve(r[:, None], L)[:, 0]
            Ax = At @ x
            u = (cu + (p - q) * Ax) / S
            return (torch.cat([x, u]), torch.zeros(0, dtype=bx.dtype),
                    torch.cat([p * (Ax - u - bz1), q * (-Ax - u - bz2)]))

        return solve

    custom = tsolvers.conelp(torch.from_numpy(c), Gop, torch.from_numpy(h),
                             {"l": 2 * m}, kktsolver=kktsolver)
    assert custom["status"] == "optimal"
    compare(ref, custom)
