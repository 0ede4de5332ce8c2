"""The port's solver bridges (glpk, osqp, dsdp) and the solver= routes of
its front ends against the JAX package's, on the cases of
tests/test_bridges.py: each case runs the same code on each package's
own modules and types, the port on the CPU.

Tolerances: glpk and dsdp (the same numpy/scipy code) to 1e-10;
osqp the same status and iterations and x to 1e-9; the conelp route of
dsdp (two solvers' conelp) the same status and x to 1e-6.  One test
needs the card (marked `cuda`, skipped where there is none) and imports
no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_bridges.py
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import kvxopt_tpu_torch as tpkg
from kvxopt_tpu_torch import config

TIGHT = 1e-10


def jax_package():
    """kvxopt_tpu, imported only by the tests that compare with it."""
    return importlib.import_module("kvxopt_tpu")


def modules(pkg):
    """The package's bridges and solvers, as attributes of one object."""
    for name in ("glpk", "osqp", "dsdp", "solvers"):
        importlib.import_module(f"{pkg.__name__}.{name}")
    return pkg


def both(case):
    """case(pkg) with the port on the CPU, then with the JAX package."""
    with config.using_device("cpu"):
        port = case(modules(tpkg))
    return port, case(modules(jax_package()))


def host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v, dtype=float)


def same(a, b, tol=TIGHT, what=()):
    """a (the port's) equal to b (the JAX package's): dicts key by key,
    sequences item by item, strings and None exactly, numbers and arrays
    to tol (1 + |b|)."""
    if isinstance(b, dict):
        assert set(a) == set(b), (what, sorted(a), sorted(b))
        for k in b:
            same(a[k], b[k], tol, what + (k,))
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            same(u, v, tol, what + (i,))
    elif b is None or isinstance(b, str):
        assert a == b, (what, a, b)
    else:
        u, v = host(a), host(b)
        assert u.shape == v.shape, (what, u.shape, v.shape)
        assert np.array_equal(np.isnan(u), np.isnan(v)), what
        ok = ~np.isnan(v)
        err = np.abs(u[ok] - v[ok]).max(initial=0.0)
        assert err <= tol * (1 + np.abs(v[ok]).max(initial=0.0)), (what, err)


def lp_data(pkg):
    c = pkg.matrix([-4.0, -5.0])
    G = pkg.matrix([[2.0, 1.0, -1.0, 0.0], [1.0, 2.0, 0.0, -1.0]])
    h = pkg.matrix([3.0, 3.0, 0.0, 0.0])
    A = pkg.matrix([1.0, 1.0], (1, 2))
    b = pkg.matrix(1.0)
    return c, G, h, A, b


OSQP_OPTS = {"verbose": 0, "eps_abs": 1e-9, "eps_rel": 1e-9,
             "max_iter": 10000, "rho": 0.1, "adaptive_rho": False,
             "polish": False, "check_termination": 1, "warm_start": True}


# ---------------------------------------------------------------------------
# glpk
# ---------------------------------------------------------------------------

def glpk_lp(pkg):
    c, G, h, A, b = lp_data(pkg)
    return [pkg.solvers.lp(c, G, h, solver="glpk"),
            pkg.solvers.lp(c, G, h, A, b, solver="glpk"),
            pkg.glpk.lp(c, G, h), pkg.glpk.lp(c, G, h, A, b),
            pkg.glpk.lp(c, G, h, None, None)]


def glpk_ilp(pkg):
    c, G, h, A, b = lp_data(pkg)
    return [pkg.glpk.ilp(c, G, h, A, b, {0}, set()),
            pkg.glpk.ilp(c, G, h, None, None, {0, 1}, set()),
            pkg.glpk.ilp(c, G, h, None, None, set(), {1}),
            pkg.glpk.ilp(c, G, h, A, pkg.matrix(-1.0), set(), {0, 1})]


def glpk_options(pkg):
    c, G, h, _, _ = lp_data(pkg)
    old = pkg.glpk.options
    pkg.glpk.options = {"msg_lev": "GLP_MSG_OFF"}
    try:
        return [pkg.glpk.lp(c, G, h),
                pkg.glpk.lp(c, G, h, options={"msg_lev": "GLP_MSG_ON"}),
                pkg.solvers.lp(c, G, h, solver="glpk",
                               options={"glpk": {"msg_lev": "GLP_MSG_ON"}})]
    finally:
        pkg.glpk.options = old


def glpk_options_honored(pkg):
    rng = np.random.default_rng(0)
    n, m = 40, 120
    G = np.vstack([rng.standard_normal((m - 2 * n, n)), np.eye(n),
                   -np.eye(n)])
    h = np.concatenate([rng.uniform(1, 2, m - 2 * n), np.full(2 * n, 5.0)])
    c = rng.standard_normal(n)
    out = [pkg.glpk.lp(c, G, h),
           pkg.glpk.lp(c, G, h,
                       options={"it_lim": 0, "presolve": "GLP_OFF"})[0],
           pkg.glpk.lp(c, G, h, options={
               "tol_bnd": 1e-9, "tol_dj": 1e-9, "msg_lev": "GLP_MSG_OFF",
               "meth": "GLP_DUAL", "pricing": "GLP_PT_PSE",
               "r_test": "GLP_RT_HAR"})]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out.append(pkg.glpk.lp(c, G, h, options={"it_lim": "nope"}))
    return out + [sorted(str(w.message) for w in rec)]


# ---------------------------------------------------------------------------
# osqp
# ---------------------------------------------------------------------------

def osqp_lp(pkg):
    c, G, h, A, b = lp_data(pkg)
    return [pkg.solvers.lp(c, G, h, solver="osqp",
                           options={"osqp": OSQP_OPTS}),
            pkg.osqp.qp(c, G, h, options=OSQP_OPTS),
            pkg.osqp.qp(c, G, h, A, b, options=OSQP_OPTS)]


def osqp_qp_data(pkg):
    q = pkg.matrix([1.0, 1.0])
    P = pkg.sparse(pkg.matrix([[4.0, 1.0], [1.0, 2.0]]))
    G = pkg.sparse(pkg.matrix([[1.0, 1, 0, -1, -1, 0],
                               [1.0, 0, 1, -1, 0, -1]]))
    h = pkg.matrix([1.0, 0.7, 0.7, -1, 0, 0])
    return P, q, G, h


def osqp_qp(pkg):
    P, q, G, h = osqp_qp_data(pkg)
    return [pkg.solvers.qp(P, q, G, h, solver="osqp",
                           options={"osqp": OSQP_OPTS})]


def osqp_eq_data(pkg):
    q = pkg.matrix([1.0, 1.0])
    P = 2 * pkg.sparse(pkg.matrix([[2.0, 0.5], [0.5, 1.0]]))
    G = pkg.sparse(pkg.matrix([[-1.0, 0.0], [0.0, -1.0]]))
    h = pkg.matrix([0.0, 0.0])
    A = pkg.sparse([1.0, 1.0]).T
    b = pkg.matrix(1.0)
    return P, q, G, h, A, b


def osqp_qp_with_equalities(pkg):
    P, q, G, h, A, b = osqp_eq_data(pkg)
    return [pkg.solvers.qp(P, q, G, h, A, b, solver="osqp",
                           options=OSQP_OPTS)]


def osqp_native_data(pkg):
    P = pkg.spdiag([11.0, 0.0])
    q = pkg.matrix([3.0, 4.0])
    A = pkg.sparse([[-1.0, 0], [0, -1.0], [-1.0, -3], [2.0, 5],
                    [3.0, 4]]).T
    u = pkg.matrix([0.0, 0.0, -15.0, 100.0, 80.0])
    l = -1e6 * pkg.matrix(1.0, u.size)
    return P, q, A, l, u


def osqp_native_format(pkg):
    P, q, A, l, u = osqp_native_data(pkg)
    return [pkg.osqp.solve(q, A, l, u, P, options=OSQP_OPTS)]


OSQP_CASES = {"lp": osqp_lp, "qp": osqp_qp,
              "qp with equalities": osqp_qp_with_equalities,
              "native format": osqp_native_format}


def stacked(P, q, G=None, h=None, A=None, b=None):
    """osqp.qp's native form (P, q, [G; A], [-inf; b], [h; b]) in numpy."""
    n = np.asarray(q).size
    rows, lo, up = [], [], []
    if G is not None:
        hv = np.asarray(h, dtype=float).ravel()
        rows.append(np.asarray(G, dtype=float).reshape(-1, n))
        lo.append(np.full(hv.size, -np.inf))
        up.append(hv)
    if A is not None:
        bv = np.asarray(b, dtype=float).ravel()
        rows.append(np.asarray(A, dtype=float).reshape(-1, n))
        lo += [bv]
        up += [bv]
    P = np.zeros((n, n)) if P is None else np.asarray(P, dtype=float)
    return (0.5 * (P + P.T), np.asarray(q, dtype=float).ravel(),
            np.vstack(rows), np.concatenate(lo), np.concatenate(up))


def admm_both(data, opts):
    """Both packages' _admm_core on the same native-form data ->
    ((x, z, y, iterations, done) of the port, of the JAX package)."""
    import jax.numpy as jnp
    from kvxopt_tpu import osqp as josqp
    from kvxopt_tpu_torch import osqp as tosqp
    o = dict(tosqp._DEFAULTS, **opts)
    args = (float(o["rho"]), float(o["sigma"]), float(o["alpha"]),
            float(o["eps_abs"]), float(o["eps_rel"]), int(o["max_iter"]),
            int(o["check_termination"]))
    port = tosqp._admm_core(*(torch.as_tensor(a) for a in data), *args)
    ref = josqp._admm_core(*(jnp.asarray(a) for a in data), *args)
    return ([np.asarray(v) for v in port[:3]] + [int(port[3]),
                                                  bool(port[4])],
            [np.asarray(v) for v in ref[:3]] + [int(ref[3]), bool(ref[4])])


def osqp_native_forms():
    """The native form of each osqp case, with its options."""
    c, G, h, A, b = (np.asarray(v) for v in lp_data(tpkg))
    P, q, Gq, hq = (np.asarray(v) for v in osqp_qp_data(tpkg))
    Pe, qe, Ge, he, Ae, be = (np.asarray(v) for v in osqp_eq_data(tpkg))
    Pn, qn, An, ln, un = (np.asarray(v) for v in osqp_native_data(tpkg))
    return {"lp": stacked(None, c, G, h),
            "lp with equalities": stacked(None, c, G, h, A, b),
            "qp": stacked(P, q, Gq, hq),
            "qp with equalities": stacked(Pe, qe, Ge, he, Ae, be),
            "native format": (0.5 * (Pn + Pn.T), qn.ravel(), An,
                              ln.ravel(), un.ravel())}


@pytest.mark.parametrize("name", sorted(OSQP_CASES))
def test_osqp_matches_jax(name):
    port, ref = both(OSQP_CASES[name])
    same(port, ref, tol=1e-9)


@pytest.mark.parametrize("name", sorted(osqp_native_forms()))
def test_osqp_iterations_match_jax(name):
    """The chunked loop stops at the JAX while_loop's iteration, with
    its iterate."""
    port, ref = admm_both(osqp_native_forms()[name], OSQP_OPTS)
    assert port[3] == ref[3] and port[4] == ref[4], (port[3:], ref[3:])
    assert port[4], "not converged"
    for u, v in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(u, v, rtol=1e-9, atol=1e-9)


def test_osqp_not_spd_runs_to_max_iter():
    """P + sigma I + rho A'A not positive definite: the factor is NaN in
    both packages, and the loop runs to max_iter with NaN iterates."""
    P = np.diag([-5.0, 1.0])
    q = np.array([1.0, -1.0])
    G = np.eye(2)
    h = np.array([1.0, 1.0])
    opts = {"max_iter": 60}
    port, ref = admm_both(stacked(P, q, G, h), opts)
    assert port[3] == ref[3] == 60 and not port[4] and not ref[4]
    assert np.isnan(port[0]).all() and np.isnan(ref[0]).all()
    res = both(lambda pkg: pkg.osqp.qp(q, G, h, P=P, options=opts))
    assert res[0][0] == res[1][0] == "max_iter_reached"
    same(*res)


# ---------------------------------------------------------------------------
# dsdp
# ---------------------------------------------------------------------------

def sdp_data(pkg):
    c = pkg.matrix([1.0, -1.0, 1.0])
    G = [pkg.matrix([[-7.0, -11.0, -11.0, 3.0],
                     [7.0, -18.0, -18.0, 8.0],
                     [-2.0, -8.0, -8.0, 1.0]])]
    G += [pkg.matrix([[-21.0, -11.0, 0.0, -11.0, 10.0, 8.0, 0.0, 8.0, 5.0],
                      [0.0, 10.0, 16.0, 10.0, -10.0, -10.0, 16.0, -10.0,
                       3.0],
                      [-5.0, 2.0, -17.0, 2.0, -6.0, 8.0, -17.0, 8.0, 6.0]])]
    h = [pkg.matrix([[33.0, -9.0], [-9.0, 26.0]])]
    h += [pkg.matrix([[14.0, 9.0, 40.0], [9.0, 91.0, 10.0],
                      [40.0, 10.0, 15.0]])]
    return c, G, h


def dsdp_sdp(pkg):
    c, Gs, hs = sdp_data(pkg)
    return [pkg.solvers.sdp(c, None, None, Gs, hs, solver="dsdp"),
            pkg.dsdp.sdp(c, None, None, Gs, hs),
            pkg.dsdp.sdp(c, Gs=Gs, hs=hs, options={"DSDP_MaxIts": 2})]


def dsdp_full_result_dict(pkg):
    c = np.array([1.0, -1.0, 1.0])
    Gs = [np.array([[-7., -11., -11., 3.], [7., -18., -18., 8.],
                    [-2., -8., -8., 1.]]).T,
          np.array([[-21., -11., 0., -11., 10., 8., 0., 8., 5.],
                    [0., 10., 16., 10., -10., -10., 16., -10., 3.],
                    [-5., 2., -17., 2., -6., 8., -17., 8., 6.]]).T]
    hs = [np.array([[33., -9.], [-9., 26.]]),
          np.array([[14., 9., 40.], [9., 91., 10.], [40., 10., 15.]])]
    return [pkg.solvers.sdp(c, Gs=Gs, hs=hs, solver="dsdp"),
            pkg.solvers.sdp(c, Gs=Gs, hs=hs, solver="dsdp",
                            options={"dsdp": {"DSDP_MaxIts": 2}})]


def symmetric_columns(rng, m, n):
    Gk = rng.standard_normal((m * m, n))
    for i in range(n):
        M = Gk[:, i].reshape(m, m)
        Gk[:, i] = (0.5 * (M + M.T)).ravel()
    return Gk


def dsdp_linear_rows(pkg):
    rng = np.random.default_rng(3)
    n, ml, m = 3, 4, 3
    c = pkg.matrix(rng.standard_normal((n, 1)))
    Gl = pkg.matrix(rng.standard_normal((ml, n)))
    hl = pkg.matrix(np.abs(rng.standard_normal((ml, 1))) + 1.0)
    Gk = symmetric_columns(rng, m, n)
    Q = rng.standard_normal((m, m))
    H = Q @ Q.T + m * np.eye(m)
    return [pkg.dsdp.sdp(c, Gl, hl, [pkg.matrix(Gk)], [pkg.matrix(H)])]


def dsdp_infeasible(pkg):
    return [pkg.dsdp.sdp(pkg.matrix([0.0]), Gs=[pkg.matrix(np.zeros((4, 1)))],
                         hs=[pkg.matrix(-np.eye(2))])]


def dsdp_unbounded(pkg):
    return [pkg.dsdp.sdp(pkg.matrix([-1.0]), Gs=[pkg.matrix(np.zeros((4, 1)))],
                         hs=[pkg.matrix(np.eye(2))], beta=100.0)]


def dsdp_random_sweep(pkg):
    rng = np.random.default_rng(7)
    out = []
    for trial in range(5):
        n, m = 2 + trial % 3, 2 + trial % 2
        Gk = symmetric_columns(rng, m, n)
        Q = rng.standard_normal((m, m))
        H = Q @ Q.T + m * np.eye(m)
        c = rng.standard_normal(n)
        out.append(pkg.dsdp.sdp(pkg.matrix(c.reshape(-1, 1)),
                                Gs=[pkg.matrix(Gk)], hs=[pkg.matrix(H)]))
    return out


DSDP_CASES = {"sdp": dsdp_sdp, "full result dict": dsdp_full_result_dict,
              "linear rows": dsdp_linear_rows, "infeasible": dsdp_infeasible,
              "unbounded": dsdp_unbounded, "random sweep": dsdp_random_sweep}
GLPK_CASES = {"lp": glpk_lp, "ilp": glpk_ilp, "options": glpk_options,
              "options honored": glpk_options_honored}


@pytest.mark.parametrize("name", sorted(GLPK_CASES))
def test_glpk_matches_jax(name):
    same(*both(GLPK_CASES[name]))


@pytest.mark.parametrize("name", sorted(DSDP_CASES))
def test_dsdp_matches_jax(name):
    same(*both(DSDP_CASES[name]))


def test_dsdp_expected_statuses():
    """The statuses tests/test_bridges.py expects, in the port."""
    with config.using_device("cpu"):
        p = modules(tpkg)
        assert [r[0] for r in dsdp_sdp(p)[1:]] == ["DSDP_PDFEASIBLE",
                                                  "DSDP_UNKNOWN"]
        assert dsdp_infeasible(p)[0][0] == "DSDP_INFEASIBLE"
        assert dsdp_unbounded(p)[0][0] == "DSDP_UNBOUNDED"
        assert [s["status"] for s in dsdp_full_result_dict(p)] == [
            "optimal", "unknown"]


def test_dsdp_conelp_route():
    """DSDP_UseConelp: the port's solvers.sdp against the JAX package's,
    the result brought to the host as matrices."""
    def case(pkg):
        c = pkg.matrix([1.0, -1.0, 1.0])
        Gs = [pkg.matrix(np.zeros((4, 3)))]
        Gs[0][0, 0] = -1.0
        Gs[0][3, 1] = -1.0
        return pkg.dsdp.sdp(c, Gs=Gs, hs=[pkg.matrix(np.eye(2))],
                            options={"DSDP_UseConelp": 1})
    port, ref = both(case)
    assert port[0] == ref[0]
    assert all(isinstance(v, tpkg.matrix) for v in (port[1], port[3]))
    same(port[1], ref[1], tol=1e-6)


# ---------------------------------------------------------------------------
# The routes take tensors, and bring them to the host
# ---------------------------------------------------------------------------

ROUTES = {
    "lp glpk": lambda s, c, G, h: s.lp(c, G, h, solver="glpk"),
    "lp osqp": lambda s, c, G, h: s.lp(c, G, h, solver="osqp"),
    "qp osqp": lambda s, c, G, h: s.qp(np.eye(2), c, G, h, solver="osqp"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_take_tensors(route):
    """A route given tensors returns what it returns for numpy data."""
    c, G, h, _, _ = (np.asarray(v) for v in lp_data(tpkg))
    with config.using_device("cpu"):
        ref = ROUTES[route](tpkg.solvers, c, G, h)
        got = ROUTES[route](tpkg.solvers, *(torch.as_tensor(v)
                                            for v in (c, G, h)))
    assert ref["status"] == "optimal"
    same(got, ref, tol=0.0)


@pytest.mark.cuda
def test_osqp_on_the_card_matches_the_cpu():
    """qp(solver='osqp') at n=200 on the card against the CPU: the same
    status and x to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n, m = 200, 400
    F = rng.standard_normal((n, n))
    P = F.T @ F / n + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    h = rng.uniform(0.5, 1.5, m)
    A, b = np.ones((1, n)), np.array([1.0])
    card = tpkg.solvers.qp(P, q, G, h, A, b, solver="osqp")
    with config.using_device("cpu"):
        cpu = tpkg.solvers.qp(P, q, G, h, A, b, solver="osqp")
    assert card["status"] == cpu["status"]
    same(card["x"], cpu["x"], tol=1e-9)
