"""The port's example programs (kvxopt_tpu_torch.examples) against the
JAX package's scripts of examples/, on the CPU.

Each case runs the JAX script's function (x64, on the CPU; the script
loaded under a name of its own, torch_example_parity.load_jax_example)
and the port's module of the same name on the same numpy data, the port
under config.using_device("cpu").  The bar: the same status, iterations
within 1, x within 1e-6 (1 + |x|), the primal objective within
1e-7 (1 + |obj|), and the values tests/test_examples.py asserts, held
against the port's result.

normappr, roblp and l1svc draw their data with each package's gsl,
whose bits differ; the port's data(m, n, seed) gives the port's draws,
and the JAX script runs on the same numbers through its own normal and
uniform, replaced in its module by those draws.
"""

import importlib

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import config
from kvxopt_tpu_torch.examples import EXAMPLES

from .torch_example_parity import (close_x, compare, compare_ops,
                                   compare_values, host, load_jax_example,
                                   recorded_lp)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def port(name):
    return importlib.import_module(f"kvxopt_tpu_torch.examples.{name}")


def test_every_script_has_its_port():
    import os
    from .torch_example_parity import EXDIR
    scripts = sorted(f[:-3] for f in os.listdir(EXDIR) if f.endswith(".py"))
    assert sorted(EXAMPLES) == scripts
    for name in EXAMPLES:
        assert hasattr(port(name), "main")


# ---------------------------------------------------------------------------
# Examples whose main() returns one result dict: the comparison and
# tests/test_examples.py's assertions

def _userguide_x(expected, atol):
    def check(sol):
        np.testing.assert_allclose(host(sol["x"]), expected, atol=atol)
    return check


def _sdp_zs(sol):
    _userguide_x([-0.3677, 1.8983, -0.8874], 1e-3)(sol)
    assert len(sol["zs"]) == 2
    for Z in sol["zs"]:
        assert np.linalg.eigvalsh(host(Z)).min() > -1e-7


def _conelp_check(sol):
    _userguide_x([-1.2209, 0.0966, 3.5775], 1e-3)(sol)
    assert sol["primal infeasibility"] < 1e-6
    assert sol["dual infeasibility"] < 1e-6


def _lp_check(sol):
    _userguide_x([1.0, 1.0], 1e-6)(sol)
    np.testing.assert_allclose(sol["primal objective"], -9.0, atol=1e-6)


def _socp_check(sol):
    _userguide_x([-5.0148, -5.7667, -8.5217], 1e-3)(sol)
    assert len(sol["zq"]) == 2


def _gp_check(sol):
    np.testing.assert_allclose(np.exp(host(sol["x"])),
                               [2.8873, 5.7746, 11.5431], rtol=1e-3)


SINGLE = {
    "lp": ({}, _lp_check),
    "socp": ({}, _socp_check),
    "sdp": ({}, _sdp_zs),
    "conelp": ({}, _conelp_check),
    "coneqp": ({}, _userguide_x([0.72558319, 0.61806264, 0.30253528],
                                1e-5)),
    "gp": ({}, _gp_check),
    "qcl1": ({}, None),
    "mcsdp": ({"n": 12}, None),
    "chebyshev": ({}, None),
    "robls": ({}, None),
    "acent": ({}, None),
    "acent2": ({}, _userguide_x([0.4110, 0.5588, -0.7201], 1e-3)),
    "l1": ({}, None),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_result(name):
    kwargs, check = SINGLE[name]
    ref = load_jax_example(name).main(**kwargs)
    sol = port(name).main(**kwargs)
    assert sol["status"] == "optimal"
    compare(sol, ref)
    assert set(sol) == set(ref)
    if check is not None:
        check(sol)


def test_l1regls():
    """Operator-form P and G with the m x m custom kktsolver; the
    subgradient condition of tests/test_examples.py."""
    xj, ref, A, y = load_jax_example("l1regls").main()
    x, sol, A2, y2 = port("l1regls").main()
    np.testing.assert_array_equal(A, A2)
    compare(sol, ref)
    close_x(x, xj)
    g = 2.0 * A.T @ (A @ x - y)
    on = np.abs(x) > 1e-6
    assert (np.abs(g) <= 1.0 + 1e-5).all()
    np.testing.assert_allclose(g[on], -np.sign(x[on]), atol=1e-4)


def test_l1regls_kktsolver_builds_on_the_solve_device():
    """The closures build A on the device of what they are handed, in
    its dtype: a float32 solve gets float32 data."""
    from kvxopt_tpu_torch.examples._data import OnDevice
    data = OnDevice(A=np.eye(2))
    v = torch.zeros(2, dtype=torch.float32)
    assert data(v).A.dtype == torch.float32
    assert data(v) is data(v)
    assert data(v.double()).A.dtype == torch.float64


def test_portfolio():
    ref = load_jax_example("portfolio").main(n=6, nmu=4)
    out = port("portfolio").main(n=6, nmu=4)
    assert (out["batch_status"] == 1).all()
    np.testing.assert_array_equal(out["batch_status"], ref["batch_status"])
    assert out["returns"][0] >= out["returns"][-1] - 1e-6
    for key in ("returns", "risks"):
        close_x(out[key], ref[key])
    for lane in range(4):
        close_x(out["batch_x"][lane], ref["batch_x"][lane])


# ---------------------------------------------------------------------------
# The modeling DSL

def _jax_draws(jmod, draws):
    """Replace the JAX script's gsl draws by `draws` (port matrices), in
    the order the script makes them."""
    from kvxopt_tpu import matrix as jmatrix
    it = iter(draws)

    def draw(*shape, **kw):
        return jmatrix(np.asarray(next(it)))
    jmod.setseed = lambda seed=0: None
    jmod.normal = jmod.uniform = draw


def _both_dsl(name, m, n, draws):
    from kvxopt_tpu import solvers as jsolvers
    from kvxopt_tpu_torch import solvers as tsolvers
    jmod = load_jax_example(name)
    _jax_draws(jmod, draws)
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        out = port(name).main(m=m, n=n)
        jout = jmod.main(m=m, n=n)
    return out, jout, lps, jlps


def test_normappr():
    from scipy.optimize import linprog
    from kvxopt_tpu_torch.examples import normappr
    draws = normappr.data(80, 20)
    out, jout, lps, jlps = _both_dsl("normappr", 80, 20, draws)
    (x1, p1), (x2, p2), (x3, p3), A, b = out
    (jx1, jp1), (jx2, jp2), (jx3, jp3), _, _ = jout
    compare_ops([p1, p2, p3], [jp1, jp2, jp3], lps, jlps)
    compare_values([x1, x2, x3], [jx1, jx2, jx3])
    assert p1.status == p2.status == p3.status == "optimal"
    Am, bv = np.asarray(A), np.asarray(b).reshape(-1)
    m, n = Am.shape
    c = np.zeros(n + 1)
    c[-1] = 1.0
    G = np.block([[Am, -np.ones((m, 1))], [-Am, -np.ones((m, 1))]])
    h = np.concatenate([-bv, bv])
    r = linprog(c, A_ub=G, b_ub=h, bounds=(None, None), method="highs")
    r1 = Am @ np.asarray(x1.value).reshape(-1) + bv
    assert abs(np.abs(r1).max() - r.fun) < 1e-6
    c = np.concatenate([np.zeros(n), np.ones(m)])
    G = np.block([[Am, -np.eye(m)], [-Am, -np.eye(m)]])
    r = linprog(c, A_ub=G, b_ub=h, bounds=(None, None), method="highs")
    r2 = Am @ np.asarray(x2.value).reshape(-1) + bv
    assert abs(np.abs(r2).sum() - r.fun) < 1e-5
    r3 = Am @ np.asarray(x3.value).reshape(-1) + bv
    direct = float(np.sum(np.maximum.reduce(
        [np.zeros_like(r3), np.abs(r3) - 0.75, 2 * np.abs(r3) - 2.25])))
    assert abs(direct - np.asarray(p3.objective.value()).ravel()[0]) < 1e-6


@pytest.mark.parametrize("name", ["roblp", "l1svc"])
def test_two_formulations(name):
    """roblp and l1svc: the PWL form agrees with the explicit auxiliary
    variables (tests/test_examples.py), and each solve with JAX's."""
    mod = port(name)
    draws = mod.data(120, 30)
    draws = draws if isinstance(draws, tuple) else (draws,)
    (x, x2, p1, p2), (jx, jx2, jp1, jp2), lps, jlps = _both_dsl(
        name, 120, 30, draws)
    assert p1.status == "optimal" and p2.status == "optimal"
    np.testing.assert_allclose(np.asarray(x.value), np.asarray(x2.value),
                               atol=1e-6)
    compare_ops([p1, p2], [jp1, jp2], lps, jlps)
    compare_values([x, x2], [jx, jx2])


def test_lp_modeling():
    from kvxopt_tpu import solvers as jsolvers
    from kvxopt_tpu_torch import solvers as tsolvers
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        lp1, lp2, (x, y, c1, c2, c3, c4), (x2, ineq) = \
            port("lp_modeling").main()
        jlp1, jlp2, jcons, (jx2, jineq) = \
            load_jax_example("lp_modeling").main()
    compare_ops([lp1, lp2], [jlp1, jlp2], lps, jlps)
    compare_values([x, y, x2], [jcons[0], jcons[1], jx2])
    for c, jc in zip((c1, c2, c3, c4, ineq), (*jcons[2:], jineq)):
        close_x(np.asarray(c.multiplier.value),
                np.asarray(jc.multiplier.value))
    np.testing.assert_allclose(float(lp1.objective.value()[0]), -9.0,
                               atol=1e-6)
    np.testing.assert_allclose([float(x.value[0]), float(y.value[0])],
                               [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(
        [float(c1.multiplier.value[0]), float(c2.multiplier.value[0])],
        [1.0, 2.0], atol=1e-5)


def test_dsdp_dual_scaling(capsys):
    """The script's module-level solves (loading it runs them) against
    the port's main(): the dual-scaling result and the conelp
    cross-check."""
    jmod = load_jax_example("dsdp_dual_scaling")
    capsys.readouterr()
    (status, x, r, zl, zs), ref = port("dsdp_dual_scaling").main()
    assert status == jmod.status
    close_x(np.asarray(x), np.asarray(jmod.x))
    assert np.asarray(r).ravel()[0] == pytest.approx(
        np.asarray(jmod.r).ravel()[0], abs=1e-7)
    for a, b in zip(zs, jmod.zs):
        close_x(np.asarray(a), np.asarray(b))
    compare(ref, jmod.ref)
    assert abs(float(np.asarray(x).ravel() @ np.array([1.0, -1.0, 1.0]))
               - ref["primal objective"]) < 1e-4


def test_floorplan():
    sol, W, H, x, y, w, hh = port("floorplan").main()
    ref, *jvals = load_jax_example("floorplan").main()
    compare(sol, ref)
    for a, b in zip((W, H, x, y, w, hh), jvals):
        close_x(a, b)
    np.testing.assert_allclose(w * hh, np.full(5, 100.0), rtol=1e-5)
    assert abs((W + H) - 47.94) < 0.2


# ---------------------------------------------------------------------------
# weak_scaling_sharded: one factor+solve step in a gloo world of 2 CPU
# ranks against the JAX script's step on 2 of the 8 virtual devices

def test_weak_scaling_sharded(monkeypatch):
    import os
    import jax.numpy as jnp
    from kvxopt_tpu.cones import ConeDims, compute_scaling
    from kvxopt_tpu.parallel import make_mesh, sharded_kkt_solver
    from kvxopt_tpu_torch.examples import weak_scaling_sharded as ws
    # the script sets XLA_FLAGS at import; keep the environment as it was
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    jmod = load_jax_example("weak_scaling_sharded")
    ndev, rows_per_dev, n = 2, 32, 12
    assert jmod.measure(ndev, rows_per_dev, n, reps=1) > 0
    # the JAX script's step (its measure() returns only the time)
    rows = rows_per_dev * ndev
    dims = ConeDims(l=rows)
    G, s, z, bx, bz = (jnp.asarray(a) for a in ws.problem(rows, n))
    W, _ = compute_scaling(dims, s, z)
    factor = sharded_kkt_solver(make_mesh(ndev, ("kkt",)), "kkt", dims, G,
                                Pmat=jnp.eye(n))
    ux_jax = np.asarray(factor(W)(bx, jnp.zeros((0,)), bz)[0])
    secs, ux = ws.run(ndev, rows_per_dev, n, reps=2, device="cpu")
    assert secs > 0
    np.testing.assert_allclose(ux, ux_jax, rtol=1e-10, atol=1e-12)
    # and the dense solve of the same system: (I + G' D^-2 G) ux = bx + ...
    Gn, sn, zn, bxn, bzn = ws.problem(rows, n)
    d2 = zn / sn
    K = np.eye(n) + Gn.T @ (d2[:, None] * Gn)
    np.testing.assert_allclose(ux, np.linalg.solve(K, bxn + Gn.T @ (d2 * bzn)),
                               rtol=1e-9, atol=1e-10)
