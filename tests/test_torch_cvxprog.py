"""The nonlinear solvers of the port (kvxopt_tpu_torch.solvers.cp, cpl,
gp and cvxprog.oracle_from_function) against the JAX package's, on the
problems of tests/test_cvxprog.py, the maximum-entropy cp of
tests/test_book_examples.py and the acent and acent2 examples.

Both sides get the same numpy data; each oracle is written once over an
array namespace (jax.numpy or torch), so both solve the same problem.
The port runs on CPU tensors (the device is set by a fixture).  The bar:
the same status and result keys, iterations within 1, x within
1e-6 (1 + |x|) of JAX's, the primal objective within 1e-7 (1 + |obj|).

JAX is imported inside the fixtures, so the test marked `cuda` also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cvxprog.py
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.solvers.cvxprog import oracle_from_function

CPL_KEYS = {"status", "x", "y", "snl", "sl", "znl", "zl",
            "primal objective", "dual objective", "gap", "relative gap",
            "primal infeasibility", "dual infeasibility", "primal slack",
            "dual slack", "iterations"}


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def compare(ref, sol, xtol=1e-6, otol=1e-7):
    """The port's result dict `sol` against the JAX package's `ref`."""
    assert set(sol) == set(ref) == CPL_KEYS
    assert sol["status"] == ref["status"]
    assert abs(sol["iterations"] - ref["iterations"]) <= 1, (
        sol["iterations"], ref["iterations"])
    assert isinstance(sol["x"], torch.Tensor)
    r = np.asarray(ref["x"])
    d = np.linalg.norm(sol["x"].numpy() - r) / (1 + np.linalg.norm(r))
    assert d <= xtol, d
    po, pr = sol["primal objective"], ref["primal objective"]
    assert abs(po - pr) <= otol * (1 + abs(pr)), (po, pr)


# ---------------------------------------------------------------------------
# The problems: numpy data and oracles over an array namespace xp
# ---------------------------------------------------------------------------

def quadratic(xp):
    """minimize (x0 - 1)^2 + (x1 - 2)^2."""
    def F(x=None, z=None):
        if x is None:
            return 0, xp.asarray(np.zeros(2))
        f = ((x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2).reshape(1)
        Df = (2.0 * (x - xp.asarray(np.array([1.0, 2.0])))).reshape(1, 2)
        if z is None:
            return f, Df
        return f, Df, z[0] * 2.0 * xp.asarray(np.eye(2))
    return F


def log_barrier(xp):
    """minimize -log(x) + x, None outside x > 0: x* = 1."""
    def F(x=None, z=None):
        if x is None:
            return 0, xp.asarray(np.array([0.5]))
        if float(x[0]) <= 0.0:
            return None
        f = (-xp.log(x) + x).reshape(1)
        Df = (-1.0 / x + 1.0).reshape(1, 1)
        if z is None:
            return f, Df
        return f, Df, (z[0] / x ** 2).reshape(1, 1)
    return F


def disc(xp, r2=1.0):
    """One nonlinear constraint x0^2 + x1^2 <= r2."""
    def F(x=None, z=None):
        if x is None:
            return 1, xp.asarray(np.zeros(2))
        f = (x[0] ** 2 + x[1] ** 2 - r2).reshape(1)
        Df = (2.0 * x).reshape(1, 2)
        if z is None:
            return f, Df
        return f, Df, z[0] * 2.0 * xp.asarray(np.eye(2))
    return F


def maxent_data():
    """book/chap7/maxent.py's constraints (tests/test_book_examples.py)."""
    n = 50
    a = -1.0 + 2.0 / (n - 1) * np.arange(n)
    I = a < 0
    G = np.zeros((8, n))
    G[0], G[1] = -a, a
    G[2], G[3] = -a ** 2, a ** 2
    G[4], G[5] = -(3 * a ** 3 - 2 * a), 3 * a ** 3 - 2 * a
    G[6, I], G[7, I] = -1.0, 1.0
    h = np.array([0.1, 0.1, -0.5, 0.6, 0.3, -0.2, -0.3, 0.4])
    return G, h, np.ones((1, n)), np.array([1.0])


def maxent(xp, n=50):
    """minimize sum x log x, None outside x > 0."""
    def F(x=None, z=None):
        if x is None:
            return 0, xp.asarray(np.ones(n))
        if float(xp.min(x)) <= 0.0:
            return None
        f = (x @ xp.log(x)).reshape(1)
        Df = (1.0 + xp.log(x)).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, xp.diag(z[0] / x)
    return F


def acent_data(m=40, n=10, seed=5):
    """examples/acent.py's data."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = np.abs(A @ rng.standard_normal(n)) + rng.uniform(0.5, 2.0, m)
    return A, b


def acent(xp, A, b):
    """minimize -sum log(b - Ax) (examples/acent.py's oracle)."""
    A, b = xp.asarray(A), xp.asarray(b)

    def F(x=None, z=None):
        if x is None:
            return 0, A[0] * 0.0
        y = b - A @ x
        f = -xp.sum(xp.log(y)).reshape(1)
        Df = (A.T @ (1.0 / y)).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, z[0] * (A.T * (1.0 / y ** 2)[None, :]) @ A
    return F


ACENT2_G = np.array([
    [0., -1., 0., 0., -21., -11., 0., -11., 10., 8., 0., 8., 5.],
    [0., 0., -1., 0., 0., 10., 16., 10., -10., -10., 16., -10., 3.],
    [0., 0., 0., -1., -5., 2., -17., 2., -6., 8., -17., -7., 6.]]).T
ACENT2_H = np.array([1.0, 0.0, 0.0, 0.0, 20., 10., 40., 10., 80., 10.,
                     40., 10., 15.])
ACENT2_DIMS = {"l": 0, "q": [4], "s": [3]}


def acent2(xp):
    """examples/acent2.py: minimize -sum log(1 - x_i^2), None outside
    |x_i| < 1."""
    def F(x=None, z=None):
        if x is None:
            return 0, xp.asarray(np.zeros(3))
        if float(xp.max(xp.abs(x))) >= 1.0:
            return None
        u = 1.0 - x ** 2
        f = -xp.sum(xp.log(u)).reshape(1)
        Df = (2.0 * x / u).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, xp.diag(2.0 * z[0] * (1.0 + x ** 2) / u ** 2)
    return F


def gp_box_data():
    """tests/test_cvxprog.py's box-volume GP (one-sided last aspect
    ratio)."""
    Aflr, Awall = 1000.0, 100.0
    alpha, beta, gamma = 0.5, 2.0, 0.5
    F = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 0.0], [1.0, 0.0, 1.0],
                  [0.0, 1.0, 1.0], [-1.0, 1.0, 0.0], [1.0, -1.0, 0.0],
                  [0.0, -1.0, 1.0]])
    g = np.log(np.array([1.0, 2.0 / Awall, 2.0 / Awall, 1.0 / Aflr, alpha,
                         1.0 / beta, gamma]))
    return [1, 2, 1, 1, 1, 1], F, g


def gp_userguide_data():
    """examples/gp.py: the userguide's box (section 9.3)."""
    Aflr, Awall = 1000.0, 100.0
    alpha, beta, gamma, delta = 0.5, 2.0, 0.5, 2.0
    F = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                  [-1., 1., 0., 1., 1., -1., 1., -1.],
                  [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
    g = np.log([1.0, 2 / Awall, 2 / Awall, 1 / Aflr, alpha, 1 / beta,
                gamma, 1 / delta])
    return [1, 2, 1, 1, 1, 1, 1], F, g


def smooth_data(n=6, seed=3):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T / n + np.eye(n), rng.standard_normal(n)


def smooth(xp, Q, a):
    """Two smooth convex constraints: sum exp(a x) <= 10, x'Qx <= 4."""
    Q, a = xp.asarray(Q), xp.asarray(a)

    def f(x):
        return xp.stack([xp.sum(xp.exp(a * x)) - 10.0, x @ Q @ x - 4.0])
    return f


def oracle_jax(f, x0):
    from kvxopt_tpu.solvers.cvxprog import oracle_from_function as ofj
    return ofj(f, x0)


def oracle_port(f, x0):
    return oracle_from_function(f, x0)


# name -> solve(solvers, xp, make_oracle): the same call on either side
CASES = {
    "cp quadratic": lambda s, xp, mk: s.cp(quadratic(xp)),
    "cp log barrier": lambda s, xp, mk: s.cp(log_barrier(xp)),
    "cpl nonlinear constraint": lambda s, xp, mk: s.cpl(
        np.array([-1.0, -1.0]), disc(xp)),
    "cpl l constraint": lambda s, xp, mk: s.cpl(
        np.array([-1.0, -1.0]), disc(xp), np.array([[0.0, 1.0]]),
        np.array([0.5])),
    "cpl q cone": lambda s, xp, mk: s.cpl(
        np.array([-1.0, 0.0]), disc(xp, 4.0), -np.eye(2), np.zeros(2),
        {"l": 0, "q": [2], "s": []}),
    "cp maxent G h A b": lambda s, xp, mk: s.cp(
        maxent(xp), *maxent_data()[:2], A=maxent_data()[2],
        b=maxent_data()[3]),
    "cp acent": lambda s, xp, mk: s.cp(acent(xp, *acent_data())),
    "cp acent2": lambda s, xp, mk: s.cp(acent2(xp), ACENT2_G, ACENT2_H,
                                        ACENT2_DIMS),
    "gp symmetric": lambda s, xp, mk: s.gp(
        [2], np.array([[1.0], [-1.0]]), np.zeros(2)),
    "gp constrained": lambda s, xp, mk: s.gp(
        [1, 2], np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]),
        np.zeros(3)),
    "gp box volume": lambda s, xp, mk: s.gp(*gp_box_data()),
    "gp userguide": lambda s, xp, mk: s.gp(*gp_userguide_data()),
    "cpl oracle_from_function": lambda s, xp, mk: s.cpl(
        -np.ones(6), mk(smooth(xp, *smooth_data()), np.zeros(6))),
}


@pytest.fixture(scope="module")
def jax_solution():
    """The JAX package's solve of a case, each solved once."""
    import jax.numpy as jnp
    from kvxopt_tpu import solvers as jsolvers
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CASES[name](jsolvers, jnp, oracle_jax)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity_with_jax(name, jax_solution):
    compare(jax_solution(name), CASES[name](tsolvers, torch, oracle_port))


def test_known_optima():
    """The port's solutions at the optima tests/test_cvxprog.py and
    tests/test_examples.py assert."""
    sol = CASES["cp quadratic"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(sol["x"].numpy(), [1.0, 2.0], atol=1e-4)
    sol = CASES["cp log barrier"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(sol["primal objective"], 1.0, atol=1e-5)
    r = 1.0 / np.sqrt(2.0)
    sol = CASES["cpl nonlinear constraint"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(sol["x"].numpy(), [r, r], atol=1e-5)
    sol = CASES["cpl l constraint"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(sol["x"].numpy(), [np.sqrt(0.75), 0.5],
                               atol=1e-5)
    sol = CASES["cpl q cone"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(sol["x"].numpy(), [2.0, 0.0], atol=1e-4)
    sol = CASES["gp userguide"](tsolvers, torch, oracle_port)
    np.testing.assert_allclose(np.exp(sol["x"].numpy()),
                               [2.8873, 5.7746, 11.5431], rtol=1e-3)
    A, b = acent_data()
    x = CASES["cp acent"](tsolvers, torch, oracle_port)["x"].numpy()
    y = b - A @ x
    assert (y > 0).all()
    assert np.linalg.norm(A.T @ (1.0 / y)) < 1e-6 * (1 + np.linalg.norm(b))
    p = CASES["cp maxent G h A b"](tsolvers, torch, oracle_port)["x"].numpy()
    G, h, _, _ = maxent_data()
    assert (p > 0).all() and abs(p.sum() - 1.0) < 1e-6
    assert (G @ p <= h + 1e-6).all()


def test_oracle_from_function_matches_jax_autodiff():
    """f, Df and H at a seeded point against jax.jacfwd / jax.hessian."""
    import jax
    import jax.numpy as jnp
    Q, a = smooth_data()
    rng = np.random.default_rng(11)
    x, z = 0.3 * rng.standard_normal(6), rng.uniform(0.5, 2.0, 2)
    fj = smooth(jnp, Q, a)
    ref = (fj(jnp.asarray(x)), jax.jacfwd(fj)(jnp.asarray(x)),
           jax.hessian(lambda u: jnp.dot(jnp.asarray(z), fj(u)))(
               jnp.asarray(x)))
    F = oracle_from_function(smooth(torch, Q, a), np.zeros(6))
    m, x0 = F()
    assert m == 2 and x0.dtype == torch.float64 and x0.device.type == "cpu"
    out = F(torch.from_numpy(x), torch.from_numpy(z))
    for r, t in zip(ref, out):
        assert t.shape == r.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    assert len(F(torch.from_numpy(x))) == 2


@pytest.mark.cuda
def test_acent_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A, b = acent_data(m=200, n=50, seed=7)
    cpu = tsolvers.cp(_acent_on(A, b, "cpu"))
    card = tsolvers.cp(_acent_on(A, b, "cuda"))
    assert card["x"].device.type == "cuda"
    assert card["status"] == cpu["status"] == "optimal"
    assert abs(card["iterations"] - cpu["iterations"]) <= 1
    x, xc = card["x"].cpu().numpy(), cpu["x"].numpy()
    assert np.linalg.norm(x - xc) <= 1e-6 * (1 + np.linalg.norm(xc))


def _acent_on(A, b, device):
    """acent's oracle with its data on `device`."""
    A = torch.as_tensor(A, device=device)
    b = torch.as_tensor(b, device=device)

    def F(x=None, z=None):
        if x is None:
            return 0, torch.zeros(A.shape[1], dtype=A.dtype, device=device)
        y = b - A @ x
        f = -torch.sum(torch.log(y)).reshape(1)
        Df = (A.T @ (1.0 / y)).reshape(1, -1)
        if z is None:
            return f, Df
        return f, Df, z[0] * (A.T * (1.0 / y ** 2)[None, :]) @ A
    return F
