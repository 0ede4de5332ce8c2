"""The port's MOSEK and Gurobi bridges (kvxopt_tpu_torch.msk, .gurobi)
against the JAX package's.  Without the commercial packages both
modules raise ImportError at import, as the JAX package's do.  With the
fake `mosek` and `gurobipy` of tests/test_msk_bridge.py and
tests/test_gurobi_bridge.py in sys.modules (their optimize() solves with
the JAX package's solvers), the port's bridges and its solvers.lp/qp/socp
dispatch return the JAX package's results to 1e-10: the code after the
solve is the same numpy on both sides.
"""

import importlib
import sys

import numpy as np
import pytest

from kvxopt_tpu_torch import config
from tests.test_gurobi_bridge import _make_fake_gurobipy
from tests.test_msk_bridge import _make_fake_mosek
from tests.test_torch_bridges import same

PACKAGES = ("kvxopt_tpu_torch", "kvxopt_tpu")


def forget(module):
    """Both packages' `module` unimported: out of sys.modules and off its
    package, so that the next import runs it again."""
    for pkg in PACKAGES:
        sys.modules.pop(f"{pkg}.{module}", None)
        if hasattr(sys.modules.get(pkg), module):
            delattr(sys.modules[pkg], module)


def fresh(module, backend, fake, monkeypatch):
    """Both packages' `module` imported anew with sys.modules[backend]
    set to `fake` -> {package: module}."""
    monkeypatch.setitem(sys.modules, backend, fake)
    forget(module)
    return {pkg: importlib.import_module(f"{pkg}.{module}")
            for pkg in PACKAGES}


@pytest.mark.parametrize("module,backend", [("msk", "mosek"),
                                            ("gurobi", "gurobipy")])
def test_import_without_the_package_raises(module, backend, monkeypatch):
    monkeypatch.delitem(sys.modules, backend, raising=False)
    forget(module)
    for pkg in PACKAGES:
        with pytest.raises(ImportError):
            importlib.import_module(f"{pkg}.{module}")
    forget(module)


@pytest.fixture
def fake_mosek(monkeypatch):
    yield fresh("msk", "mosek", _make_fake_mosek(), monkeypatch)
    forget("msk")


@pytest.fixture
def fake_gurobi(monkeypatch):
    yield fresh("gurobi", "gurobipy", _make_fake_gurobipy(), monkeypatch)
    forget("gurobi")


def solvers(pkg):
    return importlib.import_module(f"{pkg}.solvers")


def both(case):
    """case(package name) for the port on the CPU and the JAX package."""
    with config.using_device("cpu"):
        port = case(PACKAGES[0])
    return port, case(PACKAGES[1])


# the reference's doc LP (examples/doc/chap8/lp.py)
C = np.array([-4.0, -5.0])
G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
H = np.array([3.0, 3.0, 0.0, 0.0])
P2 = np.array([[2.0, 0.5], [0.5, 1.0]])
Q2 = np.array([1.0, -1.0])
SOCP = (np.array([-2.0, 1.0]), np.array([[1.0, 1.0]]), np.array([4.0]),
        [np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]])],
        [np.array([2.0, 0.0, 0.0])])

MOSEK_CASES = {
    "lp": lambda p, m: solvers(p).lp(C, G, H, solver="mosek"),
    "lp with equalities": lambda p, m: solvers(p).lp(
        C, G, H, np.array([[1.0, 1.0]]), np.array([1.5]), solver="mosek"),
    "qp": lambda p, m: solvers(p).qp(P2, Q2, G, H, solver="mosek"),
    "socp": lambda p, m: solvers(p).socp(*SOCP, solver="mosek"),
    "conelp l+s": lambda p, m: m[p].conelp(
        np.array([-1.0, -1.0]),
        np.vstack([np.eye(2), np.array([[1.0, 0.0], [0.0, 0.5],
                                        [0.0, 0.5], [1.0, 1.0]])]),
        np.array([2.0, 2.0, 3.0, 0.2, 0.2, 3.0]),
        {"l": 2, "q": [], "s": [2]})[1:],
    "ilp": lambda p, m: m[p].ilp(
        np.array([-1.0, -1.0]),
        np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]),
        np.array([3.0, 2.0, 0.0, 0.0]), I={0, 1})[1:],
}


@pytest.mark.parametrize("name", sorted(MOSEK_CASES))
def test_mosek_matches_jax(name, fake_mosek):
    port, ref = both(lambda p: MOSEK_CASES[name](p, fake_mosek))
    if isinstance(ref, dict):
        assert ref["status"] == "optimal"
    same(port, ref)


def qp_data(seed):
    rng = np.random.default_rng(seed)
    n, m = 5, 8
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.standard_normal(n)
    Gm = rng.standard_normal((m, n))
    h = Gm @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m)
    return P, q, Gm, h


def lp_data():
    rng = np.random.default_rng(3)
    n, m = 4, 12
    Gm = np.vstack([rng.standard_normal((m - 2 * n, n)), np.eye(n),
                    -np.eye(n)])
    h = np.concatenate([rng.uniform(1, 2, m - 2 * n), np.full(2 * n, 5.0)])
    return rng.standard_normal(n), Gm, h


def two_sided(p, g):
    rng = np.random.default_rng(1)
    n, m = 4, 6
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.standard_normal(n)
    Gm = rng.standard_normal((m, n))
    x = rng.standard_normal(n) * 0.1
    Gu = Gm @ x + rng.uniform(0.2, 0.6, m)
    Gl = Gm @ x - rng.uniform(0.2, 0.6, m)
    return g[p].solve(q, Gl, Gm, Gu, P=P, x_l=np.full(n, -2.0),
                      x_u=np.full(n, 2.0))


GUROBI_CASES = {
    "qp 4-tuple": lambda p, g: g[p].qp(*qp_data(0)[1:], P=qp_data(0)[0]),
    "solve two-sided": two_sided,
    "qp dispatch": lambda p, g: solvers(p).qp(*qp_data(2), solver="gurobi"),
    "lp dispatch": lambda p, g: solvers(p).lp(*lp_data(), solver="gurobi"),
}


@pytest.mark.parametrize("name", sorted(GUROBI_CASES))
def test_gurobi_matches_jax(name, fake_gurobi):
    port, ref = both(lambda p: GUROBI_CASES[name](p, fake_gurobi))
    status = ref["status"] if isinstance(ref, dict) else ref[0]
    assert status == "optimal"
    same(port, ref)
