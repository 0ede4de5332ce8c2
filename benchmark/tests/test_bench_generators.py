"""The problem generators: shapes, dims, exact sparsity, feasibility and
determinism at a small scale."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import SMALL

NAMES = ("portfolio", "lasso")


def _problem(name):
    cfg = {**harness.load_json(harness.BENCH / "configs" / f"{name}.json"),
           **SMALL[name]}
    return cfg, harness.load_module(harness.BENCH / "problems" /
                                    f"{cfg['problem']}.py")


def _make(name, seed=7, batch=3):
    cfg, mod = _problem(name)
    gen = torch.Generator().manual_seed(seed)
    return cfg, mod, mod.make(cfg, gen, batch, torch.device("cpu"),
                              torch.float64)


@pytest.mark.parametrize("name", NAMES)
def test_shapes_match_the_configuration(name):
    cfg, mod, d = _make(name)
    nv, m, p = mod.shapes(cfg)
    sh = cfg["shapes"]
    assert (nv, m, p) == (sh["n_var"], sh["m"], sh["p"])
    assert nv + m + p == sh["kkt_order"]
    assert cfg["dims"] == {"l": m}
    assert d["P"].shape == (3, nv, nv) and d["q"].shape == (3, nv)
    assert d["G"].shape == (3, m, nv) and d["h"].shape == (3, m)
    assert d["A"].shape == (3, p, nv) and d["b"].shape == (3, p)
    assert all(v.dtype == torch.float64 for v in d.values())


@pytest.mark.parametrize("name", NAMES)
def test_full_size_shapes(name):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    mod = harness.load_module(harness.BENCH / "problems" /
                              f"{cfg['problem']}.py")
    nv, m, p = mod.shapes(cfg)
    sh = cfg["shapes"]
    assert (nv, m, p, nv + m + p) == (sh["n_var"], sh["m"], sh["p"],
                                      sh["kkt_order"])


@pytest.mark.parametrize("name", NAMES)
def test_feasible_point(name):
    cfg, mod, d = _make(name)
    x, s = mod.feasible_point(cfg, d)
    assert bool((s > 0).all())
    eq = torch.einsum("bij,bj->bi", d["A"], x) - d["b"]
    ineq = torch.einsum("bij,bj->bi", d["G"], x) + s - d["h"]
    assert float(eq.abs().max()) < 1e-12
    assert float(ineq.abs().max()) < 1e-12


@pytest.mark.parametrize("name", NAMES)
def test_p_is_symmetric_positive_semidefinite(name):
    _, _, d = _make(name)
    P = d["P"]
    assert torch.equal(P, P.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(P).min()) >= 0.0


def test_portfolio_factor_sparsity_and_ranges():
    cfg, _, d = _make("portfolio")
    n, k = cfg["n"], cfg["k"]
    F = d["A"][:, :k, :n]
    nnz = (F != 0).sum(dim=(1, 2))
    assert nnz.tolist() == [round(cfg["density"] * n * k)] * 3
    D = torch.diagonal(d["P"], dim1=1, dim2=2)[:, :n] / 2
    assert bool((D >= 0).all()) and bool((D <= k ** 0.5).all())
    assert torch.equal(d["b"][:, -1], torch.ones(3, dtype=torch.float64))


def test_lasso_data_sparsity_and_lambda():
    cfg, _, d = _make("lasso")
    n, md = cfg["n"], cfg["m"]
    Ad = d["A"][:, :, :n]
    nnz = (Ad != 0).sum(dim=(1, 2))
    assert nnz.tolist() == [round(cfg["density"] * md * n)] * 3
    lam = torch.einsum("bmn,bm->bn", Ad, d["b"]).abs().amax(1) / 5
    assert torch.allclose(d["q"][:, n + md:], lam[:, None].expand(3, n))


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_data(name):
    _, _, a = _make(name, seed=2 ** 40 + 3)
    _, _, b = _make(name, seed=2 ** 40 + 3)
    _, _, c = _make(name, seed=2 ** 40 + 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q"], c["q"])
