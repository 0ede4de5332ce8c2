"""The plain reference alone: it solves small portfolios and lassos, and
its judge reads their solutions as within the stated tolerances."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import qp_orthant as ref
from benchmark.tests.small import SMALL

TOL = {"abstol": 1e-7, "reltol": 1e-6, "feastol": 1e-7}


def _data(name, seed):
    cfg = {**harness.load_json(harness.BENCH / "configs" / f"{name}.json"),
           **SMALL[name]}
    mod = harness.load_module(harness.BENCH / "problems" /
                              f"{cfg['problem']}.py")
    gen = torch.Generator().manual_seed(seed)
    return cfg, mod, mod.make(cfg, gen, 2, torch.device("cpu"),
                              torch.float64)


@pytest.mark.parametrize("name", ["portfolio", "lasso"])
def test_reference_solves_small_instances(name):
    cfg, mod, d = _data(name, 5)
    out = ref.solve(**d)
    assert out["status"] == ["optimal", "optimal"]
    j = ref.judge(d, out, TOL)
    assert max(j["residual"]) <= 1e-9
    assert max(j["gap"]) <= 1.0
    # feasibility as the generator states it: Ax = b, Gx + s = h, s >= 0
    x, s = out["x"], out["s"]
    assert float((torch.einsum("bij,bj->bi", d["A"], x) - d["b"]).abs()
                 .max()) < 1e-8
    assert float(s.min()) >= 0.0
    # the reference's optimum is no worse than the generator's feasible
    # point
    xf, _ = mod.feasible_point(cfg, d)

    def cost(v):
        return 0.5 * torch.einsum("bi,bij,bj->b", v, d["P"], v) + (
            d["q"] * v).sum(-1)
    assert bool((cost(x) <= cost(xf) + 1e-9).all())


def test_judge_reads_a_perturbed_solution_as_outside():
    _, _, d = _data("portfolio", 6)
    out = ref.solve(**d)
    bad = dict(out, x=out["x"] + 1e-4)
    assert min(ref.judge(d, bad, TOL)["residual"]) > 1e-7
    neg = dict(out, s=out["s"] - 1.0)
    assert min(ref.judge(d, neg, TOL)["residual"]) >= 1.0
    nan = dict(out, z=out["z"] * float("nan"))
    assert ref.judge(d, nan, TOL)["residual"] == [float("inf")] * 2
