"""The OSQP suite's lasso through the port's chol2, against the plain
reference benchmark/reference/qp_orthant.py (plain torch, an LDL' of the
augmented system with Bunch-Kaufman pivoting), on the CPU.

Over (x, y, t), chol2's K = P + G'W^-2 G holds, per feature, a 2x2 block
D1 [[1, -1], [-1, 1]] + D2 [[1, 1], [1, 1]] on (x_i, t_i); where x_i is
not 0 at the optimum, D1/D2 grows to ~1e16 and the block's Cholesky
breaks down near the end.  Such a lane's step is not finite; the core
flags it, and chol2 serves it from then on by the augmented LDL'
(kkt._on_ldl), whose count the call's record keeps as
kkt.fallback_lanes.  The instances are benchmark/problems/lasso.py's at
seed 1618033988: at (n, m) = (3, 300) chol2 alone ends lanes 26 and 43
SINGULAR, at (5, 500) lanes 2, 15, 36, 37 and 45 (ldl2 ends lane 15 so).
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.problems import lasso, portfolio
from benchmark.reference import qp_orthant as ref
from benchmark.tests.small import SMALL
from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import ConeDims, config, parallel, trace
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.kkt import _ldl_solver, _qd_solver
from kvxopt_tpu_torch.solvers.coneprog import OPTIMAL, SINGULAR
from .test_torch_coneqp import compare
from .test_torch_lasso_card import quasidefinite

SEED = 1618033988
TOL = {"abstol": 1e-7, "reltol": 1e-6, "feastol": 1e-7}
KEYS = ("P", "q", "G", "h", "A", "b")
# The port stops at reltol 1e-6, so its objective lies within ~1e-6 of
# the optimum (relative), which the reference reaches to 1e-11; x, whose
# directions the objective curves only through y = A_d x - b_d, lies
# within about the square root of that (the largest seen: 6e-4).
OBJ_TOL = 2 * TOL["reltol"]
X_TOL = 2e-3


@pytest.fixture(autouse=True)
def on_cpu():
    with config.using_device("cpu"):
        yield


def instances(n, lanes, device="cpu"):
    cfg = {"n": n, "m": 100 * n, "density": 0.15}
    gen = torch.Generator(device=device).manual_seed(SEED)
    return lasso.make(cfg, gen, lanes, torch.device(device), torch.float64)


def fallback_lanes():
    return trace.calls()[-1].counters.get("kkt.fallback_lanes")


def cost(d, x):
    return 0.5 * torch.einsum("bi,bij,bj->b", x, d["P"], x) + (
        d["q"] * x).sum(-1)


def against_reference(d, out):
    """Every lane optimal, within the tolerances by the reference's judge,
    and at the reference's x and objective."""
    assert (out[5] == OPTIMAL).all(), torch.nonzero(out[5] != OPTIMAL)
    got = dict(zip(("x", "y", "s", "z"), out[:4]))
    j = ref.judge(d, got, TOL)
    assert max(j["residual"]) <= TOL["feastol"], j["residual"]
    assert max(j["gap"]) <= 1.0, j["gap"]
    r = ref.solve(**d)
    assert r["status"] == ["optimal"] * d["q"].shape[0]
    dx = (got["x"] - r["x"]).norm(dim=1) / (1 + r["x"].norm(dim=1))
    assert float(dx.max()) <= X_TOL, dx
    c, cr = cost(d, got["x"]), cost(d, r["x"])
    assert float(((c - cr).abs() / (1 + cr.abs())).max()) <= OBJ_TOL


@pytest.mark.parametrize("n", [3, 5])
def test_batch_matches_the_reference_on_every_lane(n):
    d = instances(n, 48)
    out = parallel.batched_qp_solver(ConeDims(l=2 * n))(
        *(d[k] for k in KEYS))
    against_reference(d, out)
    assert fallback_lanes() > 0


def test_single_qp_of_a_lane_that_breaks():
    """solvers.qp on lane 26 alone: chol2 breaks on it as a batch of one
    too, and the fallback finishes it."""
    d = instances(3, 48)
    one = {k: v[26:27] for k, v in d.items()}
    sol = tsolvers.qp(*(one[k][0].numpy() for k in KEYS))
    assert sol["status"] == "optimal"
    assert fallback_lanes() >= 1
    out = [sol[k][None] for k in ("x", "y", "s", "z")] + [None, torch.tensor(
        [OPTIMAL])]
    against_reference(one, out)


def test_portfolio_batch_never_falls_back_and_matches_jax():
    """A small portfolio (benchmark/tests/small.py's size) never breaks
    chol2 down: the counter reads 0, and each lane agrees with the JAX
    package at test_torch_coneqp.compare's bar."""
    cfg = {**harness.load_json(harness.BENCH / "configs" / "portfolio.json"),
           **SMALL["portfolio"]}
    d = portfolio.make(cfg, torch.Generator().manual_seed(5), 4,
                       torch.device("cpu"), torch.float64)
    out = parallel.batched_qp_solver(ConeDims(l=200))(*(d[k] for k in KEYS))
    assert (out[5] == OPTIMAL).all()
    assert fallback_lanes() == 0
    for i in range(4):
        args = [d[k][i].numpy() for k in KEYS]
        sol = tsolvers.qp(*args)
        assert fallback_lanes() == 0
        compare(jsolvers.qp(*args), sol)
        np.testing.assert_allclose(sol["x"].numpy(), out[0][i].numpy(),
                                   rtol=0, atol=1e-9)


def nan_lane():
    """Two small QPs; lane 1's q holds a NaN, so every step on it is not
    finite, on chol2 and on the fallback alike."""
    rng = np.random.default_rng(3)
    n, m, p = 6, 8, 2
    M = rng.standard_normal((2, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    q = rng.standard_normal((2, n))
    q[1, 2] = np.nan
    G = np.concatenate([-np.eye(n), rng.standard_normal((m - n, n))])
    G = np.broadcast_to(G, (2, m, n)).copy()
    h = np.concatenate([np.zeros(n), np.full(m - n, 10.0)])
    h = np.broadcast_to(h, (2, m)).copy()
    A = rng.standard_normal((2, p, n))
    b = np.einsum("bpn,n->bp", A, np.full(n, 0.5))
    return [torch.from_numpy(a) for a in (P, q, G, h, A, b)]


@pytest.mark.parametrize("kktsolver", ["chol2", "ldl"])
def test_a_lane_singular_on_the_fallback_too_ends_unknown(kktsolver):
    """chol2 flags the NaN lane at its first step and ends it SINGULAR at
    the next, on the fallback; ldl, which has no fallback, ends it at the
    first.  The other lane is solved as it is alone."""
    data = nan_lane()
    out = parallel.batched_qp_solver(ConeDims(l=8), kktsolver)(*data)
    assert out[5].tolist() == [OPTIMAL, SINGULAR]
    assert fallback_lanes() == (1 if kktsolver == "chol2" else None)
    alone = parallel.batched_qp_solver(ConeDims(l=8), kktsolver)(
        *(a[:1] for a in data))
    assert torch.equal(out[0][0], alone[0][0])
    sol = tsolvers.qp(*(a[1].numpy() for a in data), kktsolver=kktsolver)
    assert sol["status"] == "unknown"


@pytest.mark.parametrize("B", [1, 3])
def test_quasidefinite_split_solves_as_ldl_nopiv(B):
    """ldl's factor on the card, two Cholesky factors of the quasidefinite
    split (kkt._qd_solver), run here on the CPU: it solves as ldl_nopiv's
    column loop, the CPU's factor, does (1e-13 measured at this
    conditioning)."""
    M, n = quasidefinite(B, 204, 200)
    b = torch.randn((B, 404), generator=torch.Generator().manual_seed(B),
                    dtype=torch.float64)
    u, ref_u = _qd_solver(M, n)(b), _ldl_solver(M)(b)
    assert float((u - ref_u).norm() / ref_u.norm()) < 1e-11
    r = torch.einsum("bij,bj->bi", M, u) - b
    assert float(r.norm() / b.norm()) < 1e-11
