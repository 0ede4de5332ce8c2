"""Lane-shared operands in the port's batch drivers, on a small efficient
frontier on the CPU.

One seeded OSQP-suite Portfolio market (k = 2 factors, n = 40 assets)
at 8 risk aversions gamma_t = 10^(5 t / 8 - 1), made by
benchmark/problems/portfolio_frontier.py: P, G, h, A and b are the
market's, shared by the lanes, and only q differs.  The bars: shared
operands give, through chol2, the same x, y, s and z (1e-12 relative),
iterations and status as the same lanes with every operand batched; the
port agrees with benchmark/reference/qp_frontier.py within the
configuration's tolerances; a shared operand reaches the KKT strategy
as the caller's own storage and counts once in operand_bytes.
"""

import numpy as np
import pytest
import torch

from benchmark.problems import portfolio_frontier
from benchmark.reference import qp_frontier
from kvxopt_tpu_torch import ConeDims, config, parallel, trace
from kvxopt_tpu_torch.parallel import batch as pbatch

LANES, K, N = 8, 2, 40
DIMS = ConeDims(l=N)
TOL = {"abstol": 1e-7, "reltol": 1e-6, "feastol": 1e-7}
KEYS = ("P", "q", "G", "h", "A", "b")
SHARED = ("P", "G", "h", "A", "b")


@pytest.fixture(autouse=True)
def on_cpu():
    with config.using_device("cpu"):
        yield


def market(seed=5):
    cfg = {"k": K, "n": N, "density": 0.5, "lanes": LANES}
    gen = torch.Generator().manual_seed(seed)
    return portfolio_frontier.make(cfg, gen, LANES, torch.device("cpu"),
                                   torch.float64)


def batched(data, keys=SHARED):
    """data with the operands `keys` copied into every lane."""
    return {k: (v.expand(LANES, *v.shape).clone() if k in keys else v)
            for k, v in data.items()}


def solve(data, kktsolver=None):
    return parallel.batched_qp_solver(DIMS, kktsolver)(
        *(data[k] for k in KEYS))


def rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def same_lanes(out, ref, tol=1e-12):
    for a, b in zip(out[:4], ref[:4]):
        assert a.shape == b.shape
        assert rel(a, b) <= tol
    assert out[4].tolist() == ref[4].tolist()
    assert out[5].tolist() == ref[5].tolist()


def test_market_shapes():
    d = market()
    nv = N + K
    assert d["P"].shape == (nv, nv) and d["q"].shape == (LANES, nv)
    assert d["G"].shape == (N, nv) and d["h"].shape == (N,)
    assert d["A"].shape == (K + 1, nv) and d["b"].shape == (K + 1,)
    g = 10.0 ** (5.0 * np.arange(LANES) / LANES - 1.0)
    np.testing.assert_allclose((d["q"][0] / d["q"]).numpy()[:, 0], g / g[0],
                               rtol=1e-14)


def test_shared_operands_match_batched_ones():
    d = market()
    same_lanes(solve(d), solve(batched(d)))


@pytest.mark.parametrize("keys", [("P",), ("G", "h"), ("A", "b"), ("G",),
                                  ("P", "A", "h")],
                         ids=lambda k: "+".join(k))
def test_mixed_batched_and_shared_operands(keys):
    """Some operands batched, the rest shared: as all batched."""
    d = market()
    same_lanes(solve(batched(d, keys)), solve(batched(d)))


@pytest.mark.parametrize("kktsolver", ["chol2", "chol", "qr", "ldl", "ldl2"])
def test_shared_operands_agree_with_the_reference(kktsolver):
    d = market()
    out = solve(d, kktsolver)
    ref = qp_frontier.solve(**d, tol=TOL)
    assert ref["status"] == ["optimal"] * LANES
    assert (out[5] == 1).all()
    # the batched state counts the last convergence test as a step
    assert (out[4] - 1).tolist() == ref["iterations"]
    j = qp_frontier.judge(d, dict(zip("xysz", out[:4])), TOL)
    assert max(j["residual"]) <= TOL["feastol"]
    assert max(j["gap"]) <= 1.0
    assert float((out[0] - ref["x"]).abs().max()) <= 1e-6


def test_the_reference_takes_shared_and_batched_operands_alike():
    d = market()
    a = qp_frontier.solve(**d, tol=TOL)
    b = qp_frontier.solve(**batched(d), tol=TOL)
    assert a["status"] == b["status"] and a["iterations"] == b["iterations"]
    for k in "xysz":
        assert rel(a[k], b[k]) <= 1e-12


def test_shared_operands_are_not_copied_per_lane(monkeypatch):
    """chol2 gets the caller's P, G and A themselves, and operand_bytes
    counts each shared storage once."""
    seen = {}
    real = pbatch.kkt.make_kkt_solver

    def spy(name, dims, G, A, P, **kw):
        seen.update(G=G, A=A, P=P)
        return real(name, dims, G, A, P, **kw)
    monkeypatch.setattr(pbatch.kkt, "make_kkt_solver", spy)
    d = market()
    solve(d)
    for k in ("G", "A", "P"):
        assert seen[k].shape == d[k].shape
        assert seen[k].data_ptr() == d[k].data_ptr()
    shared = trace.calls()[-1].counters["operand_bytes"]
    assert shared == sum(v.numel() * v.element_size() for v in d.values())
    solve(batched(d))
    full = trace.calls()[-1].counters["operand_bytes"]
    market_bytes = shared - d["q"].numel() * 8
    assert full == LANES * market_bytes + d["q"].numel() * 8


def test_other_strategies_get_stride_zero_views(monkeypatch):
    seen = {}
    real = pbatch.kkt.make_kkt_solver

    def spy(name, dims, G, A, P, **kw):
        seen.update(G=G, A=A, P=P)
        return real(name, dims, G, A, P, **kw)
    monkeypatch.setattr(pbatch.kkt, "make_kkt_solver", spy)
    d = market()
    solve(d, "ldl")
    for k in ("G", "A", "P"):
        assert seen[k].shape == (LANES, *d[k].shape)
        assert seen[k].stride(0) == 0
        assert seen[k].data_ptr() == d[k].data_ptr()


def test_count_operands_counts_a_storage_once():
    t = torch.zeros((4, 5), dtype=torch.float64)
    u = torch.zeros(3, dtype=torch.float32)
    with trace.root("batched_qp"):
        trace.count_operands(t, t[1:], t.expand(7, 4, 5), u, None)
    assert trace.calls()[-1].counters["operand_bytes"] == 4 * 5 * 8 + 3 * 4


@pytest.mark.parametrize("name", ["G", "P", "h", "A", "b"])
def test_a_batch_that_does_not_match_q_raises(name):
    d = batched(market(), (name,))
    d[name] = d[name][:3]
    with pytest.raises(ValueError, match="3 lanes"):
        solve(d)


def test_numpy_shared_operands():
    """Array-likes take the routed path, shared operands as given."""
    d = market()
    out = solve({k: v.numpy() for k, v in d.items()})
    same_lanes(out, solve(d))


def test_mixed_driver_with_shared_operands(monkeypatch):
    """Pass 2 re-solves the lanes pass 1 failed (every other one, here)
    with the shared operands whole."""
    real = pbatch.batched_qp_solver

    def failing_first_pass(dims, kktsolver=None, *a, **k):
        inner = real(dims, kktsolver, *a, **k)
        if kktsolver != "chol2_mixed_nofb":
            return inner

        def first(*args):
            out = inner(*args)
            st = out[5].clone()
            st[::2] = 2
            return (*out[:5], st, out[6])
        return first
    monkeypatch.setattr(pbatch, "batched_qp_solver", failing_first_pass)
    d = market()
    drv = parallel.batched_qp_solver_mixed(DIMS)
    out = drv(*(d[k] for k in KEYS))
    assert drv.stats["pass2_lanes"] == LANES // 2
    assert (out[5] == 1).all()
    ref = solve(d)
    assert float((out[0] - ref[0]).abs().max()) <= 1e-6


def test_sequential_driver_with_shared_operands():
    d = market()
    out = parallel.batched_qp_solver_seq(DIMS, "chol2", group=2)(
        *(d[k] for k in KEYS))
    same_lanes(out, solve(d))


def lp_shared(B=6, n=5, m=12, seed=3):
    """Bounded LPs whose lanes share G and h (lp_batch's form: random rows
    and the box |x| <= 5) and differ in c."""
    rng = np.random.default_rng(seed)
    G = np.vstack([rng.standard_normal((m - 2 * n, n)), np.eye(n),
                   -np.eye(n)])
    h = np.concatenate([rng.uniform(1, 2, m - 2 * n), np.full(2 * n, 5.0)])
    c = rng.standard_normal((B, n))
    return [torch.as_tensor(a) for a in (c, G, h)]


@pytest.mark.parametrize("kktsolver", ["chol2", "qr"])
def test_lp_driver_with_shared_operands(kktsolver):
    c, G, h = lp_shared()
    solve = parallel.batched_lp_solver(ConeDims(l=G.shape[0]), kktsolver)
    out = solve(c, G, h)
    ref = solve(c, *(a.expand(c.shape[0], *a.shape).clone() for a in (G, h)))
    assert (out[7] == 1).all()
    assert out[6].tolist() == ref[6].tolist()
    assert out[7].tolist() == ref[7].tolist()
    # a product with shared G is one GEMM, rounded otherwise than the
    # lanes' own products; the LP's iterates near its vertex amplify
    # that to ~1e-9, within the solver's tolerances
    for a, b in zip(out[:4], ref[:4]):
        assert a.shape == b.shape
        assert rel(a / out[4][:, None], b / ref[4][:, None]) <= 1e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(100, 1010, 11), (8, 42, 3)])
def test_k5_takes_a_shared_right_hand_side_on_card(cuda, B, n, k):
    """A' shared by the lanes, a view with batch stride 0 (kkt's
    _condensed_solve): each lane's x as from its own copy, bit for
    bit."""
    from kvxopt_tpu_torch.ops.chol_solve64 import chol_solve64
    M = torch.randn((B, n, n), device=cuda, dtype=torch.float64)
    L = torch.linalg.cholesky(M @ M.mT + n * torch.eye(
        n, device=cuda, dtype=torch.float64))
    At = torch.randn((k, n), device=cuda, dtype=torch.float64).mT
    x = chol_solve64(L, At.expand(B, n, k))
    assert torch.equal(x, chol_solve64(L, At.expand(B, n, k).contiguous()))


@pytest.mark.cuda
def test_shared_operands_on_card(cuda):
    """The frontier on the card, through chol2 and K5: as the same lanes
    with every operand batched (one GEMM over the lanes rounds otherwise
    than per-lane products, so to 1e-10), and within the reference's
    judge."""
    d = {k: v.to(cuda) for k, v in market().items()}
    out = solve(d)
    ref = solve(batched(d))
    assert out[0].device.type == "cuda"
    assert out[4].tolist() == ref[4].tolist()
    assert out[5].tolist() == ref[5].tolist() == [1] * LANES
    for a, b in zip(out[:4], ref[:4]):
        assert rel(a, b) <= 1e-10
    j = qp_frontier.judge(d, dict(zip("xysz", out[:4])), TOL)
    assert max(j["residual"]) <= TOL["feastol"]
