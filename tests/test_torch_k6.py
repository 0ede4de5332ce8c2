"""Kernel K6 of kvxopt_tpu_torch.ops.chol64, the f64 batched Cholesky factor
that ops.ipm_chol.chol_factor routes kkt's f64 factors on the card to.

On the CPU the wrapper runs its plain version, chol_ls.cholesky_nan, and
the tests here check the launch plan and the route, which are plain
Python.  The tests marked `cuda` hold the kernel against the plain
version on the card, where they run without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_k6.py

The kernel is backward stable like the plain version: per lane
||L L' - K|| / ||K|| <= 10 n u (u = 2^-52), whatever the conditioning.
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import kkt, ops, trace
from kvxopt_tpu_torch.ops import chol64 as k6
from kvxopt_tpu_torch.ops import chol_ls as cl
from kvxopt_tpu_torch.ops import ipm_chol

# clusters of 1..8 CTAs of K6 that one H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters at K6's shared memory)
H100 = (132, 66, 39, 30, 22, 17, 15, 15)


def spd64(B, n, seed=1):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, 2 * n, n))
    return torch.from_numpy(np.einsum("bij,bik->bjk", G, G) + n * np.eye(n))


# ---------------------------------------------------------------------------
# The plan and the route (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,n,C", [
    (100, 1010, 1),     # portfolio-frontier: one CTA a lane
    (32, 1010, 3),      # portfolio-b32: 96 SMs (clusters of 4: 30 fit)
    (1, 1010, 8),       # portfolio-single: a cluster of 8
    (32, 11, 0),        # the Schur complement: a warp a lane
])
def test_k6_plan_at_the_cells(B, n, C):
    assert k6.k6_plan(B, n, H100) == C


@pytest.mark.parametrize("B,n,C", [
    (1, 1, 0), (1000, 32, 0), (1, 33, 1), (1, 64, 1), (1, 128, 1),
    (1, 129, 1), (1, 256, 2), (5, 517, 4), (7, 4000, 8), (15, 1010, 8),
    (16, 1010, 6), (22, 1010, 5), (39, 1010, 3), (40, 1010, 2),
    (66, 1010, 2), (67, 1010, 1), (100000, 1010, 1),
    (1, k6.K6_MAX_N, 8)])
def test_k6_plan_edges(B, n, C):
    """A warp a lane up to n = 32; past it the largest cluster whose B
    copies the card holds at once, with at least two 64-row blocks a
    CTA."""
    assert k6.k6_plan(B, n, H100) == C


def test_k6_plan_refuses_past_its_order():
    assert k6.k6_plan(1, k6.K6_MAX_N + 1, H100) is None
    assert k6.k6_fits(k6.K6_MAX_N) and not k6.k6_fits(k6.K6_MAX_N + 1)


@pytest.mark.parametrize("dev,dtype,B,n,route", [
    ("cuda", torch.float64, 32, 1010, True),
    ("cuda", torch.float64, 100, 1010, True),
    ("cuda", torch.float64, 2, 1010, True),
    ("cuda", torch.float64, 32, 11, True),
    ("cuda", torch.float64, 1, 11, True),
    ("cuda", torch.float64, 1, ipm_chol.K6_ALONE_MAX_N, True),
    ("cuda", torch.float64, 1, ipm_chol.K6_ALONE_MAX_N + 1, False),
    ("cuda", torch.float64, 1, 1010, False),
    ("cuda", torch.float64, 2, k6.K6_MAX_N, True),
    ("cuda", torch.float64, 2, k6.K6_MAX_N + 1, False),
    ("cuda", torch.float32, 32, 1010, False),
    ("cpu", torch.float64, 32, 1010, False),
    ("cpu", torch.float32, 1, 11, False),
])
def test_k6_route(dev, dtype, B, n, route):
    """The f64 factor's rule: the device, the dtype, whether K6 takes the
    order n, and a single factor past K6_ALONE_MAX_N left to cuSOLVER."""
    assert ipm_chol.k6_route(torch.device(dev), dtype, B, n) is route


def test_k6_cpu_wrapper_never_consults_cuda(monkeypatch):
    """A CPU f64 matrix never reaches the kernel library, through the
    wrapper or through kkt's factor, and counts no K6 launch."""
    def forbidden(*a, **k):
        raise AssertionError("CPU path consulted CUDA or the kernels")
    monkeypatch.setattr(torch.cuda, "is_available", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    monkeypatch.setattr(k6, "_lib", forbidden)
    monkeypatch.setattr(k6, "resident", forbidden)
    before = dict(ops.LAUNCHES)
    k6.cholesky64(spd64(2, 70))
    ipm_chol.chol_factor(spd64(2, 70))
    kkt._chol_spd(spd64(2, 70), 0.0)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported or mixed devices"):
        k6.cholesky64(torch.empty((2, 40, 40), dtype=torch.float64,
                                  device="meta"))


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("bad", [None, (1, 0), (2, 39)])
def test_chol_spd_on_cpu_is_cholesky_nan(reg, bad):
    """On the CPU kkt._chol_spd still returns cholesky_nan's factor, bit
    for bit, NaN lanes included (a pivot that fails first or last), and
    no block inverses."""
    K = spd64(3, 40)
    if bad is not None:
        K[bad[0], bad[1], bad[1]] = -1e6
    L, Dinv = kkt._chol_spd(K, reg)
    assert Dinv is None
    Lr = cl.cholesky_nan(K + reg * torch.eye(40, dtype=K.dtype) if reg
                         else K)
    torch.testing.assert_close(L, Lr, rtol=0, atol=0, equal_nan=True)
    if bad is not None:
        assert bool(torch.isnan(L[bad[0]]).all())


@pytest.mark.parametrize("shape", [(3, 40, 40), (2, 3, 17, 17), (1, 200, 200),
                                   (0, 5, 5)])
def test_chol_lower_on_cpu_is_cholesky_nan(shape):
    """On the CPU the f64 factor's route is the plain version, bit for
    bit, in any batch shape."""
    B = int(np.prod(shape[:-2]))
    n = shape[-1]
    K = spd64(B, n).reshape(shape)
    if B > 1:
        K.view(-1, n, n)[1, n - 1, n - 1] = -1.0
    L, Dinv = ipm_chol.chol_factor(K)
    assert Dinv is None
    torch.testing.assert_close(L, cl.cholesky_nan(K), rtol=0, atol=0,
                               equal_nan=True)


def bad_lane_system(device="cpu"):
    """Three SPD matrices of order 16, lane 1 at cond 1e9 (beyond f32, so
    the mixed solver's f64 fallback takes it), and right-hand sides."""
    rng = np.random.default_rng(4)
    K = np.empty((3, 16, 16))
    for i in range(3):
        Q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
        K[i] = (Q * np.logspace(0, 9 if i == 1 else 2, 16)) @ Q.T
    b = rng.standard_normal((3, 16))
    return (torch.from_numpy(K).to(device), torch.from_numpy(b).to(device))


def test_mixed_fallback_factors_through_the_route(monkeypatch):
    """The mixed solver's f64 fallback factors through the route, once,
    on the f64 matrices, beside its f32 factor."""
    seen, plain = [], kkt.chol_factor

    def counted(K):
        seen.append((K.dtype, tuple(K.shape)))
        return plain(K)

    monkeypatch.setattr(kkt, "chol_factor", counted)
    K, _ = bad_lane_system()
    ksolve = kkt.mixed_spd_solver(K)
    assert ksolve.bad.tolist() == [False, True, False]
    assert seen == [(torch.float32, (3, 16, 16)),
                    (torch.float64, (3, 16, 16))]


# ---------------------------------------------------------------------------
# K6 against its plain version (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def spd64_on(B, n, cond, dev, seed=1):
    """B SPD matrices Q diag(d) Q' on the card, d log-spaced from 1 to
    1/cond, Q the orthogonal factor of a Gaussian matrix."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.linalg.qr(torch.randn((B, n, n), generator=g, device=dev,
                                    dtype=torch.float64))[0]
    d = torch.logspace(0, -np.log10(cond), n, device=dev,
                       dtype=torch.float64)
    return (Q * d) @ Q.mT


def backward_error(L, K):
    return torch.linalg.matrix_norm(L @ L.mT - K) / torch.linalg.matrix_norm(K)


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [1e2, 1e12])
@pytest.mark.parametrize("B,n", [(1, 1010), (32, 1010), (100, 1010),
                                 (32, 11), (7, 4000), (5, 517), (3, 33),
                                 (2, 64), (2, 1011)])
def test_k6_matches_plain_on_card(cuda, B, n, cond):
    """One launch a call; per lane ||L L' - K|| / ||K|| <= 10 n u; the
    upper triangle exactly zero, the diagonal positive; the factor within 10 n u cond(K) of
    cholesky_nan's (capped at 1e-3; at cond 1e12 the backward error
    carries the check)."""
    K = spd64_on(B, n, cond, cuda)
    before = ops.LAUNCHES["K6"]
    L = k6.cholesky64(K)
    assert ops.LAUNCHES["K6"] == before + 1
    assert L.shape == K.shape and L.is_contiguous()
    u = 2.0 ** -52
    assert float(backward_error(L, K).max()) <= 10 * n * u
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    Lr = cl.cholesky_nan(K)
    err = torch.linalg.matrix_norm(L - Lr) / torch.linalg.matrix_norm(Lr)
    assert float(err.max()) < min(1e-3, 10 * n * u * cond)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(32, 1010), (4, 11), (3, 517)])
def test_k6_reads_the_lower_triangle_in_place(cuda, B, n):
    """Whatever lies above the diagonal, and a transposed view, give the
    same factor bit for bit."""
    K = spd64_on(B, n, 1e4, cuda)
    L = k6.cholesky64(K)
    junk = torch.tril(K) + torch.triu(torch.full_like(K, float("nan")), 1)
    assert torch.equal(k6.cholesky64(junk), L)
    assert torch.equal(k6.cholesky64(junk.mT.contiguous().mT), L)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(32, 1010), (100, 1010), (1, 1010),
                                 (32, 11), (5, 517)])
@pytest.mark.parametrize("where", ["first", "last"])
def test_k6_nan_lane_on_card(cuda, B, n, where):
    """A lane that is not positive definite, at its first or its last
    pivot, comes out all NaN; the other lanes are finite and agree with
    cholesky_nan."""
    K = spd64_on(B, n, 1e6, cuda)
    bad = B // 2
    p = 0 if where == "first" else n - 1
    K[bad, p, p] = -1.0
    L = k6.cholesky64(K)
    assert bool(torch.isnan(L[bad]).all())
    keep = [i for i in range(B) if i != bad]
    if keep:
        assert bool(torch.isfinite(L[keep]).all())
        Lr = cl.cholesky_nan(K[keep])
        assert float((L[keep] - Lr).abs().max() / Lr.abs().max()) < 1e-9


@pytest.mark.cuda
def test_k6_refuses_bad_inputs(cuda):
    K = spd64_on(2, 64, 1e2, cuda)
    before = ops.LAUNCHES["K6"]
    with pytest.raises(TypeError):
        k6.cholesky64(K.float())
    with pytest.raises(ValueError, match="expected"):
        k6.cholesky64(K[:, :, :60])
    assert ops.LAUNCHES["K6"] == before


@pytest.mark.cuda
def test_k6_counts_one_portfolio_b32_call(cuda):
    """One portfolio-b32 call (the benchmark's problem) factors through
    K6 alone: two launches a factorization (K and the Schur complement
    S), by LAUNCHES["K6"]."""
    import json
    import os
    from benchmark.problems import portfolio
    from kvxopt_tpu_torch import ConeDims, parallel
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "portfolio.json")) as f:
        cfg = json.load(f)
    gen = torch.Generator(device=cuda).manual_seed(1)
    d = portfolio.make(cfg, gen, 32, cuda, torch.float64)
    solve = parallel.batched_qp_solver(ConeDims(l=cfg["n"]))
    args = [d[key] for key in ("P", "q", "G", "h", "A", "b")]
    solve(*args)
    torch.cuda.synchronize()
    ops.reset_launches()
    solve(*args)
    rec = trace.calls()[-1]
    factors = rec.spans["kkt.factor"][0]
    assert factors > 0
    assert ops.LAUNCHES["K6"] == 2 * factors


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,on_k6", [
    (1, 11, True), (1, ipm_chol.K6_ALONE_MAX_N, True),
    (1, ipm_chol.K6_ALONE_MAX_N + 1, False), (1, 1010, False),
    (2, 1010, True)])
def test_chol_lower_on_card(cuda, B, n, on_k6):
    """The route on the card: K6's factor where k6_route takes the shape,
    cholesky_nan's (no K6 launch) where it does not."""
    K = spd64_on(B, n, 1e4, cuda)
    before = ops.LAUNCHES["K6"]
    L, Dinv = ipm_chol.chol_factor(K)
    assert ops.LAUNCHES["K6"] == before + on_k6 and Dinv is None
    want = k6.cholesky64(K) if on_k6 else cl.cholesky_nan(K)
    assert torch.equal(L, want)


@pytest.mark.cuda
def test_mixed_fallback_on_card(cuda):
    """The mixed solver's f64 fallback factors on K6 on the card (three
    lanes of order 16): one launch, the failing lane solved to its
    condition, the others as on the CPU."""
    K, b = bad_lane_system(cuda)
    before = ops.LAUNCHES["K6"]
    ksolve = kkt.mixed_spd_solver(K)
    assert ksolve.bad.tolist() == [False, True, False]
    assert ops.LAUNCHES["K6"] == before + 1
    x = ksolve(b).cpu().numpy()
    Kc, bc = K.cpu().numpy(), b.cpu().numpy()
    r = np.einsum("bij,bj->bi", Kc, x) - bc
    assert np.abs(r).max() < 1e-6 * np.abs(bc).max()
    want = np.linalg.solve(Kc, bc[..., None])[..., 0]
    for i, tol in ((0, 1e-9), (1, 1e-5), (2, 1e-9)):
        assert (np.linalg.norm(x[i] - want[i])
                <= tol * np.linalg.norm(want[i]))
