"""Kernel K7 of kvxopt_tpu_torch.ops.gram64, the f64 scaled Gram product
K = C0 + G' diag(d)^-2 G + reg I that chol2 builds its K with on an
orthant, and the solve that applies the scaled G through G and d.

On the CPU the wrapper runs its plain version, and chol2 keeps the formed
scaled G, so every CPU result is the arithmetic it was, bit for bit.  The
tests here check the route, the plan, the plain version, and (with the
route forced on the CPU) the solve's products through G and d.  The tests
marked `cuda` hold the kernel against the plain version on the card,
where they run without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_gram64.py

Tolerances.  Each entry of K is a sum of m products w_i G_ip G_iq plus
C0_pq, and both the kernel and the plain version form it with an error of
at most (m + 4) u times the same sum of absolute values (u = 2^-52: the
products, the weight's division and square, and the sum in any order), so
they lie within 2 (m + 4) u (|C0| + |G|' diag(w) |G|) of each other,
entry by entry, however d is scaled.  The solve's products through G and
d round once more per term than those of the formed Gs, so the condensed
solve agrees with the formed path to the conditioning of K times u; 1e-13
relative leaves room for K's condition of ~1e2 here.
"""

import pkgutil

import numpy as np
import pytest
import torch

import kvxopt_tpu_torch as kt
from kvxopt_tpu_torch import cones, kkt, ops
from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.ops import gram64 as g7
from kvxopt_tpu_torch.ops import ipm_chol

U = 2.0 ** -52


def operands(B, m, n, shared, c0, seed=1, spread=2.0, device="cpu"):
    """G (m, n) or (B, m, n), d (B, m) with log d ~ N(0, spread), and C0
    None, (n, n) or (B, n, n) symmetric positive semidefinite."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n) if shared else (B, m, n))
    d = np.exp(spread * rng.standard_normal((B, m)))
    C0 = None
    if c0 is not None:
        R = rng.standard_normal((n, n) if c0 == "shared" else (B, n, n))
        C0 = R @ np.swapaxes(R, -1, -2)
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in (C0, G, d))


# ---------------------------------------------------------------------------
# The route and the plan (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dev,dtype,m,n,route", [
    ("cuda", torch.float64, 1000, 1010, True),     # the portfolio cells
    ("cuda", torch.float64, 3, 2, True),
    ("cuda", torch.float64, 0, 1010, False),       # no rows to scale
    ("cuda", torch.float64, 1000, g7.K7_MAX_N, True),
    ("cuda", torch.float64, 1000, g7.K7_MAX_N + 1, False),
    ("cuda", torch.float64, 2 ** 31 // 1011 + 1, 1010, False),
    ("cuda", torch.float32, 1000, 1010, False),
    ("cpu", torch.float64, 1000, 1010, False),
    ("cpu", torch.float32, 5, 5, False),
])
def test_k7_route(dev, dtype, m, n, route):
    """The product's rule: the device, the dtype, and whether K7 takes a
    G of m rows and n columns; the batch does not enter (K7 is ahead at
    every B measured, B = 1 included)."""
    assert ipm_chol.k7_route(torch.device(dev), dtype, m, n) is route


@pytest.mark.parametrize("B,n,T", [
    (100, 1010, 128),   # portfolio-frontier: 3600 tiles, 28 waves
    (32, 1010, 128),    # portfolio-b32
    (1, 1010, 64),      # one lane: 36 128-tiles would leave 96 SMs idle
    (4, 1010, 64),
    (8, 1010, 128),
    (1, 11, 64),        # one tile either way, a quarter of the work
    (1000, 11, 64),
])
def test_k7_plan(B, n, T):
    assert g7.k7_plan(B, n, 132) == T


# ---------------------------------------------------------------------------
# The plain version and the CPU path (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("c0", [None, "shared", "batched"])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_plain_version_is_the_formed_product(shared, c0, reg):
    """gram64_ref, and the wrapper on the CPU, equal C0 + Gs' Gs (+ reg I)
    bit for bit, Gs the l-cone scaling's W^{-T} G as cones forms it."""
    C0, G, d = operands(3, 40, 17, shared, c0)
    W = cones.NTScaling(d=d)
    Gs = cones.wtw_scale_cols(ConeDims(l=40), W, G)
    want = Gs.mT @ Gs if C0 is None else C0 + Gs.mT @ Gs
    if reg:
        want = want + reg * torch.eye(17, dtype=torch.float64)
    before = dict(ops.LAUNCHES)
    for got in (g7.gram64_ref(C0, G, d, reg), g7.gram64(C0, G, d, reg),
                ipm_chol.scaled_gram(C0, G, d, reg)):
        assert got.shape == (3, 17, 17)
        assert torch.equal(got, want)
    assert ops.LAUNCHES == before


def test_k7_cpu_wrapper_never_consults_cuda(monkeypatch):
    """CPU tensors never reach the kernel library and count no K7
    launch."""
    def forbidden(*a, **k):
        raise AssertionError("CPU path consulted CUDA or the kernels")
    monkeypatch.setattr(torch.cuda, "is_available", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    monkeypatch.setattr(g7, "_lib", forbidden)
    monkeypatch.setattr(g7, "_sm_count", forbidden)
    before = ops.LAUNCHES["K7"]
    g7.gram64(*operands(2, 30, 9, True, "shared"), 1e-3)
    assert ops.LAUNCHES["K7"] == before
    C0, G, d = operands(2, 30, 9, True, None)
    with pytest.raises(ValueError, match="unsupported or mixed devices"):
        g7.gram64(None, G.to("meta"), d)


# ---------------------------------------------------------------------------
# chol2's solve through G and d (CPU, the route forced)
# ---------------------------------------------------------------------------

def chol2_system(B, m, n, p, mnl, shared, seed=3):
    """A chol2 Newton system on an orthant of m rows (and mnl nonlinear
    rows): G, A, P shared or batched, H and Df batched, W from interior
    points within e^-1 and e of one, and right-hand sides."""
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    G = t(*lead, m, n)
    A = t(*lead, p, n) if p else None
    R = t(*lead, n, n)
    P = R @ R.mT + n * torch.eye(n, dtype=torch.float64)
    H = Df = None
    if mnl:
        Rh = t(B, n, n)
        H = Rh @ Rh.mT
        Df = t(B, mnl, n)
    dims = ConeDims(l=m)
    edims = dims.with_extra_l(mnl) if mnl else dims
    s = torch.exp(torch.from_numpy(rng.uniform(-1, 1, (B, m + mnl))))
    z = torch.exp(torch.from_numpy(rng.uniform(-1, 1, (B, m + mnl))))
    W, _ = cones.compute_scaling(edims, s, z)
    rhs = (t(B, n), t(B, p), t(B, m + mnl))
    return dims, G, A, P, H, Df, mnl, W, rhs


def chol2_solve(system):
    dims, G, A, P, H, Df, mnl, W, rhs = system
    f = kkt.make_kkt_solver("chol2", dims, G, A, P, mnl=mnl, reg=1e-9)
    return f(W, H=H, Df=Df)(*rhs)


@pytest.mark.parametrize("shared,mnl", [(True, 0), (False, 0), (False, 2)])
@pytest.mark.parametrize("p", [0, 3])
def test_solve_through_g_matches_the_formed_gs(monkeypatch, shared, p, mnl):
    """With the route forced on the CPU, chol2 forms K by scaled_gram (the
    plain version: the same K, so the same factor) and applies Gs through
    G and d: the solve agrees with the formed Gs's to 1e-13 relative, on
    l-only rows with G shared or batched and on l + mnl rows (cp and cpl,
    whose G is batched), with and without A."""
    system = chol2_system(4, 30, 12, p, mnl, shared)
    want = chol2_solve(system)
    calls = []

    def counted(*args):
        calls.append(args[1].shape)
        return g7.gram64_ref(*args)
    monkeypatch.setattr(kkt, "k7_route", lambda *a: True)
    monkeypatch.setattr(kkt, "scaled_gram", counted)
    got = chol2_solve(system)
    assert len(calls) == 1
    assert calls[0][-2:] == (30 + mnl, 12)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        if y.numel():
            assert float((x - y).abs().max()) <= 1e-13 * float(
                y.abs().max())


@pytest.mark.parametrize("shared", [True, False])
def test_orthant_products_are_the_formed_ones(shared):
    """_orthant's Gs u and Gs' b against the formed Gs's products: one
    rounding more per term, 1e-14 relative."""
    C0, G, d = operands(3, 25, 9, shared, None)
    Gs = cones.wtw_scale_cols(ConeDims(l=25), cones.NTScaling(d=d), G)
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((3, 9)))
    b = torch.from_numpy(rng.standard_normal((3, 25)))
    lanes, mv, tmv = kkt._orthant(G, d)
    lanes_f, mv_f, tmv_f = kkt._formed(Gs)
    assert lanes == lanes_f == 3
    for x, y in ((mv(u), mv_f(u)), (tmv(b), tmv_f(b))):
        assert float((x - y).abs().max()) <= 1e-14 * float(y.abs().max())


def qs_system(dims, n=6, B=2, seed=7):
    """A chol2 system on dims with q or s cones, at the identity
    scaling."""
    rng = np.random.default_rng(seed)
    G = torch.from_numpy(rng.standard_normal((B, dims.size, n)))
    R = torch.from_numpy(rng.standard_normal((B, n, n)))
    P = R @ R.mT + n * torch.eye(n, dtype=torch.float64)
    e = cones.cone_e(dims, torch.float64).expand(B, -1)
    W, _ = cones.compute_scaling(dims, e, e)
    rhs = (torch.from_numpy(rng.standard_normal((B, n))),
           torch.zeros((B, 0), dtype=torch.float64),
           torch.from_numpy(rng.standard_normal((B, dims.size))))
    return dims, G, None, P, None, None, 0, W, rhs


@pytest.mark.parametrize("dims", [ConeDims(l=4, q=[3]), ConeDims(l=4, s=[2]),
                                  ConeDims(q=[3, 3])],
                         ids=["l+q", "l+s", "q"])
def test_q_and_s_rows_keep_the_formed_path(monkeypatch, dims):
    """With q or s rows chol2 forms Gs as before, whatever the route says:
    the same solve bit for bit, and no call of scaled_gram."""
    system = qs_system(dims)
    want = chol2_solve(system)

    def forbidden(*a):
        raise AssertionError("q or s rows reached scaled_gram")
    monkeypatch.setattr(kkt, "k7_route", lambda *a: True)
    monkeypatch.setattr(kkt, "scaled_gram", forbidden)
    for x, y in zip(chol2_solve(system), want):
        assert torch.equal(x, y)


def test_the_module_is_in_the_walk():
    """ops/gram64.py is one of the port's modules that
    tests/test_torch_no_jax.py imports and reads."""
    names = {m.name for m in pkgutil.walk_packages(kt.__path__,
                                                    kt.__name__ + ".")}
    assert "kvxopt_tpu_torch.ops.gram64" in names
    from tests.test_torch_no_jax import PORT_FILES
    assert any(p.parts[-2:] == ("ops", "gram64.py") for p in PORT_FILES)


# ---------------------------------------------------------------------------
# K7 against its plain version (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lower(K):
    n = K.shape[-1]
    return torch.tril(torch.ones(n, n, dtype=torch.bool, device=K.device))


def assert_within_bound(K, C0, G, d, reg):
    """K's lower triangle within 2 (m + 4) u (|C0| + |G|' diag(w) |G|) of
    the plain version's, entry by entry (the module's note)."""
    m = d.shape[-1]
    want = g7.gram64_ref(C0, G, d, reg)
    absb = g7.gram64_ref(None if C0 is None else C0.abs(), G.abs(), d, 0.0)
    low = lower(K)
    err = ((K - want).abs() - 2 * (m + 4) * U * absb)[..., low]
    assert float(err.max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,shared,c0", [
    (100, 1000, 1010, True, "shared"),     # portfolio-frontier
    (32, 1000, 1010, False, "batched"),    # portfolio-b32
    (1, 1000, 1010, True, "shared"),       # portfolio-single
    (3, 50, 11, True, None), (2, 70, 33, False, "batched"),
    (4, 129, 64, True, "shared"), (3, 37, 65, False, None),
    (2, 1000, 1010, False, None)])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("tile", [None, 64, 128])
def test_k7_matches_plain_on_card(cuda, monkeypatch, B, m, n, shared, c0,
                                  reg, tile):
    """One launch a call; K's lower triangle within the bound of the
    module's note, d spread from ~1e-8 to ~1e8 (log d ~ N(0, 6)), at the
    planned tile and at both tile orders."""
    C0, G, d = operands(B, m, n, shared, c0, spread=6.0, device=cuda)
    if tile:
        monkeypatch.setattr(g7, "k7_plan", lambda *a: tile)
    before = ops.LAUNCHES["K7"]
    K = g7.gram64(C0, G, d, reg)
    assert ops.LAUNCHES["K7"] == before + 1
    assert K.shape == (B, n, n) and K.is_contiguous()
    assert_within_bound(K, C0, G, d, reg)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 34])
def test_k7_takes_odd_and_unaligned_rows(cuda, n):
    """An odd n (rows of an odd length) and a G whose start is not
    16-byte aligned give K within the bound, as an even, aligned G."""
    C0, G, d = operands(5, 60, n, False, "batched", device=cuda)
    Gu = torch.empty(G.numel() + 1, dtype=torch.float64,
                     device=cuda)[1:].view(G.shape)
    Gu.copy_(G)
    for Gx in (G, Gu):
        assert_within_bound(g7.gram64(C0, Gx, d, 1e-3), C0, Gx, d, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_k7_nan_lane_on_card(cuda, shared):
    """A NaN in one lane's d makes that lane's K NaN and leaves its
    neighbours finite and within the bound."""
    C0, G, d = operands(6, 300, 200, shared, "shared", device=cuda)
    d[3, 17] = float("nan")
    K = g7.gram64(C0, G, d, 1e-3)
    low = lower(K)
    assert bool(torch.isnan(K[3][low]).all())
    keep = [0, 1, 2, 4, 5]
    assert bool(torch.isfinite(K[keep][..., low]).all())
    Gk = G if shared else G[keep]
    assert_within_bound(K[keep], C0, Gk, d[keep], 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,kernel", [(32, 1010, "K6"), (2, 200, "K6"),
                                        (1, 1010, None)])
def test_factor_routes_read_the_lower_triangle(cuda, B, n, kernel):
    """Each route of chol_factor (K6, and cholesky_nan for one large
    factor) gives the same factor, bit for bit, whatever lies above K's
    diagonal: NaN there changes nothing."""
    C0, G, d = operands(B, 1000, n, True, "shared", device=cuda)
    K = g7.gram64_ref(C0, G, d, 1e-3)
    junk = torch.tril(K) + torch.triu(torch.full_like(K, float("nan")), 1)
    before = ops.LAUNCHES["K6"]
    L = ipm_chol.chol_factor(K)[0]
    Lj = ipm_chol.chol_factor(junk)[0]
    assert ops.LAUNCHES["K6"] == before + (2 if kernel else 0)
    assert torch.equal(L, Lj) and bool(torch.isfinite(Lj).all())


@pytest.mark.cuda
def test_k7_refuses_bad_inputs(cuda):
    C0, G, d = operands(2, 30, 9, True, "shared", device=cuda)
    before = ops.LAUNCHES["K7"]
    with pytest.raises(TypeError):
        g7.gram64(C0, G.float(), d)
    with pytest.raises(ValueError, match="does not match"):
        g7.gram64(C0, G[:20], d)
    with pytest.raises(ValueError, match="C0"):
        g7.gram64(C0[:5], G, d)
    assert ops.LAUNCHES["K7"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_chol2_on_card_through_k7(cuda, monkeypatch, shared):
    """chol2 on the card takes K7 on an orthant, with G shared and
    batched, and its solve agrees with the formed path's (the route
    switched off) to 1e-11 relative."""
    dims, G, A, P, H, Df, mnl, W, rhs = chol2_system(8, 300, 120, 5, 0,
                                                     shared)
    system = (dims, G.to(cuda), A.to(cuda), P.to(cuda), None, None, 0,
              cones.NTScaling(d=W.d.to(cuda)), tuple(r.to(cuda) for r in rhs))
    before = ops.LAUNCHES["K7"]
    got = chol2_solve(system)
    assert ops.LAUNCHES["K7"] == before + 1
    monkeypatch.setattr(kkt, "k7_route", lambda *a: False)
    want = chol2_solve(system)
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-11 * float(y.abs().max())


@pytest.mark.cuda
def test_k7_counts_one_portfolio_b32_call(cuda):
    """One portfolio-b32 call builds every K of order 1010 on K7: K7's
    launches at n = 1010 equal K6's (one a factorization)."""
    import json
    import os
    from benchmark.problems import portfolio
    from kvxopt_tpu_torch import parallel
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "portfolio.json")) as f:
        cfg = json.load(f)
    gen = torch.Generator(device=cuda).manual_seed(1)
    data = portfolio.make(cfg, gen, 32, cuda, torch.float64)
    solve = parallel.batched_qp_solver(ConeDims(l=cfg["n"]))
    args = [data[key] for key in ("P", "q", "G", "h", "A", "b")]
    solve(*args)
    torch.cuda.synchronize()
    ops.reset_launches()
    solve(*args)
    n = cfg["n"] + cfg["k"]
    k7 = ops.LAUNCH_SHAPES[("K7", n, 0)]
    assert k7 > 0 and k7 == ops.LAUNCH_SHAPES[("K6", n, 0)]
