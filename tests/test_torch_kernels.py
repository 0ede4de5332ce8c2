"""Kernels K1/K2/K3 of kvxopt_tpu_torch.ops.chol_ls, K4 of
kvxopt_tpu_torch.ops.chol and K5 of kvxopt_tpu_torch.ops.chol_solve64.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels run in interpret mode (as
tests/test_ops.py runs them).  The CUDA kernels themselves are held
against the plain versions in the tests marked `cuda`, which skip where
no card is present.  JAX is imported only by the parity tests, so on the
card (which has no JAX) the kernel tests run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances are tests/test_ops.py's: f32 factors of
well-conditioned matrices (cond ~ 10) agree to ~1e-6 relative, so 1e-5
on L and on solve residuals, 1e-4 on Dinv*L_kk = I and on single sweeps.
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import kkt, ops
from kvxopt_tpu_torch.ops import _build, chol as ch, chol_ls as cl
from kvxopt_tpu_torch.ops import chol_solve64 as c64
from kvxopt_tpu_torch.ops import ipm_chol

SHAPES = [(2, 128), (2, 200), (3, 256)]


def spd(B, n, seed=1):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, 2 * n, n)).astype(np.float32)
    return np.einsum("bij,bik->bjk", G, G) + n * np.eye(n, dtype=np.float32)


def rhs(B, n, k, seed=2):
    rng = np.random.default_rng(seed)
    shape = (B, n) if k == 1 else (B, n, k)
    return rng.standard_normal(shape).astype(np.float32)


_JAX_FACTORS = {}


def jax_ops():
    import jax.numpy as jnp
    from kvxopt_tpu.ops import chol_ls
    return jnp, chol_ls


def jax_factors(B, n):
    """The JAX kernel's (L, Dinv) in interpret mode, once per shape."""
    if (B, n) not in _JAX_FACTORS:
        jnp, jcl = jax_ops()
        L, D = jcl.batched_cholesky_ls(jnp.asarray(spd(B, n)),
                                       interpret=True)
        _JAX_FACTORS[(B, n)] = (np.array(L), np.array(D))
    return _JAX_FACTORS[(B, n)]


def dinv_identity_err(L, Dinv):
    """max |Dinv_kb * L_kk - I| over the diagonal blocks of every lane."""
    L, Dinv = np.asarray(L), np.asarray(Dinv)
    n = L.shape[-1]
    err = 0.0
    for kb in range(Dinv.shape[0]):
        lo, hi = kb * 128, min(kb * 128 + 128, n)
        I = Dinv[kb, :, :hi - lo, :hi - lo] @ L[:, lo:hi, lo:hi]
        err = max(err, float(np.abs(I - np.eye(hi - lo)).max()))
    return err


# n = 32 is the Schur complement's single block, 96 a ragged single block
@pytest.mark.parametrize("B,n", SHAPES + [(16, 32), (2, 96)])
def test_factor_plain_matches_jax(B, n):
    Lj, Dj = jax_factors(B, n)
    Lt, Dt = cl.batched_cholesky_ls(torch.from_numpy(spd(B, n)))
    assert Lt.shape == Lj.shape and Dt.shape == Dj.shape
    assert np.abs(Lt.numpy() - Lj).max() / np.abs(Lj).max() < 1e-5
    assert dinv_identity_err(Lt, Dt) < 1e-4
    assert dinv_identity_err(Lj, Dj) < 1e-4
    assert np.array_equal(np.triu(Lt.numpy(), 1), np.zeros_like(Lj))


# k = 32 is K^-1 A' (k = p), 37 a ragged column tile; n = 32 the Schur PCG
@pytest.mark.parametrize("k", [1, 4, 32, 37])
@pytest.mark.parametrize("B,n", SHAPES + [(16, 32)])
def test_solve_plain_matches_jax(B, n, k):
    Lj, Dj = jax_factors(B, n)
    b = rhs(B, n, k)
    jnp, jcl = jax_ops()
    xj = np.asarray(jcl.chol_solve_ls(jnp.asarray(Lj), jnp.asarray(Dj),
                                      jnp.asarray(b), interpret=True))
    xt = cl.chol_solve_ls(torch.from_numpy(Lj), torch.from_numpy(Dj),
                          torch.from_numpy(b)).numpy()
    assert xt.shape == b.shape
    K = spd(B, n).astype(np.float64)
    r = np.einsum("bij,bj...->bi...", K, xt) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5
    assert np.abs(xt - xj).max() / np.abs(xj).max() < 1e-5


def rhs_views(b):
    """rhs as the solver passes it and as views with other strides: a
    transposed copy read back through a transposed view, and slices of a
    wider tensor, 16-byte aligned (+4) or not (+3).  Each is (label, view)."""
    B, n = b.shape[:2]
    out = [("contiguous", b)]
    if b.ndim == 2:
        out.append(("3-D", b[:, :, None]))
        out.append(("transposed", b.t().contiguous().t()))
        for ofs in (3, 4):
            wide = torch.zeros((B, n + 8), device=b.device)
            wide[:, ofs:ofs + n] = b
            out.append((f"slice+{ofs}", wide[:, ofs:ofs + n]))
        return out
    k = b.shape[2]
    out.append(("transposed", b.transpose(1, 2).contiguous().transpose(1, 2)))
    for ofs in (3, 4):
        wide = torch.zeros((B, n, k + 8), device=b.device)
        wide[:, :, ofs:ofs + k] = b
        out.append((f"slice+{ofs}", wide[:, :, ofs:ofs + k]))
    return out


@pytest.mark.parametrize("k", [1, 5])
def test_solve_plain_accepts_strided_rhs(k):
    """The CPU path takes rhs with any strides and returns rhs's shape."""
    L, D = cl.batched_cholesky_ls(torch.from_numpy(spd(2, 130)))
    b = torch.from_numpy(rhs(2, 130, k))
    x0 = cl.chol_solve_ls(L, D, b)
    for label, r in rhs_views(b):
        x = cl.chol_solve_ls(L, D, r)
        assert x.shape == r.shape, label
        torch.testing.assert_close(x.reshape(x0.shape), x0, rtol=0,
                                   atol=1e-6, msg=label)


def test_solve_args_read_rhs_in_place():
    """What K2 and K3 are handed: rhs itself wherever its columns are
    contiguous (any batch and row strides), one copy where they are not,
    and a fresh contiguous (B, n, k) X."""
    L, D = cl.batched_cholesky_ls(torch.from_numpy(spd(2, 130)))
    for k in (1, 5):
        b = torch.from_numpy(rhs(2, 130, k))
        for label, r in rhs_views(b):
            r3, vec, X = cl._solve_args(L, D, r)
            assert vec == (r.ndim == 2), label
            assert X.shape == (2, 130, k) and X.is_contiguous(), label
            assert r3.shape == (2, 130, k) and torch.equal(
                r3.reshape(b.shape), b), label
            if k > 1:
                assert r3.stride(2) == 1, label
            same = r3.data_ptr() == r.data_ptr()
            assert same == (label != "transposed" or k == 1), label


# k = n is the factor refinement's shape (kkt.py), in both modes
TRI_CASES = [(B, n, k) for B, n in SHAPES for k in (1, 4)] + [
    (2, 128, 128), (2, 200, 200)]


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("B,n,k", TRI_CASES)
def test_tri_plain_matches_jax(B, n, k, trans):
    Lj, Dj = jax_factors(B, n)
    b = rhs(B, n, k, seed=3)
    jnp, jcl = jax_ops()
    xj = np.asarray(jcl.tri_solve_ls(jnp.asarray(Lj), jnp.asarray(Dj),
                                     jnp.asarray(b), trans=trans,
                                     interpret=True))
    xt = cl.tri_solve_ls(torch.from_numpy(Lj), torch.from_numpy(Dj),
                         torch.from_numpy(b), trans=trans).numpy()
    assert xt.shape == b.shape
    assert np.abs(xt - xj).max() / (np.abs(xj).max() + 1) < 1e-4


@pytest.mark.parametrize("B,n", [(2, 128), (1, 200), (3, 64), (16, 32)])
def test_k4_plain_matches_jax(B, n):
    """K4's plain version against the JAX batched_cholesky in interpret
    mode, at tests/test_ops.py's shapes (n=200 and n=64 are padded)."""
    import jax.numpy as jnp
    from kvxopt_tpu.ops.chol import batched_cholesky as jax_chol
    K = spd(B, n, seed=0)
    Lj = np.asarray(jax_chol(jnp.asarray(K), interpret=True))
    Lt = ch.batched_cholesky(torch.from_numpy(K))
    assert Lt.shape == Lj.shape == (B, n, n) and Lt.dtype == torch.float32
    assert np.abs(Lt.numpy() - Lj).max() / np.abs(Lj).max() < 1e-5
    assert np.array_equal(np.triu(Lt.numpy(), 1), np.zeros_like(Lj))


def test_k4_indefinite_lane_gives_nan_on_cpu():
    L = ch.batched_cholesky(indefinite_pair())
    assert bool(torch.isfinite(L[0]).all())
    assert bool(torch.isnan(L[1]).any())


def test_ops_exports_match_jax_package():
    """kvxopt_tpu_torch.ops exports what kvxopt_tpu.ops does for the
    kernels; without a card neither kernel reports itself available."""
    for name in ("batched_cholesky", "cholesky_kernel_available",
                 "cholesky_ls_available", "batched_cholesky_ls",
                 "chol_solve_ls", "best_cholesky", "best_chol_factor_solve"):
        assert callable(getattr(ops, name)), name
    assert ops.cholesky_kernel_available() == torch.cuda.is_available()
    assert ops.cholesky_ls_available() == torch.cuda.is_available()
    K = torch.from_numpy(spd(2, 130))
    torch.testing.assert_close(ops.batched_cholesky(K), ops.best_cholesky(K),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# No fallback: the CPU takes the plain path without touching CUDA, and a
# tensor on any other device raises.
# ---------------------------------------------------------------------------

def test_cpu_wrappers_never_consult_cuda(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("CPU path consulted CUDA or the kernels")
    monkeypatch.setattr(torch.cuda, "is_available", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    monkeypatch.setattr(cl, "_lib", forbidden)
    before = dict(ops.LAUNCHES)
    K = torch.from_numpy(spd(2, 130))
    L, D = cl.batched_cholesky_ls(K)
    cl.chol_solve_ls(L, D, torch.ones((2, 130)))
    cl.tri_solve_ls(L, D, torch.ones((2, 130, 3)), trans=True)
    assert ops.LAUNCHES == before


def test_k4_cpu_wrapper_never_consults_cuda(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("CPU path consulted CUDA or the kernels")
    monkeypatch.setattr(torch.cuda, "is_available", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    monkeypatch.setattr(ch, "_lib", forbidden)
    before = dict(ops.LAUNCHES)
    ch.batched_cholesky(torch.from_numpy(spd(2, 130)))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported or mixed devices"):
        ch.batched_cholesky(torch.empty((2, 128, 128), device="meta"))


def indefinite_pair(n=200):
    """Two lanes: lane 0 SPD, lane 1 with a negative pivot at row 150
    (past the first 128 block, so the factor breaks inside the loop)."""
    K = spd(2, n)
    K[1, 150, 150] = -1.0
    return torch.from_numpy(K)


def test_indefinite_lane_gives_nan_on_cpu():
    """A non-positive pivot gives NaN, not an error (the IPM turns it into
    status SINGULAR); the other lanes are untouched."""
    L, _ = cl.batched_cholesky_ls(indefinite_pair())
    assert bool(torch.isfinite(L[0]).all())
    assert bool(torch.isnan(L[1]).any())


def test_non_cpu_non_cuda_tensor_raises():
    K = torch.empty((2, 128, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported or mixed devices"):
        cl.batched_cholesky_ls(K)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (card only).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SHAPES + [(16, 512)])
def test_kernels_match_plain_on_card(cuda, B, n):
    K = torch.from_numpy(spd(B, n)).to(cuda)
    L, D = cl.batched_cholesky_ls(K)
    Lr, _ = cl.batched_cholesky_ls_ref(K)
    assert float((L - Lr).abs().max() / Lr.abs().max()) < 1e-5
    assert dinv_identity_err(L.cpu(), D.cpu()) < 1e-4
    for k in (1, 4):
        b = torch.from_numpy(rhs(B, n, k)).to(cuda)
        x = cl.chol_solve_ls(L, D, b)
        r = torch.einsum("bij,bj...->bi...", K.double(), x.double()) - b
        assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-5
        for trans in (False, True):
            x = cl.tri_solve_ls(L, D, b, trans=trans)
            xr = cl.tri_solve_ls_ref(L, D, b, trans=trans)
            assert float((x - xr).abs().max() /
                         (xr.abs().max() + 1)) < 1e-4


def k3_views(b):
    """R as the solver passes it and with other strides: the transposed
    view of the factor refinement's second solve (kkt.py), and column
    slices of a wider tensor, 16-byte aligned (+4) or not (+3)."""
    B, n, k = b.shape
    out = [b] + ([b.transpose(1, 2)] if n == k else [])
    for ofs in (3, 4):
        wide = torch.zeros((B, n, k + 8), device=b.device)
        wide[:, :, ofs:ofs + k] = b
        out.append(wide[:, :, ofs:ofs + k])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("B,n,k", [(16, 512, 512), (2, 128, 37),
                                   (2, 200, 200), (2, 256, 300),
                                   (16, 32, 32)])
def test_k3_matches_plain_on_card(cuda, B, n, k, trans):
    """K3 where its tiling can go wrong: k = n at the factor-refinement
    shape, ragged k, k > n, the Schur complement's shape, strided R."""
    L, D = cl.batched_cholesky_ls(torch.from_numpy(spd(B, n)).to(cuda))
    b = torch.from_numpy(rhs(B, n, k, seed=4)).to(cuda)
    for r in k3_views(b):
        before = ops.LAUNCHES["K3"]
        x = cl.tri_solve_ls(L, D, r, trans=trans)
        assert ops.LAUNCHES["K3"] == before + 1
        xr = cl.tri_solve_ls_ref(L, D, r, trans=trans)
        assert x.shape == r.shape
        assert float((x - xr).abs().max() / (xr.abs().max() + 1)) < 1e-4


def spd_on(B, n, dev, seed=1):
    """spd(B, n) made on the card (numpy is slow at n = 4096)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((B, 2 * n, n), generator=g, device=dev)
    return G.mT @ G + n * torch.eye(n, device=dev)


# (B, n, k) where K2 can go wrong: the solves' shapes (the PCG's k = 1,
# K^-1 A' at k = p = 32, the Schur PCG at n = 32), ragged n (200, and 130
# for 4-byte copies), ragged k, k > n, and n = 4096 (the solved tile in
# shared memory at k = 1, in device memory at k = 32)
K2_CASES = [(16, 512, 1), (16, 512, 32), (16, 32, 1), (16, 32, 32),
            (3, 200, 1), (2, 130, 3), (2, 128, 37), (2, 256, 300),
            (2, 4096, 1), (2, 4096, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", K2_CASES)
def test_k2_matches_plain_on_card(cuda, B, n, k):
    """One launch per call, rhs read with its own strides, and the
    relative residual and the plain version's x within 1e-5."""
    K = spd_on(B, n, cuda)
    L, D = cl.batched_cholesky_ls(K)
    g = torch.Generator(device=cuda).manual_seed(4)
    b = torch.randn((B, n) if k == 1 else (B, n, k), generator=g,
                    device=cuda)
    xr = cl.chol_solve_ls_ref(L, D, b)
    for label, r in rhs_views(b):
        before = ops.LAUNCHES["K2"]
        x = cl.chol_solve_ls(L, D, r)
        assert ops.LAUNCHES["K2"] == before + 1
        assert x.shape == r.shape and x.is_contiguous(), label
        x3, b3 = x.reshape(B, n, k).double(), b.reshape(B, n, k).double()
        res = torch.linalg.norm(K.double() @ x3 - b3) / torch.linalg.norm(b3)
        assert float(res) < 1e-5, label
        err = (x.reshape(xr.shape) - xr).abs().max() / xr.abs().max()
        assert float(err) < 1e-5, label


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(16, 512, 1), (3, 200, 1), (2, 130, 1),
                                   (16, 512, 32), (2, 256, 300)])
def test_k2_device_memory_tile_on_card(cuda, monkeypatch, B, n, k):
    """The path that keeps the solved tile in device memory (taken where
    shared memory cannot hold it), forced at the solves' shapes."""
    K = spd_on(B, n, cuda)
    L, D = cl.batched_cholesky_ls(K)
    b = torch.randn((B, n) if k == 1 else (B, n, k), device=cuda)
    x_smem = cl.chol_solve_ls(L, D, b)
    monkeypatch.setattr(cl, "_K2_SMEM_BYTES", 0)
    x = cl.chol_solve_ls(L, D, b)
    xr = cl.chol_solve_ls_ref(L, D, b)
    assert float((x - xr).abs().max() / xr.abs().max()) < 1e-5
    assert float((x - x_smem).abs().max() / xr.abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32])
def test_indefinite_lane_gives_nan_on_card(cuda, k):
    """A NaN factor lane stays NaN in K2 and leaves the other lane alone."""
    L, D = cl.batched_cholesky_ls(indefinite_pair().to(cuda))
    assert bool(torch.isfinite(L[0]).all())
    assert bool(torch.isnan(L[1]).any())
    b = torch.ones((2, 200) if k == 1 else (2, 200, k), device=cuda)
    x = cl.chol_solve_ls(L, D, b)
    assert bool(torch.isfinite(x[0]).all())
    assert bool(torch.isnan(x[1]).any())
    xr = cl.chol_solve_ls_ref(L[:1], D[:, :1].contiguous(), b[:1])
    assert float((x[:1] - xr).abs().max() / xr.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 128, 512])
def test_kernel_wrappers_refuse_bad_inputs(cuda, n):
    """At the warp (n = 32), block (128) and cluster (512) paths."""
    K = torch.from_numpy(spd(2, n)).to(cuda)
    for f in (cl.batched_cholesky_ls, ch.batched_cholesky):
        with pytest.raises(TypeError):
            f(K.double())
        with pytest.raises(ValueError, match="contiguous"):
            f(K.transpose(1, 2))
        with pytest.raises(ValueError, match="square"):
            f(K[:, :, :16].contiguous())
    if n != 128:
        return
    L, D = cl.batched_cholesky_ls(K)
    b = torch.ones((2, 128), device=cuda)
    with pytest.raises(TypeError):
        cl.chol_solve_ls(L, D, b.double())
    with pytest.raises(ValueError, match="contiguous"):
        cl.chol_solve_ls(L.transpose(1, 2), D, b)
    with pytest.raises(ValueError, match="does not match"):
        cl.chol_solve_ls(L, torch.cat([D, D]), b)
    with pytest.raises(ValueError, match="does not match"):
        cl.chol_solve_ls(L, D, b[:, :100])
    with pytest.raises(ValueError, match="mixed devices"):
        cl.chol_solve_ls(L, D, b.cpu())
    with pytest.raises(ValueError, match="mixed devices"):
        cl.tri_solve_ls(L, D, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SHAPES + [(3, 64), (16, 512)])
def test_k4_matches_plain_on_card(cuda, B, n):
    """K4 against its plain version and K1's L (same arithmetic)."""
    K = torch.from_numpy(spd(B, n)).to(cuda)
    before = ops.LAUNCHES["K4"]
    L = ch.batched_cholesky(K)
    assert ops.LAUNCHES["K4"] == before + 1
    Lr = ch.batched_cholesky_ref(K)
    assert L.shape == (B, n, n)
    assert float((L - Lr).abs().max() / Lr.abs().max()) < 1e-5
    assert torch.equal(L, torch.tril(L))
    assert float((L - cl.batched_cholesky_ls(K)[0]).abs().max()) == 0.0


@pytest.mark.cuda
def test_k4_indefinite_lane_gives_nan_on_card(cuda):
    L = ch.batched_cholesky(indefinite_pair().to(cuda))
    assert bool(torch.isfinite(L[0]).all())
    assert bool(torch.isnan(L[1]).any())


@pytest.mark.cuda
def test_k4_wrapper_refuses_bad_inputs(cuda):
    K = torch.from_numpy(spd(2, 128)).to(cuda)
    with pytest.raises(TypeError):
        ch.batched_cholesky(K.double())
    with pytest.raises(ValueError, match="contiguous"):
        ch.batched_cholesky(K.transpose(1, 2))
    with pytest.raises(ValueError, match="square"):
        ch.batched_cholesky(K[:, :, :64].contiguous())


# n where K1's paths and edges meet: one warp (1, 31, 32), one block (33,
# 96, 127, 128), the cluster path (129: 4-byte copies, 200, 512) and the
# per-step path (640), each ragged and full
K1_NS = [1, 31, 32, 33, 96, 127, 128, 129, 200, 512, 640]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K1_NS)
def test_k1_contract_on_card(cuda, n):
    """K1 against its plain version; L exactly lower triangular; the
    padded part of the last Dinv block exactly the identity; A untouched;
    one wrapper launch counted per call."""
    K = spd_on(3, n, cuda)
    K0 = K.clone()
    before = ops.LAUNCHES["K1"]
    L, D = cl.batched_cholesky_ls(K)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["K1"] == before + 1
    assert torch.equal(K, K0)
    Lr, _ = cl.batched_cholesky_ls_ref(K)
    assert L.shape == (3, n, n) and L.is_contiguous()
    assert float((L - Lr).abs().max() / Lr.abs().max()) < 1e-5
    assert torch.equal(L, torch.tril(L))
    assert dinv_identity_err(L.cpu(), D.cpu()) < 1e-4
    h = n - 128 * (D.shape[0] - 1)
    last = D[-1].cpu()
    eye = torch.eye(128)
    assert torch.equal(last[:, h:, h:], eye[h:, h:].expand(3, -1, -1))
    assert torch.equal(last[:, :h, h:], torch.zeros(3, h, 128 - h))
    assert torch.equal(last[:, h:, :h], torch.zeros(3, 128 - h, h))


@pytest.mark.cuda
@pytest.mark.parametrize("path", [0, 1])
@pytest.mark.parametrize("n", [330, 640])
def test_factor_paths_on_card(cuda, monkeypatch, n, path):
    """The cluster path (0) and the per-step path (1), forced: each agrees
    with the plain version, and K4's L is bit-equal to K1's."""
    monkeypatch.setattr(cl, "_FACTOR_PATH", path)
    K = spd_on(2, n, cuda)
    L, D = cl.batched_cholesky_ls(K)
    Lr, _ = cl.batched_cholesky_ls_ref(K)
    assert float((L - Lr).abs().max() / Lr.abs().max()) < 1e-5
    assert torch.equal(L, torch.tril(L))
    assert dinv_identity_err(L.cpu(), D.cpu()) < 1e-4
    assert torch.equal(ch.batched_cholesky(K), L)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bad", [(32, 20), (512, 300)])
def test_nan_lane_leaves_neighbour_finite_on_card(cuda, n, bad):
    """A negative pivot gives NaN in its lane only, in K1 and K4."""
    K = spd(2, n)
    K[1, bad, bad] = -1.0
    K = torch.from_numpy(K).to(cuda)
    for L in (cl.batched_cholesky_ls(K)[0], ch.batched_cholesky(K)):
        assert bool(torch.isfinite(L[0]).all())
        assert bool(torch.isnan(L[1]).any())
        Lr = ch.batched_cholesky_ref(K[:1])
        assert float((L[:1] - Lr).abs().max() / Lr.abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# K5: the f64 Cholesky solve.  On the CPU its wrapper runs the plain
# version; ops.ipm_chol.chol_solve routes by (device, dtype, n, k) alone.
# ---------------------------------------------------------------------------

def spd64(B, n, seed=1):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, 2 * n, n))
    return torch.from_numpy(np.einsum("bij,bik->bjk", G, G) + n * np.eye(n))


@pytest.mark.parametrize("k", [1, 11])
def test_k5_plain_is_a_cholesky_solve(k):
    K = spd64(3, 40)
    L = torch.linalg.cholesky(K)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 40) if k == 1 else (3, 40, k)))
    x = c64.chol_solve64(L, b)
    b3 = b[..., None] if k == 1 else b
    xr = torch.cholesky_solve(b3, L)
    assert x.shape == b.shape
    torch.testing.assert_close(x.reshape(xr.shape), xr, rtol=1e-12,
                               atol=0)


def test_k5_cpu_takes_plain_path(monkeypatch):
    """A CPU f64 factor never reaches the kernel library, through the
    wrapper or through kkt's solve, and counts no K5 launch."""
    def forbidden(*a, **k):
        raise AssertionError("CPU path consulted CUDA or the kernels")
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    monkeypatch.setattr(c64, "_lib", forbidden)
    before = dict(ops.LAUNCHES)
    L = torch.linalg.cholesky(spd64(2, 70))
    c64.chol_solve64(L, torch.ones((2, 70)))
    kkt._spd_chol(spd64(2, 70), 0.0)(torch.ones((2, 70, 11)))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("dev,dtype,n,k,route", [
    ("cuda", torch.float64, 1010, 1, True),
    ("cuda", torch.float64, 1010, 11, True),
    ("cuda", torch.float64, 1010, ipm_chol.K5_MAX_K, True),
    ("cuda", torch.float64, 1010, ipm_chol.K5_MAX_K + 1, False),
    ("cuda", torch.float64, 78848, 1, True),
    ("cuda", torch.float64, 78849, 1, False),
    ("cuda", torch.float32, 1010, 1, False),
    ("cpu", torch.float64, 1010, 1, False),
    ("cpu", torch.float32, 1010, 11, False),
])
def test_solve_route(dev, dtype, n, k, route):
    """The rule ops.ipm_chol.chol_solve applies to an f64 factor: the
    device, the dtype, k, and whether K5's shared memory holds the order n
    (up to 78848), nothing else."""
    assert ipm_chol.k5_route(torch.device(dev), dtype, n, k) is route


def _k5_fill_C(B, n, k, kb, sms=132):
    """The cluster size that fills the SMs (k5_plan's first choice)."""
    nb, nct, C = -(-n // 32), -(-k // kb), 1
    while C < 8 and 8 * C <= nb and 2 * C * B * nct <= sms:
        C *= 2
    return C


@pytest.mark.parametrize("B,n,k", [(32, 1010, 1), (32, 1010, 11),
                                   (1, 1010, 1), (1, 1010, 16), (32, 11, 1),
                                   (1, 1, 1), (300, 1010, 1), (2, 5000, 16),
                                   (2, 20000, 1), (4, 129, 33),
                                   (32, 4000, 11), (67, 4000, 1),
                                   (7, 14880, 11), (34, 14880, 1),
                                   (32, 40000, 16), (1, 78848, 1)])
def test_k5_plan_fits_the_card(B, n, k):
    """K5's launch plan: a power-of-two column tile up to 8, clusters of
    1-8 CTAs of 4 warps, each warp owning a block, a ring of 3-8 stages
    per warp and shared memory within the card's 227 KB.  The clusters
    fill at most the 132 SMs, except where shared memory needs more CTAs
    to share a lane's accumulators: then one cluster size less would not
    fit."""
    kb, C, S = c64.k5_plan(B, n, k, 132)
    nb = -(-n // 32)
    assert kb in (1, 2, 4, 8) and kb <= max(1, 2 * k - 1)
    assert C in (1, 2, 4, 8) and (C == 1 or 4 * C <= nb)
    assert 3 <= S <= 8
    assert c64.k5_smem(nb, C, kb, S) <= 232448
    if C > _k5_fill_C(B, n, k, kb):
        assert c64.k5_smem(nb, C // 2, kb, 3) > 232448


def test_k5_plan_fills_the_card_at_the_batched_shape():
    """portfolio-b32's solves (B = 32, n = 1010): at k = 1 clusters of 4
    CTAs, 128 of the 132 SMs, 16 warps a lane; at k = p = 11 two column
    tiles of 8, each a cluster of 2; a single solve takes 8 CTAs."""
    assert c64.k5_plan(32, 1010, 1, 132)[:2] == (1, 4)
    assert c64.k5_plan(32, 1010, 11, 132)[:2] == (8, 2)
    assert c64.k5_plan(1, 1010, 1, 132)[:2] == (1, 8)
    assert c64.k5_plan(1, 1010, 11, 132)[:2] == (8, 8)


def test_k5_plan_grows_clusters_for_shared_memory():
    """Where a lane's accumulators outgrow a CTA that fills the SMs, the
    cluster grows past them and the clusters run in waves: at B = 7,
    n = 14880, k = 11 one CTA a lane holds no plan even at kb = 1, and
    clusters of 8 hold kb = 4 (3 column tiles, 168 CTAs).  Past
    n = 78848 no plan fits, whatever B and k."""
    assert c64.k5_plan(7, 14880, 11, 132) == (4, 8, 3)
    assert c64.k5_smem(465, 1, 1, 3) > 232448
    assert c64.k5_fits(78848)
    for B, k in ((1, 1), (32, 11), (300, 16)):
        assert c64.k5_plan(B, 78849, k, 132) is None
    assert not c64.k5_fits(78849)


# ---------------------------------------------------------------------------
# K5 against its plain version (card only).
# ---------------------------------------------------------------------------

def spd64_on(B, n, cond, dev, seed=1):
    """B SPD matrices Q diag(d) Q' on the card, d log-spaced from 1 to
    1/cond, Q the orthogonal factor of a Gaussian matrix."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.linalg.qr(torch.randn((B, n, n), generator=g, device=dev,
                                    dtype=torch.float64))[0]
    d = torch.logspace(0, -np.log10(cond), n, device=dev,
                       dtype=torch.float64)
    return (Q * d) @ Q.mT


K5_CASES = [(B, n, k) for B in (1, 32) for n in (11, 127, 128, 129, 1010)
            for k in (1, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [1e2, 1e12])
@pytest.mark.parametrize("B,n,k", K5_CASES)
def test_k5_matches_plain_on_card(cuda, B, n, k, cond):
    """One launch per call.  Both K5 and the plain version are backward
    stable: each x solves (L + E)(L + E)' x = b with |E| <= c n u |L|
    (u = 2^-53), so the residual against L L' is within 8 n u of
    ||L||^2 ||x|| per lane whatever the conditioning, and the two x agree
    to within 8 n u cond(K), capped at 1e-3 (at cond 1e12 the residual
    carries the check)."""
    K = spd64_on(B, n, cond, cuda)
    L = torch.linalg.cholesky(K)
    g = torch.Generator(device=cuda).manual_seed(4)
    b = torch.randn((B, n) if k == 1 else (B, n, k), generator=g,
                    device=cuda, dtype=torch.float64)
    before = ops.LAUNCHES["K5"]
    x = c64.chol_solve64(L, b)
    assert ops.LAUNCHES["K5"] == before + 1
    assert x.shape == b.shape and x.is_contiguous()
    xr = cl.chol_solve_ls_ref(L, None, b)
    u = 2.0 ** -53
    x3, b3 = x.reshape(B, n, k), b.reshape(B, n, k)
    res = torch.linalg.norm(L @ (L.mT @ x3) - b3, dim=(1, 2))
    scale = torch.linalg.matrix_norm(L) ** 2 * torch.linalg.norm(
        x3, dim=(1, 2))
    assert float((res / scale).max()) < 8 * n * u
    err = torch.linalg.norm(x3 - xr.reshape(B, n, k), dim=(1, 2)) / \
        torch.linalg.norm(xr.reshape(B, n, k), dim=(1, 2))
    assert float(err.max()) < min(1e-3, 8 * n * u * cond)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(200, 300, 1), (8, 2048, 1), (3, 700, 16),
                                   (2, 64, 2), (5, 33, 4)])
def test_k5_launch_plans_on_card(cuda, B, n, k):
    """The plan's other shapes: one CTA a lane with several blocks per
    warp (B = 200), clusters of 8 with two blocks per warp (n = 2048),
    column tiles of 8 and of 2 and 4, and two blocks in all."""
    L = torch.linalg.cholesky(spd64_on(B, n, 1e6, cuda))
    b = torch.randn((B, n, k), device=cuda, dtype=torch.float64)
    before = ops.LAUNCHES["K5"]
    x = c64.chol_solve64(L, b)
    assert ops.LAUNCHES["K5"] == before + 1
    xr = cl.chol_solve_ls_ref(L, None, b)
    err = torch.linalg.norm(x - xr, dim=(1, 2)) / torch.linalg.norm(
        xr, dim=(1, 2))
    assert float(err.max()) < 8 * n * 2.0 ** -53 * 1e6


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(32, 4000, 11), (67, 4000, 1),
                                   (7, 14880, 11)])
def test_k5_large_orders_on_card(cuda, B, n, k):
    """Large orders, where a lane's accumulators fill a CTA: one CTA a
    lane (67 lanes, k = 1) or clusters of 4 at kb = 8 (k = 11), and
    clusters of 8 in waves past the SMs (B = 7, n = 14880), the plan that
    shared memory forces there.  L = D + E, D's diagonal in [1, 2] and E
    strictly lower with N(0, 1/n^2) entries, so ||E|| ~ 2/sqrt(n) and
    cond(L) < 3: both solves are backward stable, so they agree within
    8 n u cond(L)^2 (the two sweeps)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    U = torch.randn((B, n, n), generator=g, device=cuda,
                    dtype=torch.float64).triu_(1).div_(n)
    U.diagonal(dim1=1, dim2=2).uniform_(1.0, 2.0, generator=g)
    L = U.mT                        # column-major, as cuSOLVER's factors
    b = torch.randn((B, n, k), generator=g, device=cuda,
                    dtype=torch.float64)
    before = ops.LAUNCHES["K5"]
    x = c64.chol_solve64(L, b)
    assert ops.LAUNCHES["K5"] == before + 1
    xr = cl.chol_solve_ls_ref(L, None, b)
    err = torch.linalg.norm(x - xr, dim=(1, 2)) / torch.linalg.norm(
        xr, dim=(1, 2))
    assert float(err.max()) < 8 * n * 2.0 ** -53 * 9


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(32, 1010, 11), (3, 200, 5), (2, 129, 33),
                                   (1, 1010, 16)])
def test_k5_reads_rhs_in_place_on_card(cuda, B, n, k):
    """rhs as a transposed view (K^-1 A' in kkt), as a column slice and
    wider than one column tile (k = 33), and L column-major (cuSOLVER's
    factor) or row-major: the same x as from contiguous copies, bit for
    bit."""
    L = torch.linalg.cholesky(spd64_on(B, n, 1e4, cuda))
    A = torch.randn((B, k, n), device=cuda, dtype=torch.float64)
    x = c64.chol_solve64(L, A.mT)
    assert torch.equal(x, c64.chol_solve64(L, A.mT.contiguous()))
    assert torch.equal(x, c64.chol_solve64(L.contiguous(), A.mT))
    xr = cl.chol_solve_ls_ref(L, None, A.mT)
    assert float((x - xr).abs().max() / xr.abs().max()) < 1e-9
    W = torch.randn((B, n, k + 3), device=cuda, dtype=torch.float64)
    assert torch.equal(c64.chol_solve64(L, W[:, :, 2:k + 2]),
                       c64.chol_solve64(L, W[:, :, 2:k + 2].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1010, 1), (1010, 11), (11, 1)])
def test_k5_nan_lane_on_card(cuda, n, k):
    """A NaN factor lane (cholesky_nan's) comes out all NaN; the other
    lanes are bit-equal to their own solve."""
    K = spd64_on(32, n, 1e6, cuda)
    K[5, n // 2, n // 2] = -1.0
    L = cl.cholesky_nan(K)
    b = torch.randn((32, n, k), device=cuda, dtype=torch.float64)
    x = c64.chol_solve64(L, b)
    assert bool(torch.isnan(x[5]).all())
    keep = [i for i in range(32) if i != 5]
    assert bool(torch.isfinite(x[keep]).all())
    assert torch.equal(x[keep], c64.chol_solve64(L[keep].contiguous(),
                                                 b[keep]))
    assert torch.equal(x[:1], c64.chol_solve64(L[:1], b[:1]))


@pytest.mark.cuda
def test_k5_refuses_bad_inputs(cuda):
    L = torch.linalg.cholesky(spd64_on(2, 64, 1e2, cuda))
    b = torch.ones((2, 64), device=cuda, dtype=torch.float64)
    before = ops.LAUNCHES["K5"]
    with pytest.raises(TypeError):
        c64.chol_solve64(L.float(), b)
    with pytest.raises(TypeError):
        c64.chol_solve64(L, b.float())
    gappy = torch.zeros((2, 64, 80), device=cuda,
                        dtype=torch.float64)[:, :, :64]
    with pytest.raises(ValueError, match="contiguous"):
        c64.chol_solve64(gappy, b)
    with pytest.raises(ValueError, match="contiguous"):
        c64.chol_solve64(gappy.mT, b)
    with pytest.raises(ValueError, match="does not match"):
        c64.chol_solve64(L, b[:, :60])
    with pytest.raises(ValueError, match="expected"):
        c64.chol_solve64(L[:, :, :60], b)
    with pytest.raises(ValueError, match="mixed devices"):
        c64.chol_solve64(L, b.cpu())
    assert ops.LAUNCHES["K5"] == before


@pytest.mark.cuda
def test_k5_counts_in_the_program_record(cuda):
    """kkt's f64 chol2 solve on the card goes through K5, one launch a
    solve by LAUNCHES, the one launch count."""
    K = spd64_on(4, 300, 1e3, cuda)
    before = ops.LAUNCHES["K5"]
    s = kkt._spd_chol(K, 0.0)
    x = s(torch.ones((4, 300), device=cuda, dtype=torch.float64))
    s(torch.ones((4, 300, 11), device=cuda, dtype=torch.float64))
    assert ops.LAUNCHES["K5"] == before + 2
    xr = cl.chol_solve_ls_ref(torch.linalg.cholesky(K), None,
                              torch.ones((4, 300), device=cuda,
                                         dtype=torch.float64))
    assert float((x - xr).abs().max() / xr.abs().max()) < 1e-10
