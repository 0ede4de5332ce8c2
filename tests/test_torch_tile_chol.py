"""The port's TileCholesky (kvxopt_tpu_torch/ops/tile_chol.py) and
cholmod's tile path against kvxopt_tpu's on the CPU: the same tile list
and schedules from the same pattern, factors that agree to 1e-10
relative, residuals below 1e-8, and cholmod with options['device'] =
True under config.using_device("cpu") against the JAX cholmod with
device=True on its CPU backend."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from kvxopt_tpu import cholmod as jchol, matrix as jmatrix
from kvxopt_tpu import spmatrix as jspmatrix
from kvxopt_tpu.ops.tile_chol import TileCholesky as JaxTile
from kvxopt_tpu_torch import cholmod as tchol, config
from kvxopt_tpu_torch import matrix as tmatrix, spmatrix as tspmatrix
from kvxopt_tpu_torch.ops.tile_chol import (TileCholesky,
                                            tile_pattern_from_sparse)

FACTOR_TOL, RES_TOL = 1e-10, 1e-8


def block_banded_spd(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for k in range(-bw, bw + 1):
        A += np.diag(rng.standard_normal(n - abs(k)), k)
    return 0.5 * (A + A.T) + (2.0 * bw + 2.0) * np.eye(n)


def arrow_spd(n=128, ts=32, seed=4):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(n // ts):
        M = rng.standard_normal((ts, ts))
        A[d * ts:(d + 1) * ts, d * ts:(d + 1) * ts] = M @ M.T + n * np.eye(ts)
    A[-ts:, :] = rng.standard_normal((ts, n)) * 0.3
    A[:, -ts:] = A[-ts:, :].T
    A[-ts:, -ts:] += n * np.eye(ts)
    return 0.5 * (A + A.T) + n * np.eye(n)


def hermitian_banded(n, bw, seed):
    rng = np.random.default_rng(seed)
    M = np.zeros((n, n), complex)
    for k in range(1, bw + 1):
        M += np.diag(rng.standard_normal(n - k)
                     + 1j * rng.standard_normal(n - k), -k)
    return M + M.conj().T + (2.0 * bw + 2.0) * np.eye(n)


def both(A, ts):
    """(JAX tile object, port tile object) from A's lower pattern."""
    pat = tile_pattern_from_sparse(sp.csc_matrix(np.tril(A)), ts)
    return JaxTile(pat, A.shape[0], ts), TileCholesky(pat, A.shape[0], ts)


def same_schedule(jt, tt):
    assert tt.tiles == jt.tiles and tt.NT == jt.NT and tt.T == jt.T
    assert tt.upd == jt.upd and tt.col_rows == jt.col_rows
    assert tt.col_slots == jt.col_slots


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def factor_both(A, ts):
    jt, tt = both(A, ts)
    same_schedule(jt, tt)
    Lj = np.tril(np.asarray(jt.dense_from_tiles(jt.factor(
        jt.tiles_from_dense(jnp.asarray(A))))))
    Xt = tt.factor(tt.tiles_from_dense(torch.from_numpy(A)))
    Lt = np.tril(tt.dense_from_tiles(Xt).numpy())
    return jt, tt, Xt, Lj, Lt


@pytest.mark.parametrize("n,ts,bw", [(96, 32, 20), (200, 64, 40)])
def test_tile_factor_and_solve_match_jax_on_banded(n, ts, bw):
    A = block_banded_spd(n, bw, seed=1)
    jt, tt, Xt, Lj, Lt = factor_both(A, ts)
    assert rel(Lt, Lj) < FACTOR_TOL
    assert rel(Lt, np.linalg.cholesky(A)) < FACTOR_TOL
    b = np.random.default_rng(3).standard_normal(n)
    x = tt.solve(Xt, torch.from_numpy(b)).numpy()
    xj = np.asarray(jt.solve(jt.factor(jt.tiles_from_dense(jnp.asarray(A))),
                             jnp.asarray(b)))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < RES_TOL
    assert rel(x, xj) < FACTOR_TOL
    # (n, k) right-hand sides, and the two sweeps alone
    B = np.random.default_rng(4).standard_normal((n, 3))
    X = tt.solve(Xt, torch.from_numpy(B)).numpy()
    assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) < RES_TOL
    y = tt.solve_l(Xt, torch.from_numpy(B)).numpy()
    assert rel(Lt @ y, B) < RES_TOL
    z = tt.solve_lt(Xt, torch.from_numpy(B)).numpy()
    assert rel(Lt.T @ z, B) < RES_TOL


def test_tile_arrow_fill_matches_jax():
    """The arrow pattern's fill (the last block row) is the JAX
    package's, and L L' = A."""
    A = arrow_spd()
    jt, tt, _, Lj, Lt = factor_both(A, 32)
    assert tt.NT > len(tile_pattern_from_sparse(sp.csc_matrix(np.tril(A)),
                                                32)) - 1
    assert rel(Lt, Lj) < FACTOR_TOL
    assert rel(Lt @ Lt.T, A) < FACTOR_TOL


def test_tile_refactorization():
    """The same analysis factors new values of the same pattern."""
    n, ts = 160, 32
    A = block_banded_spd(n, 24, seed=2)
    _, tt = both(A, ts)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    for M in (A, A * 1.7 + 0.3 * np.eye(n)):
        X = tt.factor(tt.tiles_from_dense(torch.from_numpy(M)))
        x = tt.solve(X, b).numpy()
        assert np.linalg.norm(M @ x - b.numpy()) / np.linalg.norm(
            b.numpy()) < RES_TOL


def test_tile_batch_matches_vmap():
    """A batch of 4 same-pattern matrices in one factor and solve, against
    the JAX package's vmap over its factor."""
    n, ts = 128, 32
    A0 = block_banded_spd(n, 20, seed=6)
    jt, tt = both(A0, ts)
    scales = 1.0 + 0.2 * np.arange(4)
    As = np.stack([A0 * s for s in scales])
    Lj = jax.vmap(jt.factor)(jnp.stack([jt.tiles_from_dense(jnp.asarray(a))
                                        for a in As]))
    Xt = tt.factor(tt.tiles_from_dense(torch.from_numpy(As)))
    assert Xt.shape == (4, tt.NT, ts, ts)
    Lt = np.tril(tt.dense_from_tiles(Xt).numpy())
    for i in range(4):
        Lji = np.tril(np.asarray(jt.dense_from_tiles(Lj[i])))
        assert rel(Lt[i], Lji) < FACTOR_TOL
    b = np.random.default_rng(7).standard_normal((4, n))
    x = tt.solve(Xt, torch.from_numpy(b)).numpy()
    r = np.einsum("bij,bj->bi", As, x) - b
    assert (np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)).max() \
        < RES_TOL
    x2 = tt.solve(Xt, torch.from_numpy(b[..., None].repeat(2, -1))).numpy()
    assert rel(x2[..., 1], x) < FACTOR_TOL


def test_tile_complex_hermitian_matches_jax():
    n, ts = 72, 16
    A = hermitian_banded(n, 10, seed=8)
    jt, tt, Xt, Lj, Lt = factor_both(A, ts)
    assert Xt.dtype == torch.complex128
    assert rel(Lt, Lj) < FACTOR_TOL
    assert rel(Lt @ Lt.conj().T, A) < FACTOR_TOL
    rng = np.random.default_rng(9)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = tt.solve(Xt, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < RES_TOL
    # the host conversion mirrors diagonal tiles as the JAX one does
    low = sp.csc_matrix(np.tril(A))
    np.testing.assert_array_equal(tt.tiles_from_csc(low),
                                  jt.tiles_from_csc(low))
    assert rel(tt.diagonal(Xt).numpy(), np.diag(Lj).real) < FACTOR_TOL


def test_tile_factor_not_pd_raises():
    A = block_banded_spd(64, 8, seed=10)
    A[40, 40] = -50.0
    _, tt = both(A, 16)
    X = tt.tiles_from_dense(torch.from_numpy(A))
    L, info = tt.factor_ex(X)
    assert info.shape == (tt.T,) and int(info[2]) > 0
    with pytest.raises(ArithmeticError):
        tt.factor(X)


# ---------------------------------------------------------------------------
# cholmod's tile path: device=True on the CPU against JAX's device=True
# ---------------------------------------------------------------------------


def sparse_spd(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    if complex_:
        M = M + 1j * rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    A = M @ M.conj().T + n * np.eye(n)
    return sp.csc_matrix(np.where(np.abs(A) > 1e-12, A, 0.0))


def cholmod_run(mod, spm, mat, device, A, b, sys_codes=range(9), after=None,
                p=None):
    """cholmod symbolic, numeric (and a refactorization with `after`),
    solve for each sys code, diag and getfactor, with options['device'] =
    `device`; the port's default device is the CPU throughout."""
    old = dict(mod.options)
    mod.options.update({"supernodal": 2, "device": device, "tilesize": 8})
    try:
        with config.using_device("cpu"):
            F = mod.symbolic(spm._from_csc(sp.csc_matrix(sp.tril(A))), p=p)
            mod.numeric(spm._from_csc(sp.csc_matrix(sp.tril(A))), F)
            assert getattr(F, "_device", False) == bool(device)
            if after is not None:
                mod.numeric(spm._from_csc(sp.csc_matrix(sp.tril(after))), F)
            outs = []
            for s in sys_codes:
                B = mat(b.copy())
                mod.solve(F, B, sys=s)
                outs.append(np.asarray(B))
            outs += [np.asarray(mod.diag(F)), np.asarray(mod.getfactor(F))]
        return outs, F
    finally:
        mod.options.clear()
        mod.options.update(old)


@pytest.mark.parametrize("complex_", [False, True], ids=["d", "z"])
def test_cholmod_tile_path_matches_jax(complex_):
    """Every sys code 0-8, diag and getfactor: the port's tile path on
    the CPU against the JAX package's device path and against the port's
    own host LDL'."""
    n = 40
    A = sparse_spd(n, 3, complex_)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((n, 2))
    if complex_:
        b = b + 1j * rng.standard_normal((n, 2))
    got, F = cholmod_run(tchol, tspmatrix, tmatrix, True, A, b)
    ref, Fj = cholmod_run(jchol, jspmatrix, jmatrix, True, A, b)
    host, _ = cholmod_run(tchol, tspmatrix, tmatrix, False, A, b)
    np.testing.assert_array_equal(F.perm, Fj.perm)
    assert F._X.device.type == "cpu"
    for s, (g, r, h) in enumerate(zip(got, ref, host)):
        assert rel(g, r) < FACTOR_TOL, s
        assert rel(g, h) < RES_TOL, s
    x = got[0]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < RES_TOL
    L, perm = got[-1], F.perm
    PAPt = A.toarray()[perm][:, perm]
    assert rel(L @ L.conj().T, PAPt) < FACTOR_TOL


def test_cholmod_tile_refactorization_and_not_pd():
    n = 40
    A = sparse_spd(n, 5)
    b = np.random.default_rng(6).standard_normal((n, 1))
    got, _ = cholmod_run(tchol, tspmatrix, tmatrix, True, A, b, (0,),
                         after=A * 2.0)
    ref, _ = cholmod_run(jchol, jspmatrix, jmatrix, True, A, b, (0,),
                         after=A * 2.0)
    assert rel(got[0], ref[0]) < FACTOR_TOL
    assert np.linalg.norm(2.0 * (A @ got[0]) - b) / np.linalg.norm(b) \
        < RES_TOL
    bad = sp.csc_matrix(np.diag(np.r_[np.ones(n - 1), -1.0]))
    for mod, spm in ((tchol, tspmatrix), (jchol, jspmatrix)):
        with pytest.raises(ArithmeticError):
            cholmod_run(mod, spm, None, True, bad, b, ())


def test_cholmod_tile_pattern_change():
    """The tile path keys its analysis on the first numeric call, in both
    packages: a later matrix with another pattern reuses it.  New entries
    inside the analysed tiles are factored exactly; entries in a tile the
    analysis does not hold are dropped, by both packages alike.  (The
    natural order, so that the tiles named here are the analysed ones.)"""
    n = 48
    p = np.arange(n)
    A = sp.csc_matrix(block_banded_spd(n, 3, seed=11))
    inside = A.tolil()
    inside[5, 2] = inside[2, 5] = 0.5        # a new entry in tile (0, 0)
    far = A.tolil()
    far[44, 1] = far[1, 44] = 0.5            # tile (5, 0) is not analysed
    b = np.random.default_rng(12).standard_normal((n, 1))
    for after, exact in ((inside.tocsc(), True), (far.tocsc(), False)):
        got, F = cholmod_run(tchol, tspmatrix, tmatrix, True, A, b, (0,),
                             after=after, p=p)
        ref, _ = cholmod_run(jchol, jspmatrix, jmatrix, True, A, b, (0,),
                             after=after, p=p)
        assert rel(got[0], ref[0]) < FACTOR_TOL
        res = np.linalg.norm(after @ got[0] - b) / np.linalg.norm(b)
        assert (res < RES_TOL) == exact, res
    # the host path sees the change and factors the new pattern
    host, _ = cholmod_run(tchol, tspmatrix, tmatrix, False, A, b, (0,),
                          after=far.tocsc(), p=p)
    assert np.linalg.norm(far @ host[0] - b) / np.linalg.norm(b) < RES_TOL


def test_cholmod_auto_without_a_card_raises(monkeypatch):
    """"auto" and True mean config.default_device, the card: with none
    there, numeric raises and never takes the host path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = tspmatrix._from_csc(sp.csc_matrix(sp.tril(sparse_spd(20, 1))))
    for dev in ("auto", True):
        old = dict(tchol.options)
        tchol.options.update({"supernodal": 2, "device": dev})
        try:
            F = tchol.symbolic(A)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tchol.numeric(A, F)
            assert not getattr(F, "_numeric", False)
            with config.using_device("cpu"):
                tchol.numeric(A, F)
            assert F._device and F._X.device.type == "cpu"
        finally:
            tchol.options.clear()
            tchol.options.update(old)
