"""The sparse-KKT LP of chip_smoke's phase 14(c) at small sizes: conelp
with a custom kktsolver that factors K = G' W^-2 G with the tile
Cholesky, in the port (chip_smoke.tile_kktsolver, CPU tensors) and in
the JAX package (the kktsolver of tests/test_tile_chol.py's
test_ipm_with_tile_sparse_kkt_on_device), on the same seeded problems:
the same status, iterations within 1 and x within 1e-6 (1 + |x|)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu.ops.tile_chol import TileCholesky as JaxTile
from kvxopt_tpu.solvers import conelp as jax_conelp
from kvxopt_tpu_torch import solvers


def banded(n=96, seed=7):
    """tests/test_tile_chol.py's banded block of G, 13 diagonals."""
    rng = np.random.default_rng(seed)
    Gb = np.zeros((n, n))
    for k in range(-6, 7):
        Gb += np.diag(rng.standard_normal(n - abs(k)) * 0.3, k)
    return sp.csc_matrix(Gb + 8.0 * np.eye(n))


def standin():
    """chip_smoke.stiffness_standin at n=150: 50 grid nodes, 2000 stored
    lower entries, random couplings within 20 of the diagonal."""
    return chip_smoke.stiffness_standin(3, 150, 2000, band=20)[0]


def jax_kktsolver(G, tile):
    Gd = jnp.asarray(G)

    def kktsolver(W, H=None, Df=None):
        d = W.d
        Gs = Gd / d[:, None]
        X = tile.factor(tile.tiles_from_dense(Gs.T @ Gs))

        def solve(bx, by, bz):
            bzs = bz / d
            ux = tile.solve(X, bx + Gs.T @ bzs)
            return ux, jnp.zeros((0,), bx.dtype), (Gs @ ux - bzs) / d
        return solve
    return kktsolver


@pytest.mark.parametrize("make,ts", [(banded, 32), (standin, 32)],
                         ids=["banded96", "standin150"])
def test_tile_kkt_lp_matches_jax(make, ts):
    S = make()
    c, G, h = chip_smoke.sparse_lp(S, seed=1)
    m = G.shape[0]
    tile = chip_smoke.kkt_tiles(S, ts)
    assert tile.NT < tile.T * (tile.T + 1) // 2     # the tiles stay sparse
    jtile = JaxTile(set(tile.tiles), S.shape[0], ts)
    ref = jax_conelp(c, jnp.asarray(G), h, JaxDims(l=m),
                     kktsolver=jax_kktsolver(G, jtile))
    St = torch.from_numpy(S.toarray())
    sol = solvers.conelp(*(torch.from_numpy(a) for a in (c, G, h)),
                         {"l": m}, kktsolver=chip_smoke.tile_kktsolver(
                             St, tile))
    assert sol["status"] == ref["status"] == "optimal"
    assert abs(sol["iterations"] - ref["iterations"]) <= 1
    x, xj = sol["x"].numpy(), np.asarray(ref["x"])
    assert np.linalg.norm(x - xj) <= 1e-6 * (1 + np.linalg.norm(xj))
    z, s = sol["z"].numpy(), sol["s"].numpy()
    assert np.linalg.norm(G.T @ z + c) <= 1e-6 * (1 + np.linalg.norm(c))
    assert np.linalg.norm(G @ x + s - h) <= 1e-6 * (1 + np.linalg.norm(h))


def test_stiffness_standin_shape():
    """The stand-in has the order and stored lower count asked for, is
    symmetric (Hermitian) with a positive spectrum, and its random
    couplings stay within the band."""
    for complex_ in (False, True):
        S, shift = chip_smoke.stiffness_standin(2, 150, 2000, band=20,
                                                complex_=complex_)
        low = sp.tril(S)
        assert S.shape == (150, 150) and low.nnz == 2000
        assert abs(S - S.conj().T).max() == 0.0
        assert np.linalg.eigvalsh(S.toarray()).min() > 0.5 * shift
        r, c = low.nonzero()
        assert (r - c).max() <= max(20, 3 * (8 + 1) + 2)
    again, _ = chip_smoke.stiffness_standin(2, 150, 2000, band=20)
    assert abs(again - chip_smoke.stiffness_standin(2, 150, 2000,
                                                    band=20)[0]).max() == 0
