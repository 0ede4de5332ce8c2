"""The sparse layer's tile path on the card against the same calls on
the CPU (card only: marked `cuda`, skipped where there is none).  This
file imports no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_card.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from kvxopt_tpu_torch import cholmod, config, matrix, spmatrix
from kvxopt_tpu_torch.ops.tile_chol import (TileCholesky,
                                            tile_pattern_from_sparse)

TOL = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def run(S, b):
    """cholmod's tile path on config.default_device: sys 0-8, getfactor."""
    old = dict(cholmod.options)
    cholmod.options.update({"supernodal": 2, "device": "auto",
                            "tilesize": 32})
    try:
        A = spmatrix._from_csc(S)
        F = cholmod.symbolic(A)
        cholmod.numeric(A, F)
        out = []
        for s in range(9):
            B = matrix(b.copy())
            cholmod.solve(F, B, sys=s)
            out.append(np.asarray(B))
        return out + [np.asarray(cholmod.getfactor(F))], F
    finally:
        cholmod.options.clear()
        cholmod.options.update(old)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True], ids=["d", "z"])
def test_cholmod_tile_path_on_card_matches_cpu(cuda, complex_):
    S, _ = chip_smoke.stiffness_standin(2, 150, 2000, band=20,
                                        complex_=complex_)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((150, 2)) + (
        1j * rng.standard_normal((150, 2)) if complex_ else 0)
    got, F = run(S, b)
    with config.using_device("cpu"):
        cpu, _ = run(S, b)
    assert F._X.device.type == "cuda"
    for g, c in zip(got, cpu):
        assert rel(g, c) < TOL


@pytest.mark.cuda
def test_tile_batch_on_card_matches_cpu(cuda):
    S, _ = chip_smoke.stiffness_standin(4, 150, 2000, band=20)
    tile = TileCholesky(tile_pattern_from_sparse(S, 32), 150, 32)
    K = torch.from_numpy(S.toarray())[None] * torch.linspace(
        1.0, 2.0, 4, dtype=torch.float64)[:, None, None]
    b = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 150)))
    xs = []
    for dev in (cuda, torch.device("cpu")):
        X = tile.factor(tile.tiles_from_dense(K.to(dev)))
        xs.append(tile.solve(X, b.to(dev)).cpu().numpy())
    assert rel(xs[0], xs[1]) < TOL
    r = torch.einsum("bij,bj->bi", K, torch.from_numpy(xs[0])) - b
    assert float(r.norm() / b.norm()) < 1e-8
