"""Compute kernels for the hot path, hand-written CUDA for Hopper with a
plain PyTorch version beside each: batched block Cholesky with
diagonal-block inverses (K1) and the triangular solves against it (K2,
K3) in ops/chol_ls.py, the L-only batched Cholesky (K4) in ops/chol.py,
the f64 Cholesky solve (K5) in ops/chol_solve64.py, the f64 Cholesky
factor (K6) in ops/chol64.py and chol2's f64 scaled Gram product (K7) in
ops/gram64.py.  ops/ipm_chol.py routes the KKT strategies' products,
factors and solves to them; ops/_build.py builds and loads
the library and counts every launch (LAUNCHES per kernel, LAUNCH_SHAPES
per (kernel, n, k), reset_launches() zeroes both)."""

import torch

from ._build import LAUNCH_SHAPES, LAUNCHES, reset_launches  # noqa: F401
from .chol import batched_cholesky, cholesky_kernel_available  # noqa: F401
from .chol_ls import (batched_cholesky_ls, chol_solve_ls,  # noqa: F401
                      cholesky_ls_available, tri_solve_ls)


def _use_ls(A):
    return A.ndim == 3 and A.dtype == torch.float32


def best_cholesky(A):
    """Batched lower Cholesky: kernel K1 for a batch of f32 matrices
    (its plain version on the CPU), torch.linalg otherwise."""
    if _use_ls(A):
        return batched_cholesky_ls(A)[0]
    return torch.linalg.cholesky(A)


def best_chol_factor_solve(A):
    """(factor, solve) pair for batched SPD systems: factor(A) returns an
    opaque factor object; solve(f, rhs) solves A x = rhs for rhs of shape
    (B,n) or (B,n,k).  K1 + K2 for f32 batches, torch.linalg otherwise."""
    if _use_ls(A):
        L, Dinv = batched_cholesky_ls(A)
        return (L, Dinv), lambda f, r: chol_solve_ls(f[0], f[1], r)
    L = torch.linalg.cholesky(A)

    def solve(L, rhs):
        r3 = rhs[..., None] if rhs.ndim == L.ndim - 1 else rhs
        x = torch.cholesky_solve(r3, L)
        return x[..., 0] if rhs.ndim == L.ndim - 1 else x
    return L, solve
