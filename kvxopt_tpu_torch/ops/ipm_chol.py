"""Batched Cholesky factor and solves for the IPM KKT strategies.

Counterpart of kvxopt_tpu/ops/ipm_chol.py.  The JAX package needed
custom_vmap to collapse a vmapped scalar factorization into one
lockstep kernel call; here the batch dimension is explicit, so these are
plain batched functions.

The factor object is (L (B,n,n), Dinv (B,nb,128,128)), the layout the
JAX custom_vmap rules return.  Dispatch: an f32 factor goes to
ops/chol_ls.py, which runs kernel K1/K2/K3 for a CUDA tensor and the
plain version for a CPU tensor; an f64 factor is torch.linalg (the JAX
package likewise left f64 to XLA).  Unlike the JAX package, whose
_pallas_ok leaves f32 factors below n = 256 to XLA on the TPU, there is
no size threshold: the kernels run at every n on the card.  On an NVIDIA
H100 80GB HBM3 at 700 W (phase 18(c) of chip_smoke.py, B = 16, host
medians of 20), K1 + K2 (k = 1) + K3 (k = n) took 0.1135 ms at n = 8
against 0.1470 for cholesky_ex + cholesky_solve + solve_triangular,
0.0982 against 0.1580 at n = 32 and 0.2173 against 0.7004 at n = 256:
the kernels' factor and solves win at every n from 8 to 256.
"""

from __future__ import annotations

import torch

from . import chol_ls
from .chol_ls import block_inverses, cholesky_nan


def _kernel_dtype(*ts):
    return all(t.dtype == torch.float32 for t in ts)


def chol_factor(K):
    """Factor a batch of SPD matrices (B,n,n); returns (L, Dinv)."""
    if _kernel_dtype(K):
        L, Di = chol_ls.batched_cholesky_ls(K)
        return L, Di.transpose(0, 1)
    L = cholesky_nan(K)
    return L, block_inverses(L)


def chol_solve(L, Dinv, rhs):
    """Solve L L' x = rhs; rhs (B,n) or (B,n,k)."""
    if _kernel_dtype(L, rhs):
        return chol_ls.chol_solve_ls(L, Dinv.transpose(0, 1), rhs)
    return chol_ls.chol_solve_ls_ref(L, Dinv, rhs)


def tri_lower_solve(L, Dinv, rhs):
    """L X = rhs."""
    if _kernel_dtype(L, rhs):
        return chol_ls.tri_solve_ls(L, Dinv.transpose(0, 1), rhs)
    return chol_ls.tri_solve_ls_ref(L, Dinv, rhs)


def tri_lower_t_solve(L, Dinv, rhs):
    """L' X = rhs."""
    if _kernel_dtype(L, rhs):
        return chol_ls.tri_solve_ls(L, Dinv.transpose(0, 1), rhs,
                                    trans=True)
    return chol_ls.tri_solve_ls_ref(L, Dinv, rhs, trans=True)
