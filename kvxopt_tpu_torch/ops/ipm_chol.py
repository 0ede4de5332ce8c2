"""The route of the IPM KKT strategies' dense SPD factor and solves: which
kernel runs, from the device, the dtype, the batch B, the order n and the
right-hand sides k.  kkt.py calls these and names no kernel.

Counterpart of kvxopt_tpu/ops/ipm_chol.py.  The JAX package needed
custom_vmap to collapse a vmapped scalar factorization into one
lockstep kernel call; here the batch dimension is explicit, so these are
plain batched functions.

A factor is the pair (L, Dinv).  For f32, L is (B,n,n) and Dinv
(B,nb,128,128) the inverses of L's 128-wide diagonal blocks, the layout
the JAX custom_vmap rules return; for f64, L is (..., n, n) and Dinv is
None, since nothing reads f64 block inverses.  Which kernel runs where:

- f32 factor and solves: K1, K2 and K3 (ops/chol_ls.py) for a CUDA
  tensor, the plain versions for a CPU tensor.  Unlike the JAX package,
  whose _pallas_ok leaves f32 factors below n = 256 to XLA on the TPU,
  there is no size threshold: the kernels run at every n on the card.  On
  an NVIDIA H100 80GB HBM3 at 700 W (phase 18(c) of chip_smoke.py, B =
  16, host medians of 20), K1 + K2 (k = 1) + K3 (k = n) took 0.1135 ms
  at n = 8 against 0.1470 for cholesky_ex + cholesky_solve +
  solve_triangular, 0.0982 against 0.1580 at n = 32 and 0.2173 against
  0.7004 at n = 256: the kernels win at every n from 8 to 256.
- f64 factor: K6 (ops/chol64.py) where k6_route takes the shape, else
  cholesky_nan (cuSOLVER on the card).
- f64 solve: K5 (ops/chol_solve64.py) where k5_route takes the shape,
  else the two triangular solves of chol_ls.chol_solve_ls_ref.
- chol2's K = C0 + G' diag(d)^-2 G + reg I on an orthant: K7
  (ops/gram64.py) where k7_route takes the shape; else kkt forms the
  scaled G and its product itself.
- f64 triangular solves: torch.linalg.solve_triangular.
"""

from __future__ import annotations

import torch

from . import chol_ls
from .chol64 import cholesky64, k6_fits
from .chol_ls import cholesky_nan
from .chol_solve64 import chol_solve64, k5_fits
from .gram64 import gram64, k7_fits

# The largest order that K6 takes alone (B = 1).  A single factor is one
# lane's chain of diagonal tiles for K6, while cuSOLVER's unbatched potrf
# spreads it over the whole card.  On an H100 (K6 / cholesky_nan, ms, by
# CUDA events; host wall with a sync in brackets) K6 is ahead by both
# measures up to n = 128 (0.052 / 0.077; 0.074 / 0.085), level at 192
# and 256 (0.115 / 0.119; 0.166 / 0.156) and behind from 384 on (1010:
# 0.87 / 0.49).  From B = 2 on cuSOLVER takes its batched potrf and K6 is
# ahead at every n measured (11 to 4000; 1010: 0.90 / 1.50).
K6_ALONE_MAX_N = 128

# Right-hand sides up to which an f64 factor on the card is solved by
# kernel K5, which reads L once per 8 columns; a wider solve keeps the two
# triangular solves of the plain version.  The crossover, on an H100 at
# B = 32 and n = 1010: K5 1.18 ms against 1.79 at k = 64, 2.30 against
# 1.95 at k = 128 (at B = 1 K5 is faster at both).
K5_MAX_K = 64


def k6_route(device, dtype, B, n):
    """Whether B float64 factors of order n go to kernel K6: on a CUDA
    device, with an n that K6 takes, and with B >= 2 or n <= K6_ALONE_MAX_N;
    else the plain version, cholesky_nan."""
    return (device.type == "cuda" and dtype == torch.float64 and k6_fits(n)
            and (B >= 2 or n <= K6_ALONE_MAX_N))


def k5_route(device, dtype, n, k):
    """Whether the Cholesky solve of an f64 factor of order n with k
    right-hand sides goes to K5: on a CUDA device, k <= K5_MAX_K and an n
    that K5's shared memory holds; else the two solve_triangular calls of
    the plain version."""
    return (device.type == "cuda" and dtype == torch.float64
            and k <= K5_MAX_K and k5_fits(n))


def k7_route(device, dtype, m, n):
    """Whether chol2's K over an orthant's m scaled rows, of order n, is
    built by K7 from G and d (the scaled G never formed): on a CUDA
    device, float64, with an m and n that K7 takes, whatever the batch.
    On an H100 at m = 1000, n = 1010 (device ms, K7 / the formed scaled G
    with its GEMM and passes): B = 100 2.81 / 6.37, B = 32 0.95 / 2.50,
    and B = 1 0.071 / 0.072 on the device and 0.12 / 0.20 host time a
    call, so a single product goes to K7 too."""
    return (device.type == "cuda" and dtype == torch.float64
            and k7_fits(m, n))


def scaled_gram(C0, G, d, reg):
    """K = C0 + G' diag(d)^-2 G + reg I, C0 None, (n, n) or (B, n, n):
    K7 on the card, its plain version on the CPU.  On the card only K's
    lower triangle and diagonal tiles are written, as chol_factor reads
    them."""
    return gram64(C0, G, d, reg)


def _kernel_dtype(L, rhs):
    return L.dtype == torch.float32 and rhs.dtype == torch.float32


def chol_factor(K):
    """Factor a batch of SPD matrices; returns (L, Dinv).  A lane that is
    not positive definite gives NaN in L."""
    if K.dtype == torch.float32:
        L, Di = chol_ls.batched_cholesky_ls(K)
        return L, Di.transpose(0, 1)
    n = K.shape[-1]
    B = K.numel() // (n * n) if n else 0
    if k6_route(K.device, K.dtype, B, n):
        return cholesky64(K), None
    return cholesky_nan(K), None


def chol_solve(L, Dinv, rhs):
    """Solve L L' x = rhs; rhs (B,n) or (B,n,k)."""
    if _kernel_dtype(L, rhs):
        return chol_ls.chol_solve_ls(L, Dinv.transpose(0, 1), rhs)
    k = 1 if rhs.ndim == L.ndim - 1 else rhs.shape[-1]
    if k5_route(L.device, L.dtype, L.shape[-1], k):
        return chol_solve64(L, rhs)
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
