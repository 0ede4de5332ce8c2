"""Batched float64 Cholesky factor L L' = K: CUDA kernel K6.  Its plain
version is chol_ls.cholesky_nan, torch.linalg.cholesky_ex with a NaN lane
where a pivot fails.

K6 (csrc/chol64.cu, built by ops/_build.py) replaces no Pallas kernel: the
JAX package leaves its f64 factors to XLA.  It takes kkt's f64 factors on
the card (ops/ipm_chol.py routes them) from cuSOLVER's batched potrf and
the passes around it; the kernel's source note says what bounds it and
what its design does about that.

The contract, cholesky_nan's: K (..., n, n) float64 symmetric, its lower
triangle read in place; returns a fresh lower factor (row-major, the
upper triangle zero) in K's shape; a lane that is not positive definite
comes out all NaN.  A tensor on the CPU goes to the plain version; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ._build import _lib, _on_cpu, _raise_on, _stream, count_launch
from .chol_ls import cholesky_nan

# The kernel's tile order, and the largest n it takes: it indexes a lane
# with 32-bit offsets, so n * n < 2**31.
_T = 64
K6_MAX_N = 46340


@functools.lru_cache(maxsize=None)
def k6_plan(B, n, resident):
    """K6's launch shape for B factors of order n on a card that holds
    resident[C - 1] clusters of C CTAs at once (C = 1..8): 0 for one warp
    a lane (n <= 32), else C, the CTAs of the cluster that serves a lane:
    the largest whose B clusters the card holds all at once (so that no
    lane waits for a second wave) with at least two of the lane's 64-row
    blocks a CTA.  None past K6_MAX_N."""
    if n > K6_MAX_N:
        return None
    if n <= 32:
        return 0
    nt = -(-n // _T)
    C = 1
    for c in range(2, 9):
        if 2 * c <= nt and B <= resident[c - 1]:
            C = c
    return C


def k6_fits(n):
    """Whether K6 takes factors of order n."""
    return n <= K6_MAX_N


@functools.lru_cache(maxsize=None)
def resident(index):
    """How many clusters of 1..8 of K6's CTAs card `index` holds at once:
    (clusters of 1, ..., clusters of 8); an H100 SXM holds
    (132, 66, 39, 30, 22, 17, 15, 15)."""
    with torch.cuda.device(index):
        out = tuple(_lib().kvx_chol64_clusters(c) for c in range(1, 9))
    _raise_on(min(min(out), 0), "chol64_clusters")
    return out


def cholesky64(K):
    """Lower Cholesky factors of K (..., n, n) float64, NaN in a lane that
    is not positive definite.

    On the card, kernel K6 reads K's lower triangle in place and writes L,
    its upper triangle zero, in one launch."""
    if _on_cpu(K):
        return cholesky_nan(K)
    if K.dtype != torch.float64:
        raise TypeError(f"K: kernel takes float64, got {K.dtype}")
    if K.ndim < 2 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"K: expected (..., n, n), got {tuple(K.shape)}")
    n = K.shape[-1]
    K3 = K.reshape(-1, n, n).contiguous()
    L = torch.empty_like(K3)
    B = K3.shape[0]
    if L.numel():
        C = k6_plan(B, n, resident(K.device.index))
        if C is None:
            raise ValueError(f"cholesky64: n = {n} exceeds K6's "
                             f"{K6_MAX_N}")
        rc = _lib().kvx_chol64(K3.data_ptr(), L.data_ptr(), B, n, C,
                               _stream())
        _raise_on(rc, "cholesky64")
        count_launch("K6", n)
    return L.reshape(K.shape)
