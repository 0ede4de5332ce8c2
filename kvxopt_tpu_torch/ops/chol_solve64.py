"""Batched float64 Cholesky solve L L' X = R: CUDA kernel K5.  Its plain
version is chol_ls.chol_solve_ls_ref, two triangular solves.

K5 (csrc/chol_solve64.cu, built by ops/_build.py) replaces no Pallas
kernel: the JAX package leaves its f64 solves to XLA.  It takes the f64
solves of the KKT strategies (ops/ipm_chol.py routes them) from cuBLAS's
batched trsm, which ran them at ~20 times the time of their bytes; its
source note says what bounds it and what its design does about that.

The contract: L (B, n, n) float64 lower factors, each matrix row-major or
column-major (torch.linalg.cholesky's on the card) with the batch
contiguous, read in place (the upper triangle is never read); rhs (B, n)
or (B, n, k) float64, read in place with its own strides; X returned in
rhs's shape, contiguous.  A NaN factor gives NaN in its lane only.  A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ._build import (_lib, _on_cpu, _raise_on, _sm_count, _stream,
                     count_launch)
from .chol_ls import _as3, chol_solve_ls_ref

# Rows of a diagonal block, warps of a CTA, doubles per row of a ring
# stage, and a CTA's shared memory on sm_90: the kernel's constants
# (csrc/chol_solve64.cu), from which the launch plan is made.
_T, _NW, _LDT, _SMEM_MAX = 32, 4, 34, 232448


def k5_smem(nb, C, kb, S):
    """K5's shared memory in bytes for nb 32-row blocks, clusters of C
    CTAs, kb columns and S ring stages (csrc/chol_solve64.cu k5_smem)."""
    P = C * _NW
    own = -(-nb // P)
    return 16 * nb + 8 * ((P + 3) * _T * kb +
                          _NW * (S * _T * _LDT + own * _T * kb))


@functools.lru_cache(maxsize=None)
def k5_plan(B, n, k, sms):
    """K5's launch shape (kb, C, S) for B factors of order n, k right-hand
    sides and sms SMs, or None where no shape fits shared memory (n
    beyond about 78,800, whatever B and k).  kb columns of X per cluster,
    a power of two up to 8 (a diagonal block's solve is serial in its
    columns, so k > 8 takes ceil(k / kb) clusters per lane); C CTAs of 4
    warps per cluster, doubled while every warp owns a block and the
    clusters fit the SMs; S ring stages per warp, as many as shared
    memory holds up to 8 and no more than a call's tiles.  Where fewer
    than 3 stages fit, C doubles on up to 8 (more CTAs share a lane's
    accumulators, and the clusters run in waves), then halves below its
    first value (fewer receive slots), then kb halves."""
    nb = -(-n // _T)
    want = min(8, nb * (nb + 1) + 1)
    kb = min(8, 1 << (k - 1).bit_length())
    while kb:
        nct = -(-k // kb)
        C = 1
        while C < 8 and 2 * C * _NW <= nb and 2 * C * B * nct <= sms:
            C *= 2
        more = [c for c in (2, 4, 8) if c > C and c * _NW <= nb]
        fewer = [c for c in (4, 2, 1) if c < C]
        for c in [C] + more + fewer:
            S = min(want, (_SMEM_MAX - k5_smem(nb, c, kb, 0))
                    // (8 * _NW * _T * _LDT))
            if S >= 3:
                return kb, c, S
        kb //= 2
    return None


def k5_fits(n):
    """Whether K5 takes factors of order n: whether a launch plan fits
    shared memory, which depends on n alone (B and k only choose among
    the plans)."""
    return k5_plan(1, n, 1, 0) is not None


def _check64(t, name):
    if t.dtype != torch.float64:
        raise TypeError(f"{name}: kernel takes float64, got {t.dtype}")


def chol_solve64(L, rhs):
    """Solve L L' X = rhs for lower factors L (B, n, n) float64 and rhs
    (B, n) or (B, n, k); returns X in rhs's shape.

    On the card, kernel K5 runs both sweeps in one launch, reads rhs in
    place and writes X (B, n, k) directly."""
    if _on_cpu(L, rhs):
        return chol_solve_ls_ref(L, None, rhs)
    _check64(L, "L")
    _check64(rhs, "rhs")
    if L.ndim != 3 or L.shape[1] != L.shape[2]:
        raise ValueError(f"L: expected (B, n, n), got {tuple(L.shape)}")
    cm = not L.is_contiguous()
    if cm and not L.mT.is_contiguous():
        raise ValueError("L: kernel takes a contiguous tensor or the "
                         "transpose of one")
    r3, vec = _as3(rhs)
    if r3.ndim != 3 or r3.shape[:2] != L.shape[:2]:
        raise ValueError(f"rhs shape {tuple(rhs.shape)} does not match L "
                         f"{tuple(L.shape)}")
    B, n, k = r3.shape
    X = torch.empty((B, n, k), dtype=L.dtype, device=L.device)
    if X.numel():
        plan = k5_plan(B, n, k, _sm_count(L.device.index))
        if plan is None:
            raise ValueError(f"chol_solve64: n = {n} exceeds what K5's "
                             "shared memory holds")
        kb, C, S = plan
        rc = _lib().kvx_chol_solve64(L.data_ptr(), r3.data_ptr(),
                                     X.data_ptr(), B, n, k, *r3.stride(),
                                     int(cm), kb, C, S, _stream())
        _raise_on(rc, "chol_solve64")
        count_launch("K5", n, k)
    return X[:, :, 0] if vec else X
