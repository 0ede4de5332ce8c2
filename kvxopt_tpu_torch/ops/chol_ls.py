"""Batched blocked Cholesky with diagonal-block inverses, and the
triangular solves against it: CUDA kernels K1, K2, K3 and their plain
PyTorch versions.

Counterpart of kvxopt_tpu/ops/chol_ls.py.  K1 lives in csrc/chol_ls.cu,
K2 in csrc/chol_solve.cu, K3 in csrc/tri_solve.cu (built by
ops/_build.py); their source notes say which Pallas function each
replaces and what bounds it on the card.

Every wrapper keeps the JAX function's contract: f32 tensors, the factor
returned as (tril(L) (B,n,n), Dinv (nb,B,128,128)) with nb = ceil(n/128)
and identity on the padded diagonal of the last Dinv block.  A tensor on
the CPU goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""

from __future__ import annotations

import torch

from ._build import _lib, _on_cpu, _raise_on, _sm_count, _stream, count_launch

BS = 128

# Which of K1/K4's two launch paths runs where n > 128: None (the rule in
# _factor_path), or 0 (one cluster launch) / 1 (one launch per panel
# step).  Not a tuning option: only a hook by which a test forces a path.
_FACTOR_PATH = None

# Shared memory, in bytes, that one CTA of K2 may use to keep the solved
# part of its tile; where it needs more, that part goes through X in
# device memory instead.  Its value is the card's own limit per CTA (227
# KB on an H100), which the kernel also applies: this is not a tuning
# option, only a hook by which a test sets 0 to force the device-memory
# path.
_K2_SMEM_BYTES = 227 * 1024


def cholesky_ls_available():
    """True where kernels K1-K3 can run: a CUDA device is present."""
    return torch.cuda.is_available()


def _check(t, name, ndim):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")


def _pad_identity(A, npad):
    """(B,n,n) -> (B,npad,npad) with identity on the padded diagonal."""
    B, n, _ = A.shape
    if npad == n:
        return A.clone()
    Ap = torch.zeros((B, npad, npad), dtype=A.dtype, device=A.device)
    Ap[:, :n, :n] = A
    idx = torch.arange(n, npad, device=A.device)
    Ap[:, idx, idx] = 1.0
    return Ap


def cholesky_nan(K):
    """Lower Cholesky factor, NaN for a matrix that is not positive
    definite (jnp.linalg.cholesky's convention, which the IPM turns into
    status SINGULAR)."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def block_inverses(L):
    """Inverses of the 128x128 diagonal blocks of lower-triangular
    (B,n,n) factors, padded with identity -> (B,nb,128,128)."""
    B, n, _ = L.shape
    nb = -(-n // BS)
    Lp = L if nb * BS == n else _pad_identity(L, nb * BS)
    blocks = torch.stack([Lp[:, k * BS:(k + 1) * BS, k * BS:(k + 1) * BS]
                          for k in range(nb)], dim=1)
    eye = torch.eye(BS, dtype=L.dtype, device=L.device).expand_as(blocks)
    return torch.linalg.solve_triangular(blocks, eye, upper=False)


# ---------------------------------------------------------------------------
# K1: factor
# ---------------------------------------------------------------------------

def batched_cholesky_ls_ref(A):
    """Plain version of K1: cholesky_ex on the padded matrices, then the
    diagonal-block inverses by triangular solves."""
    B, n, _ = A.shape
    nb = -(-n // BS)
    Lp = cholesky_nan(_pad_identity(A, nb * BS))
    Dinv = block_inverses(Lp).transpose(0, 1).contiguous()
    return Lp[:, :n, :n].contiguous(), Dinv


def _check_square(A):
    _check(A, "A", 3)
    B, n, n2 = A.shape
    if n != n2:
        raise ValueError(f"A: expected square matrices, got {tuple(A.shape)}")
    return B, n


def _factor_path(B, n, device):
    """K1/K4's launch path for n > 128: 0, one launch of a cluster of 8
    (or 4) CTAs per matrix, where the chain of diagonal blocks bounds the
    factorization (n <= 512) and the clusters of 4 are all resident at
    once; else 1, one launch per panel step with the grid over tiles."""
    if _FACTOR_PATH is not None:
        return _FACTOR_PATH
    return 0 if n <= 512 and 4 * B <= _sm_count(device.index) else 1


def batched_cholesky_ls(A):
    """Lower Cholesky factors of a batch of SPD matrices (B,n,n) f32 and
    the inverses of their 128-wide diagonal blocks (nb,B,128,128).

    On the card, kernel K1 reads A in place (its lower triangle only) and
    writes L, zeros above the diagonal included, and Dinv directly: a call
    is two torch.empty and one launch, where n <= 128 or the cluster path
    runs (n <= 512), else three per 128-wide panel step."""
    if _on_cpu(A):
        return batched_cholesky_ls_ref(A)
    B, n = _check_square(A)
    L = torch.empty_like(A)
    Dinv = torch.empty((-(-n // BS), B, BS, BS), dtype=A.dtype,
                       device=A.device)
    rc = _lib().kvx_chol_ls(A.data_ptr(), L.data_ptr(), Dinv.data_ptr(), B,
                            n, _factor_path(B, n, A.device), _stream())
    _raise_on(rc, "batched_cholesky_ls")
    count_launch("K1", n)
    return L, Dinv


# ---------------------------------------------------------------------------
# K2 / K3: triangular solves
# ---------------------------------------------------------------------------

def _as3(rhs):
    return (rhs[:, :, None], True) if rhs.ndim == 2 else (rhs, False)


def chol_solve_ls_ref(L, Dinv, rhs):
    """Plain version of K2: two triangular solves."""
    r3, vec = _as3(rhs)
    y = torch.linalg.solve_triangular(L, r3, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[:, :, 0] if vec else x


def tri_solve_ls_ref(L, Dinv, rhs, trans=False):
    """Plain version of K3: L X = rhs, or L' X = rhs when trans."""
    r3, vec = _as3(rhs)
    if trans:
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), r3,
                                          upper=True)
    else:
        x = torch.linalg.solve_triangular(L, r3, upper=False)
    return x[:, :, 0] if vec else x


def _check_factor(L, Dinv):
    _check(L, "L", 3)
    _check(Dinv, "Dinv", 4)
    B, n, _ = L.shape
    nb = Dinv.shape[0]
    if Dinv.shape != (nb, B, BS, BS) or nb != -(-n // BS):
        raise ValueError(f"Dinv shape {tuple(Dinv.shape)} does not match "
                         f"L {tuple(L.shape)}")


def _solve_args(L, Dinv, rhs):
    """Checks shared by K2 and K3: (R as (B,n,k) with unit column stride,
    whether rhs was (B,n), the output X (B,n,k)).  R is read in place; a
    view whose columns are not contiguous is copied once."""
    _check_factor(L, Dinv)
    if rhs.dtype != torch.float32:
        raise TypeError(f"rhs: kernel takes float32, got {rhs.dtype}")
    r3, vec = _as3(rhs)
    if r3.shape[:2] != L.shape[:2]:
        raise ValueError(f"rhs shape {tuple(rhs.shape)} does not match L")
    B, n, k = r3.shape
    if k > 1 and r3.stride(2) != 1:
        r3 = r3.contiguous()
    return r3, vec, torch.empty((B, n, k), dtype=L.dtype, device=L.device)


def chol_solve_ls(L, Dinv, rhs):
    """Solve L L' X = rhs given batched_cholesky_ls output; rhs (B,n) or
    (B,n,k), returns the same shape.

    On the card, kernel K2 runs both sweeps in one launch, reads rhs in
    place and writes X (B,n,k) directly; rows of L beyond n act as the
    identity, so L is not padded."""
    if _on_cpu(L, Dinv, rhs):
        return chol_solve_ls_ref(L, Dinv, rhs)
    r3, vec, X = _solve_args(L, Dinv, rhs)
    B, n, k = r3.shape
    rc = _lib().kvx_chol_solve(L.data_ptr(), Dinv.data_ptr(), r3.data_ptr(),
                               X.data_ptr(), B, n, k, r3.stride(0),
                               r3.stride(1), _K2_SMEM_BYTES, _stream())
    _raise_on(rc, "chol_solve_ls")
    count_launch("K2", n, k)
    return X[:, :, 0] if vec else X


def _tri_kc(B, k, device):
    """K3's columns per CTA: 64, or 32 where 64 would leave more than half
    of the SMs without a CTA."""
    return 64 if 2 * B * -(-k // 64) >= _sm_count(device.index) else 32


def tri_solve_ls(L, Dinv, rhs, trans=False):
    """Solve L X = rhs (trans=False) or L' X = rhs (trans=True) given
    batched_cholesky_ls output, for rhs (B,n) or (B,n,k).

    On the card, kernel K3 reads rhs in place (a view whose columns are
    not contiguous is copied once) and writes X (B,n,k) directly; rows of
    L beyond n act as the identity, so L is not padded."""
    if _on_cpu(L, Dinv, rhs):
        return tri_solve_ls_ref(L, Dinv, rhs, trans)
    r3, vec, X = _solve_args(L, Dinv, rhs)
    B, n, k = r3.shape
    rc = _lib().kvx_tri(L.data_ptr(), Dinv.data_ptr(), r3.data_ptr(),
                        X.data_ptr(), B, n, k, r3.stride(0), r3.stride(1),
                        int(trans), _tri_kc(B, k, L.device), _stream())
    _raise_on(rc, "tri_solve_ls")
    count_launch("K3", n, k)
    return X[:, :, 0] if vec else X
