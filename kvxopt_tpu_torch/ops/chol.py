"""Batched blocked Cholesky that returns L only: CUDA kernel K4 and its
plain PyTorch version.

Counterpart of kvxopt_tpu/ops/chol.py.  The kernel lives in csrc/chol.cu
(built by ops/_build.py) and runs K1's factorization (csrc/chol_factor.cuh),
keeping each panel's diagonal-block inverse in a scratch of two (B,128,128)
slots; it returns no Dinv.

The wrapper keeps the JAX function's contract: f32 (B,n,n) SPD matrices
in, the lower factor (B,n,n) out with zeros above the diagonal.  A matrix
that is not positive definite gives NaN.  A tensor on the CPU goes to the
plain version; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from ._build import _lib, _on_cpu, _raise_on, _stream, count_launch
from .chol_ls import (BS, _check_square, _factor_path, _pad_identity,
                      cholesky_nan)


def cholesky_kernel_available():
    """True where kernel K4 can run: a CUDA device is present."""
    return torch.cuda.is_available()


def batched_cholesky_ref(A):
    """Plain version of K4: cholesky_ex on the identity-padded batch, NaN
    where it fails, tril, cropped to n."""
    B, n, _ = A.shape
    Lp = cholesky_nan(_pad_identity(A, -(-n // BS) * BS))
    return torch.tril(Lp[:, :n, :n])


def batched_cholesky(A):
    """Lower Cholesky factors (B,n,n) of a batch of SPD matrices, f32.

    On the card, kernel K4 reads A in place and writes L directly (K1's
    factorization, keeping each diagonal block's inverse in a scratch)."""
    if _on_cpu(A):
        return batched_cholesky_ref(A)
    B, n = _check_square(A)
    L = torch.empty_like(A)
    scratch = torch.empty((2, B, BS, BS), dtype=A.dtype, device=A.device)
    rc = _lib().kvx_chol(A.data_ptr(), L.data_ptr(), scratch.data_ptr(), B,
                         n, _factor_path(B, n, A.device), _stream())
    _raise_on(rc, "batched_cholesky")
    count_launch("K4", n)
    return L
