"""Batched blocked Cholesky that returns L only: CUDA kernel K4 and its
plain PyTorch version.

Counterpart of kvxopt_tpu/ops/chol.py.  The kernel lives in csrc/chol.cu
(built by ops/_build.py) and shares K1's diagonal-block, panel and
trailing kernels (csrc/chol_factor.cuh); its own launch path keeps each
panel's diagonal-block inverse in a (B,128,128) scratch and returns no
Dinv.

The wrapper keeps the JAX function's contract: f32 (B,n,n) SPD matrices,
n padded to a multiple of 128 with identity on the padded diagonal, tril
of the factor cropped to n returned.  A matrix that is not positive
definite gives NaN.  A tensor on the CPU goes to the plain version; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from .chol_ls import (BS, _check, _lib, _on_cpu, _pad_identity, _raise_on,
                      _stream, cholesky_nan, count_launch)


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
    """Lower Cholesky factors (B,n,n) of a batch of SPD matrices, f32."""
    if _on_cpu(A):
        return batched_cholesky_ref(A)
    _check(A, "A", 3)
    B, n, n2 = A.shape
    if n != n2:
        raise ValueError(f"A: expected square matrices, got {tuple(A.shape)}")
    npad = -(-n // BS) * BS
    O = _pad_identity(A, npad)
    scratch = torch.empty((B, BS, BS), dtype=A.dtype, device=A.device)
    rc = _lib().kvx_chol(O.data_ptr(), scratch.data_ptr(), B, npad,
                         _stream())
    _raise_on(rc, "batched_cholesky")
    count_launch("K4", n)
    return torch.tril(O[:, :n, :n])
