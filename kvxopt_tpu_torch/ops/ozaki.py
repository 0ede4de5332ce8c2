"""Ozaki-style exact-split products: f64-accurate results from f32 matmuls.

Counterpart of kvxopt_tpu/ops/ozaki.py (Ozaki et al. 2012, "Error-free
transformations of matrix multiplication").  Each f64 operand is scaled
per contraction fiber by a power of two and cut into `nslices` chunks of
`nbits` mantissa bits; chunk products then sum exactly in f32, because
nbits = floor((24 - log2 n) / 2) keeps every partial sum below 2^24
quanta.  The f32 products are plain `torch.matmul` with TF32 off
(config.py), so the result does not depend on the summation order.
Leading batch dimensions broadcast through every function.
"""

from __future__ import annotations

import math

import torch


def default_nbits(n: int) -> int:
    """Largest chunk width (<= 8) such that a length-n sum of chunk
    products cannot round in f32."""
    return max(1, min(8, (24 - int(math.ceil(math.log2(max(n, 2))))) // 2))


def default_nslices(nbits: int, target_bits: int = 52) -> int:
    """Slices needed to cover `target_bits` of each operand's mantissa."""
    return int(math.ceil(target_bits / nbits))


def split_fp(A, nslices: int, nbits: int):
    """Error-free block-fixed-point split along the LAST axis.

    Returns (S, scale): S of shape (nslices,) + A.shape in f32, S[k]
    holding mantissa bits [nbits*k, nbits*(k+1)) of A / scale; scale is a
    power of two per contraction fiber, shape A.shape[:-1] + (1,)."""
    A = A.to(torch.float64)
    a = torch.amax(torch.abs(A), dim=-1, keepdim=True)
    pos = a > 0
    e = torch.where(pos, torch.ceil(torch.log2(torch.where(
        pos, a, torch.ones_like(a)))), torch.zeros_like(a))
    scale = torch.exp2(e)
    r = A / scale
    slices = []
    for k in range(nslices):
        sh = 2.0 ** (nbits * (k + 1))
        c = torch.round(r * sh) / sh
        slices.append(c.to(torch.float32))
        r = r - c
    return torch.stack(slices), scale


def matmat(Aslices, Ascale, X, nbits: int):
    """Y = A @ X to ~f64 accuracy, A given pre-split by split_fp, for k
    right-hand sides at once: each column of X is split on its own (as a
    vmap of matvec over columns splits it), and the column slices ride
    one f32 matmul per A slice.

    Aslices: (s, ..., m, n) f32; Ascale: (..., m, 1) f64; X: (..., n, k)
    f64.  Returns (..., m, k) f64."""
    ns = Aslices.shape[0]
    n, k = X.shape[-2], X.shape[-1]
    S, xscale = split_fp(torch.swapaxes(X, -1, -2), ns, nbits)
    # (ns, ..., k, n) -> (..., n, k * ns)
    Xs = torch.movedim(S, 0, -1).transpose(-3, -2).reshape(
        X.shape[:-2] + (n, k * ns))
    acc = None
    for j in range(ns):
        Pj = torch.matmul(Aslices[j], Xs)             # (..., m, k*ns) f32
        term = torch.sum(Pj.to(torch.float64).unflatten(-1, (k, ns)),
                         dim=-1)
        acc = term if acc is None else acc + term
    return acc * Ascale * torch.swapaxes(xscale, -1, -2)


def matvec(Aslices, Ascale, x, nbits: int):
    """y = A @ x to ~f64 accuracy: matmat with one right-hand side.

    Aslices: (s, ..., m, n) f32; Ascale: (..., m, 1) f64; x: (..., n)
    f64.  Returns (..., m) f64."""
    return matmat(Aslices, Ascale, x[..., None], nbits)[..., 0]


def ata(A, nbits: int | None = None, target_bits: int = 40):
    """Exact-split Gram matrix A' A to ~`target_bits` of f64 accuracy,
    keeping the slice pairs with i + j < nslices."""
    A = A.to(torch.float64)
    k = A.shape[-2]
    nbits = nbits or default_nbits(k)
    ns = default_nslices(nbits, target_bits)
    S, scale = split_fp(torch.swapaxes(A, -1, -2), ns, nbits)
    out = None
    for i in range(ns):
        for j in range(ns - i):
            P = torch.matmul(S[i], torch.swapaxes(S[j], -1, -2))
            term = P.to(torch.float64)
            out = term if out is None else out + term
    return out * scale * torch.swapaxes(scale, -1, -2)


class OzakiOperator:
    """Pre-split form of a dense f64 matrix (batched) for repeated
    y = A x and z = A' w products at f64 accuracy from f32 matmuls."""

    def __init__(self, A, nslices: int | None = None,
                 nbits: int | None = None):
        A = A.to(torch.float64)
        m, n = A.shape[-2], A.shape[-1]
        self.nbits = nbits or min(default_nbits(n), default_nbits(m))
        self.nslices = nslices or default_nslices(self.nbits)
        self.S, self.scale = split_fp(A, self.nslices, self.nbits)
        At = torch.swapaxes(A, -1, -2)
        self.St, self.scalet = split_fp(At, self.nslices, self.nbits)

    def mv(self, x):
        return matvec(self.S, self.scale, x, self.nbits)

    def rmv(self, w):
        return matvec(self.St, self.scalet, w, self.nbits)

    def normal_mv(self, x):
        """x -> A' A x."""
        return self.rmv(self.mv(x))

    def mm(self, X):
        """A X for X (..., n, k)."""
        return matmat(self.S, self.scale, X, self.nbits)

    def normal_mm(self, X):
        """X -> A' A X for X (..., n, k)."""
        return matmat(self.St, self.scalet, self.mm(X), self.nbits)


def gram_matvec_fn(A, nslices=None, nbits=None):
    """f(x) = A' A x at f64 accuracy via two exact-split matvecs."""
    return OzakiOperator(A, nslices, nbits).normal_mv
