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


def split_vec(x, nslices: int, nbits: int):
    """Split contraction vectors; returns (Xs, scale) with Xs of shape
    x.shape[:-1] + (x.shape[-1], nslices)."""
    S, scale = split_fp(x, nslices, nbits)
    return torch.movedim(S, 0, -1), scale


def matvec(Aslices, Ascale, x, nbits: int):
    """y = A @ x to ~f64 accuracy, A given pre-split by split_fp.

    Aslices: (s, ..., m, n) f32; Ascale: (..., m, 1) f64; x: (..., n)
    f64.  Returns (..., m) f64."""
    ns = Aslices.shape[0]
    Xs, xscale = split_vec(x, ns, nbits)
    acc = None
    for k in range(ns):
        Pk = torch.matmul(Aslices[k], Xs)                # (..., m, t) f32
        term = torch.sum(Pk.to(torch.float64), dim=-1)
        acc = term if acc is None else acc + term
    return acc * Ascale[..., 0] * xscale


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


def gram_matvec_fn(A, nslices=None, nbits=None):
    """f(x) = A' A x at f64 accuracy via two exact-split matvecs."""
    return OzakiOperator(A, nslices, nbits).normal_mv
