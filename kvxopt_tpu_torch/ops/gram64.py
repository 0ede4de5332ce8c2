"""Batched float64 scaled Gram product K = C0 + G' diag(d)^-2 G + reg I:
CUDA kernel K7.  Its plain version, gram64_ref, is the arithmetic of
chol2's K on an orthant without the kernel: Gs = G / d, C0 + Gs' Gs, then
reg on the diagonal.

K7 (csrc/gram64.cu, built by ops/_build.py) replaces no Pallas kernel:
the JAX package forms chol2's K with XLA.  It takes that product on the
card (ops/ipm_chol.py routes it) from the scaled G written out for every
lane, cuBLAS's GEMM of both triangles and the passes around them; the
kernel's source note says what bounds it and what its design does about
that.

The contract: G (m, n) shared by the lanes or (B, m, n), read in place; d
(B, m), the l-cone scaling's diagonal, so that the weight of row i is
1 / d_i^2; C0 None, (n, n) shared or (B, n, n); reg a number; all
float64.  Returns K (B, n, n).  On the card K7 writes K's lower triangle
and its diagonal tiles, and leaves the rest of the upper triangle
unwritten: kkt's factor reads the lower triangle alone.  A tensor on the
CPU goes to the plain version, which forms the whole matrix; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ._build import _lib, _on_cpu, _raise_on, _sm_count, _stream, count_launch

# The largest n K7 takes (it indexes a lane's K with n * n < 2**31, and
# its G with m (n + 1) < 2**31), and its CTAs of tile order 128 and 64
# that an SM holds at once (by their shared memory: 199 and 103 KiB of
# 227).
K7_MAX_N = 46340
_PER_SM = {128: 1, 64: 2}


def gram64_ref(C0, G, d, reg=0.0):
    """Plain version of K7: Gs = G / d formed, then C0 + Gs' Gs and reg
    on the diagonal, the whole matrix."""
    Gs = G / d[..., :, None]
    K = Gs.mT @ Gs
    if C0 is not None:
        K = C0 + K
    if reg:
        K = K + reg * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K


def k7_fits(m, n):
    """Whether K7 takes a G of m rows and n columns."""
    return 1 <= n <= K7_MAX_N and 1 <= m and m * (n + 1) < 2 ** 31


@functools.lru_cache(maxsize=None)
def k7_plan(B, n, sms):
    """K7's tile order for B lanes of order n on a card of sms SMs: 128,
    unless the card's share of work in 64-tiles is less than 0.8 times
    that in 128-tiles (a small batch, whose few 128-tiles leave SMs
    idle).  Each counts the waves of CTAs the card holds at once times a
    CTA's work; the 0.8 is for the twice as many G panel reads of
    64-tiles."""
    def waves(T):
        nt = -(-n // T)
        tiles = B * nt * (nt + 1) // 2
        per = _PER_SM[T]
        return -(-tiles // (sms * per)) * per * T * T
    return 64 if waves(64) < 0.8 * waves(128) else 128


def _rows16(G):
    """G with rows that the kernel's bulk copies take: an even row
    stride and a 16-byte aligned start; a copy with a zero column where
    n is odd or G's start is not aligned."""
    n = G.shape[-1]
    if n % 2 == 0 and G.data_ptr() % 16 == 0:
        return G
    Gp = G.new_zeros(G.shape[:-1] + (n + n % 2,))
    Gp[..., :n] = G
    return Gp


@functools.lru_cache(maxsize=None)
def _zeros(index):
    """A row of 128 zeros on card `index`: the source of G's rows past m."""
    return torch.zeros(128, dtype=torch.float64, device=f"cuda:{index}")


def gram64(C0, G, d, reg=0.0):
    """K = C0 + G' diag(d)^-2 G + reg I for every lane, float64 (the
    module's contract), at the tile order k7_plan picks."""
    ts = [x for x in (C0, G, d) if x is not None]
    if _on_cpu(*ts):
        return gram64_ref(C0, G, d, reg)
    for name, x in (("C0", C0), ("G", G), ("d", d)):
        if x is not None and x.dtype != torch.float64:
            raise TypeError(f"{name}: kernel takes float64, got {x.dtype}")
    if d.ndim != 2 or G.ndim not in (2, 3):
        raise ValueError(f"d (B, m) and G (m, n) or (B, m, n) expected, got "
                         f"{tuple(d.shape)} and {tuple(G.shape)}")
    B, m = d.shape
    n = G.shape[-1]
    G = G.contiguous()
    if G.shape[-2] != m or (G.ndim == 3 and G.shape[0] != B):
        raise ValueError(f"G {tuple(G.shape)} does not match d "
                         f"{tuple(d.shape)}")
    if C0 is not None:
        C0 = C0.contiguous()
        if C0.shape[-2:] != (n, n) or C0.ndim not in (2, 3) or (
                C0.ndim == 3 and C0.shape[0] != B):
            raise ValueError(f"C0 {tuple(C0.shape)}: expected ({n}, {n}) or "
                             f"({B}, {n}, {n})")
    if not k7_fits(m, n):
        raise ValueError(f"gram64: m = {m}, n = {n} beyond K7's order")
    d = d.contiguous()
    K = torch.empty((B, n, n), dtype=torch.float64, device=G.device)
    if B == 0:
        return K
    G = _rows16(G)
    ldg = G.shape[-1]
    index = G.device.index
    T = k7_plan(B, n, _sm_count(index))
    rc = _lib().kvx_gram64(
        G.data_ptr(), 0 if G.ndim == 2 else m * ldg, ldg, d.data_ptr(),
        _zeros(index).data_ptr(), None if C0 is None else C0.data_ptr(),
        0 if C0 is None or C0.ndim == 2 else n * n, float(reg),
        K.data_ptr(), B, m, n, T, _stream())
    _raise_on(rc, "gram64")
    count_launch("K7", n)
    return K
