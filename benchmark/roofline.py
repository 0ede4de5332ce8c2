"""Peaks of the chip and the least work of the KKT factorization.

The arithmetic follows chip_smoke.py's `bound` (bytes over the memory
rate against operations over the peak, the larger bounds the time),
frozen here with the float64 peak in place of the float32 one.  Peaks
are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12      # HBM3
F64_TENSOR_FLOP_S = 67e12  # FP64 tensor core, dense


def bound_s(nbytes, flops):
    """Least seconds for `nbytes` moved and `flops` done: the larger of
    the two over their peaks."""
    return max(nbytes / HBM_BYTES_S, flops / F64_TENSOR_FLOP_S)


def kkt_work(n, m, p):
    """(bytes, flops) of one factorization of the condensed KKT system of
    a dense QP with n variables, m inequality rows and p equality rows:
    m n^2 for P + G'WG (a syrk), n^3/3 for its Cholesky, n^2 p for
    L^-1 A', n p^2 for the Schur complement and p^3/3 for its Cholesky.
    Bytes: P, G and A read once and H written once, in float64."""
    flops = m * n * n + n ** 3 / 3 + n * n * p + n * p * p + p ** 3 / 3
    nbytes = 8 * (n * n + m * n + p * n + n * n)
    return nbytes, flops
