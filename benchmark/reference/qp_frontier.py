"""Plain reference for dense convex QPs over the nonnegative orthant whose
lanes may share their P, G, h, A and b: qp_orthant.py's textbook IPM
and judge, given every operand with the batch first.

A shared operand (one instance's P (n, n), G (m, n), h (m,), A (p, n)
or b (p,)) is cast to the solve's dtype once and handed on as a view of
the batch's lanes that repeats it with a stride of 0, so it is never
copied per lane here; the lanes' q (B, n) sets the batch.  Like
qp_orthant.py it shares no code with the package under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import qp_orthant

KEYS = ("P", "q", "G", "h", "A", "b")
RANKS = {"P": 2, "q": 1, "G": 2, "h": 1, "A": 2, "b": 1}


def lanes(data, dtype=None):
    """data's operands in `dtype` (as they are where None), each with the
    batch first: a shared operand as a stride-0 view over q's lanes."""
    B = data["q"].shape[0]
    out = {}
    for k in KEYS:
        v = data[k] if dtype is None else data[k].to(dtype)
        out[k] = v.expand(B, *v.shape) if v.ndim == RANKS[k] else v
    return out


def solve(P, q, G, h, A, b, tol=None, maxiters=100, dtype=torch.float64):
    """qp_orthant.solve on operands batched or shared by the lanes."""
    d = lanes(dict(P=P, q=q, G=G, h=h, A=A, b=b), dtype)
    return qp_orthant.solve(**d, tol=tol, maxiters=maxiters, dtype=dtype)


def judge(data, out, tol):
    """qp_orthant.judge on operands batched or shared by the lanes."""
    return qp_orthant.judge(lanes(data, torch.float64), out, tol)
