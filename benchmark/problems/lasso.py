"""The OSQP benchmark suite's Lasso class as dense cone-QP data.

Stellato, Banjac, Goulart, Bemporad and Boyd, "OSQP: an operator
splitting solver for quadratic programs", Math. Prog. Comp. 2020,
appendix (lasso); github.com/osqp/osqp_benchmarks,
problem_classes/lasso.py.

    minimize    y'y + lambda 1't
    subject to  y = A_d x - b_d,  -t <= x <= t

A_d (m x n) has round(density m n) nonzeros at uniformly drawn places,
each N(0, 1); b_d = A_d v + eps with v_i = 0 with probability 1/2, else
N(0, 1/n), and eps ~ N(0, I); lambda = ||A_d' b_d||_inf / 5.  Over the
variable (x, y, t), n + m + n of them, as coneqp data:

    P = blkdiag(0_n, 2 I_m, 0_n),  q = [0; 0; lambda 1]
    G = [[I, 0, -I]; [-I, 0, -I]],  h = 0   (dims {"l": 2n})
    A = [A_d, -I_m, 0],  b = b_d
"""

from __future__ import annotations

import math

import torch


def shapes(cfg):
    """(n_var, m, p) of the coneqp data."""
    n, m = cfg["n"], cfg["m"]
    return n + m + n, 2 * n, m


def make(cfg, gen, batch, device, dtype):
    """`batch` instances drawn from the torch.Generator `gen` (on
    `device`): a dict of P, q, G, h, A, b as in portfolio.make."""
    n, md = cfg["n"], cfg["m"]
    B = batch
    nnz = round(cfg["density"] * md * n)
    kw = {"generator": gen, "device": device}
    order = torch.rand((B, md * n), **kw).argsort(dim=-1)[:, :nnz]
    mask = torch.zeros((B, md * n), device=device, dtype=torch.bool)
    mask.scatter_(1, order, True)
    Ad = (torch.randn((B, md * n), dtype=dtype, **kw) * mask).reshape(
        B, md, n)
    keep = torch.rand((B, n), **kw) < 0.5
    v = torch.randn((B, n), dtype=dtype, **kw) * keep / math.sqrt(n)
    bd = torch.einsum("bmn,bn->bm", Ad, v) + torch.randn(
        (B, md), dtype=dtype, **kw)
    lam = torch.einsum("bmn,bm->bn", Ad, bd).abs().amax(dim=1) / 5.0

    nv, mi, p = shapes(cfg)
    P = torch.zeros((B, nv, nv), dtype=dtype, device=device)
    P[:, n:n + md, n:n + md].diagonal(dim1=-2, dim2=-1).fill_(2.0)
    q = torch.zeros((B, nv), dtype=dtype, device=device)
    q[:, n + md:] = lam[:, None]
    G = torch.zeros((B, mi, nv), dtype=dtype, device=device)
    G[:, :n, :n].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    G[:, n:, :n].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    G[:, :n, n + md:].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    G[:, n:, n + md:].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    h = torch.zeros((B, mi), dtype=dtype, device=device)
    A = torch.zeros((B, p, nv), dtype=dtype, device=device)
    A[:, :, :n] = Ad
    A[:, :, n:n + md].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    return {"P": P, "q": q, "G": G, "h": h, "A": A, "b": bd}


def feasible_point(cfg, data):
    """A strictly feasible point of each instance, (x, s): x = 0,
    y = -b_d, t = 1, so s = (1, 1)."""
    n, md = cfg["n"], cfg["m"]
    b = data["b"]
    B = b.shape[0]
    x = torch.zeros((B, n + md + n), dtype=b.dtype, device=b.device)
    x[:, n:n + md] = -b
    x[:, n + md:] = 1.0
    s = torch.ones((B, 2 * n), dtype=b.dtype, device=b.device)
    return x, s
