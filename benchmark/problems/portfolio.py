"""The OSQP benchmark suite's Portfolio class as dense cone-QP data.

Stellato, Banjac, Goulart, Bemporad and Boyd, "OSQP: an operator
splitting solver for quadratic programs", Math. Prog. Comp. 2020,
appendix (portfolio optimization); github.com/osqp/osqp_benchmarks,
problem_classes/portfolio.py.

    minimize    x'Dx + y'y - mu'x / gamma
    subject to  y = F'x,  1'x = 1,  x >= 0

F (n x k) has round(density n k) nonzeros at uniformly drawn places,
each N(0, 1); D is diagonal with D_ii ~ U[0, sqrt(k)]; mu ~ N(0, I).
Over the variable (x, y), n + k of them, as coneqp data:

    P = 2 blkdiag(D, I_k),  q = [-mu / gamma; 0]
    G = [-I_n, 0],          h = 0          (dims {"l": n})
    A = [[F', -I_k]; [1', 0]],  b = [0; 1]
"""

from __future__ import annotations

import math

import torch


def shapes(cfg):
    """(n_var, m, p) of the coneqp data."""
    n, k = cfg["n"], cfg["k"]
    return n + k, n, k + 1


def make(cfg, gen, batch, device, dtype):
    """`batch` instances drawn from the torch.Generator `gen` (on
    `device`): a dict of P (B, nv, nv), q (B, nv), G (B, m, nv), h (B, m),
    A (B, p, nv), b (B, p) in `dtype`."""
    n, k = cfg["n"], cfg["k"]
    B = batch
    nnz = round(cfg["density"] * n * k)
    kw = {"generator": gen, "device": device}
    # exactly nnz places of F, uniformly without replacement
    order = torch.rand((B, n * k), **kw).argsort(dim=-1)[:, :nnz]
    mask = torch.zeros((B, n * k), device=device, dtype=torch.bool)
    mask.scatter_(1, order, True)
    F = torch.randn((B, n * k), dtype=dtype, **kw) * mask
    F = F.reshape(B, n, k)
    D = torch.rand((B, n), dtype=dtype, **kw) * math.sqrt(k)
    mu = torch.randn((B, n), dtype=dtype, **kw)

    nv, m, p = shapes(cfg)
    P = torch.zeros((B, nv, nv), dtype=dtype, device=device)
    P.diagonal(dim1=-2, dim2=-1).copy_(
        2.0 * torch.cat([D, torch.ones((B, k), dtype=dtype,
                                       device=device)], dim=1))
    q = torch.cat([-mu / cfg["gamma"],
                   torch.zeros((B, k), dtype=dtype, device=device)], dim=1)
    G = torch.zeros((B, m, nv), dtype=dtype, device=device)
    G[:, :, :n].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    h = torch.zeros((B, m), dtype=dtype, device=device)
    A = torch.zeros((B, p, nv), dtype=dtype, device=device)
    A[:, :k, :n] = F.transpose(1, 2)
    A[:, :k, n:].diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    A[:, k, :n] = 1.0
    b = torch.zeros((B, p), dtype=dtype, device=device)
    b[:, k] = 1.0
    return {"P": P, "q": q, "G": G, "h": h, "A": A, "b": b}


def feasible_point(cfg, data):
    """A strictly feasible point of each instance, (x, s) (B, nv), (B, m):
    the uniform portfolio x = 1/n, y = F'x, s = x."""
    n = cfg["n"]
    A = data["A"]
    B, p, nv = A.shape
    k = p - 1
    xa = torch.full((B, n), 1.0 / n, dtype=A.dtype, device=A.device)
    y = torch.einsum("bkn,bn->bk", A[:, :k, :n], xa)
    return torch.cat([xa, y], dim=1), xa
