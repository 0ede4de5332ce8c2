"""The efficient frontier of one OSQP-suite Portfolio market: its
instances at a sweep of risk aversions, as dense cone-QP data whose
market is shared by the lanes.

The market is problems/portfolio.py's (the OSQP benchmark suite's
Portfolio class): F, D and mu drawn as there.  The sweep is CVXOPT's
trade-off curve for qp (examples/doc/chap8/portfolio.py): N risk
aversions gamma_t = 10^(5 t / N - 1), t = 0..N-1.  Lane t is the suite's
instance at gamma_t,

    minimize    x'Dx + y'y - mu'x / gamma_t
    subject to  y = F'x,  1'x = 1,  x >= 0,

whose argmin is that of CVXOPT's -mu'x + gamma_t x'(D + F F')x.  Only q
differs between lanes: q_t = [-mu / gamma_t; 0]; P, G, h, A and b are
one instance's, shared.
"""

from __future__ import annotations

from benchmark.problems import portfolio


def shapes(cfg):
    """(n_var, m, p) of the coneqp data."""
    return portfolio.shapes(cfg)


def gammas(cfg, dtype, device):
    """The sweep's risk aversions (lanes,): 10^(5 t / lanes - 1)."""
    import torch
    t = torch.arange(cfg["lanes"], dtype=dtype, device=device)
    return 10.0 ** (5.0 * t / cfg["lanes"] - 1.0)


def make(cfg, gen, batch, device, dtype):
    """One market drawn from the torch.Generator `gen` (on `device`) and
    its `batch` = cfg["lanes"] points of the frontier: a dict of P
    (nv, nv), G (m, nv), h (m,), A (p, nv), b (p,), shared by the lanes,
    and q (batch, nv), in `dtype`."""
    if batch != cfg["lanes"]:
        raise ValueError(f"the sweep has {cfg['lanes']} lanes, the traffic "
                         f"asks for {batch}")
    one = portfolio.make({**cfg, "gamma": 1.0}, gen, 1, device, dtype)
    data = {k: v[0] for k, v in one.items()}
    # q of the market at gamma = 1 is [-mu; 0]
    data["q"] = data["q"] / gammas(cfg, dtype, device)[:, None]
    return data
