"""Markowitz portfolio optimization (reference
examples/doc/chap8/portfolio.py): a risk/return tradeoff sweep solved
with qp one risk aversion at a time, then the whole sweep in one
batched call (parallel.batched_qp_solver)."""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.convert import state_to_numpy
from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.parallel import batched_qp_solver
from kvxopt_tpu_torch.solvers import qp


def main(n=8, nmu=16):
    rng = np.random.default_rng(7)
    F = rng.standard_normal((n, n))
    S = F @ F.T + 0.1 * np.eye(n)      # covariance
    pbar = rng.uniform(0.0, 0.3, n)    # mean returns

    # single solves across the risk-aversion sweep
    mus = [10 ** (5.0 * t / (nmu - 1) - 1.0) for t in range(nmu)]
    returns, risks = [], []
    G = np.vstack([-np.eye(n), np.ones((1, n)), -np.ones((1, n))])
    h = np.concatenate([np.zeros(n), [1.0], [-1.0]])
    for mu in mus:
        sol = qp(mu * S, -pbar, G, h)
        x = to_numpy(sol["x"])
        returns.append(float(pbar @ x))
        risks.append(float(np.sqrt(x @ S @ x)))

    # the same sweep as one batched solve: P and q per lane, G and h
    # shared by the lanes and passed once
    B = nmu
    Ps = np.stack([mu * S for mu in mus])
    qs = np.tile(-pbar, (B, 1))
    vsolve = batched_qp_solver(ConeDims(l=G.shape[0]))
    xb, yb, sb, zb, it, status, metrics = state_to_numpy(
        vsolve(Ps, qs, G, h))
    return dict(returns=returns, risks=risks, batch_status=status,
                batch_x=xb)


if __name__ == "__main__":
    out = main()
    print("sweep ok; batch statuses:", out["batch_status"])
