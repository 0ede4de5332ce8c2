"""mcsdp (reference examples/doc/chap8/mcsdp.py): the SDP
    minimize 1'x  s.t.  w + diag(x) >= 0
whose optimum relates to the max-cut relaxation of -w.

The KKT system has order n + n^2: at the example's n = 20 (420) the
default thresholds send the solve to the CPU, at n = 100 (10100) it runs
on the card."""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.solvers import conelp


def mcsdp(w):
    """minimize 1'x s.t. w + diag(x) PSD."""
    w = np.asarray(w, dtype=float)
    n = w.shape[0]
    c = np.ones(n)
    # constraint: w + diag(x) = s >= 0
    # => -diag(x) + s = w  => G x + s = h with G col i = vec(-E_ii), h=vec(w)
    G = np.zeros((n * n, n))
    G[np.arange(n) * (n + 1), np.arange(n)] = -1.0
    h = w.reshape(-1)
    sol = conelp(c, G, h, ConeDims(l=0, s=(n,)))
    return sol


def main(n=20):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((n, n))
    w = 0.5 * (w + w.T)
    sol = mcsdp(w)
    # optimality condition: w + diag(x) PSD with min eigenvalue ~ 0
    x = to_numpy(sol["x"])
    lam = np.linalg.eigvalsh(w + np.diag(x))
    assert lam[0] > -1e-6
    return sol


if __name__ == "__main__":
    print(main()["status"])
