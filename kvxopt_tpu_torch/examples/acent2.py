"""Analytic centering with cone constraints (userguide section 9.1;
reference examples/doc/chap9/acent2.py):

    minimize -sum log(1 - x_i^2)
    s.t.     one second-order cone and one SDP constraint
"""

import numpy as np
import torch

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.solvers import cp


def F(x=None, z=None):
    if x is None:
        return 0, np.zeros(3)
    if float(x.abs().max()) >= 1.0:
        return None
    u = 1.0 - x ** 2
    val = -torch.log(u).sum()
    Df = (2.0 * x / u).reshape(1, -1)
    if z is None:
        return val.reshape(1), Df
    # d2/dx2 -log(1-x^2) = 2 (1+x^2) / (1-x^2)^2  (note: the reference's
    # chap9/acent2.py example file writes 1+u^2 here — a typo; the
    # userguide doc/source/solvers.rst has the correct 1+x^2)
    H = torch.diag(2.0 * z[0] * (1.0 + x ** 2) / u ** 2)
    return val.reshape(1), Df, H


def main():
    G = np.array([
        [0., -1., 0., 0., -21., -11., 0., -11., 10., 8., 0., 8., 5.],
        [0., 0., -1., 0., 0., 10., 16., 10., -10., -10., 16., -10., 3.],
        [0., 0., 0., -1., -5., 2., -17., 2., -6., 8., -17., -7., 6.],
    ]).T
    h = np.array([1.0, 0.0, 0.0, 0.0, 20., 10., 40., 10., 80., 10.,
                  40., 10., 15.])
    dims = ConeDims(l=0, q=(4,), s=(3,))
    sol = cp(F, G, h, dims)
    return sol


if __name__ == "__main__":
    sol = main()
    print("status:", sol["status"])
    print("x =", sol["x"].cpu().numpy())
