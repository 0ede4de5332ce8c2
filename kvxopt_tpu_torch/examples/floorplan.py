"""Floor planning (userguide section 9.2; reference
examples/doc/chap9/floorplan.py): place 5 blocks with minimum areas
inside a bounding box of minimum perimeter, with spacing and
aspect-ratio limits.  A cpl with 5 nonlinear (hyperbolic) constraints
-w_k + Amin_k / h_k <= 0 and 26 linear inequalities over 22 variables
(W, H, x, y, w, h)."""

import numpy as np
import torch

from kvxopt_tpu_torch.examples._data import OnDevice, to_numpy
from kvxopt_tpu_torch.solvers import cpl

RHO, GAMMA = 1.0, 5.0  # min spacing, max aspect ratio


def floorplan(Amin):
    Amin = np.asarray(Amin, dtype=float).reshape(5)
    c = np.concatenate([[1.0, 1.0], np.zeros(20)])
    data = OnDevice(Amin=Amin)

    def F(x=None, z=None):
        if x is None:
            return 5, np.concatenate([np.zeros(17), np.ones(5)])
        if float(x[17:].min()) <= 0.0:
            return None
        Am = data(x).Amin
        k = torch.arange(5, device=x.device)
        f = -x[12:17] + Am / x[17:]
        Df = x.new_zeros((5, 22))
        Df[k, 12 + k] = -1.0
        Df[k, 17 + k] = -Am / x[17:] ** 2
        if z is None:
            return f, Df
        H = x.new_zeros((22, 22))
        H[17 + k, 17 + k] = 2.0 * z * Am / x[17:] ** 3
        return f, Df, H

    # variables: [W, H, x1..x5, y1..y5, w1..w5, h1..h5]
    W, Hv = 0, 1
    X = lambda k: 2 + k - 1
    Y = lambda k: 7 + k - 1
    Wd = lambda k: 12 + k - 1
    Hd = lambda k: 17 + k - 1

    G = np.zeros((26, 22))
    h = np.zeros(26)
    r = 0

    def row(entries, rhs=0.0):
        nonlocal r
        for j, v in entries:
            G[r, j] = v
        h[r] = rhs
        r += 1

    row([(X(1), -1.0)])                                   # -x1 <= 0
    row([(X(2), -1.0)])                                   # -x2 <= 0
    row([(X(4), -1.0)])                                   # -x4 <= 0
    row([(X(1), 1.0), (X(3), -1.0), (Wd(1), 1.0)], -RHO)  # x1+w1+rho<=x3
    row([(X(2), 1.0), (X(3), -1.0), (Wd(2), 1.0)], -RHO)
    row([(X(3), 1.0), (X(5), -1.0), (Wd(3), 1.0)], -RHO)
    row([(X(4), 1.0), (X(5), -1.0), (Wd(4), 1.0)], -RHO)
    row([(W, -1.0), (X(5), 1.0), (Wd(5), 1.0)])           # x5+w5 <= W
    row([(Y(2), -1.0)])
    row([(Y(3), -1.0)])
    row([(Y(5), -1.0)])
    row([(Y(1), -1.0), (Y(2), 1.0), (Hd(2), 1.0)], -RHO)  # y2+h2+rho<=y1
    row([(Y(1), 1.0), (Y(4), -1.0), (Hd(1), 1.0)], -RHO)  # y1+h1+rho<=y4
    row([(Y(3), 1.0), (Y(4), -1.0), (Hd(3), 1.0)], -RHO)  # y3+h3+rho<=y4
    row([(Hv, -1.0), (Y(4), 1.0), (Hd(4), 1.0)])          # y4+h4 <= H
    row([(Hv, -1.0), (Y(5), 1.0), (Hd(5), 1.0)])          # y5+h5 <= H
    for k in range(1, 6):                                 # aspect limits
        row([(Wd(k), -1.0), (Hd(k), 1.0 / GAMMA)])        # h/g <= w
        row([(Wd(k), 1.0), (Hd(k), -GAMMA)])              # w <= g*h

    sol = cpl(c, F, G, h)
    x = to_numpy(sol["x"]).reshape(-1)
    return (sol, x[0], x[1], x[2:7], x[7:12], x[12:17], x[17:22])


def main():
    return floorplan([100., 100., 100., 100., 100.])


if __name__ == "__main__":
    sol, W, H, x, y, w, hh = main()
    print("status:", sol["status"])
    print(f"W = {W:.4f}, H = {H:.4f}")
    print("areas:", (w * hh).round(3))
