"""The small SOCP of userguide section 8.5 (reference
examples/doc/chap8/socp.py), in the natural second-order-cone form."""

import numpy as np

from kvxopt_tpu_torch.solvers import socp


def main():
    c = np.array([-2.0, 1.0, 5.0])
    # the reference builds the G_k column-wise
    G0 = np.array([[12., 13., 12.], [6., -3., -12.],
                   [-5., -5., 6.]]).T
    G1 = np.array([[3., 3., -1., 1.], [-6., -6., -9., 19.],
                   [10., -2., -2., -3.]]).T
    hq = [np.array([-12., -3., -2.]), np.array([27., 0., 3., -42.])]
    sol = socp(c, Gq=[G0, G1], hq=hq)
    return sol


if __name__ == "__main__":
    sol = main()
    print("x =", sol["x"].cpu().numpy())
    print("zq[0] =", sol["zq"][0].cpu().numpy())
    print("zq[1] =", sol["zq"][1].cpu().numpy())
