"""The small SDP of userguide section 8.6 (reference
examples/doc/chap8/sdp.py), in the natural semidefinite form."""

import numpy as np

from kvxopt_tpu_torch.solvers import sdp


def main():
    c = np.array([1.0, -1.0, 1.0])
    # G_k columns are vectorized symmetric coefficient matrices
    G0 = np.array([[-7., -11., -11., 3.],
                   [7., -18., -18., 8.],
                   [-2., -8., -8., 1.]]).T
    G1 = np.array([[-21., -11., 0., -11., 10., 8., 0., 8., 5.],
                   [0., 10., 16., 10., -10., -10., 16., -10., 3.],
                   [-5., 2., -17., 2., -6., 8., -17., 8., 6.]]).T
    hs = [np.array([[33., -9.], [-9., 26.]]),
          np.array([[14., 9., 40.], [9., 91., 10.], [40., 10., 15.]])]
    sol = sdp(c, Gs=[G0, G1], hs=hs)
    return sol


if __name__ == "__main__":
    sol = main()
    print("x =", sol["x"].cpu().numpy())
    print("zs[0] =", sol["zs"][0].cpu().numpy())
    print("zs[1] =", sol["zs"][1].cpu().numpy())
