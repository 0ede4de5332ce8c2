"""The small linear cone program of userguide section 8.1 (reference
examples/doc/chap8/conelp.py): one l-block, two second-order cones, one
semidefinite block, solved by the native conelp IPM."""

import numpy as np

from kvxopt_tpu_torch.cones import ConeDims
from kvxopt_tpu_torch.solvers import conelp


def main():
    c = np.array([-6.0, -4.0, -5.0])
    # columns of G (the reference writes them column-wise)
    cols = [
        [16., 7., 24., -8., 8., -1., 0., -1., 0., 0., 7.,
         -5., 1., -5., 1., -7., 1., -7., -4.],
        [-14., 2., 7., -13., -18., 3., 0., 0., -1., 0., 3.,
         13., -6., 13., 12., -10., -6., -10., -28.],
        [5., 0., -15., 12., -6., 17., 0., 0., 0., -1., 9.,
         6., -6., 6., -7., -7., -6., -7., -11.],
    ]
    G = np.array(cols).T
    h = np.array([-3., 5., 12., -2., -14., -13., 10., 0., 0., 0., 68.,
                  -30., -19., -30., 99., 23., -19., 23., 10.])
    dims = ConeDims(l=2, q=(4, 4), s=(3,))
    sol = conelp(c, G, h, dims)
    return sol


if __name__ == "__main__":
    sol = main()
    print("Status:", sol["status"])
    print("x =", sol["x"].cpu().numpy())
    print("z =", sol["z"].cpu().numpy())
