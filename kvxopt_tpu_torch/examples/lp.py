"""LP example (reference examples/doc/chap8/lp.py): the userguide LP
with solution x = (1, 1)."""

import numpy as np

from kvxopt_tpu_torch.solvers import lp


def main():
    c = np.array([-4.0, -5.0])
    G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([3.0, 3.0, 0.0, 0.0])
    sol = lp(c, G, h)
    return sol


if __name__ == "__main__":
    sol = main()
    print(sol["status"], sol["x"].cpu().numpy())
