"""The small geometric program of userguide section 9.3 (reference
examples/doc/chap9/gp.py): maximize the volume of a box h x w x d under
wall/floor area and aspect-ratio limits, in log-sum-exp form."""

import numpy as np

from kvxopt_tpu_torch.solvers import gp


def main():
    Aflr = 1000.0
    Awall = 100.0
    alpha, beta = 0.5, 2.0
    gamma, delta = 0.5, 2.0

    F = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                  [-1., 1., 0., 1., 1., -1., 1., -1.],
                  [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
    g = np.log([1.0, 2 / Awall, 2 / Awall, 1 / Aflr, alpha, 1 / beta,
                gamma, 1 / delta])
    K = [1, 2, 1, 1, 1, 1, 1]
    sol = gp(K, F, g)
    return sol


if __name__ == "__main__":
    sol = main()
    h, w, d = np.exp(sol["x"].cpu().numpy().reshape(-1))
    print(f"h = {h:f},  w = {w:f}, d = {d:f}")
