"""1-norm support vector classifier (userguide section 10.5; reference
examples/doc/chap10/l1svc.py):

    minimize ||x||_1 + sum_k max(0, 1 - (A x)_k)

solved twice through the modeling DSL — with explicit slack u and with
the hinge-loss PWL form directly."""

import numpy as np

from kvxopt_tpu_torch import normal, setseed
from kvxopt_tpu_torch.modeling import variable, op, max, sum


def data(m=200, n=50, seed=0):
    """A (m, n) standard normal, drawn by the port's gsl after
    setseed(seed)."""
    setseed(seed)
    return normal(m, n)


def main(m=200, n=50, seed=0):
    A = data(m, n, seed)

    x = variable(n, "x")
    u = variable(m, "u")
    p1 = op(sum(abs(x)) + sum(u), [A * x >= 1 - u, u >= 0])
    p1.solve()

    x2 = variable(n, "x")
    p2 = op(sum(abs(x2)) + sum(max(0, 1 - A * x2)))
    p2.solve()
    return x, x2, p1, p2


if __name__ == "__main__":
    x, x2, p1, p2 = main()
    print("status:", p1.status, p2.status)
    print("difference between the two solutions: %e"
          % np.linalg.norm(np.asarray(x.value) - np.asarray(x2.value)))
