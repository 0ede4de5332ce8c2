"""Norm and penalty approximation problems (userguide section 10.5;
reference examples/doc/chap10/normappr.py):

    minimize ||A x + b||_inf
    minimize ||A x + b||_1
    minimize sum_k max(0, |(Ax+b)_k| - 0.75, 2|(Ax+b)_k| - 2.25)

all through the modeling DSL's PWL algebra; op.solve runs the port's
solvers.lp on config.default_device."""

import numpy as np

from kvxopt_tpu_torch import normal, setseed
from kvxopt_tpu_torch.modeling import variable, op, max, sum


def data(m=200, n=50, seed=0):
    """A (m, n) and b (m, 1), standard normal, drawn by the port's gsl
    after setseed(seed) (its bits differ from the JAX package's)."""
    setseed(seed)
    A = normal(m, n)
    b = normal(m)
    return A, b


def main(m=200, n=50, seed=0):
    A, b = data(m, n, seed)

    x1 = variable(n)
    prob1 = op(max(abs(A * x1 + b)))
    prob1.solve()

    x2 = variable(n)
    prob2 = op(sum(abs(A * x2 + b)))
    prob2.solve()

    x3 = variable(n)
    prob3 = op(sum(max(0, abs(A * x3 + b) - 0.75,
                       2 * abs(A * x3 + b) - 2.25)))
    prob3.solve()
    return (x1, prob1), (x2, prob2), (x3, prob3), A, b


if __name__ == "__main__":
    (x1, p1), (x2, p2), (x3, p3), A, b = main()
    Am, bv = np.asarray(A), np.asarray(b).reshape(-1)
    for name, x, p in (("inf", x1, p1), ("l1", x2, p2),
                       ("deadzone", x3, p3)):
        r = Am @ np.asarray(x.value).reshape(-1) + bv
        print(f"{name}: {p.status}, residual range "
              f"[{r.min():.3f}, {r.max():.3f}]")
