"""Robust LP (userguide section 10.5; reference
examples/doc/chap10/roblp.py):

    minimize c'x  s.t.  A x + ||x||_1 <= b

solved twice through the modeling DSL — once with the PWL form
A*x + sum(abs(x)) <= b directly, once with the explicit auxiliary
variable y — and the solutions compared."""

import numpy as np

from kvxopt_tpu_torch import normal, uniform, setseed
from kvxopt_tpu_torch.modeling import variable, dot, op, sum


def data(m=200, n=50, seed=0):
    """A (m, n) standard normal, b (m, 1) uniform(0, 1), c (n, 1)
    standard normal, drawn by the port's gsl after setseed(seed)."""
    setseed(seed)
    A = normal(m, n)
    b = uniform(m)
    c = normal(n)
    return A, b, c


def main(m=200, n=50, seed=0):
    A, b, c = data(m, n, seed)

    x = variable(n)
    p1 = op(dot(c, x), A * x + sum(abs(x)) <= b)
    p1.solve()

    x2 = variable(n)
    y = variable(n)
    p2 = op(dot(c, x2), [A * x2 + sum(y) <= b, -y <= x2, x2 <= y])
    p2.solve()
    return x, x2, p1, p2


if __name__ == "__main__":
    x, x2, p1, p2 = main()
    print("status:", p1.status, p2.status)
    print("difference between the two solutions: %e"
          % np.linalg.norm(np.asarray(x.value) - np.asarray(x2.value)))
