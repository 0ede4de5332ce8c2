"""The small LP of userguide section 10.4 (reference
examples/doc/chap10/lp.py): scalar-variable and matrix-variable forms
of the same LP through the modeling DSL, with constraint multipliers."""

import numpy as np

from kvxopt_tpu_torch.modeling import variable, op, dot


def main():
    x = variable()
    y = variable()
    c1 = (2 * x + y <= 3)
    c2 = (x + 2 * y <= 3)
    c3 = (x >= 0)
    c4 = (y >= 0)
    lp1 = op(-4 * x - 5 * y, [c1, c2, c3, c4])
    lp1.solve()

    x2 = variable(2)
    A = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    b = np.array([3., 3., 0., 0.])
    c = np.array([-4., -5.])
    ineq = (A * x2 <= b)
    lp2 = op(dot(c, x2), ineq)
    lp2.solve()
    return lp1, lp2, (x, y, c1, c2, c3, c4), (x2, ineq)


if __name__ == "__main__":
    lp1, lp2, (x, y, c1, c2, c3, c4), (x2, ineq) = main()
    print("status:", lp1.status)
    print("optimal value: %f" % lp1.objective.value()[0])
    print("optimal x: %f  y: %f" % (x.value[0], y.value[0]))
    print("multipliers:", [float(c.multiplier.value[0])
                           for c in (c1, c2, c3, c4)])
    print("status:", lp2.status)
    print("optimal x:", np.asarray(x2.value).reshape(-1))
    print("multiplier:", np.asarray(ineq.multiplier.value).reshape(-1))
