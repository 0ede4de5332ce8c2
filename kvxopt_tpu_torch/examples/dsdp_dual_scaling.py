"""Dual-scaling SDP solve through the DSDP-style interface.

The same userguide SDP as examples/sdp.py, solved by the native
dual-scaling method (kvxopt_tpu_torch.dsdp, on the host, as the
reference wraps DSDP5 here, src/C/dsdp.c) and cross-checked against
the conelp core (solvers.sdp, on config.default_device).  The penalty
variable r returns ~0 for feasible problems; an infeasible LMI keeps
r > 0 and reports DSDP_INFEASIBLE instead of failing."""

import numpy as np

from kvxopt_tpu_torch import dsdp, matrix, solvers
from kvxopt_tpu_torch.examples._data import to_numpy


def data():
    """The userguide SDP: c, G (two blocks) and h as matrix objects."""
    c = matrix([1.0, -1.0, 1.0])
    G = [matrix([[-7.0, -11.0, -11.0, 3.0],
                 [7.0, -18.0, -18.0, 8.0],
                 [-2.0, -8.0, -8.0, 1.0]])]
    G += [matrix([[-21.0, -11.0, 0.0, -11.0, 10.0, 8.0, 0.0, 8.0, 5.0],
                  [0.0, 10.0, 16.0, 10.0, -10.0, -10.0, 16.0, -10.0, 3.0],
                  [-5.0, 2.0, -17.0, 2.0, -6.0, 8.0, -17.0, 8.0, 6.0]])]
    h = [matrix([[33.0, -9.0], [-9.0, 26.0]])]
    h += [matrix([[14.0, 9.0, 40.0], [9.0, 91.0, 10.0],
                  [40.0, 10.0, 15.0]])]
    return c, G, h


def main():
    """-> (dual-scaling (status, x, r, zl, zs), the conelp result)."""
    c, G, h = data()
    dual = dsdp.sdp(c, None, None, G, h)
    ref = solvers.sdp(c, None, None, G, h)
    return dual, ref


if __name__ == "__main__":
    (status, x, r, zl, zs), ref = main()
    c = data()[0]
    print("dual scaling:", status)
    print("x =", np.asarray(x).ravel(), " r =", np.asarray(r).ravel()[0])
    print("conelp      :", ref["status"])
    print("x =", to_numpy(ref["x"]).ravel())
    print("objective gap:",
          abs(float(np.asarray(c).ravel() @ np.asarray(x).ravel())
              - ref["primal objective"]))
