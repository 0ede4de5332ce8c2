"""Gurobi bridge (reference src/C/gurobi.c, the fork's extra: qp in
cvxopt form, gurobi.c:547-560, and solve in the two-sided-bounds form,
gurobi.c:359-373).

Both entry points return the reference's 4-tuple (status, x, z, y) —
the LP/QP dispatch in solvers.lp/qp unpacks exactly this
(reference coneprog.py:2845, :4418).

Requires the commercial `gurobipy` package; importing this module without
it raises ImportError so callers treat Gurobi as unavailable (the same
skip pattern as the reference's tests/test_gurobi.py).  The bridge is
exercised in-process by tests/test_torch_msk_gurobi.py against the fake
gurobipy of tests/test_gurobi_bridge.py.  Copy of kvxopt_tpu/gurobi.py:
numpy on the host.
"""

import gurobipy  # noqa: F401  (ImportError here == Gurobi not available)

import numpy as np

from .base import matrix

options = {}

_STATUS = {}


def _status_str(code):
    import gurobipy as gp
    if code == gp.GRB.OPTIMAL:
        return "optimal"
    if code == gp.GRB.INFEASIBLE:
        return "primal infeasible"
    if code == gp.GRB.UNBOUNDED:
        return "dual infeasible"
    return "unknown"


def _apply_options(m, opts):
    """Set Gurobi parameters from an options dict (name -> value), the
    role of gurobi.c's options translation."""
    merged = dict(options)
    if opts:
        merged.update(opts)
    for k, v in merged.items():
        try:
            m.setParam(k, v)
        except Exception:
            pass


def qp(q, G=None, h=None, A=None, b=None, P=None, options=None):
    """minimize (1/2)x'Px + q'x s.t. Gx <= h, Ax = b (gurobi.c:547-560).

    Returns (status, x, z, y): z the multipliers of Gx <= h (z >= 0 with
    the cvxopt sign convention, i.e. -Pi), y those of Ax = b."""
    import gurobipy as gp
    qv = np.asarray(q, dtype=float).reshape(-1)
    n = len(qv)
    m = gp.Model()
    m.Params.OutputFlag = 0
    _apply_options(m, options)
    x = m.addMVar(n, lb=-gp.GRB.INFINITY)
    obj = qv @ x
    if P is not None:
        Pm = np.asarray(P, dtype=float).reshape(n, n)
        obj = 0.5 * (x @ Pm @ x) + qv @ x
    m.setObjective(obj)
    cG = cA = None
    if G is not None:
        Gm = np.asarray(G, dtype=float).reshape(-1, n)
        hv = np.asarray(h, dtype=float).reshape(-1)
        cG = m.addConstr(Gm @ x <= hv)
    if A is not None:
        Am = np.asarray(A, dtype=float).reshape(-1, n)
        bv = np.asarray(b, dtype=float).reshape(-1)
        cA = m.addConstr(Am @ x == bv)
    m.optimize()
    status = _status_str(m.Status)
    if status != "optimal":
        return (status, None, None, None)
    xv = matrix(np.asarray(x.X).reshape(-1, 1))
    z = (matrix(-np.asarray(cG.Pi).reshape(-1, 1))
         if cG is not None else None)
    y = (matrix(-np.asarray(cA.Pi).reshape(-1, 1))
         if cA is not None else None)
    return (status, xv, z, y)


def solve(q, G_l=None, G=None, G_u=None, A=None, b=None, P=None,
          x_l=None, x_u=None, options=None):
    """Two-sided-bounds form (gurobi.c:359-373):

        minimize    0.5 x'Px + q'x
        subject to  G_l <= G x <= G_u
                    A x = b
                    x_l <= x <= x_u

    Infinite entries (+-inf) in G_l/G_u/x_l/x_u disable the bound.
    Returns (status, x, z, y) with z the combined multipliers of the G
    rows (z = z_u - z_l, so that Px + q + G'z + A'y = 0) and y those of
    Ax = b."""
    import gurobipy as gp
    qv = np.asarray(q, dtype=float).reshape(-1)
    n = len(qv)
    m = gp.Model()
    m.Params.OutputFlag = 0
    _apply_options(m, options)
    lb = (-gp.GRB.INFINITY if x_l is None
          else np.asarray(x_l, dtype=float).reshape(-1))
    ub = (gp.GRB.INFINITY if x_u is None
          else np.asarray(x_u, dtype=float).reshape(-1))
    x = m.addMVar(n, lb=lb, ub=ub)
    obj = qv @ x
    if P is not None:
        Pm = np.asarray(P, dtype=float).reshape(n, n)
        obj = 0.5 * (x @ Pm @ x) + qv @ x
    m.setObjective(obj)
    cU = cL = cA = None
    mrows = 0
    if G is not None:
        if G_l is None and G_u is None:
            raise ValueError(
                "at least one bound matrix must be provided for G")
        Gm = np.asarray(G, dtype=float).reshape(-1, n)
        mrows = Gm.shape[0]
        if G_u is not None:
            gu = np.asarray(G_u, dtype=float).reshape(-1)
            cU = m.addConstr(Gm @ x <= gu)
        if G_l is not None:
            gl = np.asarray(G_l, dtype=float).reshape(-1)
            cL = m.addConstr((-Gm) @ x <= -gl)
    if A is not None:
        Am = np.asarray(A, dtype=float).reshape(-1, n)
        bv = np.asarray(b, dtype=float).reshape(-1)
        cA = m.addConstr(Am @ x == bv)
    m.optimize()
    status = _status_str(m.Status)
    if status != "optimal":
        return (status, None, None, None)
    xv = matrix(np.asarray(x.X).reshape(-1, 1))
    z = None
    if mrows:
        zu = (-np.asarray(cU.Pi).reshape(-1) if cU is not None
              else np.zeros(mrows))
        zl = (-np.asarray(cL.Pi).reshape(-1) if cL is not None
              else np.zeros(mrows))
        z = matrix((zu - zl).reshape(-1, 1))
    y = (matrix(-np.asarray(cA.Pi).reshape(-1, 1))
         if cA is not None else None)
    return (status, xv, z, y)
