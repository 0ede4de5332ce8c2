"""LP / MILP bridge (reference src/C/glpk.c: lp via glp_simplex, ilp via
glp_intopt).

The reference links GLPK; this build bridges to HiGHS through scipy
(scipy.optimize.linprog / milp) — the same architectural move, a thin
wrapper over an external native simplex/branch-and-cut solver.  The
`options` dict accepts GLPK-style keys (msg_lev etc., glpk.c:200-310);
message-level options control scipy verbosity, unknown keys are ignored.

Return formats match the reference:
    lp(...)  -> (status, x, z, y)
    ilp(...) -> (status, x)

Copy of kvxopt_tpu/glpk.py: numpy and scipy on the host.
"""

import warnings

import numpy as np

from .base import matrix

options = {}


def _to_np(x, shape2=False):
    if x is None:
        return None
    a = np.asarray(x, dtype=float)
    return a if shape2 else a.reshape(-1)


def _merged_options(opts):
    out = dict(options)
    if opts:
        out.update(opts)
    return out


def _warn_default(key):
    # the reference's behavior on a badly typed/valued option
    # (glpk.c:224-226 PyErr_WarnEx "replacing ... with default value")
    warnings.warn(f"replacing glpk.options[{key!r}] with default value",
                  stacklevel=3)


def _translate_simplex_options(o):
    """Map the GLPK glp_smcp option keys the reference honors
    (glpk.c:200-330: msg_lev/meth/pricing/r_test/tol_bnd/tol_dj/tol_piv/
    obj_ll/obj_ul/it_lim/tm_lim/presolve) onto the HiGHS backend.  Keys
    with no HiGHS equivalent (pricing, r_test, obj_ll/obj_ul) are
    type-checked and accepted; badly typed values warn and fall back to
    the default, exactly like the reference."""
    sopts = {}
    method = "highs"
    for key, value in o.items():
        if key == "msg_lev":
            if value in ("GLP_MSG_OFF", "GLP_MSG_ERR"):
                sopts["disp"] = False
            elif value in ("GLP_MSG_ON", "GLP_MSG_ALL"):
                sopts["disp"] = True
            else:
                _warn_default(key)
        elif key == "meth":
            if value in ("GLP_DUAL", "GLP_DUALP"):
                method = "highs-ds"
            elif value == "GLP_PRIMAL":
                method = "highs"
            else:
                _warn_default(key)
        elif key == "pricing":
            if value not in ("GLP_PT_STD", "GLP_PT_PSE"):
                _warn_default(key)
        elif key == "r_test":
            if value not in ("GLP_RT_STD", "GLP_RT_HAR"):
                _warn_default(key)
        elif key == "tol_bnd":
            if isinstance(value, float):
                sopts["primal_feasibility_tolerance"] = value
            else:
                _warn_default(key)
        elif key == "tol_dj":
            if isinstance(value, float):
                sopts["dual_feasibility_tolerance"] = value
            else:
                _warn_default(key)
        elif key in ("tol_piv", "obj_ll", "obj_ul"):
            if not isinstance(value, float):
                _warn_default(key)
        elif key == "it_lim":
            if isinstance(value, int) and not isinstance(value, bool):
                sopts["maxiter"] = value
            else:
                _warn_default(key)
        elif key == "tm_lim":
            if isinstance(value, int) and not isinstance(value, bool):
                sopts["time_limit"] = value / 1000.0  # GLPK ms -> s
            else:
                _warn_default(key)
        elif key == "presolve":
            sopts["presolve"] = value not in ("GLP_OFF", 0, False)
    return sopts, method


def lp(c, G, h, A=None, b=None, options=None):
    """Simplex LP: minimize c'x s.t. Gx <= h, Ax = b (glpk.c:75-188).
    Returns (status, x, z, y).  GLPK-style options (msg_lev, meth,
    tol_bnd, tol_dj, it_lim, tm_lim, presolve, ...) are honored via
    their HiGHS equivalents."""
    from scipy.optimize import linprog
    o = _merged_options(options)
    sopts, method = _translate_simplex_options(o)
    cv = _to_np(c)
    Gm = np.asarray(G, dtype=float).reshape(-1, len(cv))
    hv = _to_np(h)
    Am = np.asarray(A, dtype=float).reshape(-1, len(cv)) \
        if A is not None else None
    bv = _to_np(b) if b is not None else None
    res = linprog(cv, A_ub=Gm, b_ub=hv, A_eq=Am, b_eq=bv,
                  bounds=(None, None), method=method, options=sopts)
    if res.status == 0:
        x = matrix(res.x.reshape(-1, 1))
        z = matrix(np.maximum(0.0, -np.asarray(
            res.ineqlin.marginals)).reshape(-1, 1)) \
            if hasattr(res, "ineqlin") else matrix(0.0, (len(hv), 1))
        y = matrix((-np.asarray(res.eqlin.marginals)).reshape(-1, 1)) \
            if (Am is not None and hasattr(res, "eqlin")) else \
            matrix(0.0, (0, 1))
        return ("optimal", x, z, y)
    if res.status == 2:
        return ("primal infeasible", None, None, None)
    if res.status == 3:
        return ("dual infeasible", None, None, None)
    return ("unknown", None, None, None)


def ilp(c, G, h, A=None, b=None, I=None, B=None, options=None):
    """Mixed-integer LP: I = integer variable indices, B = binary
    (glpk.c:427-455).  Returns (status, x)."""
    from scipy.optimize import milp, LinearConstraint, Bounds
    o = _merged_options(options)
    mopts = {}
    for key, value in o.items():
        # glp_iocp keys the reference honors (glpk.c intopt options):
        # msg_lev, tm_lim, mip_gap, presolve
        if key == "msg_lev":
            mopts["disp"] = value in ("GLP_MSG_ON", "GLP_MSG_ALL")
        elif key == "tm_lim":
            if isinstance(value, int) and not isinstance(value, bool):
                mopts["time_limit"] = value / 1000.0
            else:
                _warn_default(key)
        elif key == "mip_gap":
            if isinstance(value, float):
                mopts["mip_rel_gap"] = value
            else:
                _warn_default(key)
        elif key == "presolve":
            mopts["presolve"] = value not in ("GLP_OFF", 0, False)
    cv = _to_np(c)
    n = len(cv)
    Gm = np.asarray(G, dtype=float).reshape(-1, n)
    hv = _to_np(h)
    I = set() if I is None else set(int(i) for i in I)
    B = set() if B is None else set(int(i) for i in B)
    integrality = np.zeros(n)
    lb = np.full(n, -np.inf)
    ub = np.full(n, np.inf)
    for i in I:
        integrality[i] = 1
    for i in B:
        integrality[i] = 1
        lb[i], ub[i] = 0.0, 1.0
    cons = [LinearConstraint(Gm, -np.inf, hv)]
    if A is not None:
        Am = np.asarray(A, dtype=float).reshape(-1, n)
        bv = _to_np(b)
        cons.append(LinearConstraint(Am, bv, bv))
    res = milp(cv, constraints=cons, integrality=integrality,
               bounds=Bounds(lb, ub), options=mopts)
    if res.status == 0:
        x = res.x.copy()
        x[list(I | B)] = np.round(x[list(I | B)]) if (I | B) else \
            x[list(I | B)]
        return ("optimal", matrix(x.reshape(-1, 1)))
    if res.status == 2:
        # match the reference's phrasing for an infeasible relaxation
        return ("LP relaxation is primal infeasible", None)
    if res.status == 3:
        return ("LP relaxation is dual infeasible", None)
    return ("unknown", None)


def lp_bridge(c, G, h, A=None, b=None, options=None):
    """solvers.lp(solver='glpk') adapter: returns the conelp-style dict."""
    merged = dict(options or {})
    glpk_opts = merged.get("glpk", None)
    status, x, z, y = lp(c, G, h, A, b, options=glpk_opts)
    res = {"status": status, "x": x, "z": z, "y": y,
           "s": None, "iterations": 0}
    if status == "optimal":
        cv = _to_np(c)
        hv = _to_np(h)
        xv = np.asarray(x).reshape(-1)
        res["s"] = matrix((hv - np.asarray(G, dtype=float).reshape(
            -1, len(cv)) @ xv).reshape(-1, 1))
        res["primal objective"] = float(cv @ xv)
        res["dual objective"] = res["primal objective"]
        res["gap"] = 0.0
        res["relative gap"] = 0.0
        res["primal infeasibility"] = 0.0
        res["dual infeasibility"] = 0.0
    return res
