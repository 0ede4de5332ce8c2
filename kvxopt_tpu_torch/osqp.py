"""First-order ADMM QP solver (reference src/C/osqp.c, the fork's OSQP
bridge: qp in cvxopt form, solve in the native l <= Ax <= u form).

Counterpart of kvxopt_tpu/osqp.py, in torch on config.default_device
(the card unless the caller names another): one Cholesky factorization
of P + sigma I + rho A'A, then matrix-vector ADMM iterations with
over-relaxation.

The JAX package runs the iterations in a lax.while_loop that tests
convergence on the device after each one.  Here they run in chunks of
CHUNK: inside a chunk, an iteration after the one that converged leaves
x, z, y and the counter as they are (torch.where), and the host reads
the done flag once per chunk.  The solve thus stops at the same
iteration with the same iterate as the JAX package's, with one host sync
per CHUNK iterations.  A factorization that fails (M not positive
definite) gives NaN, as jax.scipy's cho_factor does, and the loop runs
to max_iter.

Return formats match the reference:
    solve(q, A, l, u, P, options) -> (status, x, y)
    qp(q, G, h, A=None, b=None, P=None, options=None)
        -> (status, x, z, y)   with z/y the inequality/equality duals
status is 'solved' or 'max_iter_reached'.
"""

import math

import numpy as np
import torch

from . import config
from .base import matrix

options = {}

_DEFAULTS = dict(rho=0.1, sigma=1e-6, alpha=1.6, eps_abs=1e-8,
                 eps_rel=1e-8, max_iter=4000, check_termination=1,
                 verbose=0, adaptive_rho=False, polish=False,
                 warm_start=False)

# ADMM iterations between two reads of the done flag by the host
CHUNK = 25


def _opts(user):
    o = dict(_DEFAULTS)
    o.update(options)
    if user:
        o.update(user)
    return o


def _admm_core(P, q, A, l, u, rho, sigma, alpha, eps_abs, eps_rel,
               max_iter, check_every):
    """ADMM on tensors P (n, n), q (n,), A (m, n), l and u (m,) ->
    (x, z, y, iterations, done), the last two 0-d tensors.  check_every
    is accepted and, as in the JAX package, unused: convergence is
    tested after every iteration."""
    n = q.shape[0]
    m = A.shape[0]
    M = P + sigma * torch.eye(n, dtype=q.dtype, device=q.device) + \
        rho * (A.T @ A)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.full_like(L, math.nan).tril())
    qmax = q.abs().max()

    def step(x, z, y):
        rhs = sigma * x - q + A.T @ (rho * z - y)
        xt = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        axt = A @ xt
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(z_relax + y / rho, l, u)
        y_new = y + rho * (z_relax - z_new)

        ax = A @ x_new
        px = P @ x_new
        aty = A.T @ y_new
        r_dual = (px + q + aty).abs().max()
        eps_d = eps_abs + eps_rel * torch.maximum(
            torch.maximum(px.abs().max(), qmax), aty.abs().max())
        if m:
            r_prim = (ax - z_new).abs().max()
            eps_p = eps_abs + eps_rel * torch.maximum(ax.abs().max(),
                                                      z_new.abs().max())
        else:
            r_prim, eps_p = 0.0, eps_abs
        return x_new, z_new, y_new, (r_prim <= eps_p) & (r_dual <= eps_d)

    x = torch.zeros((n,), dtype=q.dtype, device=q.device)
    z = torch.zeros((m,), dtype=q.dtype, device=q.device)
    y = torch.zeros((m,), dtype=q.dtype, device=q.device)
    it = torch.zeros((), dtype=torch.int32, device=q.device)
    done = torch.zeros((), dtype=torch.bool, device=q.device)
    steps = 0           # iterations run so far while not done: it == steps
    while steps < max_iter:
        for _ in range(min(CHUNK, max_iter - steps)):
            live = ~done
            xn, zn, yn, converged = step(x, z, y)
            x = torch.where(live, xn, x)
            z = torch.where(live, zn, z)
            y = torch.where(live, yn, y)
            it = it + live.to(it.dtype)
            done = torch.where(live, converged, done)
            steps += 1
        if bool(done):
            break
    return x, z, y, it, done


def solve(q, A, l, u, P=None, options=None):
    """Native OSQP form: minimize (1/2)x'Px + q'x s.t. l <= Ax <= u
    (osqp.c:370-447).  Returns (status, x, y)."""
    o = _opts(options)
    dtype, dev = config.default_dtype, config.default_device

    def put(a, shape):
        return torch.as_tensor(np.asarray(a, dtype=float).reshape(shape),
                               dtype=dtype, device=dev)

    qv = put(q, -1)
    n = qv.shape[0]
    Am, lv, uv = put(A, (-1, n)), put(l, -1), put(u, -1)
    Pm = put(P, (n, n)) if P is not None else \
        torch.zeros((n, n), dtype=dtype, device=dev)
    Pm = 0.5 * (Pm + Pm.T)
    x, z, y, it, done = _admm_core(
        Pm, qv, Am, lv, uv, float(o["rho"]), float(o["sigma"]),
        float(o["alpha"]), float(o["eps_abs"]), float(o["eps_rel"]),
        int(o["max_iter"]), int(o["check_termination"]))
    status = "solved" if bool(done) else "max_iter_reached"
    return (status, matrix(x.cpu().numpy().reshape(-1, 1)),
            matrix(y.cpu().numpy().reshape(-1, 1)))


def qp(q, G=None, h=None, A=None, b=None, P=None, options=None):
    """cvxopt form: minimize (1/2)x'Px + q'x s.t. Gx <= h, Ax = b
    (osqp.c:442).  Returns (status, x, z, y)."""
    qv = np.asarray(q, dtype=float).reshape(-1)
    n = len(qv)
    blocks, lbs, ubs = [], [], []
    mG = 0
    if G is not None:
        Gm = np.asarray(G, dtype=float).reshape(-1, n)
        hv = np.asarray(h, dtype=float).reshape(-1)
        mG = Gm.shape[0]
        blocks.append(Gm)
        lbs.append(np.full(mG, -np.inf))
        ubs.append(hv)
    mA = 0
    if A is not None:
        Am = np.asarray(A, dtype=float).reshape(-1, n)
        bv = np.asarray(b, dtype=float).reshape(-1)
        mA = Am.shape[0]
        blocks.append(Am)
        lbs.append(bv)
        ubs.append(bv)
    if not blocks:
        blocks = [np.zeros((1, n))]
        lbs = [np.array([-np.inf])]
        ubs = [np.array([np.inf])]
    Astk = np.vstack(blocks)
    lv = np.concatenate(lbs)
    uv = np.concatenate(ubs)
    status, x, y_all = solve(qv, Astk, lv, uv, P, options=options)
    ya = np.asarray(y_all).reshape(-1)
    z = matrix(np.maximum(ya[:mG], 0.0).reshape(-1, 1))
    y = matrix(ya[mG:mG + mA].reshape(-1, 1))
    return (status, x, z, y)


def qp_bridge(P, q, G=None, h=None, A=None, b=None, options=None):
    """solvers.qp/lp(solver='osqp') adapter: conelp-style result dict."""
    merged = dict(options or {})
    osqp_opts = merged.get("osqp", merged if merged else None)
    status, x, z, y = qp(q, G, h, A, b, P, options=osqp_opts)
    res = {"status": "optimal" if status == "solved" else "unknown",
           "x": x, "z": z, "y": y, "s": None, "iterations": 0}
    if x is not None:
        xv = np.asarray(x).reshape(-1)
        Pm = np.asarray(P, dtype=float).reshape(len(xv), len(xv)) \
            if P is not None else np.zeros((len(xv), len(xv)))
        qv = np.asarray(q, dtype=float).reshape(-1)
        res["primal objective"] = float(0.5 * xv @ Pm @ xv + qv @ xv)
        if G is not None:
            hv = np.asarray(h, dtype=float).reshape(-1)
            Gm = np.asarray(G, dtype=float).reshape(-1, len(xv))
            res["s"] = matrix((hv - Gm @ xv).reshape(-1, 1))
        dual = res["primal objective"]
        res["dual objective"] = dual
        res["gap"] = 0.0
        res["relative gap"] = 0.0
        res["primal infeasibility"] = 0.0
        res["dual infeasibility"] = 0.0
    return res
