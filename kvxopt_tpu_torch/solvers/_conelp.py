"""conelp: cone LPs by the extended self-dual embedding, the
natural-form wrappers lp/socp/sdp, and the solver= routes of lp, qp,
socp and sdp (glpk, osqp, gurobi, mosek, dsdp) with their numpy result
mappers.

Counterpart of kvxopt_tpu/solvers/_conelp.py (reference coneprog.py
conelp :31, lp :2550, socp :3044, sdp :3597).  The core is batched as
the coneqp core is: one lane per problem, tau and kappa (B,) tensors, and
a lane steps only while its status is RUNNING.

Newton system solved each step (f6 in the reference, coneprog.py:1130):

    A'dy + G'dz + c dtau                  = bx
    A dx - b dtau                          = by
    G dx + ds - h dtau                     = bz
    c'dx + b'dy + h'dz + dkappa            = bt
    lambda o (W^{-T}ds + W dz)             = d_s
    kappa dtau + tau dkappa                = d_kappa

reduced onto the 3x3 KKT factorization by eliminating ds and dkappa and
expanding (dx,dy,dz) = (xt,yt,zt) + dtau*(x1,y1,z1) with (x1,y1,z1) =
K^{-1}(-c, b, h) computed once per factorization.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import cones, config
from ..trace import _profile_ctx
from ..cones import ConeDims
from .coneprog import (
    RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR,
    _STATUS_STR, STEP, EXPON, LANES, Options, _asarray, _constraints,
    _custom_ops, _dispatch_ctx, _front_end_ops, _numel,
    _relgap, _resolve_options, _solve_device, _spaces, _start,
    _tree_leaves, _kkt_order, _veclen, _where)


def conelp(c, G, h, dims=None, A=None, b=None, primalstart=None,
           dualstart=None, kktsolver=None, options=None, xnewcopy=None,
           xdot=None, xscal=None, xaxpy=None, ynewcopy=None, ydot=None,
           yscal=None, yaxpy=None):
    """Solve the cone LP pair (reference coneprog.py:31)

        minimize  c'x                 maximize  -h'z - b'y
        s.t.      G x + s = h         s.t.      G'z + A'y + c = 0
                  A x = b                       z >= 0
                  s >= 0

    returning the reference's result dict including infeasibility
    certificates: on 'primal infeasible', (y, z) certify h'z + b'y = -1,
    G'z + A'y = 0, z >= 0; on 'dual infeasible', (x, s) certify c'x = -1,
    Gx + s = 0, Ax = 0, s >= 0.  Vectors are tensors on the solve's
    device.  G and A may be operators with a custom kktsolver, as in
    coneqp; primalstart {'x', 's'} and dualstart {'y', 'z'} warm-start
    the iteration.  options['profile'] = <directory> writes the solve's
    torch.profiler trace there (trace._profile_ctx).

    Custom vector spaces, as in coneqp: any x* hook makes x and c
    elements of the user's space (G an operator, kktsolver the user's),
    any y* hook y and b (A an operator, b given); primalstart's x and
    dualstart's y are then elements of those spaces.

    Where the KKT system's order len(c) + len(h) + len(b) is below
    config.host_dispatch_threshold (unknown with custom spaces or an
    operator G), array-like inputs go to the CPU
    (coneprog._dispatch_ctx)."""
    xops = _custom_ops(xnewcopy, xdot, xscal, xaxpy)
    yops = _custom_ops(ynewcopy, ydot, yscal, yaxpy)
    custom = xops is not None or yops is not None
    order = None if (custom or callable(G)) else _kkt_order(
        _veclen(c), _veclen(h), _veclen(b))
    with _dispatch_ctx(order):
        dev = _solve_device(*_tree_leaves(c), h, G, A, *_tree_leaves(b))
        with _profile_ctx(options, dev):
            return _conelp_impl(c, G, h, dims, A, b, primalstart, dualstart,
                                kktsolver, options, dev, xops, yops)


def _conelp_impl(c, G, h, dims, A, b, primalstart, dualstart, kktsolver,
                 options, dev, xops=None, yops=None):
    """conelp on the device `dev`; xops and yops the VecOps of custom x
    and y spaces, else None."""
    o, dtype = _resolve_options(options)
    if xops is not None and not (callable(G) and callable(kktsolver)):
        raise ValueError("custom x vector space requires operator-form G "
                         "and a custom kktsolver")
    if yops is not None and not (A is not None and callable(A) and
                                 b is not None):
        raise ValueError("custom y vector space requires operator-form A "
                         "and b")
    xs, ys, zs, xsp, ysp = _spaces(dtype, dev, xops, yops)
    n = None
    if xops is None:
        c = _asarray(c, dtype, dev, name="c")[None]
        n = c.shape[1]
    dims, h, b, Ga, Aa = _constraints(G, h, dims, A, b, n, dtype, dev,
                                      custom_y=yops is not None)
    if kktsolver is None:
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)
    factor, gmv, amv, _ = _front_end_ops(dims, o, kktsolver, (G, A, None),
                                         (Ga, Aa, None), xs, ys, zs)

    ps = None
    if primalstart is not None:
        ps = (_start(xs, primalstart["x"], dtype, dev, "x"),
              _start(zs, primalstart["s"], dtype, dev, "s"))
    dst = None
    if dualstart is not None:
        y0 = dualstart.get("y")
        dst = (h.new_zeros((1, 0)) if y0 is None
               else _start(ys, y0, dtype, dev, "y"),
               _start(zs, dualstart["z"], dtype, dev, "z"))
    state = _conelp_core(c, h, b, dims, o, factor, gmv, amv, ps, dst,
                         xsp=xsp, ysp=ysp)
    return _conelp_result(state, c, h, b, dims, xsp=xsp, ysp=ysp)


def _conelp_core(c, h, b, dims, o: Options, factor, gmv, amv,
                 primalstart=None, dualstart=None, xsp=LANES, ysp=LANES):
    """Batched conelp driver: c (B, n), h (B, m), b (B, p), `factor(W)` a
    KKT strategy over the batch, gmv/amv batched operator products;
    primalstart (x, s) and dualstart (y, z), each (B, .), if given; xsp
    and ysp the operations on the x and y spaces (coneprog._coneqp_core).
    Returns the final state (x, y, s, z, tau, kappa, iterations, status,
    metrics), metrics a dict of (B,) tensors: pcost, dcost, gap, relgap,
    pres, dres, pinfres, dinfres."""
    B, dtype, dev = h.shape[0], h.dtype, h.device
    p = ysp.size(b)
    deg = dims.degree
    e = cones.cone_e(dims, dtype, dev)

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    def col(t):
        return t[:, None]

    resx0 = torch.clamp(xsp.norm(c), min=1.0)
    resy0 = torch.clamp(ysp.norm(b), min=1.0)
    resz0 = torch.clamp(cones.snrm2(dims, h), min=1.0)

    def shift(u, t):
        """u + (1 + t) e where max_step t says u is not inside."""
        return _where(t >= -1e-8 * torch.clamp(torch.abs(t), min=1.0),
                      u + col(1.0 + t) * e, u)

    def initial_point():
        solve0 = factor(cones.identity_scaling(dims, B, dtype, dev))
        if primalstart is None:
            x0, _, z0p = solve0(xsp.zero(c), b, h)
            s0 = -z0p
        else:
            x0, s0 = primalstart
        if dualstart is None:
            _, y0, z0 = solve0(xsp.scal(-1.0, c), ysp.zero(b),
                               torch.zeros_like(h))
        else:
            y0, z0 = dualstart
        if primalstart is None and dualstart is None:
            # one eigenvalue call per s group for both boundary distances
            ts, tz = cones.max_step2(dims, s0, z0)
            return x0, y0, shift(s0, ts), shift(z0, tz)
        if primalstart is None:
            s0 = shift(s0, cones.max_step(dims, s0))
        if dualstart is None:
            z0 = shift(z0, cones.max_step(dims, z0))
        return x0, y0, s0, z0

    def residuals(x, y, s, z, tau, kappa):
        rx = xsp.axpy(gmv(z, trans=True), xsp.scal(tau, c))
        if p:
            rx = xsp.axpy(amv(y, trans=True), rx)
        ry = ysp.axpy(ysp.scal(tau, b), amv(x), -1.0) if p else b
        rz = gmv(x) + s - h * col(tau)
        rt = kappa + xsp.dot(c, x) + (ysp.dot(b, y) if p else 0.0) + \
            cones.sdot(dims, h, z)
        return rx, ry, rz, rt

    def metrics_of(x, y, s, z, tau, kappa):
        rx, ry, rz, rt = residuals(x, y, s, z, tau, kappa)
        gap = cones.sdot(dims, s, z) / (tau * tau)
        pcost = xsp.dot(c, x) / tau
        dcost = -(cones.sdot(dims, h, z) +
                  (ysp.dot(b, y) if p else 0.0)) / tau
        pres = cones.snrm2(dims, rz) / resz0
        if p:
            pres = torch.maximum(ysp.norm(ry) / resy0, pres)
        pres = pres / tau
        dres = xsp.norm(rx) / resx0 / tau
        # infeasibility certificates
        inf = torch.full_like(tau, math.inf)
        hz_by = cones.sdot(dims, h, z) + (ysp.dot(b, y) if p else 0.0)
        cx = xsp.dot(c, x)
        hrx = gmv(z, trans=True)
        if p:
            hrx = xsp.axpy(amv(y, trans=True), hrx)
        pinfres = torch.where(hz_by < 0.0, xsp.norm(hrx) / resx0 / (-hz_by),
                              inf)
        dinf = cones.snrm2(dims, gmv(x) + s) / resz0
        if p:
            dinf = torch.maximum(ysp.norm(amv(x)) / resy0, dinf)
        dinfres = torch.where(cx < 0.0, dinf / (-cx), inf)
        return (rx, ry, rz, rt,
                dict(pcost=pcost, dcost=dcost, gap=gap,
                     relgap=_relgap(gap, pcost, dcost), pres=pres,
                     dres=dres, pinfres=pinfres, dinfres=dinfres))

    def f6_factory(solve, lmbda, W, tau, kappa):
        # (x1, y1, z1) = K^{-1}(-c, b, h), once per factorization
        x1, y1, z1 = solve(xsp.scal(-1.0, c), b, h)
        dg = xsp.dot(c, x1) + (ysp.dot(b, y1) if p else 0.0) + \
            cones.sdot(dims, h, z1) - kappa / tau

        def f6_no_ir(bx, by, bz, bt, d_s, d_k):
            tmp = cones.sinv(dims, lmbda, d_s)
            xt, yt, zt = solve(bx, by,
                               bz - cones.scale(dims, W, tmp, trans=True))
            num = (bt - d_k / tau) - (xsp.dot(c, xt) +
                                      (ysp.dot(b, yt) if p else 0.0) +
                                      cones.sdot(dims, h, zt))
            dtau = num / dg
            dx = xsp.axpy(x1, xt, dtau)
            dy = ysp.axpy(y1, yt, dtau) if p else yt
            dz = zt + col(dtau) * z1
            ds = cones.scale(dims, W, tmp - cones.scale(dims, W, dz),
                             trans=True)
            dk = (d_k - kappa * dtau) / tau
            return dx, dy, dz, dtau, ds, dk

        def f6(bx, by, bz, bt, d_s, d_k):
            d = f6_no_ir(bx, by, bz, bt, d_s, d_k)
            for _ in range(o.refinement):
                dx, dy, dz, dtau, ds, dk = d
                t = xsp.axpy(gmv(dz, trans=True), xsp.scal(dtau, c))
                if p:
                    t = xsp.axpy(amv(dy, trans=True), t)
                r1 = xsp.axpy(t, bx, -1.0)
                r2 = ysp.axpy(ysp.axpy(ysp.scal(dtau, b), amv(dx), -1.0),
                              by, -1.0) if p else by
                r3 = bz - (gmv(dx) + ds - h * col(dtau))
                r4 = bt - (xsp.dot(c, dx) +
                           (ysp.dot(b, dy) if p else 0.0) +
                           cones.sdot(dims, h, dz) + dk)
                r5 = d_s - cones.sprod(
                    dims, lmbda,
                    cones.scale(dims, W, ds, trans=True, inverse=True) +
                    cones.scale(dims, W, dz), diag=True)
                r6 = d_k - (kappa * dtau + tau * dk)
                ex, ey, ez, et, es, ek = f6_no_ir(r1, r2, r3, r4, r5, r6)
                d = (xsp.axpy(ex, dx), ysp.axpy(ey, dy) if p else dy,
                     dz + ez, dtau + et, ds + es, dk + ek)
            return d

        return f6

    def do_step(x, y, s, z, tau, kappa, rx, ry, rz, rt):
        W, lmbda = cones.compute_scaling(dims, s, z)
        f6 = f6_factory(factor(W), lmbda, W, tau, kappa)
        lmbdasq = cones.ssqr(dims, lmbda)
        mu = (cones.sdot(dims, lmbda, lmbda) + tau * kappa) / (deg + 1)

        # Mehrotra predictor (phase 0), then corrector
        r = torch.ones_like(tau)
        d_s, d_k = -lmbdasq, -tau * kappa
        for phase in range(2):
            if phase:
                sigma = torch.clamp(1.0 - torch.clamp(tlim, max=1.0),
                                    0.0, 1.0) ** EXPON
                d_s = (-lmbdasq - cones.sprod(dims, ds_w, dz_w) +
                       col(sigma * mu) * e)
                d_k = -tau * kappa - dt * dk + sigma * mu
                r = 1.0 - sigma
            dx, dy, dz, dt, ds, dk = f6(xsp.scal(-r, rx), ysp.scal(-r, ry),
                                        col(-r) * rz, -r * rt, d_s, d_k)
            ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
            dz_w = cones.scale(dims, W, dz)
            t_cone = 1.0 / torch.clamp(_inv_step(dims, lmbda, ds_w, dz_w),
                                       min=1e-30)
            tlim = torch.minimum(t_cone, _tk_step(tau, kappa, dt, dk))
        step = torch.clamp(STEP * tlim, max=1.0)

        xn = xsp.axpy(dx, x, step)
        yn = ysp.axpy(dy, y, step) if p else y
        sn, zn = s + col(step) * ds, z + col(step) * dz
        tn, kn = tau + step * dt, kappa + step * dk
        bad = ~torch.isfinite(xsp.dot(xn, xn) + dot(sn, sn) + dot(zn, zn) +
                              tn + kn) | (tn <= 0)
        st = torch.where(bad, SINGULAR, RUNNING).to(torch.int32)
        return (xsp.where(bad, x, xn), ysp.where(bad, y, yn),
                _where(bad, s, sn),
                _where(bad, z, zn), torch.where(bad, tau, tn),
                torch.where(bad, kappa, kn), st)

    x, y, s, z = initial_point()
    tau = torch.ones((B,), dtype=dtype, device=dev)
    kappa = torch.ones((B,), dtype=dtype, device=dev)
    m = metrics_of(x, y, s, z, tau, kappa)[4]
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = torch.full((B,), RUNNING, dtype=torch.int32, device=dev)
    if o.show_progress:
        print("     pcost       dcost       gap    pres   dres   k/t")
    while bool((status == RUNNING).any()):
        live = status == RUNNING
        rx, ry, rz, rt, mm = metrics_of(x, y, s, z, tau, kappa)
        if o.show_progress:
            for i in torch.nonzero(live).flatten().tolist():
                print(f"{int(it[i]):2d}: {float(mm['pcost'][i]): .4e} "
                      f"{float(mm['dcost'][i]): .4e} "
                      f"{float(mm['gap'][i]): .0e} "
                      f"{float(mm['pres'][i]): .0e} "
                      f"{float(mm['dres'][i]): .0e} "
                      f"{float(kappa[i] / tau[i]): .0e}")
        converged = (mm["pres"] <= o.feastol) & (mm["dres"] <= o.feastol) & (
            (mm["gap"] <= o.abstol) | (torch.isfinite(mm["relgap"]) &
                                       (mm["relgap"] <= o.reltol)))
        new_status = torch.where(
            converged, OPTIMAL,
            torch.where(mm["pinfres"] <= o.feastol, PRIMAL_INFEASIBLE,
                        torch.where(mm["dinfres"] <= o.feastol,
                                    DUAL_INFEASIBLE,
                                    torch.where(it >= o.maxiters, UNKNOWN,
                                                RUNNING)))).to(torch.int32)
        stepping = live & (new_status == RUNNING)
        if bool(stepping.any()):
            xn, yn, sn, zn, tn, kn, st = do_step(x, y, s, z, tau, kappa,
                                                 rx, ry, rz, rt)
            x = xsp.where(stepping, xn, x)
            y = ysp.where(stepping, yn, y)
            s = _where(stepping, sn, s)
            z = _where(stepping, zn, z)
            tau = torch.where(stepping, tn, tau)
            kappa = torch.where(stepping, kn, kappa)
            new_status = torch.where(stepping, st, new_status)
        status = torch.where(live, new_status, status)
        it = torch.where(live, it + 1, it)
        m = {k: torch.where(live, mm[k], m[k]) for k in m}
    return x, y, s, z, tau, kappa, it, status, m


def _conelp_result(state, c, h, b, dims, lane=0, xsp=LANES, ysp=LANES):
    """The reference's result dict for one lane of a conelp state: the
    iterates scaled by 1/tau, or the certificate scaled to h'z + b'y = -1
    ('primal infeasible') or c'x = -1 ('dual infeasible'), with None
    where the reference has it; xsp and ysp as in _conelp_core."""
    x, y = xsp.lane(state[0], lane), ysp.lane(state[1], lane)
    s, z, tau, _, it = (a[lane] for a in state[2:7])
    status = int(state[7][lane])
    m = {k: float(v[lane]) for k, v in state[8].items()}
    c, b, h = xsp.lane(c, lane), ysp.lane(b, lane), h[lane]
    p = ysp.size(b)

    res = {"status": _STATUS_STR.get(status, "unknown"),
           "iterations": int(it) - 1}
    metrics = {
        "primal objective": m["pcost"],
        "dual objective": m["dcost"],
        "gap": m["gap"],
        "relative gap": m["relgap"] if math.isfinite(m["relgap"]) else None,
        "primal infeasibility": m["pres"],
        "dual infeasibility": m["dres"],
        "residual as primal infeasibility certificate":
            m["pinfres"] if math.isfinite(m["pinfres"]) else None,
        "residual as dual infeasibility certificate":
            m["dinfres"] if math.isfinite(m["dinfres"]) else None,
    }
    if status == PRIMAL_INFEASIBLE:
        hz_by = float(cones.sdot(dims, h, z) +
                      (ysp.dot1(b, y) if p else 0.0))
        scale_cert = -1.0 / hz_by
        zc = z * scale_cert
        res.update(x=None, s=None, y=ysp.scal1(scale_cert, y), z=zc)
        metrics.update({"primal objective": None, "gap": None,
                        "relative gap": None,
                        "dual objective": 1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "primal slack": None,
                        "dual slack": -float(cones.max_step(dims,
                                                            zc[None])[0])})
    elif status == DUAL_INFEASIBLE:
        scale_cert = -1.0 / float(xsp.dot1(c, x))
        sc = s * scale_cert
        res.update(x=xsp.scal1(scale_cert, x), s=sc, y=None, z=None)
        metrics.update({"dual objective": None, "gap": None,
                        "relative gap": None,
                        "primal objective": -1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "dual slack": None,
                        "primal slack": -float(cones.max_step(dims,
                                                              sc[None])[0])})
    else:
        tauf = float(tau)
        res.update(x=xsp.scal1(1.0 / tauf, x), s=s / tauf,
                   y=ysp.scal1(1.0 / tauf, y), z=z / tauf)
        ts, tz = cones.max_step2(dims, s[None], z[None])
        metrics["primal slack"] = -float(ts[0]) / tauf
        metrics["dual slack"] = -float(tz[0]) / tauf
    res.update(metrics)
    return res


def _inv_step(dims, lmbda, ds_w, dz_w):
    """max(ts, tz, 0): reciprocal of the max feasible cone step (one
    eigenvalue call per s group for both directions)."""
    ts, tz = cones.max_step2(dims, cones.scale2(dims, lmbda, ds_w),
                             cones.scale2(dims, lmbda, dz_w))
    return torch.clamp(torch.maximum(ts, tz), min=0.0)


def _tk_step(tau, kappa, dt, dk):
    """max feasible step keeping tau, kappa > 0."""
    inf = torch.full_like(tau, math.inf)
    return torch.minimum(torch.where(dt < 0, -tau / dt, inf),
                         torch.where(dk < 0, -kappa / dk, inf))


# ---------------------------------------------------------------------------
# Natural-form wrappers (reference coneprog.py lp:2550, socp:3044, sdp:3597)
# ---------------------------------------------------------------------------


def _ruiz_equilibrate(c, G, h, A, b, iters=6):
    """Ruiz equilibration of an LP (numpy): returns scaled data plus the
    row/col scalings (dr, dra, dc) with G' = diag(dr) G diag(dc).
    l-cone only."""
    G = np.asarray(G, dtype=float)
    c = np.asarray(c, dtype=float).reshape(-1)
    h = np.asarray(h, dtype=float).reshape(-1)
    m, n = G.shape
    Aa = np.asarray(A, dtype=float).reshape(-1, n) if A is not None \
        else np.zeros((0, n))
    dr = np.ones(m)
    dra = np.ones(Aa.shape[0])
    dc = np.ones(n)
    Gs, As = G.copy(), Aa.copy()
    for _ in range(iters):
        rmax = np.maximum(np.abs(Gs).max(axis=1), 1e-12)
        ramax = np.maximum(np.abs(As).max(axis=1), 1e-12) \
            if len(As) else np.ones(0)
        stacked = np.vstack([Gs, As]) if len(As) else Gs
        cmax = np.maximum(np.abs(stacked).max(axis=0), 1e-12)
        sr = 1.0 / np.sqrt(rmax)
        sra = 1.0 / np.sqrt(ramax)
        sc = 1.0 / np.sqrt(cmax)
        Gs = Gs * sr[:, None] * sc[None, :]
        if len(As):
            As = As * sra[:, None] * sc[None, :]
        dr *= sr
        dra *= sra
        dc *= sc
    return (c * dc, Gs, h * dr,
            As if A is not None else None,
            (np.asarray(b, dtype=float).reshape(-1) * dra
             if b is not None else None),
            dr, dra, dc)


# ---------------------------------------------------------------------------
# The solver= routes' result mappers (numpy on the host, as in the JAX
# package)
# ---------------------------------------------------------------------------


def _np_slack(s, ml, mq):
    """-max_step over an l/q cone layout: min margin to the boundary
    (reference misc.max_step via coneprog.py:2965-2966)."""
    vals = []
    if ml:
        vals.append(np.min(s[:ml]))
    ofs = ml
    for k in mq:
        blk = s[ofs:ofs + k]
        vals.append(blk[0] - np.linalg.norm(blk[1:]))
        ofs += k
    return float(min(vals)) if vals else None


def _bridge_cone_result(status, x, z, y, c, G, h, A, b, ml, mq, P=None):
    """Map a generic bridge return (status string, x, z, y) onto the
    reference's solution dict — the shared result math of the reference's
    external-solver dispatch (coneprog.py:4427-4560, same computations for
    gurobi as for mosek)."""
    c = np.asarray(c, dtype=float).reshape(-1)
    h = (np.asarray(h, dtype=float).reshape(-1) if h is not None
         else np.zeros(0))
    Gm = (np.asarray(G, dtype=float).reshape(len(h), -1) if G is not None
          else np.zeros((0, len(c))))
    n = len(c)
    Am = (np.asarray(A, dtype=float).reshape(-1, n)
          if A is not None else np.zeros((0, n)))
    bv = (np.asarray(b, dtype=float).reshape(-1)
          if b is not None else np.zeros(0))
    Pm = (np.asarray(P, dtype=float).reshape(n, n)
          if P is not None else None)
    resx0 = max(1.0, np.linalg.norm(c))
    resy0 = max(1.0, np.linalg.norm(bv))
    resz0 = max(1.0, np.linalg.norm(h))
    sol = dict.fromkeys((
        "x", "s", "y", "z", "primal objective", "dual objective", "gap",
        "relative gap", "primal infeasibility", "dual infeasibility",
        "residual as primal infeasibility certificate",
        "residual as dual infeasibility certificate",
        "primal slack", "dual slack"))
    sol["status"] = status
    if status != "optimal" or x is None:
        return sol
    xv = np.asarray(x, dtype=float).reshape(-1)
    zv = (np.asarray(z, dtype=float).reshape(-1) if z is not None
          else np.zeros(len(h)))
    yv = (np.asarray(y, dtype=float).reshape(-1) if y is not None
          else np.zeros(Am.shape[0]))
    sv = h - Gm @ xv
    quad = 0.5 * xv @ Pm @ xv if Pm is not None else 0.0
    pcost = float(c @ xv + quad)
    dcost = float(-h @ zv - bv @ yv - quad)
    gap = float(sv @ zv)
    rx = c + Gm.T @ zv + Am.T @ yv
    if Pm is not None:
        rx = rx + Pm @ xv
    resx = np.linalg.norm(rx) / resx0
    resy = np.linalg.norm(bv - Am @ xv) / resy0
    resz = np.linalg.norm(Gm @ xv + sv - h) / resz0
    sol.update({
        "x": xv, "s": sv, "y": yv, "z": zv,
        "primal objective": pcost, "dual objective": dcost,
        "gap": gap,
        "relative gap": (gap / -pcost if pcost < 0.0 else
                         gap / dcost if dcost > 0.0 else None),
        "primal infeasibility": float(max(resy, resz)),
        "dual infeasibility": float(resx),
        "primal slack": _np_slack(sv, ml, mq),
        "dual slack": _np_slack(zv, ml, mq)})
    return sol


def _mosek_cone_result(solsta, x, z, y, c, G, h, A, b, ml, mq, P=None):
    """Map a MOSEK bridge return (solsta, x, z, y) onto the reference's
    solution dict, including residuals, slacks, and scaled infeasibility
    certificates (reference coneprog.py:2923-3036 for lp, :4432-4560 for
    qp, :3399-3520 for socp)."""
    import mosek

    c = np.asarray(c, dtype=float).reshape(-1)
    h = np.asarray(h, dtype=float).reshape(-1)
    Gm = np.asarray(G, dtype=float).reshape(len(h), -1)
    m, n = Gm.shape
    Am = (np.asarray(A, dtype=float).reshape(-1, n)
          if A is not None else np.zeros((0, n)))
    bv = (np.asarray(b, dtype=float).reshape(-1)
          if b is not None else np.zeros(0))
    Pm = (np.asarray(P, dtype=float).reshape(n, n)
          if P is not None else None)
    resx0 = max(1.0, np.linalg.norm(c))
    resy0 = max(1.0, np.linalg.norm(bv))
    resz0 = max(1.0, np.linalg.norm(h))
    sol = dict.fromkeys((
        "x", "s", "y", "z", "primal objective", "dual objective", "gap",
        "relative gap", "primal infeasibility", "dual infeasibility",
        "residual as primal infeasibility certificate",
        "residual as dual infeasibility certificate",
        "primal slack", "dual slack"))

    near_opt = getattr(mosek.solsta, "near_optimal", None)
    if solsta in (mosek.solsta.optimal, near_opt):
        sol["status"] = ("optimal" if solsta is mosek.solsta.optimal
                         else "near optimal")
        xv = np.asarray(x, dtype=float).reshape(-1)
        zv = np.asarray(z, dtype=float).reshape(-1)
        yv = (np.asarray(y, dtype=float).reshape(-1)
              if y is not None else np.zeros(0))
        sv = h - Gm @ xv
        quad = 0.5 * xv @ Pm @ xv if Pm is not None else 0.0
        pcost = float(c @ xv + quad)
        dcost = float(-h @ zv - bv @ yv - quad)
        gap = float(sv @ zv)
        rx = c + Gm.T @ zv + Am.T @ yv
        if Pm is not None:
            rx = rx + Pm @ xv
        resx = np.linalg.norm(rx) / resx0
        resy = np.linalg.norm(bv - Am @ xv) / resy0
        resz = np.linalg.norm(Gm @ xv + sv - h) / resz0
        sol.update({
            "x": xv, "s": sv, "y": yv, "z": zv,
            "primal objective": pcost, "dual objective": dcost,
            "gap": gap,
            "relative gap": (gap / -pcost if pcost < 0.0 else
                             gap / dcost if dcost > 0.0 else None),
            "primal infeasibility": float(max(resy, resz)),
            "dual infeasibility": float(resx),
            "primal slack": _np_slack(sv, ml, mq),
            "dual slack": _np_slack(zv, ml, mq)})
    elif solsta is mosek.solsta.prim_infeas_cer:
        sol["status"] = "primal infeasible"
        zv = np.asarray(z, dtype=float).reshape(-1)
        yv = (np.asarray(y, dtype=float).reshape(-1)
              if y is not None else np.zeros(0))
        scal = 1.0 / (-h @ zv - bv @ yv)
        zv, yv = zv * scal, yv * scal
        sol.update({
            "y": yv, "z": zv, "dual objective": 1.0,
            "residual as primal infeasibility certificate": float(
                np.linalg.norm(-Am.T @ yv - Gm.T @ zv) / resx0),
            "dual slack": _np_slack(zv, ml, mq)})
    elif solsta == mosek.solsta.dual_infeas_cer:
        sol["status"] = "dual infeasible"
        xv = np.asarray(x, dtype=float).reshape(-1)
        xv = xv * (-1.0 / float(c @ xv))
        sv = -Gm @ xv
        resy = np.linalg.norm(Am @ xv) / resy0
        resz = np.linalg.norm(Gm @ xv + sv) / resz0
        sol.update({
            "x": xv, "s": sv, "primal objective": -1.0,
            "residual as dual infeasibility certificate": float(
                max(resy, resz)),
            "primal slack": _np_slack(sv, ml, mq)})
    else:
        sol["status"] = "unknown"
    return sol


def _dsdp_result(dsdpstatus, x, zl, zs, c, Gl, hl, Gs, hs):
    """Full result-dict mapping for solvers.sdp(solver='dsdp') — the
    reference's DSDP branch (coneprog.py:3924-4113): status translation,
    certificate scaling, residuals, slacks, and the complete key set."""
    c = np.asarray(c, dtype=float).reshape(-1)
    n = len(c)
    ml = 0 if hl is None else int(np.asarray(hl).size)
    Glm = (np.asarray(Gl, dtype=float).reshape(ml, n) if ml
           else np.zeros((0, n)))
    hlv = (np.asarray(hl, dtype=float).reshape(-1) if ml
           else np.zeros(0))
    Gs = Gs or []
    hs = hs or []
    ms = [int(np.asarray(hk).shape[0]) for hk in hs]
    Gsm = [np.asarray(Gk, dtype=float).reshape(m * m, n)
           for Gk, m in zip(Gs, ms)]
    hsm = [np.asarray(hk, dtype=float).reshape(m, m)
           for hk, m in zip(hs, ms)]

    resx0 = max(1.0, np.linalg.norm(c))
    rh = [np.linalg.norm(hlv)] + [np.linalg.norm(hk) for hk in hsm]
    resz0 = max(1.0, np.linalg.norm(rh))

    def _slack(sl_, ss_):
        vals = ([float(np.min(sl_))] if ml else []) + \
            [float(np.linalg.eigvalsh(0.5 * (S + S.T))[0]) for S in ss_]
        return min(vals) if vals else None

    def _gxT(zl_, zs_):
        """G'z over the l/s blocks (full symmetric storage)."""
        out = (Glm.T @ zl_ if ml else np.zeros(n))
        for Gk, Z in zip(Gsm, zs_):
            out = out + Gk.T @ Z.reshape(-1)
        return out

    def _gx(x_):
        """(Gl x, [mat(Gs_k x)])"""
        sl_ = Glm @ x_ if ml else np.zeros(0)
        ss_ = [(Gk @ x_).reshape(m, m) for Gk, m in zip(Gsm, ms)]
        return sl_, ss_

    keys = ("x", "sl", "ss", "y", "zl", "zs", "primal objective",
            "dual objective", "gap", "relative gap",
            "primal infeasibility", "dual infeasibility",
            "residual as primal infeasibility certificate",
            "residual as dual infeasibility certificate",
            "primal slack", "dual slack")
    sol = dict.fromkeys(keys)

    if dsdpstatus == "DSDP_UNBOUNDED":
        sol["status"] = "dual infeasible"
        xv = np.asarray(x, dtype=float).reshape(-1)
        xv = xv * (-1.0 / float(c @ xv))
        sl_, ss_ = _gx(xv)
        sl_, ss_ = -sl_, [-0.5 * (S + S.T) for S in ss_]
        glx, gsx = _gx(xv)
        rz = np.concatenate([glx + sl_] +
                            [(S + gs).reshape(-1)
                             for S, gs in zip(ss_, gsx)]) \
            if (ml or ms) else np.zeros(0)
        sol.update({
            "x": xv, "sl": sl_, "ss": ss_, "primal objective": -1.0,
            "residual as dual infeasibility certificate":
                float(np.linalg.norm(rz) / resz0),
            "primal slack": _slack(sl_, ss_)})
        return sol

    if dsdpstatus == "DSDP_INFEASIBLE":
        sol["status"] = "primal infeasible"
        zlv = (np.asarray(zl, dtype=float).reshape(-1) if ml
               else np.zeros(0))
        zsv = [np.asarray(Z, dtype=float).reshape(m, m)
               for Z, m in zip(zs or [], ms)]
        hz = float(hlv @ zlv) + sum(
            float(np.sum(hk * Z)) for hk, Z in zip(hsm, zsv))
        scal = 1.0 / (-hz)
        zlv = zlv * scal
        zsv = [0.5 * (Z + Z.T) * scal for Z in zsv]
        rx = -_gxT(zlv, zsv)
        sol.update({
            "y": np.zeros(0), "zl": zlv, "zs": zsv,
            "dual objective": 1.0,
            "residual as primal infeasibility certificate":
                float(np.linalg.norm(rx) / resx0),
            "dual slack": _slack(zlv, zsv)})
        return sol

    sol["status"] = ("optimal" if dsdpstatus == "DSDP_PDFEASIBLE"
                     else "unknown")
    if x is None or zl is None and ml:
        return sol
    xv = np.asarray(x, dtype=float).reshape(-1)
    zlv = (np.asarray(zl, dtype=float).reshape(-1) if ml
           else np.zeros(0))
    zsv = [0.5 * (np.asarray(Z, dtype=float).reshape(m, m) +
                  np.asarray(Z, dtype=float).reshape(m, m).T)
           for Z, m in zip(zs or [], ms)]
    glx, gsx = _gx(xv)
    sl_ = hlv - glx
    ss_ = [0.5 * ((hk - gs) + (hk - gs).T) for hk, gs in zip(hsm, gsx)]
    pcost = float(c @ xv)
    dcost = -float(hlv @ zlv) - sum(
        float(np.sum(hk * Z)) for hk, Z in zip(hsm, zsv))
    gap = float(sl_ @ zlv) + sum(
        float(np.sum(S * Z)) for S, Z in zip(ss_, zsv))
    relgap = (gap / -pcost if pcost < 0.0 else
              gap / dcost if dcost > 0.0 else None)
    rx = c + _gxT(zlv, zsv)
    resx = float(np.linalg.norm(rx) / resx0)
    rz = np.concatenate(
        [glx + sl_ - hlv] +
        [(gs + S - hk).reshape(-1)
         for gs, S, hk in zip(gsx, ss_, hsm)]) if (ml or ms) else \
        np.zeros(0)
    resz = float(np.linalg.norm(rz) / resz0)
    pinfres = dinfres = None
    if sol["status"] != "optimal" and dcost > 0.0:
        pinfres = float(np.linalg.norm(_gxT(zlv, zsv)) / resx0 / dcost)
    if sol["status"] != "optimal" and pcost < 0.0:
        rzc = np.concatenate(
            [glx + sl_] + [(gs + S).reshape(-1)
                           for gs, S in zip(gsx, ss_)])
        dinfres = float(np.linalg.norm(rzc) / resz0 / -pcost)
    sol.update({
        "x": xv, "sl": sl_, "ss": ss_, "y": np.zeros(0),
        "zl": zlv, "zs": zsv,
        "primal objective": pcost, "dual objective": dcost,
        "gap": gap, "relative gap": relgap,
        "primal infeasibility": resz, "dual infeasibility": resx,
        "residual as primal infeasibility certificate": pinfres,
        "residual as dual infeasibility certificate": dinfres,
        "primal slack": _slack(sl_, ss_),
        "dual slack": _slack(zlv, zsv)})
    return sol


def _host(a):
    """numpy copy of an array-like or tensor (None stays None)."""
    if a is None or not isinstance(a, torch.Tensor):
        return a
    return a.detach().cpu().numpy()


def _on_host(*args):
    """The data of a solver= route on the host: tensors (on any device)
    as numpy arrays, lists of them item by item, the rest as given."""
    return [[_host(a) for a in v] if isinstance(v, (list, tuple))
            else _host(v) for v in args]


def _qp_route(solver, P, q, G, h, A, b, options):
    """qp(solver='osqp' | 'gurobi' | 'mosek'): the JAX package's branches
    (its solvers/coneprog.py qp) on host data; osqp runs on the data's
    device."""
    if solver == "osqp":
        from .. import osqp as _osqp
        with config.using_device(_solve_device(q, G, h, A, b, P)):
            return _osqp.qp_bridge(*_on_host(P, q, G, h, A, b),
                                   options=options)
    P, q, G, h, A, b = _on_host(P, q, G, h, A, b)
    ml = 0 if h is None else np.asarray(h).size
    if solver == "gurobi":
        from .. import gurobi as _gurobi
        opts = (options or {}).get("gurobi")
        status, x, z, y = _gurobi.qp(q, G, h, A, b, P, options=opts)
        return _bridge_cone_result(status, x, z, y, q, G, h, A, b,
                                   ml, [], P=P)
    from .. import msk
    opts = (options or {}).get("mosek")
    if opts:
        solsta, x, z, y = msk.qp(P, q, G, h, A, b, options=opts)
    else:
        solsta, x, z, y = msk.qp(P, q, G, h, A, b)
    return _mosek_cone_result(solsta, x, z, y, q, G, h, A, b, ml, [], P=P)


def lp(c, G, h, A=None, b=None, solver=None, primalstart=None,
       dualstart=None, kktsolver=None, options=None):
    """LP: minimize c'x s.t. Gx <= h, Ax = b.  `solver` accepts None
    (native conelp), 'glpk' (HiGHS-backed bridge), 'osqp' (the ADMM of
    osqp.py, on the data's device as the native route), 'gurobi' or
    'mosek' (requiring their packages): the reference's dispatch contract
    (coneprog.py:2807-2838).  The routes other than the native one take
    their data to the host and return its numpy result dictionary.  With
    options['equilibrate'] the native route Ruiz-scales the LP first and
    unscales the iterates after.  The native route runs on the CPU where
    the KKT system's order is below config.host_dispatch_threshold, as
    conelp does."""
    if solver == "glpk":
        from .. import glpk
        return glpk.lp_bridge(*_on_host(c, G, h, A, b), options=options)
    if solver == "osqp":
        from .. import osqp as _osqp
        with config.using_device(_solve_device(c, G, h, A, b)):
            return _osqp.qp_bridge(None, *_on_host(c, G, h, A, b),
                                   options=options)
    if solver == "gurobi":
        # reference coneprog.py:2834-2845: LP through gurobi.qp with P=None
        from .. import gurobi as _gurobi
        c, G, h, A, b = _on_host(c, G, h, A, b)
        opts = (options or {}).get("gurobi")
        status, x, z, y = _gurobi.qp(c, G, h, A, b, None, options=opts)
        ml = np.asarray(h).size
        return _bridge_cone_result(status, x, z, y, c, G, h, A, b, ml, [])
    if solver == "mosek":
        from .. import msk
        c, G, h, A, b = _on_host(c, G, h, A, b)
        opts = (options or {}).get("mosek")
        if opts:
            solsta, x, z, y = msk.lp(c, G, h, A, b, options=opts)
        else:
            solsta, x, z, y = msk.lp(c, G, h, A, b)
        hv = np.asarray(h, dtype=float).reshape(-1)
        return _mosek_cone_result(solsta, x, z, y, c, G, h, A, b,
                                  len(hv), [])
    ml = int(_numel(h))
    if options and options.get("equilibrate"):
        # Ruiz presolve for badly scaled LPs: solve the scaled problem on
        # the solve's device, then unscale the iterates
        with _dispatch_ctx(_kkt_order(_veclen(c), _veclen(h), _veclen(b))):
            dev = _solve_device(c, G, h, A, b)
        scaled = _ruiz_equilibrate(*(_host(a) for a in (c, G, h, A, b)))
        cs, Gs, hs, As, bs = (None if a is None else
                              torch.as_tensor(a, device=dev)
                              for a in scaled[:5])
        dr, dra, dc = scaled[5:]
        opts2 = {k: v for k, v in options.items() if k != "equilibrate"}
        sol = dict(conelp(cs, Gs, hs, {"l": ml}, As, bs,
                          kktsolver=kktsolver, options=opts2))
        for key, d, mul in (("x", dc, True), ("s", dr, False),
                            ("z", dr, True), ("y", dra, True)):
            v = sol.get(key)
            if v is None or (key == "y" and A is None):
                continue
            d = torch.as_tensor(d, dtype=v.dtype, device=v.device)
            sol[key] = v.reshape(-1) * d if mul else v.reshape(-1) / d
        return sol
    return conelp(c, G, h, {"l": ml}, A, b, primalstart=primalstart,
                  dualstart=dualstart, kktsolver=kktsolver, options=options)


def _stack_blocks(dtype, dev, Gl, hl, Gk, hk, rows):
    """G and h of the cone program stacked from the natural form's
    blocks: Gl (ml, n) and hl (ml,), then each block's G reshaped to
    rows(h_k) x n and its h flattened in row-major order.  Returns
    (G, h, ml, block sizes)."""
    Gs, hs, sizes = [], [], []
    ml = 0
    if Gl is not None:
        hl = _asarray(hl, dtype, dev).reshape(-1)
        ml = hl.shape[0]
        Gs.append(_asarray(Gl, dtype, dev).reshape(ml, -1))
        hs.append(hl)
    for G_, h_ in zip(Gk, hk):
        h_ = _asarray(h_, dtype, dev)
        k = rows(h_)
        Gs.append(_asarray(G_, dtype, dev).reshape(h_.numel(), -1))
        hs.append(h_.reshape(-1))
        sizes.append(k)
    return torch.cat(Gs), torch.cat(hs), ml, tuple(sizes)


def _split(sol, ml, shapes, names):
    """Split the stacked s and z of a result back into the natural form:
    key + names[0] the l part, key + names[1] the list of blocks of the
    given shapes."""
    for key in ("z", "s"):
        v = sol.get(key)
        if v is None:
            continue
        parts, ofs = [], ml
        for shape in shapes:
            w = math.prod(shape)
            parts.append(v[ofs:ofs + w].reshape(shape))
            ofs += w
        sol[key + names[0]], sol[key + names[1]] = v[:ml], parts
    return sol


def _socp_mosek(c, Gl, hl, Gq, hq, A, b, options):
    """socp(solver='mosek') on host data (the JAX package's branch)."""
    from .. import msk
    opts = (options or {}).get("mosek")
    if opts:
        solsta, x, zl, zq = msk.socp(c, Gl, hl, Gq, hq, options=opts)
    else:
        solsta, x, zl, zq = msk.socp(c, Gl, hl, Gq, hq)
    ml = 0 if hl is None else np.asarray(hl).size
    mq = [np.asarray(hk).size for hk in (hq or [])]
    Gfull = np.vstack(
        ([np.asarray(Gl, dtype=float).reshape(ml, -1)] if ml else [])
        + [np.asarray(Gk, dtype=float).reshape(mk, -1)
           for Gk, mk in zip(Gq or [], mq)])
    hfull = np.concatenate(
        ([np.asarray(hl, dtype=float).reshape(-1)] if ml else [])
        + [np.asarray(hk, dtype=float).reshape(-1) for hk in (hq or [])])
    z = (np.concatenate([np.asarray(zl).reshape(-1)]
                        + [np.asarray(zk).reshape(-1) for zk in zq])
         if zl is not None else None)
    sol = _mosek_cone_result(solsta, x, z, None, c, Gfull, hfull,
                             A, b, ml, mq)
    # split the stacked s/z back into the socp natural form
    # (reference coneprog.py:3470-3490)
    for key, parts in (("s", ("sl", "sq")), ("z", ("zl", "zq"))):
        v = sol.pop(key)
        if v is None:
            sol[parts[0]], sol[parts[1]] = None, None
        else:
            sol[parts[0]] = v[:ml]
            blocks, ofs = [], ml
            for k in mq:
                blocks.append(v[ofs:ofs + k])
                ofs += k
            sol[parts[1]] = blocks
    return sol


def socp(c, Gl=None, hl=None, Gq=None, hq=None, A=None, b=None,
         solver=None, primalstart=None, dualstart=None, kktsolver=None,
         options=None):
    """SOCP in natural form: minimize c'x s.t. Gl x <= hl plus
    second-order cone blocks s_k = h_k - G_k x in Q (reference
    coneprog.py:3044).  The result holds zl/zq and sl/sq beside z and s.
    solver='mosek' dispatches to the MOSEK bridge (requires the mosek
    package) on the host, as the reference (coneprog.py:3363).  The native
    route picks its device as conelp does (coneprog._dispatch_ctx on the
    KKT system's order: len(c), the rows of hl and hq, len(b)) before it
    stacks the blocks."""
    if solver == "mosek":
        return _socp_mosek(*_on_host(c, Gl, hl, Gq, hq, A, b), options)
    dtype = _resolve_options(options)[1]
    Gq, hq = list(Gq or []), list(hq or [])
    with _dispatch_ctx(_kkt_order(_veclen(c), _veclen(hl), _veclen(b),
                                  *map(_veclen, hq))):
        dev = _solve_device(c, Gl, hl, *Gq, *hq, A, b)
    G, h, ml, sizes = _stack_blocks(dtype, dev, Gl, hl, Gq, hq,
                                    lambda h_: h_.numel())
    sol = dict(conelp(c, G, h, ConeDims(l=ml, q=sizes), A, b,
                      primalstart=primalstart, dualstart=dualstart,
                      kktsolver=kktsolver, options=options))
    return _split(sol, ml, [(k,) for k in sizes], ("l", "q"))


def sdp(c, Gl=None, hl=None, Gs=None, hs=None, A=None, b=None,
        solver=None, primalstart=None, dualstart=None, kktsolver=None,
        options=None):
    """SDP in natural form: minimize c'x s.t. Gl x <= hl and
    sum_i x_i (Gs[k] column i, reshaped) <= hs[k] in the PSD order
    (reference coneprog.py:3597; Gs[k] columns are vectorized coefficient
    matrices, hs[k] square matrices).  The result holds zl/zs and sl/ss
    (m x m blocks) beside z and s.  solver='dsdp' routes through the
    DSDP-interface bridge on the host (reference coneprog.py:3924).  The
    native route picks its device as conelp does (coneprog._dispatch_ctx
    on the KKT system's order: len(c), the rows of hl, the entries of
    each hs block, len(b)) before it stacks the blocks."""
    if solver == "dsdp":
        if A is not None:
            raise ValueError("sdp() with the solver = 'dsdp' option does "
                             "not handle problems with equality "
                             "constraints")
        from .. import dsdp as _dsdp
        from . import options as global_options
        c, Gl, hl, Gs, hs = _on_host(c, Gl, hl, Gs, hs)
        # solvers.options['dsdp'] (reference coneprog.py:3930) merged
        # under per-call options; solvers.sdp callers expect
        # conelp-level accuracy from every route, so tighten the
        # dual-scaling gap beyond the DSDP interface default (1e-5)
        # unless the user set it explicitly
        dopts = dict(global_options.get("dsdp") or {})
        dopts.update((options or {}).get("dsdp") or {})
        dopts.setdefault("DSDP_GapTolerance", 1e-8)
        status, x, r, zl, zs = _dsdp.sdp(c, Gl, hl, Gs, hs,
                                         options=dopts)
        return _dsdp_result(status, x, zl, zs, c, Gl, hl, Gs, hs)
    dtype = _resolve_options(options)[1]
    Gs, hs = list(Gs or []), list(hs or [])
    with _dispatch_ctx(_kkt_order(_veclen(c), _veclen(hl), _veclen(b),
                                  *map(_veclen, hs))):
        dev = _solve_device(c, Gl, hl, *Gs, *hs, A, b)
    G, h, ml, sizes = _stack_blocks(dtype, dev, Gl, hl, Gs, hs,
                                    lambda h_: h_.shape[0])
    sol = dict(conelp(c, G, h, ConeDims(l=ml, s=sizes), A, b,
                      primalstart=primalstart, dualstart=dualstart,
                      kktsolver=kktsolver, options=options))
    return _split(sol, ml, [(k, k) for k in sizes], ("l", "s"))
