"""conelp: cone LPs by the extended self-dual embedding, and the
natural-form wrappers lp/socp/sdp.

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

from .. import cones
from ..cones import ConeDims
from .coneprog import (
    RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR,
    _STATUS_STR, STEP, EXPON, Options, _asarray, _constraints,
    _front_end_ops, _numel, _refuse_solver, _refuse_vector_spaces, _relgap,
    _resolve_options, _solve_device, _where)


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
    the iteration."""
    _refuse_vector_spaces(xnewcopy, xdot, xscal, xaxpy, ynewcopy, ydot,
                          yscal, yaxpy)
    o, dtype = _resolve_options(options)
    dev = _solve_device(c, h, G, A, b)
    c = _asarray(c, dtype, dev, name="c")
    n = c.shape[0]
    dims, h, b, Ga, Aa = _constraints(G, h, dims, A, b, n, dtype, dev)
    if kktsolver is None:
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    o = o.resolve_refinement(dims, kktsolver)
    factor, gmv, amv, _ = _front_end_ops(dims, o, kktsolver, (G, A, None),
                                         (Ga, Aa, None))

    def start(vec):
        return _asarray(vec, dtype, dev)[None]
    ps = None
    if primalstart is not None:
        ps = (start(primalstart["x"]), start(primalstart["s"]))
    dst = None
    if dualstart is not None:
        y0 = dualstart.get("y")
        dst = (b.new_zeros((1, 0)) if y0 is None else start(y0),
               start(dualstart["z"]))
    state = _conelp_core(c[None], h, b, dims, o, factor, gmv, amv, ps, dst)
    return _conelp_result(state, c[None], h, b, dims)


def _conelp_core(c, h, b, dims, o: Options, factor, gmv, amv,
                 primalstart=None, dualstart=None):
    """Batched conelp driver: c (B, n), h (B, m), b (B, p), `factor(W)` a
    KKT strategy over the batch, gmv/amv batched operator products;
    primalstart (x, s) and dualstart (y, z), each (B, .), if given.
    Returns the final state (x, y, s, z, tau, kappa, iterations, status,
    metrics), metrics a dict of (B,) tensors: pcost, dcost, gap, relgap,
    pres, dres, pinfres, dinfres."""
    B, dtype, dev = c.shape[0], c.dtype, c.device
    p = b.shape[-1]
    deg = dims.degree
    e = cones.cone_e(dims, dtype, dev)

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    def col(t):
        return t[:, None]

    resx0 = torch.clamp(norm(c), min=1.0)
    resy0 = torch.clamp(norm(b), min=1.0)
    resz0 = torch.clamp(cones.snrm2(dims, h), min=1.0)

    def shift(u, t):
        """u + (1 + t) e where max_step t says u is not inside."""
        return _where(t >= -1e-8 * torch.clamp(torch.abs(t), min=1.0),
                      u + col(1.0 + t) * e, u)

    def initial_point():
        solve0 = factor(cones.identity_scaling(dims, B, dtype, dev))
        if primalstart is None:
            x0, _, z0p = solve0(torch.zeros_like(c), b, h)
            s0 = -z0p
        else:
            x0, s0 = primalstart
        if dualstart is None:
            _, y0, z0 = solve0(-c, torch.zeros_like(b), torch.zeros_like(h))
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
        rx = gmv(z, trans=True) + col(tau) * c
        if p:
            rx = amv(y, trans=True) + rx
        ry = amv(x) - col(tau) * b if p else b
        rz = gmv(x) + s - h * col(tau)
        rt = kappa + dot(c, x) + (dot(b, y) if p else 0.0) + \
            cones.sdot(dims, h, z)
        return rx, ry, rz, rt

    def metrics_of(x, y, s, z, tau, kappa):
        rx, ry, rz, rt = residuals(x, y, s, z, tau, kappa)
        gap = cones.sdot(dims, s, z) / (tau * tau)
        pcost = dot(c, x) / tau
        dcost = -(cones.sdot(dims, h, z) + (dot(b, y) if p else 0.0)) / tau
        pres = cones.snrm2(dims, rz) / resz0
        if p:
            pres = torch.maximum(norm(ry) / resy0, pres)
        pres = pres / tau
        dres = norm(rx) / resx0 / tau
        # infeasibility certificates
        inf = torch.full_like(tau, math.inf)
        hz_by = cones.sdot(dims, h, z) + (dot(b, y) if p else 0.0)
        cx = dot(c, x)
        hrx = gmv(z, trans=True)
        if p:
            hrx = amv(y, trans=True) + hrx
        pinfres = torch.where(hz_by < 0.0, norm(hrx) / resx0 / (-hz_by),
                              inf)
        dinf = cones.snrm2(dims, gmv(x) + s) / resz0
        if p:
            dinf = torch.maximum(norm(amv(x)) / resy0, dinf)
        dinfres = torch.where(cx < 0.0, dinf / (-cx), inf)
        return (rx, ry, rz, rt,
                dict(pcost=pcost, dcost=dcost, gap=gap,
                     relgap=_relgap(gap, pcost, dcost), pres=pres,
                     dres=dres, pinfres=pinfres, dinfres=dinfres))

    def f6_factory(solve, lmbda, W, tau, kappa):
        # (x1, y1, z1) = K^{-1}(-c, b, h), once per factorization
        x1, y1, z1 = solve(-c, b, h)
        dg = dot(c, x1) + (dot(b, y1) if p else 0.0) + \
            cones.sdot(dims, h, z1) - kappa / tau

        def f6_no_ir(bx, by, bz, bt, d_s, d_k):
            tmp = cones.sinv(dims, lmbda, d_s)
            xt, yt, zt = solve(bx, by,
                               bz - cones.scale(dims, W, tmp, trans=True))
            num = (bt - d_k / tau) - (dot(c, xt) +
                                      (dot(b, yt) if p else 0.0) +
                                      cones.sdot(dims, h, zt))
            dtau = num / dg
            dx = col(dtau) * x1 + xt
            dy = col(dtau) * y1 + yt if p else yt
            dz = zt + col(dtau) * z1
            ds = cones.scale(dims, W, tmp - cones.scale(dims, W, dz),
                             trans=True)
            dk = (d_k - kappa * dtau) / tau
            return dx, dy, dz, dtau, ds, dk

        def f6(bx, by, bz, bt, d_s, d_k):
            d = f6_no_ir(bx, by, bz, bt, d_s, d_k)
            for _ in range(o.refinement):
                dx, dy, dz, dtau, ds, dk = d
                t = gmv(dz, trans=True) + col(dtau) * c
                if p:
                    t = amv(dy, trans=True) + t
                r1 = bx - t
                r2 = by - (amv(dx) - col(dtau) * b) if p else by
                r3 = bz - (gmv(dx) + ds - h * col(dtau))
                r4 = bt - (dot(c, dx) + (dot(b, dy) if p else 0.0) +
                           cones.sdot(dims, h, dz) + dk)
                r5 = d_s - cones.sprod(
                    dims, lmbda,
                    cones.scale(dims, W, ds, trans=True, inverse=True) +
                    cones.scale(dims, W, dz), diag=True)
                r6 = d_k - (kappa * dtau + tau * dk)
                ex, ey, ez, et, es, ek = f6_no_ir(r1, r2, r3, r4, r5, r6)
                d = (ex + dx, ey + dy if p else dy, dz + ez, dtau + et,
                     ds + es, dk + ek)
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
            dx, dy, dz, dt, ds, dk = f6(col(-r) * rx, col(-r) * ry,
                                        col(-r) * rz, -r * rt, d_s, d_k)
            ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
            dz_w = cones.scale(dims, W, dz)
            t_cone = 1.0 / torch.clamp(_inv_step(dims, lmbda, ds_w, dz_w),
                                       min=1e-30)
            tlim = torch.minimum(t_cone, _tk_step(tau, kappa, dt, dk))
        step = torch.clamp(STEP * tlim, max=1.0)

        xn = col(step) * dx + x
        yn = col(step) * dy + y if p else y
        sn, zn = s + col(step) * ds, z + col(step) * dz
        tn, kn = tau + step * dt, kappa + step * dk
        bad = ~torch.isfinite(dot(xn, xn) + dot(sn, sn) + dot(zn, zn) +
                              tn + kn) | (tn <= 0)
        st = torch.where(bad, SINGULAR, RUNNING).to(torch.int32)
        return (_where(bad, x, xn), _where(bad, y, yn), _where(bad, s, sn),
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
            x = _where(stepping, xn, x)
            y = _where(stepping, yn, y)
            s = _where(stepping, sn, s)
            z = _where(stepping, zn, z)
            tau = torch.where(stepping, tn, tau)
            kappa = torch.where(stepping, kn, kappa)
            new_status = torch.where(stepping, st, new_status)
        status = torch.where(live, new_status, status)
        it = torch.where(live, it + 1, it)
        m = {k: torch.where(live, mm[k], m[k]) for k in m}
    return x, y, s, z, tau, kappa, it, status, m


def _conelp_result(state, c, h, b, dims, lane=0):
    """The reference's result dict for one lane of a conelp state: the
    iterates scaled by 1/tau, or the certificate scaled to h'z + b'y = -1
    ('primal infeasible') or c'x = -1 ('dual infeasible'), with None
    where the reference has it."""
    x, y, s, z, tau, _, it = (a[lane] for a in state[:7])
    status = int(state[7][lane])
    m = {k: float(v[lane]) for k, v in state[8].items()}
    c, h, b = c[lane], h[lane], b[lane]
    p = b.shape[0]

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
                      (torch.dot(b, y) if p else 0.0))
        scale_cert = -1.0 / hz_by
        zc = z * scale_cert
        res.update(x=None, s=None, y=y * scale_cert, z=zc)
        metrics.update({"primal objective": None, "gap": None,
                        "relative gap": None,
                        "dual objective": 1.0,
                        "primal infeasibility": None,
                        "dual infeasibility": None,
                        "primal slack": None,
                        "dual slack": -float(cones.max_step(dims,
                                                            zc[None])[0])})
    elif status == DUAL_INFEASIBLE:
        scale_cert = -1.0 / float(torch.dot(c, x))
        sc = s * scale_cert
        res.update(x=x * scale_cert, s=sc, y=None, z=None)
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
        res.update(x=x * (1.0 / tauf), s=s / tauf, y=y * (1.0 / tauf),
                   z=z / tauf)
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


def _host(a):
    """numpy copy of an array-like or tensor (None stays None)."""
    if a is None or not isinstance(a, torch.Tensor):
        return a
    return a.detach().cpu().numpy()


def lp(c, G, h, A=None, b=None, solver=None, primalstart=None,
       dualstart=None, kktsolver=None, options=None):
    """LP: minimize c'x s.t. Gx <= h, Ax = b, through conelp.  With
    options['equilibrate'] the LP is Ruiz-scaled first and the iterates
    unscaled after.  The routes solver='glpk', 'osqp', 'gurobi' and
    'mosek' are not ported yet."""
    _refuse_solver(solver, ("glpk", "osqp", "gurobi", "mosek"))
    ml = int(_numel(h))
    if options and options.get("equilibrate"):
        # Ruiz presolve for badly scaled LPs: solve the scaled problem on
        # the solve's device, then unscale the iterates
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


def socp(c, Gl=None, hl=None, Gq=None, hq=None, A=None, b=None,
         solver=None, primalstart=None, dualstart=None, kktsolver=None,
         options=None):
    """SOCP in natural form: minimize c'x s.t. Gl x <= hl plus
    second-order cone blocks s_k = h_k - G_k x in Q (reference
    coneprog.py:3044).  The result holds zl/zq and sl/sq beside z and s.
    solver='mosek' is not ported yet."""
    _refuse_solver(solver, ("mosek",))
    dtype = _resolve_options(options)[1]
    Gq, hq = list(Gq or []), list(hq or [])
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
    (m x m blocks) beside z and s.  solver='dsdp' is not ported yet."""
    _refuse_solver(solver, ("dsdp",))
    dtype = _resolve_options(options)[1]
    Gs, hs = list(Gs or []), list(hs or [])
    dev = _solve_device(c, Gl, hl, *Gs, *hs, A, b)
    G, h, ml, sizes = _stack_blocks(dtype, dev, Gl, hl, Gs, hs,
                                    lambda h_: h_.shape[0])
    sol = dict(conelp(c, G, h, ConeDims(l=ml, s=sizes), A, b,
                      primalstart=primalstart, dualstart=dualstart,
                      kktsolver=kktsolver, options=options))
    return _split(sol, ml, [(k, k) for k in sizes], ("l", "s"))
