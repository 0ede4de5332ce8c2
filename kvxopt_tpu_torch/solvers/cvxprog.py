"""Nonlinear convex optimization: cpl, cp and gp.

Counterpart of kvxopt_tpu/solvers/cvxprog.py (reference cvxprog.py: cpl
:35, cp :1359, gp :1967).  cpl solves

    minimize    c'x
    subject to  f(x) <= 0        (mnl smooth convex constraints)
                G x + s = h, s in K
                A x = b

given the reference's oracle contract (cvxprog.py:68-110):

    F()      -> (mnl, x0)
    F(x)     -> (f, Df)          (None if x is outside the domain of f)
    F(x, z)  -> (f, Df, H)       with H = sum_i z_i * d2f_i(x)

The nonlinear multipliers are scaled like extra 'l' entries
(dims.with_extra_l(mnl)), so the cone algebra and every KKT strategy of
the port serve unchanged.  `oracle_from_function` builds the whole
contract from a plain torch function by torch.func; gp's log-sum-exp
oracle is written out by hand.

The loop is eager Python, as in the JAX package: each iteration calls
the oracle.  Its state is a batch of one: cone vectors (1, m), x (1, n)
(or the user's element of a custom x-space), y (1, p), and the
Nesterov-Todd scaling of cones.compute_scaling, updated incrementally
from the scaled iterates each step (cones.update_scaling_inc).  The step
is a Mehrotra predictor-corrector with the reference's merit line search
(backtracking on phi = theta1*gap + theta2*||rx|| + theta3*||rznl||,
with the relaxed iterations of cvxprog.py:1080-1263).  The scalars that
steer it are read from the device together, one sync where the JAX loop
reads each alone.

If the condensed strategy's directions come out non-finite
(ops.chol_ls.cholesky_nan gives NaN where a factorization fails, as
jnp.linalg.cholesky does), the step is solved again with the
regularized full 3x3 `ldl` factorization, on the same device.

Each front end first sizes its solve from shape metadata: the order of
its KKT system, the variables (cpl: len(c), cp: len(x0) from F(), gp:
F's columns) plus the nonlinear rows, len(h) and len(b)
(coneprog._kkt_order).  Below config.host_dispatch_threshold it runs
the solve with config.default_device the CPU (coneprog._dispatch_ctx),
before any array is placed.  Array-like data goes to
config.default_device, tensors keep their device.
"""

from __future__ import annotations

import math

import torch

from .. import cones, config, kkt
from ..cones import ConeDims
from ..kkt import _mv, _tmv
from .coneprog import (
    OPTIMAL, UNKNOWN, SINGULAR, _STATUS_STR, STEP, EXPON, _AsGiven, _Lanes,
    _asarray, _dispatch_ctx, _instance_factor, _instance_op, _make_vecops,
    _kkt_order, _numel, _relgap, _resolve_options, _solve_device,
    _tree_leaves, _veclen)

# line-search constants (reference cvxprog.py:385-388)
BETA = 0.5
ALPHA = 0.01
MAX_RELAXED_ITERS = 8

# what a singular factorization or a user's kktsolver raises; any other
# error (a CUDA fault among them) propagates
_FACTOR_ERRORS = (torch.linalg.LinAlgError, ArithmeticError, ValueError)


def _tensor(a, dtype, device):
    return torch.as_tensor(a, dtype=dtype, device=device)


def oracle_from_function(f, x0, mnl=None):
    """A cpl/cp oracle from a plain torch function f(x) -> the vector of
    constraint values (a scalar counts as one): Df by torch.func.jacfwd,
    H = d2(z'f)/dx2 by torch.func.hessian.  f must be functional, as
    torch.func requires: no in-place updates of its input and no
    .item() or float() of a traced value.  x0 goes to the solve's
    device (config.default_device unless it is a tensor) in
    config.default_dtype.  mnl is accepted for the JAX signature and
    unused: the oracle reports the length of f(x0)."""
    x0 = _asarray(x0, config.default_dtype, _solve_device(x0), name="x0")
    fx0 = f(x0)
    m = int(fx0.shape[0]) if fx0.ndim else 1

    def fv(x):
        return torch.atleast_1d(f(x))
    jac = torch.func.jacfwd(fv)

    def oracle(x=None, z=None):
        if x is None:
            return m, x0
        x = torch.as_tensor(x, dtype=x0.dtype, device=x0.device)
        val, Df = fv(x), jac(x)
        if z is None:
            return val, Df
        z = torch.as_tensor(z, dtype=x0.dtype, device=x0.device)
        H = torch.func.hessian(lambda xx: torch.dot(z, fv(xx)))(x)
        return val, Df, H

    return oracle


def _matrix_op(M):
    """The batched products of a (1, r, k) matrix: M v, and M' v with
    trans=True."""
    def op(v, trans=False):
        return _tmv(M, v) if trans else _mv(M, v)
    return op


def _allfinite(*elements):
    leaves = [a for e in elements for a in _tree_leaves(e)]
    return bool(torch.stack([torch.isfinite(a).all() for a in leaves]).all())


def _floats(*values):
    """Python floats of numbers and of 0-d or one-lane tensors, the
    tensors read from the device in one transfer."""
    ts = [v.reshape(()) for v in values if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.to(ts[0].device, torch.float64)
                             for t in ts]).tolist() if ts else ())
    return [next(read) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


def cpl(c, F, G=None, h=None, dims=None, A=None, b=None, kktsolver=None,
        options=None, xnewcopy=None, xdot=None, xscal=None, xaxpy=None,
        ynewcopy=None, ydot=None, yscal=None, yaxpy=None):
    """Nonlinear cone program with a linear objective (reference
    cvxprog.py:35); returns the reference's result dict: status, x, y,
    snl, sl, znl, zl (tensors on the solve's device), the objectives,
    gap, relative gap, infeasibilities, slacks and iterations.

    G, h and dims as in coneqp: the s blocks of G and h are read from
    their lower triangle (column-major storage).  G and A may be
    operators G(u) / G(v, trans=True) with a custom kktsolver(W, H=None,
    Df=None) -> solve(bx, by, bz); W is one instance's scaling in the
    JAX package's layout over dims with mnl extra 'l' entries, H and Df
    are the oracle's, as it returned them.

    Custom vector spaces: passing any x*/y* hook makes x and c (and y
    and b) elements of the user's space, nested dicts, lists or tuples
    of tensors; G and A must then be operators, kktsolver a custom
    factor, and the oracle's Df and H operators: Df(u) maps x-space to
    R^mnl, Df(v, trans=True) back, H(u) x-space to x-space.

    Where the KKT system's order len(c) + mnl (F()[0]) + len(h) +
    len(b) is below config.host_dispatch_threshold (unknown with custom
    spaces or an operator G), array-like inputs go to the CPU before any
    is placed (coneprog._dispatch_ctx); cp and gp reach cpl through their
    own routing."""
    custom = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy,
                                         ynewcopy, ydot, yscal, yaxpy))
    order = None
    if not (custom or callable(G)):
        try:
            mnl = int(F()[0])
        except Exception:
            mnl = None
        order = _kkt_order(_veclen(c), mnl, _veclen(h), _veclen(b))
    with _dispatch_ctx(order):
        return _cpl_impl(c, F, G, h, dims, A, b, kktsolver, options,
                         xnewcopy, xdot, xscal, xaxpy, ynewcopy, ydot,
                         yscal, yaxpy)


def _cpl_impl(c, F, G, h, dims, A, b, kktsolver, options, xnewcopy, xdot,
              xscal, xaxpy, ynewcopy, ydot, yscal, yaxpy):
    """cpl on the device its inputs and config.default_device give."""
    o, dtype = _resolve_options(options)
    custom_x = any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy))
    custom_y = any(f is not None for f in (ynewcopy, ydot, yscal, yaxpy))
    xops = _make_vecops(xnewcopy, xdot, xscal, xaxpy)
    yops = _make_vecops(ynewcopy, ydot, yscal, yaxpy)
    if (custom_x or custom_y) and not callable(kktsolver):
        raise ValueError("custom vector spaces require a custom kktsolver")
    mnl, x0 = F()
    mnl = int(mnl)
    dev = _solve_device(*_tree_leaves(c), *_tree_leaves(x0), G, h, A, b)
    lanes = _Lanes(dtype, dev)
    xs = _AsGiven if custom_x else lanes
    ys = _AsGiven if custom_y else lanes
    n = None
    if not custom_x:
        c = _asarray(c, dtype, dev, name="c")[None]
        n = c.shape[1]
        x0 = _asarray(x0, dtype, dev, shape=(n,), name="x0")[None]

    if dims is None:
        dims = ConeDims(l=0 if h is None else int(_numel(h)))
    dims = ConeDims.from_dict(dims)
    if G is None:
        if custom_x:
            if dims.size:
                raise ValueError("custom x vector space requires "
                                 "operator-form G when dims is nonempty")
            G = (lambda v, trans=False: xops.zero(c) if trans
                 else torch.zeros((0,), dtype=dtype, device=dev))
        else:
            G = torch.zeros((dims.size, n), dtype=dtype, device=dev)
            h = None
    G_is_op = callable(G)
    if custom_x and not G_is_op:
        raise ValueError("custom x vector space requires operator-form G")
    if G_is_op and not callable(kktsolver):
        raise ValueError("operator-form G requires a custom kktsolver")
    Ga = None if G_is_op else cones.sym_from_lower_cols(dims, _asarray(
        G, dtype, dev, shape=(dims.size, n), name="G")[None])
    gmv = _instance_op(G, xs, lanes) if G_is_op else _matrix_op(Ga)
    h = (cones.sym_from_lower(dims, _asarray(
        h, dtype, dev, shape=(dims.size,), name="h")[None]) if h is not None
        else torch.zeros((1, dims.size), dtype=dtype, device=dev))
    Aa = None
    if custom_y:
        if A is None or not callable(A) or b is None:
            raise ValueError("custom y vector space requires operator-form "
                             "A and b")
        amv = _instance_op(A, xs, ys)
        p = 1
    elif A is not None and callable(A):
        if not callable(kktsolver):
            raise ValueError("operator-form A requires a custom kktsolver")
        if b is None:
            raise ValueError("operator-form A requires b")
        b = _asarray(b, dtype, dev, name="b")[None]
        amv = _instance_op(A, xs, ys)
        p = b.shape[1]
    else:
        b = (_asarray(b, dtype, dev, name="b") if b is not None else
             torch.zeros((0,), dtype=dtype, device=dev))[None]
        p = b.shape[1]
        Aa = (torch.zeros((1, 0, n or 1), dtype=dtype, device=dev)
              if A is None else
              _asarray(A, dtype, dev, shape=(p, n), name="A")[None])
        amv = _matrix_op(Aa)

    o = o.resolve_refinement(dims, kktsolver)
    edims = dims.with_extra_l(mnl)
    edeg = edims.degree
    e = cones.cone_e(edims, dtype, dev)[None]

    if kktsolver is None:
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    fallback_factor = None
    if isinstance(kktsolver, str):
        named = kkt.make_kkt_solver(kktsolver, dims, Ga, Aa, None, mnl=mnl,
                                    reg=o.kktreg)
        factor = _batched_factor(named)
        if kktsolver != "ldl":
            # The JAX package's robustness fallback: when the IPM drives
            # the gap far below the feasibility residuals (possible under
            # the relaxed line search), the condensed Cholesky systems
            # reach condition ~1/eps and the factor gives NaN; the
            # regularized full 3x3 LDL solve survives that regime.
            fallback_factor = _batched_factor(kkt.make_kkt_solver(
                "ldl", dims, Ga, Aa, None, mnl=mnl, reg=o.kktreg))
    else:
        factor = _instance_factor(kktsolver, edims, xs, ys)

    def feval(x, z=None):
        """The oracle at x: (f (1, mnl), Df, H), Df and H as it returned
        them (tensors (mnl, n) and (n, n), or operators); None outside
        the domain."""
        out = F(xs.to_user(x)) if z is None else F(xs.to_user(x), z[0])
        if out is None or out[0] is None:
            return None
        f = _tensor(out[0], dtype, dev).reshape(1, mnl)
        Df = out[1]
        if not callable(Df):
            Df = _tensor(Df, dtype, dev).reshape(mnl, -1)
        if z is None:
            return f, Df
        H = out[2]
        if not callable(H):
            H = _tensor(H, dtype, dev).reshape(n, n)
        return f, Df, H

    def dfmv(Df):
        return (_instance_op(Df, xs, lanes) if callable(Df)
                else _matrix_op(Df[None]))

    def geff_mv(Df, v, trans=False):
        dmv = dfmv(Df)
        if trans:
            return xops.axpy(dmv(v[:, :mnl], trans=True),
                             gmv(v[:, mnl:], trans=True))
        return torch.cat([dmv(v), gmv(v)], dim=-1)

    # initial point (reference cvxprog.py: x = x0, s = z = e)
    x = x0
    y = yops.zero(b)
    s = e.clone()
    z = e.clone()
    W = lmbda = None   # the scaled state, computed at it == 0, then
                       # updated incrementally (reference :760-1335)

    if feval(x) is None:
        raise ValueError("x0 must be in the domain of f")

    status = UNKNOWN
    metrics = {}
    iters_done = 0
    # relaxed line-search state (reference cvxprog.py:385-388,1080-1118)
    relaxed_iters = 0
    phi0 = dphi0 = step0 = 0.0
    saved = None
    theta1 = theta2 = theta3 = 0.0
    pres0 = dres0 = 1.0

    for it in range(o.maxiters + 1):
        f, Df = feval(x)
        rx = xops.axpy(geff_mv(Df, z, trans=True), c)
        if p:
            rx = xops.axpy(amv(y, trans=True), rx)
        ry = yops.axpy(b, amv(x), -1.0) if p else b
        rznl = s[:, :mnl] + f
        rzl = s[:, mnl:] + gmv(x) - h
        rz = torch.cat([rznl, rzl], dim=-1)
        gap = cones.sdot(edims, s, z)
        pcost = torch.as_tensor(xops.dot(c, x), dtype=dtype, device=dev)
        dcost = pcost + (yops.dot(y, ry) if p else 0.0) + \
            cones.sdot(edims, z, rz) - gap
        relgap = _relgap(gap, pcost, dcost)
        (gap_v, pcost_v, dcost_v, relgap_v, resx_v, resy_v, resznl_v,
         reszl_v) = _floats(
            gap, pcost, dcost, relgap, xops.norm(rx),
            yops.norm(ry) if p else 0.0, torch.linalg.vector_norm(rznl),
            cones.snrm2(dims, rzl))
        pres_raw = math.sqrt(resy_v ** 2 + resznl_v ** 2 + reszl_v ** 2)
        if it == 0:
            pres0 = max(1.0, pres_raw)
            dres0 = max(1.0, resx_v)
            # merit weights (reference cvxprog.py:713-719)
            theta1 = 1.0 / gap_v
            theta2 = 1.0 / max(1.0, resx_v)
            theta3 = 1.0 / max(1.0, resznl_v)
        pres = pres_raw / pres0
        dres = resx_v / dres0
        phi = theta1 * gap_v + theta2 * resx_v + theta3 * resznl_v

        if o.show_progress:
            print(f"{it:2d}: {pcost_v: .4e} {dcost_v: .4e} {gap_v: .0e} "
                  f"{pres: .0e} {dres: .0e}")

        metrics = dict(pcost=pcost_v, dcost=dcost_v, gap=gap_v,
                       relgap=relgap_v, pres=pres, dres=dres)
        iters_done = it
        if (pres <= o.feastol and dres <= o.feastol and
                (gap_v <= o.abstol or
                 (math.isfinite(relgap_v) and relgap_v <= o.reltol))):
            status = OPTIMAL
            break
        if it == o.maxiters:
            status = UNKNOWN
            break

        _, _, H = feval(x, z[:, :mnl])
        if it == 0:
            W, lmbda = cones.compute_scaling(edims, s, z,
                                             method=o.sscaling)
        try:
            solve = factor(W, H=H, Df=Df)
        except _FACTOR_ERRORS:
            if 0 < relaxed_iters < MAX_RELAXED_ITERS and saved is not None:
                # The singular factor may be caused by a relaxed line
                # search: restore the saved series start and require a
                # standard line search (reference cvxprog.py:785-815).
                x, y = saved["x"], saved["y"]
                s, z = saved["s"], saved["z"]
                W, lmbda = saved["W"], saved["lmbda"]
                relaxed_iters = -1
                saved = None
                continue
            status = SINGULAR
            break
        lmbdasq = cones.ssqr(edims, lmbda)
        mu = gap / edeg

        hmv = (_instance_op(lambda u, trans=False: H(u), xs, xs) if callable(H)
               else _matrix_op(H[None]))

        fb_solve_cache = []

        def newton(d_target):
            out = _newton(solve, d_target)
            if fallback_factor is not None and not _allfinite(*out):
                if not fb_solve_cache:
                    fb_solve_cache.append(fallback_factor(W, H=H, Df=Df))
                out = _newton(fb_solve_cache[0], d_target)
            return out

        def _newton(solve, d_target):
            tmp = cones.sinv(edims, lmbda, d_target)
            bz = -rz - cones.scale(edims, W, tmp, trans=True)
            dx, dy, dz = solve(xops.scal(-1.0, rx), yops.scal(-1.0, ry), bz)
            for _ in range(o.refinement):
                # r1 = -rx - (H dx + A'dy + Geff'dz)    (x-space)
                t1 = xops.axpy(hmv(dx), geff_mv(Df, dz, trans=True))
                if p:
                    t1 = xops.axpy(amv(dy, trans=True), t1)
                r1 = xops.axpy(rx, xops.scal(-1.0, t1), -1.0)
                # r2 = -ry - A dx                        (y-space)
                r2 = (yops.scal(-1.0, yops.axpy(amv(dx), ry))
                      if p else ry)
                wtwdz = cones.scale(edims, W, cones.scale(edims, W, dz),
                                    trans=True)
                r3 = bz - (geff_mv(Df, dx) - wtwdz)
                ex, ey, ez = solve(r1, r2, r3)
                dx = xops.axpy(ex, dx)
                dy = yops.axpy(ey, dy) if p else dy
                dz = dz + ez
            ds = cones.scale(edims, W,
                             tmp - cones.scale(edims, W, dz), trans=True)
            return dx, dy, dz, ds

        # ---- Mehrotra predictor-corrector with the reference's merit
        # line search: relaxed backtracking on
        #     phi = theta1*gap + theta2*||rx|| + theta3*||rznl||
        # (reference cvxprog.py:1010-1235; constants :385-388) ----------

        def make_trial(xc, yc, sc, zc, dxc, dyc, dzc, dsc, sigma_c,
                       gap_c, dsdz_c):
            def trial(stp):
                xn = xops.axpy(dxc, xc, stp)
                outn = feval(xn)
                if outn is None:
                    return None
                fn_, Dfn_ = outn
                yn = yops.axpy(dyc, yc, stp) if p else yc
                sn = sc + stp * dsc
                zn = zc + stp * dzc
                rxn = xops.axpy(geff_mv(Dfn_, zn, trans=True), c)
                if p:
                    rxn = xops.axpy(amv(yn, trans=True), rxn)
                finite, newresx, newresznl = _floats(
                    torch.isfinite(fn_).all(), xops.norm(rxn),
                    torch.linalg.vector_norm(sn[:, :mnl] + fn_))
                if not finite:
                    return None
                # predicted gap along the step (reference :1157-1159)
                newgap = (1.0 - (1.0 - sigma_c) * stp) * gap_c + \
                    stp * stp * dsdz_c
                newphi = theta1 * newgap + theta2 * newresx + \
                    theta3 * newresznl
                if not math.isfinite(newphi):
                    return None
                return dict(x=xn, y=yn, s=sn, z=zn, gap=newgap,
                            phi=newphi, stp=stp)
            return trial

        def backtrack(tri, stp, phi_ref, dphi_ref):
            """Standard backtracking to sufficient merit decrease
            (reference cvxprog.py:1178-1186)."""
            for _ in range(90):
                tr = tri(stp)
                if tr is not None and tr["phi"] <= phi_ref + \
                        ALPHA * stp * dphi_ref:
                    return tr
                stp *= BETA
            return None

        def first_step(tri, stp):
            """Relaxed acceptance: the first finite in-domain step (the
            reference takes the full step unconditionally after the
            domain backtrack, cvxprog.py:1186-1235)."""
            for _ in range(60):
                tr = tri(stp)
                if tr is not None:
                    return tr
                stp *= BETA
            return None

        sigma = 0.0
        accepted = None
        failed = False
        for i in (0, 1):
            # Note: unlike conelp, the reference's cpl corrector target
            # has no second-order (ds o dz) term (cvxprog.py:976-992).
            d_t = -lmbdasq if i == 0 else \
                -lmbdasq + (sigma * mu)[:, None] * e
            dx, dy, dz, ds = newton(d_t)
            # scaled directions and the eigendecompositions needed for
            # the post-step scaling update (reference :1040-1060)
            ds_w = cones.scale(edims, W, ds, trans=True, inverse=True)
            dz_w = cones.scale(edims, W, dz)
            ts, eig_s = cones.max_step_eig(
                edims, cones.scale2(edims, lmbda, ds_w))
            tz, eig_z = cones.max_step_eig(
                edims, cones.scale2(edims, lmbda, dz_w))
            dsdz, ts_v, tz_v = _floats(cones.sdot(edims, ds_w, dz_w), ts, tz)
            t = max(0.0, ts_v, tz_v)
            step = 1.0 if t <= 0.0 else min(1.0, STEP / t)

            # backtrack until x + step*dx is in the domain of f
            # (reference :1044-1053)
            indom = False
            for _ in range(60):
                if feval(xops.axpy(dx, x, step)) is not None:
                    indom = True
                    break
                step *= BETA
            if not indom:
                failed = True
                break

            trial = make_trial(x, y, s, z, dx, dy, dz, ds, sigma, gap_v,
                               dsdz)
            ctx = dict(trial=trial, x=x, y=y, s=s, z=z, W=W, lmbda=lmbda,
                       ds_w=ds_w, dz_w=dz_w, eig_s=eig_s, eig_z=eig_z)

            if i == 0:
                # predictor: backtrack until the gap decrease test (and,
                # outside a relaxed series, sufficient phi decrease)
                # holds (reference :1163-1170); its exit sets sigma
                dphi = -phi
                tr = None
                for _ in range(60):
                    tr = trial(step)
                    if tr is not None and (
                            tr["gap"] <= (1.0 - ALPHA * step) * gap_v
                            and (0 <= relaxed_iters < MAX_RELAXED_ITERS
                                 or tr["phi"] <= phi + ALPHA * step *
                                 dphi)):
                        break
                    tr = None
                    step *= BETA
                if tr is None:
                    failed = True
                    break
                ratio = tr["gap"] / gap_v
                # clamp to [0, 1]: the predicted gap can go negative on
                # aggressive affine steps, and a negative sigma would
                # make the corrector an anti-centering step
                sigma = min(1.0, max(0.0, min(ratio, ratio ** EXPON)))
                continue

            # corrector: relaxed / standard line search with saved-state
            # resume (reference :1080-1263)
            dphi = (-theta1 * (1.0 - sigma) * gap_v
                    - theta2 * resx_v - theta3 * resznl_v)

            if relaxed_iters == -1 or MAX_RELAXED_ITERS == 0:
                # standard backtracking line search
                tr = backtrack(trial, step, phi, dphi)
                if tr is None:
                    failed = True
                    break
                accepted = (tr, ctx)
            elif relaxed_iters == 0:
                tr = first_step(trial, step)
                if tr is None:
                    failed = True
                    break
                if tr["phi"] <= phi + ALPHA * tr["stp"] * dphi:
                    relaxed_iters = 0
                else:
                    # save the series start for a possible later resume
                    phi0, dphi0, step0 = phi, dphi, tr["stp"]
                    saved = ctx
                    relaxed_iters = 1
                accepted = (tr, ctx)
            elif relaxed_iters < MAX_RELAXED_ITERS:
                tr = first_step(trial, step)
                if tr is None:
                    failed = True
                    break
                if tr["phi"] <= phi0 + ALPHA * step0 * dphi0:
                    relaxed_iters = 0
                    saved = None
                else:
                    relaxed_iters += 1
                accepted = (tr, ctx)
            else:  # relaxed_iters == MAX_RELAXED_ITERS
                tr = first_step(trial, step)
                if tr is not None and tr["phi"] <= phi0 + ALPHA * \
                        step0 * dphi0:
                    # the series ends with sufficient decrease w.r.t. phi0
                    relaxed_iters = 0
                    saved = None
                    accepted = (tr, ctx)
                else:
                    # resume the saved first line search of the series
                    # as a standard one (reference :1231-1263); stay in
                    # standard mode afterwards (the reference's shipped
                    # behavior: its `relaxed_iters == 0` at :1184 is a
                    # comparison, not an assignment)
                    sctx = saved
                    tr = backtrack(sctx["trial"], step0, phi0, dphi0)
                    relaxed_iters = -1
                    saved = None
                    if tr is None:
                        failed = True
                        break
                    accepted = (tr, sctx)

        if failed or accepted is None:
            status = UNKNOWN
            break
        tr, ctx = accepted
        x, y = tr["x"], tr["y"]
        stp = tr["stp"]
        # Incremental scaling update from the *scaled* new iterates
        # (reference cvxprog.py:1268-1335 + misc.py:422): far better
        # conditioned near the cone boundary than recomputing W from the
        # unscaled pair.
        su = cones.step_scaled_iterates(edims, ctx["lmbda"], ctx["ds_w"],
                                        ctx["eig_s"], stp)
        zu = cones.step_scaled_iterates(edims, ctx["lmbda"], ctx["dz_w"],
                                        ctx["eig_z"], stp)
        W, lmbda = cones.update_scaling_inc(edims, ctx["W"], ctx["lmbda"],
                                            su, zu, method=o.sscaling)
        # the unscaled s and z are needed only for the residuals
        s, z = cones.lmbda_to_cone(edims, W, lmbda)

    relgap = metrics.get("relgap", math.inf)
    pslack, dslack = _floats(cones.max_step(edims, s),
                             cones.max_step(edims, z))
    return {
        "status": _STATUS_STR.get(status, "unknown"),
        "x": xs.to_user(x), "y": ys.to_user(y),
        "snl": s[0, :mnl], "sl": s[0, mnl:],
        "znl": z[0, :mnl], "zl": z[0, mnl:],
        "primal objective": metrics.get("pcost"),
        "dual objective": metrics.get("dcost"),
        "gap": metrics.get("gap"),
        "relative gap": relgap if math.isfinite(relgap) else None,
        "primal infeasibility": metrics.get("pres"),
        "dual infeasibility": metrics.get("dres"),
        "primal slack": -pslack,
        "dual slack": -dslack,
        "iterations": iters_done,
    }


def _batched_factor(named):
    """A named KKT strategy called with one instance's dense H (n, n) and
    Df (mnl, n), as a batch of one."""
    def factor(W, H=None, Df=None):
        if callable(H) or callable(Df):
            raise TypeError("operator-form H or Df requires a custom "
                            "kktsolver")
        return named(W, H=H[None], Df=Df[None])
    return factor


def cp(F, G=None, h=None, dims=None, A=None, b=None, kktsolver=None,
       options=None, xnewcopy=None, xdot=None, xscal=None, xaxpy=None,
       ynewcopy=None, ydot=None, yscal=None, yaxpy=None):
    """Nonlinear objective (reference cvxprog.py:1359): minimize f0(x)
    s.t. f_k(x) <= 0, Gx + s = h, Ax = b, by the epigraph transform onto
    cpl (reference cvxprog.py:1767-1958): the variable (x, t) with
    c = e_{n+1}, f0(x) - t <= 0 and t starting at 0.  F's value vector has
    mnl+1 entries with f0 first; the result's x is cut back to n.

    With custom x-space hooks the epigraph variable is the tuple (x, t),
    with hooks built from the given ones, and a user kktsolver sees the
    extended operators.

    Where the KKT system's order len(x0) + mnl (F() gives both) +
    len(h) + len(b) is below config.host_dispatch_threshold (unknown with
    custom x hooks or where F() raises), array-like inputs go to the CPU
    before any is placed (coneprog._dispatch_ctx); x0 given as a tensor
    keeps its device."""
    order = None
    if all(f is None for f in (xnewcopy, xdot, xscal, xaxpy)):
        try:
            mnl, x0 = F()
            order = _kkt_order(_veclen(x0), int(mnl), _veclen(h),
                               _veclen(b))
        except Exception:
            order = None
    with _dispatch_ctx(order):
        return _cp_impl(F, G, h, dims, A, b, kktsolver, options, xnewcopy,
                        xdot, xscal, xaxpy, ynewcopy, ydot, yscal, yaxpy)


def _cp_impl(F, G, h, dims, A, b, kktsolver, options, xnewcopy, xdot, xscal,
             xaxpy, ynewcopy, ydot, yscal, yaxpy):
    """cp on the device its inputs and config.default_device give."""
    _, dtype = _resolve_options(options)
    if any(f is not None for f in (xnewcopy, xdot, xscal, xaxpy)):
        return _cp_custom(F, G, h, dims, A, b, kktsolver, options, dtype,
                          _make_vecops(xnewcopy, xdot, xscal, xaxpy),
                          ynewcopy, ydot, yscal, yaxpy)
    mnl, x0 = F()
    mnl = int(mnl)
    dev = _solve_device(x0, G, h, A, b)
    x0 = _asarray(x0, dtype, dev, name="x0")
    n = x0.shape[0]

    f0 = F(x0)
    if f0 is None or f0[0] is None:
        raise ValueError("x0 must be in the domain of f")
    t0 = 0.0   # the reference starts the epigraph variable at 0
               # (cvxprog.py:1778 `return mnl+1, [x0, 0.0]`)
    tcol = x0.new_zeros((mnl + 1, 1))   # the -t column of Df_e
    tcol[0, 0] = -1.0

    def F_e(xe=None, z=None):
        if xe is None:
            return mnl + 1, torch.cat([x0, x0.new_tensor([t0])])
        x, t = xe[:n], xe[n]
        out = F(x) if z is None else F(x, z)
        if out is None or out[0] is None:
            return None
        f, Df = out[0], out[1]
        f = torch.atleast_1d(_tensor(f, dtype, dev))
        fe = torch.cat([f[:1] - t, f[1:]])
        if callable(Df):
            # operator-form Df (needs a custom kktsolver, as in the
            # reference cvxprog.py:1795): extend with the -t column
            dmv = Df

            def Dfe(u, trans=False):
                if trans:
                    return torch.cat([dmv(u, trans=True), -u[:1]])
                r = dmv(u[:n])
                return torch.cat([r[:1] - u[n], r[1:]])
        else:
            Dfe = torch.cat([_tensor(Df, dtype, dev).reshape(mnl + 1, n),
                             tcol], dim=1)
        if z is None:
            return fe, Dfe
        H = out[2]
        if callable(H):
            # operator-form H (the reference's l2ac pattern,
            # examples/doc/chap9/l2ac.py:30-38): a zero row and column
            # for the epigraph variable
            hmv = H

            def He(u):
                return torch.cat([hmv(u[:n]), u.new_zeros((1,))])
        else:
            He = x0.new_zeros((n + 1, n + 1))
            He[:n, :n] = _tensor(H, dtype, dev).reshape(n, n)
        return fe, Dfe, He

    if dims is None:
        dims = ConeDims(l=0 if h is None else int(_numel(h)))
    dims = ConeDims.from_dict(dims)
    G_e = A_e = None
    if G is not None:
        Ga = _asarray(G, dtype, dev, name="G").reshape(dims.size, n)
        G_e = torch.cat([Ga, Ga.new_zeros((dims.size, 1))], dim=1)
    if A is not None:
        Aa = _asarray(A, dtype, dev, name="A").reshape(-1, n)
        A_e = torch.cat([Aa, Aa.new_zeros((Aa.shape[0], 1))], dim=1)
    c_e = x0.new_zeros((n + 1,))
    c_e[n] = 1.0
    sol = cpl(c_e, F_e, G_e, h, dims, A_e, b, kktsolver=kktsolver,
              options=options)
    sol["x"] = sol["x"][:n]
    return sol


def _cp_custom(F, G, h, dims, A, b, kktsolver, options, dtype, xops,
               ynewcopy, ydot, yscal, yaxpy):
    """cp over a custom x vector space: the epigraph variable (x, t) as a
    tuple, its hooks built from `xops`."""
    mnl, x0 = F()
    mnl = int(mnl)
    f0 = F(x0)
    if f0 is None or f0[0] is None:
        raise ValueError("x0 must be in the domain of f")
    dev = _solve_device(*_tree_leaves(x0))
    t0 = torch.zeros((), dtype=dtype, device=dev)   # reference :1778

    def F_e(xe=None, z=None):
        if xe is None:
            return mnl + 1, (x0, t0)
        x, t = xe
        out = F(x) if z is None else F(x, z)
        if out is None or out[0] is None:
            return None
        f, Df = out[0], out[1]
        f = torch.atleast_1d(_tensor(f, dtype, dev))
        fe = torch.cat([f[:1] - t, f[1:]])
        dmv = Df if callable(Df) else _dense_mv(_tensor(Df, dtype, dev))

        def Df_e(u, trans=False):
            if trans:
                return (dmv(u, trans=True), -u[0])
            ux, ut = u
            r = dmv(ux)
            return torch.cat([r[:1] - ut, r[1:]])

        if z is None:
            return fe, Df_e
        H = out[2]
        hmv = H if callable(H) else _dense_mv(_tensor(H, dtype, dev))

        def H_e(u):
            ux, ut = u
            return (hmv(ux), torch.zeros_like(t0))

        return fe, Df_e, H_e

    def G_e(u, trans=False):
        if trans:
            return (G(u, trans=True), torch.zeros_like(t0))
        return G(u[0])

    A_e = None
    if A is not None:
        def A_e(u, trans=False):
            if trans:
                return (A(u, trans=True), torch.zeros_like(t0))
            return A(u[0])

    c_e = (xops.scal(0.0, x0), torch.ones_like(t0))

    def xdot_e(u, v):
        return xops.dot(u[0], v[0]) + u[1] * v[1]

    def xscal_e(alpha, u):
        return (xops.scal(alpha, u[0]), alpha * u[1])

    def xaxpy_e(u, v, alpha=1.0):
        return (xops.axpy(u[0], v[0], alpha), alpha * u[1] + v[1])

    def xnewcopy_e(u):
        return (xops.copy(u[0]), u[1])

    sol = cpl(c_e, F_e, G_e if G is not None else None, h, dims, A_e, b,
              kktsolver=kktsolver, options=options, xnewcopy=xnewcopy_e,
              xdot=xdot_e, xscal=xscal_e, xaxpy=xaxpy_e,
              ynewcopy=ynewcopy, ydot=ydot, yscal=yscal, yaxpy=yaxpy)
    sol["x"] = sol["x"][0]
    return sol


def _dense_mv(M):
    """M u, and M' u with trans=True, for one instance's matrix M."""
    def mv(u, trans=False):
        return M.T @ u if trans else M @ u
    return mv


def gp(K, F, g, G=None, h=None, A=None, b=None, kktsolver=None,
       options=None):
    """Geometric program in convex (log-sum-exp) form (reference
    cvxprog.py:1967): minimize lse(F_0 x + g_0) s.t. lse(F_i x + g_i) <= 0,
    Gx <= h, Ax = b, F's rows partitioned by K; through cp.

    The oracle is the reference's log-sum-exp contract written out
    (cvxprog.py:2102-2154): the max-shifted value, the gradient F_i'w
    with softmax weights w, the Hessian F_i'(diag(w) - ww')F_i, all
    blocks at once (one segment max and a few products per call).  F and
    g are arrays or tensors.

    Where the KKT system's order, F's columns + len(K) - 1 (the
    posynomial constraints) + len(h) + len(b), is below
    config.host_dispatch_threshold, array-like inputs go to the CPU
    before any is placed (coneprog._dispatch_ctx)."""
    try:
        shp = getattr(F, "shape", None)
        n = int(shp[1]) if shp is not None and not callable(shp) \
            else int(F.size[1])
    except Exception:
        n = None
    with _dispatch_ctx(_kkt_order(n, len(K) - 1, _veclen(h), _veclen(b))):
        return _gp_impl(K, F, g, G, h, A, b, kktsolver, options)


def _gp_impl(K, F, g, G, h, A, b, kktsolver, options):
    """gp on the device its inputs and config.default_device give."""
    _, dtype = _resolve_options(options)
    dev = _solve_device(F, g, G, h, A, b)
    K = [int(k) for k in K]
    Fm = _tensor(F, dtype, dev)
    gv = _tensor(g, dtype, dev).reshape(-1)
    n = Fm.shape[1]
    if Fm.shape[0] != sum(K) or gv.shape[0] != sum(K):
        raise ValueError("rows of F and g must equal sum(K)")
    mnl = len(K) - 1
    # the block of each row, and the (mnl+1, sum(K)) block indicator
    seg = torch.repeat_interleave(
        torch.arange(mnl + 1, device=dev),
        torch.tensor(K, device=dev))
    S = torch.zeros((mnl + 1, sum(K)), dtype=dtype, device=dev)
    S[seg, torch.arange(sum(K), device=dev)] = 1.0

    def F_gp(x=None, z=None):
        if x is None:
            return mnl, torch.zeros((n,), dtype=dtype, device=dev)
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        y = Fm @ x + gv
        ymax = torch.full((mnl + 1,), -math.inf, dtype=dtype,
                          device=dev).scatter_reduce(0, seg, y, "amax")
        w = torch.exp(y - ymax[seg])
        tot = S @ w
        f = ymax + torch.log(tot)
        w = w / tot[seg]
        Df = S @ (Fm * w[:, None])
        if z is None:
            return f, Df
        z = torch.as_tensor(z, dtype=dtype, device=dev)
        H = Fm.T @ (Fm * (z[seg] * w)[:, None]) - Df.T @ (Df * z[:, None])
        return f, Df, H

    return cp(F_gp, G, h, None, A, b, kktsolver=kktsolver, options=options)
