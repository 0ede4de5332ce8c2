"""Batched cone-QP interior-point solve.

Counterpart of the coneqp core of kvxopt_tpu/solvers/coneprog.py: the
primal-dual Mehrotra predictor-corrector with Nesterov-Todd scaling,
run as a Python loop over tensors that hold a whole batch of problems,
one lane per problem.  A lane whose status is no longer RUNNING keeps
its state, its iteration count and its metrics while the other lanes
iterate, as under the JAX package's vmapped lax.while_loop.

The front ends (coneqp, qp) and the conelp solver are not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import cones
from ..cones import ConeDims

# status codes
RUNNING, OPTIMAL, UNKNOWN, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, SINGULAR = (
    0, 1, 2, 3, 4, 5)

_STATUS_STR = {
    OPTIMAL: "optimal",
    UNKNOWN: "unknown",
    PRIMAL_INFEASIBLE: "primal infeasible",
    DUAL_INFEASIBLE: "dual infeasible",
    SINGULAR: "unknown",
}

STEP = 0.99   # fraction-to-boundary (reference coneprog.py:424)
EXPON = 3     # sigma exponent (reference coneprog.py:423)


class Options(NamedTuple):
    maxiters: int = 100
    abstol: float = 1e-7
    reltol: float = 1e-6
    feastol: float = 1e-7
    refinement: int = -1   # -1 = auto: 1 with q/s cones else 0
    show_progress: bool = False
    kktreg: float = 0.0
    sscaling: str = "eigh"  # s-block NT construction, 'eigh' or 'svd';
                            # the coneqp core uses the default, as the
                            # JAX package's does
    facref: object = None   # factor refinement of the mixed strategies:
                            # None = config.factor_refine, True/False force
    ozaki: object = None    # exact-split refinement matvecs of the mixed
                            # strategies: None = config.ozaki_refine

    def resolve_refinement(self, dims, kktsolver=None):
        """-1 (auto) resolves to the reference default (1 with q/s cones
        else 0), and to at least 1 with a mixed-precision KKT strategy:
        without an outer refinement step the f32 factor + PCG solve
        leaves lanes stalled at status 'unknown' at 1e-7 tolerances."""
        if self.refinement >= 0:
            return self
        auto = 1 if (dims.q or dims.s) else 0
        if isinstance(kktsolver, str) and "mixed" in kktsolver:
            auto = max(auto, 1)
        return self._replace(refinement=auto)


class Metrics(NamedTuple):
    pcost: torch.Tensor
    dcost: torch.Tensor
    gap: torch.Tensor
    relgap: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor


def _relgap(gap, pcost, dcost):
    inf = torch.full_like(gap, math.inf)
    return torch.where(pcost < 0.0, gap / (-pcost),
                       torch.where(dcost > 0.0, gap / dcost, inf))


def _result_dict(status, x, y, s, z, dims, metrics, iterations):
    """Result dictionary of one lane (scalars and per-lane vectors)."""
    res = {
        "status": _STATUS_STR.get(int(status), "unknown"),
        "x": x, "y": y, "s": s, "z": z,
        "iterations": int(iterations),
    }
    res.update(metrics)
    return res


def _where(mask, a, b):
    """Per-lane select: mask (B,), a and b (B, ...)."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _coneqp_core(q, h, b, dims: ConeDims, o: Options, factor, gmv, amv,
                 pmv):
    """Batched coneqp driver: q (B, n), h (B, m), b (B, p), `factor(W)` a
    KKT strategy over the batch, gmv/amv/pmv batched operator products
    (gmv and amv take trans=True for G' and A').  Returns the final
    state (x, y, s, z, iterations, status, metrics)."""
    B, dtype, dev = q.shape[0], q.dtype, q.device
    p = b.shape[-1]
    deg = dims.degree
    e = cones.cone_e(dims, dtype, dev)
    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    resx0 = torch.clamp(norm(q), min=1.0)
    resy0 = torch.clamp(norm(b), min=1.0)
    resz0 = torch.clamp(cones.snrm2(dims, h), min=1.0)

    def newton(solve, lmbda, W, rx, ry, rz, d_target):
        """Solve the Newton system for a given complementarity target."""
        tmp = cones.sinv(dims, lmbda, d_target)
        bz = -rz - cones.scale(dims, W, tmp, trans=True)
        bx, by = -rx, -ry
        dx, dy, dz = solve(bx, by, bz)
        for _ in range(o.refinement):
            # residuals of the full (unscaled) Newton system
            t = pmv(dx)
            if p:
                t = amv(dy, trans=True) + t
            r1 = bx - (gmv(dz, trans=True) + t)
            r2 = by - amv(dx) if p else by
            wtwdz = cones.scale(dims, W, cones.scale(dims, W, dz),
                                trans=True)
            r3 = bz - (gmv(dx) - wtwdz)
            ex, ey, ez = solve(r1, r2, r3)
            dx = ex + dx
            dy = ey + dy if p else dy
            dz = dz + ez
        ds = cones.scale(dims, W, tmp - cones.scale(dims, W, dz),
                         trans=True)
        return dx, dy, dz, ds

    def initial_point():
        W0 = cones.identity_scaling(dims, B, dtype, dev)
        x0, y0, z0 = factor(W0)(-q, b, h)
        s0 = -z0
        ts, tz = cones.max_step2(dims, s0, z0)
        s0 = _where(ts >= -1e-8 * torch.clamp(torch.abs(ts), min=1.0),
                    s0 + (1.0 + ts)[:, None] * e, s0)
        z0 = _where(tz >= -1e-8 * torch.clamp(torch.abs(tz), min=1.0),
                    z0 + (1.0 + tz)[:, None] * e, z0)
        return x0, y0, s0, z0

    def metrics_of(x, y, s, z):
        rx = pmv(x) + (gmv(z, trans=True) + q)
        if p:
            rx = amv(y, trans=True) + rx
        ry = amv(x) - b if p else b
        rz = gmv(x) + s - h
        gap = cones.sdot(dims, s, z)
        pcost = 0.5 * dot(x, pmv(x)) + dot(q, x)
        dcost = pcost + (dot(y, ry) if p else 0.0) + \
            cones.sdot(dims, z, rz) - gap
        pres = torch.clamp(cones.snrm2(dims, rz) / resz0, min=0.0)
        if p:
            pres = torch.maximum(norm(ry) / resy0, pres)
        dres = norm(rx) / resx0
        return rx, ry, rz, Metrics(pcost, dcost, gap,
                                   _relgap(gap, pcost, dcost), pres, dres)

    def do_step(x, y, s, z, rx, ry, rz, m):
        W, lmbda = cones.compute_scaling(dims, s, z)
        solve = factor(W)
        lmbdasq = cones.ssqr(dims, lmbda)
        mu = m.gap / deg

        # Mehrotra predictor, then corrector
        dx, dy, dz, ds = newton(solve, lmbda, W, rx, ry, rz, -lmbdasq)
        tinv = None
        for phase in range(2):
            if phase:
                stp = torch.where(tinv <= 0.0, torch.ones_like(tinv),
                                  torch.clamp(1.0 / tinv, max=1.0))
                mu_aff = cones.sdot(dims, s + stp[:, None] * ds,
                                    z + stp[:, None] * dz) / deg
                sigma = torch.clamp(mu_aff / mu, 0.0, 1.0) ** EXPON
                combined = (-lmbdasq - cones.sprod(dims, ds_w, dz_w) +
                            (sigma * mu)[:, None] * e)
                dx, dy, dz, ds = newton(solve, lmbda, W, rx, ry, rz,
                                        combined)
            ds_w = cones.scale(dims, W, ds, trans=True, inverse=True)
            dz_w = cones.scale(dims, W, dz)
            ts, tz = cones.max_step2(dims, cones.scale2(dims, lmbda, ds_w),
                                     cones.scale2(dims, lmbda, dz_w))
            tinv = torch.clamp(torch.maximum(ts, tz), min=0.0)
        step = torch.clamp(STEP * torch.where(
            tinv <= 0.0, torch.full_like(tinv, 1.0 / STEP),
            torch.clamp(1.0 / tinv, max=1.0 / STEP)), max=1.0)

        xn = step[:, None] * dx + x
        yn = step[:, None] * dy + y if p else y
        sn = s + step[:, None] * ds
        zn = z + step[:, None] * dz
        bad = ~torch.isfinite(dot(xn, xn) + dot(sn, sn) + dot(zn, zn))
        st = torch.where(bad, SINGULAR, RUNNING).to(torch.int32)
        return (_where(bad, x, xn), _where(bad, y, yn), _where(bad, s, sn),
                _where(bad, z, zn), st)

    x, y, s, z = initial_point()
    m = metrics_of(x, y, s, z)[3]
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = torch.full((B,), RUNNING, dtype=torch.int32, device=dev)
    if o.show_progress:
        print("     pcost       dcost       gap    pres   dres")
    while bool((status == RUNNING).any()):
        live = status == RUNNING
        rx, ry, rz, mm = metrics_of(x, y, s, z)
        if o.show_progress:
            for i in torch.nonzero(live).flatten().tolist():
                print(f"{int(it[i]):2d}: {float(mm.pcost[i]): .4e} "
                      f"{float(mm.dcost[i]): .4e} {float(mm.gap[i]): .0e} "
                      f"{float(mm.pres[i]): .0e} {float(mm.dres[i]): .0e}")
        converged = (mm.pres <= o.feastol) & (mm.dres <= o.feastol) & (
            (mm.gap <= o.abstol) | (torch.isfinite(mm.relgap) &
                                    (mm.relgap <= o.reltol)))
        new_status = torch.where(
            converged, OPTIMAL,
            torch.where(it >= o.maxiters, UNKNOWN, RUNNING)).to(torch.int32)
        stepping = live & (new_status == RUNNING)
        if bool(stepping.any()):
            xn, yn, sn, zn, st = do_step(x, y, s, z, rx, ry, rz, mm)
            x = _where(stepping, xn, x)
            y = _where(stepping, yn, y)
            s = _where(stepping, sn, s)
            z = _where(stepping, zn, z)
            new_status = torch.where(stepping, st, new_status)
        status = torch.where(live, new_status, status)
        it = torch.where(live, it + 1, it)
        m = Metrics(*(torch.where(live, a, b_) for a, b_ in zip(mm, m)))
    return x, y, s, z, it, status, m
