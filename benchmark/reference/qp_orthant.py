"""Plain reference for dense convex QPs over the nonnegative orthant.

    minimize    (1/2) x'Px + q'x
    subject to  G x + s = h,  s >= 0
                A x = b

A batched primal-dual interior-point method with Mehrotra's
predictor-corrector, written from the textbook method in plain torch:
each Newton system is reduced to the augmented system
[[P + G' diag(z/s) G, A'], [A, 0]], which is factored as LDL' with
Bunch-Kaufman pivoting (torch.linalg.ldl_factor).  It shares no code
with the package under test, and takes only the problem data.

`judge` measures a claimed solution against the data, in float64, by the
stopping measures of CVXOPT's coneqp: relative residuals against
max(1, ||h||), max(1, ||b||) and max(1, ||q||), and the duality gap.
"""

from __future__ import annotations

import math

import torch

STEP = 0.99
TIGHT = {"feastol": 1e-11, "abstol": 1e-11, "reltol": 1e-11}


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _tmv(M, v):
    return torch.einsum("bij,bi->bj", M, v)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def measures(P, q, G, h, A, b, x, y, s, z):
    """(pres, dres, gap, pcost, relgap) per lane, CVXOPT's definitions."""
    rd = _mv(P, x) + q + _tmv(G, z) + _tmv(A, y)
    rpe = _mv(A, x) - b
    rpi = _mv(G, x) + s - h
    one = torch.ones_like(q[:, 0])
    pres = torch.maximum(_norm(rpi) / torch.maximum(one, _norm(h)),
                         _norm(rpe) / torch.maximum(one, _norm(b)))
    dres = _norm(rd) / torch.maximum(one, _norm(q))
    gap = (s * z).sum(-1)
    pcost = 0.5 * (x * _mv(P, x)).sum(-1) + (q * x).sum(-1)
    dcost = pcost + (y * rpe).sum(-1) + (z * rpi).sum(-1) - gap
    inf = torch.full_like(gap, math.inf)
    relgap = torch.where(pcost < 0, gap / -pcost,
                         torch.where(dcost > 0, gap / dcost, inf))
    return pres, dres, gap, pcost, relgap, (rd, rpe, rpi)


def _max_step(v, dv):
    """Largest a in (0, inf] with v + a dv >= 0, per lane."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, math.inf))
    return ratio.amin(dim=-1)


def solve(P, q, G, h, A, b, tol=None, maxiters=100, dtype=torch.float64):
    """Solve each lane of the batch (P (B, n, n), q (B, n), G (B, m, n),
    h (B, m), A (B, p, n), b (B, p)) in `dtype` on the data's device.
    tol: feastol, abstol and reltol (TIGHT by default).  Returns a dict
    of x, y, s, z (in `dtype`), status (a list: 'optimal', 'unknown' at
    maxiters or when a step makes no progress, 'singular' where the
    iterate stopped being finite) and iterations (a list)."""
    tol = dict(TIGHT if tol is None else tol)
    P, q, G, h, A, b = (t.to(dtype) for t in (P, q, G, h, A, b))
    B, n = q.shape
    m, p = h.shape[1], b.shape[1]
    Gt, At = G.transpose(1, 2), A.transpose(1, 2)

    def augmented(H, use):
        """LDL' (Bunch-Kaufman) of each lane's augmented matrix; lanes
        where `use` is false, or whose matrix is not finite or singular,
        factor the identity instead and are False in the returned mask."""
        K = torch.zeros((B, n + p, n + p), dtype=dtype, device=q.device)
        K[:, :n, :n] = H
        K[:, :n, n:] = At
        K[:, n:, :n] = A
        ok = use & torch.isfinite(K).flatten(1).all(-1)
        eye = torch.eye(n + p, dtype=dtype, device=q.device)
        K = torch.where(ok[:, None, None], K, eye)
        LD, piv, info = torch.linalg.ldl_factor_ex(K)
        if bool((info != 0).any()):
            ok = ok & (info == 0)
            K = torch.where(ok[:, None, None], K, eye)
            LD, piv, _ = torch.linalg.ldl_factor_ex(K)
        return (LD, piv), ok

    def asolve(LD, r1, r2):
        u = torch.linalg.ldl_solve(*LD, torch.cat([r1, r2], -1)[..., None])
        return u[:, :n, 0], u[:, n:, 0]

    # initial point (W = I): [P A' G'; A 0 0; G 0 -I][x; y; z] = [-q; b; h]
    LU, _ = augmented(P + Gt @ G, torch.ones(B, dtype=torch.bool,
                                             device=q.device))
    x, y = asolve(LU, -q + _tmv(G, h), b)
    z = _mv(G, x) - h
    s = -z
    for v in (s, z):
        a = -v.amin(dim=-1)
        shift = torch.where(a >= -1e-8 * torch.clamp(a.abs(), min=1.0),
                            1.0 + a, torch.zeros_like(a))
        v += shift[:, None]

    status = ["running"] * B
    iters = [0] * B
    live = torch.ones(B, dtype=torch.bool, device=q.device)
    for it in range(maxiters + 1):
        pres, dres, gap, pcost, relgap, (rd, rpe, rpi) = measures(
            P, q, G, h, A, b, x, y, s, z)
        done = (pres <= tol["feastol"]) & (dres <= tol["feastol"]) & (
            (gap <= tol["abstol"]) | (relgap <= tol["reltol"]))
        finished = (done & live).tolist()
        for i, f in enumerate(finished):
            if f:
                status[i], iters[i] = "optimal", it
        live = live & ~done
        if it == maxiters or not bool(live.any()):
            break
        d = z / s
        LU, ok = augmented(P + Gt @ (d[..., None] * G), live)
        for i in torch.nonzero(live & ~ok).flatten().tolist():
            status[i], iters[i] = "singular", it
        live = live & ok

        def newton(rsz):
            t = (z * rpi - rsz) / s
            dx, dy = asolve(LU, -rd - _tmv(G, t), -rpe)
            Gdx = _mv(G, dx)
            return dx, dy, -rpi - Gdx, d * Gdx + t

        mu = gap / m
        dxa, dya, dsa, dza = newton(s * z)
        aa = torch.clamp(torch.minimum(_max_step(s, dsa), _max_step(z, dza)),
                         max=1.0)
        mua = ((s + aa[:, None] * dsa) * (z + aa[:, None] * dza)).sum(-1) / m
        sigma = torch.clamp(mua / mu, 0.0, 1.0) ** 3
        dx, dy, ds, dz = newton(s * z + dsa * dza - (sigma * mu)[:, None])
        a = torch.clamp(STEP * torch.minimum(_max_step(s, ds),
                                             _max_step(z, dz)), max=1.0)
        xn, yn = x + a[:, None] * dx, y + a[:, None] * dy
        sn, zn = s + a[:, None] * ds, z + a[:, None] * dz
        finite = torch.isfinite(xn).all(-1) & torch.isfinite(yn).all(-1) & \
            torch.isfinite(sn).all(-1) & torch.isfinite(zn).all(-1) & \
            (sn > 0).all(-1) & (zn > 0).all(-1)
        stuck = ~finite | (a < 1e-10)
        for i, (lv, st, fin) in enumerate(zip(live.tolist(), stuck.tolist(),
                                              finite.tolist())):
            if lv and st:
                status[i] = "unknown" if fin else "singular"
                iters[i] = it
        step = live & ~stuck
        x = torch.where(step[:, None], xn, x)
        y = torch.where(step[:, None], yn, y)
        s = torch.where(step[:, None], sn, s)
        z = torch.where(step[:, None], zn, z)
        live = step
    for i in range(B):
        if status[i] == "running":
            status[i], iters[i] = "unknown", maxiters
    return {"x": x, "y": y, "s": s, "z": z, "status": status,
            "iterations": iters}


def judge(data, out, tol):
    """Per lane, in float64 on the data's device, how a claimed solution
    `out` (x, y, s, z, each with the batch first) meets the optimality
    conditions that the tolerances `tol` (feastol, abstol, reltol) state:
    a dict of lists
      residual  the largest of the relative primal and dual residuals and
                of how far s or z leaves the orthant (within tolerance:
                at most feastol);
      gap       the duality gap s'z over abstol, or the relative gap over
                reltol, whichever is smaller (within tolerance: at most 1);
                a reading only, since a float32 solve drives s'z lower
                than a float64 one and so gap cannot tell them apart.
    A lane whose numbers are not finite reads inf in both."""
    f = torch.float64
    P, q, G, h, A, b = (data[k].to(f) for k in ("P", "q", "G", "h", "A",
                                                 "b"))
    x, y, s, z = (out[k].to(device=q.device, dtype=f)
                  for k in ("x", "y", "s", "z"))
    pres, dres, gap, _, relgap, _ = measures(P, q, G, h, A, b, x, y, s, z)
    outside = torch.maximum(torch.clamp(-s.amin(-1), min=0.0),
                            torch.clamp(-z.amin(-1), min=0.0))
    residual = torch.maximum(torch.maximum(pres, dres), outside)
    gapr = torch.minimum(gap.abs() / tol["abstol"],
                         torch.where(relgap >= 0, relgap,
                                     torch.full_like(relgap, math.inf))
                         / tol["reltol"])
    inf = torch.full_like(residual, math.inf)
    bad = ~torch.isfinite(residual) | torch.isnan(gapr)
    return {"residual": torch.where(bad, inf, residual).tolist(),
            "gap": torch.where(bad, inf, gapr).tolist()}
