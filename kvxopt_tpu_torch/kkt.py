"""KKT factorization strategies, batched over a leading axis.

Counterpart of kvxopt_tpu/kkt.py.  A strategy is

    make_kkt_solver(name, dims, G, A, P=None, mnl=0, reg=0.0)
        -> factor(W, H=None, Df=None)
        -> solve(bx, by, bz) -> (ux, uy, uz)

solving the scaled Newton system of the JAX package for every lane of a
batch at once: G is (B, m, n), A (B, p, n), P (B, n, n), the right-hand
sides (B, .).  `chol2` also takes G (m, n), A (p, n) and P (n, n)
shared by the lanes: it reads each once, a product with one being a
single GEMM over the lanes (_mv, _tmv), and keeps per lane only what the
lane's scaling makes its own (W^{-T} G, K and its factor).

Every strategy of the JAX package is here: the condensed
normal-equations strategy `chol2` and its mixed-precision forms
`chol2_mixed` / `chol2_mixed_nofb` (f32 factor on kernel K1, f64
refinement), each with a Schur complement over A when p > 0, the
null-space strategies `chol` and `qr`, and the regularized
quasidefinite LDL' strategies `ldl` (the full 3x3 system) and `ldl2`
(uz eliminated), on any l + q + s cone.

`chol2`'s factor also takes factor(W, fallback=lanes): the lanes named
there are factored and solved by `ldl` on those lanes alone, gathered,
and scattered back (_on_ldl).  The IPM core names the lanes whose chol2
step was not finite, or whose K lost a pivot to cancellation (the
solve's `weak`), in solvers.coneprog._coneqp_core; the factor a strategy
returns says whether it takes the keyword (`lane_fallback`).
"""

from __future__ import annotations

from functools import partial

import torch

from . import cones, config, trace
from .cones import ConeDims, NTScaling
from .ops.chol_ls import chol_solve_ls_ref
from .ops.ipm_chol import (chol_factor, chol_solve, k7_route, scaled_gram,
                           tri_lower_solve, tri_lower_t_solve)
from .ops.ozaki import OzakiOperator, ata

STRATEGIES = ("ldl", "ldl2", "chol", "chol2", "qr", "chol2_mixed",
              "chol2_mixed_nofb")
PORTED = STRATEGIES


def _mv(M, x):
    """Batched M @ x for M (B, r, c), or (r, c) shared by the lanes (one
    GEMM), and x (B, c)."""
    if M.ndim == 2:
        return x @ M.mT
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def _tmv(M, x):
    """Batched M' @ x for M (B, r, c), or (r, c) shared by the lanes (one
    GEMM), and x (B, r)."""
    if M.ndim == 2:
        return x @ M
    return torch.matmul(x.unsqueeze(-2), M).squeeze(-2)


def _eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def _trsv(M, b, upper):
    """Batched triangular solve M x = b for b (B, k)."""
    return torch.linalg.solve_triangular(M, b[..., None],
                                         upper=upper)[..., 0]


def make_kkt_solver(name, dims: ConeDims, G, A=None, P=None, mnl: int = 0,
                    reg: float = 0.0, ozaki=None, facref=None):
    """ozaki / facref: None follows config.ozaki_refine /
    config.factor_refine; True/False force; facref="vmap" turns factor
    refinement on exactly when the factor reaches kernel K3 (a CUDA
    batch in f32)."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown kktsolver {name!r}; expected one of "
                         f"{STRATEGIES}")
    if A is None:
        A = G.new_zeros(G.shape[:-2] + (0, G.shape[-1]))
    edims = dims.with_extra_l(mnl) if mnl else dims
    fn = {"chol2": _kkt_chol2, "chol": _kkt_chol, "qr": _kkt_qr,
          "ldl": _kkt_ldl, "ldl2": _kkt_ldl2,
          "chol2_mixed": partial(_kkt_chol2_mixed, ozaki=ozaki,
                                 facref=facref),
          # without the per-lane f64-factor fallback; batch drivers pair
          # it with an all-f64 re-solve of the lanes that failed
          "chol2_mixed_nofb": partial(_kkt_chol2_mixed, fallback=False,
                                      ozaki=ozaki, facref=facref)}[name]
    factor = partial(fn, dims, edims, G, A, P, mnl, reg)
    factor.lane_fallback = name == "chol2"
    return factor


def _geff(G, Df, mnl):
    if mnl:
        if Df is None:
            raise ValueError("Df required when mnl > 0")
        return torch.cat([Df, G], dim=-2) if G.shape[-2] else Df
    return G


def _keff(P, H, G):
    """P + H, or zeros (B, n, n) shaped like G's columns ((n, n) where G
    is shared)."""
    K = None
    for M in (P, H):
        if M is not None:
            K = M if K is None else K + M
    if K is None:
        n = G.shape[-1]
        return G.new_zeros(G.shape[:-2] + (n, n))
    return K


def _chol_spd(K, reg):
    if reg:
        K = K + reg * _eye_like(K)
    return chol_factor(K)


def _spd_chol(K, reg):
    L, Dinv = _chol_spd(K, reg)
    return lambda b: chol_solve(L, Dinv, b)


def _empty_y(bx):
    return torch.zeros((bx.shape[0], 0), dtype=bx.dtype, device=bx.device)


# ---------------------------------------------------------------------------
# chol2 — condensed normal equations (reference misc.py:1352 kkt_chol2)
# ---------------------------------------------------------------------------

def _formed(Gs):
    """A formed Gs = W^{-T} Geff as _condensed_solve reads it: (lanes,
    u -> Gs u, b -> Gs' b)."""
    return Gs.shape[0], partial(_mv, Gs), partial(_tmv, Gs)


def _orthant(G, d):
    """Gs = diag(d)^{-1} G on an orthant, never formed: Gs u = (G u) / d
    and Gs' b = G' (b / d), each one GEMM over the lanes where G is
    shared."""
    return (d.shape[0], lambda u: _mv(G, u) / d,
            lambda b: _tmv(G, b / d))


def _condensed_solve(edims, W, gs, A, ksolve, spd_solver):
    """The Newton-system solve of the condensed strategies: uz eliminated,
    K^{-1} applied by ksolve, and with p > 0 the Schur complement
    S = A K^{-1} A' (K^{-1} A' one ksolve with p right-hand sides) solved
    by spd_solver(S).  gs is Gs as _formed or _orthant give it.  A (p, n)
    shared by the lanes is one right-hand side block for every lane's
    factor, read in place."""
    lanes, gs_mv, gs_tmv = gs
    p = A.shape[-2]
    if p:
        At = A.mT
        if A.ndim == 2:
            At = At.expand(lanes, *At.shape)
        KiAt = ksolve(At)
        ssolve = spd_solver(A @ KiAt if A.ndim == 3 else KiAt.mT @ A.mT)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        f = bx + gs_tmv(bzs)
        if p:
            Kif = ksolve(f)
            uy = ssolve(_mv(A, Kif) - by)
            ux = Kif - _mv(KiAt, uy)
        else:
            ux = ksolve(f)
            uy = _empty_y(bx)
        # uz = (W'W)^{-1} (Geff ux - bz) = W^{-1} (Gs ux - W^{-T} bz)
        uz = cones.scale(edims, W, gs_mv(ux) - bzs, inverse=True)
        return ux, uy, uz

    return solve


# A pivot of chol2's K that keeps less than this share of its diagonal
# has lost ~12 of its 16 digits to cancellation: the lane's factor is
# about to break down (kkt._on_ldl), and the core moves the lane to the
# fallback from its next step.  On the OSQP lasso the lanes that break
# read 7e-13 to 6e-16 the step before, those that do not 1e-7 to 1e-10
# at their last step; where no two rows of G share a variable (an
# orthant on the variables, as in the portfolio) K's pivots keep their
# diagonal whole.
WEAK_PIVOT = 1e-12


def _weak_chol(K, reg):
    """(b -> K^{-1} b, the (B,) lanes whose Cholesky factor of K + reg I
    holds a pivot below WEAK_PIVOT of its diagonal)."""
    L, Dinv = _chol_spd(K, reg)
    Ld, Kd = (torch.diagonal(M, dim1=-2, dim2=-1) for M in (L, K))
    # K_ii + reg - L_ii^2 / WEAK_PIVOT > 0 at a weak pivot; NaN reads False
    weak = torch.addcmul(Kd + reg if reg else Kd, Ld, Ld,
                         value=-1.0 / WEAK_PIVOT).amax(-1) > 0
    return (lambda b: chol_solve(L, Dinv, b)), weak


def _kkt_chol2(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None,
               fallback=None):
    """Eliminate uz, factor K = P + H + Gs'Gs (Gs = W^{-T} Geff), then a
    Schur complement S = A K^{-1} A' over the equality constraints.  On an
    orthant (no q or s rows) where k7_route takes the shape, Gs =
    diag(d)^{-1} Geff is never formed: K + reg I comes from Geff and d
    (scaled_gram), and the solve applies Gs through Geff.  fallback: the
    indices of the lanes that `ldl` serves instead (_on_ldl), or None.
    The solve's `weak` is the (B,) mask of lanes whose K lost most of a
    pivot (WEAK_PIVOT)."""
    Geff = _geff(G, Df, mnl)
    if not (edims.q or edims.s) and k7_route(Geff.device, Geff.dtype,
                                             *Geff.shape[-2:]):
        C0 = None if P is None and H is None else _keff(P, H, G)
        ksolve, weak = _weak_chol(scaled_gram(C0, Geff, W.d, reg), 0.0)
        gs = _orthant(Geff, W.d)
    else:
        Gs = cones.wtw_scale_cols(edims, W, Geff)
        ksolve, weak = _weak_chol(
            _keff(P, H, G) + Gs.transpose(-1, -2) @ Gs, reg)
        gs = _formed(Gs)
    solve = _condensed_solve(edims, W, gs, A, ksolve,
                             lambda S: _spd_chol(S, reg))
    if fallback is not None:
        solve = _on_ldl(solve, fallback, dims, edims, G, A, P, mnl, reg, W,
                        H, Df)
    solve.weak = weak
    return solve


def _on_ldl(solve, lanes, dims, edims, G, A, P, mnl, reg, W, H, Df):
    """chol2's solve with the lanes `lanes` answered by `ldl` (_kkt_ldl,
    its regularization and one refinement step) on those lanes alone.

    Where a variable's two orthant rows make it a 2x2 block of K whose
    eigenvalues differ by orders (lasso's -t <= x <= t with one row
    active: D1 [[1, -1], [-1, 1]] + D2 [[1, 1], [1, 1]], D1/D2 -> 1e16),
    K's second pivot there is a difference of two numbers of size D1 and
    its Cholesky factor breaks down.  `ldl` keeps W^{-T} G as its own
    block of the augmented system and never forms that block.  chol2
    still factors every lane, so its kernels keep the batch's shapes; the
    named lanes' answers are replaced."""
    idx = torch.as_tensor(lanes, dtype=torch.long)
    k = idx.shape[0]
    trace.count("kkt.fallback_lanes", k)

    def take(M):
        # a matrix shared by the lanes (2-D) becomes a stride-0 batch
        if M is None:
            return None
        return M[idx] if M.ndim == 3 else M.expand(k, *M.shape)

    with trace.span("kkt.fallback"):
        if G.device.type == "cuda":
            # from pinned memory the copy does not wait for the card
            idx = idx.pin_memory().to(G.device, non_blocking=True)
        Wk = NTScaling(*(tuple(t[idx] for t in f) if isinstance(f, tuple)
                         else f[idx] for f in W))
        lsolve = _kkt_ldl(dims, edims, take(G), take(A), take(P), mnl, reg,
                          Wk, take(H), take(Df))

    def both(bx, by, bz):
        ux, uy, uz = solve(bx, by, bz)
        with trace.span("kkt.fallback"):
            fx, fy, fz = lsolve(bx[idx], by[idx], bz[idx])
            return (ux.index_copy(0, idx, fx), uy.index_copy(0, idx, fy),
                    uz.index_copy(0, idx, fz))

    return both


# ---------------------------------------------------------------------------
# chol2_mixed — factor in float32, recover float64 accuracy by refinement
# against the f64 operator.
# ---------------------------------------------------------------------------

def cond_any(pred, true_fn, false_fn, *ops):
    """Per-lane select between two branches where the (expensive) true
    branch runs only if some lane needs it: the batched form of
    `lax.cond(pred, ...)` that kvxopt_tpu.kkt.cond_any gives a vmapped
    trace.  pred is (B,) bool.  Where every lane takes the true branch,
    the false one does not run, as under a real lax.cond (a lane of
    batched_qp_solver_seq)."""
    n_true = int(pred.sum())
    if n_true == pred.numel():
        return true_fn(*ops)
    out_f = false_fn(*ops)
    if not n_true:
        return out_f
    out_t = true_fn(*ops)
    return torch.where(pred.reshape((-1,) + (1,) * (out_t.ndim - 1)),
                       out_t, out_f)


def _mixed_core(kmul, K32, dtype, k64_build, max_refine=30,
                rtol_factor=500.0, fallback=True, keq64_build=None):
    """Equilibrated f32 Cholesky + f64 preconditioned CG against the
    operator kmul, with an optional f64-factor fallback for lanes whose
    measured refinement contraction says f32 carries too little
    information.

    - kmul(X): exact (f64) product with the SPD matrices, X (B, n, k);
    - K32: the (B, n, n) f32 matrices to factor;
    - k64_build(): the dense f64 matrices, built only if a lane falls
      back;
    - keq64_build(dsc): the equilibrated f64 matrices to ~1e-12, for the
      one-shot factor refinement (None: off).

    Returns ksolve(b) for b (B, n), or (B, n, k) for k right-hand sides
    solved at once, each column refined on its own as the JAX package's
    vmap over columns refines it; with the fallback, ksolve.bad is the
    (B,) mask of lanes that took it."""
    eps64 = torch.finfo(dtype).eps
    dsc32 = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(K32, dim1=-2, dim2=-1), min=1e-30))
    Keq32 = K32 * dsc32[:, :, None] * dsc32[:, None, :]
    L32, Di32 = _chol_spd(Keq32, 0.0)
    dsc = dsc32.to(dtype)
    dsc3 = dsc[:, :, None]

    D32 = None
    if keq64_build is not None:
        # One-shot factor refinement: with E = Keq - L0 L0' to ~1e-12
        # (exact-split Gram), D = L0 Phi(L0^{-1} E L0^{-T}) (Phi = strict
        # lower + half diagonal) makes (L0+D)(L0+D)' = Keq to O(eps32^2);
        # applied first-order around the base solve S0 = (L0 L0')^{-1}:
        #   (MM')^{-1} r ~ u - S0(D L0' u + L0 D' u),  u = S0 r.
        # The two n-RHS triangular solves run on kernel K3.
        Keq64 = keq64_build(dsc)
        L0_64 = L32.to(dtype)
        E32 = (Keq64 - ata(L0_64.transpose(-1, -2))).to(K32.dtype)
        F1 = tri_lower_solve(L32, Di32, E32)
        F = tri_lower_solve(L32, Di32,
                            F1.transpose(-1, -2)).transpose(-1, -2)
        Phi = torch.tril(F, -1) + 0.5 * torch.diag_embed(
            torch.diagonal(F, dim1=-2, dim2=-1))
        D32 = L32 @ Phi

    def m_apply(R):
        # approximate K^{-1} R through the equilibrated f32 factor
        R32 = (dsc3 * R).to(K32.dtype)
        if D32 is None:
            return dsc3 * chol_solve(L32, Di32, R32).to(dtype)
        U = chol_solve(L32, Di32, R32)
        Wd = D32 @ (L32.transpose(-1, -2) @ U) + L32 @ (
            D32.transpose(-1, -2) @ U)
        Z = U - chol_solve(L32, Di32, Wd)
        return dsc3 * Z.to(dtype)

    def norm(V):
        return torch.linalg.vector_norm(V, dim=-2)

    def dot(U, V):
        return torch.sum(U * V, dim=-2)

    def solve32(b):
        # Preconditioned CG on K X = b, the f32 factor as preconditioner,
        # for b (B, n, k).  Each (lane, column) iterates until its own
        # exit holds; a finished one's carry is frozen, as in a vmapped
        # lax.while_loop.
        bn = norm(b)
        tol = rtol_factor * eps64 * torch.clamp(bn, min=1e-300)
        x = m_apply(b)
        r = b - kmul(x)
        z = m_apply(r)
        p = z
        rz = dot(r, z)
        xb = x
        rb = norm(r)
        since = torch.zeros_like(rb, dtype=torch.int32)
        k = torch.zeros_like(since)
        while True:
            live = ((rb > tol) & (k < max_refine) & (since < 8) &
                    torch.isfinite(rb))
            if not bool(live.any()):
                return xb
            Kp = kmul(p)
            pKp = dot(p, Kp)
            alpha = rz / torch.where(pKp > 0, pKp,
                                     torch.full_like(pKp, float("inf")))
            x_ = x + alpha[:, None] * p
            r_ = r - alpha[:, None] * Kp
            z_ = m_apply(r_)
            rz2 = dot(r_, z_)
            # rz can go negative (the f32 preconditioner is only
            # approximately PD); the floor must keep its sign
            beta = torch.where(torch.abs(rz) > 1e-300, rz2 / rz,
                               torch.zeros_like(rz))
            p_ = z_ + beta[:, None] * p
            rn = norm(r_)
            better = torch.isfinite(rn) & (rn < rb)
            xb_ = torch.where(better[:, None], x_, xb)
            rb_ = torch.where(better, rn, rb)
            since_ = torch.where(better, torch.zeros_like(since), since + 1)
            lv = live[:, None]
            x = torch.where(lv, x_, x)
            r = torch.where(lv, r_, r)
            z = torch.where(lv, z_, z)
            p = torch.where(lv, p_, p)
            rz = torch.where(live, rz2, rz)
            xb = torch.where(lv, xb_, xb)
            rb = torch.where(live, rb_, rb)
            since = torch.where(live, since_, since)
            k = torch.where(live, k + 1, k)

    def columns(solve3):
        def ksolve(b):
            if b.ndim == 2:
                return solve3(b[:, :, None])[:, :, 0]
            return solve3(b)
        return ksolve

    if not fallback:
        return columns(solve32)

    # probe the actual refinement contraction rate per lane
    b0 = dsc3 / norm(dsc3)[:, None]
    x0 = m_apply(b0)
    r0 = b0 - kmul(x0)
    x1 = x0 + m_apply(r0)
    r1 = b0 - kmul(x1)
    n0 = norm(r0)[:, 0]
    n1 = norm(r1)[:, 0]
    contr = n1 / torch.clamp(n0, min=1e-300)
    bad = (~torch.isfinite(contr)) | (contr > 0.5) | (~torch.isfinite(n0))

    # the f64 factor is built only if some lane needs it; cond_any reads
    # it only then
    L64 = chol_factor(k64_build())[0] if bool(bad.any()) else None

    ksolve = columns(lambda b: cond_any(
        bad, lambda v: chol_solve_ls_ref(L64, None, v), solve32, b))
    ksolve.bad = bad
    return ksolve


def mixed_spd_solver(K, reg=0.0, cdt=None, max_refine=30,
                     rtol_factor=50.0, fallback=True, ozaki=None,
                     facref=None):
    """Dense-matrix wrapper around `_mixed_core` for a batch K (B, n, n)
    (the Schur complements of the mixed strategies, and standalone SPD
    solves)."""
    cdt = cdt or config.compute_dtype
    if reg:
        K = K + reg * _eye_like(K)
    if ozaki is None:
        ozaki = config.ozaki_refine
    if facref is None:
        facref = config.factor_refine
    if ozaki:
        kmul = OzakiOperator(K).mm
    else:
        def kmul(X):
            return K @ X
    keq = None
    if facref:
        def keq(dsc):
            return K * dsc[:, :, None] * dsc[:, None, :]
    return _mixed_core(kmul, K.to(cdt), K.dtype, lambda: K, max_refine,
                       rtol_factor, fallback, keq64_build=keq)


def _kkt_chol2_mixed(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None,
                     fallback=True, ozaki=None, facref=None):
    """Condensed normal equations with the mixed-precision SPD solver:
    K = P + Gs'Gs formed and factored in f32, f64 work limited to
    operator products inside the refinement loop.  With p > 0, K^{-1} A'
    is one solve with p right-hand sides and the Schur complement
    S = A K^{-1} A' gets a mixed-precision solver of its own."""
    cdt = config.compute_dtype
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    Gs32 = Gs.to(cdt)
    Kx32 = _keff(P, H, G).to(cdt) + Gs32.transpose(-1, -2) @ Gs32
    if reg:
        Kx32 = Kx32 + reg * _eye_like(Kx32)

    if ozaki is None:
        ozaki = config.ozaki_refine
    if ozaki:
        gop = OzakiOperator(Gs)
        ops = [OzakiOperator(M) for M in (P, H) if M is not None]

        def kmul(X):
            out = gop.normal_mm(X)
            for op in ops:
                out = out + op.mm(X)
            if reg:
                out = out + reg * X
            return out
    else:
        def kmul(X):
            out = Gs.transpose(-1, -2) @ (Gs @ X)
            for M in (P, H):
                if M is not None:
                    out = out + M @ X
            if reg:
                out = out + reg * X
            return out

    def k64_build():
        K = _keff(P, H, G) + Gs.transpose(-1, -2) @ Gs
        if reg:
            K = K + reg * _eye_like(K)
        return K

    if facref == "vmap":
        # refine exactly when the setup's n-RHS solves run on kernel K3
        facref = (config.factor_refine and cdt == torch.float32
                  and G.device.type == "cuda")
    elif facref is None:
        facref = config.factor_refine
    keq64_build = None
    if facref:

        def keq64_build(dsc):
            # equilibrated f64 K to ~1e-12 with an exact-split Gram
            K = _keff(P, H, G) + ata(Gs)
            if reg:
                K = K + reg * _eye_like(K)
            return K * dsc[:, :, None] * dsc[:, None, :]

    ksolve = _mixed_core(kmul, Kx32, G.dtype, k64_build,
                         fallback=fallback, keq64_build=keq64_build)
    return _condensed_solve(
        edims, W, _formed(Gs), A, ksolve,
        lambda S: mixed_spd_solver(S, reg, fallback=fallback, ozaki=ozaki,
                                   facref=facref))


# ---------------------------------------------------------------------------
# chol / qr — null-space method (reference misc.py:1213 kkt_chol)
# ---------------------------------------------------------------------------

def _nullspace(A):
    """Full QR of A' -> (Q1 (B,n,p), Q2 (B,n,n-p), R1 (B,p,p))."""
    p = A.shape[-2]
    Q, R = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    return Q[..., :p], Q[..., p:], R[..., :p, :p]


def _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df, spd_solver):
    """Common null-space elimination: x = Q1 w + Q2 v with A' = Q R."""
    p = A.shape[-2]
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    K = _keff(P, H, G) + Gs.transpose(-1, -2) @ Gs
    if p:
        Q1, Q2, R1 = _nullspace(A)
        solve_red = spd_solver(Q2.transpose(-1, -2) @ K @ Q2, reg)
    else:
        solve_full = spd_solver(K, reg)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        f = bx + _tmv(Gs, bzs)
        if p:
            Q1w = _mv(Q1, _trsv(R1.transpose(-1, -2), by, upper=False))
            v = solve_red(_tmv(Q2, f - _mv(K, Q1w)))
            ux = Q1w + _mv(Q2, v)
            uy = _trsv(R1, _tmv(Q1, f - _mv(K, ux)), upper=True)
        else:
            ux = solve_full(f)
            uy = _empty_y(bx)
        uz = cones.scale(edims, W, _mv(Gs, ux) - bzs, inverse=True)
        return ux, uy, uz

    return solve


def _spd_qr(K, reg):
    # QR of the (symmetric PSD) reduced matrix: more robust than Cholesky
    # for nearly singular K
    if reg:
        K = K + reg * _eye_like(K)
    Q, R = torch.linalg.qr(K)
    return lambda b: _trsv(R, _tmv(Q, b), upper=True)


def _kkt_chol(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    return _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df,
                          _spd_chol)


def _kkt_qr(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    return _kkt_nullspace(dims, edims, G, A, P, mnl, reg, W, H, Df, _spd_qr)


# ---------------------------------------------------------------------------
# ldl / ldl2 — regularized quasidefinite factorizations
# (reference misc.py:1055 kkt_ldl, :1128 kkt_ldl2)
# ---------------------------------------------------------------------------

DEFAULT_KKTREG = 1e-9


def _set_diag(M, lo, hi, val):
    """M[:, i, i] = val for lo <= i < hi (a fill of the diagonal's view:
    an indexed store of a Python number waits for the card)."""
    torch.diagonal(M, dim1=-2, dim2=-1)[:, lo:hi].fill_(val)


def ldl_nopiv(M, block: int = 64):
    """Unpivoted blocked LDL' factorization of a batch of quasidefinite
    matrices M (B, n, n): (L (B, n, n) unit lower triangular, d (B, n))
    with M = L diag(d) L'.  As kvxopt_tpu.kkt.ldl_nopiv: M padded with
    the identity to a multiple of `block`, each diagonal block factored
    column by column with rank-one updates, the panel below it by a
    triangular solve and the trailing matrix by one product."""
    Bn, n, _ = M.shape
    nb = -(-n // block) * block
    Mp = M.new_zeros((Bn, nb, nb))
    Mp[:, :n, :n] = M
    _set_diag(Mp, n, nb, 1.0)
    L = torch.zeros_like(Mp)
    _set_diag(L, 0, nb, 1.0)   # once: a scalar store per column would
                               # copy the scalar to the card each time
    d = M.new_zeros((Bn, nb))
    for k0 in range(0, nb, block):
        k1 = k0 + block
        Akk = Mp[:, k0:k1, k0:k1].clone()
        Lkk = L[:, k0:k1, k0:k1]
        for j in range(block):
            pivot = Akk[:, j, j]
            col = Akk[:, j + 1:, j] / pivot[:, None]
            Lkk[:, j + 1:, j] = col
            d[:, k0 + j] = pivot
            Akk[:, j + 1:, j + 1:] -= (col[:, :, None] * col[:, None, :] *
                                       pivot[:, None, None])
        if k1 < nb:
            dk = d[:, k0:k1]
            Lsk = torch.linalg.solve_triangular(
                Lkk, Mp[:, k1:, k0:k1].mT, upper=False).mT / dk[:, None, :]
            Mp[:, k1:, k1:] -= (Lsk * dk[:, None, :]) @ Lsk.mT
            L[:, k1:, k0:k1] = Lsk
    return L[:, :n, :n], d[:, :n]


def ldl_solve(L, d, b):
    """x with L diag(d) L' x = b for b (B, n)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(L.mT, y / d[..., None], upper=True,
                                         unitriangular=True)[..., 0]


def _refined(msolve, rhs, mul):
    """One solve with the regularized factor and one step of iterative
    refinement against the unregularized system, whose product is
    mul(u)."""
    u = msolve(rhs)
    return u + msolve(rhs - mul(u))


def _ldl_solver(M):
    """b -> M^{-1} b through ldl_nopiv's factor of M (B, n, n)."""
    L, d = ldl_nopiv(M)
    return partial(ldl_solve, L, d)


def _qd_solver(M, n):
    """b -> M^{-1} b for a batch of quasidefinite M = [[H, C'], [C, -F]],
    H (n, n) and F positive definite: the unpivoted LDL' that ldl_nopiv
    computes, in two blocks, each a Cholesky factor (ops.ipm_chol's
    route): H = L1 L1', Y = L1^{-1} C' and S = F + Y'Y = L2 L2', so that
    M = [[L1, 0], [Y', L2]] diag(I, -I) [[L1', Y], [0, L2']].  A handful
    of launches where ldl_nopiv's column loop takes ~6 a column."""
    L1 = chol_factor(M[:, :n, :n])[0]
    Y = tri_lower_solve(L1, None, M[:, n:, :n].mT)
    L2 = chol_factor(Y.mT @ Y - M[:, n:, n:])[0]

    def solve(b):
        w = tri_lower_solve(L1, None, b[:, :n])
        u2 = chol_solve(L2, None, _tmv(Y, w) - b[:, n:])
        u1 = tri_lower_t_solve(L1, None, w - _mv(Y, u2))
        return torch.cat([u1, u2], dim=-1)

    return solve


def _kkt_ldl(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    """Full 3x3 LDL' with QDLDL-style +/- regularization (reference
    kkt_ldl with the kktreg option, misc.py:1055-1125)."""
    n, p = G.shape[-1], A.shape[-2]
    eps = reg or DEFAULT_KKTREG
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    N = Gs.shape[-2]
    Kxx = _keff(P, H, G)
    M = G.new_zeros((G.shape[0], n + p + N, n + p + N))
    M[:, :n, :n] = Kxx + eps * _eye_like(Kxx)
    M[:, n:n + p, :n] = A
    M[:, :n, n:n + p] = A.mT
    M[:, n + p:, :n] = Gs
    M[:, :n, n + p:] = Gs.mT
    _set_diag(M, n, n + p, -eps)
    _set_diag(M, n + p, n + p + N, -(1.0 + eps))
    # the same factor: on the card the quasidefinite split, on the CPU the
    # JAX package's recurrence, whose column loop the card's host pays for
    # (ldl_nopiv at order 2040 on an H100: ~140 ms a factor, host-bound)
    msolve = (_qd_solver(M, n) if M.device.type == "cuda"
              else _ldl_solver(M))

    def mul(u):
        ux, uy, uz = u[:, :n], u[:, n:n + p], u[:, n + p:]
        return torch.cat([_mv(Kxx, ux) + _tmv(A, uy) + _tmv(Gs, uz),
                          _mv(A, ux), _mv(Gs, ux) - uz], dim=-1)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        u = _refined(msolve, torch.cat([bx, by, bzs], dim=-1), mul)
        uz = cones.scale(edims, W, u[:, n + p:], inverse=True)
        return u[:, :n], u[:, n:n + p], uz

    return solve


def _kkt_ldl2(dims, edims, G, A, P, mnl, reg, W, H=None, Df=None):
    """2x2 condensed LDL': eliminate uz first (reference kkt_ldl2,
    misc.py:1128)."""
    n, p = G.shape[-1], A.shape[-2]
    eps = reg or DEFAULT_KKTREG
    Geff = _geff(G, Df, mnl)
    Gs = cones.wtw_scale_cols(edims, W, Geff)
    K = _keff(P, H, G) + Gs.mT @ Gs
    M = G.new_zeros((G.shape[0], n + p, n + p))
    M[:, :n, :n] = K + eps * _eye_like(K)
    M[:, n:, :n] = A
    M[:, :n, n:] = A.mT
    _set_diag(M, n, n + p, -eps)
    msolve = _ldl_solver(M)

    def mul(u):
        ux, uy = u[:, :n], u[:, n:]
        return torch.cat([_mv(K, ux) + _tmv(A, uy), _mv(A, ux)], dim=-1)

    def solve(bx, by, bz):
        bzs = cones.scale(edims, W, bz, trans=True, inverse=True)
        u = _refined(msolve, torch.cat([bx + _tmv(Gs, bzs), by], dim=-1),
                     mul)
        ux = u[:, :n]
        uz = cones.scale(edims, W, _mv(Gs, ux) - bzs, inverse=True)
        return ux, u[:, n:], uz

    return solve
