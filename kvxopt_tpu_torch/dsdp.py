"""SDP solver in the DSDP5 interface style (reference src/C/dsdp.c:
sdp(c, Gl, hl, Gs, hs, gamma, beta) with DSDP_* options).

The reference wraps the DSDP5 dual-scaling solver.  This build
implements the SAME ALGORITHM FAMILY natively — a dual-scaling
potential-reduction method (Benson/Ye/Zhang) on the reference's
penalized, box-bounded formulation (dsdp.c:44-57):

    minimize    c'x + gamma*r
    subject to  Gl x <= hl + r*1
                mat(Gs[k] x) <= hs[k] + r*I,   k = 1..L
                -beta <= x <= beta,   r >= 0

which is always strictly feasible (x = 0, r large), so the method needs
no phase-1.  Unlike the primal-dual conelp core (solvers/), the
iteration maintains ONLY the dual slack S(v) = H - A(v) of the point
v = (x, r): each step factors S, solves the Schur system
M d = -(c_hat/mu + g) with M_ij = sum_k tr(S_k^-1 A_i S_k^-1 A_j), and
derives a candidate multiplier Z = mu (S^-1 + S^-1 A(d) S^-1) whose
feasibility (Z >= 0) certifies the lower bound -<H, Z> — the defining
structure of dual scaling (only one matrix inequality is tracked, and
objective bounds come from the Newton by-product).

Options honored (dsdp.c / reference test_dsdp.py): DSDP_Monitor,
DSDP_MaxIts, DSDP_GapTolerance (default 1e-5).  Return format matches
the reference: (status, x, r, zl, zs) with status 'DSDP_PDFEASIBLE',
'DSDP_INFEASIBLE' (penalty r stays active), 'DSDP_UNBOUNDED' (the box
binds), or 'DSDP_UNKNOWN'.  Set options['DSDP_UseConelp'] = 1 to route
through the native conelp core instead (the pre-round-5 behavior).

Problem sizes here are CPU-scale (the reference's DSDP is a CPU code);
the iteration runs in numpy f64 on the host.  The DSDP_UseConelp route
solves with kvxopt_tpu_torch.solvers.sdp on config.default_device and
brings its result to the host.  Copy of kvxopt_tpu/dsdp.py but for that
route."""

import numpy as np

from .base import matrix

options = {}


def _sym_from_lower(M):
    """Reference contract: only the LOWER triangle of mat(Gs[:,i]) and
    hs[k] is accessed (dsdp.c docstring)."""
    L = np.tril(M)
    return L + L.T - np.diag(np.diag(M))


def _dual_scaling(c, Glm, hlv, Amats, Hmats, gamma, beta, maxits, tol,
                  monitor):
    """Core dual-scaling iteration on v = (x, r).  Amats[k]: (n+1, m, m)
    coefficient stack of block k (A_r = -I); Hmats[k]: (m, m) rhs."""
    n = len(c)
    ml = len(hlv)
    chat = np.concatenate([c, [gamma]])

    # strictly feasible start: x = 0, r big enough for every slack
    r0 = 1.0
    if ml:
        r0 = max(r0, 1.5 * max(0.0, -float(hlv.min())) + 1.0)
    lmins = [float(np.linalg.eigvalsh(H)[0]) for H in Hmats]
    for lm in lmins:
        r0 = max(r0, 1.5 * max(0.0, -lm) + 1.0)
    v = np.zeros(n + 1)
    v[n] = r0

    # LP-type rows as (a, h) with slack h - a'v:
    #   Gl rows: a = (Gl_i, -1), h = hl_i
    #   box:     a = (+-e_i, 0), h = beta
    #   r >= 0:  a = (0, -1),    h = 0
    rows_a = []
    rows_h = []
    if ml:
        rows_a.append(np.hstack([Glm, -np.ones((ml, 1))]))
        rows_h.append(hlv)
    eye = np.eye(n)
    rows_a.append(np.hstack([eye, np.zeros((n, 1))]))
    rows_h.append(np.full(n, beta))
    rows_a.append(np.hstack([-eye, np.zeros((n, 1))]))
    rows_h.append(np.full(n, beta))
    ar = np.zeros((1, n + 1))
    ar[0, n] = -1.0
    rows_a.append(ar)
    rows_h.append(np.zeros(1))
    Arows = np.vstack(rows_a)           # (nrows, n+1)
    hrows = np.concatenate(rows_h)

    nu = len(hrows) + sum(H.shape[0] for H in Hmats)
    rho = nu + 5.0 * np.sqrt(nu)

    # valid initial lower bound: c'x + gamma r >= -beta*||c||_1
    zlow = -beta * float(np.abs(c).sum()) - 1.0
    Zbest = None
    status = "DSDP_UNKNOWN"

    def slacks(v):
        s = hrows - Arows @ v
        Ss = [H - np.einsum("imn,i->mn", A, v)
              for A, H in zip(Amats, Hmats)]
        return s, Ss

    def potential(v, zlow):
        s, Ss = slacks(v)
        if (s <= 0).any():
            return np.inf
        ld = 0.0
        for S in Ss:
            sign, l2 = np.linalg.slogdet(S)
            if sign <= 0:
                return np.inf
            ld += l2
        gap = chat @ v - zlow
        if gap <= 0:
            return -np.inf
        return rho * np.log(gap) - np.log(s).sum() - ld

    for it in range(maxits):
        s, Ss = slacks(v)
        gap = chat @ v - zlow
        if monitor and it % int(monitor) == 0:
            print(f"DSDP it {it}: obj {chat @ v:.6e} bound "
                  f"{zlow:.6e} gap {gap:.2e}")
        if gap <= tol * (1.0 + abs(zlow)):
            status = "DSDP_CONVERGED"
            break
        mu = gap / rho

        # Schur matrix + gradient of the log-barrier
        M = (Arows / (s ** 2)[:, None]).T @ Arows
        g = Arows.T @ (1.0 / s)
        Ws, Ls = [], []
        Tmats = []
        for A, S in zip(Amats, Ss):
            L = np.linalg.cholesky(S)
            W = np.linalg.inv(S)
            Ws.append(W)
            Ls.append(L)
            T = np.einsum("mp,ipq,qn->imn", W, A, W)   # W A_i W
            Tmats.append(T)
            M += np.einsum("imn,jmn->ij", A, T)
            g += np.einsum("imn,nm->i", A, W)
        d = np.linalg.solve(M + 1e-12 * np.eye(n + 1), -(chat / mu + g))

        # candidate multiplier Z = mu (W + W A(d) W): A^T(Z) = -chat
        zrows = mu * (1.0 / s + (Arows @ d) / s ** 2)
        Zs = [mu * (W + np.einsum("imn,i->mn", T, d))
              for W, T in zip(Ws, Tmats)]
        feas = (zrows >= 0).all() and all(
            np.linalg.eigvalsh(0.5 * (Z + Z.T))[0] >= 0 for Z in Zs)
        if feas:
            bound = -(hrows @ zrows) - sum(
                np.sum(H * Z) for H, Z in zip(Hmats, Zs))
            if bound > zlow:
                zlow = bound
                Zbest = (zrows.copy(), [Z.copy() for Z in Zs])
                # the bound jump reshapes the potential: recompute the
                # direction for the new mu (M and g are unchanged, so
                # this reuses the factorizations — the classic
                # dual-scaling bound-update re-centering)
                gap = chat @ v - zlow
                if gap <= tol * (1.0 + abs(zlow)):
                    status = "DSDP_CONVERGED"
                    break
                mu = gap / rho
                d = np.linalg.solve(M + 1e-12 * np.eye(n + 1),
                                    -(chat / mu + g))

        # step: largest alpha keeping every slack strictly positive
        ad = Arows @ d
        alpha = np.inf
        pos = ad > 0
        if pos.any():
            alpha = min(alpha, float((s[pos] / ad[pos]).min()))
        for Lk, A in zip(Ls, Amats):
            Ad = np.einsum("imn,i->mn", A, d)
            T = np.linalg.solve(Lk, np.linalg.solve(Lk, Ad).T)
            lmax = float(np.linalg.eigvalsh(0.5 * (T + T.T))[-1])
            if lmax > 0:
                alpha = min(alpha, 1.0 / lmax)
        alpha = 0.98 * min(alpha, 10.0)

        # backtracking on the potential
        p0 = potential(v, zlow)
        best_v, best_p = v, p0
        a = alpha
        for _ in range(12):
            cand = v + a * d
            pc = potential(cand, zlow)
            if pc < best_p:
                best_v, best_p = cand, pc
                break
            a *= 0.5
        if best_p >= p0:    # no descent: stall
            break
        v = best_v

    converged = status == "DSDP_CONVERGED"
    x, r = v[:n], float(v[n])
    s, Ss = slacks(v)
    if converged:
        href = 1.0 + (float(np.abs(hlv).max()) if ml else 0.0) + max(
            [float(np.abs(H).max()) for H in Hmats], default=0.0)
        if r > 1e-5 * href * max(1.0, r0):
            status = "DSDP_INFEASIBLE"
        elif n and float(np.abs(x).max()) >= 0.999 * beta:
            status = "DSDP_UNBOUNDED"
        else:
            status = "DSDP_PDFEASIBLE"
    else:
        status = "DSDP_UNKNOWN"

    if Zbest is not None:
        zrows, Zs = Zbest
    else:
        zrows, Zs = np.zeros(len(hrows)), [np.zeros_like(H)
                                           for H in Hmats]
    zl = zrows[:ml] if ml else np.zeros(0)
    return status, x, r, zl, Zs


def sdp(c, Gl=None, hl=None, Gs=None, hs=None, gamma=1e8, beta=1e7,
        options=None):
    """Solve the DSDP-form SDP (see module docstring) with the native
    dual-scaling method.  Options: DSDP_Monitor, DSDP_MaxIts,
    DSDP_GapTolerance (1e-5), DSDP_UseConelp (route to the conelp
    core).  Returns (status, x, r, zl, zs) exactly like the reference
    dsdp.c wrapper."""
    merged = dict(globals()["options"])
    if options is not None:
        merged.update(options)
    if merged.get("DSDP_UseConelp", 0):
        return _conelp_sdp(c, Gl, hl, Gs, hs, merged)

    cv = np.asarray(c, dtype=float).reshape(-1)
    n = len(cv)
    ml = 0 if hl is None else int(np.asarray(hl).size)
    Glm = (np.asarray(Gl, dtype=float).reshape(ml, n) if ml
           else np.zeros((0, n)))
    hlv = (np.asarray(hl, dtype=float).reshape(-1) if ml
           else np.zeros(0))
    Gs = Gs or []
    hs = hs or []
    ms = [int(np.asarray(hk).shape[0]) for hk in hs]
    Amats, Hmats = [], []
    for Gk, hk, m in zip(Gs, hs, ms):
        Gkm = np.asarray(Gk, dtype=float).reshape(m * m, n)
        A = np.empty((n + 1, m, m))
        for i in range(n):
            A[i] = _sym_from_lower(Gkm[:, i].reshape(m, m))
        A[n] = -np.eye(m)                       # coefficient of r
        Amats.append(A)
        Hmats.append(_sym_from_lower(np.asarray(hk, float).reshape(m, m)))

    maxits = int(merged.get("DSDP_MaxIts", 200))
    tol = float(merged.get("DSDP_GapTolerance", 1e-5))
    monitor = int(merged.get("DSDP_Monitor", 0) or 0)

    status, x, r, zl, zs = _dual_scaling(
        cv, Glm, hlv, Amats, Hmats, float(gamma), float(beta), maxits,
        tol, monitor)

    xm = matrix(np.asarray(x, float).reshape(-1, 1))
    zlm = matrix(np.asarray(zl, float).reshape(-1, 1)) if ml else \
        matrix(np.zeros((0, 1)))
    zsm = [matrix(np.asarray(Z, float)) for Z in zs]
    return (status, xm, matrix(float(r)), zlm, zsm)


def _conelp_sdp(c, Gl, hl, Gs, hs, merged):
    """The conelp-core route (interface parity path, pre-round-5): the
    port's solvers.sdp, on config.default_device."""
    from .solvers import sdp as _sdp
    from .solvers._conelp import _host
    solver_opts = {}
    if "DSDP_MaxIts" in merged:
        solver_opts["maxiters"] = int(merged["DSDP_MaxIts"])
    if "DSDP_GapTolerance" in merged:
        solver_opts["reltol"] = float(merged["DSDP_GapTolerance"])
    if merged.get("DSDP_Monitor", 0):
        solver_opts["show_progress"] = True
    sol = _sdp(c, Gl=Gl, hl=hl, Gs=Gs, hs=hs, options=solver_opts)
    if sol["status"] == "optimal":
        status = "DSDP_PDFEASIBLE"
    elif sol["status"] == "primal infeasible":
        status = "DSDP_INFEASIBLE"
    elif sol["status"] == "dual infeasible":
        status = "DSDP_UNBOUNDED"
    else:
        status = "DSDP_UNKNOWN"
    x = sol.get("x")
    if x is not None:
        x = matrix(_host(x).reshape(-1, 1))
    zl = sol.get("zl")
    if zl is not None:
        zl = matrix(_host(zl).reshape(-1, 1))
    zs = [matrix(_host(zk)) for zk in sol.get("zs", [])] \
        if sol.get("zs") is not None else None
    r = matrix(0.0)
    return (status, x, r, zl, zs)
