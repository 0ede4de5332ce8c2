"""cvxbook and demo examples on the port (the problems of the JAX
package's tests/test_book_examples5.py): book/chap6/consumerpref (a
family of LPs over concavity, monotonicity and preference constraints
through the DSL), book/chap6/inputdesign (regularized least-norm input
design by lapack.gels, a host facade as in the JAX package),
book/chap7/probbounds (Chebyshev probability lower bounds by sdp, the
bounding ellipse by lapack.posv), filterdemo (a Chebyshev FIR lowpass
through the DSL) and book/chap4/rls (bounds on sphere-constrained least
squares by two SDPs).  Data synthesized or reduced as in the JAX
tests."""

from math import cos, pi, sqrt

import numpy as np

from kvxopt_tpu_torch import lapack, matrix
from kvxopt_tpu_torch.examples._data import to_numpy
from kvxopt_tpu_torch.models.modeling import op, variable
from kvxopt_tpu_torch.models.modeling import max as mmax
from kvxopt_tpu_torch.solvers import sdp


# ---------------------------------------------------------------------------
# consumerpref (reference examples/book/chap6/consumerpref.py:88-113,
# reduced to the first 12 baskets)

_BASKETS = [
    0.45, 0.96, 0.21, 0.34, 0.28, 0.87, 0.96, 0.03, 0.08, 0.92,
    0.02, 0.22, 0.00, 0.39, 0.26, 0.64, 0.35, 0.97, 0.91, 0.78,
    0.12, 0.14, 0.58, 0.84,
]


def consumerpref_data(seed=None, m=12):
    """B (2, m): the baskets as columns (no random data)."""
    return np.asarray(_BASKETS[:2 * m], dtype=float).reshape(m, 2).T


def _utility(x, y):
    return (1.1 * np.sqrt(x) + 0.8 * np.sqrt(y)) / 1.9


def consumerpref(B):
    """The reference's classification loop (consumerpref.py:97-113):
    basket k is 'rejected' if minimize -u[k] is optimal with a positive
    value, else 'preferred' if minimize u[k] is, else 'neutral';
    statuses other than 'optimal' are part of the semantics -> (labels,
    values (m, 2): the two optimal values, NaN where not optimal)."""
    m = B.shape[1]
    order = np.argsort(_utility(B[0], B[1]))
    u, gx, gy = variable(m), variable(m), variable(m)
    gxc, gyc = variable(1), variable(1)
    cons = [gx >= 0, gy >= 0, gxc >= 0, gyc >= 0]
    cons += [u[int(order[j + 1])] >= u[int(order[j])] + 1.0
             for j in range(m - 1)]
    cons += [u[j] <= u[i] + gx[i] * (B[0, j] - B[0, i])
             + gy[i] * (B[1, j] - B[1, i])
             for i in range(m) for j in range(m)]
    cons += [0 <= u[i] + gx[i] * (0.5 - B[0, i]) + gy[i] * (0.5 - B[1, i])
             for i in range(m)]
    cons += [u[j] <= gxc * (B[0, j] - 0.5) + gyc * (B[1, j] - 0.5)
             for j in range(m)]

    def solve(k, sign):
        p = op(sign * u[k], cons)
        p.solve()
        v = float(np.asarray(p.objective.value()).reshape(-1)[0]) \
            if p.status == "optimal" else np.nan
        return p.status, v

    labels, vals = [], np.full((m, 2), np.nan)
    for k in range(m):
        st, v = solve(k, -1)
        vals[k, 0] = v
        if st == "optimal" and v > 1e-7:
            labels.append("rejected")
            continue
        st, v = solve(k, +1)
        vals[k, 1] = v
        labels.append("preferred" if st == "optimal" and v > 1e-7
                      else "neutral")
    return labels, vals


# ---------------------------------------------------------------------------
# inputdesign (book/chap6/inputdesign.py:27-37)

def inputdesign_data(seed=None, n=201):
    """(H (n, n), ydes (n,)): the convolution of the plant's impulse
    response and the desired output (no random data)."""
    H = np.zeros((n, n))
    for t in range(n):
        H += np.diag(np.full(n - t, (1.0 / 9.0) * 0.9 ** t
                             * (1.0 - 0.4 * cos(2 * t))), -t)
    ydes = np.concatenate([np.zeros(40), np.ones(50), -np.ones(50),
                           np.zeros(n - 140)])
    return H, ydes


INPUTDESIGN_WEIGHTS = ((0.0, 0.005), (0.0, 0.05), (0.3, 0.05))


def inputdesign_system(data, delta, eta):
    """The stacked least-squares system [H; sqrt(eta) I; sqrt(delta) D]
    u = [ydes; 0] of one (delta, eta) setting -> (AA, bb)."""
    H, ydes = data
    n = H.shape[0]
    D = np.zeros((n - 1, n))
    D[np.arange(n - 1), np.arange(n - 1)] = -1.0
    D[np.arange(n - 1), np.arange(1, n)] = 1.0
    AA = np.vstack([H, sqrt(eta) * np.eye(n), sqrt(delta) * D])
    return AA, np.concatenate([ydes, np.zeros(2 * n - 1)])


def inputdesign(data):
    """The input u of each (delta, eta) of INPUTDESIGN_WEIGHTS by
    lapack.gels."""
    n = data[0].shape[0]
    out = []
    for delta, eta in INPUTDESIGN_WEIGHTS:
        AA, bb = inputdesign_system(data, delta, eta)
        x = matrix(bb.reshape(-1, 1).copy())
        lapack.gels(matrix(AA.copy()), x)
        out.append(np.asarray(x)[:n, 0])
    return out


# ---------------------------------------------------------------------------
# probbounds (book/chap7/probbounds.py:48-115): the Chebyshev lower bound
# on the probability of detecting symbol 0 in its Voronoi cell

def probbounds_data(seed=None, sigmas=(1.0, 1.5)):
    """(A0 (6, 2), b0 (6,), sigmas): the cell {x : A0 x <= b0} and the
    noise levels (no random data)."""
    V = np.array([[1.0, -1.0, -2.0, -2.0, 0.0, 1.5, 1.0],
                  [1.0, 2.0, 1.0, -1.0, -2.0, -1.0, 1.0]])
    m = V.shape[1] - 1
    A0 = np.column_stack([-(V[1, :m] - V[1, 1:]), V[0, :m] - V[0, 1:]])
    return A0, (A0 * V[:, :m].T).sum(axis=1), tuple(sigmas)


def probbounds_problem(A, b, Sigma):
    """The SDP (probbounds.py:48-103) over (P (3 entries), q, r, tau
    (m)) -> (c, Gl, hl, Gs, hs)."""
    m = A.shape[0]
    novars = 6 + m
    c = np.zeros(novars)
    c[0], c[1], c[2] = Sigma[0, 0], 2 * Sigma[1, 0], Sigma[1, 1]
    c[5] = 1.0
    Gs, hs = [], []
    for k in range(m + 1):
        Gk = np.zeros((9, novars))
        Gk[0, 0] = Gk[1, 1] = Gk[4, 2] = -1.0
        Gk[2, 3] = Gk[5, 4] = Gk[8, 5] = -1.0
        hk = np.zeros((3, 3))
        if k < m:
            Gk[2, 6 + k] = 0.5 * A[k, 0]
            Gk[5, 6 + k] = 0.5 * A[k, 1]
            Gk[8, 6 + k] = -b[k]
            hk[2, 2] = -1.0
        Gs.append(Gk)
        hs.append(hk)
    Gl = np.zeros((m, novars))
    Gl[np.arange(m), 6 + np.arange(m)] = -1.0
    return c, Gl, np.zeros(m), Gs, hs


def probbounds(data):
    """For each noise level: the bound, P, q, r and the sdp's solution;
    and the center of the bounding ellipse {x | x'Px + 2q'x + r = 1} of
    the last level by lapack.posv -> (rows, center, scale)."""
    A0, b0, sigmas = data
    rows = []
    for sigma in sigmas:
        Sigma = sigma ** 2 * np.eye(2)
        sol = sdp(*probbounds_problem(A0, b0, Sigma))
        x = to_numpy(sol["x"]).reshape(-1)
        P = x[[0, 1, 1, 2]].reshape(2, 2)
        q, r = x[[3, 4]], x[5]
        bound = 1.0 - Sigma[0, 0] * P[0, 0] - 2 * Sigma[1, 0] * P[1, 0] \
            - Sigma[1, 1] * P[1, 1] - r
        rows.append(dict(bound=bound, P=P, q=q, r=r, sol=sol))
    P, q, r = rows[-1]["P"], rows[-1]["q"], rows[-1]["r"]
    xc = matrix((-q).reshape(2, 1))
    lapack.posv(matrix(P.copy()), xc)
    xc = np.asarray(xc).reshape(-1)
    return rows, xc, 1.0 - r - float(q @ xc)


# ---------------------------------------------------------------------------
# filterdemo (reference examples/filterdemo/filterdemo_cli design_lowpass):
# op(max(abs(G2*h)), [G1*h <= d1, G1*h >= 1/d1])

def filterdemo_data(seed=None, N=10, rp_db=1.0, wc=0.3 * pi, ws=0.5 * pi,
                    Q=20):
    """(G1, G2, d1): the cosine matrices of the pass band [0, wc) and the
    stop band [ws, pi) of an order-N filter, Q points per band unit,
    and the ripple bound d1 (no random data)."""
    n1 = int(round(N * Q * wc / pi))
    n2 = int(round(N * Q * (pi - ws) / pi))
    G1 = np.cos(np.outer(np.linspace(0, wc, n1, endpoint=False),
                         np.arange(N + 1)))
    G2 = np.cos(np.outer(np.linspace(ws, pi, n2, endpoint=False),
                         np.arange(N + 1)))
    return G1, G2, 10 ** (rp_db / 20.0)


def filterdemo(data):
    """The DSL design -> (op, h's value (N + 1,), the stop band's
    attenuation max|G2 h|)."""
    G1, G2, d1 = data
    h = variable(G1.shape[1])
    p = op(mmax(abs(G2 * h)), [G1 * h <= d1, G1 * h >= 1.0 / d1])
    p.solve()
    hv = np.asarray(h.value).reshape(-1)
    return p, hv, float(np.max(np.abs(G2 @ hv)))


# ---------------------------------------------------------------------------
# rls (reference examples/book/chap4/rls.py, fig 4.11): the optimal values
# of min/max ||Ax - b||^2 s.t. x'x = alpha by SDP duals

RLS_LOWER = (0.2, 1.0, 3.0)
RLS_UPPER = (0.2, 0.6)


def rls_data(seed=7, m=6, n=4):
    """(A (m, n), b (m,))."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def rls_gh(data):
    """The example's G ((n+1)^2, 2) and h = [A b]'[A b] of the (t, u)
    SDP."""
    A, b = data
    n = A.shape[1]
    G = np.zeros(((n + 1) ** 2, 2))
    G[-1, 0] = -1.0                        # coefficient of t
    G[: (n + 1) ** 2 - 1: n + 2, 1] = -1.0  # coefficient of u
    Ab = np.hstack([A, b.reshape(-1, 1)])
    return G, Ab.T @ Ab


def rls(data):
    """The lower bounds at RLS_LOWER (h) and the upper bounds at
    RLS_UPPER (-h) -> ([(alpha, value, solution)] lower,
    [(alpha, value, solution)] upper)."""
    G, h = rls_gh(data)
    out = []
    for alphas, sign in ((RLS_LOWER, 1.0), (RLS_UPPER, -1.0)):
        rows = []
        for alpha in alphas:
            c = np.array([1.0, alpha])
            sol = sdp(c, Gs=[matrix(np.asfortranarray(G))],
                      hs=[matrix(np.asfortranarray(sign * h))])
            rows.append((alpha, -sign * float(c @ to_numpy(sol["x"])), sol))
        out.append(rows)
    return tuple(out)
