"""The port's problems of kvxopt_tpu_torch.examples.book.examples5
(consumerpref, inputdesign, probbounds, filterdemo, rls) against the JAX
package's, as tests/test_book_examples5.py solves them, on the CPU.

tests/test_book_examples5.py holds consumerpref, probbounds, filterdemo
and one rls case against the reference package, which is not built
here, so they skip there; here each is held against the JAX package on
the same data and runs.  The bar: the same status, iterations within 1,
x within 1e-6 (1 + |x|), the primal objective within 1e-7 (1 + |obj|),
and the JAX test's own independent oracles.
"""

import numpy as np
import pytest

from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.examples.book import examples5 as ex

from .torch_example_parity import (close_obj, close_x, compare, host,
                                   recorded_lp)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


# ---------------------------------------------------------------------------
# consumerpref

def jax_consumerpref(B):
    """tests/test_book_examples5.py's _pref_solver_ours and _classify on
    kvxopt_tpu's modeling layer."""
    from kvxopt_tpu.models.modeling import op, variable
    m = B.shape[1]
    order = np.argsort(ex._utility(B[0], B[1]))
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


def test_consumerpref_analysis():
    B = ex.consumerpref_data()
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        labels, vals = ex.consumerpref(B)
        jlabels, jvals = jax_consumerpref(B)
    assert labels == jlabels
    np.testing.assert_array_equal(np.isfinite(vals), np.isfinite(jvals))
    both = np.isfinite(vals)
    assert both.any()
    for a, b in zip(vals[both], jvals[both]):
        close_obj(a, b)
    assert len(lps) == len(jlps)
    for s, js in zip(lps, jlps):
        assert s["status"] == js["status"]
        assert abs(s["iterations"] - js["iterations"]) <= 1
        if js["status"] == "optimal":
            compare(s, js)


# ---------------------------------------------------------------------------
# inputdesign: lapack.gels against the JAX package's and numpy's lstsq

def test_inputdesign_gels():
    from kvxopt_tpu import lapack, matrix
    data = ex.inputdesign_data()
    n = data[0].shape[0]
    for u, (delta, eta) in zip(ex.inputdesign(data),
                               ex.INPUTDESIGN_WEIGHTS):
        AA, bb = ex.inputdesign_system(data, delta, eta)
        xm = matrix(bb.reshape(-1, 1).copy())
        lapack.gels(matrix(AA.copy()), xm)
        np.testing.assert_allclose(u, np.asarray(xm)[:n, 0], rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(u, np.linalg.lstsq(AA, bb, rcond=None)[0],
                                   rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# probbounds

def test_probbounds_chebyshev_sdp():
    data = ex.probbounds_data()
    A0, b0, sigmas = data
    rows, xc, scale = ex.probbounds(data)
    for row, sigma in zip(rows, sigmas):
        Sigma = sigma ** 2 * np.eye(2)
        ref = jsolvers.sdp(*ex.probbounds_problem(A0, b0, Sigma))
        assert row["sol"]["status"] == "optimal"
        compare(row["sol"], ref)
        x = host(ref["x"])
        bound = 1.0 - Sigma[0, 0] * x[0] - 2 * Sigma[1, 0] * x[1] \
            - Sigma[1, 1] * x[2] - x[5]
        assert 0.0 <= row["bound"] <= 1.0 + 1e-8
        np.testing.assert_allclose(row["bound"], bound, atol=1e-7)
    P, q = rows[-1]["P"], rows[-1]["q"]
    np.testing.assert_allclose(P @ xc, -q, atol=1e-10)
    assert scale > 0


# ---------------------------------------------------------------------------
# filterdemo

def test_filterdemo_lowpass_design():
    from kvxopt_tpu.models.modeling import op, variable
    from kvxopt_tpu.models.modeling import max as mmax
    data = ex.filterdemo_data()
    G1, G2, d1 = data
    with recorded_lp(tsolvers, jsolvers) as (lps, jlps):
        p, hv, att = ex.filterdemo(data)
        h = variable(G1.shape[1])
        jp = op(mmax(abs(G2 * h)), [G1 * h <= d1, G1 * h >= 1.0 / d1])
        jp.solve()
    assert p.status == jp.status == "optimal"
    compare(lps[0], jlps[0])
    jhv = np.asarray(h.value).reshape(-1)
    close_x(hv, jhv)
    np.testing.assert_allclose(att, np.max(np.abs(G2 @ jhv)), rtol=1e-6,
                               atol=1e-7)
    y1 = G1 @ hv
    assert (y1 <= d1 + 1e-7).all() and (y1 >= 1.0 / d1 - 1e-7).all()
    assert att < 1.0 / d1


# ---------------------------------------------------------------------------
# rls

def sphere_ls_value(A, b, alpha, minimize=True):
    """min/max ||Ax-b||^2 over ||x||^2 = alpha by bisection on the
    multiplier (tests/test_book_examples5.py's secular-equation
    oracle)."""
    H, g = A.T @ A, A.T @ b
    w = np.linalg.eigvalsh(H)
    lo, hi = (-w[0], -w[0] + 1e6) if minimize else (-w[-1] - 1e6, -w[-1])
    for _ in range(200):
        lam = 0.5 * (lo + hi)
        x = np.linalg.solve(H + lam * np.eye(H.shape[0]), g)
        if (float(x @ x) > alpha) == minimize:
            lo = lam
        else:
            hi = lam
    r = A @ x - b
    return float(r @ r)


def test_rls_bounds_vs_secular_oracle():
    data = ex.rls_data()
    A, b = data
    lower, upper = ex.rls(data)
    for rows, minimize in ((lower, True), (upper, False)):
        for alpha, value, sol in rows:
            assert sol["status"] == "optimal"
            np.testing.assert_allclose(
                value, sphere_ls_value(A, b, alpha, minimize), rtol=1e-5,
                atol=1e-6)


def test_rls_bounds_vs_jax():
    from kvxopt_tpu import matrix
    data = ex.rls_data()
    G, h = ex.rls_gh(data)
    lower, upper = ex.rls(data)
    for rows, sign in ((lower, 1.0), (upper, -1.0)):
        for alpha, value, sol in rows:
            ref = jsolvers.sdp(np.array([1.0, alpha]),
                               Gs=[matrix(np.asfortranarray(G))],
                               hs=[matrix(np.asfortranarray(sign * h))])
            compare(sol, ref)
