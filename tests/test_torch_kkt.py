"""KKT strategies of kvxopt_tpu_torch.kkt against jax.vmap of the JAX
package's strategies (B=3, n=16, m=32, random NT scalings, f64 state).

The all-f64 `chol2` differs from JAX only in summation order.  The mixed
strategies refine an f32 factor to the PCG exit 500*eps64*|b|, so both
sides land within ~1e-12 of the exact solution; 1e-9 relative leaves
room for the conditioning of K (~1e4 here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import cones as jc, kkt as jk
from kvxopt_tpu_torch import cones as tc, kkt as tk

B, N, M = 3, 16, 32
JD, TD = jc.ConeDims(l=M), tc.ConeDims(l=M)


def system(seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, M, N))
    R = rng.standard_normal((B, N, N))
    P = R @ np.swapaxes(R, 1, 2) + N * np.eye(N)
    # interior points spread over decades, as in late IPM iterations
    s = np.exp(rng.uniform(-3, 3, (B, M)))
    z = np.exp(rng.uniform(-3, 3, (B, M)))
    bx, bz = rng.standard_normal((B, N)), rng.standard_normal((B, M))
    return G, P, s, z, bx, bz


def rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def jax_solve(name, G, P, s, z, bx, bz, **kw):
    def one(Gi, Pi, si, zi, bxi, bzi):
        W, _ = jc.compute_scaling(JD, si, zi)
        f = jk.make_kkt_solver(name, JD, Gi, jnp.zeros((0, N)), Pi, **kw)
        return f(W)(bxi, jnp.zeros((0,)), bzi)
    out = jax.vmap(one)(*(jnp.asarray(a) for a in (G, P, s, z, bx, bz)))
    return [np.asarray(o) for o in out]


def torch_solve(name, G, P, s, z, bx, bz, **kw):
    G, P, s, z, bx, bz = (torch.from_numpy(a) for a in (G, P, s, z, bx, bz))
    W, _ = tc.compute_scaling(TD, s, z)
    f = tk.make_kkt_solver(name, TD, G, None, P, **kw)
    return [o.numpy() for o in f(W)(bx, torch.zeros((B, 0)), bz)]


CASES = [("chol2", {})] + [
    (name, {"facref": fr, "ozaki": oz})
    for name in ("chol2_mixed", "chol2_mixed_nofb")
    for fr in (True, False) for oz in (False, True)]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{sorted(k.items())}" for n, k in CASES])
def test_strategy_matches_jax(name, kw):
    data = system()
    ux_j, uy_j, uz_j = jax_solve(name, *data, **kw)
    ux, uy, uz = torch_solve(name, *data, **kw)
    assert uy.shape == uy_j.shape == (B, 0)
    rel_close(ux, ux_j, 1e-9)
    rel_close(uz, uz_j, 1e-9)
    # and the Newton system itself: P ux + G' uz = bx, G ux - W'W uz = bz
    G, P, s, z, bx, bz = data
    r1 = np.einsum("bij,bj->bi", P, ux) + np.einsum("bji,bj->bi", G, uz) - bx
    r3 = np.einsum("bij,bj->bi", G, ux) - (s / z) * uz - bz
    assert np.abs(r1).max() < 1e-8 * (1 + np.abs(bx).max())
    assert np.abs(r3).max() < 1e-8 * (1 + np.abs(bz).max())


def test_vmap_sentinel_is_off_on_cpu():
    """facref="vmap" refines only when the factor reaches kernel K3 (a
    CUDA batch); on the CPU it matches facref=False exactly."""
    data = system(1)
    a = torch_solve("chol2_mixed_nofb", *data, facref="vmap")
    b = torch_solve("chol2_mixed_nofb", *data, facref=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_mixed_spd_solver_fallback_one_lane():
    """One lane with cond ~1e9 (beyond f32) takes the f64 fallback; the
    other lanes stay on the f32 factor + PCG, as under JAX's cond_any."""
    rng = np.random.default_rng(4)
    n = 16
    K = np.empty((B, n, n))
    for i in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.logspace(0, 9 if i == 1 else 2, n)
        K[i] = (Q * ev) @ Q.T
    b = rng.standard_normal((B, n))
    want = np.asarray(jax.vmap(lambda Ki, bi: jk.mixed_spd_solver(Ki)(bi))(
        jnp.asarray(K), jnp.asarray(b)))
    ksolve = tk.mixed_spd_solver(torch.from_numpy(K))
    assert ksolve.bad.tolist() == [False, True, False]
    got = ksolve(torch.from_numpy(b)).numpy()
    for i in (0, 2):
        rel_close(got[i], want[i], 1e-9)
    # lane 1 is an f64 Cholesky solve on both sides; two LAPACK-style
    # factorizations of a cond-1e9 matrix agree to ~cond*eps64 ~ 1e-7
    rel_close(got[1], want[1], 1e-5)
    r = np.einsum("bij,bj->bi", K, got) - b
    assert np.abs(r).max() < 1e-6 * np.abs(b).max()


def test_cond_any_skips_true_branch_when_no_lane_needs_it():
    calls = []

    def true_fn(x):
        calls.append(1)
        return x + 1.0

    x = torch.zeros((3, 2))
    out = tk.cond_any(torch.tensor([False, False, False]), true_fn,
                      lambda v: v - 1.0, x)
    assert not calls and bool((out == -1.0).all())
    out = tk.cond_any(torch.tensor([False, True, False]), true_fn,
                      lambda v: v - 1.0, x)
    assert calls and out[:, 0].tolist() == [-1.0, 1.0, -1.0]


@pytest.mark.parametrize("name", ["ldl", "ldl2", "chol", "qr"])
def test_other_strategies_not_ported(name):
    """Every strategy is ported (ldl and ldl2: tests/test_torch_kkt_ldl.py,
    chol and qr: tests/test_torch_kkt_eq.py) and builds; an unknown name
    still raises."""
    G = torch.zeros((1, 4, 2))
    assert name in tk.PORTED
    assert callable(tk.make_kkt_solver(name, tc.ConeDims(l=4), G))
    with pytest.raises(ValueError):
        tk.make_kkt_solver("nope", tc.ConeDims(l=4), G)


def test_equality_constraints_not_ported():
    """Equality constraints are ported (tests/test_torch_kkt_eq.py): a
    strategy takes A with p > 0, with a semidefinite cone too."""
    G, A = torch.zeros((1, 4, 2)), torch.ones((1, 1, 2))
    assert callable(tk.make_kkt_solver("chol2", tc.ConeDims(l=4), G, A))
    for name in tk.STRATEGIES:
        assert callable(tk.make_kkt_solver(name, tc.ConeDims(l=0, s=(2,)),
                                           G, A))
