"""KKT strategies with second-order cones and equality constraints:
kvxopt_tpu_torch.kkt against jax.vmap of the JAX package's strategies
(B=3, n=16, l=10, q=(4,4,6), p=3, f64 state).

Both packages solve with the same NT scaling W: the JAX package's, carried
over by convert.scaling_from_jax.  The all-f64 strategies (chol2, chol,
qr) differ from JAX only in summation order.  The mixed strategies refine
an f32 factor to the PCG exit 500*eps64*|b| (50*eps64*|b| for the Schur
complement), so both sides land within ~1e-12 of the exact solution; 1e-9
relative leaves room for the conditioning of K (~1e4 here) and of S.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import cones as jc, kkt as jk
from kvxopt_tpu_torch import cones as tc, kkt as tk
from kvxopt_tpu_torch.convert import scaling_from_jax

B, N, P_ = 3, 16, 3
D = dict(l=10, q=(4, 4, 6))
JD, TD = jc.ConeDims(**D), tc.ConeDims(**D)
M = JD.size


def interior(rng):
    out = np.empty((B, M))
    out[:, :D["l"]] = np.exp(rng.uniform(-3, 3, (B, D["l"])))
    ofs = D["l"]
    for m in D["q"]:
        u = rng.standard_normal((B, m - 1))
        out[:, ofs] = np.linalg.norm(u, axis=1) * np.exp(
            rng.uniform(0.01, 2, B))
        out[:, ofs + 1:ofs + m] = u
        ofs += m
    return out


def system(seed=0, p=P_):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, M, N))
    A = rng.standard_normal((B, p, N))
    R = rng.standard_normal((B, N, N))
    P = R @ np.swapaxes(R, 1, 2) + N * np.eye(N)
    s, z = interior(rng), interior(rng)
    bx, by, bz = (rng.standard_normal((B, k)) for k in (N, p, M))
    return G, A, P, s, z, bx, by, bz


def rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def jax_solve(name, G, A, P, s, z, bx, by, bz, **kw):
    def one(Gi, Ai, Pi, si, zi, bxi, byi, bzi):
        W, _ = jc.compute_scaling(JD, si, zi)
        f = jk.make_kkt_solver(name, JD, Gi, Ai, Pi, **kw)
        return f(W)(bxi, byi, bzi), W
    (ux, uy, uz), W = jax.vmap(one)(
        *(jnp.asarray(a) for a in (G, A, P, s, z, bx, by, bz)))
    return [np.asarray(o) for o in (ux, uy, uz)], \
        jax.tree_util.tree_map(np.asarray, W)


def torch_solve(name, Wj, G, A, P, s, z, bx, by, bz, **kw):
    W = scaling_from_jax(TD, Wj.d, Wj.beta, Wj.v, device="cpu")
    G, A, P, bx, by, bz = (torch.from_numpy(a)
                           for a in (G, A, P, bx, by, bz))
    f = tk.make_kkt_solver(name, TD, G, A, P, **kw)
    return [o.numpy() for o in f(W)(bx, by, bz)]


def newton_residuals(W, G, A, P, ux, uy, uz, bx, by, bz):
    """P ux + A'uy + G'uz - bx, A ux - by, G ux - W'W uz - bz."""
    W = scaling_from_jax(TD, W.d, W.beta, W.v, device="cpu")
    wtw = tc.scale(TD, W, tc.scale(TD, W, torch.from_numpy(uz)),
                   trans=True).numpy()
    r1 = (np.einsum("bij,bj->bi", P, ux) + np.einsum("bji,bj->bi", A, uy)
          + np.einsum("bji,bj->bi", G, uz) - bx)
    r2 = np.einsum("bij,bj->bi", A, ux) - by
    r3 = np.einsum("bij,bj->bi", G, ux) - wtw - bz
    return r1, r2, r3


CASES = [("chol2", {}), ("chol", {}), ("qr", {})] + [
    (name, {"facref": fr, "ozaki": oz})
    for name in ("chol2_mixed", "chol2_mixed_nofb")
    for fr in (True, False) for oz in (False, True)]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{sorted(k.items())}" for n, k in CASES])
def test_strategy_with_eq_matches_jax(name, kw):
    data = system()
    (ux_j, uy_j, uz_j), Wj = jax_solve(name, *data, **kw)
    ux, uy, uz = torch_solve(name, Wj, *data, **kw)
    assert uy.shape == uy_j.shape == (B, P_)
    for got, want in ((ux, ux_j), (uy, uy_j), (uz, uz_j)):
        rel_close(got, want, 1e-9)
    G, A, P, s, z, bx, by, bz = data
    for r, b in zip(newton_residuals(Wj, G, A, P, ux, uy, uz, bx, by, bz),
                    (bx, by, bz)):
        assert np.abs(r).max() < 1e-8 * (1 + np.abs(b).max())


@pytest.mark.parametrize("name", ["chol", "qr"])
def test_nullspace_strategies_without_eq_match_jax(name):
    data = system(1, p=0)
    (ux_j, uy_j, uz_j), Wj = jax_solve(name, *data)
    ux, uy, uz = torch_solve(name, Wj, *data)
    assert uy.shape == (B, 0)
    rel_close(ux, ux_j, 1e-9)
    rel_close(uz, uz_j, 1e-9)


def test_mixed_ksolve_columns_match_one_by_one():
    """K^{-1} A' solved as one (B, n, p) batch equals p separate solves:
    each column refines on its own, as under the JAX package's vmap."""
    rng = np.random.default_rng(3)
    R = rng.standard_normal((B, N, N))
    K = torch.from_numpy(R @ np.swapaxes(R, 1, 2) + np.eye(N))
    b = torch.from_numpy(rng.standard_normal((B, N, 4)))
    for ozaki in (False, True):
        ksolve = tk.mixed_spd_solver(K, fallback=False, ozaki=ozaki,
                                     facref=False)
        X = ksolve(b)
        cols = torch.stack([ksolve(b[..., j]) for j in range(4)], -1)
        rel_close(X.numpy(), cols.numpy(), 1e-12)
        rel_close(X.numpy(), torch.linalg.solve(K, b).numpy(), 1e-9)
