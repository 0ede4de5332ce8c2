"""The regularized LDL' strategies of kvxopt_tpu_torch.kkt against the JAX
package's: ldl_nopiv on quasidefinite matrices, and `ldl` / `ldl2` on
l + q + s dims against jax.vmap of the JAX strategies (B=3, n=12,
l=4, q=(3,), s=(3,2,3), p = 0 and 2, f64 state).

ldl_nopiv runs the same blocked recurrence on both sides, so L and d
differ only in summation order (1e-10 relative).  The strategies solve
with the same NT scaling W, the JAX package's carried over by
convert.scaling_from_jax, and one step of iterative refinement; their
solutions match to 1e-9 relative, as tests/test_torch_kkt.py sets it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import cones as jc, kkt as jk
from kvxopt_tpu_torch import cones as tc, kkt as tk
from kvxopt_tpu_torch.convert import scaling_from_jax

B, N = 3, 12
D = dict(l=4, q=(3,), s=(3, 2, 3))
JD, TD = jc.ConeDims(**D), tc.ConeDims(**D)
M = JD.size


def rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def quasidefinite(n, seed):
    """[[K, C'], [C, -E]] with K and E positive definite, n1 + n2 = n."""
    rng = np.random.default_rng(seed)
    n1 = (2 * n) // 3
    R1 = rng.standard_normal((B, n1, n1))
    R2 = rng.standard_normal((B, n - n1, n - n1))
    Mq = np.zeros((B, n, n))
    Mq[:, :n1, :n1] = R1 @ np.swapaxes(R1, 1, 2) + n1 * np.eye(n1)
    Mq[:, n1:, n1:] = -(R2 @ np.swapaxes(R2, 1, 2) + np.eye(n - n1))
    C = rng.standard_normal((B, n - n1, n1))
    Mq[:, n1:, :n1] = C
    Mq[:, :n1, n1:] = np.swapaxes(C, 1, 2)
    return Mq


@pytest.mark.parametrize("n", [50, 130])
def test_ldl_nopiv_matches_jax(n):
    """n=50 pads to one 64 panel; n=130 takes three panels, the last one
    padded."""
    Mq = quasidefinite(n, n)
    L, d = tk.ldl_nopiv(torch.from_numpy(Mq))
    Lj, dj = jax.vmap(jk.ldl_nopiv)(jnp.asarray(Mq))
    rel_close(L, Lj, 1e-10)
    rel_close(d, dj, 1e-10)
    L, d = L.numpy(), d.numpy()
    assert np.array_equal(np.diagonal(L, axis1=1, axis2=2), np.ones((B, n)))
    rel_close((L * d[:, None, :]) @ np.swapaxes(L, 1, 2), Mq, 1e-12)
    b = np.random.default_rng(1).standard_normal((B, n))
    x = tk.ldl_solve(torch.from_numpy(L), torch.from_numpy(d),
                     torch.from_numpy(b)).numpy()
    rel_close(np.einsum("bij,bj->bi", Mq, x), b, 1e-10)


def interior(rng):
    out = np.empty((B, M))
    out[:, :D["l"]] = np.exp(rng.uniform(-2, 2, (B, D["l"])))
    ofs = D["l"]
    for m in D["q"]:
        u = rng.standard_normal((B, m - 1))
        out[:, ofs] = np.linalg.norm(u, axis=1) * np.exp(
            rng.uniform(0.01, 2, B))
        out[:, ofs + 1:ofs + m] = u
        ofs += m
    for m in D["s"]:
        R = rng.standard_normal((B, m, m))
        out[:, ofs:ofs + m * m] = (R @ np.swapaxes(R, 1, 2) +
                                   0.1 * np.eye(m)).reshape(B, -1)
        ofs += m * m
    return out


def system(seed, p):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, M, N))
    G = np.asarray(tc.sym_from_lower_cols(TD, torch.from_numpy(G)))
    A = rng.standard_normal((B, p, N))
    R = rng.standard_normal((B, N, N))
    P = R @ np.swapaxes(R, 1, 2) + N * np.eye(N)
    s, z = interior(rng), interior(rng)
    bx, by, bz = (rng.standard_normal((B, k)) for k in (N, p, M))
    bz = np.asarray(tc.symm(TD, torch.from_numpy(bz)))
    return G, A, P, s, z, bx, by, bz


@pytest.mark.parametrize("p", [0, 2])
@pytest.mark.parametrize("name", ["ldl", "ldl2"])
def test_ldl_strategies_match_jax(name, p):
    G, A, P, s, z, bx, by, bz = system(10 + p, p)

    def one(Gi, Ai, Pi, si, zi, bxi, byi, bzi):
        W, _ = jc.compute_scaling(JD, si, zi)
        f = jk.make_kkt_solver(name, JD, Gi, Ai, Pi)
        return f(W)(bxi, byi, bzi), W
    (ux_j, uy_j, uz_j), Wj = jax.vmap(one)(
        *(jnp.asarray(a) for a in (G, A, P, s, z, bx, by, bz)))
    Wj = jax.tree_util.tree_map(np.asarray, Wj)
    W = scaling_from_jax(TD, Wj.d, Wj.beta, Wj.v, Wj.r, Wj.rti,
                         device="cpu")
    Gt, At, Pt, bxt, byt, bzt = (torch.from_numpy(a)
                                 for a in (G, A, P, bx, by, bz))
    ux, uy, uz = tk.make_kkt_solver(name, TD, Gt, At, Pt)(W)(bxt, byt, bzt)
    assert uy.shape == (B, p)
    for got, want in ((ux, ux_j), (uy, uy_j), (uz, uz_j)):
        if p or got is not uy:
            rel_close(got.numpy(), want, 1e-9)
    # the Newton system itself, to the regularization's 1e-9
    wtw = tc.scale(TD, W, tc.scale(TD, W, uz), trans=True)
    r1 = tk._mv(Pt, ux) + tk._tmv(At, uy) + tk._tmv(Gt, uz) - bxt
    r2 = tk._mv(At, ux) - byt
    r3 = tk._mv(Gt, ux) - wtw - bzt
    for r, b in ((r1, bx), (r2, by), (r3, bz)):
        if r.numel():
            assert float(r.abs().max()) < 1e-7 * (1 + np.abs(b).max())


def test_every_strategy_is_ported():
    assert tk.PORTED == tk.STRATEGIES == jk.STRATEGIES
