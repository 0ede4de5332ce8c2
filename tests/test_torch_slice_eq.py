"""The widened slice end to end: second-order cones and equality
constraints through make_qp_solver, batched_qp_solver and
batched_qp_solver_mixed, against the JAX package's drivers vmapped on the
CPU with x64.

Per lane: the same status, iterations within 1, and x, y, the primal and
the dual objective within 1e-7 relative (norm-wise for x and y, against
max(1, |reference|)).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bench_configs import _socp_batch
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu.parallel import batch as jb
from kvxopt_tpu_torch import ConeDims
from kvxopt_tpu_torch.convert import problem_to_torch, state_to_numpy
from kvxopt_tpu_torch.parallel import batch as tb


def lqeq_problems(B, n, l, q, p, seed0=0):
    """Feasible l + q + eq batch, one seed per lane: P = MM' + nI, G
    standard normal, x0 = 0.1 randn, s0 uniform(0.5, 1.5) on the orthant
    and SOC blocks as bench_configs._socp_batch builds them, h = G x0 + s0,
    A standard normal, b = A x0."""
    out = []
    m = l + sum(q)
    for seed in range(seed0, seed0 + B):
        rng = np.random.default_rng(seed)
        Mx = rng.standard_normal((n, n))
        P = Mx @ Mx.T + n * np.eye(n)
        qv = rng.standard_normal(n)
        G = rng.standard_normal((m, n))
        x0 = 0.1 * rng.standard_normal(n)
        s0 = np.empty(m)
        s0[:l] = rng.uniform(0.5, 1.5, l)
        ofs = l
        for qm in q:
            u = rng.standard_normal(qm - 1) * 0.3
            s0[ofs] = np.linalg.norm(u) + rng.uniform(0.5, 1.5)
            s0[ofs + 1:ofs + qm] = u
            ofs += qm
        A = rng.standard_normal((p, n))
        out.append((P, qv, G, G @ x0 + s0, A, A @ x0))
    return tuple(np.stack(a) for a in zip(*out))


def rel_err(a, b):
    return np.linalg.norm(a - b, axis=-1) / np.maximum(
        1.0, np.linalg.norm(b, axis=-1))


def compare(port, ref):
    x, y, it, st, m = port[0], port[1], port[4], port[5], port[6]
    xj, yj, itj, stj = (np.asarray(ref[i]) for i in (0, 1, 4, 5))
    np.testing.assert_array_equal(st, stj)
    assert (np.abs(it - itj) <= 1).all(), (it, itj)
    assert rel_err(x, xj).max() <= 1e-7, rel_err(x, xj)
    assert rel_err(y, yj).max() <= 1e-7, rel_err(y, yj)
    for a, b in ((m.pcost, ref[6].pcost), (m.dcost, ref[6].dcost)):
        b = np.asarray(b)
        assert (np.abs(a - b) <= 1e-7 * np.maximum(1.0, np.abs(b))).all()


SMALL = dict(B=4, n=16, l=8, q=(4, 4), p=3)


def test_make_qp_solver_lqeq_matches_jax():
    """The default strategy with q cones is chol, on both sides."""
    data = lqeq_problems(**SMALL)
    dims = dict(l=SMALL["l"], q=SMALL["q"])
    port = state_to_numpy(tb.make_qp_solver(ConeDims(**dims), with_eq=True)(
        *problem_to_torch(*data, device="cpu")))
    ref = jax.vmap(jb.make_qp_solver(JaxDims(**dims), with_eq=True))(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)
    assert (port[5] == 1).all() and port[1].shape == (4, 3)


@pytest.mark.parametrize("name", ["chol2", "qr"])
def test_make_qp_solver_lqeq_other_strategies_match_jax(name):
    data = lqeq_problems(**SMALL, seed0=20)
    dims = dict(l=SMALL["l"], q=SMALL["q"])
    port = state_to_numpy(tb.make_qp_solver(ConeDims(**dims), name)(
        *problem_to_torch(*data, device="cpu")))
    ref = jax.vmap(jb.make_qp_solver(JaxDims(**dims), name))(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)


def test_mixed_driver_lqeq_matches_jax():
    data = lqeq_problems(**SMALL, seed0=10)
    dims = dict(l=SMALL["l"], q=SMALL["q"])
    solve = tb.batched_qp_solver_mixed(ConeDims(**dims), with_eq=True)
    port = state_to_numpy(solve(*problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver_mixed(JaxDims(**dims), with_eq=True)(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)
    assert (port[5] == 1).all()
    assert 0 <= solve.stats["pass2_lanes"] <= SMALL["B"]


def test_single_instance_with_eq():
    """One lane without the batch axis, A and b included."""
    P, q, G, h, A, b = (a[0] for a in lqeq_problems(**SMALL, seed0=30))
    dims = dict(l=SMALL["l"], q=SMALL["q"])
    port = state_to_numpy(tb.make_qp_solver(ConeDims(**dims))(
        *problem_to_torch(P, q, G, h, A, b, device="cpu")))
    ref = jb.make_qp_solver(JaxDims(**dims))(
        *(jnp.asarray(a) for a in (P, q, G, h, A, b)))
    assert port[0].shape == (16,) and port[1].shape == (3,)
    compare(tuple(a[None] for a in port[:6]) + (
        type(port[6])(*(a[None] for a in port[6])),),
        tuple(np.asarray(a)[None] for a in ref[:6]) + (
            type(ref[6])(*(np.asarray(a)[None] for a in ref[6])),))


def test_socp_batch_matches_jax():
    """The JAX bench's socp_batch shape: B=16, n=64, q=[8]*8, no l, no
    equality constraints, through batched_qp_solver (strategy chol)."""
    data = _socp_batch(16, 64, 8, 8, 0)
    dims = dict(l=0, q=(8,) * 8)
    port = state_to_numpy(tb.batched_qp_solver(ConeDims(**dims))(
        *problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver(JaxDims(**dims))(
        *(jnp.asarray(a) for a in data))
    compare(port, ref)
    assert (port[5] == 1).all()


@pytest.mark.parametrize("B,n,l,q,p", [(4, 16, 8, (4, 4), 3),
                                       (2, 130, 260, (16,) * 8, 16)])
def test_pass1_with_factor_refinement_lqeq_matches_jax(B, n, l, q, p):
    """Pass 1 alone as the card runs it, factor refinement on (on the CPU
    the drivers' "vmap" default turns it off on both sides), including
    the lanes that end 'singular' and go to pass 2.

    Where a lane ends 'singular', the f32 factor of the equilibrated K
    broke down at cond(K) ~ 1/eps32, and which iteration that happens at
    is decided by rounding: at (B,n,l,q,p) = (2,130,130,(16,)*8,8) lane 0
    of the port breaks at iteration 10 where JAX's goes on to 'optimal'.
    From the same (s, z) the two packages' q-block scalings differ by
    ~1e-10 relative (jnrm2's x0 - |x1| cancels near the cone boundary,
    and the two norms sum in another order), the f32 Gram Gs'Gs differs
    by summation order besides (14664 of 16900 entries, ~1e-6 relative),
    and the equilibrated K's smallest eigenvalue is 8e-8 in one f32
    matrix and 7.7e-7 in the other; both packages' Cholesky agree on
    each matrix.  JAX's own lane 1 ends at iteration 9 or 11 depending on
    the batch it sits in.  The shapes here keep every lane clear of that
    edge."""
    from kvxopt_tpu.solvers.coneprog import Options as JaxOptions
    from kvxopt_tpu_torch.solvers.coneprog import Options
    data = lqeq_problems(B, n, l, q, p)
    port = state_to_numpy(tb.batched_qp_solver(
        ConeDims(l=l, q=q), "chol2_mixed_nofb",
        Options(ozaki=True, facref=True))(
            *problem_to_torch(*data, device="cpu")))
    ref = jb.batched_qp_solver(
        JaxDims(l=l, q=q), "chol2_mixed_nofb",
        JaxOptions(ozaki=True, facref=True))(*(jnp.asarray(a) for a in data))
    compare(port, ref)
