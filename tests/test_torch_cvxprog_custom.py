"""The customization levels of the port's cpl and cp: operator-form G
with a user kktsolver(W, H, Df), a custom x-space of dicts of tensors,
the ldl fallback of the condensed strategies and the device rule
(coneqp's and conelp's custom spaces: tests/test_torch_custom_spaces.py).

Parity cases hold the port against the JAX package on the same numpy
data, with tests/test_torch_cvxprog.py's bar: the same status and keys,
iterations within 1, x within 1e-6 (1 + |x|), the primal objective
within 1e-7 (1 + |obj|).
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu_torch import config, kkt
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.solvers.cvxprog import oracle_from_function

from .test_torch_cvxprog import compare, disc, maxent, maxent_data


@pytest.fixture
def on_the_cpu():
    with config.using_device("cpu"):
        yield


def operator_G_problem(xp):
    """minimize -x0 - x1 s.t. x0^2 + x1^2 <= 1 and x1 <= 0.5, with the
    linear constraint as an operator and a kktsolver that eliminates uz
    and solves K = H + Gs'Gs densely (tests/test_cvxprog.py:164)."""
    Gd = xp.asarray(np.array([[0.0, 1.0]]))

    def G(v, trans=False):
        if trans:
            return Gd.T @ v
        return Gd @ v

    def kktsolver(W, H=None, Df=None):
        d = W.d   # (mnl + 1,): the nonlinear row's scaling, then G's
        Gs = xp.concatenate([Df, Gd], 0) / d[:, None]
        K = H + Gs.T @ Gs

        def solve(bx, by, bz):
            bzs = bz / d
            ux = xp.linalg.solve(K, bx + Gs.T @ bzs)
            return ux, by, (Gs @ ux - bzs) / d
        return solve
    return G, kktsolver


def test_cpl_operator_G_and_kktsolver(on_the_cpu):
    import jax.numpy as jnp
    from kvxopt_tpu import solvers as jsolvers
    c, h = np.array([-1.0, -1.0]), np.array([0.5])
    Gj, kj = operator_G_problem(jnp)
    ref = jsolvers.cpl(c, disc(jnp), Gj, h, kktsolver=kj)
    seen = []
    G, kt = operator_G_problem(torch)

    def kktsolver(W, H=None, Df=None):
        seen.append((tuple(W.d.shape), tuple(H.shape), tuple(Df.shape)))
        return kt(W, H=H, Df=Df)
    sol = tsolvers.cpl(c, disc(torch), G, h, kktsolver=kktsolver)
    compare(ref, sol)
    # one instance, no batch axis: d over mnl + l entries, H (n, n),
    # Df (mnl, n) as the oracle returned them
    assert set(seen) == {((2,), (2, 2), (1, 2))}
    np.testing.assert_allclose(sol["x"].numpy(), [np.sqrt(0.75), 0.5],
                               atol=1e-5)


N1, N2 = 2, 3
SHIFT_A = np.linspace(0.3, 0.7, N1)
SHIFT_B = np.linspace(-0.4, 0.4, N2)


def f0_flat(xp):
    a, b = xp.asarray(SHIFT_A), xp.asarray(SHIFT_B)

    def f(x):
        return (xp.sum(xp.exp(x[:N1] - a)) + xp.sum((x[N1:] + b) ** 2) +
                0.1 * xp.sum(x ** 2))
    return f


def f0_tree(xp):
    a, b = xp.asarray(SHIFT_A), xp.asarray(SHIFT_B)

    def f(x):
        return (xp.sum(xp.exp(x["a"] - a)) + xp.sum((x["b"] + b) ** 2) +
                0.1 * (xp.sum(x["a"] ** 2) + xp.sum(x["b"] ** 2)))
    return f


def dense_cp(s, oracle_from_function, xp):
    """cp on the flat variable, its oracle from f0_flat by autodiff."""
    Fd = oracle_from_function(lambda x: f0_flat(xp)(x).reshape(1),
                              np.zeros(N1 + N2))

    def F(x=None, z=None):
        if x is None:
            m, x0 = Fd()
            return m - 1, x0
        return Fd(x) if z is None else Fd(x, z)
    return s.cp(F)


def ravel(u):
    """The epigraph element ({'a', 'b'}, t) as one flat vector."""
    x, t = u
    return torch.cat([x["a"], x["b"], t.reshape(1)])


def unravel(v):
    return ({"a": v[:N1], "b": v[N1:N1 + N2]}, v[N1 + N2])


def tree_cp():
    """cp over the x-space {'a': (2,), 'b': (3,)}: the gradient and the
    Hessian-vector product by torch.func, and a kktsolver that makes the
    extended-space operators dense column by column."""
    f = f0_tree(torch)
    grad = torch.func.grad(f)
    x0 = {"a": torch.zeros(N1, dtype=torch.float64),
          "b": torch.zeros(N2, dtype=torch.float64)}

    def F(x=None, z=None):
        if x is None:
            return 0, x0
        g = grad(x)

        def Df(u, trans=False):
            if trans:   # R^1 -> x-space
                return {k: u[0] * v for k, v in g.items()}
            return sum(torch.sum(g[k] * u[k]) for k in g).reshape(1)

        if z is None:
            return f(x).reshape(1), Df

        def H(u):
            _, hvp = torch.func.jvp(grad, (x,), (u,))
            return {k: z[0] * v for k, v in hvp.items()}
        return f(x).reshape(1), Df, H

    def kktsolver(W, H=None, Df=None):
        eye = torch.eye(N1 + N2 + 1, dtype=torch.float64)
        cols = [unravel(e) for e in eye]
        Hd = torch.stack([ravel(H(u)) for u in cols], 1)
        Dd = torch.stack([Df(u) for u in cols], 1)   # (mnl + 1, n + 1)
        d = W.d
        Gs = Dd / d[:, None]
        L = torch.linalg.cholesky(Hd + Gs.T @ Gs + 1e-12 * eye)

        def solve(bx, by, bz):
            bzs = bz / d
            ux = torch.cholesky_solve((ravel(bx) + Gs.T @ bzs)[:, None],
                                      L)[:, 0]
            return unravel(ux), by, (Gs @ ux - bzs) / d
        return solve

    return tsolvers.cp(F, kktsolver=kktsolver, xnewcopy=lambda u: u)


def jax_tree_cp():
    """tests/test_cvxprog.py::test_cp_pytree_vector_space's tree solve."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from kvxopt_tpu import solvers as jsolvers
    f = f0_tree(jnp)
    grad = jax.grad(f)
    x0 = {"a": jnp.zeros(N1), "b": jnp.zeros(N2)}

    def F(x=None, z=None):
        if x is None:
            return 0, x0
        g = grad(x)

        def Df(u, trans=False):
            if trans:
                return jax.tree_util.tree_map(lambda t: u[0] * t, g)
            return jnp.atleast_1d(sum(
                jnp.vdot(a, b) for a, b in zip(jax.tree_util.tree_leaves(g),
                                               jax.tree_util.tree_leaves(u))))
        if z is None:
            return jnp.atleast_1d(f(x)), Df

        def H(u):
            _, hvp = jax.jvp(grad, (x,), (u,))
            return jax.tree_util.tree_map(lambda t: z[0] * t, hvp)
        return jnp.atleast_1d(f(x)), Df, H

    def kktsolver(W, H=None, Df=None):
        flat0, unrav = ravel_pytree((x0, jnp.zeros(())))
        nt = flat0.shape[0]
        eye = np.eye(nt)
        cols = [unrav(jnp.asarray(eye[i])) for i in range(nt)]
        Hd = jnp.stack([ravel_pytree(H(u))[0] for u in cols], axis=1)
        Dd = jnp.stack([Df(u) for u in cols], axis=0).reshape(nt, -1).T
        d = W.d
        Gs = Dd / d[:, None]
        L = jnp.linalg.cholesky(Hd + Gs.T @ Gs + 1e-12 * jnp.eye(nt))

        def solve(bx, by, bz):
            bzs = bz / d
            r = ravel_pytree(bx)[0] + Gs.T @ bzs
            ux = jax.scipy.linalg.cho_solve((L, True), r)
            return unrav(ux), by, (Gs @ ux - bzs) / d
        return solve

    return jsolvers.cp(F, kktsolver=kktsolver, xnewcopy=lambda u: u)


def test_cp_over_a_dict_x_space(on_the_cpu):
    """The tree solve agrees with the port's dense solve to 1e-6 and
    meets the parity bar against the JAX package's tree solve."""
    sol = tree_cp()
    assert sol["status"] == "optimal"
    assert set(sol["x"]) == {"a", "b"}
    xt = torch.cat([sol["x"]["a"], sol["x"]["b"]]).numpy()
    dense = dense_cp(tsolvers, oracle_from_function, torch)
    assert dense["status"] == "optimal"
    np.testing.assert_allclose(xt, dense["x"].numpy(), atol=1e-6)
    ref = jax_tree_cp()
    flat = dict(sol, x=torch.from_numpy(xt))
    compare(dict(ref, x=np.concatenate([np.asarray(ref["x"]["a"]),
                                        np.asarray(ref["x"]["b"])])), flat)


def test_ldl_fallback_after_a_failed_factor(on_the_cpu, monkeypatch):
    """The condensed strategy's first factor gives NaN (as a failed
    Cholesky does): the step is solved again with ldl and the solve
    still ends optimal, at the solution of the plain run."""
    G, h, A, b = maxent_data()
    plain = tsolvers.cp(maxent(torch), G, h, A=A, b=b)
    calls = {"chol": 0, "ldl": 0}
    chol, ldl = kkt.chol_factor, kkt.ldl_nopiv

    def failing_once(K):
        calls["chol"] += 1
        L, Dinv = chol(K)
        if calls["chol"] == 1:
            L = torch.full_like(L, float("nan"))
        return L, Dinv

    def counted_ldl(M, *args, **kw):
        calls["ldl"] += 1
        return ldl(M, *args, **kw)

    monkeypatch.setattr(kkt, "chol_factor", failing_once)
    monkeypatch.setattr(kkt, "ldl_nopiv", counted_ldl)
    sol = tsolvers.cp(maxent(torch), G, h, A=A, b=b)
    assert calls["ldl"] == 1 and calls["chol"] > 1
    assert sol["status"] == plain["status"] == "optimal"
    x, xp = sol["x"].numpy(), plain["x"].numpy()
    assert np.linalg.norm(x - xp) <= 1e-6 * (1 + np.linalg.norm(xp))


def test_a_failing_user_factor_ends_unknown(on_the_cpu):
    """A kktsolver that raises LinAlgError ends the solve 'unknown' (the
    JAX package's 'singular'); any other error propagates."""
    c = np.array([-1.0, -1.0])

    def singular(W, H=None, Df=None):
        raise torch.linalg.LinAlgError("singular")
    sol = tsolvers.cpl(c, disc(torch), kktsolver=singular)
    assert sol["status"] == "unknown" and sol["iterations"] == 0

    def broken(W, H=None, Df=None):
        raise RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsolvers.cpl(c, disc(torch), kktsolver=broken)


NO_CARD = {
    "cp": lambda: tsolvers.cp(maxent(np), *maxent_data()[:2]),
    "cpl": lambda: tsolvers.cpl(np.array([-1.0, -1.0]), disc(np)),
    "gp": lambda: tsolvers.gp([2], np.array([[1.0], [-1.0]]), np.zeros(2)),
    "oracle_from_function": lambda: oracle_from_function(
        lambda x: x @ x, np.zeros(2)),
}


@pytest.mark.parametrize("entry", sorted(NO_CARD))
def test_no_card_and_no_device_named_raises(entry, monkeypatch):
    """The default device is the card; where there is none a call with
    numpy data raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert config.default_device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NO_CARD[entry]()


def test_tensors_keep_their_device(monkeypatch):
    """CPU tensors solve on the CPU with no device named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sol = tsolvers.gp([2], torch.tensor([[1.0], [-1.0]]), torch.zeros(2))
    assert sol["status"] == "optimal" and sol["x"].device.type == "cpu"


def test_the_solvers_export_the_nonlinear_front_ends():
    assert {"cp", "cpl", "gp"} <= set(tsolvers.__all__)
    assert all(callable(getattr(tsolvers, f)) for f in ("cp", "cpl", "gp"))
