"""Custom x and y vector spaces in the port's coneqp and conelp, held
against the JAX package on the same numpy data (CPU, x64).

The pytree problems are tests/test_custom_kkt.py's (x = {'a', 'b'}, G and
P operators, a kktsolver over a dense chol2 factor); the custom-y ones
split y into {'u', 'w'} with an operator A.  The bar: the same status,
iterations within 1, x and z within 1e-7.  The ValueErrors carry the
JAX package's words.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import kkt as jkkt
from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu.cones import ConeDims as JaxDims
from kvxopt_tpu_torch import config, misc
from kvxopt_tpu_torch import solvers as tsolvers
from kvxopt_tpu_torch.convert import tree_from_numpy, tree_to_numpy

TOL = 1e-7


@pytest.fixture(autouse=True)
def on_the_cpu():
    with config.using_device("cpu"):
        yield


class Backend:
    """The numpy data of a problem as one package's arrays, its dense
    chol2 factor and solvers."""

    def __init__(self, xp, G, A, P):
        self.jax = xp is jnp
        self.xp = xp
        self.arr = (jnp.asarray if self.jax else
                    lambda a: torch.as_tensor(np.asarray(a)))
        self.solvers = jsolvers if self.jax else tsolvers
        self.G, self.A = self.arr(G), self.arr(A)
        self.P = None if P is None else self.arr(P)

    def dense_factor(self, dims):
        """factor(W) -> solve(bx, by, bz) on flat vectors: chol2 with
        K = P + G'W'WG."""
        if self.jax:
            f = jkkt.make_kkt_solver("chol2", JaxDims(**dims), self.G,
                                     self.A, self.P)
            return f
        f = misc.kkt_chol2(self.G, dims, self.A)
        return lambda W: f(W, H=self.P)

    def cat(self, parts):
        return (jnp.concatenate if self.jax else torch.cat)(parts)


def split(v, sizes, keys):
    """A flat vector as a dict of consecutive pieces."""
    out, ofs = {}, 0
    for k, m in zip(keys, sizes):
        out[k] = v[ofs:ofs + m]
        ofs += m
    return out


def join(bk, u, keys):
    return bk.cat([u[k] for k in keys])


def pytree_qp(seed=11, n1=3, n2=4, m=10, p=0):
    """tests/test_custom_kkt.py:166's data, with p equality rows."""
    rng = np.random.default_rng(seed)
    n = n1 + n2
    G = rng.standard_normal((m, n))
    P = np.eye(n) * 2.0
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.5, 1.5, m)
    q = rng.standard_normal(n)
    A = rng.standard_normal((p, n))
    return dict(n=(n1, n2), P=P, q=q, G=G, h=h, A=A, b=A @ x0,
                dims={"l": m})


def pytree_lp(seed=12, n1=2, n2=3, m=9, p=0):
    """tests/test_custom_kkt.py:219's data (a bounded LP: c in the row
    space of G with positive multipliers), with p equality rows."""
    rng = np.random.default_rng(seed)
    n = n1 + n2
    G = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.5, 1.5, m)
    c = -G.T @ rng.uniform(0.5, 1.5, m)
    A = rng.standard_normal((p, n))
    return dict(n=(n1, n2), c=c, G=G, h=h, A=A, b=A @ x0, dims={"l": m})


XK, YK = ("a", "b"), ("u", "w")


def custom_call(xp, prob, entry, custom_x, custom_y, **extra):
    """entry ('coneqp' or 'conelp') through the custom-space contract in
    one package: x = {'a', 'b'} where custom_x, y = {'u', 'w'} (p split
    in two) where custom_y; operators for P, G and A and a kktsolver that
    joins the pieces into a dense chol2 solve."""
    bk = Backend(xp, prob["G"], prob["A"], prob.get("P"))
    nx = prob["n"]
    p = prob["A"].shape[0]
    ny = (p // 2, p - p // 2)
    G, A, P = bk.G, bk.A, bk.P
    xin = (lambda u: split(u, nx, XK)) if custom_x else (lambda u: u)
    xout = (lambda u: join(bk, u, XK)) if custom_x else (lambda u: u)
    yin = (lambda u: split(u, ny, YK)) if custom_y else (lambda u: u)
    yout = (lambda u: join(bk, u, YK)) if custom_y else (lambda u: u)

    def Gop(u, trans=False):
        return xin(G.T @ u) if trans else G @ xout(u)

    def Aop(u, trans=False):
        return xin(A.T @ yout(u)) if trans else yin(A @ xout(u))

    def Pop(u):
        return xin(P @ xout(u))

    dense = bk.dense_factor(prob["dims"])

    def kktsolver(W, H=None, Df=None):
        solve = dense(W)

        def s(bx, by, bz):
            ux, uy, uz = solve(xout(bx), yout(by), bz)
            return xin(ux), yin(uy), uz
        return s

    kw = dict(kktsolver=kktsolver, **extra)
    if custom_x:
        kw["xnewcopy"] = lambda u: u
    if custom_y:
        kw["ydot"] = lambda u, v: sum(xp.sum(u[k] * v[k]) for k in YK)
    Gx = Gop if custom_x else G
    Ax = Aop if (custom_x or custom_y) else A
    b = bk.arr(prob["b"])
    args = dict(A=Ax if p else None, b=(yin(b) if p else None))
    if entry == "coneqp":
        q = xin(bk.arr(prob["q"]))
        sol = bk.solvers.coneqp(Pop if custom_x else P, q, Gx,
                                bk.arr(prob["h"]), prob["dims"], **args, **kw)
    else:
        c = xin(bk.arr(prob["c"]))
        sol = bk.solvers.conelp(c, Gx, bk.arr(prob["h"]), prob["dims"],
                                **args, **kw)
    return sol, xout, yout


def flat(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def compare(port, ref, tol=TOL):
    (p, pxo, pyo), (r, rxo, ryo) = port, ref
    assert p["status"] == r["status"] == "optimal"
    assert abs(p["iterations"] - r["iterations"]) <= 1
    for k, po, ro in (("x", pxo, rxo), ("z", None, None), ("y", pyo, ryo)):
        a = flat(po(p[k]) if po else p[k])
        e = flat(ro(r[k]) if ro else r[k])
        np.testing.assert_allclose(a, e, atol=tol, rtol=0, err_msg=k)


CASES = {
    "coneqp x": ("coneqp", pytree_qp, 0, True, False),
    "conelp x": ("conelp", pytree_lp, 0, True, False),
    "coneqp y": ("coneqp", pytree_qp, 4, False, True),
    "conelp y": ("conelp", pytree_lp, 4, False, True),
    "coneqp x and y": ("coneqp", pytree_qp, 4, True, True),
    "conelp x and y": ("conelp", pytree_lp, 4, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_custom_spaces_match_jax(case):
    """The same custom-space call in both packages: status, iterations
    within 1, x, y and z within 1e-7; and the port's against its own
    dense call."""
    entry, make, p, cx, cy = CASES[case]
    prob = make(p=p)
    ref = custom_call(jnp, prob, entry, cx, cy)
    port = custom_call(torch, prob, entry, cx, cy)
    compare(port, ref)
    dense = custom_call(torch, prob, entry, False, False)
    compare(port, dense)
    if cx:
        assert set(port[0]["x"]) == set(XK)
    if cy:
        assert set(port[0]["y"]) == set(YK)


def test_the_dense_solves_of_test_custom_kkt():
    """tests/test_custom_kkt.py's own assertions on the port: the pytree
    solve agrees with coneqp/conelp on the dense data."""
    prob = pytree_qp()
    sol, xo, _ = custom_call(torch, prob, "coneqp", True, False)
    ref = tsolvers.coneqp(prob["P"], prob["q"], prob["G"], prob["h"],
                          prob["dims"])
    np.testing.assert_allclose(flat(xo(sol["x"])), flat(ref["x"]), atol=TOL)
    np.testing.assert_allclose(flat(sol["z"]), flat(ref["z"]), atol=TOL)
    prob = pytree_lp()
    sol, xo, _ = custom_call(torch, prob, "conelp", True, False)
    ref = tsolvers.conelp(prob["c"], prob["G"], prob["h"], prob["dims"])
    np.testing.assert_allclose(flat(xo(sol["x"])), flat(ref["x"]), atol=1e-6)
    np.testing.assert_allclose(flat(sol["z"]), flat(ref["z"]), atol=1e-6)


def test_initvals_and_starts_in_custom_spaces():
    """coneqp's initvals and conelp's primalstart/dualstart take the
    spaces' elements; the solves end as JAX's do."""
    prob = pytree_qp(p=4)
    x0 = np.linalg.lstsq(prob["A"], prob["b"], rcond=None)[0]
    iv = {"x": {"a": x0[:3], "b": x0[3:]}, "y": {"u": np.zeros(2),
                                                 "w": np.zeros(2)}}
    port = custom_call(torch, prob, "coneqp", True, True, initvals={
        k: tree_from_numpy(v, device="cpu") for k, v in iv.items()})
    ref = custom_call(jnp, prob, "coneqp", True, True, initvals={
        k: {kk: jnp.asarray(a) for kk, a in v.items()}
        for k, v in iv.items()})
    compare(port, ref)
    prob = pytree_lp(p=4)
    x0 = np.linalg.lstsq(prob["A"], prob["b"], rcond=None)[0]
    s0 = prob["h"] - prob["G"] @ x0
    assert (s0 > 0).all()
    starts = dict(primalstart={"x": {"a": x0[:2], "b": x0[2:]}, "s": s0},
                  dualstart={"y": {"u": np.zeros(2), "w": np.zeros(2)},
                             "z": np.ones(9)})
    port = custom_call(torch, prob, "conelp", True, True, **{
        k: {kk: (tree_from_numpy(a, device="cpu") if kk in "xy" else a)
            for kk, a in v.items()} for k, v in starts.items()})
    ref = custom_call(jnp, prob, "conelp", True, True, **{
        k: {kk: (jax.tree_util.tree_map(jnp.asarray, a) if kk in "xy"
                 else a)
            for kk, a in v.items()} for k, v in starts.items()})
    compare(port, ref)


def err_cases():
    """(name, call(solvers, xp)) pairs that must raise ValueError with
    the same words in both packages."""
    prob = pytree_qp(p=2)
    P, q, G, h, A, b = (prob[k] for k in "PqGhAb")
    dims = prob["dims"]

    def G_op(u, trans=False):
        return u

    def kkt(W):
        return None
    tree = {"a": q[:3], "b": q[3:]}
    return {
        "coneqp x needs P, G operators": (
            lambda s, xp: s.coneqp(P, tree, G_op, h, dims, kktsolver=kkt,
                                   xnewcopy=lambda u: u),
            "custom x vector space requires operator-form P and G"),
        "coneqp x needs a kktsolver": (
            lambda s, xp: s.coneqp(G_op, tree, G_op, h, dims,
                                   xnewcopy=lambda u: u),
            "custom x vector space requires a custom kktsolver"),
        "coneqp y needs A": (
            lambda s, xp: s.coneqp(P, q, G, h, dims, kktsolver=kkt,
                                   ydot=lambda u, v: 0.0),
            "custom y vector space requires A"),
        "coneqp y needs an A operator": (
            lambda s, xp: s.coneqp(P, q, G, h, dims, A, b, kktsolver=kkt,
                                   ydot=lambda u, v: 0.0),
            "custom y vector space requires operator-form A"),
        "coneqp needs complete initvals": (
            lambda s, xp: s.coneqp(G_op, tree, G_op, h, dims, kktsolver=kkt,
                                   xnewcopy=lambda u: u,
                                   initvals={"x": tree}),
            "custom vector spaces require complete initvals"),
        "conelp x needs a G operator": (
            lambda s, xp: s.conelp(tree, G, h, dims, kktsolver=kkt,
                                   xdot=lambda u, v: 0.0),
            "custom x vector space requires operator-form G and a custom "
            "kktsolver"),
        "conelp y needs b": (
            lambda s, xp: s.conelp(q, G, h, dims, G_op, None, kktsolver=kkt,
                                   yscal=lambda a, u: u),
            "custom y vector space requires operator-form A and b"),
    }


@pytest.mark.parametrize("case", sorted(err_cases()))
def test_custom_space_errors_match_jax(case):
    call, words = err_cases()[case]
    for s, xp in ((jsolvers, jnp), (tsolvers, torch)):
        with pytest.raises(ValueError, match=words):
            call(s, xp)


def test_tree_conversion_round_trip():
    """convert.tree_from_numpy/tree_to_numpy keep the structure, and the
    leaves in the order of the JAX package's pytree leaves."""
    from kvxopt_tpu_torch.solvers.coneprog import _tree_leaves
    rng = np.random.default_rng(3)
    tree = {"b": [rng.standard_normal(2), (rng.standard_normal(3),)],
            "a": rng.standard_normal((2, 2)), "c": None}
    t = tree_from_numpy(tree, device="cpu")
    assert isinstance(t["a"], torch.Tensor) and t["c"] is None
    jl = jax.tree_util.tree_leaves(tree)
    tl = _tree_leaves(t)
    assert len(jl) == len(tl) == 3
    for a, e in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), e)
    back = tree_to_numpy(t)
    assert type(back["b"][1]) is tuple
    for a, e in zip(jax.tree_util.tree_leaves(back), jl):
        np.testing.assert_array_equal(a, e)
