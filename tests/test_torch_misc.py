"""kvxopt_tpu_torch.misc and misc_solvers against kvxopt_tpu.misc.

The same seeded numpy vectors go through both packages on the CPU (JAX
in f64, the port under config.using_device("cpu")) on dims l=3, q=[4,3],
s=[3,2], with mnl=0 and mnl=2 leading orthant entries.  The functions
are sums and products of O(1) numbers: they agree to 1e-12 relative.
compute_scaling and update_scaling are compared field by field on W; r
and rti, free up to the sign of each singular vector, through r r' and
rti rti'.  W applied to a vector depends on those signs, so scale is
compared on one W given to both packages: the JAX package's W to the
port as it is, and the port's to the JAX package as arrays.

The kkt_* factors run as kktsolvers of coneqp (through the H=P wrapper:
coneqp calls a custom kktsolver with W alone) on a seeded l+q+s QP with
n=20, and directly as kktsolvers of conelp on a seeded l+q+s LP: status
and iterations equal, x to 1e-7.  kkt_chol2 without the wrapper solves
the wrong Newton system, in both packages alike.
"""

import numpy as np
import pytest
import torch

from kvxopt_tpu import misc as jm
from kvxopt_tpu import misc_solvers as jms
from kvxopt_tpu import solvers as jsolvers
from kvxopt_tpu_torch import config
from kvxopt_tpu_torch import misc as tm
from kvxopt_tpu_torch import misc_solvers as tms
from kvxopt_tpu_torch import solvers as tsolvers

DIMS = {"l": 3, "q": [4, 3], "s": [3, 2]}
SIZE = 3 + 4 + 3 + 9 + 4
PACKED = 3 + 4 + 3 + 6 + 3
MNL = [0, 2]


@pytest.fixture(autouse=True)
def _cpu():
    with config.using_device("cpu"):
        yield


def close(a, b, tol=1e-12):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size:
        assert np.abs(a - b).max() <= tol * (1.0 + np.abs(b).max())


def interior(seed, mnl=0, diag=False):
    """A point strictly inside the cone of DIMS with mnl extra orthant
    entries; with diag, the s blocks are diagonal (lambda's shape)."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(0.2, 2.0, DIMS["l"] + mnl)]
    for m in DIMS["q"]:
        u = rng.standard_normal(m - 1) * 0.5
        parts.append(np.concatenate([[np.linalg.norm(u) +
                                      rng.uniform(0.3, 1.5)], u]))
    for m in DIMS["s"]:
        if diag:
            X = np.diag(rng.uniform(0.3, 2.0, m))
        else:
            M = rng.standard_normal((m, m))
            X = M @ M.T + m * np.eye(m)
        parts.append(X.reshape(-1))
    return np.concatenate(parts)


def vector(seed, n):
    return np.random.default_rng(seed).standard_normal(n)


def both(fn, *args, **kw):
    """fn of each package on the same numpy arguments."""
    return (getattr(jm, fn)(*args, **kw),
            getattr(tm, fn)(*(torch.from_numpy(a) if isinstance(
                a, np.ndarray) else a for a in args), **kw))


@pytest.mark.parametrize("mnl", MNL)
def test_vector_functions(mnl):
    x, y = vector(1, SIZE + mnl), vector(2, SIZE + mnl)
    lam = interior(3, mnl, diag=True)
    for fn, args, kw in [
            ("sdot", (x, y, DIMS), {"mnl": mnl}),
            ("snrm2", (x, DIMS), {"mnl": mnl}),
            ("sprod", (x, y, DIMS), {"mnl": mnl}),
            ("sprod", (lam, y, DIMS), {"mnl": mnl, "diag": "D"}),
            ("sinv", (x, lam, DIMS), {"mnl": mnl}),
            ("ssqr", (x, DIMS), {"mnl": mnl}),
            ("max_step", (x, DIMS), {"mnl": mnl}),
            ("max_step", (interior(4, mnl), DIMS), {"mnl": mnl}),
            ("symm", (x, DIMS), {"mnl": mnl}),
            ("scale2", (lam, x, DIMS), {"mnl": mnl}),
            ("scale2", (lam, x, DIMS), {"mnl": mnl, "inverse": "I"})]:
        j, t = both(fn, *args, **kw)
        if fn in ("sdot", "snrm2", "max_step"):
            assert isinstance(t, float)
        close(t, j)


@pytest.mark.parametrize("mnl", MNL)
def test_pack_unpack_order(mnl):
    """The reference's packed order: each s block's column-major lower
    triangle column by column, off-diagonals times sqrt 2; unpack leaves
    the strict upper triangle zero."""
    x = interior(5, mnl)
    jp, tp = both("pack", x, DIMS, mnl=mnl)
    assert tp.shape == (PACKED + mnl,)
    close(tp, jp)
    ju, tu = both("unpack", np.array(jp), DIMS, mnl=mnl)
    assert tu.shape == (SIZE + mnl,)
    close(tu, ju)
    ofs = 3 + mnl + 7 + 9                   # the order-2 block
    X = x[ofs:ofs + 4].reshape(2, 2)        # row-major view of the buffer
    close(tp[-3:], [X[0, 0], np.sqrt(2.0) * X[0, 1], X[1, 1]])
    close(tu[ofs:ofs + 4], [X[0, 0], X[0, 1], 0.0, X[1, 1]])
    # the packed inner product is the full one on symmetric data
    close(np.dot(jp, jp), np.dot(x, x))


@pytest.mark.parametrize("mnl", MNL)
@pytest.mark.parametrize("cols", [None, 3])
def test_pack2(mnl, cols):
    rng = np.random.default_rng(6)
    shape = (SIZE + mnl,) if cols is None else (SIZE + mnl, cols)
    x = rng.standard_normal(shape)
    j, t = both("pack2", x, DIMS, mnl=mnl)
    assert t.shape == shape
    close(t, j)
    # the tail past the packed length keeps its values
    close(t[PACKED + mnl:], x[PACKED + mnl:])


@pytest.mark.parametrize("mnl", MNL)
def test_sgemv_jdot_jnrm2(mnl):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((SIZE + mnl, 6))
    x6, xm = rng.standard_normal(6), rng.standard_normal(SIZE + mnl)
    j, t = both("sgemv", A, x6, xm, DIMS, alpha=2.0, beta=-0.5, mnl=mnl)
    close(t, j)
    j, t = both("sgemv", A, xm, x6, DIMS, trans="T", alpha=0.5, beta=3.0,
                mnl=mnl)
    close(t, j)
    u = interior(8)[3:7]                   # an interior q block
    w = rng.standard_normal(4)
    for args in ((u,), (u, w)):
        j, t = both("jdot", *args)
        assert isinstance(t, float)
        close(t, j)
    j, t = both("jnrm2", u)
    assert isinstance(t, float)
    close(t, j)


def scaling_fields_close(Wt, Wj):
    close(Wt.d, Wj.d)
    assert len(Wt.beta) == len(Wj.beta) == len(DIMS["q"])
    for a, b in zip(Wt.beta, Wj.beta):
        assert a.ndim == 0
        close(a, b)
    for a, b in zip(Wt.v, Wj.v):
        close(a, b)
    assert len(Wt.r) == len(Wj.r) == len(DIMS["s"])
    for f in ("r", "rti"):
        for a, b in zip(getattr(Wt, f), getattr(Wj, f)):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape
            close(a @ a.T, b @ b.T)


@pytest.mark.parametrize("mnl", MNL)
def test_compute_update_scaling_and_scale(mnl):
    s, z = interior(9, mnl), interior(10, mnl)
    (Wj, lj), (Wt, lt) = both("compute_scaling", s, z, None, DIMS, mnl=mnl)
    scaling_fields_close(Wt, Wj)
    close(lt, lj)
    s2, z2 = interior(11, mnl), interior(12, mnl)
    Uj, ulj = jm.update_scaling(Wj, lj, s2, z2, DIMS, mnl=mnl)
    Ut, ult = tm.update_scaling(Wt, lt, torch.from_numpy(s2),
                                torch.from_numpy(z2), DIMS, mnl=mnl)
    scaling_fields_close(Ut, Uj)
    close(ult, ulj)
    x = vector(13, SIZE + mnl)
    Wt_as_jax = type(Wj)(*(np.asarray(f) if isinstance(f, torch.Tensor)
                           else tuple(np.asarray(a) for a in f)
                           for f in Wt))
    for trans in "NT":
        for inverse in "NI":
            kw = {"trans": trans, "inverse": inverse, "mnl": mnl}
            # the JAX package's W, as it is, is the port's layout
            close(tm.scale(torch.from_numpy(x), Wj, DIMS, **kw),
                  jm.scale(x, Wj, DIMS, **kw))
            close(tm.scale(torch.from_numpy(x), Wt, DIMS, **kw),
                  jm.scale(x, Wt_as_jax, DIMS, **kw))
    # W z = W^{-T} s = lambda
    close(tm.scale(z, Wt, DIMS, mnl=mnl), lt)
    close(tm.scale(s, Wt, DIMS, trans="T", inverse="I", mnl=mnl), lt)


def test_misc_solvers_reexports_and_trisc():
    for name in ("scale", "scale2", "pack", "pack2", "unpack", "symm",
                 "sdot", "snrm2", "sprod", "sinv", "max_step",
                 "compute_scaling", "update_scaling"):
        assert getattr(tms, name) is getattr(tm, name)
    x = vector(14, SIZE + 2)
    for fn in ("trisc", "triusc"):
        for offset in (0, 2):
            j = getattr(jms, fn)(x, DIMS, offset=offset)
            t = getattr(tms, fn)(x, DIMS, offset=offset)
            close(t, j, 0.0)
    assert tm.use_C is jm.use_C


def sym_rows(G):
    """G with each s block of each column made symmetric, as the front
    ends read it."""
    G = G.copy()
    ofs = DIMS["l"] + sum(DIMS["q"])
    for m in DIMS["s"]:
        X = G[ofs:ofs + m * m].reshape(m, m, -1)
        G[ofs:ofs + m * m] = (0.5 * (X + X.transpose(1, 0, 2))).reshape(
            m * m, -1)
        ofs += m * m
    return G


def qp_data(seed=0, n=20, p=2):
    """A feasible l+q+s QP of DIMS: P SPD, h = G x0 + s0 with s0 in the
    cone's interior, b = A x0."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    G = sym_rows(rng.standard_normal((SIZE, n)))
    x0 = rng.standard_normal(n)
    h = G @ x0 + interior(seed + 100)
    A = rng.standard_normal((p, n))
    return P, q, G, h, A, A @ x0


def lp_data(seed=0, n=12, p=2):
    """A feasible, bounded l+q+s LP of DIMS: h = G x0 + s0 and
    c = -G'z0 - A'y0 with s0, z0 interior.  G's symmetric s rows leave
    it 19 independent rows, so n = 12 keeps G of full column rank, as
    the condensed strategies need."""
    rng = np.random.default_rng(seed)
    G = sym_rows(rng.standard_normal((SIZE, n)))
    A = rng.standard_normal((p, n))
    x0 = rng.standard_normal(n)
    z0 = interior(seed + 200)
    h = G @ x0 + interior(seed + 300)
    c = -G.T @ z0 - A.T @ rng.standard_normal(p)
    return c, G, h, A, A @ x0


def solutions_agree(sj, st, tol=1e-7):
    assert st["status"] == sj["status"]
    assert st["iterations"] == sj["iterations"]
    xj = np.asarray(sj["x"])
    close(st["x"], xj, tol)


KKT = ["kkt_chol", "kkt_chol2", "kkt_qr", "kkt_ldl", "kkt_ldl2"]


@pytest.mark.parametrize("name", KKT)
def test_kkt_through_coneqp_with_H(name):
    P, q, G, h, A, b = qp_data()
    fj = getattr(jm, name)(G, DIMS, A)
    ft = getattr(tm, name)(torch.from_numpy(G), DIMS, torch.from_numpy(A))
    sj = jsolvers.coneqp(P, q, G, h, DIMS, A, b,
                         kktsolver=lambda W, H=None, Df=None: fj(W, H=P))
    st = tsolvers.coneqp(P, q, G, h, DIMS, A, b,
                         kktsolver=lambda W, H=None, Df=None: ft(W, H=P))
    assert st["status"] == "optimal"
    solutions_agree(sj, st)
    ref = tsolvers.coneqp(P, q, G, h, DIMS, A, b)
    close(st["x"], ref["x"].numpy(), 1e-7)


@pytest.mark.parametrize("name", KKT)
def test_kkt_through_conelp(name):
    """kkt_ldl's unpivoted LDL' of the LP's quasidefinite system, whose
    (1,1) block is only the regularization, breaks down in both packages
    on this LP; the iteration where the lane stops depends on rounding
    (ROADMAP.md, Queue 3)."""
    c, G, h, A, b = lp_data()
    sj = jsolvers.conelp(c, G, h, DIMS, A, b,
                         kktsolver=getattr(jm, name)(G, DIMS, A))
    st = tsolvers.conelp(c, G, h, DIMS, A, b,
                         kktsolver=getattr(tm, name)(G, DIMS, A))
    if name == "kkt_ldl":
        assert st["status"] == sj["status"] == "unknown"
        return
    assert st["status"] == "optimal"
    solutions_agree(sj, st)


def orthant_qp(seed=0, n=20, m=40):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    G = rng.standard_normal((m, n))
    return (M @ M.T / n + np.eye(n), rng.standard_normal(n), G,
            G @ rng.standard_normal(n) + rng.uniform(0.5, 1.5, m))


def test_kkt_chol2_without_H_ignores_P():
    """coneqp hands a custom kktsolver W alone, so a kkt_* factor passed
    as it is solves the Newton system without P and the solve does not
    converge, in both packages alike (n=20, m=40 orthant); through the
    H=P wrapper it ends as kktsolver='chol2' does."""
    P, q, G, h = orthant_qp()
    dims = {"l": G.shape[0], "q": [], "s": []}
    sj = jsolvers.coneqp(P, q, G, h, dims,
                         kktsolver=jm.kkt_chol2(G, dims, None))
    st = tsolvers.coneqp(P, q, G, h, dims,
                         kktsolver=tm.kkt_chol2(G, dims, None))
    assert st["status"] == sj["status"] != "optimal"
    assert st["iterations"] == sj["iterations"]
    f = tm.kkt_chol2(G, dims, None)
    st = tsolvers.coneqp(P, q, G, h, dims,
                         kktsolver=lambda W, H=None, Df=None: f(W, H=P))
    ref = tsolvers.coneqp(P, q, G, h, dims, kktsolver="chol2")
    assert st["status"] == ref["status"] == "optimal"
    assert st["iterations"] == ref["iterations"]
    close(st["x"], ref["x"].numpy(), 1e-12)
