"""Semidefinite-cone algebra of kvxopt_tpu_torch.cones against
kvxopt_tpu.cones.

Each function runs on a batch of 3 cone vectors in the port and through
jax.vmap in the JAX package, both in f64 on the CPU, on l=2, q=(3,),
s=(3,2,3) (the order-3 group is blocks 0 and 2, not one slice) and on
l=0, s=(4,).  Sums and products of O(1) numbers agree to 1e-12 relative.

Eigenvectors and singular vectors are free up to sign, and up to a
rotation inside a repeated eigenvalue, so r and rti are compared through
what does not depend on that choice: r r', rti rti', W z = W^{-T} s =
lambda and rti' r = I, to 1e-10 relative (eigh of L_z' L_s as the
Gram matrix squares its condition number).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import cones as jc
from kvxopt_tpu_torch import cones as tc
from kvxopt_tpu_torch.convert import scaling_from_jax, scaling_to_jax

B = 3
DIMS = [dict(l=2, q=(3,), s=(3, 2, 3)), dict(l=0, q=(), s=(4,))]
IDS = ["l2-q3-s323", "s4"]


def close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size:
        assert np.abs(a - b).max() <= tol * (1.0 + np.abs(b).max())


def T(a):
    return torch.from_numpy(np.array(a))


def jd_td(d):
    return jc.ConeDims(**d), tc.ConeDims(**d)


def interior(d, seed, diag=False):
    """(B, size) points strictly inside the cone; with diag, the s blocks
    are diagonal (the shape of lambda)."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, jc.ConeDims(**d).size))
    out[:, :d["l"]] = rng.uniform(0.2, 2.0, (B, d["l"]))
    ofs = d["l"]
    for m in d["q"]:
        u = rng.standard_normal((B, m - 1)) * 0.5
        out[:, ofs] = np.linalg.norm(u, axis=1) + rng.uniform(0.3, 1.5, B)
        out[:, ofs + 1:ofs + m] = u
        ofs += m
    for m in d["s"]:
        if diag:
            X = np.stack([np.diag(rng.uniform(0.3, 2.0, m))
                          for _ in range(B)])
        else:
            M = rng.standard_normal((B, m, m)) * 0.5
            X = M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(m)
        out[:, ofs:ofs + m * m] = X.reshape(B, -1)
        ofs += m * m
    return out


def anyvec(d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, jc.ConeDims(**d).size))


def vmapped(fn, *arrs):
    """fn vmapped over the lanes of numpy arrays (or pytrees of them)."""
    out = jax.vmap(fn)(*jax.tree_util.tree_map(jnp.asarray, arrs))
    return jax.tree_util.tree_map(np.asarray, out)


def sblocks(d, u):
    """The s blocks of (B, size) vectors, one (B, m, m) array each."""
    u = np.asarray(u)
    JD = jc.ConeDims(**d)
    return [u[:, o:o + m * m].reshape(B, m, m) for o, m in zip(JD.sofs,
                                                              JD.s)]


def gram(r):
    r = np.asarray(r)
    return r @ np.swapaxes(r, -1, -2)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_block_groups_match_jax(d):
    jq, js = jc.block_groups(jc.ConeDims(**d))
    tq, ts = tc.block_groups(tc.ConeDims(**d))
    assert len(tq) == len(jq) and len(ts) == len(js)
    for (m, idxs, flat), g in zip(jq + js, tq + ts):
        assert (g.m, g.idxs) == (m, idxs)
        np.testing.assert_array_equal(g.flat, flat)
    for (m, idxs, flat), g in zip(js, ts):
        assert isinstance(g, tc.SGroup)
        assert (g.start is None) == (d["s"] == (3, 2, 3) and m == 3)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_algebra_matches_jax(d):
    JD, TD = jd_td(d)
    close(tc.cone_e(TD, torch.float64), jc.cone_e(JD, jnp.float64))
    u, y = anyvec(d, 1), anyvec(d, 2)
    x, lam = interior(d, 3), interior(d, 4, diag=True)
    close(tc.sdot(TD, T(u), T(y)), vmapped(lambda a, b: jc.sdot(JD, a, b),
                                           u, y))
    close(tc.snrm2(TD, T(u)), vmapped(lambda a: jc.snrm2(JD, a), u))
    close(tc.sprod(TD, T(u), T(y)),
          vmapped(lambda a, b: jc.sprod(JD, a, b), u, y))
    close(tc.sprod(TD, T(lam), T(y), diag=True),
          vmapped(lambda a, b: jc.sprod(JD, a, b, diag=True), lam, y))
    close(tc.ssqr(TD, T(u)), vmapped(lambda a: jc.ssqr(JD, a), u))
    got = tc.sinv(TD, T(lam), T(y))
    close(got, vmapped(lambda a, b: jc.sinv(JD, a, b), lam, y))
    # lambda o (lambda \o y) = y
    close(tc.sprod(TD, T(lam), got, diag=True), y, 1e-11)
    # the diag product agrees with the full one on diagonal x
    close(tc.sprod(TD, T(lam), T(x), diag=True),
          tc.sprod(TD, T(lam), T(x)))


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_max_step_matches_jax(d):
    JD, TD = jd_td(d)
    for u in (anyvec(d, 5), interior(d, 6)):
        close(tc.max_step(TD, T(u)), vmapped(lambda a: jc.max_step(JD, a),
                                             u))
    u, v = anyvec(d, 7), interior(d, 8)
    ts, tz = tc.max_step2(TD, T(u), T(v))
    ws = vmapped(lambda a, b: jnp.stack(jc.max_step2(JD, a, b)), u, v)
    close(ts, ws[:, 0])
    close(tz, ws[:, 1])
    assert bool((tz < 0).all())

    t, eig = tc.max_step_eig(TD, T(u))
    tj, eigj = vmapped(lambda a: jc.max_step_eig(JD, a), u)
    close(t, tj)
    sym = [0.5 * (X + np.swapaxes(X, 1, 2)) for X in sblocks(d, u)]
    for gi, g in enumerate(tc.block_groups(TD)[1]):
        sig, Q = (a.numpy() for a in eig[gi])
        close(sig, eigj[gi][0])            # distinct eigenvalues, ascending
        rebuilt = (Q * sig[..., None, :]) @ np.swapaxes(Q, -1, -2)
        close(rebuilt, np.stack([sym[k] for k in g.idxs], 1))


@pytest.mark.parametrize("method", ["eigh", "svd"])
@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_compute_scaling_matches_jax(d, method):
    JD, TD = jd_td(d)
    s, z = interior(d, 9), interior(d, 10)
    W, lam = tc.compute_scaling(TD, T(s), T(z), method=method)
    Wj, lamj = vmapped(lambda a, b: jc.compute_scaling(JD, a, b, method),
                       s, z)
    close(lam, lamj, 1e-10)
    dd, beta, v, r, rti = scaling_to_jax(TD, W)
    close(dd, Wj.d)
    for k in range(len(d["q"])):
        close(beta[k], Wj.beta[k])
        close(v[k], Wj.v[k])
    for k in range(len(d["s"])):
        close(gram(r[k]), gram(Wj.r[k]), 1e-10)
        close(gram(rti[k]), gram(Wj.rti[k]), 1e-10)
        close(np.swapaxes(rti[k], 1, 2) @ r[k],
              np.broadcast_to(np.eye(d["s"][k]), r[k].shape), 1e-10)
    # W z = W^{-T} s = lambda, lambda's s blocks diagonal
    close(tc.scale(TD, W, T(z)), lam, 1e-10)
    close(tc.scale(TD, W, T(s), trans=True, inverse=True), lam, 1e-10)
    for X in sblocks(d, lam):
        assert np.array_equal(X, X * np.eye(X.shape[-1]))
    # update_scaling recomputes the same scaling
    _, lam2 = tc.update_scaling(TD, W, T(s), T(z))
    close(lam2, lamj, 1e-10)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_identity_scaling_matches_jax(d):
    JD, TD = jd_td(d)
    W = tc.identity_scaling(TD, B, torch.float64)
    Wj = jc.identity_scaling(JD, jnp.float64)
    dd, beta, v, r, rti = scaling_to_jax(TD, W)
    for k in range(len(d["s"])):
        close(r[k], np.broadcast_to(np.asarray(Wj.r[k]), r[k].shape))
        close(rti[k], np.broadcast_to(np.asarray(Wj.rti[k]), r[k].shape))
    u = anyvec(d, 11)
    for trans in (False, True):
        for inverse in (False, True):
            close(tc.scale(TD, W, T(u), trans=trans, inverse=inverse), u)


def jax_W(d, seed):
    """The JAX package's scaling at a random interior pair, and the same
    W in the port's layout."""
    JD, TD = jd_td(d)
    s, z = interior(d, seed), interior(d, seed + 1)
    Wj, lamj = vmapped(lambda a, b: jc.compute_scaling(JD, a, b), s, z)
    W = scaling_from_jax(TD, Wj.d, Wj.beta, Wj.v, Wj.r, Wj.rti, device="cpu")
    return Wj, W, lamj


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_scale_matches_jax(d, trans, inverse):
    """Both packages apply the same W (the JAX package's, carried over by
    convert.scaling_from_jax)."""
    JD, TD = jd_td(d)
    Wj, W, _ = jax_W(d, 12)
    u = anyvec(d, 14)
    got = tc.scale(TD, W, T(u), trans=trans, inverse=inverse)
    close(got, vmapped(lambda Wl, ul: jc.scale(JD, Wl, ul, trans=trans,
                                               inverse=inverse), Wj, u))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_scale2_matches_jax(d, inverse):
    JD, TD = jd_td(d)
    lam, u = interior(d, 15, diag=True), anyvec(d, 16)
    close(tc.scale2(TD, T(lam), T(u), inverse=inverse),
          vmapped(lambda a, b: jc.scale2(JD, a, b, inverse=inverse), lam, u))
    if not inverse:                 # H(lambda^{-1/2}) maps lambda to e
        close(tc.scale2(TD, T(lam), T(lam)),
              np.broadcast_to(np.asarray(jc.cone_e(JD, jnp.float64)),
                              lam.shape), 1e-11)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_wtw_scale_cols_matches_jax(d):
    JD, TD = jd_td(d)
    Wj, W, _ = jax_W(d, 17)
    G = np.random.default_rng(19).standard_normal((B, JD.size, 5))
    got = tc.wtw_scale_cols(TD, W, T(G))
    close(got, vmapped(lambda Wl, Gl: jc.wtw_scale_cols(JD, Wl, Gl), Wj, G))
    close(got[..., 2], tc.scale(TD, W, T(G[..., 2]), trans=True,
                                inverse=True))


def factors(d, seed):
    """l/q parts interior points, s parts lower-triangular factors with a
    positive diagonal (the inputs of update_scaling_inc)."""
    out = interior(d, seed)
    rng = np.random.default_rng(seed + 100)
    JD = jc.ConeDims(**d)
    for o, m in zip(JD.sofs, JD.s):
        Lf = np.tril(rng.standard_normal((B, m, m)) * 0.3, -1) + \
            np.stack([np.diag(rng.uniform(0.5, 1.5, m)) for _ in range(B)])
        out[:, o:o + m * m] = Lf.reshape(B, -1)
    return out


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_update_scaling_inc_matches_jax(d):
    JD, TD = jd_td(d)
    Wj, W, lamj = jax_W(d, 20)
    s, z = factors(d, 22), factors(d, 23)
    W2, lam2 = tc.update_scaling_inc(TD, W, T(lamj), T(s), T(z))
    W2j, lam2j = vmapped(lambda Wl, a, b, c: jc.update_scaling_inc(
        JD, Wl, a, b, c), Wj, lamj, s, z)
    close(lam2, lam2j, 1e-10)
    dd, beta, v, r, rti = scaling_to_jax(TD, W2)
    close(dd, W2j.d)
    for k in range(len(d["q"])):
        close(beta[k], W2j.beta[k], 1e-10)
        close(v[k], W2j.v[k], 1e-10)
    for k in range(len(d["s"])):
        close(gram(r[k]), gram(W2j.r[k]), 1e-10)
        close(gram(rti[k]), gram(W2j.rti[k]), 1e-10)
        close(np.swapaxes(rti[k], 1, 2) @ r[k],
              np.broadcast_to(np.eye(d["s"][k]), r[k].shape), 1e-10)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_step_scaled_iterates_matches_jax(d):
    JD, TD = jd_td(d)
    lam, dw = interior(d, 24, diag=True), 0.3 * anyvec(d, 25)
    dw = np.asarray(tc.symm(TD, T(dw)))
    step = np.array([0.2, 0.5, 0.9])
    _, eig = tc.max_step_eig(TD, tc.scale2(TD, T(lam), T(dw)))
    got = tc.step_scaled_iterates(TD, T(lam), T(dw), eig, T(step))

    def one(a, b, st):
        _, e = jc.max_step_eig(JD, jc.scale2(JD, a, b))
        return jc.step_scaled_iterates(JD, a, b, e, st)
    want = vmapped(one, lam, dw, step)
    n0 = d["l"] + sum(d["q"])
    close(got[:, :n0], want[:, :n0])
    for X, Xj in zip(sblocks(d, got), sblocks(d, want)):
        close(gram(X), gram(Xj), 1e-10)
    # a scalar step is the same step on every lane
    one_step = tc.step_scaled_iterates(TD, T(lam), T(dw), eig, 0.5)
    close(one_step[1], got[1])


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_lmbda_to_cone_matches_jax(d):
    JD, TD = jd_td(d)
    Wj, W, lamj = jax_W(d, 26)
    s, z = tc.lmbda_to_cone(TD, W, T(lamj))
    sj, zj = vmapped(lambda Wl, a: jc.lmbda_to_cone(JD, Wl, a), Wj, lamj)
    close(s, sj)
    close(z, zj)
    # and they are the pair the scaling came from
    close(s, interior(d, 26), 1e-10)
    close(z, interior(d, 27), 1e-10)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_storage_matches_jax(d):
    JD, TD = jd_td(d)
    u = anyvec(d, 28)
    assert tc.pack_size(TD) == jc.pack_size(JD)
    p = tc.pack(TD, T(u))
    close(p, vmapped(lambda a: jc.pack(JD, a), u))
    close(tc.unpack(TD, p), vmapped(lambda a: jc.unpack(JD, a), p.numpy()))
    for fn, jfn in ((tc.sym_from_lower, jc.sym_from_lower),
                    (tc.symm, jc.symm)):
        close(fn(TD, T(u)), vmapped(lambda a: jfn(JD, a), u))
    # sym_from_lower reads the row-major upper triangle, and unpack(pack)
    # is the identity on symmetric data
    sym = tc.sym_from_lower(TD, T(u))
    for X, Xu in zip(sblocks(d, sym), sblocks(d, u)):
        close(np.triu(X), np.triu(Xu), 0.0)
    close(tc.unpack(TD, tc.pack(TD, sym)), sym)
    close(tc.sdot(TD, sym, sym), torch.sum(tc.pack(TD, sym) ** 2, dim=-1))
    G = np.random.default_rng(29).standard_normal((B, JD.size, 4))
    close(tc.sym_from_lower_cols(TD, T(G)),
          vmapped(lambda a: jc.sym_from_lower_cols(JD, a), G))


def test_scaling_round_trips_through_convert():
    d = DIMS[0]
    TD = tc.ConeDims(**d)
    W, _ = tc.compute_scaling(TD, T(interior(d, 30)), T(interior(d, 31)))
    W2 = scaling_from_jax(TD, *scaling_to_jax(TD, W), device="cpu")
    assert [len(W2.r), len(W2.rti)] == [2, 2]      # s groups of order 2, 3
    for a, b in zip(W.beta + W.v + W.r + W.rti + (W.d,),
                    W2.beta + W2.v + W2.r + W2.rti + (W2.d,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_nan_in_an_s_block_gives_nan_on_that_lane(d):
    """One lane with NaN in an s block: the port's max_step, max_step_eig
    and compute_scaling give NaN on that lane (as jnp.linalg does) and the
    JAX values on the others."""
    JD, TD = jd_td(d)
    u, s, z = anyvec(d, 32), interior(d, 33), interior(d, 34)
    o = JD.sofs[-1]
    for a in (u, s):
        a[1, o + 1] = np.nan
    t = tc.max_step(TD, T(u)).numpy()
    tj = vmapped(lambda a: jc.max_step(JD, a), u)
    t2, eig = tc.max_step_eig(TD, T(u))
    t2j = vmapped(lambda a: jc.max_step_eig(JD, a)[0], u)
    W, lam = tc.compute_scaling(TD, T(s), T(z))
    Wj, lamj = vmapped(lambda a, b: jc.compute_scaling(JD, a, b), s, z)
    assert np.isnan(tj[1]) and np.isnan(t2j[1]) and np.isnan(lamj[1]).any()
    for got, want, tol in ((t, tj, 1e-12), (t2.numpy(), t2j, 1e-12),
                           (lam.numpy(), lamj, 1e-10)):
        assert np.isnan(got[1]).any()
        close(got[[0, 2]], want[[0, 2]], tol)
    # NaN fills the blocks that held it, and only those
    sig = eig[-1][0].numpy()
    assert np.isnan(sig[1, -1]).all() and np.isfinite(sig[[0, 2]]).all()
    assert np.isfinite(sblocks(d, lam)[0][1]).all() == (len(d["s"]) > 1)
    ts, tz = tc.max_step2(TD, T(u), T(s))
    assert np.isnan(float(ts[1])) and np.isnan(float(tz[1]))
