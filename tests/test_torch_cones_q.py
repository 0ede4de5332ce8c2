"""Second-order-cone algebra of kvxopt_tpu_torch.cones against
kvxopt_tpu.cones.

Each function runs on a batch of 3 cone vectors in the port and lane by
lane in the JAX package, both in f64 on the CPU, on mixed l + q dims
with unequal block sizes: l=3, q=(4,4,6) (two groups, each one slice)
and l=2, q=(4,6,4) (the size-4 group is not adjacent).  The operations
are short sums and products of O(1) numbers at interior points, so 1e-12
relative leaves room only for summation order.
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
DIMS = [dict(l=3, q=(4, 4, 6)), dict(l=2, q=(4, 6, 4))]
IDS = ["l3-q446", "l2-q464"]


def close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * (1.0 + np.abs(b).max())


def interior(d, seed):
    """(B, size) points strictly inside the cone."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, jc.ConeDims(**d).size))
    out[:, :d["l"]] = rng.uniform(0.2, 2.0, (B, d["l"]))
    ofs = d["l"]
    for m in d["q"]:
        u = rng.standard_normal((B, m - 1)) * 0.5
        out[:, ofs] = np.linalg.norm(u, axis=1) + rng.uniform(0.3, 1.5, B)
        out[:, ofs + 1:ofs + m] = u
        ofs += m
    return out


def anyvec(d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, jc.ConeDims(**d).size))


def per_lane(fn, *arrs):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrs)))
                     for i in range(B)])


def T(a):
    return torch.from_numpy(np.asarray(a))


def jax_scaling(JD, s, z):
    """The JAX package's (W, lambda) vmapped over the lanes, numpy."""
    W, lam = jax.vmap(lambda a, b: jc.compute_scaling(JD, a, b))(
        jnp.asarray(s), jnp.asarray(z))
    return jax.tree_util.tree_map(np.asarray, W), np.asarray(lam)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_block_groups_match_jax(d):
    jq, _ = jc.block_groups(jc.ConeDims(**d))
    tq, ts = tc.block_groups(tc.ConeDims(**d))
    assert ts == [] and len(tq) == len(jq)
    for (m, idxs, flat), g in zip(jq, tq):
        assert (g.m, g.idxs) == (m, idxs)
        np.testing.assert_array_equal(g.flat, flat)
        assert (g.start is None) == (d["q"] == (4, 6, 4) and m == 4)


def test_jdot_jnrm2_and_block_helpers_match_jax():
    x = interior(dict(l=0, q=(5,)), 0)
    u = anyvec(dict(l=0, q=(5,)), 1)
    close(tc.jdot(T(x)), per_lane(jc.jdot, x))
    close(tc.jnrm2(T(x)), per_lane(jc.jnrm2, x))
    close(tc._soc_sqrt(T(x)), per_lane(jc._soc_sqrt, x))
    beta = np.random.default_rng(2).uniform(0.5, 2.0, B)
    v = interior(dict(l=0, q=(5,)), 3)
    v = v / per_lane(jc.jnrm2, v)[:, None]          # v'Jv = 1
    for tf, jf in ((tc._soc_apply, jc._soc_apply),
                   (tc._soc_apply_inv, jc._soc_apply_inv)):
        close(tf(T(beta), T(v), T(u)), per_lane(jf, beta, v, u))
        # and the inverse undoes the map
    close(tc._soc_apply_inv(T(beta), T(v), tc._soc_apply(T(beta), T(v),
                                                         T(u))), u)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_cone_e_and_products_match_jax(d):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    close(tc.cone_e(TD, torch.float64), jc.cone_e(JD, jnp.float64))
    x, y, u = interior(d, 4), anyvec(d, 5), anyvec(d, 6)
    close(tc.sdot(TD, T(u), T(y)), per_lane(lambda a, b: jc.sdot(JD, a, b),
                                            u, y))
    close(tc.snrm2(TD, T(u)), per_lane(lambda a: jc.snrm2(JD, a), u))
    close(tc.sprod(TD, T(u), T(y)),
          per_lane(lambda a, b: jc.sprod(JD, a, b), u, y))
    close(tc.ssqr(TD, T(u)), per_lane(lambda a: jc.ssqr(JD, a), u))
    close(tc.sinv(TD, T(x), T(y)),
          per_lane(lambda a, b: jc.sinv(JD, a, b), x, y))
    # x o (x \o y) = y
    close(tc.sprod(TD, T(x), tc.sinv(TD, T(x), T(y))), y, 1e-11)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_max_step_matches_jax(d):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    for u in (anyvec(d, 7), interior(d, 8)):
        close(tc.max_step(TD, T(u)), per_lane(lambda a: jc.max_step(JD, a),
                                              u))
    u, v = anyvec(d, 9), interior(d, 10)
    ts, tz = tc.max_step2(TD, T(u), T(v))
    ws = per_lane(lambda a, b: jnp.stack(jc.max_step2(JD, a, b)), u, v)
    close(ts, ws[:, 0])
    close(tz, ws[:, 1])
    assert bool((tz < 0).all())          # interior points


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_compute_scaling_matches_jax(d):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    s, z = interior(d, 11), interior(d, 12)
    W, lam = tc.compute_scaling(TD, T(s), T(z))
    Wj, lamj = jax_scaling(JD, s, z)
    close(lam, lamj)
    dd, beta, v = scaling_to_jax(TD, W)[:3]
    close(dd, Wj.d)
    for k in range(len(d["q"])):
        close(beta[k], Wj.beta[k])
        close(v[k], Wj.v[k])
    # W z = W^{-T} s = lambda, and lambda'lambda = s'z
    close(tc.scale(TD, W, T(z)), lam)
    close(tc.scale(TD, W, T(s), trans=True, inverse=True), lam)
    close(tc.sdot(TD, lam, lam), tc.sdot(TD, T(s), T(z)))


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_identity_scaling_matches_jax(d):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    W = tc.identity_scaling(TD, B, torch.float64)
    Wj = jc.identity_scaling(JD, jnp.float64)
    dd, beta, v = scaling_to_jax(TD, W)[:3]
    close(dd, np.broadcast_to(np.asarray(Wj.d), (B, d["l"])))
    for k in range(len(d["q"])):
        close(beta[k], np.full(B, float(Wj.beta[k])))
        close(v[k], np.broadcast_to(np.asarray(Wj.v[k]), (B, d["q"][k])))
    u = anyvec(d, 13)
    close(tc.scale(TD, W, T(u)), u)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_scale_matches_jax(d, trans, inverse):
    """Both packages apply the same W (the JAX package's, carried over by
    convert.scaling_from_jax)."""
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    s, z, u = interior(d, 14), interior(d, 15), anyvec(d, 16)
    Wj, _ = jax_scaling(JD, s, z)
    W = scaling_from_jax(TD, Wj.d, Wj.beta, Wj.v, device="cpu")
    got = tc.scale(TD, W, T(u), trans=trans, inverse=inverse)
    want = np.asarray(jax.vmap(
        lambda Wl, ul: jc.scale(JD, Wl, ul, trans=trans, inverse=inverse))(
            jax.tree_util.tree_map(jnp.asarray, Wj), jnp.asarray(u)))
    close(got, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_scale2_matches_jax(d, inverse):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    lam, u = interior(d, 17), anyvec(d, 18)
    got = tc.scale2(TD, T(lam), T(u), inverse=inverse)
    close(got, per_lane(lambda a, b: jc.scale2(JD, a, b, inverse=inverse),
                        lam, u))
    # H(lambda^{-1/2}) maps lambda to e
    if not inverse:
        close(tc.scale2(TD, T(lam), T(lam)),
              np.broadcast_to(np.asarray(jc.cone_e(JD, jnp.float64)),
                              lam.shape), 1e-11)


@pytest.mark.parametrize("d", DIMS, ids=IDS)
def test_wtw_scale_cols_matches_jax(d):
    JD, TD = jc.ConeDims(**d), tc.ConeDims(**d)
    s, z = interior(d, 19), interior(d, 20)
    G = np.random.default_rng(21).standard_normal((B, JD.size, 5))
    Wj, _ = jax_scaling(JD, s, z)
    W = scaling_from_jax(TD, Wj.d, Wj.beta, Wj.v, device="cpu")
    got = tc.wtw_scale_cols(TD, W, T(G))
    want = np.asarray(jax.vmap(lambda Wl, Gl: jc.wtw_scale_cols(JD, Wl, Gl))(
        jax.tree_util.tree_map(jnp.asarray, Wj), jnp.asarray(G)))
    close(got, want)
    # each column is W^{-T} applied to that column of G
    close(got[..., 2], tc.scale(TD, W, T(G[..., 2]), trans=True,
                                inverse=True))


def test_scaling_round_trips_through_convert():
    d = DIMS[1]
    TD = tc.ConeDims(**d)
    W, _ = tc.compute_scaling(TD, T(interior(d, 22)), T(interior(d, 23)))
    W2 = scaling_from_jax(TD, *scaling_to_jax(TD, W), device="cpu")
    for a, b in zip(W.beta + W.v + (W.d,), W2.beta + W2.v + (W2.d,)):
        assert torch.equal(a, b)
