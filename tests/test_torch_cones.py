"""l-cone algebra of kvxopt_tpu_torch.cones against kvxopt_tpu.cones.

Each function runs on a batch of 3 cone vectors (l = 7) in the port and
lane by lane in the JAX package, both in f64 on the CPU.  The operations
are elementwise or single reductions, so 1e-12 relative leaves room
only for summation order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu import cones as jc
from kvxopt_tpu_torch import cones as tc

L, B = 7, 3
JD, TD = jc.ConeDims(l=L), tc.ConeDims(l=L)


def vecs(seed, positive=False):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.1, 2.0, (B, L)) if positive else \
        rng.standard_normal((B, L))
    return v


def close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * (1.0 + np.abs(b).max())


def per_lane(fn, *arrs):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrs)))
                     for i in range(B)])


def scaling(seed):
    s, z = vecs(seed, True), vecs(seed + 1, True)
    return s, z


CASES = {
    "sdot": (lambda u, v: jc.sdot(JD, u, v),
             lambda u, v: tc.sdot(TD, u, v), False),
    "snrm2": (lambda u, v: jc.snrm2(JD, u),
              lambda u, v: tc.snrm2(TD, u), False),
    "sprod": (lambda u, v: jc.sprod(JD, u, v),
              lambda u, v: tc.sprod(TD, u, v), False),
    "ssqr": (lambda u, v: jc.ssqr(JD, u),
             lambda u, v: tc.ssqr(TD, u), False),
    "sinv": (lambda u, v: jc.sinv(JD, u, v),
             lambda u, v: tc.sinv(TD, u, v), True),
    "max_step": (lambda u, v: jc.max_step(JD, u),
                 lambda u, v: tc.max_step(TD, u), False),
    "scale2": (lambda u, v: jc.scale2(JD, u, v),
               lambda u, v: tc.scale2(TD, u, v), True),
    "scale2_inv": (lambda u, v: jc.scale2(JD, u, v, inverse=True),
                   lambda u, v: tc.scale2(TD, u, v, inverse=True), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_elementwise_matches_jax(name):
    jfn, tfn, positive = CASES[name]
    u, v = vecs(0, positive), vecs(1)
    want = per_lane(jfn, u, v)
    got = tfn(torch.from_numpy(u), torch.from_numpy(v))
    close(got, want)


def test_max_step2_matches_jax():
    u, v = vecs(2), vecs(3)
    ws = per_lane(lambda a, b: jnp.stack(jc.max_step2(JD, a, b)), u, v)
    ts, tz = tc.max_step2(TD, torch.from_numpy(u), torch.from_numpy(v))
    close(ts, ws[:, 0])
    close(tz, ws[:, 1])


def test_cone_e_and_identity_scaling():
    close(tc.cone_e(TD, torch.float64), jc.cone_e(JD, jnp.float64))
    W = tc.identity_scaling(TD, B, torch.float64)
    assert W.d.shape == (B, L)
    close(W.d, np.stack([np.asarray(jc.identity_scaling(JD, jnp.float64).d)
                         for _ in range(B)]))


def test_compute_scaling_matches_jax():
    s, z = scaling(4)
    W, lam = tc.compute_scaling(TD, torch.from_numpy(s), torch.from_numpy(z))
    close(W.d, per_lane(lambda a, b: jc.compute_scaling(JD, a, b)[0].d, s, z))
    close(lam, per_lane(lambda a, b: jc.compute_scaling(JD, a, b)[1], s, z))
    # W z = W^{-T} s = lambda
    close(tc.scale(TD, W, torch.from_numpy(z)), lam)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_scale_matches_jax(trans, inverse):
    s, z = scaling(5)
    u = vecs(6)
    W, _ = tc.compute_scaling(TD, torch.from_numpy(s), torch.from_numpy(z))
    got = tc.scale(TD, W, torch.from_numpy(u), trans=trans, inverse=inverse)

    def one(si, zi, ui):
        Wj, _ = jc.compute_scaling(JD, si, zi)
        return jc.scale(JD, Wj, ui, trans=trans, inverse=inverse)
    close(got, per_lane(one, s, z, u))


def test_wtw_scale_cols_matches_jax():
    s, z = scaling(7)
    G = np.random.default_rng(8).standard_normal((B, L, 5))
    W, _ = tc.compute_scaling(TD, torch.from_numpy(s), torch.from_numpy(z))
    got = tc.wtw_scale_cols(TD, W, torch.from_numpy(G))

    def one(si, zi, Gi):
        Wj, _ = jc.compute_scaling(JD, si, zi)
        return jc.wtw_scale_cols(JD, Wj, Gi)
    close(got, per_lane(one, s, z, G))


def test_conedims_mirrors_jax():
    d = {"l": 3, "q": [4, 2], "s": [3]}
    jd, td = jc.ConeDims.from_dict(d), tc.ConeDims.from_dict(d)
    for attr in ("size", "degree", "qofs", "sofs"):
        assert getattr(jd, attr) == getattr(td, attr)
    assert td.with_extra_l(2) == tc.ConeDims(l=5, q=(4, 2), s=(3,))
    with pytest.raises(ValueError):
        tc.ConeDims(l=-1)


def test_q_and_s_cones_not_ported():
    """q cones (tests/test_torch_cones_q.py) and s cones
    (tests/test_torch_cones_s.py) are ported: nothing here raises."""
    close(tc.cone_e(tc.ConeDims(l=2, q=(3,)), torch.float64),
          [1.0, 1.0, 1.0, 0.0, 0.0])
    close(tc.cone_e(tc.ConeDims(l=2, s=(3,)), torch.float64),
          [1.0, 1.0] + np.eye(3).ravel().tolist())
    close(tc.sprod(tc.ConeDims(s=(2,)), torch.ones(1, 4), torch.ones(1, 4)),
          [[2.0, 2.0, 2.0, 2.0]])
