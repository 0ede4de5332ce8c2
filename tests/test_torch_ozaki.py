"""Exact-split products of kvxopt_tpu_torch.ops.ozaki against
kvxopt_tpu.ops.ozaki.

Both sides split the same f64 operands into the same f32 slices and sum
slice products that are exact in f32, so they agree to f64 rounding of
the final sums: 1e-13 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kvxopt_tpu.ops import ozaki as jo
from kvxopt_tpu_torch.ops import ozaki as to


def rel_close(a, b, tol=1e-13):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def operand(shape, seed):
    rng = np.random.default_rng(seed)
    # a spread of magnitudes across rows, as in a W-scaled G
    return rng.standard_normal(shape) * np.exp(
        rng.uniform(-4, 4, shape[:-1] + (1,)))


@pytest.mark.parametrize("n", [2, 100, 512, 5000])
def test_default_bits_and_slices(n):
    nb = to.default_nbits(n)
    assert nb == jo.default_nbits(n)
    assert to.default_nslices(nb) == jo.default_nslices(nb)


def test_split_fp_matches_jax():
    A = operand((3, 20, 33), 0)
    S, sc = to.split_fp(torch.from_numpy(A), 6, 7)
    Sj, scj = jo.split_fp(jnp.asarray(A), 6, 7)
    assert S.dtype == torch.float32
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    # torch.exp2 of an integer is an exact power of two; XLA's CPU exp2
    # can be off by an ulp, so the scales agree to f64 rounding only
    rel_close(sc, scj, 1e-15)


@pytest.mark.parametrize("B,m,n", [(3, 32, 16), (2, 260, 130)])
def test_ata_matches_jax(B, m, n):
    A = operand((B, m, n), 1)
    got = to.ata(torch.from_numpy(A))
    want = np.stack([np.asarray(jo.ata(jnp.asarray(A[i]))) for i in range(B)])
    rel_close(got, want)


@pytest.mark.parametrize("B,m,n", [(3, 32, 16), (2, 260, 130)])
def test_operator_matches_jax(B, m, n):
    A = operand((B, m, n), 2)
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    op = to.OzakiOperator(torch.from_numpy(A))
    for i in range(B):
        jop = jo.OzakiOperator(jnp.asarray(A[i]))
        rel_close(op.mv(torch.from_numpy(x))[i], jop.mv(jnp.asarray(x[i])))
        rel_close(op.rmv(torch.from_numpy(w))[i],
                  jop.rmv(jnp.asarray(w[i])))
        rel_close(op.normal_mv(torch.from_numpy(x))[i],
                  jop.normal_mv(jnp.asarray(x[i])))
    # and against the plain f64 products
    rel_close(to.gram_matvec_fn(torch.from_numpy(A))(torch.from_numpy(x)),
              np.einsum("bji,bjk,bk->bi", A, A, x), 1e-12)
