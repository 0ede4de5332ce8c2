"""kvxopt_tpu_torch.fftw: the five cases of tests/test_fftw.py on the
port, and each of the twelve transforms against kvxopt_tpu.fftw on the
same input, to 1e-12 (the same scipy.fft calls on both sides)."""

import numpy as np
import pytest
import scipy.fft

import kvxopt_tpu as jpkg
from kvxopt_tpu import fftw as jfftw
from kvxopt_tpu_torch import fftw, matrix


def test_dft_roundtrip():
    X = matrix(np.random.default_rng(0).standard_normal((8, 3)))
    orig = np.asarray(X).copy()
    fftw.dft(X)
    assert X.typecode == "z"
    np.testing.assert_allclose(np.asarray(X), np.fft.fft(orig, axis=0),
                               atol=1e-10)
    fftw.idft(X)
    np.testing.assert_allclose(np.asarray(X).real, orig, atol=1e-10)


def test_dct_roundtrip():
    X = matrix(np.random.default_rng(1).standard_normal((16, 2)))
    orig = np.asarray(X).copy()
    fftw.dct(X)
    np.testing.assert_allclose(np.asarray(X), scipy.fft.dct(orig, axis=0),
                               atol=1e-10)
    fftw.idct(X)
    np.testing.assert_allclose(np.asarray(X), orig, atol=1e-10)


def test_dst_roundtrip():
    X = matrix(np.random.default_rng(2).standard_normal((10, 1)))
    orig = np.asarray(X).copy()
    fftw.dst(X)
    fftw.idst(X)
    np.testing.assert_allclose(np.asarray(X), orig, atol=1e-10)


def test_dftn_roundtrip():
    X = matrix(np.random.default_rng(3).standard_normal((12, 1)))
    orig = np.asarray(X).copy()
    fftw.dftn(X, dims=(3, 4))
    fftw.idftn(X, dims=(3, 4))
    np.testing.assert_allclose(np.asarray(X).real, orig, atol=1e-10)


def test_dctn_idctn():
    X = matrix(np.random.default_rng(4).standard_normal((6, 1)))
    orig = np.asarray(X).copy()
    fftw.dctn(X, dims=(2, 3))
    fftw.idctn(X, dims=(2, 3))
    np.testing.assert_allclose(np.asarray(X), orig, atol=1e-10)


# (transform, keyword arguments, input shape, complex input)
TRANSFORMS = [
    ("dft", {}, (8, 3), False), ("idft", {}, (8, 3), True),
    ("dftn", {"dims": (3, 4)}, (12, 1), True),
    ("idftn", {"dims": (3, 4)}, (12, 1), True),
    ("dct", {}, (16, 2), False), ("idct", {}, (16, 2), False),
    ("dct", {"type": 3}, (9, 2), False),
    ("dctn", {"dims": (2, 3)}, (6, 1), False),
    ("idctn", {"dims": (2, 3)}, (6, 1), False),
    ("dst", {}, (10, 2), False), ("idst", {}, (10, 2), False),
    ("dstn", {"dims": (2, 5)}, (10, 1), False),
    ("idstn", {"dims": (2, 5)}, (10, 1), False),
]


@pytest.mark.parametrize("i", range(len(TRANSFORMS)),
                         ids=[f"{t[0]}{t[1] or ''}" for t in TRANSFORMS])
def test_transform_matches_jax(i):
    name, kw, shape, cplx = TRANSFORMS[i]
    rng = np.random.default_rng(10 + i)
    a = rng.standard_normal(shape)
    if cplx:
        a = a + 1j * rng.standard_normal(shape)
    Xt, Xj = matrix(a.copy()), jpkg.matrix(a.copy())
    getattr(fftw, name)(Xt, **kw)
    getattr(jfftw, name)(Xj, **kw)
    assert Xt.typecode == Xj.typecode and Xt.size == Xj.size
    t, j = np.asarray(Xt), np.asarray(Xj)
    assert np.abs(t - j).max() <= 1e-12 * (1.0 + np.abs(j).max())
    assert np.abs(t - a).max() > 1e-3       # the transform changed X
