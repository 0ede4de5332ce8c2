"""Discrete transforms (reference src/C/fftw.c): dft/idft, dftn/idftn,
dct/idct/dctn/idctn, dst/idst/dstn/idstn.

The reference wraps FFTW and transforms dense matrices *in place*,
column-wise for the 1-d transforms and row-major with a `dims` tuple for
the N-d variants (fftw.c:37-80); the same calling conventions are kept
here.  Transform kernels are scipy.fft on host matrices, by design:
the facade's in-place contract is host-side by nature, and FFTs of
tensors on the card are torch.fft's.  No solver calls this module.

Normalization: idft(dft(x)) == x, idct(dct(x)) == x, idst(dst(x)) == x
(the reference's inverse transforms include the 1/N scaling; see the fftw
module docs in doc/source/fftw.rst).  dct defaults to DCT-II ('REDFT10'),
dst to DST-I ('RODFT00'), matching FFTW's real-even/odd transform kinds.

Copy of kvxopt_tpu/fftw.py: scipy.fft on the host, over the port's
base.matrix.
"""

import numpy as np
import scipy.fft as _fft

from .base import matrix


def _inplace_cols(X, fn, force_complex=False):
    if not isinstance(X, matrix):
        raise TypeError("argument must be a dense matrix")
    a = np.asarray(X)
    out = fn(a)
    if force_complex or np.iscomplexobj(out):
        X._a = np.asfortranarray(out.astype(np.complex128))
    else:
        X._a = np.asfortranarray(out.astype(np.float64))
    return X


def dft(X):
    """In-place column-wise DFT (complex)."""
    return _inplace_cols(X, lambda a: _fft.fft(a, axis=0),
                         force_complex=True)


def idft(X):
    """In-place column-wise inverse DFT; idft(dft(x)) == x."""
    return _inplace_cols(X, lambda a: _fft.ifft(a, axis=0),
                         force_complex=True)


def _nd(X, fn, dims):
    a = np.asarray(X).reshape(-1, order="F")
    if dims is None:
        dims = (len(a),)
    nd = a.reshape(dims[::-1])  # row-major over dims per the reference
    out = fn(nd)
    return out.reshape(-1)


def dftn(X, dims=None):
    """In-place N-dimensional DFT over `dims` (row-major)."""
    out = _nd(X, _fft.fftn, dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.complex128))
    return X


def idftn(X, dims=None):
    """Inverse N-dimensional complex DFT (unnormalized), in place."""
    out = _nd(X, _fft.ifftn, dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.complex128))
    return X


def dct(X, type=2):
    """In-place column-wise DCT (default DCT-II / FFTW REDFT10)."""
    return _inplace_cols(X, lambda a: _fft.dct(a.real, type=type, axis=0))


def idct(X, type=2):
    """Inverse of dct: idct(dct(x)) == x."""
    return _inplace_cols(
        X, lambda a: _fft.idct(a.real, type=type, axis=0))


def dctn(X, dims=None, type=2):
    """N-dimensional DCT over the given dims (default: all), type
    1..4, in place (reference fftw.c dctn)."""
    out = _nd(X, lambda a: _fft.dctn(a.real, type=type), dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.float64))
    return X


def idctn(X, dims=None, type=2):
    """Inverse of `dctn` (unnormalized, like FFTW), in place."""
    out = _nd(X, lambda a: _fft.idctn(a.real, type=type), dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.float64))
    return X


def dst(X, type=1):
    """In-place column-wise DST (default DST-I / FFTW RODFT00)."""
    return _inplace_cols(X, lambda a: _fft.dst(a.real, type=type, axis=0))


def idst(X, type=1):
    """Inverse 1-d DST of the given type (unnormalized), in place."""
    return _inplace_cols(
        X, lambda a: _fft.idst(a.real, type=type, axis=0))


def dstn(X, dims=None, type=1):
    """N-dimensional DST over the given dims, type 1..4, in place."""
    out = _nd(X, lambda a: _fft.dstn(a.real, type=type), dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.float64))
    return X


def idstn(X, dims=None, type=1):
    """Inverse of `dstn` (unnormalized), in place."""
    out = _nd(X, lambda a: _fft.idstn(a.real, type=type), dims)
    X._a = np.asfortranarray(out.reshape(X.size, order="F").astype(
        np.float64))
    return X
