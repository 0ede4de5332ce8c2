"""Dense `matrix` and sparse `spmatrix` types plus the base module's
generic operations.

API-parity layer over the reference's C matrix core (reference
src/C/dense.c — the `matrix` object with column-major storage, typecodes
'i'/'d'/'z', full indexing and number protocols; src/C/sparse.c — the
`spmatrix` CCS object; src/C/base.c — sparse()/spdiag(), elementwise math,
mixed dense/sparse gemv/gemm/syrk/axpy, norm).  Where the reference needs
~10k lines of C for speed, this build keeps the *host-side container*
semantics in numpy/scipy (column-major) and ships compute to the card:
every matrix converts to a tensor with `.to_torch()` (on
config.default_device unless a device is named), and all solver-facing
code paths accept these types via `__array__`.

Copy of kvxopt_tpu/base.py; only the device hooks differ.

Semantics notes (doc/source/matrices.rst of the reference):
- storage is column-major; single-index access is in column-major order;
- matrix(list) builds a column; matrix([[col1],[col2]]) builds from block
  columns; nested blocks concatenate vertically inside a column;
- 'i' < 'd' < 'z' typecode promotion, no implicit downcast;
- A[I] with I a list/matrix of indices gathers in column-major order;
- V of an spmatrix is assignable (same sparsity pattern).
"""

from __future__ import annotations

import numbers

import numpy as np
import scipy.sparse as _sp

_TC2DTYPE = {"i": np.int64, "d": np.float64, "z": np.complex128}


def _to_torch(a, device, dtype):
    import torch
    from . import config
    if device is None:
        device = config.default_device
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
_DTYPE2TC = {np.dtype(np.int64): "i", np.dtype(np.float64): "d",
             np.dtype(np.complex128): "z"}
_ORDER = {"i": 0, "d": 1, "z": 2}


def _promote(tc1, tc2):
    return tc1 if _ORDER[tc1] >= _ORDER[tc2] else tc2


def _tc_of_value(v):
    if isinstance(v, (bool, np.bool_)):
        return "i"
    if isinstance(v, (int, np.integer)):
        return "i"
    if isinstance(v, (float, np.floating)):
        return "d"
    if isinstance(v, (complex, np.complexfloating)):
        return "z"
    raise TypeError(f"unsupported scalar type {type(v)}")


def _canon_dtype(arr):
    if arr.dtype.kind in "bui":
        return arr.astype(np.int64)
    if arr.dtype.kind == "f":
        return arr.astype(np.float64)
    if arr.dtype.kind == "c":
        return arr.astype(np.complex128)
    raise TypeError(f"unsupported dtype {arr.dtype}")


class matrix:
    """Dense column-major matrix (reference dense.c matrix_tp)."""

    __array_priority__ = 10.0

    def __init__(self, value=0.0, size=None, tc=None):
        arr = self._build(value, size, tc)
        if tc is not None:
            want = _TC2DTYPE[tc]
            cur = _DTYPE2TC[arr.dtype]
            if _ORDER[tc] < _ORDER[cur]:
                raise TypeError(
                    f"cannot cast typecode '{cur}' to '{tc}'")
            arr = arr.astype(want)
        self._a = np.asfortranarray(arr)

    @staticmethod
    def _build(value, size, tc):
        if isinstance(value, matrix):
            arr = value._a.copy()
        elif isinstance(value, spmatrix):
            arr = value._csc.toarray()
        elif isinstance(value, np.ndarray):
            arr = _canon_dtype(np.array(value, copy=True))
            if arr.ndim == 0:
                arr = arr.reshape(1, 1)
            elif arr.ndim == 1:
                arr = arr.reshape(-1, 1)
            elif arr.ndim != 2:
                raise TypeError("expected a 2-d array")
        elif isinstance(value, numbers.Number):
            tcv = tc or _tc_of_value(value)
            if size is None:
                size = (1, 1)
            _check_size(size)
            arr = np.full(size, value, dtype=_TC2DTYPE[tcv], order="F")
            return arr
        elif isinstance(value, (list, tuple)):
            if len(value) == 0:
                arr = np.zeros((0, 1), dtype=_TC2DTYPE[tc or "i"])
            elif all(isinstance(v, (list, tuple)) for v in value):
                # block columns
                cols = [_block_column(v) for v in value]
                ncols = cols[0].shape[1] if cols else 0
                rows = cols[0].shape[0]
                for c in cols:
                    if c.shape[0] != rows:
                        raise TypeError("incompatible block dimensions")
                arr = np.concatenate(cols, axis=1) if cols else \
                    np.zeros((0, 0))
            elif any(isinstance(v, (matrix, spmatrix)) for v in value):
                arr = _block_column(value)
            else:
                vals = list(value)
                tcv = "i"
                for v in vals:
                    tcv = _promote(tcv, _tc_of_value(v))
                arr = np.array(vals, dtype=_TC2DTYPE[tcv]).reshape(-1, 1)
        elif hasattr(value, "read"):  # file-like: not supported here
            raise TypeError("file construction: use fromfile()")
        else:
            try:
                arr = _canon_dtype(np.array(value))
                if arr.ndim <= 1:
                    arr = arr.reshape(-1, 1)
            except Exception:
                raise TypeError(
                    f"invalid type {type(value)} for matrix()")
        if size is not None:
            _check_size(size)
            if arr.size != size[0] * size[1]:
                raise TypeError("size of data does not match dimensions")
            arr = arr.reshape(size, order="F")
        return arr

    # -- properties ------------------------------------------------------
    @property
    def size(self):
        return self._a.shape

    @property
    def typecode(self):
        return _DTYPE2TC[self._a.dtype]

    @property
    def T(self):
        return matrix(self._a.T.copy())

    @property
    def H(self):
        return matrix(self._a.T.conj().copy())

    def trans(self):
        return self.T

    def ctrans(self):
        return self.H

    @property
    def real(self):
        return matrix(np.real(self._a).copy())

    @property
    def imag(self):
        return matrix(np.imag(self._a).copy())

    # -- numpy / torch interop ------------------------------------------
    def __array__(self, dtype=None, copy=None):
        a = self._a
        return np.array(a, dtype=dtype) if dtype else np.array(a)

    def to_torch(self, device=None, dtype=None):
        """The matrix as a tensor on `device` (config.default_device, the
        card, unless one is named), of `dtype` (the matching torch dtype
        unless one is named)."""
        return _to_torch(self._a, device, dtype)

    # -- indexing --------------------------------------------------------
    def _flat(self):
        return self._a.reshape(-1, order="F")

    def __len__(self):
        return self._a.size

    def __getitem__(self, key):
        if isinstance(key, tuple):
            if len(key) != 2:
                raise TypeError("invalid index")
            ri = _resolve_index(key[0], self._a.shape[0])
            ci = _resolve_index(key[1], self._a.shape[1])
            if np.isscalar(ri) and np.isscalar(ci):
                return self._a[ri, ci].item()
            ri = np.atleast_1d(ri)
            ci = np.atleast_1d(ci)
            return matrix(self._a[np.ix_(ri, ci)])
        idx = _resolve_index(key, self._a.size)
        flat = self._flat()
        if np.isscalar(idx):
            return flat[idx].item()
        return matrix(np.asarray(flat[np.atleast_1d(idx)]).reshape(-1, 1))

    def __setitem__(self, key, value):
        val = _value_array(value)
        if isinstance(key, tuple):
            if len(key) != 2:
                raise TypeError("invalid index")
            ri = _resolve_index(key[0], self._a.shape[0])
            ci = _resolve_index(key[1], self._a.shape[1])
            if np.isscalar(ri) and np.isscalar(ci):
                self._a[ri, ci] = val
                return
            ri = np.atleast_1d(ri)
            ci = np.atleast_1d(ci)
            if val.ndim == 2:
                self._a[np.ix_(ri, ci)] = val
            else:
                self._a[np.ix_(ri, ci)] = np.asarray(val).reshape(
                    (len(ri), len(ci)), order="F")
            return
        idx = _resolve_index(key, self._a.size)
        flat = self._flat()
        if np.isscalar(idx):
            flat[idx] = val
        else:
            idx = np.atleast_1d(idx)
            v = np.asarray(val).reshape(-1, order="F")
            if v.size == 1:
                v = np.broadcast_to(v, idx.shape)
            flat[idx] = v
        self._a = flat.reshape(self._a.shape, order="F")

    def __iter__(self):
        return iter(self._flat().tolist())

    # -- arithmetic ------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, matrix):
            return other._a
        if isinstance(other, spmatrix):
            return other._csc.toarray()
        if isinstance(other, numbers.Number):
            return other
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return matrix(self._a + o)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return matrix(self._a - o)

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return matrix(o - self._a)

    def __mul__(self, other):
        if isinstance(other, numbers.Number):
            return matrix(self._a * other)
        if isinstance(other, (matrix, spmatrix)):
            o = other._a if isinstance(other, matrix) else \
                other._csc.toarray()
            if self._a.shape[1] != o.shape[0]:
                raise TypeError("incompatible dimensions")
            return matrix(self._a @ o)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, numbers.Number):
            return matrix(self._a * other)
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, numbers.Number):
            if self.typecode == "i" and isinstance(other, int):
                return matrix(self._a // other)
            return matrix(self._a / other)
        return NotImplemented

    def __mod__(self, other):
        if isinstance(other, numbers.Number):
            return matrix(self._a % other)
        return NotImplemented

    def __pow__(self, other):
        if isinstance(other, numbers.Number):
            a = self._a
            if a.dtype.kind == "i":
                a = a.astype(np.float64)
            if np.any(np.asarray(a) < 0) and not isinstance(
                    other, (int, np.integer)) and a.dtype.kind != "c":
                a = a.astype(np.complex128)
            return matrix(a ** other)
        return NotImplemented

    def __neg__(self):
        return matrix(-self._a)

    def __pos__(self):
        return matrix(self._a.copy())

    def __abs__(self):
        return matrix(np.abs(self._a))

    def __eq__(self, other):
        if isinstance(other, matrix):
            return (self._a.shape == other._a.shape and
                    bool(np.all(self._a == other._a)))
        return NotImplemented

    def __hash__(self):
        return id(self)

    # -- io / pickling ---------------------------------------------------
    def tofile(self, f):
        self._flat().tofile(f)

    def __reduce__(self):
        return (matrix, (bytes(self._flat().tobytes()), self.size,
                         self.typecode))

    def __str__(self):
        from . import printing
        return printing.matrix_str_default(self)

    def __repr__(self):
        return f"<{self.size[0]}x{self.size[1]} matrix, tc='" \
               f"{self.typecode}'>"


def _check_size(size):
    if (not isinstance(size, tuple) or len(size) != 2 or
            not all(isinstance(s, (int, np.integer)) for s in size) or
            size[0] < 0 or size[1] < 0):
        raise TypeError("size must be a tuple of non-negative integers")


def _block_column(blocks):
    """Vertical concatenation of a block-column list."""
    parts = []
    tcv = "i"
    for blk in blocks:
        if isinstance(blk, matrix):
            parts.append(blk._a)
        elif isinstance(blk, spmatrix):
            parts.append(blk._csc.toarray())
        elif isinstance(blk, numbers.Number):
            tcv = _promote(tcv, _tc_of_value(blk))
            parts.append(np.array([[blk]], dtype=_TC2DTYPE[
                _tc_of_value(blk)]))
        elif isinstance(blk, (list, tuple)):
            arr = matrix(list(blk))._a
            parts.append(arr)
        else:
            parts.append(matrix(blk)._a)
    ncols = max((p.shape[1] for p in parts), default=1)
    out = []
    for p in parts:
        if p.shape[1] == ncols:
            out.append(p)
        elif p.size == 1:
            out.append(np.full((1, ncols), p.item()))
        else:
            raise TypeError("incompatible block dimensions")
    dtype = np.result_type(*[p.dtype for p in out]) if out else np.int64
    return np.concatenate([p.astype(dtype) for p in out], axis=0)


def _resolve_index(key, n):
    if isinstance(key, (int, np.integer)):
        k = int(key)
        if k < 0:
            k += n
        if not 0 <= k < n:
            raise IndexError("index out of range")
        return k
    if isinstance(key, slice):
        return np.arange(*key.indices(n))
    if isinstance(key, matrix):
        key = key._flat()
    if isinstance(key, (list, tuple, np.ndarray)):
        idx = np.asarray(key, dtype=np.int64).reshape(-1)
        idx = np.where(idx < 0, idx + n, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError("index out of range")
        return idx
    raise TypeError(f"invalid index type {type(key)}")


def _value_array(value):
    if isinstance(value, matrix):
        return value._a
    if isinstance(value, spmatrix):
        return value._csc.toarray()
    if isinstance(value, numbers.Number):
        return value
    return np.asarray(value)


def fromfile(f, size, tc="d"):
    """Binary read counterpart of matrix.tofile (reference dense.c
    fromfile)."""
    arr = np.fromfile(f, dtype=_TC2DTYPE[tc], count=size[0] * size[1])
    return matrix(arr.reshape(size, order="F"))


# pickling entry: matrix(bytes, size, tc) reconstructs from the raw
# buffer (matrix.__reduce__ emits this form)
def _matrix_init_dispatch(self, value=0.0, size=None, tc=None):
    if isinstance(value, (bytes, bytearray)):
        arr = np.frombuffer(value, dtype=_TC2DTYPE[tc or "d"]).copy()
        self._a = np.asfortranarray(arr.reshape(size, order="F"))
        return
    _matrix_real_init(self, value, size, tc)


_matrix_real_init = matrix.__init__
matrix.__init__ = _matrix_init_dispatch


# ---------------------------------------------------------------------------
# spmatrix
# ---------------------------------------------------------------------------


class spmatrix:
    """Sparse CCS matrix (reference sparse.c spmatrix_tp).  Built from
    triplets with duplicate summation (sparse.c:2639-2700); V is
    assignable; indexing, arithmetic and products follow the reference."""

    __array_priority__ = 11.0

    def __init__(self, V, I, J, size=None, tc=None):
        Va = np.asarray(V._flat() if isinstance(V, matrix) else V)
        Ia = np.asarray(I._flat() if isinstance(I, matrix) else I,
                        dtype=np.int64).reshape(-1)
        Ja = np.asarray(J._flat() if isinstance(J, matrix) else J,
                        dtype=np.int64).reshape(-1)
        if Va.ndim == 0 or Va.size == 1:
            Va = np.broadcast_to(np.asarray(Va).reshape(-1), Ia.shape)
        Va = Va.reshape(-1)
        if not (len(Va) == len(Ia) == len(Ja)):
            raise TypeError("V, I, J must have the same length")
        if tc is None:
            if Va.dtype.kind == "c":
                tc = "z"
            else:
                tc = "d"
        dtype = _TC2DTYPE[tc]
        if tc == "i":
            raise TypeError("spmatrix typecode must be 'd' or 'z'")
        if size is None:
            size = (int(Ia.max()) + 1 if len(Ia) else 0,
                    int(Ja.max()) + 1 if len(Ja) else 0)
        _check_size(size)
        if len(Ia) and (Ia.min() < 0 or Ia.max() >= size[0] or
                        Ja.min() < 0 or Ja.max() >= size[1]):
            raise TypeError("index out of range")
        coo = _sp.coo_matrix((Va.astype(dtype), (Ia, Ja)), shape=size)
        csc = coo.tocsc()
        csc.sum_duplicates()
        csc.sort_indices()
        self._csc = csc

    @classmethod
    def _from_csc(cls, csc):
        obj = cls.__new__(cls)
        csc = csc.tocsc()
        csc.sum_duplicates()
        csc.sort_indices()
        if csc.dtype.kind not in "fc":
            csc = csc.astype(np.float64)
        elif csc.dtype != np.float64 and csc.dtype.kind == "f":
            csc = csc.astype(np.float64)
        elif csc.dtype.kind == "c" and csc.dtype != np.complex128:
            csc = csc.astype(np.complex128)
        obj._csc = csc
        return obj

    # -- properties ------------------------------------------------------
    @property
    def size(self):
        return self._csc.shape

    @property
    def typecode(self):
        return _DTYPE2TC[self._csc.dtype]

    @property
    def V(self):
        return matrix(self._csc.data.reshape(-1, 1).copy())

    @V.setter
    def V(self, value):
        v = np.asarray(_value_array(value)).reshape(-1)
        if v.size == 1:
            v = np.broadcast_to(v, self._csc.data.shape)
        if v.shape != self._csc.data.shape:
            raise TypeError("length of value does not match nnz")
        self._csc.data[:] = v.astype(self._csc.dtype)

    @property
    def I(self):  # noqa: E743
        coo = self._csc.tocoo()
        order = np.lexsort((coo.row, coo.col))
        return matrix(coo.row[order].astype(np.int64).reshape(-1, 1))

    @property
    def J(self):
        coo = self._csc.tocoo()
        order = np.lexsort((coo.row, coo.col))
        return matrix(coo.col[order].astype(np.int64).reshape(-1, 1))

    @property
    def CCS(self):
        return (matrix(self._csc.indptr.astype(np.int64).reshape(-1, 1)),
                matrix(self._csc.indices.astype(np.int64).reshape(-1, 1)),
                matrix(self._csc.data.reshape(-1, 1).copy()))

    @property
    def T(self):
        return spmatrix._from_csc(self._csc.T)

    @property
    def H(self):
        return spmatrix._from_csc(self._csc.conj().T)

    def trans(self):
        return self.T

    def ctrans(self):
        return self.H

    # -- interop ---------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        a = self._csc.toarray()
        return a.astype(dtype) if dtype else a

    def to_torch(self, device=None, dtype=None):
        """The matrix as a dense tensor (see matrix.to_torch)."""
        return _to_torch(self._csc.toarray(), device, dtype)

    def to_scipy(self):
        return self._csc.copy()

    def __len__(self):
        return int(self._csc.nnz)

    # -- indexing --------------------------------------------------------
    def __getitem__(self, key):
        dense = None
        if isinstance(key, tuple) and len(key) == 2:
            ri = _resolve_index(key[0], self.size[0])
            ci = _resolve_index(key[1], self.size[1])
            if np.isscalar(ri) and np.isscalar(ci):
                return self._csc[ri, ci]
            ri, ci = np.atleast_1d(ri), np.atleast_1d(ci)
            sub = self._csc[np.ix_(ri, ci)]
            return spmatrix._from_csc(sub)
        idx = _resolve_index(key, self.size[0] * self.size[1])
        m = self.size[0]
        if np.isscalar(idx):
            return self._csc[idx % m, idx // m]
        idx = np.atleast_1d(idx)
        rows, cols = idx % m, idx // m
        vals = np.asarray(self._csc[rows, cols]).reshape(-1)
        return spmatrix(vals, np.arange(len(idx)), np.zeros(len(idx)),
                        size=(len(idx), 1), tc=self.typecode)

    def __setitem__(self, key, value):
        lil = self._csc.tolil()
        val = _value_array(value)
        if isinstance(key, tuple) and len(key) == 2:
            ri = _resolve_index(key[0], self.size[0])
            ci = _resolve_index(key[1], self.size[1])
            if np.isscalar(ri) and np.isscalar(ci):
                lil[ri, ci] = val
            else:
                ri, ci = np.atleast_1d(ri), np.atleast_1d(ci)
                v = np.asarray(val)
                if v.ndim < 2 or v.shape != (len(ri), len(ci)):
                    v = np.broadcast_to(
                        np.asarray(val).reshape(-1, order="F").reshape(
                            -1)[0] if np.asarray(val).size == 1 else
                        np.asarray(val).reshape((len(ri), len(ci)),
                                                order="F"),
                        (len(ri), len(ci)))
                lil[np.ix_(ri, ci)] = v
        else:
            m = self.size[0]
            idx = np.atleast_1d(_resolve_index(
                key, self.size[0] * self.size[1]))
            v = np.asarray(val).reshape(-1)
            if v.size == 1:
                v = np.broadcast_to(v, idx.shape)
            lil[idx % m, idx // m] = v
        self._csc = lil.tocsc()
        self._csc.sort_indices()

    # -- fork extras: in-place pattern update (sparse.c:4760 ipset/ipadd)
    def ipset(self, values, I, J):
        """In-place assignment at existing pattern positions."""
        self._ip_update(values, I, J, add=False)

    def ipadd(self, values, I, J):
        """In-place addition at existing pattern positions."""
        self._ip_update(values, I, J, add=True)

    def _ip_update(self, values, I, J, add):
        v = np.asarray(_value_array(values)).reshape(-1)
        Ia = np.asarray(_value_array(I), dtype=np.int64).reshape(-1)
        Ja = np.asarray(_value_array(J), dtype=np.int64).reshape(-1)
        if v.size == 1:
            v = np.broadcast_to(v, Ia.shape)
        indptr, indices = self._csc.indptr, self._csc.indices
        for val, i, j in zip(v, Ia, Ja):
            lo, hi = indptr[j], indptr[j + 1]
            pos = lo + np.searchsorted(indices[lo:hi], i)
            if pos >= hi or indices[pos] != i:
                raise ValueError(
                    f"entry ({i},{j}) not in the sparsity pattern")
            if add:
                self._csc.data[pos] += val
            else:
                self._csc.data[pos] = val

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, spmatrix):
            return spmatrix._from_csc(self._csc + other._csc)
        if isinstance(other, matrix):
            return matrix(self._csc.toarray() + other._a)
        if isinstance(other, numbers.Number):
            return matrix(self._csc.toarray() + other)
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, spmatrix):
            return spmatrix._from_csc(self._csc - other._csc)
        if isinstance(other, matrix):
            return matrix(self._csc.toarray() - other._a)
        if isinstance(other, numbers.Number):
            return matrix(self._csc.toarray() - other)
        return NotImplemented

    def __rsub__(self, other):
        if isinstance(other, matrix):
            return matrix(other._a - self._csc.toarray())
        if isinstance(other, numbers.Number):
            return matrix(other - self._csc.toarray())
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, numbers.Number):
            return spmatrix._from_csc(self._csc * other)
        if isinstance(other, spmatrix):
            if self.size[1] != other.size[0]:
                raise TypeError("incompatible dimensions")
            return spmatrix._from_csc(self._csc @ other._csc)
        if isinstance(other, matrix):
            if self.size[1] != other.size[0]:
                raise TypeError("incompatible dimensions")
            return matrix(np.asarray(self._csc @ other._a))
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, numbers.Number):
            return spmatrix._from_csc(self._csc * other)
        if isinstance(other, matrix):
            if other.size[1] != self.size[0]:
                raise TypeError("incompatible dimensions")
            return matrix(np.asarray(other._a @ self._csc))
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, numbers.Number):
            return spmatrix._from_csc(self._csc / other)
        return NotImplemented

    def __neg__(self):
        return spmatrix._from_csc(-self._csc)

    def __pos__(self):
        return spmatrix._from_csc(self._csc.copy())

    def __abs__(self):
        return spmatrix._from_csc(abs(self._csc))

    def __reduce__(self):
        coo = self._csc.tocoo()
        return (spmatrix, (coo.data.copy(), coo.row.astype(np.int64),
                           coo.col.astype(np.int64), self.size,
                           self.typecode))

    def __str__(self):
        from . import printing
        return printing.spmatrix_str_default(self)

    def __repr__(self):
        return f"<{self.size[0]}x{self.size[1]} sparse matrix, " \
               f"tc='{self.typecode}', nnz={self._csc.nnz}>"


# ---------------------------------------------------------------------------
# base module functions: sparse(), spdiag(), elementwise math, norms, BLAS-ish
# (reference base.c:2083-2118 function table)
# ---------------------------------------------------------------------------


def sparse(value, tc=None):
    """Build an spmatrix from a matrix, spmatrix, or block layout
    [[col-blocks], [col-blocks], ...] (reference base.c sparse,
    :1091+)."""
    if isinstance(value, spmatrix):
        out = spmatrix._from_csc(value._csc.copy())
    elif isinstance(value, matrix):
        out = spmatrix._from_csc(_sp.csc_matrix(value._a))
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (list, tuple)) for v in value) and value:
            cols = []
            for colblocks in value:
                parts = []
                for blk in colblocks:
                    if isinstance(blk, spmatrix):
                        parts.append(blk._csc)
                    elif isinstance(blk, matrix):
                        parts.append(_sp.csc_matrix(blk._a))
                    elif isinstance(blk, numbers.Number):
                        parts.append(_sp.csc_matrix(
                            np.array([[blk]], dtype=float)))
                    else:
                        parts.append(_sp.csc_matrix(matrix(blk)._a))
                cols.append(_sp.vstack(parts) if len(parts) > 1
                            else parts[0])
            out = spmatrix._from_csc(_sp.hstack(cols).tocsc())
        else:
            out = spmatrix._from_csc(_sp.csc_matrix(matrix(value)._a))
    else:
        raise TypeError(f"invalid type {type(value)} for sparse()")
    if tc is not None:
        out._csc = out._csc.astype(_TC2DTYPE[tc])
    return out


def spdiag(diag):
    """Block-diagonal sparse matrix from a list of scalars / matrices /
    sparse matrices, or a vector (reference base.c spdiag)."""
    if isinstance(diag, (matrix, spmatrix)) and 1 in diag.size:
        vals = np.asarray(diag).reshape(-1)
        return spmatrix._from_csc(_sp.diags(vals).tocsc())
    blocks = []
    for blk in diag:
        if isinstance(blk, numbers.Number):
            blocks.append(_sp.csc_matrix(np.array([[blk]], dtype=float)))
        elif isinstance(blk, spmatrix):
            blocks.append(blk._csc)
        elif isinstance(blk, matrix):
            blocks.append(_sp.csc_matrix(blk._a))
        else:
            blocks.append(_sp.csc_matrix(matrix(blk)._a))
    return spmatrix._from_csc(_sp.block_diag(blocks).tocsc())


def _elementwise(fn, domain_complex=None):
    def apply(x):
        if isinstance(x, (matrix, spmatrix)):
            arr = np.asarray(x)
        else:
            arr = np.asarray(matrix(x))
        out = fn(arr)
        return matrix(out)
    return apply


def _maybe_complex(fn, cond):
    def wrapped(a):
        if a.dtype.kind != "c" and np.any(cond(a)):
            a = a.astype(np.complex128)
        return fn(a)
    return wrapped


exp = _elementwise(np.exp)
log = _elementwise(_maybe_complex(np.log, lambda a: a <= 0))
sqrt = _elementwise(_maybe_complex(np.sqrt, lambda a: a < 0))
sin = _elementwise(np.sin)
exp.__doc__ = "Elementwise exponential of a dense matrix (new matrix)."
log.__doc__ = ("Elementwise natural log of a dense matrix (new matrix); "
               "promotes to 'z' when any entry is <= 0.")
sqrt.__doc__ = ("Elementwise square root of a dense matrix (new matrix); "
                "promotes to 'z' when any entry is < 0.")
cos = _elementwise(np.cos)
tan = _elementwise(np.tan)
asin = _elementwise(_maybe_complex(np.arcsin, lambda a: abs(a) > 1))
acos = _elementwise(_maybe_complex(np.arccos, lambda a: abs(a) > 1))
atan = _elementwise(np.arctan)
sinh = _elementwise(np.sinh)
cosh = _elementwise(np.cosh)
tanh = _elementwise(np.tanh)


def conj(x):
    if isinstance(x, spmatrix):
        return spmatrix._from_csc(x._csc.conj())
    return matrix(np.conj(np.asarray(x)))


def _pairwise(op):
    def apply(x, y):
        sx = isinstance(x, spmatrix)
        sy = isinstance(y, spmatrix)
        ax = np.asarray(x) if not isinstance(x, numbers.Number) else x
        ay = np.asarray(y) if not isinstance(y, numbers.Number) else y
        out = op(ax, ay)
        if sx and sy and op in (np.multiply,):
            return sparse(matrix(out))
        return matrix(np.asarray(out))
    return apply


def emul(x, y):
    """Elementwise multiply (reference base.c emul)."""
    return _pairwise(np.multiply)(x, y)


def ediv(x, y):
    """Elementwise divide."""
    return _pairwise(np.divide)(x, y)


def emin(x, y=None):
    if y is None:
        return min(np.asarray(x).reshape(-1).tolist())
    return _pairwise(np.minimum)(x, y)


def emax(x, y=None):
    if y is None:
        return max(np.asarray(x).reshape(-1).tolist())
    return _pairwise(np.maximum)(x, y)


def norm(x, ord="2"):
    """Matrix/vector norms with the reference's ord codes
    {'M','1','I','F','2'} (reference base.c:389-470 norm)."""
    a = np.asarray(x)
    if ord in (2, "2"):
        return float(np.linalg.norm(a.reshape(-1)))
    if ord == "M":
        return float(np.max(np.abs(a))) if a.size else 0.0
    if ord in (1, "1"):
        return float(np.max(np.abs(a).sum(axis=0))) if a.size else 0.0
    if ord in ("I", "i", np.inf):
        return float(np.max(np.abs(a).sum(axis=1))) if a.size else 0.0
    if ord in ("F", "f"):
        return float(np.linalg.norm(a))
    raise ValueError(f"invalid norm {ord!r}")


# mixed dense/sparse BLAS-style helpers (reference base.c gemv/gemm/...)
def _as2d(x):
    return np.asarray(x)


def gemv(A, x, y, trans="N", alpha=1.0, beta=0.0):
    """y := alpha*op(A)*x + beta*y, in place on a dense matrix y."""
    Aa = _as2d(A)
    if trans == "T":
        Aa = Aa.T
    elif trans == "C":
        Aa = Aa.conj().T
    res = alpha * (Aa @ np.asarray(x).reshape(-1)) + \
        beta * np.asarray(y).reshape(-1)
    y[:] = matrix(res.reshape(-1, 1))
    return y


def gemm(A, B, C, transA="N", transB="N", alpha=1.0, beta=0.0):
    """C := alpha*op(A)*op(B) + beta*C in place."""
    Aa, Ba = _as2d(A), _as2d(B)
    if transA == "T":
        Aa = Aa.T
    elif transA == "C":
        Aa = Aa.conj().T
    if transB == "T":
        Ba = Ba.T
    elif transB == "C":
        Ba = Ba.conj().T
    res = alpha * (Aa @ Ba) + beta * np.asarray(C)
    C[:, :] = matrix(res)
    return C


def syrk(A, C, uplo="L", trans="N", alpha=1.0, beta=0.0):
    Aa = _as2d(A)
    res = alpha * (Aa @ Aa.T if trans == "N" else Aa.T @ Aa) + \
        beta * np.asarray(C)
    C[:, :] = matrix(res)
    return C


def symv(A, x, y, uplo="L", alpha=1.0, beta=0.0):
    Aa = _as2d(A)
    Af = np.tril(Aa) + np.tril(Aa, -1).T if uplo == "L" else \
        np.triu(Aa) + np.triu(Aa, 1).T
    res = alpha * (Af @ np.asarray(x).reshape(-1)) + \
        beta * np.asarray(y).reshape(-1)
    y[:] = matrix(res.reshape(-1, 1))
    return y


def axpy(x, y, alpha=1.0):
    """y := alpha*x + y in place."""
    if isinstance(y, matrix):
        y[:] = matrix((alpha * np.asarray(x) +
                       np.asarray(y)).reshape(-1, 1, order="F")
                      if np.asarray(y).ndim == 1 else
                      alpha * np.asarray(x) + np.asarray(y))
    else:
        raise TypeError("y must be a dense matrix")
    return y
