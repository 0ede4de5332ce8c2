"""Shared sparse-LU machinery for the umfpack and klu API modules.

Wraps the native left-looking LU (kvxopt_tpu_torch/native/host.cpp): symbolic
objects hold the fill-reducing column ordering; numeric objects own the
factor handle and support KLU-style value-only refactorization with
automatic fallback (reference klu.c:296-302)."""

import numpy as np

from . import canon_csc
from ..native import lib
from .. import amd as _amd

_TRANS = {"N": 0, "T": 1, "C": 2}


class SymbolicLU:
    """Column preordering + pattern signature (the reference's
    umfpack/klu `symbolic` capsule)."""

    def __init__(self, A):
        m, n, cp, ri, vx = canon_csc(A)
        if m != n:
            raise TypeError("matrix must be square")
        self.n = n
        self.is_complex = vx.dtype.kind == "c"
        self.q = _amd.order_array(A)
        self.pattern = (cp.tobytes(), ri.tobytes())


def row_scales(n, ri, vx, kind):
    """Per-row scale factors s (divide row i by s[i] before factoring):
    'sum' = sum of |values| per row (UMFPACK's default scaling),
    'max' = max |value| per row (KLU's default).  Empty rows get s = 1."""
    mag = np.abs(vx)
    s = np.zeros(n, dtype=np.float64)
    if kind == "sum":
        np.add.at(s, ri, mag)
    elif kind == "max":
        np.maximum.at(s, ri, mag)
    else:
        raise ValueError(kind)
    s[s == 0.0] = 1.0
    return s


class _NativeHandle:
    """Refcounted owner of a native LU factor pointer.  Refactorization
    mutates the donor's factor in place (the reference's klu_refactor
    semantics, klu.c:296-302), so the donor NumericLU and the new one
    share this wrapper; the native factor is freed when the last
    reference dies."""

    def __init__(self, ptr, sfx):
        self.ptr = ptr
        self.sfx = sfx

    def free(self):
        if self.ptr is not None:
            getattr(lib, f"lu_free_{self.sfx}")(self.ptr)
            self.ptr = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


class NumericLU:
    """Owns the native LU handle (the reference's `numeric` capsule).

    With `row_scale` set ('sum'/'max'), the factorization is of the
    row-scaled matrix diag(1/s)*A — mirroring UMFPACK/KLU row scaling —
    and solves/determinants account for s transparently."""

    def __init__(self, A, Fs: SymbolicLU, refactor_from=None,
                 row_scale=None):
        m, n, cp, ri, vx = canon_csc(A)
        if n != Fs.n:
            raise TypeError("A does not match the symbolic factorization")
        self.is_complex = vx.dtype.kind == "c"
        sfx = "z" if self.is_complex else "d"
        self._sfx = sfx
        self.n = n
        self.pattern = (cp.tobytes(), ri.tobytes())
        self.s = None
        self._orig_csc = None
        if row_scale is not None:
            self.s = row_scales(n, ri, vx, row_scale)
            # keep the unscaled matrix for iterative refinement of solves
            # (UMFPACK's default behavior, UMFPACK_IRSTEP = 2)
            self._orig_csc = (cp.copy(), ri.copy(), vx.copy())
            vx = vx / self.s[ri]
        self._h = None
        if refactor_from is not None and \
                refactor_from._sfx == sfx and refactor_from.n == n and \
                refactor_from._h is not None and \
                refactor_from._h.ptr is not None and \
                refactor_from.pattern == self.pattern:
            # fast path: reuse pattern + pivot order, recompute values.
            # The donor's factor is updated IN PLACE (klu_refactor
            # semantics): afterwards both objects view the new values.
            status = getattr(lib, f"lu_refactor_{sfx}")(
                refactor_from._h.ptr, n, cp, ri, vx)
            if status == 0:
                self._h = refactor_from._h
                refactor_from.s = self.s
                refactor_from._orig_csc = self._orig_csc
                return
            # fallback to full factorization (the KLU contract)
        import ctypes
        st = ctypes.c_longlong(0)
        ptr = getattr(lib, f"lu_factor_{sfx}")(
            n, cp, ri, vx, Fs.q, ctypes.byref(st), 0.001)
        self._h = _NativeHandle(ptr, sfx)
        if st.value != 0 or getattr(lib, f"lu_singular_{sfx}")(
                self._h.ptr):
            self.free()
            raise ArithmeticError("singular matrix")

    @property
    def _handle(self):
        if self._h is None or self._h.ptr is None:
            raise ValueError("numeric factorization has been freed")
        return self._h.ptr

    def free(self):
        """Release this object's reference to the native factor (freed
        when the last sharer is gone)."""
        if self._h is not None:
            h, self._h = self._h, None
            del h

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass

    def _solve_once(self, work, trans):
        """work: (nrhs, n) contiguous; solved in place via the (possibly
        row-scaled) factors."""
        sfx = self._sfx
        if self.s is not None and trans == "N":
            work /= self.s          # A x = b  ->  (D A) x = D b
        getattr(lib, f"lu_solve_{sfx}")(self._handle, work,
                                        work.shape[0], _TRANS[trans])
        if self.s is not None and trans != "N":
            work /= self.s          # A^T x = b -> x = D z, (DA)^T z = b
        return work

    def solve_inplace(self, barr, trans="N"):
        """barr: (n, nrhs) numpy array (any order); solved in place.
        With row scaling active, two steps of iterative refinement
        against the original matrix restore full accuracy (the scaled
        factors' backward error is relative to D*A, not A)."""
        sfx = self._sfx
        dtype = np.complex128 if sfx == "z" else np.float64
        b = np.ascontiguousarray(barr.T, dtype=dtype)     # (nrhs, n)
        work = self._solve_once(b.copy(), trans)
        if self.s is not None:
            import scipy.sparse as sp
            cp, ri, vx = self._orig_csc
            A = sp.csc_matrix((vx, ri, cp), shape=(self.n, self.n))
            Aop = {"N": A, "T": A.T, "C": A.conj().T}[trans]
            for _ in range(2):
                resid = b - (Aop @ work.T).T
                work += self._solve_once(np.ascontiguousarray(resid),
                                         trans)
        return work.T

    def logdet(self):
        """(logmag, phase) with det = phase * exp(logmag); computed in
        log space so intermediate products cannot under/overflow."""
        import ctypes
        sfx = self._sfx
        lm = ctypes.c_double(0.0)
        ph = np.zeros(1, dtype=np.complex128 if sfx == "z"
                      else np.float64)
        getattr(lib, f"lu_logdet_{sfx}")(self._handle, ctypes.byref(lm),
                                         ph)
        logmag = lm.value
        if self.s is not None:
            logmag += np.sum(np.log(self.s))  # undo the row scaling
        return logmag, ph[0].item()

    def det(self):
        logmag, phase = self.logdet()
        with np.errstate(over="ignore"):  # det beyond f64 range -> inf
            return phase * np.exp(logmag)

    def get_factors(self):
        """Returns (L, U, p, q) scipy CSC factors with P A Q = L U, where
        P selects rows p (row k of PAQ is row p[k] of A) and Q selects
        columns q."""
        import ctypes
        import scipy.sparse as sp
        sfx = self._sfx
        dtype = np.complex128 if sfx == "z" else np.float64
        ln, un = ctypes.c_longlong(0), ctypes.c_longlong(0)
        getattr(lib, f"lu_sizes_{sfx}")(self._handle, ctypes.byref(ln),
                                        ctypes.byref(un))
        n = self.n
        Lp = np.zeros(n + 1, np.int64); Li = np.zeros(ln.value, np.int64)
        Lx = np.zeros(ln.value, dtype)
        Up = np.zeros(n + 1, np.int64); Ui = np.zeros(un.value, np.int64)
        Ux = np.zeros(un.value, dtype)
        p = np.zeros(n, np.int64); q = np.zeros(n, np.int64)
        getattr(lib, f"lu_get_{sfx}")(self._handle, Lp, Li, Lx, Up, Ui,
                                      Ux, p, q)
        L = sp.csc_matrix((Lx, Li, Lp), shape=(n, n))
        U = sp.csc_matrix((Ux, Ui, Up), shape=(n, n))
        return L, U, p, q
