"""Sparse Cholesky (reference src/C/cholmod.c): symbolic, numeric, solve,
spsolve, linsolve, splinsolve, diag, getfactor, options.

Factorizes P A P' = L D L' (simplicial, up-looking, native implementation
in kvxopt_tpu_torch/native/host.cpp) with a minimum-degree fill-reducing
permutation P.  Like the reference, the module-level `options` dict is
read at call time (cholmod.c:50-108): options['supernodal'] != 0 demands
positive definiteness (LL' semantics, ArithmeticError otherwise);
options['supernodal'] == 0 permits indefinite LDL'.

Supernodal device path (counterpart of kvxopt_tpu/cholmod.py's): with
options['supernodal'] != 0 and options['device'] truthy, numeric
factorization runs the tile-supernodal factorization of
ops/tile_chol.py on config.default_device.  options['device'] is "auto"
or True for the tile path there (the card; where there is none, numeric
raises, it never takes the host path instead; under
config.using_device("cpu") the tile path runs on the CPU), or False for
the host LDL'.  The tile
analysis happens once per symbolic object (keyed on the first device
factorization, as in the JAX package: a later numeric call with another
pattern reuses it), and repeated `numeric(A, F)` calls are value-only
refactorizations on the device.  The device path serves every sys code
0..8 of solve/spsolve (the split systems 1..6 are expressed in the host
LDL' convention from the tile LL' factor) plus linsolve, splinsolve,
diag and getfactor, for both 'd' and Hermitian 'z' matrices.

Repeated `numeric(A, F)` calls on the same symbolic object reuse the
factor pattern and only recompute values (free fast-refactorization, the
analogue of CHOLMOD's separate symbolic/numeric phases).

Supports 'd' (symmetric) and 'z' (Hermitian LDL^H with real D)
matrices on both paths.
"""

import ctypes

import numpy as np
import scipy.sparse as _sp
import torch

from . import config
from .base import matrix, spmatrix
from ._sparse import canon_csc
from .native import lib
from . import amd as _amd

options = {"supernodal": 2, "device": "auto", "tilesize": 128}


def _tile_device():
    """The torch device of the tile path, or None for the host LDL'."""
    if not options.get("device", "auto"):
        return None
    dev = torch.device(config.default_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for cholmod's tile path: set "
            "cholmod.options['device'] to False (host LDL') or run under "
            "config.using_device('cpu')")
    return dev


class CholSymbolic:
    """Permutation + (lazily created) native factor handle."""

    def __init__(self, A, p=None, uplo="L"):
        m, n, cp, ri, vx = canon_csc(A)
        if m != n:
            raise TypeError("matrix must be square")
        self.is_complex = vx.dtype.kind == "c"
        self._sfx = "_z" if self.is_complex else ""
        self.n = n
        self.uplo = uplo
        if p is not None:
            self.perm = np.asarray(p, dtype=np.int64).reshape(-1)
        else:
            self.perm = _amd.order_array(A, uplo=uplo)
        self._handle = None
        self._numeric = False

    def _permuted_lower(self, A):
        m, n, cp, ri, vx = canon_csc(A)
        csc = _sp.csc_matrix((vx, ri, cp), shape=(n, n))
        tri = _sp.tril(csc) if self.uplo == "L" else _sp.triu(csc)
        if self.is_complex:
            full = tri + tri.conj().T - _sp.diags(tri.diagonal())
            dtype = np.complex128
        else:
            full = tri + tri.T - _sp.diags(tri.diagonal())
            dtype = np.float64
        perm = self.perm
        sub = full[perm, :][:, perm]
        low = _sp.tril(sub).tocsc()
        low.sort_indices()
        return (low.indptr.astype(np.int64),
                low.indices.astype(np.int64),
                np.ascontiguousarray(low.data.astype(dtype)))

    def factorize(self, A):
        cp, ri, vx = self._permuted_lower(A)
        dev = (_tile_device() if options.get("supernodal", 2) != 0
               else None)
        if dev is not None:
            self._factorize_device(cp, ri, vx, dev)
            return
        self._device = False
        fac = getattr(lib, "ldl_factor" + self._sfx)
        refac = getattr(lib, "ldl_refactor" + self._sfx)
        # The native refactor reuses the symbolic structure of the FIRST
        # factorization; feeding it a different sparsity pattern (e.g.
        # explicit zeros pruned by scipy on an earlier call) would read
        # out of bounds.  Detect pattern changes and fall back to a full
        # factorization (the reference's CHOLMOD does the equivalent
        # symbolic consistency check).
        patt = getattr(self, "_patt", None)
        same = (patt is not None and len(patt[0]) == len(cp)
                and len(patt[1]) == len(ri)
                and np.array_equal(patt[0], cp)
                and np.array_equal(patt[1], ri))
        if self._handle is not None and not same:
            getattr(lib, "ldl_free" + self._sfx)(self._handle)
            self._handle = None
        if self._handle is None:
            st = ctypes.c_longlong(0)
            self._handle = fac(self.n, cp, ri, vx, ctypes.byref(st))
            status = st.value
            self._patt = (cp.copy(), ri.copy())
        else:
            status = refac(self._handle, self.n, cp, ri, vx)
        if status != 0:
            raise ArithmeticError("factorization failed (zero pivot)")
        if options.get("supernodal", 2) != 0:
            D = self.Dvals()
            if (D <= 0).any():
                raise ArithmeticError("matrix is not positive definite")
        self._numeric = True

    def _factorize_device(self, cp, ri, vx, dev):
        """Supernodal numeric factorization on `dev`: tile-pattern
        symbolic analysis once, then the tile factorization
        (ops/tile_chol.py); repeat calls are refactorizations on the
        device.  The infos and diag(L) come back in one small copy."""
        from .ops.tile_chol import TileCholesky, tile_pattern_from_sparse
        low = _sp.csc_matrix((vx, ri, cp), shape=(self.n, self.n))
        if getattr(self, "_tile", None) is None:
            ts = int(options.get("tilesize", 128))
            pattern = tile_pattern_from_sparse(low, ts)
            self._tile = TileCholesky(pattern, self.n, ts)
        X = torch.from_numpy(self._tile.tiles_from_csc(low)).to(dev)
        Xf, info = self._tile.factor_ex(X)
        Ld = self._tile.diagonal(Xf)
        host = torch.cat([info.to(Ld.dtype), Ld]).cpu().numpy()
        info, Ld = host[:self._tile.T], host[self._tile.T:]
        if (info != 0).any() or not bool(np.isfinite(Ld).all()) or bool(
                (Ld <= 0).any()):
            raise ArithmeticError("matrix is not positive definite")
        self._X, self._Ld, self._Ld_dev = Xf, Ld, torch.from_numpy(Ld).to(dev)
        self._device = True
        self._numeric = True

    def Dvals(self):
        if getattr(self, "_device", False):
            return self._Ld ** 2  # LL' -> D = diag(L)^2
        D = np.zeros(self.n, np.float64)
        getattr(lib, "ldl_diag" + self._sfx)(self._handle, D)
        return D

    def solve_permuted(self, barr, mode):
        if getattr(self, "_device", False):
            return self._solve_device(barr, {0: 1, 4: 2, 5: 3, 1: 4,
                                             3: 5, 2: 6}.get(mode, 1)
                                      if mode != 0 else 0)
        dtype = np.complex128 if self.is_complex else np.float64
        work = np.ascontiguousarray(barr.T, dtype=dtype)
        getattr(lib, "ldl_solve" + self._sfx)(self._handle, work,
                                              work.shape[0], mode)
        return work.T

    def _solve_device(self, barr, sys):
        """Device-tile solves for all split systems, in the host LDL'
        convention (unit L, D = diag(L)^2; the tile factor is LL' with
        L = L_unit sqrt(D)) — reference cholmod.c:401 sys codes."""
        t, X = self._tile, self._X
        dtype = np.complex128 if self.is_complex else np.float64
        arr = torch.from_numpy(np.ascontiguousarray(barr, dtype=dtype)).to(
            X.device)
        dh = self._Ld_dev[:, None]
        if sys in (0, 1):
            out = t.solve(X, arr)
        elif sys == 2:      # L_unit D x = b  ->  x = L^{-1} b / diag(L)
            out = t.solve_l(X, arr) / dh
        elif sys == 3:      # D L_unit' x = b -> x = L^{-H}(b / diag(L))
            out = t.solve_lt(X, arr / dh)
        elif sys == 4:      # L_unit x = b    -> x = diag(L) L^{-1} b
            out = t.solve_l(X, arr) * dh
        elif sys == 5:      # L_unit' x = b   -> x = L^{-H}(diag(L) b)
            out = t.solve_lt(X, arr * dh)
        elif sys == 6:      # D x = b
            out = arr / (dh * dh)
        else:
            raise ValueError("sys must be in 0..8")
        return out.cpu().numpy()

    def get_L(self):
        n = self.n
        if getattr(self, "_device", False):
            Ld = self._tile.dense_from_tiles(self._X).cpu().numpy()
            Lm = _sp.csc_matrix(np.tril(Ld))
            return Lm, np.ones(n)
        nnz = getattr(lib, "ldl_lnnz" + self._sfx)(self._handle)
        Lp = np.zeros(n + 1, np.int64)
        Li = np.zeros(nnz, np.int64)
        dtype = np.complex128 if self.is_complex else np.float64
        Lx = np.zeros(nnz, dtype)
        D = np.zeros(n, np.float64)
        getattr(lib, "ldl_get" + self._sfx)(self._handle, Lp, Li, Lx, D)
        Lm = _sp.csc_matrix((Lx, Li, Lp), shape=(n, n)) + _sp.eye(n)
        return Lm.tocsc(), D

    def __del__(self):
        try:
            if self._handle is not None:
                getattr(lib, "ldl_free" + self._sfx)(self._handle)
                self._handle = None
        except Exception:
            pass


def symbolic(A, p=None, uplo="L"):
    """Symbolic analysis (cholmod.c:218)."""
    return CholSymbolic(A, p=p, uplo=uplo)


def numeric(A, F):
    """Numeric factorization into a symbolic object (cholmod.c:294);
    repeated calls refactor in place."""
    F.factorize(A)


def _check_numeric(F):
    if not getattr(F, "_numeric", False):
        raise ValueError("factor is not numeric")


def solve(F, B, sys=0):
    """In-place solve with the factor; `sys` selects the system exactly as
    the reference (cholmod.c:401):
    0: Ax=b, 1: LDL'x=b, 2: LDx=b, 3: DL'x=b, 4: Lx=b, 5: L'x=b,
    6: Dx=b, 7: x=Pb, 8: x=P'b."""
    _check_numeric(F)
    if not isinstance(B, matrix):
        raise TypeError("B must be a dense matrix")
    dtype = np.complex128 if F.is_complex else np.float64
    arr = np.asarray(B, dtype=dtype)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    perm = F.perm
    if sys == 0:
        w = arr[perm, :]
        w = F.solve_permuted(w, 0)
        out = np.empty_like(arr)
        out[perm, :] = w
    elif sys in (1, 2, 3, 4, 5, 6):
        mode = {1: 0, 2: 4, 3: 5, 4: 1, 5: 3, 6: 2}[sys]
        out = F.solve_permuted(arr, mode)
    elif sys == 7:
        out = arr[perm, :]
    elif sys == 8:
        out = np.empty_like(arr)
        out[perm, :] = arr
    else:
        raise ValueError("sys must be in 0..8")
    B._a = np.asfortranarray(out.astype(B._a.dtype))


def spsolve(F, B, sys=0):
    """Sparse-RHS solve returning an spmatrix (cholmod.c:502)."""
    _check_numeric(F)
    dense = matrix(np.asarray(B, dtype=float))
    solve(F, dense, sys=sys)
    return spmatrix._from_csc(_sp.csc_matrix(np.asarray(dense)))


def linsolve(A, B, p=None, uplo="L"):
    """One-shot factor + in-place solve (cholmod.c:590)."""
    F = symbolic(A, p=p, uplo=uplo)
    numeric(A, F)
    solve(F, B, sys=0)


def splinsolve(A, B, p=None, uplo="L"):
    """One-shot with a sparse RHS, returning an spmatrix
    (cholmod.c:757)."""
    F = symbolic(A, p=p, uplo=uplo)
    numeric(A, F)
    return spsolve(F, B, sys=0)


def diag(F):
    """Diagonal of the Cholesky factor L of P A P' = L L'
    (cholmod.c:884)."""
    _check_numeric(F)
    D = F.Dvals()
    if (D < 0).any():
        raise ArithmeticError("matrix is not positive definite")
    return matrix(np.sqrt(D).reshape(-1, 1))


def getfactor(F):
    """The factor L with P A P' = L L' as an spmatrix (cholmod.c:1002)."""
    _check_numeric(F)
    L, D = F.get_L()
    if (D < 0).any():
        raise ArithmeticError("matrix is not positive definite")
    Lc = L @ _sp.diags(np.sqrt(D))
    return spmatrix._from_csc(Lc.tocsc())
