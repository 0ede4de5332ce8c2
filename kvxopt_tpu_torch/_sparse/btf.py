"""Block-triangular-form (BTF) sparse LU — the full KLU pipeline
(reference src/C/klu.c): maximum transversal + strongly-connected
components put A into block *upper* triangular form, each diagonal block
factors independently with the native left-looking LU, off-diagonal
entries go to F, and solves proceed by block back-substitution.

Identity (klu.c:382 get_numeric):  R * P * A * Q = L * U + F
with R = diag(1/s[p]) the row scaling (s = per-row max-abs of A, KLU's
default scale mode), L/U block-diagonal, r the block boundaries.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from . import canon_csc
from .lu import SymbolicLU, NumericLU, row_scales


def btf_analyze(A):
    """Returns (prow, qcol, r): row/col permutations putting A[prow][:,qcol]
    into block upper triangular form, and block boundaries r."""
    m, n, cp, ri, vx = canon_csc(A)
    if m != n:
        raise TypeError("matrix must be square")
    csc = sp.csc_matrix((np.ones(len(ri)), ri, cp), shape=(n, n))
    # maximum transversal: column j matched to row match[j]
    match = csgraph.maximum_bipartite_matching(csc.tocsr(),
                                               perm_type="column")
    if (match < 0).any():
        raise ArithmeticError("structurally singular matrix")
    # permute columns so the diagonal is the matching: B = A[:, match]
    B = csc[:, match]
    # strongly connected components of the digraph of B
    ncomp, labels = csgraph.connected_components(B, directed=True,
                                                 connection="strong")
    # scipy labels SCCs in reverse topological order for 'strong'; order
    # components so the permuted matrix is block UPPER triangular.
    # Determine a topological order of components via condensation edges.
    rows, cols = B.nonzero()
    lr, lc = labels[rows], labels[cols]
    # For block upper triangular P A Q we need, for every nonzero (i, j),
    # pos(comp(i)) <= pos(comp(j)): topologically order the condensation
    # with edges comp(row) -> comp(col).
    from collections import defaultdict, deque
    edges = defaultdict(set)
    for rr, cc in zip(lr, lc):
        if rr != cc:
            edges[rr].add(cc)
    indeg = np.zeros(ncomp, dtype=np.int64)
    for a in edges:
        for b in edges[a]:
            indeg[b] += 1
    dq = deque([c for c in range(ncomp) if indeg[c] == 0])
    topo = []
    while dq:
        c = dq.popleft()
        topo.append(c)
        for b in edges[c]:
            indeg[b] -= 1
            if indeg[b] == 0:
                dq.append(b)
    assert len(topo) == ncomp
    pos = np.zeros(ncomp, dtype=np.int64)
    for i, c in enumerate(topo):
        pos[c] = i
    # rows/cols sorted by component position (stable)
    row_order = np.argsort(pos[labels], kind="stable")
    col_order = row_order.copy()
    prow = row_order                      # B[prow][:, col_order]
    qcol = match[col_order]               # columns of original A
    # block boundaries
    sizes = np.bincount(pos[labels], minlength=ncomp)
    r = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return prow.astype(np.int64), qcol.astype(np.int64), r


class BTFSymbolic:
    """BTF permutations + per-block symbolic analyses."""

    def __init__(self, A):
        m, n, cp, ri, vx = canon_csc(A)
        self.n = n
        self.is_complex = vx.dtype.kind == "c"
        self.prow, self.qcol, self.r = btf_analyze(A)
        csc = sp.csc_matrix((vx, ri, cp), shape=(n, n))
        M = csc[self.prow, :][:, self.qcol].tocsc()
        self.block_syms = []
        for k in range(len(self.r) - 1):
            lo, hi = self.r[k], self.r[k + 1]
            blk = M[lo:hi, lo:hi]
            self.block_syms.append(SymbolicLU(blk))


class BTFNumeric:
    """Per-block numeric factors + the off-diagonal F."""

    def __init__(self, A, Fs: BTFSymbolic, refactor_from=None):
        m, n, cp, ri, vx = canon_csc(A)
        if n != Fs.n:
            raise TypeError("A does not match the symbolic object")
        # KLU-style row scaling: divide row i of A by s[i] = max_j |a_ij|
        # before the block factorizations (klu defaults, Common->scale=2)
        self.s = row_scales(n, ri, vx, "max")
        self._orig = sp.csc_matrix((vx, ri, cp), shape=(n, n))
        csc = sp.csc_matrix((vx / self.s[ri], ri, cp), shape=(n, n))
        M = csc[Fs.prow, :][:, Fs.qcol].tocsc()
        self.n = n
        self.r = Fs.r
        self.sym = Fs
        self.is_complex = vx.dtype.kind == "c"
        self.blocks = []
        K = len(Fs.r) - 1
        for k in range(K):
            lo, hi = Fs.r[k], Fs.r[k + 1]
            blk = M[lo:hi, lo:hi]
            prior = None
            if refactor_from is not None and \
                    len(getattr(refactor_from, "blocks", [])) == K:
                prior = refactor_from.blocks[k]
            self.blocks.append(NumericLU(blk, Fs.block_syms[k],
                                         refactor_from=prior))
        # strict upper off-diagonal blocks: keep entries whose row and
        # column fall in different BTF blocks (vectorized COO mask; the
        # per-block LIL zeroing this replaces was O(n^2) per block)
        coo = M.tocoo()
        rvec = np.asarray(Fs.r)
        blk_of_row = np.searchsorted(rvec, coo.row, side="right") - 1
        blk_of_col = np.searchsorted(rvec, coo.col, side="right") - 1
        keep = blk_of_row != blk_of_col
        self.F = sp.csc_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])),
            shape=(n, n))
        if refactor_from is not None:
            # refactorization updates the donor in place (the reference's
            # klu_refactor contract): the prior numeric object remains
            # usable and views the NEW values, exactly like a reused
            # KLU numeric capsule
            refactor_from.blocks = self.blocks
            refactor_from.F = self.F
            refactor_from.s = self.s
            refactor_from._orig = self._orig
            refactor_from.is_complex = self.is_complex

    def solve_inplace(self, barr, trans="N"):
        """Solve A X = B (or trans) with two steps of iterative
        refinement against the original matrix (the scaled factors'
        backward error is relative to R*A, not A)."""
        b = np.array(barr, dtype=np.complex128 if self.is_complex
                     else np.float64)
        if b.ndim == 1:
            b = b.reshape(-1, 1)
        Aop = {"N": self._orig, "T": self._orig.T,
               "C": self._orig.conj().T}[trans]
        x = self._solve_once(b, trans)
        for _ in range(2):
            x += self._solve_once(b - Aop @ x, trans)
        return x

    def _solve_once(self, barr, trans="N"):
        """One pass through the block factors: A = P' M Q' with M =
        blkdiag + F upper block triangular."""
        n = self.n
        r, prow, qcol = self.r, self.sym.prow, self.sym.qcol
        K = len(r) - 1
        out = np.array(barr, dtype=np.complex128 if self.is_complex
                       else np.float64)
        if out.ndim == 1:
            out = out.reshape(-1, 1)
        nrhs = out.shape[1]
        s_perm = self.s[prow].reshape(-1, 1)
        if trans == "N":
            w = out[prow, :] / s_perm   # R P b  (factors are of R P A Q)
            y = np.zeros_like(w)
            for k in range(K - 1, -1, -1):
                lo, hi = r[k], r[k + 1]
                rhs = w[lo:hi, :] - self.F[lo:hi, :] @ y
                y[lo:hi, :] = self.blocks[k].solve_inplace(rhs, "N")
            x = np.zeros_like(y)
            x[qcol, :] = y              # x = Q y
            return x
        # A' x = b  (or A^H):  M' (P x) = Q' b, M' lower block triangular
        conj = (trans == "C")
        w = out[qcol, :]            # Q' b
        y = np.zeros_like(w)
        Ft = self.F.conj().T if conj else self.F.T
        for k in range(K):
            lo, hi = r[k], r[k + 1]
            rhs = w[lo:hi, :] - Ft[lo:hi, :] @ y
            y[lo:hi, :] = self.blocks[k].solve_inplace(rhs, trans)
        x = np.zeros_like(y)
        x[prow, :] = y / s_perm         # x = P' R y  (R = diag(1/s[p]))
        return x

    def det(self):
        # accumulate in log magnitude + phase: plain products across
        # blocks and scale factors overflow long before det(A) does
        phase = 1.0 + 0.0j if self.is_complex else 1.0
        logmag = 0.0
        for blk in self.blocks:
            blm, bph = blk.logdet()
            logmag += blm
            phase *= bph
        if phase == 0:
            return phase
        logmag += np.sum(np.log(self.s))  # det(R^-1) undoes row scaling
        with np.errstate(over="ignore"):  # det beyond f64 range -> inf
            d = phase * np.exp(logmag)
        # permutation signs of prow and qcol
        def perm_sign(p):
            p = np.asarray(p)
            seen = np.zeros(len(p), bool)
            sign = 1
            for i in range(len(p)):
                if seen[i]:
                    continue
                j, ln = i, 0
                while not seen[j]:
                    seen[j] = True
                    j = p[j]
                    ln += 1
                if ln % 2 == 0:
                    sign = -sign
            return sign
        return d * perm_sign(self.sym.prow) * perm_sign(self.sym.qcol)

    def get_factors(self):
        """(L, U, p, q, F, r): block-diagonal L/U with the per-block row
        and column permutations folded into the global p/q so that
        A[p][:, q] = L U + F_perm."""
        n = self.n
        r = self.r
        K = len(r) - 1
        Ls, Us = [], []
        prow_local = np.zeros(n, dtype=np.int64)
        qcol_local = np.zeros(n, dtype=np.int64)
        for k in range(K):
            lo = r[k]
            L, U, pk, qk = self.blocks[k].get_factors()
            Ls.append(L)
            Us.append(U)
            prow_local[lo:lo + len(pk)] = lo + pk
            qcol_local[lo:lo + len(qk)] = lo + qk
        Lb = sp.block_diag(Ls).tocsc()
        Ub = sp.block_diag(Us).tocsc()
        p = self.sym.prow[prow_local]
        q = self.sym.qcol[qcol_local]
        Fp = self.F[prow_local, :][:, qcol_local].tocsc()
        return Lb, Ub, p, q, Fp, np.asarray(self.r)
