"""Tile-sparse (supernodal-style) Cholesky with the numeric factorization
on the device.

Counterpart of kvxopt_tpu/ops/tile_chol.py, which is XLA code with no
Pallas kernel: the numeric phase here is dense tile operations in torch
(torch.matmul, index_add_, torch.linalg.cholesky_ex and
solve_triangular) on the card, in float64 or complex128.

The symbolic analysis is the JAX package's host code: the block fill
rule over a fixed tile pattern and the per-column schedules.  The lower
triangular nonzero TILES of L live in one (..., NT, ts, ts) tensor, the
leading dimensions a batch of matrices with the same pattern.  Tiles are
stored column by column, so column j's tiles (its diagonal tile, then
its subdiagonal tiles in row order) are one contiguous range of slots.
Per block column j, `factor` does

  1. X[ij] -= X[ik] X[jk]^H for every k < j with L[jk] != 0 (one batched
     product of the gathered tiles, accumulated with index_add_),
  2. one dense Cholesky of the diagonal tile,
  3. X[ij] := X[ij] L_jj^{-H} for the column's subdiagonal tiles.

The JAX package pads the schedules to fixed shapes for lax.scan; a
Python loop over the T block columns needs no padding, so each column's
index lists go to the device once, unpadded.  Nothing in the loop waits
for the device: the Cholesky infos are read once, after it.
"""

from __future__ import annotations

import numpy as np
import torch


class TileCholesky:
    """Host symbolic analysis over a fixed tile pattern."""

    def __init__(self, pattern, n, ts=128):
        """pattern: iterable of (i, j) tile coordinates (i >= j) with a
        nonzero tile in the LOWER triangle of A (diagonal tiles required);
        n: matrix order; ts: tile size."""
        self.n = n
        self.ts = ts
        self.T = -(-n // ts)
        T = self.T
        S = set()
        for i, j in pattern:
            if i < j:
                i, j = j, i
            S.add((int(i), int(j)))
        for d in range(T):
            S.add((d, d))
        # block fill: L[i,j] exists if A[i,j] or exists k<j with L[i,k]
        # and L[j,k] (block right-looking fill rule)
        changed = True
        while changed:
            changed = False
            by_col = {}
            for (i, j) in S:
                by_col.setdefault(j, []).append(i)
            for k in sorted(by_col):
                rows = sorted(r for r in by_col[k] if r > k)
                for a in range(len(rows)):
                    for b in range(a, len(rows)):
                        ii, jj = rows[b], rows[a]
                        if (ii, jj) not in S:
                            S.add((ii, jj))
                            changed = True
        self.tiles = sorted(S, key=lambda t: (t[1], t[0]))  # col-major
        self.slot = {t: k for k, t in enumerate(self.tiles)}
        self.NT = len(self.tiles)

        # per-column schedules
        self.col_rows = []       # subdiagonal row tiles of column j
        self.col_slots = []      # their slots
        self.upd = []            # per column: (dst, a, b) update triples
        for j in range(T):
            rows = sorted(i for (i, jj) in S if jj == j and i > j)
            self.col_rows.append(rows)
            self.col_slots.append([self.slot[(i, j)] for i in rows])
            triples = []
            for k in range(j):
                if (j, k) not in S:
                    continue
                rows_k = [i for (i, kk) in S if kk == k and i >= j]
                for i in rows_k:
                    if (i, j) in S:
                        triples.append((self.slot[(i, j)],
                                        self.slot[(i, k)],
                                        self.slot[(j, k)]))
            self.upd.append(triples)
        self.diag_slots = [self.slot[(j, j)] for j in range(T)]
        self._dev = {}

    def _index(self, device):
        """Per column (dst - diag slot, a, b, rows) as index tensors on
        `device`, made once per device; dst is relative to the column's
        first slot."""
        key = str(device)
        if key not in self._dev:
            def t(v):
                return torch.tensor(v, dtype=torch.long, device=device)
            cols = []
            for j in range(self.T):
                d0 = self.diag_slots[j]
                u = self.upd[j]
                cols.append((t([x[0] - d0 for x in u]), t([x[1] for x in u]),
                             t([x[2] for x in u]), t(self.col_rows[j])))
            tiles = np.array(self.tiles, dtype=np.int64).reshape(-1, 2)
            self._dev[key] = (cols, t(tiles[:, 0]), t(tiles[:, 1]),
                              t(self.diag_slots))
        return self._dev[key]

    # -- conversions -----------------------------------------------------

    def tiles_from_dense(self, A):
        """(..., n, n) Hermitian tensor -> (..., NT, ts, ts) tiles, gathered
        on A's device; the pad rows get a unit diagonal."""
        ts, T, n = self.ts, self.T, self.n
        npad = T * ts
        _, I, J, _ = self._index(A.device)
        Ap = A.new_zeros((*A.shape[:-2], npad, npad))
        Ap[..., :n, :n] = A
        idx = torch.arange(n, npad, device=A.device)
        Ap[..., idx, idx] = 1.0
        Ap = Ap.reshape(*A.shape[:-2], T, ts, T, ts).transpose(-3, -2)
        return Ap[..., I, J, :, :]

    def tiles_from_csc(self, low):
        """Host conversion of a (lower-triangular) scipy CSC matrix into
        the numpy tile array: the entries on or below the diagonal that lie
        in a tile of the pattern, the diagonal tiles mirrored (Hermitian
        for complex dtypes), unit diagonal on the pad rows so that the
        factorization of the padded matrix is well-posed."""
        import scipy.sparse as sp
        ts, T, n = self.ts, self.T, self.n
        dtype = (np.complex128 if np.iscomplexobj(low.data)
                 else np.float64)
        X = np.zeros((self.NT, ts, ts), dtype=dtype)
        coo = sp.coo_matrix(low)
        r, c, v = coo.row, coo.col, coo.data
        keep = r >= c
        r, c, v = r[keep], c[keep], v[keep]
        lookup = np.full(T * T, -1, dtype=np.int64)
        tiles = np.array(self.tiles, dtype=np.int64).reshape(-1, 2)
        lookup[tiles[:, 0] * T + tiles[:, 1]] = np.arange(self.NT)
        k = lookup[(r // ts) * T + c // ts]
        inside = k >= 0
        np.add.at(X, (k[inside], r[inside] % ts, c[inside] % ts), v[inside])
        D = X[self.diag_slots]
        X[self.diag_slots] = (np.tril(D) + np.tril(D, -1).conj()
                              .transpose(0, 2, 1))
        for d in range(n - (T - 1) * ts, ts):
            X[self.diag_slots[-1], d, d] = 1.0
        return X

    def dense_from_tiles(self, X):
        """(..., NT, ts, ts) tiles -> (..., n, n), zero outside them."""
        ts, T, n = self.ts, self.T, self.n
        _, I, J, _ = self._index(X.device)
        out = X.new_zeros((*X.shape[:-3], T, T, ts, ts))
        out[..., I, J, :, :] = X
        out = out.transpose(-3, -2).reshape(*X.shape[:-3], T * ts, T * ts)
        return out[..., :n, :n]

    def diagonal(self, X):
        """diag(L) of factored tiles, (..., n) on X's device: the diagonal
        tiles' diagonals alone (real for a Hermitian factor)."""
        _, _, _, dslots = self._index(X.device)
        d = X[..., dslots, :, :].diagonal(dim1=-2, dim2=-1).real
        return d.reshape(*X.shape[:-3], -1)[..., :self.n]

    # -- numeric factorization -------------------------------------------

    def factor_ex(self, X):
        """Numeric tile Cholesky: X (..., NT, ts, ts) tiles of the lower
        triangle of A -> (tiles of L, info (..., T)), diagonal tiles
        lower-triangular; info is cholesky_ex's per diagonal tile (0 where
        it is positive definite).  X is not modified and nothing waits for
        the device."""
        cols, _, _, _ = self._index(X.device)
        X = X.clone()
        infos = []
        for j in range(self.T):
            dst, a, b, _ = cols[j]
            d0 = self.diag_slots[j]
            col = X[..., d0:d0 + 1 + len(self.col_rows[j]), :, :]
            if self.upd[j]:
                # X[ij] -= L[ik] L[jk]^H (conj is a no-op for real dtypes)
                upd = X[..., a, :, :] @ X[..., b, :, :].mH
                col.index_add_(col.ndim - 3, dst, upd, alpha=-1)
            Ljj, info = torch.linalg.cholesky_ex(col[..., 0, :, :])
            col[..., 0, :, :] = Ljj
            infos.append(info)
            if self.col_rows[j]:
                # X[ij] := X[ij] L_jj^{-H}: solve Y L_jj^H = X[ij]
                col[..., 1:, :, :] = torch.linalg.solve_triangular(
                    Ljj.mH.unsqueeze(-3), col[..., 1:, :, :], upper=True,
                    left=False)
        return X, torch.stack(infos, -1)

    def factor(self, X):
        """factor_ex, raising ArithmeticError where a diagonal tile is not
        positive definite (one read of the infos, after the loop)."""
        L, info = self.factor_ex(X)
        if bool((info != 0).any()):
            raise ArithmeticError("matrix is not positive definite")
        return L

    # -- solves ------------------------------------------------------------

    def _rhs(self, X, b):
        """b (..., n) or (..., n, k), ... X's batch dimensions -> the
        padded (..., T, ts, k) block vector and whether b was a vector."""
        vec = b.ndim == X.ndim - 2
        bb = b[..., None] if vec else b
        ts, T, n = self.ts, self.T, self.n
        y = bb.new_zeros((*bb.shape[:-2], T * ts, bb.shape[-1]))
        y[..., :n, :] = bb
        return y.reshape(*bb.shape[:-2], T, ts, bb.shape[-1]), vec

    def _out(self, y, vec):
        out = y.reshape(*y.shape[:-3], -1, y.shape[-1])[..., :self.n, :]
        return out[..., 0] if vec else out

    def _column(self, X, j):
        d0 = self.diag_slots[j]
        return X[..., d0, :, :], X[..., d0 + 1:d0 + 1 + len(
            self.col_rows[j]), :, :]

    def solve_l(self, X, b):
        """Forward block substitution: L y = b, with b (..., n) or
        (..., n, k)."""
        cols, _, _, _ = self._index(X.device)
        y, vec = self._rhs(X, b.to(X.dtype))
        for j in range(self.T):
            Ljj, sub = self._column(X, j)
            yj = torch.linalg.solve_triangular(Ljj, y[..., j, :, :],
                                               upper=False)
            y[..., j, :, :] = yj
            if self.col_rows[j]:
                y.index_add_(y.ndim - 3, cols[j][3], sub @ yj.unsqueeze(-3),
                             alpha=-1)
        return self._out(y, vec)

    def solve_lt(self, X, b):
        """Backward block substitution: L^H x = b (L' for real)."""
        cols, _, _, _ = self._index(X.device)
        y, vec = self._rhs(X, b.to(X.dtype))
        for j in reversed(range(self.T)):
            Ljj, sub = self._column(X, j)
            acc = y[..., j, :, :]
            if self.col_rows[j]:
                acc = acc - (sub.mH @ y[..., cols[j][3], :, :]).sum(-3)
            y[..., j, :, :] = torch.linalg.solve_triangular(
                Ljj.mH, acc, upper=True)
        return self._out(y, vec)

    def solve(self, X, b):
        """Solve A x = b given factored tiles X (block forward, then
        backward substitution)."""
        return self.solve_lt(X, self.solve_l(X, b))


def tile_pattern_from_sparse(A, ts=128):
    """Tile coordinates of the lower triangle of a scipy sparse matrix."""
    import scipy.sparse as sp
    coo = sp.tril(A.tocsc()).tocoo()
    tiles = set(zip((coo.row // ts).tolist(), (coo.col // ts).tolist()))
    return tiles
