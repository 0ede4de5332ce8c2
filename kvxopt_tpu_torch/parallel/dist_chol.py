"""Block-cyclic distributed Cholesky over a mesh axis.

Counterpart of kvxopt_tpu/parallel/dist_chol.py.  For one SPD matrix too
large for one device, the n x n matrix is cut into nb-wide block
columns dealt cyclically over the ranks of a mesh axis: block column j
lives on rank j mod ndev (ScaLAPACK's layout, which keeps every rank
busy as the factorization front moves right).  The axis may be a tuple
(('dcn', 'ici')) of a hierarchical mesh; its collectives then run over
each mesh axis in turn (mesh.Axis).

Per factorization step k, one per block column:
  1. the owner broadcasts column k's rows from k nb down (one
     collective);
  2. every rank factors the nb x nb diagonal block (torch.linalg, as
     the JAX module's jnp.linalg.cholesky) and forms the panel
     L[k:, k] by a triangular solve (O(n nb^2), redundant);
  3. every rank applies the rank-nb trailing update to the block
     columns it owns (the O(n^2 nb) work, in parallel).
A triangular solve broadcasts, per block step, the owner's part of the
result: nb entries and the update of the rows below (forward), nb
entries (backward).

The stacks are the ranks' own: a rank holds its nloc = nblk / ndev block
columns, (nloc, n, nb), in the order of cyclic_pack's stack, whose slice
index * nloc : (index + 1) * nloc they are; gather_stack joins them.
"""

from __future__ import annotations

import torch

from .batch import _tensors
from .mesh import Axis


def _order(nblk, ndev):
    """Stack position -> global block column: rank d's columns d, d +
    ndev, ... at positions d * nloc, ..."""
    return torch.arange(nblk).reshape(nblk // ndev, ndev).T.reshape(-1)


def cyclic_pack(K, nb, ndev):
    """(n, n) SPD -> ((nblk, n, nb) block-column stack in cyclic order,
    nloc): global block j = l * ndev + d is stored at stack position
    d * nloc + l, so rank d's slice holds exactly the columns {d, d +
    ndev, ...}."""
    n = K.shape[0]
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    nblk = n // nb
    if nblk % ndev:
        raise ValueError(f"the {nblk} block columns must divide over "
                         f"{ndev} ranks")
    cols = K.reshape(n, nblk, nb).permute(1, 0, 2)
    return cols[_order(nblk, ndev).to(K.device)], nblk // ndev


def cyclic_unpack(Lst, nb, ndev):
    """Inverse of cyclic_pack: (nblk, n, nb) stack -> (n, n)."""
    nblk, n, _ = Lst.shape
    inv = torch.argsort(_order(nblk, ndev)).to(Lst.device)
    return Lst[inv].permute(1, 0, 2).reshape(n, n)


def gather_stack(mesh, axis, Lst):
    """The ranks' own stacks (nloc, n, nb) joined into cyclic_pack's whole
    (nblk, n, nb) stack, on every rank."""
    ax = Axis(mesh, axis)
    return ax.gather(Lst, Lst.shape[0] * ax.size)


def dist_chol_factory(mesh, axis, n: int, nb: int = 256):
    """Returns (factor, solve) over the ranks of `axis` of `mesh`.

    factor(Kl) -> Ll: Kl is this rank's (nloc, n, nb) part of
    cyclic_pack's stack of an SPD K; Ll the same part of L's stack, with
    L L' = K, L lower triangular (zero above the diagonal).

    solve(Ll, b) -> x with K x = b, for b (n,) or (n, k) the same on
    every rank; x is then the same on every rank."""
    ax = Axis(mesh, axis)
    ndev, me = ax.size, ax.index
    nblk = n // nb
    if nblk * nb != n or nblk % ndev:
        raise ValueError(f"n={n} must be a multiple of nb * ndev = "
                         f"{nb * ndev}")
    nloc = nblk // ndev
    owned = torch.arange(nloc) * ndev + me     # global block columns

    def factor(Kl):
        L = Kl.clone()
        for k in range(nblk):
            owner, lk, r0 = k % ndev, k // ndev, k * nb
            col = (L[lk, r0:].clone() if owner == me else
                   L.new_empty((n - r0, nb)))
            ax.broadcast(col, owner)
            Lkk = torch.linalg.cholesky(col[:nb])
            # the panel: col L_kk^{-T}, whose first nb rows are L_kk
            pan = torch.linalg.solve_triangular(Lkk.T, col, upper=True,
                                                left=False)
            pan[:nb] = Lkk
            if owner == me:
                L[lk, :r0] = 0.0
                L[lk, r0:] = pan
            later = torch.nonzero(owned > k).flatten()
            if later.numel():
                js = owned[later] - k
                pj = torch.stack([pan[j * nb:(j + 1) * nb]
                                  for j in js.tolist()])
                L[later, r0 + nb:] -= torch.einsum("ik,ljk->lij",
                                                   pan[nb:], pj)
        return L

    def solve(Ll, b):
        vec = b.ndim == 1
        y = (b[:, None] if vec else b).clone()
        k_ = y.shape[1]
        for k in range(nblk):                      # L y = b
            owner, lk, r0 = k % ndev, k // ndev, k * nb
            if owner == me:
                Lk = Ll[lk, r0:]
                yk = torch.linalg.solve_triangular(Lk[:nb], y[r0:r0 + nb],
                                                   upper=False)
                buf = torch.cat([yk, Lk[nb:] @ yk])
            else:
                buf = y.new_empty((n - r0, k_))
            ax.broadcast(buf, owner)
            y[r0:r0 + nb] = buf[:nb]
            y[r0 + nb:] -= buf[nb:]
        for k in reversed(range(nblk)):            # L' x = y
            owner, lk, r0 = k % ndev, k // ndev, k * nb
            if owner == me:
                Lk = Ll[lk, r0:]
                rhs = y[r0:r0 + nb] - Lk[nb:].T @ y[r0 + nb:]
                buf = torch.linalg.solve_triangular(Lk[:nb].T, rhs,
                                                    upper=True)
            else:
                buf = y.new_empty((nb, k_))
            ax.broadcast(buf, owner)
            y[r0:r0 + nb] = buf
        return y[:, 0] if vec else y

    return factor, solve


def dist_cholesky(mesh, axis, K, nb: int = 256):
    """Pack K (n, n), the same on every rank (a tensor, or an array put on
    config.default_device), and factor it distributed:
    returns (Ll, solve), Ll this rank's part of L's stack (gather_stack
    and cyclic_unpack give L) and solve(Ll, b) as dist_chol_factory's."""
    K, = _tensors(K)
    ax = Axis(mesh, axis)
    Kst, nloc = cyclic_pack(K, nb, ax.size)
    factor, solve = dist_chol_factory(mesh, axis, K.shape[0], nb)
    return factor(Kst[ax.index * nloc:(ax.index + 1) * nloc]), solve
