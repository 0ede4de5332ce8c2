"""Arrow (bordered block-diagonal) KKT factorization.

Counterpart of kvxopt_tpu/parallel/arrow.py: B independent diagonal
blocks coupled through a small set of shared variables,

    K = [ D_1            C_1 ]
        [      ...       ... ]
        [           D_B  C_B ]
        [ C_1' ...  C_B'  E  ]

factored as a batched Cholesky of the D_i (torch.linalg, as the JAX
module's cho_factor), the Schur complement S = E - sum_i C_i' D_i^{-1}
C_i and its Cholesky factor.  Solves are batched triangular solves plus
a border solve.  With a mesh the ranks, called with the same data
(SPMD), each factor their own consecutive share of the blocks; S and
the border right-hand side are summed by one all_reduce each, and the
blocks' solutions are gathered so that every rank returns all of them.
"""

from __future__ import annotations

import torch

from .batch import _tensors
from .mesh import Axis


def arrow_kkt_factor(D, C, E, mesh=None, axis: str = "kkt"):
    """Factor the arrow matrix of blocks D (B, nb, nb), borders
    C (B, nb, nc) and corner E (nc, nc) (tensors, or arrays put on
    config.default_device).  Returns (solve, S): solve(bblk, bbrd) ->
    (xblk, xbrd) with bblk (B, nb) and bbrd (nc,), and the Schur
    complement S.  With `mesh`, the blocks are dealt over `axis`, whose
    rank count must divide B."""
    D, C, E = _tensors(D, C, E)
    B = C.shape[0]
    ax = None if mesh is None else Axis(mesh, axis)
    mine = slice(None) if ax is None else ax.part(B)
    Cl = C[mine]
    chol_D = torch.linalg.cholesky(D[mine])
    DinvC = torch.cholesky_solve(Cl, chol_D)
    Ssum = torch.einsum("bij,bik->jk", Cl, DinvC)
    if ax is not None:
        ax.all_reduce(Ssum)
    S = E - Ssum
    chol_S = torch.linalg.cholesky(S)

    def solve(bblk, bbrd):
        bblk, bbrd = _tensors(bblk, bbrd)
        w = torch.cholesky_solve(bblk[mine][..., None], chol_D)[..., 0]
        csum = torch.einsum("bij,bi->j", Cl, w)
        if ax is not None:
            ax.all_reduce(csum)
        xbrd = torch.cholesky_solve((bbrd - csum)[:, None], chol_S)[:, 0]
        xblk = w - torch.einsum("bij,j->bi", DinvC, xbrd)
        if ax is not None:
            xblk = ax.gather(xblk, B)
        return xblk, xbrd

    return solve, S
