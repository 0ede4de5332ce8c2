"""Tensor-parallel KKT: row-sharded constraint matrices over a mesh axis.

Counterpart of kvxopt_tpu/parallel/sharded.py.  The condensed KKT
system K = P + G' W^{-1} W^{-T} G is a sum over constraint rows, so with
G's rows dealt over the ranks of a mesh axis each rank forms its own
normal-equations term and one all_reduce sums K; the (small, the same
on every rank) Cholesky factorization follows on each rank.  This is the
tensor-parallel form of the reference's custom-kktsolver contract
(reference coneprog.py:286-402, tests/test_custom_kkt.py:11-31).

The ranks work SPMD: each calls coneqp/conelp (or cpl) with the same
data and passes kktsolver=sharded_kkt_solver(...), which keeps only the
rank's rows of G on its device.  Cone blocks are grouped by size and
stacked so that each rank owns whole blocks; the l part is dealt by
rows.  Per factorization one all_reduce of K (n x n); per solve one
all_reduce of an n-vector and one gather (an all_reduce of a zero-padded
cone vector).

- sharded_kkt_solver(mesh, axis, dims, G, A=None, Pmat=None, reg=0.0,
  dist_nb=0): the kktsolver factory for the full product cone (l, q
  and s blocks); with dist_nb > 0 the Cholesky of K runs block-cyclic
  over the axis (dist_chol.py).
- sharded_kkt_factor(mesh, axis, G, d, Pmat=None): the l-cone-only
  standalone factor of the JAX package's first round.
"""

from __future__ import annotations

import torch

from .. import cones
from ..cones import ConeDims
from ..convert import scaling_batch
from .batch import _tensors
from .mesh import Axis


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m if x else 0


class _ConeShards:
    """This rank's rows of a cone-structured G: the l part padded to a
    multiple of the rank count and dealt by rows, the q and s blocks
    grouped by size, each group's count padded likewise and dealt by
    blocks.  Padded rows are zero and contribute nothing."""

    def __init__(self, axis: Axis, dims: ConeDims, G):
        nd, me = axis.size, axis.index
        self.axis, self.dims = axis, dims
        self.n = G.shape[1]
        self.lpad = max(_ceil_to(dims.l, nd), nd)
        k = self.lpad // nd
        lo, hi = me * k, min((me + 1) * k, dims.l)
        self.lrows = (lo, max(lo, hi), k)
        self.Gl = G.new_zeros((k, self.n))
        self.Gl[:self.lrows[1] - lo] = G[lo:self.lrows[1]]
        self.qgroups = self._groups(dims.q, dims.qofs, lambda m: m, G)
        self.sgroups = self._groups(dims.s, dims.sofs, lambda m: m * m, G)

    def _groups(self, sizes, offsets, rows, G):
        """[(m, local [(j, offset)], stacked local blocks)] per block size
        m: this rank's blocks j of the group, the zero blocks of the
        padding at the end."""
        nd, me = self.axis.size, self.axis.index
        bysize = {}
        for m, ofs in zip(sizes, offsets):
            bysize.setdefault(m, []).append(ofs)
        out = []
        for m, ofss in sorted(bysize.items()):
            k = _ceil_to(len(ofss), nd) // nd
            mine = ofss[me * k:(me + 1) * k]
            blk = G.new_zeros((k, rows(m), self.n))
            for j, ofs in enumerate(mine):
                blk[j] = G[ofs:ofs + rows(m)]
            out.append((m, mine, blk))
        return out

    def scaled(self, W):
        """This rank's rows of W^{-T} G, per part: (Gs_l, [Sq], [Ss]), from
        W in the JAX package's single-instance layout (padded blocks get
        the identity scaling)."""
        lo, hi, k = self.lrows
        d = self.Gl.new_ones((k,))
        d[:hi - lo] = W.d[lo:hi]
        Gsl = self.Gl / d[:, None]
        qk = {ofs: i for i, ofs in enumerate(self.dims.qofs)}
        Sq = []
        for m, mine, Bq in self.qgroups:
            beta = Bq.new_ones((Bq.shape[0],))
            v = Bq.new_zeros((Bq.shape[0], m))
            v[:, 0] = 1.0
            for j, ofs in enumerate(mine):
                beta[j] = W.beta[qk[ofs]]
                v[j] = W.v[qk[ofs]]
            sgn = Bq.new_ones((m,))
            sgn[1:] = -1.0
            Jv = v * sgn
            JvB = torch.einsum("bm,bmn->bn", Jv, Bq)
            Sq.append((2.0 * Jv[:, :, None] * JvB[:, None, :]
                       - Bq * sgn[None, :, None]) / beta[:, None, None])
        sk = {ofs: i for i, ofs in enumerate(self.dims.sofs)}
        Ss = []
        for m, mine, Bs in self.sgroups:
            rti = torch.eye(m, dtype=Bs.dtype, device=Bs.device).repeat(
                Bs.shape[0], 1, 1)
            for j, ofs in enumerate(mine):
                rti[j] = W.rti[sk[ofs]]
            V = torch.einsum("bji,bjkc,bkl->bilc", rti,
                             Bs.reshape(-1, m, m, self.n), rti)
            Ss.append(V.reshape(-1, m * m, self.n))
        return Gsl, Sq, Ss

    def local(self, u):
        """This rank's parts of a cone vector u (the same on every rank),
        stacked like scaled()'s."""
        lo, hi, k = self.lrows
        ul = u.new_zeros((k,))
        ul[:hi - lo] = u[lo:hi]

        def stack(groups, rows):
            out = []
            for m, mine, blk in groups:
                s = u.new_zeros((blk.shape[0], rows(m)))
                for j, ofs in enumerate(mine):
                    s[j] = u[ofs:ofs + rows(m)]
                out.append(s)
            return out
        return (ul, stack(self.qgroups, lambda m: m),
                stack(self.sgroups, lambda m: m * m))

    def gather(self, wl, wq, ws):
        """The cone vector whose parts on each rank are local()'s, on every
        rank: an all_reduce of a zero-padded vector."""
        lo, hi, _ = self.lrows
        out = wl.new_zeros((self.dims.size,))
        out[lo:hi] = wl[:hi - lo]
        for groups, parts, rows in ((self.qgroups, wq, lambda m: m),
                                    (self.sgroups, ws, lambda m: m * m)):
            for (m, mine, _), w in zip(groups, parts):
                for j, ofs in enumerate(mine):
                    out[ofs:ofs + rows(m)] = w[j]
        return self.axis.all_reduce(out)


def _gram(Gsl, Sq, Ss):
    """This rank's term of K: Gs' Gs over its rows."""
    K = Gsl.T @ Gsl
    for S in Sq + Ss:
        K = K + torch.einsum("bmn,bmp->np", S, S)
    return K


def _chol_solver(K):
    L = torch.linalg.cholesky(K)

    def solve(b):
        return torch.cholesky_solve(b[:, None] if b.ndim == 1 else b,
                                    L).reshape(b.shape)
    return solve


def _dist_solver(mesh, axis, K, nb):
    """K^{-1} by the block-cyclic factorization over the axis: K padded
    with the identity to a multiple of nb times the rank count."""
    from .dist_chol import cyclic_pack, dist_chol_factory
    ax = Axis(mesh, axis)
    n = K.shape[0]
    npad = _ceil_to(n, nb * ax.size)
    Kp = torch.eye(npad, dtype=K.dtype, device=K.device)
    Kp[:n, :n] = K
    factor, dsolve = dist_chol_factory(mesh, axis, npad, nb)
    Kst, nloc = cyclic_pack(Kp, nb, ax.size)
    Ll = factor(Kst[ax.index * nloc:(ax.index + 1) * nloc])

    def solve(b):
        bp = b.new_zeros((npad,) + tuple(b.shape[1:]))
        bp[:n] = b
        return dsolve(Ll, bp)[:n]
    return solve


def sharded_kkt_solver(mesh, axis, dims, G, A=None, Pmat=None,
                       reg: float = 0.0, dist_nb: int = 0):
    """A kktsolver for coneqp/conelp/cpl with G's rows dealt over `axis`
    (a mesh axis name or a tuple of them) of `mesh`.

    Returns factor(W, H=None, Df=None) -> solve(bx, by, bz) -> (ux, uy,
    uz) solving

        [ P    A'   G'  ] [ux]   [bx]
        [ A    0    0   ] [uy] = [by]
        [ G    0  -W'W  ] [uz]   [bz]

    W in the JAX package's single-instance layout, as the front ends
    give it (convert.scaling_instance).  K = P + H + Gs'Gs (Gs = W^{-T}G)
    is formed on each rank's rows and summed by one all_reduce; its
    Cholesky factor and the Schur complement over A are the same on
    every rank, or with dist_nb > 0 K is factored block-cyclic over the
    axis with block size dist_nb (dist_chol.py).  With cpl's nonlinear
    rows Df (mnl of them, W then over dims plus mnl leading 'l' entries)
    those rows are kept whole on every rank.  G, A and Pmat are tensors,
    or arrays put on config.default_device."""
    dims = ConeDims.from_dict(dims)
    G, A, Pmat = _tensors(G, A, Pmat)
    n = G.shape[1]
    Aa = G.new_zeros((0, n)) if A is None else A.to(G)
    Pa = None if Pmat is None else Pmat.to(G)
    p = Aa.shape[0]
    ax = Axis(mesh, axis)
    shards = _ConeShards(ax, dims, G)
    eye = torch.eye(n, dtype=G.dtype, device=G.device)

    def factor(W, H=None, Df=None):
        mnl = 0 if Df is None else Df.shape[0]
        Wc = W._replace(d=W.d[mnl:]) if mnl else W
        Wb = scaling_batch(dims, Wc, G.device)
        Gsl, Sq, Ss = shards.scaled(Wc)
        K = ax.all_reduce(_gram(Gsl, Sq, Ss))
        if Pa is not None:
            K = K + Pa
        if H is not None:
            K = K + torch.as_tensor(H).to(G)
        if mnl:
            dnl = W.d[:mnl]
            Dfs = torch.as_tensor(Df).to(G) / dnl[:, None]
            K = K + Dfs.T @ Dfs
        if reg:
            K = K + reg * eye
        ksolve = (_dist_solver(mesh, axis, K, dist_nb) if dist_nb
                  else _chol_solver(K))
        if p:
            KiAt = ksolve(Aa.T)
            S = Aa @ KiAt
            if reg:
                S = S + reg * torch.eye(p, dtype=G.dtype, device=G.device)
            ssolve = _chol_solver(S)

        def solve(bx, by, bz):
            bznl, bzc = bz[:mnl], bz[mnl:]
            bzs = cones.scale(dims, Wb, bzc[None], trans=True,
                              inverse=True)[0]
            ul, uq, us = shards.local(bzs)
            t = Gsl.T @ ul
            for S, u in zip(Sq + Ss, uq + us):
                t = t + torch.einsum("bmn,bm->n", S, u)
            f = bx + ax.all_reduce(t)
            if mnl:
                bznl_s = bznl / dnl
                f = f + Dfs.T @ bznl_s
            if p:
                Kif = ksolve(f)
                uy = ssolve(Aa @ Kif - by)
                ux = Kif - KiAt @ uy
            else:
                ux = ksolve(f)
                uy = bx.new_zeros((0,))
            gx = shards.gather(Gsl @ ux,
                               [torch.einsum("bmn,n->bm", S, ux) for S in Sq],
                               [torch.einsum("bmn,n->bm", S, ux) for S in Ss])
            uz = cones.scale(dims, Wb, (gx - bzs)[None], inverse=True)[0]
            if mnl:
                uz = torch.cat([(Dfs @ ux - bznl_s) / dnl, uz])
            return ux, uy, uz

        return solve

    return factor


def sharded_kkt_factor(mesh, axis, G, d, Pmat=None):
    """Factor K = Pmat + G' diag(d)^{-2} G with G's rows and d dealt over
    `axis` (the l-cone scaling W = diag(d)): G (m, n) and d (m,) the same
    on every rank, m a multiple of the rank count.  Returns (solve, K),
    solve(bx, bz) -> (ux, uz) for [P + G'D^{-2}G] ux = bx + G'D^{-2} bz,
    uz = D^{-2}(G ux - bz), each product one all_reduce (uz gathered on
    every rank)."""
    G, d, Pmat = _tensors(G, d, Pmat)
    ax = Axis(mesh, axis)
    rows = ax.part(G.shape[0])
    Gl, dl = G[rows], d.to(G)[rows]
    Gs = Gl / dl[:, None]
    K = ax.all_reduce(Gs.T @ Gs)
    if Pmat is not None:
        K = K + Pmat.to(G)
    ksolve = _chol_solver(K)

    def solve(bx, bz):
        bzl = bz[rows]
        ux = ksolve(bx + ax.all_reduce(Gl.T @ (bzl / dl ** 2)))
        uz = ax.gather((Gl @ ux - bzl) / dl ** 2, G.shape[0])
        return ux, uz

    return solve, K
