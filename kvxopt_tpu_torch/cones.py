"""Cone algebra for the nonnegative orthant and second-order cones,
batched over a leading axis.

Counterpart of kvxopt_tpu/cones.py.  A cone vector of dims (l, q, s) is
the flat layout of the JAX package; every function here takes tensors
with a leading batch dimension, (B, size), in place of a vmapped scalar
function.  Second-order (q) blocks of equal size are processed as one
group, a (B, c, m) tensor for c blocks of size m, as `block_groups`
groups them in the JAX package.

The l and q cones are ported.  Semidefinite (s) blocks raise
NotImplementedError (ROADMAP.md, Queue 1, item 1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ConeDims:
    """Static description of a product cone.

    l: dimension of the nonnegative orthant
    q: sizes of the second-order cone blocks
    s: orders of the semidefinite blocks
    """

    l: int = 0
    q: Tuple[int, ...] = ()
    s: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(int(x) for x in self.q))
        object.__setattr__(self, "s", tuple(int(x) for x in self.s))
        if self.l < 0 or any(x < 1 for x in self.q) or any(
                x < 1 for x in self.s):
            raise ValueError("invalid cone dimensions")

    @classmethod
    def from_dict(cls, dims) -> "ConeDims":
        if isinstance(dims, ConeDims):
            return dims
        return cls(
            l=int(dims.get("l", 0)),
            q=tuple(dims.get("q", ())),
            s=tuple(dims.get("s", ())),
        )

    @property
    def size(self) -> int:
        """Length of the flat cone vector (full storage for s blocks)."""
        return self.l + sum(self.q) + sum(m * m for m in self.s)

    @property
    def degree(self) -> int:
        """Degree of the cone: l + len(q) + sum(s)."""
        return self.l + len(self.q) + sum(self.s)

    @property
    def qofs(self) -> Tuple[int, ...]:
        ofs, out = self.l, []
        for m in self.q:
            out.append(ofs)
            ofs += m
        return tuple(out)

    @property
    def sofs(self) -> Tuple[int, ...]:
        ofs, out = self.l + sum(self.q), []
        for m in self.s:
            out.append(ofs)
            ofs += m * m
        return tuple(out)

    def with_extra_l(self, extra: int) -> "ConeDims":
        """Dims with `extra` leading orthant entries."""
        return ConeDims(l=self.l + extra, q=self.q, s=self.s)


def require_no_s(dims: ConeDims):
    """Raise for semidefinite blocks, which the port does not have yet."""
    if dims.s:
        raise NotImplementedError(
            "kvxopt_tpu_torch supports the nonnegative orthant (l) and "
            "second-order cones (q) so far; semidefinite cones (s) are "
            "queued in ROADMAP.md (Queue 1, item 1)")


# ---------------------------------------------------------------------------
# Same-size block grouping
# ---------------------------------------------------------------------------

class QGroup(NamedTuple):
    """Equal-size q blocks: m, the block indices, their flat indices
    (count, m) as in the JAX package's block_groups, and the first flat
    index when the blocks are adjacent (one slice), else None."""

    m: int
    idxs: Tuple[int, ...]
    flat: np.ndarray
    start: Optional[int]


_GROUP_CACHE: dict = {}


def block_groups(dims: ConeDims):
    """(qgroups, sgroups) as the JAX package's block_groups returns them,
    q groups in increasing block size; sgroups stays empty (s blocks are
    not ported)."""
    cached = _GROUP_CACHE.get(dims)
    if cached is not None:
        return cached
    qg: dict = {}
    for k, m in enumerate(dims.q):
        qg.setdefault(m, []).append(k)
    qgroups = []
    for m, idxs in sorted(qg.items()):
        flat = np.stack([np.arange(dims.qofs[k], dims.qofs[k] + m)
                         for k in idxs])
        first = int(flat[0, 0])
        adjacent = np.array_equal(flat.ravel(),
                                  np.arange(first, first + flat.size))
        qgroups.append(QGroup(m, tuple(idxs), flat,
                              first if adjacent else None))
    _GROUP_CACHE[dims] = (qgroups, [])
    return _GROUP_CACHE[dims]


def _take(u, g: QGroup, dim=-1):
    """The blocks of group g along axis `dim` (negative): (..., size, ...)
    -> (..., c, m, ...)."""
    c = len(g.idxs)
    if g.start is not None:
        blk = u.narrow(dim, g.start, c * g.m)
    else:
        blk = u.index_select(dim % u.ndim, torch.as_tensor(
            g.flat.ravel(), device=u.device))
    return blk.unflatten(dim, (c, g.m))


def _assemble(dims, lpart, qparts, dim=-1):
    """A cone vector (dim=-1) or the rows of a cone matrix (dim=-2) from
    its l part and one (..., c, m, ...) tensor per q group."""
    if not dims.q:
        return lpart
    pieces = [(0, lpart)] if dims.l else []
    for g, val in zip(block_groups(dims)[0], qparts):
        if g.start is not None:
            pieces.append((g.start, val.flatten(dim - 1, dim)))
        else:
            pieces += [(int(ofs), val.select(dim - 1, j))
                       for j, ofs in enumerate(g.flat[:, 0])]
    pieces.sort(key=lambda p: p[0])
    return torch.cat([p for _, p in pieces], dim=dim)


def _blockwise(dims, lfn, qfn, *us):
    """Apply lfn to the l parts of us and qfn(group index, *blocks) to
    each q group, and reassemble the cone vector."""
    require_no_s(dims)
    lpart = lfn(*(u[..., :dims.l] for u in us)) if dims.l else None
    qparts = [qfn(gi, *(_take(u, g) for u in us))
              for gi, g in enumerate(block_groups(dims)[0])]
    return _assemble(dims, lpart, qparts)


def _J(u, dim=-1):
    """J u = (u0, -u1) along axis `dim` of SOC blocks."""
    return torch.cat([u.narrow(dim, 0, 1), -u.narrow(dim, 1,
                                                    u.shape[dim] - 1)],
                     dim=dim)


def jdot(x):
    """Hyperbolic inner product x0^2 - ||x1||^2 of SOC blocks (last
    axis); leading axes broadcast."""
    return x[..., 0] ** 2 - torch.sum(x[..., 1:] ** 2, dim=-1)


def jnrm2(x):
    """Hyperbolic norm sqrt(x0^2 - ||x1||^2) of interior SOC blocks, in
    the stable form sqrt((x0 - ||x1||) (x0 + ||x1||))."""
    a = torch.linalg.vector_norm(x[..., 1:], dim=-1)
    return torch.sqrt(torch.clamp((x[..., 0] - a) * (x[..., 0] + a),
                                  min=0.0))


class NTScaling(NamedTuple):
    """Nesterov-Todd scaling point of a batch.

    d:    (B, l)          W_l = diag(d)
    beta: per q group of block_groups(dims), (B, c)
    v:    per q group, (B, c, m) with v'Jv = 1;  W_q = beta (2 v v' - J)
    r, rti: empty (s blocks are not ported).
    The JAX package keeps beta and v per block; convert.py maps between
    the two layouts."""

    d: torch.Tensor
    beta: tuple = ()
    v: tuple = ()
    r: tuple = ()
    rti: tuple = ()


# ---------------------------------------------------------------------------
# Identity element, inner products, Jordan algebra
# ---------------------------------------------------------------------------

def cone_e(dims: ConeDims, dtype, device=None):
    """Identity element of the cone, shape (size,): ones on the orthant,
    (1, 0, ..., 0) on each q block."""
    require_no_s(dims)
    e = torch.zeros((dims.size,), dtype=dtype, device=device)
    e[:dims.l] = 1.0
    e[list(dims.qofs)] = 1.0
    return e


def sdot(dims: ConeDims, u, v):
    """Cone inner product of (B, size) vectors -> (B,)."""
    return torch.sum(u * v, dim=-1)


def snrm2(dims: ConeDims, u):
    """Euclidean norm of (B, size) cone vectors -> (B,)."""
    return torch.sqrt(torch.clamp(sdot(dims, u, u), min=0.0))


def sprod(dims: ConeDims, x, y, diag: bool = False):
    """Jordan product x o y: elementwise on the orthant,
    (x'y, x0 y1 + y0 x1) on each q block."""
    def q(gi, xb, yb):
        head = torch.sum(xb * yb, dim=-1, keepdim=True)
        return torch.cat([head, xb[..., :1] * yb[..., 1:] +
                          yb[..., :1] * xb[..., 1:]], dim=-1)
    return _blockwise(dims, torch.mul, q, x, y)


def ssqr(dims: ConeDims, x):
    """x o x."""
    def q(gi, xb):
        head = torch.sum(xb * xb, dim=-1, keepdim=True)
        return torch.cat([head, 2.0 * xb[..., :1] * xb[..., 1:]], dim=-1)
    return _blockwise(dims, lambda a: a * a, q, x)


def sinv(dims: ConeDims, x, y):
    """Inverse Jordan product x \\o y: y / x on the orthant, the inverse
    of the arrow matrix Arw(x) applied to y on each q block."""
    def q(gi, xb, yb):
        c0 = (xb[..., 0] * yb[..., 0] - torch.sum(
            xb[..., 1:] * yb[..., 1:], dim=-1)) / jdot(xb)
        c1 = (yb[..., 1:] - c0[..., None] * xb[..., 1:]) / xb[..., :1]
        return torch.cat([c0[..., None], c1], dim=-1)
    return _blockwise(dims, lambda a, b: b / a, q, x, y)


# ---------------------------------------------------------------------------
# max_step
# ---------------------------------------------------------------------------

def max_step(dims: ConeDims, x):
    """min{t | x + t*e >= 0} per lane, shape (B,): negative iff x is
    strictly inside the cone."""
    require_no_s(dims)
    vals = []
    if dims.l:
        vals.append(-torch.amin(x[..., :dims.l], dim=-1))
    for g in block_groups(dims)[0]:
        xb = _take(x, g)
        vals.append(torch.amax(torch.linalg.vector_norm(
            xb[..., 1:], dim=-1) - xb[..., 0], dim=-1))
    if not vals:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.amax(torch.stack(vals, dim=-1), dim=-1)


def max_step2(dims: ConeDims, u, v):
    """max_step of two cone vectors."""
    return max_step(dims, u), max_step(dims, v)


# ---------------------------------------------------------------------------
# Nesterov-Todd scaling
# ---------------------------------------------------------------------------

def compute_scaling(dims: ConeDims, s, z):
    """NT scaling W and scaled point lambda from strictly feasible (s, z),
    with W z = W^{-T} s = lambda.  Orthant: d = sqrt(s/z),
    lambda = sqrt(s z).  q blocks: beta = sqrt(jnrm2(s)/jnrm2(z)) and the
    hyperbolic Householder vector v of the square root of the map taking
    z to s (kvxopt_tpu/cones.py compute_scaling)."""
    require_no_s(dims)
    sl, zl = s[..., :dims.l], z[..., :dims.l]
    d = torch.sqrt(sl / zl)
    betas, vs, lams = [], [], []
    for g in block_groups(dims)[0]:
        sb, zb = _take(s, g), _take(z, g)
        aa, bb = jnrm2(sb), jnrm2(zb)
        beta = torch.sqrt(aa / bb)
        s_ = sb / aa[..., None]
        z_ = zb / bb[..., None]
        gamma = torch.sqrt((1.0 + torch.sum(s_ * z_, dim=-1)) / 2.0)
        wbar = (s_ + _J(z_)) / (2.0 * gamma[..., None])
        head = wbar[..., :1] + 1.0
        vb = torch.cat([head, wbar[..., 1:]], dim=-1) / torch.sqrt(
            2.0 * head)
        betas.append(beta)
        vs.append(vb)
        lams.append(_soc_apply(beta, vb, zb))
    lmbda = _assemble(dims, torch.sqrt(sl * zl) if dims.l else None, lams)
    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs)), lmbda


def identity_scaling(dims: ConeDims, batch: int, dtype,
                     device=None) -> NTScaling:
    """The identity scaling W = I for a batch of `batch` lanes (v = e
    gives W_q = 2 e e' - J = I)."""
    require_no_s(dims)
    betas, vs = [], []
    for g in block_groups(dims)[0]:
        c = len(g.idxs)
        betas.append(torch.ones((batch, c), dtype=dtype, device=device))
        v = torch.zeros((batch, c, g.m), dtype=dtype, device=device)
        v[..., 0] = 1.0
        vs.append(v)
    return NTScaling(d=torch.ones((batch, dims.l), dtype=dtype,
                                  device=device),
                     beta=tuple(betas), v=tuple(vs))


# ---------------------------------------------------------------------------
# Applying the scaling
# ---------------------------------------------------------------------------

def _soc_apply(beta, v, u):
    """beta (2 v v' - J) u for SOC blocks (last axis); beta has the
    leading shape of v and u."""
    return beta[..., None] * (
        2.0 * v * torch.sum(v * u, dim=-1, keepdim=True) - _J(u))


def _soc_apply_inv(beta, v, u):
    """W^{-1} u = (1/beta) (2 (Jv)(Jv)' - J) u."""
    Jv = _J(v)
    return (2.0 * Jv * torch.sum(Jv * u, dim=-1, keepdim=True) -
            _J(u)) / beta[..., None]


def scale(dims: ConeDims, W: NTScaling, u, trans: bool = False,
          inverse: bool = False):
    """W u, W' u, W^{-1} u or W^{-T} u (W is symmetric on the orthant and
    on q blocks, so trans changes nothing there)."""
    def lfn(a):
        return a * (W.d if not inverse else 1.0 / W.d)

    def qfn(gi, ub):
        app = _soc_apply_inv if inverse else _soc_apply
        return app(W.beta[gi], W.v[gi], ub)
    return _blockwise(dims, lfn, qfn, u)


def _soc_sqrt(lam):
    """Jordan square root of interior SOC blocks (last axis)."""
    head = torch.sqrt((lam[..., :1] + jnrm2(lam)[..., None]) / 2.0)
    return torch.cat([head, lam[..., 1:] / (2.0 * head)], dim=-1)


def scale2(dims: ConeDims, lmbda, u, inverse: bool = False):
    """H(lambda^{-1/2}) u, the automorphism mapping lambda to e (inverse:
    H(lambda^{1/2}) u).  Orthant: u / lambda (inverse: u * lambda); q:
    2 w (w'u) - jdot(w) J u with w = lambda^{-1/2} (inverse: lambda^{1/2})."""
    def qfn(gi, lam_b, ub):
        sq = _soc_sqrt(lam_b)
        w = sq if inverse else _J(sq) / jdot(sq)[..., None]
        return (2.0 * w * torch.sum(w * ub, dim=-1, keepdim=True) -
                jdot(w)[..., None] * _J(ub))
    return _blockwise(dims, lambda lam, a: a * lam if inverse else a / lam,
                      qfn, lmbda, u)


def wtw_scale_cols(dims: ConeDims, W: NTScaling, G):
    """W^{-T} applied to every column of G (B, size, n): a row scaling on
    the orthant, a rank-one update of each q block over all columns."""
    require_no_s(dims)
    lpart = G[..., :dims.l, :] / W.d[..., :, None] if dims.l else None
    qparts = []
    for gi, g in enumerate(block_groups(dims)[0]):
        Bk = _take(G, g, dim=-2)                          # (B, c, m, n)
        Jv = _J(W.v[gi])                                  # (B, c, m)
        JvB = torch.einsum("...cm,...cmn->...cn", Jv, Bk)
        qparts.append((2.0 * Jv[..., None] * JvB[..., None, :] -
                       _J(Bk, dim=-2)) / W.beta[gi][..., None, None])
    return _assemble(dims, lpart, qparts, dim=-2)
