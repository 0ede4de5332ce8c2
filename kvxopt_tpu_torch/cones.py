"""Cone algebra for the nonnegative orthant, second-order cones and
semidefinite cones, batched over a leading axis.

Counterpart of kvxopt_tpu/cones.py.  A cone vector of dims (l, q, s) is
the flat layout of the JAX package, each s block a full m x m matrix in
row-major order; every function here takes tensors with a leading batch
dimension, (B, size), in place of a vmapped scalar function.  Blocks of
equal size are processed as one group, as `block_groups` groups them in
the JAX package: a (B, c, m) tensor for c q blocks of size m, a
(B, c, m, m) tensor for c s blocks of order m.

Eigen-decompositions and SVDs of s blocks are torch.linalg calls.  A
block that holds NaN or inf goes into them as the identity and comes out
as NaN (`_finite_blocks`): jnp.linalg returns NaN for such a block, and
the interior-point loop turns a NaN step into status SINGULAR, where
torch would return finite values on the CPU and may raise on CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.chol_ls import cholesky_nan


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

    def qblock(self, u, k):
        """The k-th q block of the cone vector u."""
        return u[self.qofs[k]:self.qofs[k] + self.q[k]]

    def sblock(self, u, k):
        """The k-th s block of the cone vector u as its (m, m) matrix."""
        m = self.s[k]
        return u[self.sofs[k]:self.sofs[k] + m * m].reshape(m, m)

    def with_extra_l(self, extra: int) -> "ConeDims":
        """Dims with `extra` leading orthant entries."""
        return ConeDims(l=self.l + extra, q=self.q, s=self.s)


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


class SGroup(NamedTuple):
    """Equal-order s blocks, as QGroup: flat is (count, m*m), each row a
    block's m x m entries in row-major order."""

    m: int
    idxs: Tuple[int, ...]
    flat: np.ndarray
    start: Optional[int]


_GROUP_CACHE: dict = {}


def _groups(kind, sizes, offsets, width):
    by_size: dict = {}
    for k, m in enumerate(sizes):
        by_size.setdefault(m, []).append(k)
    out = []
    for m, idxs in sorted(by_size.items()):
        flat = np.stack([np.arange(offsets[k], offsets[k] + width(m))
                         for k in idxs])
        first = int(flat[0, 0])
        adjacent = np.array_equal(flat.ravel(),
                                  np.arange(first, first + flat.size))
        out.append(kind(m, tuple(idxs), flat, first if adjacent else None))
    return out


def block_groups(dims: ConeDims):
    """(qgroups, sgroups) as the JAX package's block_groups returns them,
    each in increasing block size."""
    cached = _GROUP_CACHE.get(dims)
    if cached is None:
        cached = (_groups(QGroup, dims.q, dims.qofs, lambda m: m),
                  _groups(SGroup, dims.s, dims.sofs, lambda m: m * m))
        _GROUP_CACHE[dims] = cached
    return cached


def _take(u, g, dim=-1):
    """The blocks of group g along axis `dim` (negative): (..., size, ...)
    -> (..., c, w, ...) with w = m for q groups and m*m for s groups."""
    c, w = g.flat.shape
    if g.start is not None:
        blk = u.narrow(dim, g.start, c * w)
    else:
        blk = u.index_select(dim % u.ndim, torch.as_tensor(
            g.flat.ravel(), device=u.device))
    return blk.unflatten(dim, (c, w))


def _smat(u, g):
    """The s blocks of group g of cone vectors u (B, size) as matrices
    (B, c, m, m)."""
    return _take(u, g).unflatten(-1, (g.m, g.m))


def _assemble(dims, lpart, parts, dim=-1):
    """A cone vector (dim=-1) or the rows of a cone matrix (dim=-2) from
    its l part and one (..., c, w, ...) tensor per group, q groups first
    and then s groups, as block_groups lists them."""
    qgroups, sgroups = block_groups(dims)
    pieces = [(0, lpart)] if dims.l else []
    for g, val in zip(qgroups + sgroups, parts):
        if g.start is not None:
            pieces.append((g.start, val.flatten(dim - 1, dim)))
        else:
            pieces += [(int(ofs), val.select(dim - 1, j))
                       for j, ofs in enumerate(g.flat[:, 0])]
    pieces.sort(key=lambda p: p[0])
    return torch.cat([p for _, p in pieces], dim=dim)


def _blockwise(dims, lfn, qfn, sfn, *us):
    """Apply lfn to the l parts of us, qfn(group index, *blocks) to each
    q group's (B, c, m) blocks and sfn(group index, *blocks) to each s
    group's (B, c, m, m) blocks, and reassemble the cone vector."""
    qgroups, sgroups = block_groups(dims)
    lpart = lfn(*(u[..., :dims.l] for u in us)) if dims.l else None
    parts = [qfn(gi, *(_take(u, g) for u in us))
             for gi, g in enumerate(qgroups)]
    parts += [sfn(gi, *(_smat(u, g) for u in us)).flatten(-2)
              for gi, g in enumerate(sgroups)]
    return _assemble(dims, lpart, parts)


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


def _diag(X):
    return torch.diagonal(X, dim1=-2, dim2=-1)


def _sym(X):
    return 0.5 * (X + X.mT)


class NTScaling(NamedTuple):
    """Nesterov-Todd scaling point of a batch.

    d:    (B, l)          W_l = diag(d)
    beta: per q group of block_groups(dims), (B, c)
    v:    per q group, (B, c, m) with v'Jv = 1;  W_q = beta (2 v v' - J)
    r, rti: per s group, (B, c, m, m);  W_s(X) = r' X r and
          W_s^{-T}(X) = rti' X rti, rti = r^{-T}.
    The JAX package keeps beta, v, r and rti per block; convert.py maps
    between the two layouts."""

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
    (1, 0, ..., 0) on each q block, I on each s block."""
    e = torch.zeros((dims.size,), dtype=dtype, device=device)
    e[:dims.l] = 1.0
    e[list(dims.qofs)] = 1.0
    for ofs, m in zip(dims.sofs, dims.s):
        e[ofs:ofs + m * m:m + 1] = 1.0
    return e


def sdot(dims: ConeDims, u, v):
    """Cone inner product of (B, size) vectors -> (B,): with full s-block
    storage the plain dot product is the trace inner product."""
    return torch.sum(u * v, dim=-1)


def snrm2(dims: ConeDims, u):
    """Euclidean norm of (B, size) cone vectors -> (B,)."""
    return torch.sqrt(torch.clamp(sdot(dims, u, u), min=0.0))


def sprod(dims: ConeDims, x, y, diag: bool = False):
    """Jordan product x o y: elementwise on the orthant,
    (x'y, x0 y1 + y0 x1) on each q block, (XY + YX)/2 on each s block
    (with diag=True the s blocks of x are taken as diagonal, the lambda
    vector)."""
    def q(gi, xb, yb):
        head = torch.sum(xb * yb, dim=-1, keepdim=True)
        return torch.cat([head, xb[..., :1] * yb[..., 1:] +
                          yb[..., :1] * xb[..., 1:]], dim=-1)

    def s(gi, X, Y):
        if diag:
            lam = _diag(X)
            return Y * 0.5 * (lam[..., :, None] + lam[..., None, :])
        return 0.5 * (X @ Y + Y @ X)
    return _blockwise(dims, torch.mul, q, s, x, y)


def ssqr(dims: ConeDims, x):
    """x o x."""
    def q(gi, xb):
        head = torch.sum(xb * xb, dim=-1, keepdim=True)
        return torch.cat([head, 2.0 * xb[..., :1] * xb[..., 1:]], dim=-1)
    return _blockwise(dims, lambda a: a * a, q, lambda gi, X: X @ X, x)


def sinv(dims: ConeDims, x, y):
    """Inverse Jordan product x \\o y: y / x on the orthant, the inverse
    of the arrow matrix Arw(x) applied to y on each q block, and
    Y_ij 2 / (lam_i + lam_j) on each s block, whose x is diagonal."""
    def q(gi, xb, yb):
        c0 = (xb[..., 0] * yb[..., 0] - torch.sum(
            xb[..., 1:] * yb[..., 1:], dim=-1)) / jdot(xb)
        c1 = (yb[..., 1:] - c0[..., None] * xb[..., 1:]) / xb[..., :1]
        return torch.cat([c0[..., None], c1], dim=-1)

    def s(gi, X, Y):
        lam = _diag(X)
        return Y * (2.0 / (lam[..., :, None] + lam[..., None, :]))
    return _blockwise(dims, lambda a, b: b / a, q, s, x, y)


# ---------------------------------------------------------------------------
# Eigen-decompositions of s blocks, NaN in -> NaN out
# ---------------------------------------------------------------------------

def _finite_blocks(X):
    """(X with each non-finite (..., m, m) block replaced by the identity,
    the (...) mask of the finite blocks)."""
    ok = torch.isfinite(X).all(dim=-1).all(dim=-1)
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return torch.where(ok[..., None, None], X, eye), ok


def _nan_where_not(ok, t, k):
    """t with NaN in the blocks where ok is False; t has k trailing axes
    beyond ok's."""
    return torch.where(ok.reshape(ok.shape + (1,) * k), t,
                       torch.full_like(t, math.nan))


def _eigvalsh(X):
    Xf, ok = _finite_blocks(X)
    return _nan_where_not(ok, torch.linalg.eigvalsh(Xf), 1)


def _eigh(X):
    Xf, ok = _finite_blocks(X)
    w, Q = torch.linalg.eigh(Xf)
    return _nan_where_not(ok, w, 1), _nan_where_not(ok, Q, 2)


def _svd(X):
    Xf, ok = _finite_blocks(X)
    U, sig, Vh = torch.linalg.svd(Xf)
    return (_nan_where_not(ok, U, 2), _nan_where_not(ok, sig, 1),
            _nan_where_not(ok, Vh, 2))


# ---------------------------------------------------------------------------
# max_step
# ---------------------------------------------------------------------------

def _max_step_lq(dims, x):
    vals = []
    if dims.l:
        vals.append(-torch.amin(x[..., :dims.l], dim=-1))
    for g in block_groups(dims)[0]:
        xb = _take(x, g)
        vals.append(torch.amax(torch.linalg.vector_norm(
            xb[..., 1:], dim=-1) - xb[..., 0], dim=-1))
    return vals


def _max_of(vals, x):
    if not vals:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.amax(torch.stack(vals, dim=-1), dim=-1)


def max_step(dims: ConeDims, x):
    """min{t | x + t*e >= 0} per lane, shape (B,): negative iff x is
    strictly inside the cone.  One batched eigvalsh per s group."""
    vals = _max_step_lq(dims, x)
    for g in block_groups(dims)[1]:
        w = _eigvalsh(_sym(_smat(x, g)))
        vals.append(-torch.amin(w.flatten(-2), dim=-1))
    return _max_of(vals, x)


def max_step2(dims: ConeDims, u, v):
    """max_step of two cone vectors, with one eigenvalue call per s group
    for both."""
    t = max_step(dims, torch.cat([u, v]))
    return t[:u.shape[0]], t[u.shape[0]:]


def max_step_eig(dims: ConeDims, u):
    """max_step that also returns the s-block eigendecompositions: (t,
    eig), eig one (sig (B, c, m), Q (B, c, m, m)) pair per s group with
    Q diag(sig) Q' the symmetric part of the block."""
    vals = _max_step_lq(dims, u)
    eig = []
    for g in block_groups(dims)[1]:
        sig, Q = _eigh(_sym(_smat(u, g)))
        eig.append((sig, Q))
        vals.append(-torch.amin(sig.flatten(-2), dim=-1))
    return _max_of(vals, u), eig


# ---------------------------------------------------------------------------
# Nesterov-Todd scaling
# ---------------------------------------------------------------------------

def _svd_batched(Bm, method: str = "eigh"):
    """Batched SVD Bm = U diag(sig) V' of square (..., m, m) blocks,
    singular values in descending order.  'eigh' takes it from the
    eigendecomposition of Bm'Bm, as the JAX package's default does
    (reversed, clamped at 1e-300, U = Bm V / sig); 'svd' calls
    torch.linalg.svd."""
    if method == "svd":
        U, sig, Vh = _svd(Bm)
        return U, sig, Vh.mT
    sig2, Q = _eigh(Bm.mT @ Bm)
    sig2 = torch.clamp(sig2.flip(-1), min=1e-300)
    V = Q.flip(-1)
    sig = torch.sqrt(sig2)
    U = Bm @ (V / sig[..., None, :])
    return U, sig, V


def _lam_blocks(lam):
    """diag(lam) as (..., m*m) for the s blocks of lambda."""
    return torch.diag_embed(lam).flatten(-2)


def compute_scaling(dims: ConeDims, s, z, method: str = "eigh"):
    """NT scaling W and scaled point lambda from strictly feasible (s, z),
    with W z = W^{-T} s = lambda.  Orthant: d = sqrt(s/z),
    lambda = sqrt(s z).  q blocks: beta = sqrt(jnrm2(s)/jnrm2(z)) and the
    hyperbolic Householder vector v of the square root of the map taking
    z to s.  s blocks: one Cholesky over [S; Z] per group, the SVD of
    L_z' L_s = U diag(lam) V' (`method`: 'eigh' or 'svd'),
    r = L_s V lam^{-1/2}, rti = L_z U lam^{-1/2}, lambda = diag(lam)
    (kvxopt_tpu/cones.py compute_scaling)."""
    qgroups, sgroups = block_groups(dims)
    sl, zl = s[..., :dims.l], z[..., :dims.l]
    d = torch.sqrt(sl / zl)
    betas, vs, rs, rtis, parts = [], [], [], [], []
    for g in qgroups:
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
        parts.append(_soc_apply(beta, vb, zb))
    for g in sgroups:
        S, Z = _smat(s, g), _smat(z, g)
        c = S.shape[-3]
        LL = cholesky_nan(torch.cat([_sym(S), _sym(Z)], dim=-3))
        L1, L2 = LL[..., :c, :, :], LL[..., c:, :, :]
        U, lam, V = _svd_batched(L2.mT @ L1, method)
        isqrt = 1.0 / torch.sqrt(lam)
        rs.append(L1 @ (V * isqrt[..., None, :]))
        rtis.append(L2 @ (U * isqrt[..., None, :]))
        parts.append(_lam_blocks(lam))
    lmbda = _assemble(dims, torch.sqrt(sl * zl) if dims.l else None, parts)
    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs), r=tuple(rs),
                     rti=tuple(rtis)), lmbda


def identity_scaling(dims: ConeDims, batch: int, dtype,
                     device=None) -> NTScaling:
    """The identity scaling W = I for a batch of `batch` lanes (v = e
    gives W_q = 2 e e' - J = I; r = rti = I)."""
    qgroups, sgroups = block_groups(dims)
    betas, vs, rs = [], [], []
    for g in qgroups:
        c = len(g.idxs)
        betas.append(torch.ones((batch, c), dtype=dtype, device=device))
        v = torch.zeros((batch, c, g.m), dtype=dtype, device=device)
        v[..., 0] = 1.0
        vs.append(v)
    for g in sgroups:
        rs.append(torch.eye(g.m, dtype=dtype, device=device).expand(
            batch, len(g.idxs), g.m, g.m))
    return NTScaling(d=torch.ones((batch, dims.l), dtype=dtype,
                                  device=device),
                     beta=tuple(betas), v=tuple(vs), r=tuple(rs),
                     rti=tuple(rs))


def update_scaling(dims: ConeDims, W: NTScaling, s, z):
    """The NT scaling recomputed from an unscaled strictly feasible pair
    (s, z), as the JAX package's update_scaling does; the incremental
    update from scaled iterates is update_scaling_inc."""
    return compute_scaling(dims, s, z)


def update_scaling_inc(dims: ConeDims, W: NTScaling, lmbda, s, z,
                       method: str = "eigh"):
    """Incremental Nesterov-Todd scaling update (kvxopt_tpu/cones.py
    update_scaling_inc, reference misc.py:422).

    The l and q blocks of s and z hold the new iterates in the current
    scaling (W^{-T} s_new and W z_new); the s blocks hold factors Ls, Lz
    (m x m) with Ls Ls' = W^{-T} s_new and Lz Lz' = W z_new.  Returns
    (W_new, lmbda_new) with W_new z_new = W_new^{-T} s_new = lmbda_new,
    lambda's s blocks diagonal."""
    qgroups, sgroups = block_groups(dims)
    lpart = None
    d = W.d
    if dims.l:
        sl, zl = s[..., :dims.l], z[..., :dims.l]
        d = W.d * torch.sqrt(sl / zl)
        lpart = torch.sqrt(sl * zl)
    betas, vs, rs, rtis, parts = [], [], [], [], []
    for gi, g in enumerate(qgroups):
        sb, zb = _take(s, g), _take(z, g)
        v, beta = W.v[gi], W.beta[gi]
        aa, bb = jnrm2(sb), jnrm2(zb)
        s_ = sb / aa[..., None]
        z_ = zb / bb[..., None]
        cc = torch.sqrt((1.0 + torch.sum(s_ * z_, dim=-1)) / 2.0)
        vs_ = torch.sum(v * s_, dim=-1)
        vz = v[..., 0] * z_[..., 0] - torch.sum(v[..., 1:] * z_[..., 1:],
                                                dim=-1)
        vq = (vs_ + vz) / (2.0 * cc)
        vu = vs_ - vz
        wk0 = 2.0 * v[..., 0] * vq - (s_[..., 0] + z_[..., 0]) / (2.0 * cc)
        dd = (v[..., 0] * vu - s_[..., 0] / 2.0 + z_[..., 0] / 2.0) / \
            (wk0 + 1.0)
        lam1 = (2.0 * (-dd * vq + 0.5 * vu))[..., None] * v[..., 1:] + \
            (0.5 * (1.0 - dd / cc))[..., None] * s_[..., 1:] + \
            (0.5 * (1.0 + dd / cc))[..., None] * z_[..., 1:]
        scal = torch.sqrt(aa * bb)
        parts.append(scal[..., None] * torch.cat([cc[..., None], lam1],
                                                 dim=-1))
        # v := ((2 v v' - J) q)^{1/2} with q = (s_ + J z_) / (2c)
        w = 2.0 * vq[..., None] * v - (_J(s_) + z_) / (2.0 * cc[..., None])
        w = torch.cat([w[..., :1] + 1.0, w[..., 1:]], dim=-1)
        vs.append(w / torch.sqrt(2.0 * w[..., :1]))
        betas.append(beta * torch.sqrt(aa / bb))
    for gi, g in enumerate(sgroups):
        Ls, Lz = _smat(s, g), _smat(z, g)
        # SVD Lz' Ls = U diag(lam) V'; r := r Ls V lam^{-1/2},
        # rti := rti Lz U lam^{-1/2}
        U, lam, V = _svd_batched(Lz.mT @ Ls, method)
        isqrt = 1.0 / torch.sqrt(lam)
        rs.append((W.r[gi] @ Ls) @ (V * isqrt[..., None, :]))
        rtis.append((W.rti[gi] @ Lz) @ (U * isqrt[..., None, :]))
        parts.append(_lam_blocks(lam))
    return NTScaling(d=d, beta=tuple(betas), v=tuple(vs), r=tuple(rs),
                     rti=tuple(rtis)), _assemble(dims, lpart, parts)


def _lanes(step, k):
    """A per-lane step (B,) shaped to broadcast over k more axes; a
    Python number passes through."""
    if torch.is_tensor(step) and step.ndim:
        return step.reshape(step.shape + (1,) * k)
    return step


def step_scaled_iterates(dims: ConeDims, lmbda, d_w, eig, step):
    """Input of update_scaling_inc after a line-search step of length
    `step` (per lane, or one number).  l/q blocks: lmbda + step * d_w;
    s blocks: L = Lam^{1/2} Q diag(sqrt(1 + step*sig)) with (sig, Q) = eig
    from max_step_eig of scale2(lmbda, d_w), so that L L' is the new
    scaled iterate."""
    sgroups = block_groups(dims)[1]

    def factor(gi, _):
        sig, Q = eig[gi]
        rt = torch.sqrt(_diag(_smat(lmbda, sgroups[gi])))
        return (rt[..., :, None] * Q) * torch.sqrt(torch.clamp(
            1.0 + _lanes(step, 2) * sig, min=0.0))[..., None, :]
    return _map_s(dims, lmbda + _lanes(step, 1) * d_w, factor)


def lmbda_to_cone(dims: ConeDims, W: NTScaling, lmbda):
    """The unscaled iterates (s, z) = (W' lambda, W^{-1} lambda)."""
    return (scale(dims, W, lmbda, trans=True),
            scale(dims, W, lmbda, inverse=True))


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
    """W u, W' u, W^{-1} u or W^{-T} u.  W is symmetric on the orthant and
    on q blocks, so trans matters only for s blocks: W u = r' U r,
    W' u = r U r', W^{-1} u = rti U rti', W^{-T} u = rti' U rti."""
    def lfn(a):
        return a * (W.d if not inverse else 1.0 / W.d)

    def qfn(gi, ub):
        app = _soc_apply_inv if inverse else _soc_apply
        return app(W.beta[gi], W.v[gi], ub)

    def sfn(gi, U):
        R = W.rti[gi] if inverse else W.r[gi]
        if inverse == trans:
            return R.mT @ U @ R
        return R @ U @ R.mT
    return _blockwise(dims, lfn, qfn, sfn, u)


def _soc_sqrt(lam):
    """Jordan square root of interior SOC blocks (last axis)."""
    head = torch.sqrt((lam[..., :1] + jnrm2(lam)[..., None]) / 2.0)
    return torch.cat([head, lam[..., 1:] / (2.0 * head)], dim=-1)


def scale2(dims: ConeDims, lmbda, u, inverse: bool = False):
    """H(lambda^{-1/2}) u, the automorphism mapping lambda to e (inverse:
    H(lambda^{1/2}) u).  Orthant: u / lambda (inverse: u * lambda); q:
    2 w (w'u) - jdot(w) J u with w = lambda^{-1/2} (inverse: lambda^{1/2});
    s: U_ij / sqrt(lam_i lam_j) (inverse: times), lambda's s blocks being
    diagonal."""
    def qfn(gi, lam_b, ub):
        sq = _soc_sqrt(lam_b)
        w = sq if inverse else _J(sq) / jdot(sq)[..., None]
        return (2.0 * w * torch.sum(w * ub, dim=-1, keepdim=True) -
                jdot(w)[..., None] * _J(ub))

    def sfn(gi, Lam, U):
        rt = torch.sqrt(_diag(Lam))
        denom = rt[..., :, None] * rt[..., None, :]
        return U * denom if inverse else U / denom
    return _blockwise(dims, lambda lam, a: a * lam if inverse else a / lam,
                      qfn, sfn, lmbda, u)


def wtw_scale_cols(dims: ConeDims, W: NTScaling, G):
    """W^{-T} applied to every column of G (B, size, n): a row scaling on
    the orthant, a rank-one update of each q block, and rti' X rti for
    each s block X of every column, as two batched matmuls over
    (B, c, n, m, m)."""
    qgroups, sgroups = block_groups(dims)
    lpart = G[..., :dims.l, :] / W.d[..., :, None] if dims.l else None
    parts = []
    for gi, g in enumerate(qgroups):
        Bk = _take(G, g, dim=-2)                          # (B, c, m, n)
        Jv = _J(W.v[gi])                                  # (B, c, m)
        JvB = torch.einsum("...cm,...cmn->...cn", Jv, Bk)
        parts.append((2.0 * Jv[..., None] * JvB[..., None, :] -
                      _J(Bk, dim=-2)) / W.beta[gi][..., None, None])
    for gi, g in enumerate(sgroups):
        X = _take(G, g, dim=-2).unflatten(-2, (g.m, g.m)).movedim(-1, -3)
        rti = W.rti[gi].unsqueeze(-3)                     # (B, c, 1, m, m)
        V = rti.mT @ X @ rti                              # (B, c, n, m, m)
        parts.append(V.movedim(-3, -1).flatten(-3, -2))   # (B, c, m*m, n)
    return _assemble(dims, lpart, parts, dim=-2)


# ---------------------------------------------------------------------------
# Storage: packed s blocks, the authoritative triangle, symmetrization
# ---------------------------------------------------------------------------

def pack_size(dims: ConeDims) -> int:
    """Length of the packed representation of a cone vector
    (l + sum(q) + sum(m*(m+1)/2) for the lower-triangle s blocks)."""
    return dims.l + sum(dims.q) + sum(m * (m + 1) // 2 for m in dims.s)


def _tril_weights(m, scale, like):
    rows, cols = torch.tril_indices(m, m, device=like.device)
    w = torch.full(rows.shape, scale, dtype=like.dtype, device=like.device)
    w[rows == cols] = 1.0
    return rows, cols, w


def pack(dims: ConeDims, u):
    """Full-storage cone vectors (..., size) -> packed storage: each s
    block becomes its lower triangle (row by row), off-diagonals scaled
    by sqrt(2) so that dot products are kept."""
    parts = [u[..., :dims.l + sum(dims.q)]]
    for ofs, m in zip(dims.sofs, dims.s):
        X = u[..., ofs:ofs + m * m].unflatten(-1, (m, m))
        rows, cols, w = _tril_weights(m, math.sqrt(2.0), u)
        parts.append(X[..., rows, cols] * w)
    return torch.cat(parts, dim=-1)


def unpack(dims: ConeDims, p):
    """Inverse of pack."""
    n0 = dims.l + sum(dims.q)
    parts, pofs = [p[..., :n0]], n0
    for m in dims.s:
        npk = m * (m + 1) // 2
        rows, cols, w = _tril_weights(m, 1.0 / math.sqrt(2.0), p)
        X = p.new_zeros(p.shape[:-1] + (m, m))
        X[..., rows, cols] = p[..., pofs:pofs + npk] * w
        X = X + X.mT - torch.diag_embed(_diag(X))
        parts.append(X.flatten(-2))
        pofs += npk
    return torch.cat(parts, dim=-1)


def _map_s(dims, u, fn):
    """u with each s group's (B, c, m, m) blocks X replaced by
    fn(group index, X)."""
    qgroups, sgroups = block_groups(dims)
    if not sgroups:
        return u
    parts = [_take(u, g) for g in qgroups]
    parts += [fn(gi, _smat(u, g)).flatten(-2) for gi, g in enumerate(sgroups)]
    return _assemble(dims, u[..., :dims.l] if dims.l else None, parts)


def sym_from_lower(dims: ConeDims, u):
    """The s blocks made symmetric from their authoritative triangle: the
    cone-program convention reads the lower triangle in column-major
    storage, which is the upper triangle of the row-major block.
    Idempotent on symmetric data."""
    return _map_s(dims, u,
                  lambda gi, X: torch.triu(X) + torch.triu(X, 1).mT)


def sym_from_lower_cols(dims: ConeDims, G):
    """sym_from_lower applied to every column of G (B, size, n)."""
    return sym_from_lower(dims, G.mT).mT


def symm(dims: ConeDims, u):
    """The s blocks replaced by their symmetric part (X + X')/2."""
    return _map_s(dims, u, lambda gi, X: _sym(X))
