"""Cone algebra for the nonnegative orthant, batched over a leading axis.

Counterpart of kvxopt_tpu/cones.py.  A cone vector of dims (l, q, s) is
the flat layout of the JAX package; every function here takes tensors
with a leading batch dimension, (B, size), in place of a vmapped scalar
function.

Only the l-cone (R^l_+) is ported so far.  Second-order and
semidefinite blocks raise NotImplementedError (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

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


def require_l_only(dims: ConeDims):
    """Raise for cone blocks the port does not have yet."""
    if dims.q or dims.s:
        raise NotImplementedError(
            "kvxopt_tpu_torch supports only the nonnegative orthant (l) "
            "so far; second-order and semidefinite cones are queued in "
            "ROADMAP.md (Queue 1, item 1)")


class NTScaling(NamedTuple):
    """Nesterov-Todd scaling point.  For the l-cone W = diag(d), with d
    of shape (B, l); the q and s fields stay empty tuples."""

    d: torch.Tensor
    beta: tuple = ()
    v: tuple = ()
    r: tuple = ()
    rti: tuple = ()


def cone_e(dims: ConeDims, dtype, device=None):
    """Identity element of the cone, shape (size,)."""
    require_l_only(dims)
    return torch.ones((dims.size,), dtype=dtype, device=device)


def sdot(dims: ConeDims, u, v):
    """Cone inner product of (B, size) vectors -> (B,)."""
    return torch.sum(u * v, dim=-1)


def snrm2(dims: ConeDims, u):
    """Euclidean norm of (B, size) cone vectors -> (B,)."""
    return torch.sqrt(torch.clamp(sdot(dims, u, u), min=0.0))


def sprod(dims: ConeDims, x, y, diag: bool = False):
    """Jordan product x o y (elementwise on the orthant)."""
    require_l_only(dims)
    return x * y


def ssqr(dims: ConeDims, x):
    """x o x."""
    require_l_only(dims)
    return x * x


def sinv(dims: ConeDims, x, y):
    """Inverse Jordan product x \\o y (elementwise y / x)."""
    require_l_only(dims)
    return y / x


def max_step(dims: ConeDims, x):
    """min{t | x + t*e >= 0} per lane, shape (B,)."""
    require_l_only(dims)
    if not dims.l:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return -torch.amin(x[..., :dims.l], dim=-1)


def max_step2(dims: ConeDims, u, v):
    """max_step of two cone vectors."""
    return max_step(dims, u), max_step(dims, v)


def compute_scaling(dims: ConeDims, s, z):
    """NT scaling W and scaled point lambda from strictly feasible (s, z):
    d = sqrt(s/z), lambda = sqrt(s z)."""
    require_l_only(dims)
    sl, zl = s[..., :dims.l], z[..., :dims.l]
    return NTScaling(d=torch.sqrt(sl / zl)), torch.sqrt(sl * zl)


def identity_scaling(dims: ConeDims, batch: int, dtype,
                     device=None) -> NTScaling:
    """The identity scaling W = I for a batch of `batch` lanes."""
    require_l_only(dims)
    return NTScaling(d=torch.ones((batch, dims.l), dtype=dtype,
                                  device=device))


def scale(dims: ConeDims, W: NTScaling, u, trans: bool = False,
          inverse: bool = False):
    """W u, W' u, W^{-1} u or W^{-T} u (W is symmetric on the orthant)."""
    require_l_only(dims)
    dl = W.d if not inverse else 1.0 / W.d
    return u * dl


def scale2(dims: ConeDims, lmbda, u, inverse: bool = False):
    """H(lambda^{-1/2}) u = u / lambda (inverse: u * lambda)."""
    require_l_only(dims)
    return u * lmbda if inverse else u / lmbda


def wtw_scale_cols(dims: ConeDims, W: NTScaling, G):
    """W^{-T} applied to every column of G (B, size, n): a row scaling."""
    require_l_only(dims)
    return G / W.d[..., :, None]
