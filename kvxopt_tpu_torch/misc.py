"""Cone-algebra utility layer with the reference's misc.py surface
(reference src/python/misc.py: compute_scaling :250, update_scaling :422,
scale/scale2, pack/unpack, sdot/snrm2, sprod/sinv/ssqr, max_step, sgemv,
and the five kkt_* strategies :1055-1570).

Counterpart of kvxopt_tpu/misc.py, not a copy: functional adapters over
the port's batched cones and kkt, which take a leading batch axis.  Each
function here takes single cone vectors, adds a batch of one and drops
it from the result; dims may be a ConeDims or the reference's
{'l': ..., 'q': [...], 's': [...]} dict, and mnl adds that many leading
orthant entries.  Array-like inputs go to the device of the first tensor
among the arguments, else to config.default_device (the card); tensors
keep their own device.  sdot, snrm2, max_step, jdot and jnrm2 return
Python floats, one host sync each.

W is in the JAX package's single-instance layout
(convert.scaling_instance): d (l,), beta a tuple of 0-d tensors and v a
tuple of (m,) per q block, r and rti tuples of (m, m) per s block.  A
custom kktsolver of the front ends receives W so, and compute_scaling and
update_scaling return it so, so that scale(x, W, dims) works inside one.

The kkt_* functions return factor(W, H=None, Df=None) -> solve(bx, by,
bz) on single vectors.  coneqp calls a custom kktsolver with W alone, so
P reaches a kkt_* factor only through H:
    kktsolver=lambda W, H=None, Df=None: misc.kkt_chol(G, dims, A)(W, H=P)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cones as _c
from . import kkt as _k
from .cones import ConeDims, NTScaling  # noqa: F401
from .convert import scaling_batch, scaling_instance
from .solvers.coneprog import _solve_device


def _dims(dims, mnl=0):
    d = ConeDims.from_dict(dims)
    return d.with_extra_l(mnl) if mnl else d


def _tensors(*xs):
    """The arguments as tensors on one device (None stays None):
    tensors as they are, array-likes on the first tensor's device, else
    on config.default_device; integer data become float64."""
    dev = _solve_device(*xs)
    out = []
    for x in xs:
        if x is None or isinstance(x, torch.Tensor):
            out.append(x)
            continue
        a = np.asarray(x)
        if a.dtype.kind not in "fc":
            a = a.astype(np.float64)
        out.append(torch.as_tensor(a, device=dev))
    return out


def _batch(*xs):
    """The arguments as tensors with a leading batch axis of one."""
    return [x[None] for x in _tensors(*xs)]


def sdot(x, y, dims, mnl=0):
    return float(_c.sdot(_dims(dims, mnl), *_batch(x, y))[0])


def snrm2(x, dims, mnl=0):
    return float(_c.snrm2(_dims(dims, mnl), *_batch(x))[0])


def sprod(x, y, dims, mnl=0, diag="N"):
    return _c.sprod(_dims(dims, mnl), *_batch(x, y), diag=(diag == "D"))[0]


def sinv(x, y, dims, mnl=0):
    """x := y \\o x, the s blocks of y diagonal."""
    xb, yb = _batch(x, y)
    return _c.sinv(_dims(dims, mnl), yb, xb)[0]


def ssqr(x, dims, mnl=0):
    return _c.ssqr(_dims(dims, mnl), *_batch(x))[0]


def max_step(x, dims, mnl=0, sigma=None):
    return float(_c.max_step(_dims(dims, mnl), *_batch(x))[0])


def compute_scaling(s, z, lmbda=None, dims=None, mnl=0):
    """(W, lambda) of a strictly feasible pair (s, z), W in the
    single-instance layout."""
    d = _dims(dims, mnl)
    W, lam = _c.compute_scaling(d, *_batch(s, z))
    return scaling_instance(d, W), lam[0]


def update_scaling(W, lmbda, s, z, dims=None, mnl=0):
    """(W, lambda) recomputed from the unscaled pair (s, z), as the JAX
    package's update_scaling does."""
    if dims is None:
        raise ValueError("dims required")
    d = _dims(dims, mnl)
    sb, zb = _batch(s, z)
    W, lam = _c.update_scaling(d, scaling_batch(d, W, sb.device), sb, zb)
    return scaling_instance(d, W), lam[0]


def scale(x, W, dims, trans="N", inverse="N", mnl=0):
    d = _dims(dims, mnl)
    (xb,) = _batch(x)
    return _c.scale(d, scaling_batch(d, W, xb.device), xb,
                    trans=(trans == "T"), inverse=(inverse == "I"))[0]


def scale2(lmbda, x, dims, mnl=0, inverse="N"):
    return _c.scale2(_dims(dims, mnl), *_batch(lmbda, x),
                     inverse=(inverse == "I"))[0]


def _packed(d, device):
    """(index, off): for each entry of packed storage its index in full
    storage, and whether it is an off-diagonal s entry.  The s blocks
    are read as the reference's column-major lower triangle, column by
    column (misc_solvers.c:404): block entry (c, r), r >= c, at buffer
    index c*m + r."""
    nlq = d.l + sum(d.q)
    index = [torch.arange(nlq, device=device)]
    off = [torch.zeros(nlq, dtype=torch.bool, device=device)]
    for ofs, m in zip(d.sofs, d.s):
        c, r = torch.triu_indices(m, m, device=device)
        index.append(ofs + c * m + r)
        off.append(c != r)
    return torch.cat(index), torch.cat(off)


def _weights(off, scale, like):
    w = torch.ones(off.shape, dtype=like.dtype, device=off.device)
    w[off] = scale
    return w


def pack(x, dims, mnl=0):
    """Packed storage with the reference's element order: each s block
    as its lower triangle column by column, off-diagonals scaled by
    sqrt 2 (dot-product preserving)."""
    (x,) = _tensors(x)
    index, off = _packed(_dims(dims, mnl), x.device)
    return x[index] * _weights(off, math.sqrt(2.0), x)


def pack2(x, dims, mnl=0):
    """The reference's in-place pack2 (misc_solvers.c:468) as a function:
    per column of x the s components are repacked into packed storage
    within a buffer of the same shape; entries past the packed length
    keep their values.  x is a cone vector or a matrix whose columns
    are cone vectors."""
    (x,) = _tensors(x)
    d = _dims(dims, mnl)
    X = x[:, None] if x.ndim == 1 else x
    index, off = _packed(d, x.device)
    nlq = d.l + sum(d.q)
    out = X.clone()
    out[nlq:index.numel()] = X[index[nlq:]] * _weights(
        off[nlq:], math.sqrt(2.0), X)[:, None]
    return out[:, 0] if x.ndim == 1 else out


def unpack(x, dims, mnl=0):
    """Inverse of pack (misc_solvers.c:544): the lower triangle of each
    s block in full column-major storage; the strict upper triangle
    stays zero."""
    (x,) = _tensors(x)
    d = _dims(dims, mnl)
    index, off = _packed(d, x.device)
    out = x.new_zeros((d.size,))
    out[index] = x[:index.numel()] * _weights(off, 1.0 / math.sqrt(2.0), x)
    return out


def symm(x, dims, mnl=0):
    return _c.symm(_dims(dims, mnl), *_batch(x))[0]


def sgemv(A, x, y, dims, trans="N", alpha=1.0, beta=0.0, mnl=0):
    """alpha A x + beta y over cone vectors (reference misc.py sgemv),
    returned."""
    A, x, y = _tensors(A, x, y)
    if trans == "T":
        return alpha * (A.T @ x) + beta * y
    return alpha * (A @ x) + beta * y


def jdot(x, y=None):
    x, y = _tensors(x, y)
    if y is None:
        return float(_c.jdot(x))
    return float(x[0] * y[0] - torch.dot(x[1:], y[1:]))


def jnrm2(x):
    return float(_c.jnrm2(*_tensors(x)))


def _kkt(name, G, dims, A, mnl=0, **kw):
    """kkt.make_kkt_solver on one instance: factor(W, H=None, Df=None)
    with W in the single-instance layout, H (n, n) and Df (mnl, n), ->
    solve(bx, by, bz) on single vectors."""
    d = ConeDims.from_dict(dims)
    G, A = _tensors(G, A)
    factor_b = _k.make_kkt_solver(name, d, G[None],
                                  None if A is None else A.to(G)[None],
                                  mnl=mnl, **kw)

    def factor(W, H=None, Df=None):
        H, Df = (None if M is None else _tensors(M, G)[0].to(G)[None]
                 for M in (H, Df))
        solve_b = factor_b(scaling_batch(d, W, G.device), H, Df)

        def solve(bx, by, bz):
            bx, by, bz = (v.to(G)[None] for v in _tensors(bx, by, bz, G)[:3])
            return tuple(u[0] for u in solve_b(bx, by, bz))
        return solve
    return factor


# KKT strategies with the reference's names (misc.py:1055-1570)
def kkt_ldl(G, dims, A, mnl=0, kktreg=0.0):
    return _kkt("ldl", G, dims, A, mnl, reg=kktreg)


def kkt_ldl2(G, dims, A, mnl=0, kktreg=0.0):
    return _kkt("ldl2", G, dims, A, mnl, reg=kktreg)


def kkt_chol(G, dims, A, mnl=0):
    return _kkt("chol", G, dims, A, mnl)


def kkt_chol2(G, dims, A, mnl=0):
    return _kkt("chol2", G, dims, A, mnl)


def kkt_qr(G, dims, A, mnl=0):
    return _kkt("qr", G, dims, A, mnl)


use_C = True  # parity flag: the reference toggles its C kernels
              # (misc.py:25); here the batched torch path always runs.
