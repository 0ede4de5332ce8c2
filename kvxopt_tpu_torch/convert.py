"""Carrying problems, options and results between kvxopt_tpu and the port.

Nothing here imports jax: a JAX ConeDims or Options converts through its
attributes or its _asdict(), and arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones import ConeDims, NTScaling, block_groups
from .solvers.coneprog import Metrics, Options, _tree_map


def dims_from(obj) -> ConeDims:
    """ConeDims from a dict or any object with l / q / s attributes."""
    if isinstance(obj, ConeDims):
        return obj
    if isinstance(obj, dict):
        return ConeDims.from_dict(obj)
    return ConeDims(l=int(getattr(obj, "l", 0)),
                    q=tuple(getattr(obj, "q", ())),
                    s=tuple(getattr(obj, "s", ())))


def options_from(obj) -> Options:
    """Options from a JAX Options (or its _asdict()) or a plain dict;
    keys the port does not know are refused."""
    d = obj._asdict() if hasattr(obj, "_asdict") else dict(obj)
    unknown = set(d) - set(Options._fields)
    if unknown:
        raise ValueError(f"unknown options: {sorted(unknown)}")
    return Options(**d)


def problem_to_torch(*arrays, device="cuda", dtype=torch.float64):
    """numpy (or array-like) problem data, (P, q, G, h) or
    (P, q, G, h, A, b) -> tensors on `device`: the card unless the caller
    names another (where there is no card, that raises)."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in arrays)


def tree_from_numpy(u, device="cuda", dtype=torch.float64):
    """An element of a custom vector space in the JAX package's form (a
    pytree: dicts, lists and tuples, nested, of arrays; None an empty
    node) -> the port's: the same structure, each leaf a tensor of
    `dtype` on `device` (the card unless the caller names another).
    coneprog._tree_leaves lists the leaves in jax.tree_util's order."""
    return _tree_map(lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                               device=device), u)


def tree_to_numpy(u):
    """tree_from_numpy's inverse: the same structure with numpy leaves."""
    return _tree_map(lambda a: a.detach().cpu().numpy(), u)


def scaling_from_jax(dims, d, beta, v, r=(), rti=(), device="cuda",
                     dtype=torch.float64):
    """The port's NTScaling from the JAX package's fields, each with a
    leading batch axis (as jax.vmap returns them): d (B, l), beta a tuple
    of (B,) per q block, v a tuple of (B, m) per q block, r and rti
    tuples of (B, m, m) per s block.  The port keeps beta and v per group
    of equal-size q blocks and r and rti per group of equal-order s
    blocks.  The tensors go to the card unless the caller names another
    device."""
    dims = dims_from(dims)
    qgroups, sgroups = block_groups(dims)

    def per_group(groups, fields):
        return tuple(torch.tensor(
            np.stack([np.asarray(fields[k]) for k in g.idxs], 1),
            dtype=dtype, device=device) for g in groups)
    return NTScaling(
        d=torch.tensor(np.asarray(d), dtype=dtype, device=device),
        beta=per_group(qgroups, beta), v=per_group(qgroups, v),
        r=per_group(sgroups, r), rti=per_group(sgroups, rti))


def _per_block(groups, fields, nblocks, pick):
    """Per-group fields (one tensor per group, the group's blocks on axis
    1) -> one entry per block, pick(field, j) taking block j."""
    out = [None] * nblocks
    for gi, g in enumerate(groups):
        for j, k in enumerate(g.idxs):
            out[k] = pick(fields[gi], j)
    return tuple(out)


def scaling_to_jax(dims, W):
    """(d, beta, v, r, rti) of the port's NTScaling in the JAX package's
    layout, numpy with a leading batch axis: beta and v one entry per q
    block, r and rti one per s block."""
    dims = dims_from(dims)
    qgroups, sgroups = block_groups(dims)

    def pick(f, j):
        return f[:, j].cpu().numpy()
    return (W.d.cpu().numpy(),
            *(_per_block(qgroups, fields, len(dims.q), pick)
              for fields in (W.beta, W.v)),
            *(_per_block(sgroups, fields, len(dims.s), pick)
              for fields in (W.r, W.rti)))


def scaling_instance(dims, W, lane=0):
    """One lane of the port's NTScaling in the JAX package's
    single-instance layout, as tensors on W's device: d (l,), beta a
    tuple of 0-d tensors and v a tuple of (m,) per q block, r and rti
    tuples of (m, m) per s block.  A custom kktsolver of the front ends
    receives this."""
    dims = dims_from(dims)
    qgroups, sgroups = block_groups(dims)

    def pick(f, j):
        return f[lane, j]
    return NTScaling(
        d=W.d[lane],
        beta=_per_block(qgroups, W.beta, len(dims.q), pick),
        v=_per_block(qgroups, W.v, len(dims.q), pick),
        r=_per_block(sgroups, W.r, len(dims.s), pick),
        rti=_per_block(sgroups, W.rti, len(dims.s), pick))


def scaling_batch(dims, W, device):
    """scaling_instance's inverse: one instance in the JAX package's
    single-instance layout (fields tensors or arrays) -> the port's
    NTScaling as a batch of one on `device`."""
    dims = dims_from(dims)
    qgroups, sgroups = block_groups(dims)

    def t(a):
        return torch.as_tensor(a if isinstance(a, torch.Tensor)
                               else np.array(a), device=device)

    def per_group(groups, fields):
        return tuple(torch.stack([t(fields[k]) for k in g.idxs])[None]
                     for g in groups)
    return NTScaling(d=t(W.d)[None], beta=per_group(qgroups, W.beta),
                     v=per_group(qgroups, W.v), r=per_group(sgroups, W.r),
                     rti=per_group(sgroups, W.rti))


def state_to_numpy(out):
    """The port's (x, y, s, z, iterations, status, metrics) -> numpy, in
    the JAX package's layout (metrics a Metrics of arrays)."""
    def cpu(t):
        return t.detach().cpu().numpy()
    x, y, s, z, it, status, m = out
    return (cpu(x), cpu(y), cpu(s), cpu(z), cpu(it), cpu(status),
            Metrics(*(cpu(a) for a in m)))


def lp_state_to_numpy(out):
    """The port's conelp state (x, y, s, z, tau, kappa, iterations,
    status, metrics) -> numpy, in the JAX package's layout (metrics a
    dict of arrays)."""
    def cpu(t):
        return t.detach().cpu().numpy()
    *arrays, m = out
    return (*(cpu(a) for a in arrays), {k: cpu(v) for k, v in m.items()})
