"""Carrying problems, options and results between kvxopt_tpu and the port.

Nothing here imports jax: a JAX ConeDims or Options converts through its
attributes or its _asdict(), and arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones import ConeDims
from .solvers.coneprog import Metrics, Options


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


def problem_to_torch(P, q, G, h, device="cpu", dtype=torch.float64):
    """numpy (or array-like) problem data -> tensors on `device`."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (P, q, G, h))


def state_to_numpy(out):
    """The port's (x, y, s, z, iterations, status, metrics) -> numpy, in
    the JAX package's layout (metrics a Metrics of arrays)."""
    def cpu(t):
        return t.detach().cpu().numpy()
    x, y, s, z, it, status, m = out
    return (cpu(x), cpu(y), cpu(s), cpu(z), cpu(it), cpu(status),
            Metrics(*(cpu(a) for a in m)))
