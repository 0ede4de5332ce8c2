"""Helpers of the example programs: the user's numpy data as tensors on
the device a closure is handed, and results back as numpy."""

from types import SimpleNamespace

import numpy as np
import torch


class OnDevice:
    """Numpy arrays as float tensors on the device and in the dtype of a
    tensor a closure is handed (the x of an operator, W.d of a
    kktsolver), made once per (device, dtype): `T = data(v)`, then
    `T.A @ v`."""

    def __init__(self, **arrays):
        self._arrays = {k: np.asarray(v, dtype=np.float64)
                        for k, v in arrays.items()}
        self._made = {}

    def __call__(self, like):
        key = (like.device, like.dtype)
        if key not in self._made:
            self._made[key] = SimpleNamespace(**{
                k: torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for k, a in self._arrays.items()})
        return self._made[key]


def to_numpy(v):
    """A result vector (a tensor on any device, a matrix or an array) as
    a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)
