"""Global configuration for kvxopt_tpu_torch.

Counterpart of kvxopt_tpu/config.py.  Solver state lives in
``default_dtype`` (float64, as in the reference library); the batched
Cholesky kernels factor in ``compute_dtype`` (float32) and the results
are corrected by iterative refinement in ``default_dtype``.

float32 matrix products must run in full IEEE f32: TF32 keeps about
three decimal digits, the same loss that gave 0% convergence when the
JAX package let f32 matmuls run as bf16 passes.  Importing this module
therefore turns TF32 off for both cuBLAS and cuDNN.
"""

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

default_dtype = torch.float64
compute_dtype = torch.float32

# Exact-split (Ozaki) refinement matvecs inside the mixed KKT strategies
# (ops/ozaki.py).  Off by default; the batched mixed driver forces it on.
ozaki_refine = os.environ.get("KVXOPT_TPU_OZAKI", "0") == "1"

# One-shot exact-split-Gram correction of the f32 Cholesky factor in the
# mixed KKT strategies (kkt._mixed_core).
factor_refine = os.environ.get("KVXOPT_TPU_FACREF", "1") == "1"

# Where the front ends (solvers.coneqp/qp/conelp/lp/socp/sdp) place
# array-like inputs: the card unless the caller names another device.
# Torch tensors passed in keep their own device; where there is no card
# and no device is named, a front-end call raises.
default_device = torch.device("cuda")


def set_default_dtype(dtype):
    global default_dtype
    default_dtype = _torch_dtype(dtype)


def set_compute_dtype(dtype):
    global compute_dtype
    compute_dtype = _torch_dtype(dtype)


def set_default_device(device):
    """Set the device the front ends place array-like inputs on; returns
    the one it replaces."""
    global default_device
    old, default_device = default_device, torch.device(device)
    return old


class using_device:
    """Context manager: `with config.using_device("cpu"): ...` runs the
    front ends' array-like inputs on that device inside the block."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.old = set_default_device(self.device)
        return self.device

    def __exit__(self, *exc):
        set_default_device(self.old)


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
