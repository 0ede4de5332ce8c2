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
import sys
import threading
import types

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
# and no device is named, a front-end call raises.  `default_device`
# reads the calling thread's device: the innermost using_device block of
# that thread, else the process-wide one (set_default_device, or an
# assignment to config.default_device), as jax.default_device is
# thread-local over jax_default_device.
_process_device = torch.device("cuda")
_thread = threading.local()


def _default_device():
    dev = getattr(_thread, "device", None)
    return _process_device if dev is None else dev


def set_default_dtype(dtype):
    """Set the dtype of the solver state (a torch dtype, a numpy dtype or
    its name)."""
    global default_dtype
    default_dtype = _torch_dtype(dtype)


def set_compute_dtype(dtype):
    """Set the dtype the batched Cholesky kernels factor in."""
    global compute_dtype
    compute_dtype = _torch_dtype(dtype)


def set_default_device(device):
    """Set the process-wide device the front ends place array-like inputs
    on; returns the one it replaces."""
    global _process_device
    old, _process_device = _process_device, torch.device(device)
    return old


class using_device:
    """Context manager: `with config.using_device("cpu"): ...` runs the
    front ends' array-like inputs on that device inside the block, in the
    calling thread only."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.old = getattr(_thread, "device", None)
        _thread.device = self.device
        return self.device

    def __exit__(self, *exc):
        _thread.device = self.old


class _Config(types.ModuleType):
    @property
    def default_device(self):
        return _default_device()

    @default_device.setter
    def default_device(self, device):
        set_default_device(device)


sys.modules[__name__].__class__ = _Config


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


# ---------------------------------------------------------------------------
# Executor dispatch: the card for work it does faster, the CPU for the rest.
#
# A single-instance interior-point solve of a small KKT system is bound
# by kernel launches and host round trips on the card, not by
# arithmetic, and the host's f64 LAPACK finishes it first.  The front
# ends (coneqp, conelp, cpl, cp, gp and the natural forms over them)
# therefore run a solve whose KKT system has an order n + m + p
# (variables, rows of h and nonlinear constraints, rows of b;
# solvers.coneprog._kkt_order) below host_dispatch_threshold on the CPU,
# before any array is placed; the batch drivers do the same per instance
# below host_dispatch_threshold_batched.  The JAX package sizes by n
# alone; the order is used here because the CPU's time grows with m as
# well: on the card below, the PWL models of op.solve at n = 251 and 500
# (m = 2000 and 1500) beat the CPU in 5 of 6 timings (82 against 121 ms
# at n = 251 in one run, 150 against 136 in the other), where the
# orthant QP at n = 128 (m = 256) lost, 28 against 24 ms.  The route is
# chosen by size alone: a threshold of 0 (or KVXOPT_TPU_HOST_DISPATCH=0) keeps
# everything on the card, and where the card is the default device and
# there is none, nothing is routed and the call raises as before.
#
# HOST_DISPATCH and HOST_DISPATCH_BATCHED are the card's own crossovers,
# from phase 18 of chip_smoke.py: the smallest order from which the card
# beat the CPU at every larger one swept (medians of 5 warm calls), on
#   card: NVIDIA H100 80GB HBM3, 700.00 W;
#   host: GenuineIntel family 6, model 207 (the machine gives no model
#         name), 8 logical CPUs with AVX-512 and AMX,
#         torch.get_num_threads() = 8.
# Single instance: qp and lp on the orthant (m = 2n, order 3n) at n = 4
# ... 512.  Over six runs the card won both from order 768 (n = 256)
# twice and from 1536 (n = 512) four times; at 768 it won 8 of the 12 qp
# and lp timings (losing by at most 36%, winning by up to 48%), so the
# default is 768.  The repo's own solves agree: the card won 9 of 10
# timings of the PWL models through op.solve (orders 2000 to 6250), the
# CPU the userguide problems, the userguide gp and acent2 (orders 6 to
# 17) by 1.7x or more; the seeded gp (order 320, sent to the CPU) was a tie, 67
# against 70-72 ms on the card.  Batched: B = 16
# chol2 QP and LP batches at n = 16 ... 512: the card won from n = 128
# (order 384) in all six runs.
# ---------------------------------------------------------------------------

HOST_DISPATCH = 768
HOST_DISPATCH_BATCHED = 384
host_dispatch_threshold = int(
    os.environ.get("KVXOPT_TPU_HOST_DISPATCH", HOST_DISPATCH))
host_dispatch_threshold_batched = int(
    os.environ.get("KVXOPT_TPU_HOST_DISPATCH_BATCHED", HOST_DISPATCH_BATCHED))


def host_device():
    """The executor of sub-threshold work: the CPU."""
    return torch.device("cpu")


def accelerator_is_host():
    """True when the default device is not the card: there is nothing to
    route away from."""
    return _default_device().type != "cuda"


def _card_missing():
    return (_default_device().type == "cuda"
            and not torch.cuda.is_available())


def dispatch_device(work_size):
    """The executor of a single-instance solve whose KKT system has order
    ~work_size: None (stay on config.default_device) at or above
    host_dispatch_threshold, host_device() below it.  None whenever the
    threshold is 0 or less, the default device is already the host, or
    the default device is the card and there is none."""
    if (host_dispatch_threshold <= 0 or accelerator_is_host()
            or _card_missing()):
        return None
    if work_size >= host_dispatch_threshold:
        return None
    return host_device()


def dispatch_device_batched(work_size):
    """The executor of a batched solve whose instances' KKT systems have
    order ~work_size, as dispatch_device with
    host_dispatch_threshold_batched; off too where the single-instance
    threshold is 0 or less."""
    if (host_dispatch_threshold <= 0 or host_dispatch_threshold_batched <= 0
            or accelerator_is_host() or _card_missing()):
        return None
    if work_size >= host_dispatch_threshold_batched:
        return None
    return host_device()
