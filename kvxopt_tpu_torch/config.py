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
