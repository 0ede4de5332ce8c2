// Batched blocked Cholesky with diagonal-block inverses (K1), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel batched_cholesky_ls of
// kvxopt_tpu/ops/chol_ls.py (:358, body _chol_ls_kernel :225, panel step
// _panel_factor_inverse :136).  The solves against its factor are
// chol_solve.cu (K2, L L^T X = R) and tri_solve.cu (K3, one sweep).
//
// Contract (the JAX function's): f32 in and out, n padded by the caller
// to npad = 128 * nb with identity on the padded diagonal, row-major
// (B, npad, npad) matrices, and the inverses of L's 128x128 diagonal
// blocks in a (nb, B, 128, 128) array.
//
// K1's three kernels (diagonal block, panel, trailing update) live in
// chol_factor.cuh, shared with K4 (chol.cu); see the notes there.
//
// Arithmetic: IEEE f32 FFMA on the CUDA cores with f32 accumulation.  No
// tensor-core instruction is used: Hopper takes f32 there only as TF32,
// which fails the kernels' tolerances.  A non-positive pivot gives NaN
// through rsqrtf, as lax.rsqrt does in the TPU kernel; the solver turns
// NaN into status SINGULAR.
//
// The TPU kernel advanced all B matrices through each panel in lockstep
// to amortise the TPU's serial vector-unit pivot chain.  Here the B
// matrices are independent blocks of each grid instead.
//
// The C entry point returns cudaGetLastError(); it launches on the given
// stream, synchronises nothing and allocates nothing.

#include "chol_factor.cuh"

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

// Factor B padded SPD matrices in place.  O: (B, npad, npad), on entry the
// matrices, on exit L in the lower triangle (the strict upper triangle of
// the trailing blocks is left as scratch; the caller takes tril).
// Dinv: (nb, B, 128, 128) output.
int kvx_chol_ls(void* O, void* Dinv, int B, int npad, void* stream)
{
    return chol_factor_blocked((float*)O, (float*)Dinv, (size_t)B * BS * BS,
                               B, npad, (cudaStream_t)stream);
}

}  // extern "C"
