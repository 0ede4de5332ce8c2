// Batched blocked Cholesky with diagonal-block inverses (K1), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel batched_cholesky_ls of
// kvxopt_tpu/ops/chol_ls.py (:358, body _chol_ls_kernel :225, panel step
// _panel_factor_inverse :136).  The solves against its factor are
// chol_solve.cu (K2, L L^T X = R) and tri_solve.cu (K3, one sweep).
//
// Contract (the JAX function's): A (B, n, n) f32 SPD, read in place (its
// lower triangle only); L (B, n, n) f32 written whole, zeros above the
// diagonal; the inverses of L's 128x128 diagonal blocks in a
// (nb, B, 128, 128) array, nb = ceil(n / 128), identity on the padded
// diagonal of the last block and zeros off it.  Nothing is padded or
// copied around the kernel.
//
// The factorization (one launch per call where n <= 128 and, through a
// cluster of CTAs per matrix, where n <= 512; else three per 128-wide
// panel step) lives in chol_factor.cuh, shared with K4 (chol.cu); see the
// design notes there.
//
// The TPU kernel advanced all B matrices through each panel in lockstep
// to amortise the TPU's serial vector-unit pivot chain.  Here the B
// matrices are independent clusters of CTAs, or each step's launch runs
// their blocks and tiles side by side.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include "chol_factor.cuh"

extern "C" {

// Factor B SPD matrices: A (B, n, n) in, L (B, n, n) and Dinv
// (nb, B, 128, 128) out.  path 0: one cluster launch (n > 128); path 1:
// one launch per panel step.  n <= 128 is one launch either way.
int kvx_chol_ls(const void* A, void* L, void* Dinv, int B, int n, int path,
                void* stream)
{
    return chol_factor((const float*)A, (float*)L, (float*)Dinv,
                       (n + BS - 1) / BS, B, n, path, (cudaStream_t)stream);
}

}  // extern "C"
