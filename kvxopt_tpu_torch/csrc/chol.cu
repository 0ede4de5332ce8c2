// Batched blocked Cholesky that returns L only (K4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of kvxopt_tpu/ops/chol.py:
//   K4  batched_cholesky (chol.py:139, body _chol_stream_kernel :115,
//       per-matrix factor _factor_inplace :41)
//
// Contract (the JAX function's): A (B, n, n) f32 SPD, read in place (its
// lower triangle only); L (B, n, n) f32 written whole, zeros above the
// diagonal.  No diagonal-block inverse is returned.
//
// What the TPU kernel computes per 128 panel -- factor the diagonal block,
// invert it, L21 = A21 * L11^{-T} as one product, trailing updates as
// products -- is what K1's factorization computes, so K4 runs it
// (chol_factor.cuh, shared with K1; its L is bit-equal to K1's): the
// inverse of each panel's diagonal block lives only in a scratch of two
// (B, 128, 128) slots that the panels take in turn, where K1 keeps all nb
// of them.  What bounds it and what the design does about it: the notes in
// chol_factor.cuh.
//
// The TPU kernel streamed the B matrices through VMEM one after another
// with double-buffered DMA; here the B matrices are independent clusters
// of CTAs, or each step's launch runs them side by side.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include "chol_factor.cuh"

extern "C" {

// Factor B SPD matrices: A (B, n, n) in, L (B, n, n) out; Yscratch
// (2, B, 128, 128), overwritten panel by panel.  path as kvx_chol_ls.
int kvx_chol(const void* A, void* L, void* Yscratch, int B, int n, int path,
             void* stream)
{
    return chol_factor((const float*)A, (float*)L, (float*)Yscratch, 2, B, n,
                       path, (cudaStream_t)stream);
}

}  // extern "C"
