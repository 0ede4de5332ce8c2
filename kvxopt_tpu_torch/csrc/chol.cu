// Batched blocked Cholesky that returns L only (K4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of kvxopt_tpu/ops/chol.py:
//   K4  batched_cholesky (chol.py:139, body _chol_stream_kernel :115,
//       per-matrix factor _factor_inplace :41)
//
// Contract (the JAX function's): f32 in and out, n padded by the caller to
// npad = 128 * nb with identity on the padded diagonal, row-major
// (B, npad, npad) matrices factored in place; the caller takes tril and
// crops to n.  No diagonal-block inverse is returned.
//
// What the TPU kernel computes per 128 panel -- factor the diagonal block,
// invert it, L21 = A21 * L11^{-T} as one product, trailing updates as
// products -- is what the three kernels of chol_factor.cuh compute, so K4
// runs them (shared with K1) on its own launch path: the inverse of each
// panel's diagonal block lives only in a (B, 128, 128) scratch that every
// panel reuses, where K1 keeps all nb of them.  Bound, as K1, by the serial
// pivot chain of the diagonal blocks at small n and by the f32 FFMA rate
// of the trailing update at large n (notes in chol_factor.cuh).
//
// The TPU kernel streamed the B matrices through VMEM one after another
// with double-buffered DMA; here the B matrices are independent blocks of
// each grid, and nothing is staged by hand between launches.
//
// The C entry point returns cudaGetLastError(); it launches on the given
// stream, synchronises nothing and allocates nothing.

#include "chol_factor.cuh"

extern "C" {

// Factor B padded SPD matrices in place.  O: (B, npad, npad), on entry the
// matrices, on exit L in the lower triangle (the strict upper triangle of
// the trailing blocks is left as scratch; the caller takes tril).
// Yscratch: (B, 128, 128), overwritten panel by panel.
int kvx_chol(void* O, void* Yscratch, int B, int npad, void* stream)
{
    return chol_factor_blocked((float*)O, (float*)Yscratch, 0, B, npad,
                               (cudaStream_t)stream);
}

}  // extern "C"
