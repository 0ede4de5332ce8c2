// Batched blocked Cholesky with diagonal-block inverses (K1) and the
// L L^T solve against that factor (K2), for Hopper (sm_90a).
//
// These replace the Pallas TPU kernels of kvxopt_tpu/ops/chol_ls.py:
//   K1  batched_cholesky_ls (chol_ls.py:358, body _chol_ls_kernel :225,
//       panel step _panel_factor_inverse :136)
//   K2  chol_solve_ls (chol_ls.py:517, body _solve_kernel :477 with
//       _fwd_sweep :417 and _bwd_sweep :446)
// The single sweep K3 (tri_solve_ls) is tri_solve.cu.
//
// Contract (the JAX functions'): f32 in and out, n padded by the caller
// to npad = 128 * nb with identity on the padded diagonal, row-major
// (B, npad, npad) matrices, and the inverses of L's 128x128 diagonal
// blocks in a (nb, B, 128, 128) array.  Right-hand sides are passed
// transposed, (B, kpad, npad), so one column of X is contiguous.
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
// C entry points return cudaGetLastError(); they launch on the given
// stream, synchronise nothing and allocate nothing.

#include <stdint.h>

#include "chol_factor.cuh"

// ---------------------------------------------------------------------------
// K2: block substitution sweeps against (L, Dinv), forward then backward.
//
// One CTA per (matrix, chunk of KC right-hand-side columns), 512 threads.
// The chunk of X lives in shared memory for the whole sweep.  Each block
// step is acc = r_i - band * z, then z_i = Dinv_i * acc (forward) or
// Dinv_i^T * acc (backward): nothing is inverted per solve.
//   forward:  band = L[i-block, :bi], read row-wise, one warp per row,
//             coalesced along the row, warp-shuffle reduction;
//   backward: band = L[hi:, i-block]^T, read as rows of L, one thread per
//             column of the block and 4 partial sums over t, coalesced.
// At KC = 1 (the solver's PCG) a sweep is one pass over half of L and is
// bound by device-memory bandwidth; at KC = 8 (K^-1 A^T, k = p) the k / 8
// chunks of every matrix read L from L2.
// ---------------------------------------------------------------------------

#define SW_THREADS 512
#define SW_WARPS (SW_THREADS / 32)
#define SW_PARTS (SW_THREADS / BS)

template <int KC>
__device__ __forceinline__ void warp_sum(float (&a)[KC])
{
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            a[c] += __shfl_down_sync(0xffffffffu, a[c], o);
}

template <int KC>
__global__ void __launch_bounds__(SW_THREADS)
sweep_kernel(const float* __restrict__ L, const float* __restrict__ Dinv,
             float* __restrict__ Z, int B, int npad, int kpad)
{
    extern __shared__ float smem[];
    float* Zs = smem;                   // KC x npad
    float* acc = Zs + KC * npad;        // KC x BS
    float* part = acc + KC * BS;        // SW_PARTS x KC x BS

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int nb = npad / BS;
    const float* Lb = L + (size_t)b * npad * npad;
    float* Zg = Z + ((size_t)b * kpad + (size_t)blockIdx.x * KC) * npad;

    for (int idx = tid; idx < KC * npad; idx += SW_THREADS) Zs[idx] = Zg[idx];
    __syncthreads();

    {   // forward: L y = r
        for (int i = 0; i < nb; ++i) {
            const int bi = i * BS;
            const float* Di = Dinv + ((size_t)i * B + b) * BS * BS;
            for (int r = warp; r < BS; r += SW_WARPS) {
                float a[KC];
#pragma unroll
                for (int c = 0; c < KC; ++c) a[c] = 0.0f;
                const float* Lr = Lb + (size_t)(bi + r) * npad;
                for (int t = lane; t < bi; t += 32) {
                    float l = Lr[t];
#pragma unroll
                    for (int c = 0; c < KC; ++c)
                        a[c] = fmaf(l, Zs[c * npad + t], a[c]);
                }
                warp_sum<KC>(a);
                if (lane == 0) {
#pragma unroll
                    for (int c = 0; c < KC; ++c)
                        acc[c * BS + r] = Zs[c * npad + bi + r] - a[c];
                }
            }
            __syncthreads();
            for (int r = warp; r < BS; r += SW_WARPS) {
                float a[KC];
#pragma unroll
                for (int c = 0; c < KC; ++c) a[c] = 0.0f;
                for (int s = lane; s < BS; s += 32) {
                    float d = Di[r * BS + s];
#pragma unroll
                    for (int c = 0; c < KC; ++c)
                        a[c] = fmaf(d, acc[c * BS + s], a[c]);
                }
                warp_sum<KC>(a);
                if (lane == 0) {
#pragma unroll
                    for (int c = 0; c < KC; ++c) Zs[c * npad + bi + r] = a[c];
                }
            }
            __syncthreads();
        }
    }

    {   // backward: L^T x = y
        const int r = tid % BS, p = tid / BS;
        for (int i = nb - 1; i >= 0; --i) {
            const int bi = i * BS, hi = bi + BS;
            const float* Di = Dinv + ((size_t)i * B + b) * BS * BS;
            float a[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) a[c] = 0.0f;
            for (int t = hi + p; t < npad; t += SW_PARTS) {
                float l = Lb[(size_t)t * npad + bi + r];
#pragma unroll
                for (int c = 0; c < KC; ++c)
                    a[c] = fmaf(l, Zs[c * npad + t], a[c]);
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) part[(p * KC + c) * BS + r] = a[c];
            __syncthreads();
            if (tid < BS) {
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    float s = 0.0f;
                    for (int q = 0; q < SW_PARTS; ++q)
                        s += part[(q * KC + c) * BS + r];
                    acc[c * BS + r] = Zs[c * npad + bi + r] - s;
                }
            }
            __syncthreads();
#pragma unroll
            for (int c = 0; c < KC; ++c) a[c] = 0.0f;
            for (int s = p; s < BS; s += SW_PARTS) {
                float d = Di[s * BS + r];
#pragma unroll
                for (int c = 0; c < KC; ++c)
                    a[c] = fmaf(d, acc[c * BS + s], a[c]);
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) part[(p * KC + c) * BS + r] = a[c];
            __syncthreads();
            if (tid < BS) {
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    float s = 0.0f;
                    for (int q = 0; q < SW_PARTS; ++q)
                        s += part[(q * KC + c) * BS + r];
                    Zs[c * npad + bi + r] = s;
                }
            }
            __syncthreads();
        }
    }

    for (int idx = tid; idx < KC * npad; idx += SW_THREADS) Zg[idx] = Zs[idx];
}

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

// Shared memory one sweep CTA needs, in bytes (0 for an unsupported kc).
int kvx_sweep_smem(int npad, int kc)
{
    if (kc != 1 && kc != 8) return 0;
    return (kc * npad + kc * BS + SW_PARTS * kc * BS) * (int)sizeof(float);
}

// Solve L L^T Z = Z for Z (B, kpad, npad) in place against (L, Dinv); kc
// in {1, 8} columns per CTA, kpad a multiple of kc.
int kvx_sweep(void* L, void* Dinv, void* Z, int B, int npad, int kpad,
              int kc, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    const int smem = kvx_sweep_smem(npad, kc);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    dim3 grid(kpad / kc, B);
    if (kc == 1) {
        cudaFuncSetAttribute((const void*)sweep_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
        sweep_kernel<1><<<grid, SW_THREADS, smem, s>>>(
            (const float*)L, (const float*)Dinv, (float*)Z, B, npad, kpad);
    } else {
        cudaFuncSetAttribute((const void*)sweep_kernel<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
        sweep_kernel<8><<<grid, SW_THREADS, smem, s>>>(
            (const float*)L, (const float*)Dinv, (float*)Z, B, npad, kpad);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
