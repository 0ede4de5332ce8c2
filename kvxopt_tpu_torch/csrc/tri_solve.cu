// Batched triangular solve against the blocked Cholesky factor (K3), for
// Hopper (sm_90a): L X = R or L^T X = R for wide R (k up to n and beyond),
// through the stored inverses of L's 128x128 diagonal blocks.
//
// Replaces the Pallas TPU kernel tri_solve_ls of kvxopt_tpu/ops/chol_ls.py
// (:592; body _tri_kernel :498, launched per chunk of k by _tri_chunk :564).
//
// Contract (the JAX function's): L (B, n, n) f32 row-major and lower
// triangular, Dinv (nb, B, 128, 128) f32 with nb = ceil(n / 128), R
// (B, n, k) f32 with unit column stride and the batch and row strides
// given, X (B, n, k) f32 contiguous.  Rows and columns of L beyond n act
// as the identity: the kernel reads no padded copy of L, it zero-fills
// what lies beyond n (or beyond k) as it copies.  Nothing is inverted.
//
// Math, per 128-row block i (bi = 128 i, hi = bi + 128):
//   forward  (L X = R):   X_i = Dinv_i   (R_i - L[bi:hi, 0:bi] X[0:bi])
//   backward (L^T X = R): X_i = Dinv_i^T (R_i - L[hi:n, bi:hi]^T X[hi:n])
// Columns of X are independent; each block step is two small GEMMs on one
// chain that runs along i.
//
// What bounds it.  At the factor-refinement shape (B=16, n=k=512, forward)
// a call is 2.68 GFLOP: band products sum_i 128 * 128 i * 512 MACs over
// i = 0..3 (50.3M per matrix) and Dinv products 4 * 128 * 128 * 512 MACs
// (33.6M per matrix).  That is about 40 us at the card's 67 TFLOP/s f32
// FFMA peak, so the kernel is meant to be bound by FFMA issue.  The sweep
// it replaces (chol_ls.cu, 8 columns per CTA) issued one shared-memory
// load per FFMA and a warp-shuffle reduction per row, and reached about
// 8% of that peak.
//
// Design.
//  1. Grid: one CTA of 256 threads per (matrix, tile of KC = 16 * TN
//     columns of X), KC = 64 or 32; the CTA walks the block chain itself
//     and nothing is carried between CTAs.
//  2. Register tiling: the 128 x KC accumulator of the current block lives
//     in registers, 8 x TN outputs per thread (rows ty*4 + {0..3} and
//     64 + ty*4 + {0..3}, columns tx*TN ..).  Per 4 steps of depth a
//     thread loads 8 float4 of A and 4 vectors of TN values of B from
//     shared memory and issues 32 * TN FFMAs: at TN = 4, 128 FFMAs for 12
//     shared loads, against 1 each before, and no shuffles.
//  3. Ring: the operands are streamed through TS_STAGES stages of shared
//     memory with 16-byte cp.async.cg (4-byte cp.async.ca where n, k or a
//     stride is not a multiple of 4), zero-filling beyond n and k.  A band
//     stage holds a 128 x 32 chunk of L and the 32 x KC chunk of solved X
//     rows it multiplies; then the four 128 x 32 chunks of Dinv_i follow
//     through the same ring against the accumulator, staged once in
//     shared memory (Cs).  Copies of chunk q + 2 overlap the FFMAs of
//     chunk q.  The ring restarts at each block step: the next step's
//     band ends on the X_i just solved.
//  4. No cap on n from shared memory: each solved X_i goes to device
//     memory, and later block steps of the same CTA read it back through
//     the ring from L2 (visible after __syncthreads; cp.async.cg reads
//     L2).  Shared memory per CTA is 3 x 26 KB of ring + 32 KB of Cs at
//     KC = 64, whatever n is.
//  5. Transposition in staging: the forward A operands (L's band rows,
//     Dinv_i) are copied as 128 rows x 32 (row stride 36 floats, no bank
//     conflicts for the float4 reads along the depth); the backward ones
//     (L[t, bi:hi], rows of Dinv_i, i.e. A^T) as 32 rows x 128 and read
//     as float4 along the rows.  One template, TRANS.
//  6. No staging of R: the kernel reads R_i straight into the accumulator
//     and writes X_i in their (B, n, k) row-major layouts, KC * 4
//     contiguous bytes per row, masked at the ragged k edge.
//  7. Precision: IEEE f32 FFMA with f32 accumulation, as in K1, K2 and K4.
//     No tensor-core instruction: TF32 fails the tolerances.
//
// The C entry point returns cudaGetLastError(); it launches on the given
// stream, synchronises nothing and allocates nothing.

#include "common.cuh"

namespace {

constexpr int TS_BS = 128;                  // diagonal block (Dinv contract)
constexpr int TS_KT = 32;                   // depth of one ring chunk
constexpr int TS_THREADS = 256;
constexpr int TS_STAGES = 3;
constexpr int TS_AST = TS_KT + 4;           // row stride, 128 x 32 A chunk
constexpr int TS_A = TS_BS * TS_AST;        // floats per A stage (>= 32*128)

__device__ __forceinline__ int row_of(int j, int ty)
{
    return (j >> 2) * 64 + ty * 4 + (j & 3);
}

template <int TN>
__device__ __forceinline__ void lds(float (&v)[TN], const float* p)
{
    if constexpr (TN == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x; v[1] = t.y;
    }
}

template <int TN>
__device__ __forceinline__ void sts(float* p, const float (&v)[TN])
{
    if constexpr (TN == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// acc (+/-)= A * Bm over one chunk of depth TS_KT.  A is a 128 x 32 chunk
// (row stride TS_AST) when !TRANS, its transpose 32 x 128 when TRANS; Bm is
// 32 x KC with row stride KC.
template <bool TRANS, int TN, bool SUB>
__device__ __forceinline__ void chunk_fma(float (&acc)[8][TN], const float* a,
                                          const float* bm, int ty, int tx)
{
    constexpr int KC = 16 * TN;
#pragma unroll
    for (int kk = 0; kk < TS_KT; kk += 4) {
        float av[4][8];     // av[u][j]: row row_of(j), depth kk + u
        if (!TRANS) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float4 t = *reinterpret_cast<const float4*>(
                    a + row_of(j, ty) * TS_AST + kk);
                av[0][j] = t.x; av[1][j] = t.y; av[2][j] = t.z; av[3][j] = t.w;
            }
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float4 t = *reinterpret_cast<const float4*>(
                        a + (kk + u) * TS_BS + h * 64 + ty * 4);
                    av[u][4 * h] = t.x; av[u][4 * h + 1] = t.y;
                    av[u][4 * h + 2] = t.z; av[u][4 * h + 3] = t.w;
                }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            float bv[TN];
            lds<TN>(bv, bm + (kk + u) * KC + tx * TN);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float x = SUB ? -av[u][j] : av[u][j];
#pragma unroll
                for (int c = 0; c < TN; ++c)
                    acc[j][c] = fmaf(x, bv[c], acc[j][c]);
            }
        }
    }
}

template <bool TRANS, bool VEC, int TN>
__global__ void __launch_bounds__(TS_THREADS, 2)
tri_kernel(const float* __restrict__ L, const float* __restrict__ Dinv,
           const float* __restrict__ R, float* __restrict__ X, int B, int n,
           int k, long long sRb, long long sRr)
{
    constexpr int KC = 16 * TN;
    constexpr int NDQ = TS_BS / TS_KT;          // Dinv chunks per block
    extern __shared__ __align__(16) float smem[];
    float* As = smem;                           // TS_STAGES x TS_A
    float* Bs = As + TS_STAGES * TS_A;          // TS_STAGES x TS_KT x KC
    float* Cs = Bs + TS_STAGES * TS_KT * KC;    // 128 x KC

    const int b = blockIdx.y, c0 = blockIdx.x * KC;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int nb = (n + TS_BS - 1) / TS_BS;
    const int vc = k - c0;                      // valid columns of the tile
    const float* Lb = L + (size_t)b * n * n;
    const float* Rb = R + b * sRb + c0;
    float* Xb = X + (size_t)b * n * k + c0;

    float acc[8][TN];

    for (int step = 0; step < nb; ++step) {
        const int i = TRANS ? nb - 1 - step : step;
        const int bi = i * TS_BS;
        // band rows (forward: columns) of L and rows of X: [t_lo, t_hi)
        const int t_lo = TRANS ? bi + TS_BS : 0;
        const int t_hi = TRANS ? n : bi;
        const int nband = t_hi > t_lo ? (t_hi - t_lo + TS_KT - 1) / TS_KT : 0;
        const int nq = nband + NDQ;
        const float* Di = Dinv + ((size_t)i * B + b) * TS_BS * TS_BS;

        auto load = [&](int q) {
            const int s = q % TS_STAGES;
            float* a = As + s * TS_A;
            if (q < nband) {
                const int t0 = t_lo + q * TS_KT;
                if (TRANS)
                    tile_async<TS_KT, TS_BS, VEC, TS_THREADS>(
                        a, TS_BS, Lb + (size_t)t0 * n + bi, n, n - t0, TS_BS);
                else
                    tile_async<TS_BS, TS_KT, VEC, TS_THREADS>(
                        a, TS_AST, Lb + (size_t)bi * n + t0, n, n - bi, TS_KT);
                tile_async<TS_KT, KC, VEC, TS_THREADS>(Bs + s * TS_KT * KC, KC,
                                           Xb + (size_t)t0 * k, k, n - t0,
                                           vc);
            } else {
                const int s0 = (q - nband) * TS_KT;
                if (TRANS)
                    tile_async<TS_KT, TS_BS, VEC, TS_THREADS>(
                        a, TS_BS, Di + s0 * TS_BS, TS_BS, TS_KT, TS_BS);
                else
                    tile_async<TS_BS, TS_KT, VEC, TS_THREADS>(
                        a, TS_AST, Di + s0, TS_BS, TS_BS, TS_KT);
            }
        };

#pragma unroll
        for (int s = 0; s < TS_STAGES - 1; ++s) {
            if (s < nq) load(s);
            cp_async_commit();
        }

        // acc = R_i, zero beyond n rows and k columns
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int r = bi + row_of(j, ty), c = tx * TN;
            const float* src = Rb + r * sRr + c;
#pragma unroll
            for (int e = 0; e < TN; ++e) acc[j][e] = 0.0f;
            if (VEC) {
                if (r < n && c < vc) lds<TN>(acc[j], src);
            } else {
#pragma unroll
                for (int e = 0; e < TN; ++e)
                    if (r < n && c + e < vc) acc[j][e] = src[e];
            }
        }

        for (int q = 0; q < nq; ++q) {
            if (q == nband) {
                // the band result becomes the B operand of the Dinv product
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    sts<TN>(Cs + row_of(j, ty) * KC + tx * TN, acc[j]);
#pragma unroll
                    for (int e = 0; e < TN; ++e) acc[j][e] = 0.0f;
                }
            }
            cp_async_wait<TS_STAGES - 2>();
            __syncthreads();
            if (q + TS_STAGES - 1 < nq) load(q + TS_STAGES - 1);
            cp_async_commit();
            const int s = q % TS_STAGES;
            if (q < nband)
                chunk_fma<TRANS, TN, true>(acc, As + s * TS_A,
                                           Bs + s * TS_KT * KC, ty, tx);
            else
                chunk_fma<TRANS, TN, false>(acc, As + s * TS_A,
                                            Cs + (q - nband) * TS_KT * KC,
                                            ty, tx);
        }

        // X_i to device memory; later block steps read it back via the ring
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int r = bi + row_of(j, ty), c = tx * TN;
            float* dst = Xb + (size_t)r * k + c;
            if (VEC) {
                if (r < n && c < vc) sts<TN>(dst, acc[j]);
            } else {
#pragma unroll
                for (int e = 0; e < TN; ++e)
                    if (r < n && c + e < vc) dst[e] = acc[j][e];
            }
        }
        __syncthreads();
    }
}

constexpr int tri_smem_bytes(int kc)
{
    return (TS_STAGES * (TS_A + TS_KT * kc) + TS_BS * kc) * (int)sizeof(float);
}

template <bool TRANS, bool VEC, int TN>
int tri_launch(const float* L, const float* Dinv, const float* R, float* X,
               int B, int n, int k, long long sRb, long long sRr,
               cudaStream_t s)
{
    constexpr int KC = 16 * TN;
    constexpr int smem = tri_smem_bytes(KC);
    const void* fn = (const void*)tri_kernel<TRANS, VEC, TN>;
    static unsigned smem_set;
    cudaError_t e = smem_limit_once(fn, smem, &smem_set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((k + KC - 1) / KC, B);
    tri_kernel<TRANS, VEC, TN><<<grid, TS_THREADS, smem, s>>>(
        L, Dinv, R, X, B, n, k, sRb, sRr);
    return (int)cudaGetLastError();
}

template <bool TRANS, bool VEC>
int tri_dispatch_kc(const float* L, const float* Dinv, const float* R,
                    float* X, int B, int n, int k, long long sRb,
                    long long sRr, int kc, cudaStream_t s)
{
    if (kc == 64)
        return tri_launch<TRANS, VEC, 4>(L, Dinv, R, X, B, n, k, sRb, sRr, s);
    return tri_launch<TRANS, VEC, 2>(L, Dinv, R, X, B, n, k, sRb, sRr, s);
}

}  // namespace

extern "C" {

// X (B, n, k) = L^{-1} R (trans = 0) or L^{-T} R (trans = 1).  R has unit
// column stride, batch stride sRb and row stride sRr (in floats); kc, the
// columns per CTA, is 32 or 64.
int kvx_tri(const void* L, const void* Dinv, const void* R, void* X, int B,
            int n, int k, long long sRb, long long sRr, int trans, int kc,
            void* stream)
{
    if (B < 1 || n < 1 || k < 1 || (kc != 32 && kc != 64))
        return (int)cudaErrorInvalidValue;
    const bool vec = n % 4 == 0 && k % 4 == 0 && sRb % 4 == 0 &&
                     sRr % 4 == 0 && aligned16(L) && aligned16(Dinv) &&
                     aligned16(R) && aligned16(X);
    const float *l = (const float*)L, *d = (const float*)Dinv,
                *r = (const float*)R;
    float* x = (float*)X;
    cudaStream_t s = (cudaStream_t)stream;
    if (trans)
        return vec ? tri_dispatch_kc<true, true>(l, d, r, x, B, n, k, sRb,
                                                 sRr, kc, s)
                   : tri_dispatch_kc<true, false>(l, d, r, x, B, n, k, sRb,
                                                  sRr, kc, s);
    return vec ? tri_dispatch_kc<false, true>(l, d, r, x, B, n, k, sRb, sRr,
                                              kc, s)
               : tri_dispatch_kc<false, false>(l, d, r, x, B, n, k, sRb, sRr,
                                               kc, s);
}

}  // extern "C"
