// Blocked right-looking Cholesky of B padded SPD matrices, shared by
// kernel K1 (chol_ls.cu, which keeps every diagonal-block inverse) and
// kernel K4 (chol.cu, which keeps L only).
//
// Contract: f32, row-major (B, npad, npad) matrices with npad = 128 * nb
// and identity on the padded diagonal, factored in place.  Per 128-wide
// panel kb: the diagonal-block kernel factors A_kk and writes its inverse
// Y_kk to the panel's slot of `Dinv`; the panel kernel forms
// L21 = A21 * Y_kk^T; the trailing kernel applies A22 -= L21 L21^T.  The
// slot of panel kb is Dinv + kb * panel_stride: K1 passes B*128*128 and
// keeps all nb slots, K4 passes 0 and reuses one (B,128,128) scratch,
// which is safe because the launches are ordered on one stream.
//
// Arithmetic: IEEE f32 FFMA on the CUDA cores with f32 accumulation.  No
// tensor-core instruction is used: Hopper takes f32 there only as TF32,
// which fails the kernels' tolerances.  A non-positive pivot gives NaN
// through rsqrtf, as lax.rsqrt does in the TPU kernels.
//
// The kernels are static: each translation unit that includes this header
// gets its own copy, so the sources build as separate objects.

#pragma once

#include "common.cuh"

#define BS 128

// ---------------------------------------------------------------------------
// Step 1: factor one 128x128 diagonal block and build its inverse.
//
// One CTA of 512 threads per matrix.  Bound by the serial pivot chain: 128
// dependent pivots.  A pivot step that needs a block-wide barrier costs
// about 2 us on the card (measured with one barrier pair per pivot), so
// the design takes every barrier out of the pivot chain: the block is
// factored right-looking in four 32-wide sub-panels, and each 32x32
// diagonal sub-block is factored (with its inverse) by one warp in
// registers, lane r holding row r, pivots and columns moving by warp
// shuffles.  Between sub-panels the whole CTA applies the 32-wide panel
// transform and trailing update out of shared memory (three barriers per
// sub-panel).  The inverse Y = L^{-1} of the whole block is then built by
// block forward substitution, Y_ip = -Y_ii sum_{p<=k<i} L_ik Y_kp, with
// the diagonal sub-blocks' inverses from the warp factorizations -- the
// same "factor and inverse together" output as the TPU kernels' panel
// step.
// ---------------------------------------------------------------------------

#define SB 32          // sub-panel width (one warp)
#define LDS_ (BS + 1)  // padded stride: row and column walks hit 32 banks

static __device__ __forceinline__ void warp_factor_inverse(float* A,
                                                           float* Y,
                                                           int P, int r)
{
    // A, Y: (BS x LDS_) shared; factors A[P:P+32, P:P+32] in place
    // (lower, zero upper) and writes its inverse to Y[P:P+32, P:P+32].
    const unsigned full = 0xffffffffu;
    float a[SB], y[SB];
#pragma unroll
    for (int c = 0; c < SB; ++c) {
        a[c] = A[(P + r) * LDS_ + P + c];
        y[c] = (c == r) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
        const float rs = rsqrtf(__shfl_sync(full, a[j], j));
        const float l = a[j] * rs;          // L[r][j] for r >= j
        if (r >= j) a[j] = l;
        if (r == j) {
#pragma unroll
            for (int c = 0; c <= j; ++c) y[c] *= rs;
        }
#pragma unroll
        for (int c = 0; c <= j; ++c) {
            const float yjc = __shfl_sync(full, y[c], j);
            if (r > j) y[c] = fmaf(-l, yjc, y[c]);
        }
#pragma unroll
        for (int c = j + 1; c < SB; ++c) {
            const float lc = __shfl_sync(full, l, c);
            if (r > j) a[c] = fmaf(-l, lc, a[c]);
        }
    }
#pragma unroll
    for (int c = 0; c < SB; ++c) {
        A[(P + r) * LDS_ + P + c] = (c <= r) ? a[c] : 0.0f;
        Y[(P + r) * LDS_ + P + c] = y[c];
    }
}

static __global__ void __launch_bounds__(512)
chol_diag_kernel(float* __restrict__ O, float* __restrict__ Dinv,
                 int npad, int base)
{
    extern __shared__ float smem[];
    float* A = smem;                    // BS x LDS_: the block, then L
    float* Y = A + BS * LDS_;           // BS x LDS_: L^{-1}
    float* T = Y + BS * LDS_;           // 3 x SB x SB scratch

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    float* Ob = O + (size_t)b * npad * npad + (size_t)base * npad + base;

    for (int idx = tid; idx < BS * BS; idx += nt) {
        const int r = idx / BS, c = idx % BS;
        A[r * LDS_ + c] = Ob[(size_t)r * npad + c];
        Y[r * LDS_ + c] = 0.0f;
    }
    __syncthreads();

    for (int P = 0; P < BS; P += SB) {
        if (tid < SB) warp_factor_inverse(A, Y, P, tid);
        __syncthreads();
        const int R0 = P + SB, nr = BS - R0;
        // panel: A[R0:, P:P+32] <- A[R0:, P:P+32] * Y_pp^T, in place
        float v[(BS - SB) * SB / 512];
        int nv = 0;
        for (int idx = tid; idx < nr * SB; idx += nt, ++nv) {
            const int r = R0 + idx / SB, c = idx % SB;
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < SB; ++k)
                acc = fmaf(A[r * LDS_ + P + k], Y[(P + c) * LDS_ + P + k],
                           acc);
            v[nv] = acc;
        }
        __syncthreads();
        nv = 0;
        for (int idx = tid; idx < nr * SB; idx += nt, ++nv)
            A[(R0 + idx / SB) * LDS_ + P + idx % SB] = v[nv];
        __syncthreads();
        // trailing: A[R0:, R0:] -= L_panel * L_panel^T (lower part)
        for (int idx = tid; idx < nr * nr; idx += nt) {
            const int r = R0 + idx / nr, c = R0 + idx % nr;
            if (c > r) continue;
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < SB; ++k)
                acc = fmaf(A[r * LDS_ + P + k], A[c * LDS_ + P + k], acc);
            A[r * LDS_ + c] -= acc;
        }
        __syncthreads();
    }

    // block forward substitution for the off-diagonal blocks of Y
    for (int i = 1; i < BS / SB; ++i) {
        const int I = i * SB;
        for (int idx = tid; idx < i * SB * SB; idx += nt) {
            const int p = idx / (SB * SB), r = (idx / SB) % SB, c = idx % SB;
            float acc = 0.0f;
            for (int k = p * SB; k < I; ++k)
                acc = fmaf(A[(I + r) * LDS_ + k], Y[k * LDS_ + p * SB + c],
                           acc);
            T[idx] = acc;
        }
        __syncthreads();
        for (int idx = tid; idx < i * SB * SB; idx += nt) {
            const int p = idx / (SB * SB), r = (idx / SB) % SB, c = idx % SB;
            float acc = 0.0f;
#pragma unroll 8
            for (int s = 0; s < SB; ++s)
                acc = fmaf(Y[(I + r) * LDS_ + I + s],
                           T[(p * SB + s) * SB + c], acc);
            Y[(I + r) * LDS_ + p * SB + c] = -acc;
        }
        __syncthreads();
    }

    float* Yg = Dinv + (size_t)b * BS * BS;
    for (int idx = tid; idx < BS * BS; idx += nt) {
        const int r = idx / BS, c = idx % BS;
        Ob[(size_t)r * npad + c] = (c <= r) ? A[r * LDS_ + c] : 0.0f;
        Yg[idx] = Y[r * LDS_ + c];
    }
}

// ---------------------------------------------------------------------------
// Step 2: panel transform L21 = A21 * Y^T, in place.
//
// Grid (row tiles of 32, B), 256 threads.  Bound by compute at large n
// (2 * 128 * 128 flops per row).  Y^T sits in shared memory with a padded
// stride (conflict-free for both the transposing store and the reads);
// each thread keeps 16 rows of one output column in registers, so one
// shared load of Y feeds 16 FFMAs.
// ---------------------------------------------------------------------------

#define PR_ROWS 32
#define LDD (BS + 1)   // padded stride: conflict-free transposed stores

static __global__ void __launch_bounds__(256)
chol_panel_kernel(float* __restrict__ O, const float* __restrict__ Dinv,
                  int npad, int base)
{
    extern __shared__ float smem[];
    float* Yt = smem;                   // BS x LDD, Yt[k][c] = Y[c][k]
    float* As = Yt + BS * LDD;          // PR_ROWS x BS

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int row0 = base + BS + blockIdx.x * PR_ROWS;
    const float* Yg = Dinv + (size_t)b * BS * BS;
    float* Ob = O + (size_t)b * npad * npad;

    for (int idx = tid; idx < BS * BS; idx += 256) {
        int c = idx / BS, k = idx % BS;
        Yt[k * LDD + c] = Yg[idx];
    }
    for (int idx = tid; idx < PR_ROWS * BS; idx += 256) {
        int r = idx / BS, k = idx % BS;
        As[idx] = Ob[(size_t)(row0 + r) * npad + base + k];
    }
    __syncthreads();

    const int c = tid % BS;
    const int rg = tid / BS;            // 0 or 1
    float acc[PR_ROWS / 2];
#pragma unroll
    for (int t = 0; t < PR_ROWS / 2; ++t) acc[t] = 0.0f;
    for (int k = 0; k < BS; ++k) {
        float y = Yt[k * LDD + c];
#pragma unroll
        for (int t = 0; t < PR_ROWS / 2; ++t)
            acc[t] = fmaf(As[(rg + 2 * t) * BS + k], y, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < PR_ROWS / 2; ++t)
        Ob[(size_t)(row0 + rg + 2 * t) * npad + base + c] = acc[t];
}

// ---------------------------------------------------------------------------
// Step 3: trailing update A22 -= L21 * L21^T on the lower triangle.
//
// Grid (lower-triangular pairs of 64x64 tiles, B), 256 threads, each
// thread a 4x4 register block of the output.  Bound by compute at large
// n: this step carries nearly all of the factorization's n^3/3 flops.
// Both 64x128 operand strips are staged transposed in shared memory
// (stride 65: conflict-free stores, at most 2-way conflicts on loads).
// ---------------------------------------------------------------------------

#define TT 64
#define LDT (TT + 1)

static __global__ void __launch_bounds__(256)
chol_trailing_kernel(float* __restrict__ O, int npad, int base)
{
    extern __shared__ float smem[];
    float* At = smem;                   // BS x LDT, At[k][r]
    float* Bt = At + BS * LDT;          // BS x LDT, Bt[k][c]

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    int p = blockIdx.x, ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
    const int tj = p - ti * (ti + 1) / 2;
    const int r0 = base + BS;
    const int ra = r0 + ti * TT, rb = r0 + tj * TT;
    float* Ob = O + (size_t)b * npad * npad;

    for (int idx = tid; idx < TT * BS; idx += 256) {
        int r = idx / BS, k = idx % BS;
        At[k * LDT + r] = Ob[(size_t)(ra + r) * npad + base + k];
        Bt[k * LDT + r] = Ob[(size_t)(rb + r) * npad + base + k];
    }
    __syncthreads();

    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < BS; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = At[k * LDT + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bt[k * LDT + tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float* row = Ob + (size_t)(ra + ty * 4 + i) * npad + rb + tx * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] -= acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// The launch path: nb panels of three launches each, on stream s.
// Returns the first launch error (as an int), or 0.
// ---------------------------------------------------------------------------

static int chol_factor_blocked(float* O, float* Dinv, size_t panel_stride,
                               int B, int npad, cudaStream_t s)
{
    const int smem_diag = (2 * BS * LDS_ + 3 * SB * SB) * sizeof(float);
    const int smem_panel = (BS * LDD + PR_ROWS * BS) * sizeof(float);
    const int smem_trail = 2 * BS * LDT * sizeof(float);
    static unsigned diag_set, panel_set, trail_set;
    cudaError_t e = smem_limit_once((const void*)chol_diag_kernel,
                                    smem_diag, &diag_set);
    if (e == cudaSuccess)
        e = smem_limit_once((const void*)chol_panel_kernel, smem_panel,
                            &panel_set);
    if (e == cudaSuccess)
        e = smem_limit_once((const void*)chol_trailing_kernel, smem_trail,
                            &trail_set);
    if (e != cudaSuccess) return (int)e;
    const int nb = npad / BS;
    for (int kb = 0; kb < nb; ++kb) {
        const int base = kb * BS;
        float* dk = Dinv + (size_t)kb * panel_stride;
        chol_diag_kernel<<<B, 512, smem_diag, s>>>(O, dk, npad, base);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int m = npad - base - BS;
        if (m == 0) break;
        chol_panel_kernel<<<dim3(m / PR_ROWS, B), 256, smem_panel, s>>>(
            O, dk, npad, base);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int nt = m / TT;
        chol_trailing_kernel<<<dim3(nt * (nt + 1) / 2, B), 256, smem_trail,
                               s>>>(O, npad, base);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}
