// Batched blocked Cholesky with diagonal-block inverses (K1) and the
// triangular sweeps against that factor (K2, K3), for Hopper (sm_90a).
//
// These replace the Pallas TPU kernels of kvxopt_tpu/ops/chol_ls.py:
//   K1  batched_cholesky_ls (chol_ls.py:358, body _chol_ls_kernel :225,
//       panel step _panel_factor_inverse :136)
//   K2  chol_solve_ls (chol_ls.py:517, body _solve_kernel :477 with
//       _fwd_sweep :417 and _bwd_sweep :446)
//   K3  tri_solve_ls (chol_ls.py:592, body _tri_kernel :498)
//
// Contract (the JAX functions'): f32 in and out, n padded by the caller
// to npad = 128 * nb with identity on the padded diagonal, row-major
// (B, npad, npad) matrices, and the inverses of L's 128x128 diagonal
// blocks in a (nb, B, 128, 128) array.  Right-hand sides are passed
// transposed, (B, kpad, npad), so one column of X is contiguous.
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

#include <cuda_runtime.h>
#include <stdint.h>

#define BS 128

// ---------------------------------------------------------------------------
// K1, step 1: factor one 128x128 diagonal block and build its inverse.
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
// same "factor and inverse together" output as _panel_factor_inverse.
// ---------------------------------------------------------------------------

#define SB 32          // sub-panel width (one warp)
#define LDS_ (BS + 1)  // padded stride: row and column walks hit 32 banks

__device__ __forceinline__ void warp_factor_inverse(float* A, float* Y,
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

__global__ void __launch_bounds__(512)
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
// K1, step 2: panel transform L21 = A21 * Y^T, in place.
//
// Grid (row tiles of 32, B), 256 threads.  Bound by compute at large n
// (2 * 128 * 128 flops per row).  Y^T sits in shared memory with a padded
// stride (conflict-free for both the transposing store and the reads);
// each thread keeps 16 rows of one output column in registers, so one
// shared load of Y feeds 16 FFMAs.
// ---------------------------------------------------------------------------

#define PR_ROWS 32
#define LDD (BS + 1)   // padded stride: conflict-free transposed stores

__global__ void __launch_bounds__(256)
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
// K1, step 3: trailing update A22 -= L21 * L21^T on the lower triangle.
//
// Grid (lower-triangular pairs of 64x64 tiles, B), 256 threads, each
// thread a 4x4 register block of the output.  Bound by compute at large
// n: this step carries nearly all of the factorization's n^3/3 flops.
// Both 64x128 operand strips are staged transposed in shared memory
// (stride 65: conflict-free stores, at most 2-way conflicts on loads).
// ---------------------------------------------------------------------------

#define TT 64
#define LDT (TT + 1)

__global__ void __launch_bounds__(256)
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
// K2 / K3: block substitution sweeps against (L, Dinv).
//
// One CTA per (matrix, chunk of KC right-hand-side columns), 512 threads.
// The chunk of X lives in shared memory for the whole sweep.  Each block
// step is acc = r_i - band * z, then z_i = Dinv_i * acc (forward) or
// Dinv_i^T * acc (backward): nothing is inverted per solve.
//   forward:  band = L[i-block, :bi], read row-wise, one warp per row,
//             coalesced along the row, warp-shuffle reduction;
//   backward: band = L[hi:, i-block]^T, read as rows of L, one thread per
//             column of the block and 4 partial sums over t, coalesced.
// At KC = 1 (K2 in the solver's PCG) a sweep is one pass over half of L
// and is bound by device-memory bandwidth; at KC = 8 with k = n (K3 in
// the factor refinement) it is bound by compute, and the k / 8 chunks
// of every matrix read L from L2.
// mode 0: forward then backward (L L^T x = r), 1: forward (L x = r),
// 2: backward (L^T x = r).
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
             float* __restrict__ Z, int B, int npad, int kpad, int mode)
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

    if (mode != 2) {
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

    if (mode != 1) {
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
    cudaStream_t s = (cudaStream_t)stream;
    const int smem_diag = (2 * BS * LDS_ + 3 * SB * SB) * sizeof(float);
    const int smem_panel = (BS * LDD + PR_ROWS * BS) * sizeof(float);
    const int smem_trail = 2 * BS * LDT * sizeof(float);
    cudaFuncSetAttribute((const void*)chol_diag_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_diag);
    cudaFuncSetAttribute((const void*)chol_panel_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_panel);
    cudaFuncSetAttribute((const void*)chol_trailing_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_trail);
    float* o = (float*)O;
    float* dinv = (float*)Dinv;
    const int nb = npad / BS;
    for (int kb = 0; kb < nb; ++kb) {
        const int base = kb * BS;
        float* dk = dinv + (size_t)kb * B * BS * BS;
        chol_diag_kernel<<<B, 512, smem_diag, s>>>(o, dk, npad, base);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int m = npad - base - BS;
        if (m == 0) break;
        chol_panel_kernel<<<dim3(m / PR_ROWS, B), 256, smem_panel, s>>>(
            o, dk, npad, base);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        const int nt = m / TT;
        chol_trailing_kernel<<<dim3(nt * (nt + 1) / 2, B), 256, smem_trail,
                               s>>>(o, npad, base);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// Shared memory one sweep CTA needs, in bytes (0 for an unsupported kc).
int kvx_sweep_smem(int npad, int kc)
{
    if (kc != 1 && kc != 8) return 0;
    return (kc * npad + kc * BS + SW_PARTS * kc * BS) * (int)sizeof(float);
}

// Sweep Z (B, kpad, npad) in place against (L, Dinv); kc in {1, 8} columns
// per CTA, kpad a multiple of kc.
int kvx_sweep(void* L, void* Dinv, void* Z, int B, int npad, int kpad,
              int kc, int mode, void* stream)
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
            (const float*)L, (const float*)Dinv, (float*)Z, B, npad, kpad,
            mode);
    } else {
        cudaFuncSetAttribute((const void*)sweep_kernel<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
        sweep_kernel<8><<<grid, SW_THREADS, smem, s>>>(
            (const float*)L, (const float*)Dinv, (float*)Z, B, npad, kpad,
            mode);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
