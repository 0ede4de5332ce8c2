// Batched blocked Cholesky for Hopper (sm_90a), shared by kernel K1
// (chol_ls.cu, which keeps every diagonal-block inverse) and kernel K4
// (chol.cu, which keeps L only).
//
// Contract: A (B, n, n) f32 row-major SPD, only its lower triangle read
// and never written; L (B, n, n) f32 written whole, with exact zeros above
// the diagonal; the inverse Y of each 128x128 diagonal block of L, padded
// to [L_kk 0; 0 I] for the last block, in slot kb % nslot of `Dinv`, each
// slot (B, 128, 128) (K1: nslot = nb keeps every inverse; K4: nslot = 2,
// a scratch in which the cluster's CTA 0 writes block kb+1's inverse while
// its peers may still be staging block kb's).
// Rows and columns beyond n act as the identity: tiles zero-fill beyond
// n and put 1 on the padded diagonal as they load, so nothing is padded
// or copied around the kernel.  A non-positive pivot gives NaN through
// rsqrtf, as lax.rsqrt does in the TPU kernels, in that matrix only.
//
// Math, per 128-wide panel kb (base = 128 kb), as the TPU kernels:
//   factor the diagonal block and build its inverse Y_kk;
//   panel:    L21 = A21 Y_kk^T                (rows below the block)
//   trailing: A22 -= L21 L21^T                (lower tiles only)
// The first panel reads A; later panels read the partly updated trailing
// matrix from L's buffer, which stays in L2 at the solves' sizes (16.8 MB
// at B=16 n=512 against the 50 MB L2).
//
// What bounds it.  The factorization is n^3/3 flops per matrix, but at
// the solves' shapes (n = 512 and the Schur complement's n = 32) the
// chain of diagonal blocks bounds it: each step factors and inverts a
// 128x128 block whose 128 pivots depend on each other.  The kernels this
// replaces spent 68 us on that step (one CTA per matrix; one warp factored
// each 32-wide sub-panel while 15 waited at three barriers per sub-panel,
// then a block substitution built Y), 71% of the call at B=16 n=512, and
// factored a 128 block of 94% identity at n=32.  At n >= 2048 the
// trailing update's FFMAs bound it.
//
// Design.
//  1. The 32-wide pivot step (warp_factor_inverse): one warp, lane r
//     holding row r of the symmetric sub-block in registers.  Pivot row j,
//     broadcast from lane j, is column j by symmetry, so one shuffle per
//     column feeds both the rank-1 update and the substitution that builds
//     the inverse: two FFMAs per shuffle, no barrier, no shared memory.
//  2. The diagonal block (block_factor): warps 0-3 make the pivot's row
//     of the last panel and its update, then warp 0 factors the sub-panel
//     while the six warps off warp 0's scheduler update the other
//     sub-blocks and build Y's off-diagonal row blocks by substitution,
//     their partial sums kept in Y's unused upper sub-blocks.  Only the
//     sub-panels that hold data are factored.
//  3. n <= 32: one warp per matrix factors the whole matrix with its
//     inverse (chol_warp_kernel); n <= 128: one CTA per matrix runs
//     block_factor (chol_block_kernel).  One launch, no panel or trailing
//     work.
//  4. 128 < n, by default where n <= 512: one launch, a thread-block
//     cluster of 8 CTAs per matrix, or 4 where B clusters of 8 are not
//     resident at once (chol_cluster_kernel; 64 CTAs at B=16).  Look-ahead
//     on the chain: half the cluster splits the next diagonal block's
//     panel rows and then its update into strips, waiting only on each
//     other (mbarriers in shared memory, arrivals from the peers at
//     cluster scope), and CTA 0 factors that block while the other CTAs
//     finish the step's panel and trailing tiles.  Every read of L goes
//     to L2 (cp.async.cg, ld.global.cg), so the barriers' release and
//     acquire order the peers' writes.
//  5. Elsewhere (n > 512, where the trailing update's FFMAs and not the
//     chain bound the call, or too many matrices for resident clusters):
//     one launch per step -- chol_block_kernel on B CTAs, then
//     chol_tile_kernel for the panel and for the trailing update, each
//     with its grid over the B matrices' 128 x 128 tiles.  The wrapper
//     chooses by a rule on B, n and the SM count.
//  6. 256 threads per CTA, so that one kernel holds both the pivot step
//     (a[32] and y[32] per lane) and the products within the 255
//     registers a thread may have; at 512 threads the 128-register budget
//     spilled, and the cluster's diagonal block ran far slower than in a
//     kernel of its own.
//  7. Products: a 16U x 128 tile per CTA, 8 x 8 outputs per thread from
//     float4 shared loads (rows ty + 16u, columns tx + 16v: A broadcast
//     within each quarter-warp, B on eight bank groups per quarter-warp),
//     operands streamed in 32-deep chunks through a 3-stage cp.async ring
//     (16-byte copies where n and the pointers allow, else 4-byte ones).
//     The panel's Y is staged once per CTA.  The trailing tile reads its
//     old values all at once after the product (src may be L itself).
//  8. The zeros above the diagonal are written by the kernel: each panel
//     tile zeroes its mirror in the block row above, block_factor the
//     upper triangle of its diagonal block.
//  9. Precision: IEEE f32 FFMA with f32 accumulation, each output summed
//     in the same order on every path, so K4's L is bit-equal to K1's.
//     No tensor-core instruction: Hopper takes f32 there only as TF32,
//     which fails the tolerances.
//
// The kernels live in an anonymous namespace: each translation unit that
// includes this header gets its own copy, so the sources build as
// separate objects.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BS = 128;             // diagonal block (Dinv contract)
constexpr int SB = 32;              // sub-panel: one warp
constexpr int NT = 256;             // threads of the block-sized kernels
constexpr int LDB = BS + 4;         // row stride of a 128-wide block
constexpr int KT = 32;              // depth of a ring chunk
constexpr int LDK = KT + 4;         // row stride of a ring chunk
constexpr int STAGES = 3;
constexpr int NCH = BS / KT;        // chunks per product

// Shared memory, in floats: the block and its inverse, or the panel's
// staged Y and the product ring
constexpr int SM_RING = BS * LDB;
constexpr int SM_BLOCK = 2 * BS * LDB;
constexpr int SM_PROD = SM_RING + STAGES * 2 * BS * LDK;
constexpr int SM_BYTES =
    (SM_BLOCK > SM_PROD ? SM_BLOCK : SM_PROD) * (int)sizeof(float);

// ---------------------------------------------------------------------------
// Building blocks
// ---------------------------------------------------------------------------

// Factor the 32x32 SPD matrix held one row per lane, both triangles (a[c]
// = A[r][c] = A[c][r]), and build its inverse: on return a holds row r of
// L (zeros above the diagonal) and y column r of L^{-1} (y[i] =
// L^{-1}[i][r]).  Pivot row j, broadcast from lane j, is by symmetry
// column j scaled by L[j][j], so one shuffle per column serves both each
// lane's rank-1 update, a[c] -= (L[r][j] / L[j][j]) A[j][c], and the
// right-looking substitution of its column of the inverse, y[c] -=
// A[j][c] (Y[j][r] / L[j][j]): two FFMAs per shuffle.  No barrier and no
// shared memory; the chain per pivot is a shuffle, an rsqrt, two
// multiplies and an FFMA.
__device__ __forceinline__ void warp_factor_inverse(float (&a)[SB],
                                                    float (&y)[SB], int r)
{
    const unsigned full = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < SB; ++i) y[i] = i == r ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
        const float rs = rsqrtf(__shfl_sync(full, a[j], j));
        const float l = a[j] * rs;          // L[r][j] for r >= j
        const float m = l * rs;
        y[j] *= rs;                         // Y[j][r]
        const float w = y[j] * rs;
#pragma unroll
        for (int c = j + 1; c < SB; ++c) {
            const float s = __shfl_sync(full, a[c], j);
            a[c] = fmaf(-m, s, a[c]);
            y[c] = fmaf(-s, w, y[c]);
        }
        a[j] = l;
    }
#pragma unroll
    for (int c = 0; c < SB; ++c)
        if (c > r) a[c] = 0.0f;
}

// acc[u][v] += sum_k a[u * sa + k] b[v * sb + k] over depth (a multiple of
// 4), float4 loads along the depth: the A B^T form.
template <int U, int V>
__device__ __forceinline__ void fma_nt(float (&acc)[U][V], const float* a,
                                       int sa, const float* b, int sb,
                                       int depth)
{
    for (int k = 0; k < depth; k += 4) {
        float4 av[U], bv[V];
#pragma unroll
        for (int u = 0; u < U; ++u)
            av[u] = *reinterpret_cast<const float4*>(a + u * sa + k);
#pragma unroll
        for (int v = 0; v < V; ++v)
            bv[v] = *reinterpret_cast<const float4*>(b + v * sb + k);
        // one depth at a time over all outputs: consecutive FFMAs are
        // independent
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int v = 0; v < V; ++v)
                    acc[u][v] = fmaf((&av[u].x)[e], (&bv[v].x)[e],
                                     acc[u][v]);
    }
}

// acc[u][v] += sum_k a[u * sa + k] b[k * ldb + v] over depth (a multiple
// of 4): the A B form, b's four columns contiguous.
template <int U>
__device__ __forceinline__ void fma_nn(float (&acc)[U][4], const float* a,
                                       int sa, const float* b, int ldb,
                                       int depth)
{
    for (int k = 0; k < depth; k += 4) {
        float4 av[U], bv[4];
#pragma unroll
        for (int u = 0; u < U; ++u)
            av[u] = *reinterpret_cast<const float4*>(a + u * sa + k);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            bv[e] = *reinterpret_cast<const float4*>(b + (k + e) * ldb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                    acc[u][v] = fmaf((&av[u].x)[e], (&bv[e].x)[v],
                                     acc[u][v]);
    }
}

template <int U, int V>
__device__ __forceinline__ void zero(float (&acc)[U][V])
{
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = 0.0f;
}

// A barrier of `count` threads (whole warps) at hardware barrier `id`.
__device__ __forceinline__ void bar_named(int id, int count)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// The diagonal block: factor block kb (rows and columns base .. base+127,
// read from src, row stride n) and build its inverse; write L's block
// (zeros above the diagonal, nothing beyond n) and Y (128 x 128, identity
// on the padding) to Yg.  vec: rows of src and L are 16-byte aligned.  All
// NT threads of the CTA; ends in a barrier.
//
// The block is four 32-wide sub-panels; (i, j) below is the 32 x 32
// sub-block of block row i, block column j.  Per sub-panel p:
//   warps 0-3: the pivot's row of the last panel, L[p][p-1] = A[p][p-1]
//     Y[p-1][p-1]^T, and its update of (p, p); then
//   warp 0: factors (p, p) with its inverse (warp_factor_inverse), while
//   warps 1-3, 5-7 (off warp 0's scheduler): the rest of the last panel,
//     its update of the other sub-blocks (i, j), i >= j >= p, and the
//     substitution for Y's row block p - 1, Y[p-1][q] = -Y[p-1][p-1]
//     sum_{k=q}^{p-2} L[p-1][k] Y[k][q], its partial sums T kept in Y's
//     unused upper sub-block (q, p-1).
// Only the pivot chain waits: the substitution, which the TPU kernel ran
// after the block, and the updates off the next pivot's sub-block run
// beside the factor.  The last row block's substitution ends the block.
// A product task is a 32 x 32 sub-block, on 128 threads (2 x 4 outputs
// each) on the chain and on 64 (4 x 4) beside it.  Only the ceil(h / 32)
// sub-panels that hold data are factored: [A 0; 0 I] has factor [L 0;
// 0 I] and inverse [L^-1 0; 0 I], so the padding is written, never
// computed.
// ---------------------------------------------------------------------------

// Warp 0's step: factor the sub-block at Ap (lower triangle, row stride
// LDB) in place, zeros above the diagonal, and write its inverse at Yp.
__device__ __forceinline__ void pivot_factor(float* Ap, float* Yp, int lane)
{
    float a[SB], y[SB];
#pragma unroll
    for (int c = 0; c < SB; ++c)
        a[c] = c <= lane ? Ap[lane * LDB + c] : Ap[c * LDB + lane];
    warp_factor_inverse(a, y, lane);
#pragma unroll
    for (int c = 0; c < SB; ++c) {
        Ap[lane * LDB + c] = a[c];
        Yp[c * LDB + lane] = y[c];
    }
}

// The sub-block (i, j) of a 128 x LDB block in shared memory.
__device__ __forceinline__ float* sub(float* X, int i, int j)
{
    return X + i * SB * LDB + j * SB;
}

// U x 4 outputs of a 32 x 32 sub-block product for thread t < 256 / U:
// rows t / 8 + (32 / U) u; columns t % 8 + 8v (the A B^T form, B read
// along its rows) or 4 (t % 8) + v (the A B form).  Eight consecutive
// threads share their rows, so A's loads are broadcasts and a row's
// readers are one warp, and B's rows, 132 floats apart, fall on eight
// bank groups.
template <int U>
__device__ __forceinline__ void sub_nt(float (&acc)[U][4], const float* a,
                                       const float* b, int t)
{
    fma_nt<U, 4>(acc, a + (t >> 3) * LDB, (SB / U) * LDB, b + (t & 7) * LDB,
                 8 * LDB, SB);
}

template <int U>
__device__ __forceinline__ void sub_nn(float (&acc)[U][4], const float* a,
                                       const float* b, int t)
{
    fma_nn<U>(acc, a + (t >> 3) * LDB, (SB / U) * LDB, b + 4 * (t & 7), LDB,
              SB);
}

// out = acc, or out -= acc where SUB, at the A B^T form's outputs
template <int U, bool SUB>
__device__ __forceinline__ void put_nt(float* out, const float (&acc)[U][4],
                                       int t)
{
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            float& o = out[((t >> 3) + (SB / U) * u) * LDB + (t & 7) + 8 * v];
            o = SUB ? o - acc[u][v] : acc[u][v];
        }
}

// out = s acc at the A B form's outputs
template <int U>
__device__ __forceinline__ void put_nn(float* out, const float (&acc)[U][4],
                                       int t, float s)
{
#pragma unroll
    for (int u = 0; u < U; ++u)
        *reinterpret_cast<float4*>(out + ((t >> 3) + (SB / U) * u) * LDB +
                                   4 * (t & 7)) =
            make_float4(s * acc[u][0], s * acc[u][1], s * acc[u][2],
                        s * acc[u][3]);
}

// L[i][j] = A[i][j] Y[j][j]^T in place, or A[i][j] -= L[i][k] L[j][k]^T
template <int U>
__device__ __forceinline__ void panel_sub(float* As, float* Ys, int i, int j,
                                          int t)
{
    float acc[U][4];
    zero(acc);
    sub_nt<U>(acc, sub(As, i, j), sub(Ys, j, j), t);
    __syncwarp();
    put_nt<U, false>(sub(As, i, j), acc, t);
}

template <int U>
__device__ __forceinline__ void update_sub(float* As, int i, int j, int k,
                                           int t)
{
    float acc[U][4];
    zero(acc);
    sub_nt<U>(acc, sub(As, i, k), sub(As, j, k), t);
    put_nt<U, true>(sub(As, i, j), acc, t);
}

// T[p][q] = sum_{k=q}^{p-1} L[p][k] Y[k][q] into Y's upper sub-block (q, p)
template <int U>
__device__ __forceinline__ void subst_sum(float* As, float* Ys, int p, int q,
                                          int t)
{
    float acc[U][4];
    zero(acc);
    for (int k = q; k < p; ++k)
        sub_nn<U>(acc, sub(As, p, k), sub(Ys, k, q), t);
    put_nn<U>(sub(Ys, q, p), acc, t, 1.0f);
}

// Y[p][q] = -Y[p][p] T[p][q]
template <int U>
__device__ __forceinline__ void subst_apply(float* Ys, int p, int q, int t)
{
    float acc[U][4];
    zero(acc);
    sub_nn<U>(acc, sub(Ys, p, p), sub(Ys, q, p), t);
    put_nn<U>(sub(Ys, p, q), acc, t, -1.0f);
}

__device__ __forceinline__ void block_factor(const float* __restrict__ src,
                                             float* __restrict__ L,
                                             float* __restrict__ Yg, int n,
                                             int base, bool vec, float* smem)
{
    float* As = smem;                   // BS x LDB: the block, then L
    float* Ys = As + BS * LDB;          // BS x LDB: L^{-1}, and T above
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = min(BS, n - base);    // rows and columns that hold data
    const int nsp = (h + SB - 1) / SB;  // sub-panels to factor
    const float* Ab = src + (size_t)base * n + base;

    // the lower triangle (identity beyond h, zeros above the diagonal),
    // every load of a thread in flight at once: 16 float4 where rows are
    // 16-byte aligned (n % 4 == 0), else 64 scalars in four batches
    if (vec) {
        float4 v[BS * BS / 4 / NT];
#pragma unroll
        for (int it = 0; it < BS * BS / 4 / NT; ++it) {
            const int idx = it * NT + tid, r = idx >> 5, c = (idx & 31) * 4;
            v[it] = r < h && c < h && c <= r
                ? __ldcg(reinterpret_cast<const float4*>(Ab + (size_t)r * n +
                                                         c))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int it = 0; it < BS * BS / 4 / NT; ++it) {
            const int idx = it * NT + tid, r = idx >> 5, c = (idx & 31) * 4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = (&v[it].x)[e];
                As[r * LDB + c + e] = c + e < r ? x
                    : (c + e == r ? (r < h ? x : 1.0f) : 0.0f);
            }
        }
    } else {
        for (int part = 0; part < BS * BS / NT / 16; ++part) {
            float v[16];
#pragma unroll
            for (int it = 0; it < 16; ++it) {
                const int idx = (part * 16 + it) * NT + tid;
                const int r = idx / BS, c = idx % BS;
                v[it] = (r == c) ? 1.0f : 0.0f;
                if (r < h && c < h && c <= r)
                    v[it] = __ldcg(Ab + (size_t)r * n + c);
            }
#pragma unroll
            for (int it = 0; it < 16; ++it) {
                const int idx = (part * 16 + it) * NT + tid;
                As[(idx / BS) * LDB + idx % BS] = v[it];
            }
        }
    }
    __syncthreads();

    // the workers: the six warps off warp 0's scheduler (warp % 4 != 0),
    // as three slots of 64 threads
    const bool worker = (warp & 3) != 0;
    const int wi = warp - (warp >> 2) - 1;
    const int slot = wi >> 1, t = (wi & 1) * 32 + lane;
    for (int p = 0; p < nsp; ++p) {
        if (p > 0) {
            // the pivot's row of panel p - 1, then its update of (p, p), on
            // warps 0-3 alone
            if (warp < 4) {
                panel_sub<2>(As, Ys, p, p - 1, tid);
                bar_named(1, 128);
                update_sub<2>(As, p, p, p - 1, tid);
            }
            __syncthreads();
        }
        if (warp == 0) {
            pivot_factor(sub(As, p, p), sub(Ys, p, p), lane);
        } else if (worker && p > 0) {
            const int m = nsp - p;
            const bool last = p + 1 == nsp;
            // the rest of panel p - 1
            for (int i = p + 1 + slot; i < nsp; i += 3)
                panel_sub<4>(As, Ys, i, p - 1, t);
            if (m > 1) bar_named(2, NT - 64);
            // round 1: panel p - 1's update of the sub-blocks (i, j),
            // i >= j >= p, but (p, p); the sums T[p-1][q]; and the last
            // row block's T[p][p-1]
            const int ntr = m * (m + 1) / 2 - 1;
            const int nsum = p - 1;
            const int ntask = ntr + nsum + last;
            for (int k = slot; k < ntask; k += 3) {
                if (k < ntr) {
                    int i = 0, j = k + 1;
                    while (j > i) j -= ++i;
                    update_sub<4>(As, p + i, p + j, p - 1, t);
                } else if (k < ntr + nsum) {
                    subst_sum<4>(As, Ys, p - 1, k - ntr, t);
                } else {
                    subst_sum<4>(As, Ys, p, p - 1, t);
                }
            }
            if (p > 1) {
                bar_named(2, NT - 64);
                // round 2: Y[p-1][q] = -Y[p-1][p-1] T[p-1][q]
                for (int q = slot; q < p - 1; q += 3)
                    subst_apply<4>(Ys, p - 1, q, t);
                if (last) {
                    bar_named(2, NT - 64);
                    // round 3: the last row block's sums T[p][q], q < p-1
                    for (int q = slot; q < p - 1; q += 3)
                        subst_sum<4>(As, Ys, p, q, t);
                }
            }
        }
        __syncthreads();
    }
    // the last row block of Y
    for (int q = tid >> 7; q < nsp - 1; q += NT / 128)
        subst_apply<2>(Ys, nsp - 1, q, tid & 127);
    __syncthreads();

    float* Lb = L + (size_t)base * n + base;
    if (vec) {
        for (int idx = tid; idx < BS * BS / 4; idx += NT) {
            const int r = idx >> 5, c = (idx & 31) * 4;
            if (r < h && c < h) {
                const float4 a =
                    *reinterpret_cast<const float4*>(As + r * LDB + c);
                *reinterpret_cast<float4*>(Lb + (size_t)r * n + c) =
                    make_float4(c <= r ? a.x : 0.0f, c + 1 <= r ? a.y : 0.0f,
                                c + 2 <= r ? a.z : 0.0f,
                                c + 3 <= r ? a.w : 0.0f);
            }
        }
    } else {
        for (int idx = tid; idx < BS * BS; idx += NT) {
            const int r = idx / BS, c = idx % BS;
            if (r < h && c < h)
                Lb[(size_t)r * n + c] = c <= r ? As[r * LDB + c] : 0.0f;
        }
    }
    // Y: computed sub-blocks on and below the diagonal; identity on the
    // padding and zeros elsewhere (the T sums above are not copied)
    for (int idx = tid; idx < BS * BS / 4; idx += NT) {
        const int r = idx >> 5, c = (idx & 31) * 4;
        const int rb = r / SB, cb = c / SB;
        *reinterpret_cast<float4*>(Yg + r * BS + c) = cb > rb || rb >= nsp
            ? make_float4(r == c, r == c + 1, r == c + 2, r == c + 3)
            : *reinterpret_cast<const float4*>(Ys + r * LDB + c);
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// Product tiles: 16U x 128 outputs per CTA of NT = 256 threads, thread
// (ty = tid / 16, tx = tid % 16) owning rows ty + 16u (u < U) and columns
// tx + 16v (v < 8): per four depths U float4 loads of A (a broadcast
// within each quarter-warp) and 8 of B (eight bank groups per
// quarter-warp) feed 32U FFMAs.  U = 8 (128-row tiles) but on the
// cluster's chain, which splits its tiles into strips of 64 or 32 rows.
// ---------------------------------------------------------------------------

// Stage Y (128 x 128, row stride 128, always 16-byte aligned) into Ys.
__device__ __forceinline__ void stage_y(float* Ys, const float* Yg)
{
    tile_async<BS, BS, true, NT>(Ys, LDB, Yg, BS, BS, BS);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
}

// acc = Ag[16U rows] Bg[128 rows]^T over 128 columns (row stride ld, rows
// beyond ar / br read as 0) through the ring; with Ys (the panel) the B
// operand is the staged Y instead of Bg.  Ends in a barrier.
template <bool VEC, int U>
__device__ __forceinline__ void product(float (&acc)[U][8], float* ring,
                                        const float* Ag, const float* Bg,
                                        size_t ld, int ar, int br,
                                        const float* Ys)
{
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    constexpr int STAGE = 2 * BS * LDK;
    auto issue = [&](int q) {
        float* st = ring + (q % STAGES) * STAGE;
        tile_async<16 * U, KT, VEC, NT>(st, LDK, Ag + q * KT, ld, ar, KT);
        if (Ys == nullptr)
            tile_async<BS, KT, VEC, NT>(st + BS * LDK, LDK, Bg + q * KT, ld,
                                        br, KT);
        cp_async_commit();
    };
    zero(acc);
    issue(0);
    issue(1);
    for (int q = 0; q < NCH; ++q) {
        cp_async_wait<1>();
        __syncthreads();
        if (q + 2 < NCH)
            issue(q + 2);
        else
            cp_async_commit();
        const float* st = ring + (q % STAGES) * STAGE;
        if (Ys == nullptr)
            fma_nt<U, 8>(acc, st + ty * LDK, 16 * LDK,
                         st + (BS + tx) * LDK, 16 * LDK, KT);
        else
            fma_nt<U, 8>(acc, st + ty * LDK, 16 * LDK,
                         Ys + tx * LDB + q * KT, 16 * LDB, KT);
    }
    __syncthreads();
}

// Panel rows R0 .. R0 + 16U of step kb (base = 128 kb): L[R0.., kb] =
// src[R0.., kb] Y^T with Y staged in Ys; and their mirror above the
// diagonal, L[kb, R0..], set to 0.
template <bool VEC, int U>
__device__ void panel_tile(const float* __restrict__ src,
                           float* __restrict__ L, int n, int base, int R0,
                           const float* Ys, float* ring)
{
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float acc[U][8];
    product<VEC, U>(acc, ring, src + (size_t)R0 * n + base, nullptr, n,
                    n - R0, 0, Ys);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int r = R0 + ty + 16 * u;
        if (r < n)
#pragma unroll
            for (int v = 0; v < 8; ++v)
                L[(size_t)r * n + base + tx + 16 * v] = acc[u][v];
    }
    for (int idx = threadIdx.x; idx < BS * 16 * U; idx += NT) {
        const int r = base + idx / (16 * U), c = R0 + idx % (16 * U);
        if (c < n) L[(size_t)r * n + c] = 0.0f;
    }
}

// Trailing rows R0 .. R0 + 16U, block column C0 .. C0 + 128, lower part:
// L[r][c] = src[r][c] - L[r, kb] . L[c, kb].
template <bool VEC, int U>
__device__ void trailing_tile(const float* __restrict__ src,
                              float* __restrict__ L, int n, int base, int R0,
                              int C0, float* ring)
{
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float acc[U][8];
    product<VEC, U>(acc, ring, L + (size_t)R0 * n + base,
                    L + (size_t)C0 * n + base, n, n - R0, n - C0, nullptr);
    // every load of the tile in flight before the first store (src may be
    // L itself)
    float old[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int r = R0 + ty + 16 * u;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            const int c = C0 + tx + 16 * v;
            old[u][v] = r < n && c <= r ? __ldcg(src + (size_t)r * n + c)
                                        : 0.0f;
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int r = R0 + ty + 16 * u;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            const int c = C0 + tx + 16 * v;
            if (r < n && c <= r)
                L[(size_t)r * n + c] = old[u][v] - acc[u][v];
        }
    }
}

// Trailing tile idx of step kb, of the nrt (nrt + 1) / 2 below block kb:
// block row kb + 1 + ti, block column cj.
__device__ __forceinline__ void trailing_of(int idx, int kb, int* ti,
                                            int* cj)
{
    int t = 0;
    while (idx > t) idx -= ++t;
    *ti = t;
    *cj = kb + 1 + idx;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// n <= 32: warp 0 factors the matrix with its inverse in registers; the
// CTA's four warps write the identity padding of the Dinv block.
__global__ void __launch_bounds__(128)
chol_warp_kernel(const float* __restrict__ A, float* __restrict__ L,
                 float* __restrict__ Dinv, int n)
{
    __shared__ float Ls[SB * (SB + 1)];
    const int b = blockIdx.x, tid = threadIdx.x;
    const float* Ab = A + (size_t)b * n * n;
    float* Lb = L + (size_t)b * n * n;
    float* Yg = Dinv + (size_t)b * BS * BS;
    if (tid < SB) {
        const int r = tid;
        float a[SB], y[SB];
#pragma unroll
        for (int c = 0; c < SB; ++c)
            a[c] = (r < n && c < n) ? __ldg(Ab + max(r, c) * n + min(r, c))
                                    : (c == r ? 1.0f : 0.0f);
        warp_factor_inverse(a, y, r);
#pragma unroll
        for (int c = 0; c < SB; ++c) {
            Ls[r * (SB + 1) + c] = a[c];
            Yg[c * BS + r] = y[c];
        }
    }
    for (int idx = tid; idx < BS * BS / 4; idx += 128) {
        const int r = idx / (BS / 4), c = (idx % (BS / 4)) * 4;
        if (r < SB && c < SB) continue;
        *reinterpret_cast<float4*>(Yg + r * BS + c) =
            make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
    }
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += 128)
        Lb[idx] = Ls[(idx / n) * (SB + 1) + idx % n];
}

// One diagonal block per matrix: the whole factor where n <= 128, step
// kb's diagonal block on the per-step path (src is A at kb = 0, else L).
__global__ void __launch_bounds__(NT, 1)
chol_block_kernel(const float* __restrict__ src, float* __restrict__ L,
                  float* __restrict__ Dinv, size_t dstride_b, int n, int base,
                  bool vec)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    block_factor(src + (size_t)b * n * n, L + (size_t)b * n * n,
                 Dinv + b * dstride_b, n, base, vec, smem);
}

// The per-step path's products: PANEL, grid (row blocks below kb, B);
// else grid (trailing tiles, B).
template <bool VEC, bool PANEL>
__global__ void __launch_bounds__(NT, 1)
chol_tile_kernel(const float* __restrict__ src, float* __restrict__ L,
                 const float* __restrict__ Dinv, size_t dstride_b, int n,
                 int kb)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.y, base = kb * BS;
    const float* sb = src + (size_t)b * n * n;
    float* Lb = L + (size_t)b * n * n;
    if (PANEL) {
        stage_y(smem, Dinv + b * dstride_b);
        panel_tile<VEC, 8>(sb, Lb, n, base, base + BS * (1 + blockIdx.x),
                           smem, smem + SM_RING);
    } else {
        int ti, cj;
        trailing_of(blockIdx.x, kb, &ti, &cj);
        trailing_tile<VEC, 8>(sb, Lb, n, base, base + BS * (1 + ti), cj * BS,
                              smem + SM_RING);
    }
}

// The cluster barrier in two halves: arrive releases the caller's writes,
// wait returns once every CTA of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// n > 128: the whole factorization in one launch, a cluster of CS CTAs
// per matrix (grid CS * B), CS = 8 or 4.  Per step kb, the chain -- the
// panel rows of diagonal block kb+1, that block's update, its factor --
// runs first: CTAs 0 .. S-1 (S = CS / 2) each take a strip of 128 / S
// rows of the panel rows, wait only for each other's strips (mbarrier
// `rows` in each), take the same strip of the block's update, and CTA 0
// factors the block as soon as CTAs 1 .. S-1 arrive on its mbarrier
// `strips`.  CTAs S .. CS-1 take the other panel rows, and CTAs 1 .. CS-1
// the other trailing tiles once every panel row is in L (the cluster
// barrier's first half, arrived at after the panel).
template <bool VEC, int CS>
__global__ void __launch_bounds__(NT, 1)
chol_cluster_kernel(const float* __restrict__ A, float* __restrict__ L,
                    float* __restrict__ Dinv, int nslot, int n)
{
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t rows;           // strip CTAs: the panel strips
    __shared__ uint64_t strips;         // CTA 0: the update strips
    constexpr int S = CS / 2, SR = BS / S, SU = SR / 16;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / CS;
    const int nb = (n + BS - 1) / BS;
    const float* Ab = A + (size_t)b * n * n;
    float* Lb = L + (size_t)b * n * n;
    float* Yb = Dinv + (size_t)b * BS * BS;
    const size_t dstride = (size_t)(gridDim.x / CS) * BS * BS;
    float* ring = smem + SM_RING;

    if (rank < S && threadIdx.x == 0) {
        mbar_init(&rows, S);
        mbar_init(&strips, S - 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // step kb = -1 factors block 0; the factor has one call site, so that
    // the kernel holds one copy of its unrolled code
    for (int kb = -1; kb + 1 < nb; ++kb) {
        const int base = kb * BS, next = base + BS;
        const float* src = kb <= 0 ? Ab : Lb;
        const int nrt = nb - 1 - kb;    // block rows below block kb
        if (kb >= 0) {
            if (rank < S || rank - S + 1 < nrt) {
                stage_y(smem, Yb + (kb % nslot) * dstride);
                if (rank < S)
                    panel_tile<VEC, SU>(src, Lb, n, base, next + rank * SR,
                                        smem, ring);
                else
                    for (int t = rank - S + 1; t < nrt; t += CS - S)
                        panel_tile<VEC, 8>(src, Lb, n, base, next + t * BS,
                                           smem, ring);
            }
            __syncthreads();
            cluster_arrive();
            if (rank < S) {
                if (threadIdx.x < S)
                    mbar_arrive_remote(mapa(smem_u32(&rows), threadIdx.x));
                if (threadIdx.x == 0) mbar_wait(&rows, kb & 1);
                __syncthreads();
                trailing_tile<VEC, SU>(src, Lb, n, base, next + rank * SR,
                                       next, ring);
                __syncthreads();
            }
        }
        if (rank == 0) {
            if (kb >= 0) {
                if (threadIdx.x == 0) mbar_wait(&strips, kb & 1);
                __syncthreads();
            }
            block_factor(kb < 0 ? Ab : Lb, Lb,
                         Yb + ((kb + 1) % nslot) * dstride, n, next, VEC,
                         smem);
            if (kb >= 0) cluster_wait();
        } else if (kb >= 0) {
            if (rank < S && threadIdx.x == 0)
                mbar_arrive_remote(mapa(smem_u32(&strips), 0));
            cluster_wait();
            // the other trailing tiles, on CTAs S .. CS-1 first
            const int slot = rank >= S ? rank - S : rank + CS - S - 1;
            for (int idx = 1 + slot; idx < nrt * (nrt + 1) / 2;
                 idx += CS - 1) {
                int ti, cj;
                trailing_of(idx, kb, &ti, &cj);
                trailing_tile<VEC, 8>(src, Lb, n, base, next + ti * BS,
                                      cj * BS, ring);
            }
        }
        cluster.sync();
    }
}

// ---------------------------------------------------------------------------
// The launch paths, on stream s.  path 0: one cluster launch (n > 128);
// path 1: one launch per step.  Each returns the first launch error, or 0.
// ---------------------------------------------------------------------------

template <bool VEC>
int chol_launch_steps(const float* A, float* L, float* Dinv, int nslot, int B,
                      int n, cudaStream_t s)
{
    static unsigned set_b, set_p, set_t;
    const auto kp = chol_tile_kernel<VEC, true>;
    const auto kt = chol_tile_kernel<VEC, false>;
    cudaError_t e = smem_limit_once((const void*)chol_block_kernel,
                                    SM_BYTES, &set_b);
    if (e == cudaSuccess)
        e = smem_limit_once((const void*)kp, SM_BYTES, &set_p);
    if (e == cudaSuccess)
        e = smem_limit_once((const void*)kt, SM_BYTES, &set_t);
    if (e != cudaSuccess) return (int)e;
    const int nb = (n + BS - 1) / BS;
    const size_t dstride = (size_t)B * BS * BS;
    for (int kb = 0; kb < nb; ++kb) {
        const float* src = kb == 0 ? A : L;
        float* Y = Dinv + (kb % nslot) * dstride;
        chol_block_kernel<<<B, NT, SM_BYTES, s>>>(src, L, Y, (size_t)BS * BS,
                                                  n, kb * BS, VEC);
        if (kb + 1 == nb) break;
        const int nrt = nb - 1 - kb;
        kp<<<dim3(nrt, B), NT, SM_BYTES, s>>>(src, L, Y, (size_t)BS * BS, n,
                                              kb);
        kt<<<dim3(nrt * (nrt + 1) / 2, B), NT, SM_BYTES, s>>>(
            src, L, Dinv, (size_t)BS * BS, n, kb);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

// One cluster launch of CS CTAs per matrix; with `active`, only ask the
// occupancy calculator how many such clusters are resident at once.
template <bool VEC, int CS>
cudaError_t launch_cluster(const float* A, float* L, float* Dinv, int nslot,
                           int B, int n, cudaStream_t s, int* active)
{
    static unsigned set;
    const auto fn = chol_cluster_kernel<VEC, CS>;
    cudaError_t e = smem_limit_once((const void*)fn, SM_BYTES, &set);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS * B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = SM_BYTES;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (active) return cudaOccupancyMaxActiveClusters(active, fn, &cfg);
    return cudaLaunchKernelEx(&cfg, fn, A, L, Dinv, nslot, n);
}

// CS = 8 where B clusters of 8 are resident at once on this device (asked
// once per device), else 4.
template <bool VEC>
int chol_launch_cluster(const float* A, float* L, float* Dinv, int nslot,
                        int B, int n, cudaStream_t s)
{
    static int active8[32];             // per device; 0: not asked yet
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    int& m = active8[dev & 31];
    if (e == cudaSuccess && m == 0) {
        e = launch_cluster<VEC, 8>(A, L, Dinv, nslot, B, n, s, &m);
        if (m == 0) m = -1;
    }
    if (e == cudaSuccess)
        e = m >= B ? launch_cluster<VEC, 8>(A, L, Dinv, nslot, B, n, s,
                                            nullptr)
                   : launch_cluster<VEC, 4>(A, L, Dinv, nslot, B, n, s,
                                            nullptr);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int chol_factor(const float* A, float* L, float* Dinv, int nslot, int B,
                int n, int path, cudaStream_t s)
{
    if (B < 1 || n < 1 || nslot < 1 || (path != 0 && path != 1) ||
        !aligned16(Dinv))
        return (int)cudaErrorInvalidValue;
    if (n <= SB) {
        chol_warp_kernel<<<B, 128, 0, s>>>(A, L, Dinv, n);
        return (int)cudaGetLastError();
    }
    const bool vec = n % 4 == 0 && aligned16(A) && aligned16(L);
    if (path == 0 && n > BS)
        return vec ? chol_launch_cluster<true>(A, L, Dinv, nslot, B, n, s)
                   : chol_launch_cluster<false>(A, L, Dinv, nslot, B, n, s);
    return vec ? chol_launch_steps<true>(A, L, Dinv, nslot, B, n, s)
               : chol_launch_steps<false>(A, L, Dinv, nslot, B, n, s);
}

}  // namespace
