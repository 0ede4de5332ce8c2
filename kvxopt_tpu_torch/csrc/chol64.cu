// Batched float64 Cholesky factor (K6), for Hopper (sm_90a): L L^T = K for
// symmetric positive definite K (B, n, n), the lower triangle read.
//
// Why it was added.  It replaces no Pallas kernel: the JAX package leaves
// its float64 factors to XLA (jnp.linalg.cholesky), and the port sent them
// to torch.linalg.cholesky_ex, which runs cuSOLVER's batched potrf and
// clears the upper triangle in a pass of its own, followed by a NaN select
// over the whole factor.  In the batched QP path (kkt._kkt_chol2,
// n = 1010) those took ~2.7 ms a factor at B = 32 and ~6.7 ms at B = 100,
// about 9 to 13 times the bound below.
//
// What bounds it.  n^3 / 3 flops a lane: 3.43e8 at n = 1010, 0.51 ms at
// B = 100 on the f64 tensor cores' 67 TFLOP/s; K read and L written once
// are 16.3 MB a lane, 0.49 ms at B = 100 at 3.35 TB/s.  One lane's K is
// 8.2 MB, beyond a CTA's or a cluster's shared memory, and 100 lanes
// (816 MB) are beyond the 50 MB L2, so a right-looking update that reads
// and writes the trailing matrix at each panel step (~86 MB a lane) would
// be bound by its bytes at ~5 times the bound.  Within a lane the chain
// of diagonal-tile factors is serial.
//
// Design.
//  1. Left-looking by 64 x 64 tiles: the tile (i, j) of L is
//     (K(i, j) - sum_k<j L(i, k) L(j, k)^T) L(j, j)^-T, made once from the
//     finished panels, so each tile of L is written once and L's earlier
//     panels are read, ~21 MB a lane at n = 1010 for the row blocks; the
//     panel's own rows, the same for all of its tiles, are read once for
//     every two row blocks.
//  2. The update runs on the f64 tensor cores: mma.sync m16n8k16 (wgmma
//     has no f64; m8n8k4 runs at half rate on Hopper).  A CTA of 8 warps
//     makes two row blocks of a panel at once (a "unit"), each warp 16 rows
//     by the panel's 64 columns, the sums in registers.  The operands
//     stream through a ring of 4 stages of depth 16 with cp.async; K's
//     tiles go to shared memory beside them.
//  3. Work: a thread-block cluster of C CTAs serves one lane and owns its
//     row blocks i with i % C == rank; C comes from the wrapper's plan on
//     (B, n): the largest cluster whose B copies the card holds at once
//     (B = 100: one CTA a lane, B = 32: 3, B = 1: 8).  At panel j the
//     owner of row block j updates and factors the diagonal tile first;
//     the other CTAs update their tiles meanwhile, then copy L(j, j) from
//     the owner's shared memory (one cluster barrier) and solve against
//     it.  A second cluster barrier ends the panel, so every CTA reads the
//     finished panel from memory.
//  4. Diagonal tile: warp 0 factors each 32 x 32 half (lane r holds row r;
//     a loop over the columns whose new column goes through shared memory
//     as broadcasts), the off-diagonal 32 x 32 block is solved by
//     substitution and the second half updated on the tensor cores.
//  5. Off-diagonal tiles are solved in the registers that hold their sums:
//     by blocks of 8 columns, substitution inside a block (one shuffle a
//     column) and the blocks to its right updated on the tensor cores; no
//     inverse of a block is formed.  L is stored from the registers.
//  6. A lane whose pivot is not positive (or NaN) comes out all NaN, as
//     chol_ls.cholesky_nan gives it; the other lanes are untouched.  The
//     upper triangle is written as zeros, by the CTA that makes the mirror
//     tile.  Rows and columns beyond n act as the identity.
//  7. n <= 32 (the Schur complement of the QP path, n = p = 11): one warp
//     a lane, the diagonal tile's 32 x 32 factor alone.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K6_T = 64;                      // tile order
constexpr int K6_KC = 16;                     // depth of a ring stage
constexpr int K6_LDS = K6_KC + 2;             // doubles per ring row
constexpr int K6_LDT = K6_T + 4;              // doubles per tile row
constexpr int K6_TILE = K6_T * K6_LDT;        // doubles per tile buffer
constexpr unsigned K6_FULL = 0xffffffffu;

// A unit is two of a CTA's row blocks of one panel (the panel's rows are
// read once for both), made by 8 warps of 16 rows by the panel's 64
// columns.  Shared memory: the ring of S stages (the unit's and the
// panel's rows), K's tiles of the unit, the diagonal tile and its
// reciprocal pivots, a column of scratch, the failure flag.
constexpr int K6_NT = 256;                    // threads of a CTA
constexpr int K6_R = 2 * K6_T;                // rows of a unit
constexpr int K6_S = 4;                       // ring stages
constexpr int K6_STAGE = (K6_R + K6_T) * K6_LDS;
constexpr int K6_SMEM =
    8 * (K6_S * K6_STAGE + K6_R * K6_LDT + K6_TILE + 2 * K6_T) + 16;

// d += a b over an 8 x 4 by 4 x 8 product (the small update inside the
// diagonal tile)
__device__ __forceinline__ void dmma8(double (&d)[2], double a, double b)
{
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64"
                 " {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}

// d += a b over a 16 x 8 by 8 x 8 product: lane (g, t) = (lane / 4,
// lane % 4) holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4],
// B[t][g], B[t + 4][g] and D[g][2t + e], D[g + 8][2t + e] (e = 0, 1).
// Hopper runs the m16n8 shapes at the full f64 tensor rate, m8n8k4 at
// half.
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[4],
                                       double b0, double b1)
{
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64"
                 " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
                 " {%0, %1, %2, %3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0),
                   "d"(b1));
}

// Wait until at most n (0..K6_S - 1) of this thread's cp.async groups are
// pending: the count is an immediate.
__device__ __forceinline__ void cp_async_wait_upto(int n)
{
    static_assert(K6_S == 4, "one case per count");
    switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
    }
}

__device__ __forceinline__ void cluster_arrive_relaxed()
{
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warp factors the 32 x 32 block at A (row stride LD; lane r reads
// row r of its lower triangle) in place, the upper triangle cleared, and
// writes the reciprocal pivots to dinv; returns whether a pivot was not
// positive.  Column k is a[0] at step k (each step shifts the row by one,
// so that the loop over the columns needs no unrolling and its code stays
// small); the new column of L goes through col (64 doubles of shared
// memory) and is read back as broadcasts at fixed offsets.
template <int LD>
__device__ __forceinline__ bool chol32_smem(double* A, double* dinv,
                                            double* col)
{
    const int r = threadIdx.x & 31;
    double a[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) a[c] = A[r * LD + c];
    double d = __shfl_sync(K6_FULL, a[0], 0);
    bool bad = false;
#pragma unroll 1
    for (int k = 0; k < 32; ++k) {
        bad |= !(d > 0.0);
        const double inv = rsqrt(d);
        const double l = r > k ? a[0] * inv : (r == k ? d * inv : 0.0);
        // the next pivot first, from lane k + 1's own L[k + 1][k], so that
        // its shuffle and square root wait for no shared memory and run
        // under the rest of the update
        d = __shfl_sync(K6_FULL, fma(-l, l, a[1]), (k + 1) & 31);
        A[r * LD + k] = l;
        col[r] = l;
        if (r == k) dinv[k] = inv;
        __syncwarp();
        // a[c] <- a[c + 1] - L[r][k] L[k + 1 + c][k]; col's slots past 31,
        // and lane r's slots past column r, are never read as results
        const double* ck = col + k + 1;
#pragma unroll
        for (int c = 0; c < 31; ++c) a[c] = fma(-l, ck[c], a[c + 1]);
        __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < 32; ++c)
        if (c > r) A[r * LD + c] = 0.0;
    __syncwarp();
    return bad;
}

// The CTA (its first 4 warps work) factors the 64 x 64 tile A (row
// stride K6_LDT, lower triangle read) in place, its upper triangle
// cleared, and writes the reciprocal pivots to dinv, with col (64 doubles)
// as scratch; warp 0 sets *fail where a pivot fails.  Ends with a barrier.
__device__ void factor64(double* A, double* dinv, double* col, int* fail)
{
    const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
    if (w == 0 && chol32_smem<K6_LDT>(A, dinv, col) && ln == 0) *fail = 1;
    __syncthreads();
    if (w < 4) {
        // A21 <- A21 L11^-T: 4 lanes a row, lane q the columns 4m + q
        const int r = 32 + (tid >> 2), q = tid & 3;
        double x[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) x[m] = A[r * K6_LDT + 4 * m + q];
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            const int m0 = c >> 2, q0 = c & 3;
            const double xc = __shfl_sync(K6_FULL, x[m0] * dinv[c],
                                          (ln & ~3) | q0);
            if (q == q0) x[m0] = xc;
#pragma unroll
            for (int m = m0; m < 8; ++m)
                if (m > m0 || q > q0)
                    x[m] = fma(-xc, A[(4 * m + q) * K6_LDT + c], x[m]);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) A[r * K6_LDT + 4 * m + q] = x[m];
    }
    __syncthreads();
    if (w < 4) {
        // A22 -= A21 A21^T on the tensor cores: warp w makes rows 8w..
        const int g = ln >> 2, t = ln & 3, r0 = 32 + 8 * w;
        double acc[4][2] = {};
#pragma unroll
        for (int kk = 0; kk < 32; kk += 4) {
            const double a = A[(r0 + g) * K6_LDT + kk + t];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
                dmma8(acc[ni], a, A[(32 + ni * 8 + g) * K6_LDT + kk + t]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                A[(r0 + g) * K6_LDT + 32 + ni * 8 + 2 * t + e] -= acc[ni][e];
    }
    __syncthreads();
    if (w == 0 &&
        chol32_smem<K6_LDT>(A + 32 * K6_LDT + 32, dinv + 32, col) && ln == 0)
        *fail = 1;
    for (int e = tid; e < 32 * 32; e += K6_NT)
        A[(e >> 5) * K6_LDT + 32 + (e & 31)] = 0.0;
    __syncthreads();
}

// The warp solves X Ljj^T = T for its 16 rows of T, held in the
// accumulator layout (x[ni]: rows g, g + 8 and columns 8 ni + 2t + e),
// Ljj lower with reciprocal pivots dinv, in place: by blocks of 8 columns,
// substitution inside a block (one shuffle a column, no inverse formed)
// and the blocks to its right updated on the tensor cores.
__device__ __forceinline__ void trsm_rows(double (&x)[8][4],
                                          const double* Ljj,
                                          const double* dinv)
{
    const int ln = threadIdx.x & 31, g = ln >> 2, t = ln & 3;
    const int base = ln & ~3;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int t0 = c >> 1, e0 = c & 1;
            const double dc = dinv[8 * b + c];
            double l[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
                l[e] = 2 * t + e > c
                           ? Ljj[(8 * b + 2 * t + e) * K6_LDT + 8 * b + c]
                           : 0.0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const double xc = __shfl_sync(K6_FULL, x[b][2 * h + e0] * dc,
                                              base | t0);
                if (t == t0) x[b][2 * h + e0] = xc;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    x[b][2 * h + e] = fma(-xc, l[e], x[b][2 * h + e]);
            }
        }
        if (b == 7) break;
        // -X_b as an A fragment: X[g][t] lies in lane (g, t / 2), element
        // t % 2, and X[g][t + 4] in lane (g, t / 2 + 2)
        const int s0 = base | (t >> 1), s1 = s0 + 2;
        const bool odd = t & 1;
        double a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int src = q < 2 ? s0 : s1, h = q & 1;
            const double v0 = __shfl_sync(K6_FULL, x[b][2 * h], src);
            const double v1 = __shfl_sync(K6_FULL, x[b][2 * h + 1], src);
            a[q] = -(odd ? v1 : v0);
        }
#pragma unroll
        for (int b2 = b + 1; b2 < 8; ++b2) {
            const double* Lr = Ljj + (8 * b2 + g) * K6_LDT + 8 * b + t;
            dmma16(x[b2], a, Lr[0], Lr[4]);
        }
    }
}

// The CTA starts the copy of depth k0..k0+15 of the unit's rows (ra..,
// and rc.. for its second block) and of the panel's rows rb.. of the
// lane's L (row-major, order n) into ring stage st; rows past n are
// zero-filled.
__device__ __forceinline__ void load_stage(double* st, const double* Lb,
                                           int n, int ra, int rc, int rb,
                                           int k0, bool vec)
{
    // the stage's three 64-row blocks: the unit's two, the panel's
    const int base[3] = {ra, rc, rb};
    if (vec) {
        // 8 copies of 16 bytes a row; thread tid copies piece tid % 8 of
        // rows tid / 8 and tid / 8 + 32 of each block
        const int c = (threadIdx.x & 7) * 2, r0 = threadIdx.x >> 3;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
                const int r = r0 + 32 * x, row = base[q] + r;
                const bool ok = row < n;
                cp_async16(st + (q * K6_T + r) * K6_LDS + c,
                           ok ? Lb + row * n + k0 + c : Lb, ok);
            }
    } else {
        const int c = threadIdx.x & 15, r0 = threadIdx.x >> 4;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int r = r0 + 16 * x, row = base[q] + r;
                const bool ok = row < n;
                cp_async8(st + (q * K6_T + r) * K6_LDS + c,
                          ok ? Lb + row * n + k0 + c : Lb, ok);
            }
    }
}

// The CTA starts the copy of K's tiles of the unit (rows ra.., and rc..
// for its second block; columns c0..) into Ts, zero-filled past n.  The
// diagonal tile's upper part is copied too and never used.
__device__ __forceinline__ void load_ktile(double* Ts, const double* Kb,
                                           int n, int ra, int rc, int c0,
                                           bool vec)
{
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll 4
        for (int it = 0; it < K6_R * K6_T / 2 / K6_NT; ++it) {
            const int idx = it * K6_NT + tid;
            const int r = idx >> 5, c = (idx & 31) * 2;
            const int row = (r < K6_T ? ra : rc - K6_T) + r, col = c0 + c;
            const bool ok = row < n && col < n;
            cp_async16(Ts + r * K6_LDT + c, ok ? Kb + row * n + col : Kb, ok);
        }
    } else {
#pragma unroll 4
        for (int it = 0; it < K6_R * K6_T / K6_NT; ++it) {
            const int idx = it * K6_NT + tid;
            const int r = idx >> 6, c = idx & 63;
            const int row = (r < K6_T ? ra : rc - K6_T) + r, col = c0 + c;
            const bool ok = row < n && col < n;
            cp_async8(Ts + r * K6_LDT + c, ok ? Kb + row * n + col : Kb, ok);
        }
    }
}

// The CTA writes the factored diagonal tile A (row stride K6_LDT, upper
// part zero) to L at row and column block j, within n.
__device__ __forceinline__ void store_diag(double* Lb, const double* A, int n,
                                           int j)
{
    const int r0 = j * K6_T;
    for (int idx = threadIdx.x; idx < K6_T * K6_T; idx += K6_NT) {
        const int r = idx >> 6, c = idx & 63;
        if (r0 + r < n && r0 + c < n)
            Lb[(r0 + r) * n + r0 + c] = A[r * K6_LDT + c];
    }
}

// The CTA writes zeros to L's tile at rows r0.., columns c0.., within n.
__device__ __forceinline__ void store_zeros(double* Lb, int n, int r0, int c0,
                                            bool vec)
{
    if (vec) {
        for (int idx = threadIdx.x; idx < K6_T * K6_T / 2;
             idx += K6_NT) {
            const int r = idx >> 5, c = (idx & 31) * 2;
            if (r0 + r < n && c0 + c < n)
                *reinterpret_cast<double2*>(Lb + (r0 + r) * n + c0 + c) =
                    make_double2(0.0, 0.0);
        }
    } else {
        for (int idx = threadIdx.x; idx < K6_T * K6_T; idx += K6_NT) {
            const int r = idx >> 6, c = idx & 63;
            if (r0 + r < n && c0 + c < n) Lb[(r0 + r) * n + c0 + c] = 0.0;
        }
    }
}

__global__ void __launch_bounds__(K6_NT, 1)
chol64_kernel(const double* __restrict__ K, double* __restrict__ L, int n,
              bool vec)
{
    extern __shared__ __align__(16) double k6_smem_d[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int cr = (int)cluster.block_rank();
    const int lane = blockIdx.x / C;
    const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
    const int g = ln >> 2, t = ln & 3;
    const int nt = (n + K6_T - 1) / K6_T;
    const double* Kb = K + (size_t)lane * n * n;
    double* Lb = L + (size_t)lane * n * n;

    double* ring = k6_smem_d;
    double* Ts = ring + K6_S * K6_STAGE;      // K's tiles of the unit
    double* Ljj = Ts + K6_R * K6_LDT;         // L(j, j), then its pivots
    double* dinv = Ljj + K6_TILE;
    double* col = dinv + K6_T;
    int* fail = reinterpret_cast<int*>(col + K6_T);
    if (tid == 0) *fail = 0;
    __syncthreads();

    // warp w makes the unit's rows 16w.. (in its block w / 4), all 64
    // columns
    const int wb = w / 4, wr = 16 * (w % 4) + g;
    for (int j = 0; j < nt; ++j) {
        const bool owner = j % C == cr;
        const int nk = j * K6_T / K6_KC;
        // the CTA's row blocks of the panel: i0, i0 + C, ...; unit u holds
        // the two from i0 + 2 u C
        const int i0 = j + ((cr - j % C) % C + C) % C;
        const int nblk = i0 < nt ? (nt - 1 - i0) / C + 1 : 0;
        const int nunit = (nblk + 1) / 2;
        const int F = nunit * nk;
        if (!owner) cluster_arrive_relaxed();
        bool waited = owner;

        // the ring's producer: chunk p (stage ps) is the unit from row
        // block pi, depth pk, of the panel's F chunks
        int p = 0, ps = 0, pi = i0, pk = 0;
        auto issue = [&]() {
            if (p < F) {
                load_stage(ring + ps * K6_STAGE, Lb, n, pi * K6_T,
                           (pi + C) * K6_T, j * K6_T, pk, vec);
                pk += K6_KC;
                if (pk == j * K6_T) {
                    pk = 0;
                    pi += 2 * C;
                }
            }
            cp_async_commit();
            ++p;
            if (++ps == K6_S) ps = 0;
        };
        int fs = 0;                 // the ring stage to use next
        for (int q = 0; q < K6_S - 1; ++q) issue();

        for (int u = 0; u < nunit; ++u) {
            const int b0 = i0 + 2 * u * C;    // the unit's first block
            const int i = b0 + wb * C;        // this warp's block
            const bool dunit = b0 == j;       // the owner's diagonal unit
            load_ktile(Ts, Kb, n, b0 * K6_T, (b0 + C) * K6_T, j * K6_T, vec);
            cp_async_commit();
            double acc[8][4] = {};
            for (int kc = 0; kc < nk; ++kc) {
                // the unit's chunk kc has landed (K's tiles, committed
                // after the chunks already in flight, may still be pending)
                cp_async_wait_upto(kc <= K6_S - 2 ? K6_S - 1 : K6_S - 2);
                __syncthreads();
                issue();
                const double* As = ring + fs * K6_STAGE;
                const double* Bs = As + K6_R * K6_LDS;
                if (++fs == K6_S) fs = 0;
                // the fragments' depths t + 4q (q = 0..3) are the stage's
                // columns 4t + q (any order of the depths gives the same
                // sum): two 16-byte loads a row
                const double* Ar = As + (16 * w + g) * K6_LDS + 4 * t;
                double2 av[4];
#pragma unroll
                for (int h = 0; h < 4; ++h)
                    av[h] = *reinterpret_cast<const double2*>(
                        Ar + (h & 1) * 8 * K6_LDS + (h >> 1) * 2);
                const double a[8] = {av[0].x, av[1].x, av[0].y, av[1].y,
                                     av[2].x, av[3].x, av[2].y, av[3].y};
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    const double* Br = Bs + (8 * ni + g) * K6_LDS + 4 * t;
                    const double2 b0 = *reinterpret_cast<const double2*>(Br);
                    const double2 b1 =
                        *reinterpret_cast<const double2*>(Br + 2);
                    const double b[4] = {b0.x, b0.y, b1.x, b1.y};
                    dmma16x16(acc[ni], a, b);
                }
            }
            cp_async_wait_upto(nk < K6_S - 1 ? nk : K6_S - 1);
            __syncthreads();
            // T = K(i, j) - sum L(i, k) L(j, k)^T, in the accumulators (to
            // Ljj for the diagonal tile); rows and columns past n are the
            // identity's
            const bool drows = i == j;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = wr + (e >> 1) * 8;
                    const int c = 8 * ni + 2 * t + (e & 1);
                    double v = Ts[(16 * w + g + (e >> 1) * 8) * K6_LDT + c] -
                               acc[ni][e];
                    if (drows && r == c && j * K6_T + r >= n) v = 1.0;
                    acc[ni][e] = v;
                    if (drows) Ljj[r * K6_LDT + c] = v;
                }
            if (dunit) {
                __syncthreads();
                factor64(Ljj, dinv, col, fail);
                cluster_arrive();
                cluster_wait();
                store_diag(Lb, Ljj, n, j);
            } else if (!waited) {
                // L(j, j) and its pivots from the owner's shared memory
                cluster_wait();
                waited = true;
                const double2* src = reinterpret_cast<const double2*>(
                    cluster.map_shared_rank(Ljj, j % C));
                double2* d2 = reinterpret_cast<double2*>(Ljj);
                for (int e = tid; e < (K6_TILE + K6_T) / 2; e += K6_NT)
                    d2[e] = src[e];
                __syncthreads();
            }
            // the rows outside the diagonal tile: solve, then store from
            // the registers, and zeros at the mirror tiles
            if (!drows && i < nt) {
                trsm_rows(acc, Ljj, dinv);
#pragma unroll
                for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = i * K6_T + wr + 8 * h;
                        const int col = j * K6_T + 8 * ni + 2 * t;
                        const double v0 = acc[ni][2 * h];
                        const double v1 = acc[ni][2 * h + 1];
                        if (row >= n || col >= n) continue;
                        if (vec) {
                            *reinterpret_cast<double2*>(Lb + row * n + col) =
                                make_double2(v0, v1);
                        } else {
                            Lb[row * n + col] = v0;
                            if (col + 1 < n) Lb[row * n + col + 1] = v1;
                        }
                    }
            }
            for (int q = 0; q < 2; ++q) {
                const int bq = b0 + q * C;
                if (bq != j && bq < nt)
                    store_zeros(Lb, n, j * K6_T, bq * K6_T, vec);
            }
            __syncthreads();
        }
        cp_async_wait<0>();
        if (!waited) cluster_wait();
        // the panel is in memory before any CTA reads it, and no CTA
        // overwrites its L(j, j) while a peer copies it
        cluster.sync();
    }

    // a failed pivot anywhere in the lane makes the lane NaN
    int bad = 0;
    for (int q = 0; q < C; ++q) bad |= *cluster.map_shared_rank(fail, q);
    cluster.sync();
    if (bad) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int r = cr; r < n; r += C)
            for (int c = tid; c < n; c += K6_NT) Lb[r * n + c] = nan;
    }
}

// One warp a lane for n <= 32: lane r holds row r.
__global__ void __launch_bounds__(128)
chol64_warp_kernel(const double* __restrict__ K, double* __restrict__ L,
                   int B, int n)
{
    constexpr int LD = 33;
    __shared__ double As[4][32 * LD];
    __shared__ double dv[4][32];
    __shared__ double cv[4][64];
    const int w = threadIdx.x >> 5, lane = blockIdx.x * 4 + w;
    if (lane >= B) return;
    const int r = threadIdx.x & 31;
    const double* Kb = K + (size_t)lane * n * n;
    double* Lb = L + (size_t)lane * n * n;
    double* A = As[w];
    for (int c = 0; c < 32; ++c)
        A[r * LD + c] = r < n && c <= r ? Kb[r * n + c] : (r == c ? 1.0 : 0.0);
    __syncwarp();
    const bool bad = chol32_smem<LD>(A, dv[w], cv[w]);
    if (r < n) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int c = 0; c < n; ++c) Lb[r * n + c] = bad ? nan : A[r * LD + c];
    }
}

cudaError_t k6_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int B, int C, cudaStream_t s)
{
    static unsigned smem_set;
    cudaError_t e = smem_limit_once((const void*)chol64_kernel, K6_SMEM,
                                    &smem_set, true);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(C * B);
    cfg.blockDim = dim3(K6_NT);
    cfg.dynamicSmemBytes = K6_SMEM;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return e;
}

}  // namespace

extern "C" {

// L (B, n, n) row-major, contiguous = the lower Cholesky factors of K
// (B, n, n) row-major, contiguous, lower triangles read: clusters of C
// (1..8) CTAs a lane (the wrapper's plan), or C = 0 for one warp a lane
// (n <= 32).
int kvx_chol64(const void* K, void* L, int B, int n, int C, void* stream)
{
    const double* k = (const double*)K;
    double* l = (double*)L;
    cudaStream_t s = (cudaStream_t)stream;
    if (B < 1 || n < 1 || n > 46340 || C < 0 || C > 8)
        return (int)cudaErrorInvalidValue;
    if (C == 0) {
        if (n > 32) return (int)cudaErrorInvalidValue;
        chol64_warp_kernel<<<(B + 3) / 4, 128, 0, s>>>(k, l, B, n);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = k6_config(cfg, attr, B, C, s);
    if (e != cudaSuccess) return (int)e;
    const bool vec = n % 2 == 0 && aligned16(k) && aligned16(l);
    e = cudaLaunchKernelEx(&cfg, chol64_kernel, k, l, n, vec);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The most clusters of C (1..8) CTAs of K6 that the current card holds at
// once (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
int kvx_chol64_clusters(int C)
{
    if (C < 1 || C > 8) return -(int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = k6_config(cfg, attr, 1, C, 0);
    int num = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveClusters(&num, chol64_kernel, &cfg);
    return e != cudaSuccess ? -(int)e : num;
}

}  // extern "C"
