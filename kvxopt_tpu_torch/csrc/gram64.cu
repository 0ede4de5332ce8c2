// Batched float64 scaled Gram product (K7), for Hopper (sm_90a):
// K = C0 + G' diag(w) G + reg I with w_i = 1 / d_i^2, for every lane,
// G (m, n) shared by the lanes or one a lane, C0 absent, shared or one a
// lane.  K's lower triangle and its diagonal tiles are written; the other
// tiles above the diagonal are left as they were (the factor that follows
// reads the lower triangle alone).
//
// Why it was added.  It replaces no Pallas kernel: the JAX package forms
// chol2's K = P + Gs'Gs (Gs = W^-T G) with XLA.  On an orthant Gs is
// G / d, and the port wrote it out for every lane, 808 MB at B = 100,
// m = 1000, n = 1010 (portfolio-frontier, G shared by the lanes): the
// divide, torch.cat's copy of it, a cuBLAS GEMM of both triangles of
// Gs'Gs, the add of P and that of reg I took 6.9 ms a factorization on
// an H100, 4.8 of it the GEMM.
//
// What bounds it.  The lower triangle's m n^2 flops a lane (the syrk's
// count), 1.02e9 at m = 1000, n = 1010: 1.52 ms at B = 100 on the f64
// tensor cores' 67 TFLOP/s.  G read once and K's lower triangle written
// once are ~0.13 ms at 3.35 TB/s, so the work, not the bytes, bounds it;
// but each output tile reads two column panels of G (2 T m doubles) from
// L2, 6.6 GB at B = 100 with 128-tiles, and on the card those copies,
// and the barriers that hand a stage of them from one chunk of rows to
// the next, cost as much as a fifth of the time of the products.
//
// Design.
//  1. One output tile of T x T (T = 128, or 64 where the batch is too
//     small to fill the card with 128-tiles) a unit of work, lower tiles
//     only: 36 a lane at n = 1010 and T = 128.  A persistent grid, as many
//     CTAs as the card holds at once, walks over the (lane, tile) pairs
//     in order, so that the CTAs at work at one time read the same lanes
//     and a G that is shared (8 MB) or one lane's own stays in L2.
//  2. The product runs on the f64 tensor cores, mma.sync m16n8k16 (wgmma
//     has no f64).  A CTA has T / 16 warps, each 32 rows by T / 2
//     columns of the tile, the sums in registers.  The tile's rows are
//     taken in an order that puts the two rows of a fragment side by side
//     (fragment row g is tile row 2g, row g + 8 is 2g + 1), and so are the
//     columns of two neighbouring 8-column blocks, so that every operand
//     fragment is read from shared memory 16 bytes at a time.
//  3. G's rows stream through a ring of 3 stages of 32 rows: a stage holds
//     the row panel's and the column panel's 32 x T blocks (one only on a
//     diagonal tile, which reads the same panel twice), each row one bulk
//     copy (cp.async.bulk), and the rows' d.  Every warp copies a few rows
//     of each stage, and a stage's full and empty mbarriers replace the
//     CTA's barrier: a warp waits for a stage's bytes, and refills the
//     stage of the chunk before its current one once every warp is done
//     with it, so the warps run up to a chunk apart instead of in step
//     (2.84 against 3.31 ms at B = 100 with a barrier a chunk).  The ring
//     runs on from one tile into the next, so the next tile's loads are in
//     flight while a tile's sums are stored.
//  4. The weights multiply one operand only, in registers as its
//     fragments are read: lane l forms w for the stage's row l and the
//     others take theirs by shuffles.  Rows past m weigh 0, and a chunk's
//     16 rows that all lie past m are skipped.
//  5. Epilogue: C0's elements (read at its lane stride, 0 for a shared
//     C0), a row block's all loaded before any is used, and reg on the
//     diagonal are added to the sums, which are stored into K (B, n, n)
//     row-major; rows and columns past n are not stored.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include "common.cuh"

namespace {

constexpr int K7_KC = 32;                     // rows of G a ring stage holds
static_assert(K7_KC % 16 == 0 && K7_KC <= 64,
              "16-deep products, at most 2 weights a lane");
constexpr int K7_S = 3;                       // ring stages
constexpr unsigned K7_FULL = 0xffffffffu;

template <int T>
struct K7Shape {
    static constexpr int WC = 2;              // warps across a tile
    static constexpr int NW = (T / 32) * WC;  // warps, each 32 rows
    static constexpr int NT = 32 * NW;        // threads of a CTA
    static constexpr int MINB = T == 64 ? 2 : 1;  // CTAs an SM holds
    static constexpr int RW = K7_KC / NW;     // rows a warp copies a stage
    static_assert(K7_KC % NW == 0, "a warp copies whole rows");
    static constexpr int WN = T / WC;         // a warp's columns
    static constexpr int NP = WN / 16;        // its pairs of 8-column blocks
    static constexpr int LD = T + 4;          // doubles a panel row
    static constexpr int PANEL = K7_KC * LD;
    static constexpr int STAGE = 2 * PANEL + K7_KC;
    // the ring, then a full and an empty mbarrier a stage
    static constexpr int SMEM = 8 * K7_S * STAGE + 16 * K7_S;
};

// The lane and the lower tile (I >= J) of (lane, tile) pair tau, tpl tiles
// a lane, numbered row by row.
__device__ __forceinline__ void tile_of(long long tau, int tpl, int& lane,
                                        int& I, int& J)
{
    lane = (int)(tau / tpl);
    const int r = (int)(tau - (long long)lane * tpl);
    int i = (int)((sqrt(8.0 * r + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > r) --i;
    while ((i + 1) * (i + 2) / 2 <= r) ++i;
    I = i;
    J = r - i * (i + 1) / 2;
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory with the bulk-copy engine, the bytes
// completed on the mbarrier bar.
__device__ __forceinline__ void bulk_g2s(double* dst, const double* src,
                                         unsigned bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(bar)) : "memory");
}

// Arrive on the mbarrier bar once this thread's cp.async copies so far
// are done (the barrier's expected count is raised by one meanwhile).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar)
{
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Warp w's share of filling ring stage st: rows r0 + w RW.. (RW of them)
// of a lane's G (row stride ldg), the columns p0.. and, off the diagonal,
// q0.. (T each, fewer at the last column block, rounded up to an even
// count that the row stride holds), by bulk copies, a row past m copied
// from `zeros`; warp 0 also copies the stage's rows of d by cp.async,
// zero-filled past m.  All of it completes on the stage's mbarrier full,
// which expects one arrival a warp.  The columns past n are left as they
// were: they meet only rows and columns of K past n.
template <int T>
__device__ __forceinline__ void load_stage(double* st, uint64_t* full,
                                           const double* Gl, int ldg,
                                           const double* dl,
                                           const double* zeros, int m, int n,
                                           int r0, int p0, int q0)
{
    using S = K7Shape<T>;
    const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
    const int ne = (n + 1) & ~1;
    const bool two = p0 != q0;
    const int wp = min(T, ne - p0), wq = min(T, ne - q0);
    if (w == 0) {
        for (int r = ln; r < K7_KC; r += 32) {
            const int row = r0 + r;
            cp_async8(st + 2 * S::PANEL + r, row < m ? dl + row : dl,
                      row < m);
        }
        cp_async_arrive(full);
        __syncwarp();
    }
    if (ln == 0) mbar_arm(full, 8u * S::RW * (wp + (two ? wq : 0)));
    __syncwarp();
    if (ln < S::RW) {
        const int r = w * S::RW + ln, row = r0 + r;
        const bool ok = row < m;
        const double* src = Gl + (size_t)row * ldg;
        bulk_g2s(st + r * S::LD, ok ? src + p0 : zeros, 8u * wp, full);
        if (two)
            bulk_g2s(st + S::PANEL + r * S::LD, ok ? src + q0 : zeros,
                     8u * wq, full);
    }
}

template <int T>
__global__ void __launch_bounds__(K7Shape<T>::NT, K7Shape<T>::MINB)
gram64_kernel(const double* __restrict__ G, long long gs, int ldg,
              const double* __restrict__ d,
              const double* __restrict__ zeros,
              const double* __restrict__ C0, long long cs, double reg,
              double* __restrict__ K, int B, int m, int n, bool vec)
{
    using S = K7Shape<T>;
    extern __shared__ __align__(16) double k7_smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(k7_smem + K7_S * S::STAGE);
    uint64_t* empty = full + K7_S;
    const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
    const int g = ln >> 2, t = ln & 3;
    const int wm = w / S::WC, wn = w % S::WC;
    const int nt = (n + T - 1) / T;
    const int tpl = nt * (nt + 1) / 2;
    const long long total = (long long)B * tpl;
    const int nk = (m + K7_KC - 1) / K7_KC;
    const long long first = blockIdx.x, step = gridDim.x;

    if (tid == 0) {
        for (int q = 0; q < K7_S; ++q) {
            mbar_init(full + q, S::NW);
            mbar_init(empty + q, 32 * S::NW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the ring's producer, every warp its share: the next chunk to load,
    // of the CTA's tiles in order
    long long pq = 0, ptau = first;
    int pk = 0, plane = 0, pI = 0, pJ = 0;
    if (ptau < total) tile_of(ptau, tpl, plane, pI, pJ);
    auto issue = [&]() {
        if (ptau >= total) return;
        const int st = (int)(pq % K7_S);
        const long long round = pq / K7_S;
        // the chunk that last held the stage is done in every warp
        if (round) mbar_wait(empty + st, (unsigned)((round - 1) & 1));
        load_stage<T>(k7_smem + st * S::STAGE, full + st, G + plane * gs,
                      ldg, d + (size_t)plane * m, zeros, m, n, pk * K7_KC,
                      pI * T, pJ * T);
        ++pq;
        if (++pk == nk) {
            pk = 0;
            ptau += step;
            if (ptau < total) tile_of(ptau, tpl, plane, pI, pJ);
        }
    };
    for (int q = 0; q < K7_S - 1; ++q) issue();

    int cst = 0;                              // the ring stage to use next
    unsigned phase = 0;                       // and its mbarriers' phase
    for (long long tau = first; tau < total; tau += step) {
        int lane, I, J;
        tile_of(tau, tpl, lane, I, J);
        const bool diag = I == J;
        double acc[2][2 * S::NP][4] = {};
        for (int kk = 0; kk < nk; ++kk) {
            mbar_wait(full + cst, phase);
            const double* Ps = k7_smem + cst * S::STAGE;
            const double* Qs = diag ? Ps : Ps + S::PANEL;
            uint64_t* release = empty + cst;
            if (++cst == K7_S) {
                cst = 0;
                phase ^= 1;
            }
            // lane l forms the weights of the stage's rows l and l + 32,
            // 0 past m
            const int rows = m - kk * K7_KC;
            double wl[(K7_KC + 31) / 32];
#pragma unroll
            for (int x = 0; x < (K7_KC + 31) / 32; ++x) {
                const int r = 32 * x + ln;
                const double dv = r < K7_KC ? Ps[2 * S::PANEL + r] : 1.0;
                wl[x] = r < rows ? 1.0 / (dv * dv) : 0.0;
            }
#pragma unroll
            for (int s = 0; s < K7_KC / 16; ++s) {
                if (16 * s >= rows) break;    // past m: weight 0
                // depth 16 s + t + 4 i of the fragments is row
                // 16 s + t + 4 i of the stage
                double wk[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = 16 * s + 4 * i;    // and + t
                    wk[i] = __shfl_sync(K7_FULL, wl[r / 32], r % 32 + t);
                }
                double a[2][8];
#pragma unroll
                for (int mb = 0; mb < 2; ++mb) {
                    const double* Ar = Ps + (16 * s + t) * S::LD + 32 * wm +
                                       16 * mb + 2 * g;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const double2 v = *reinterpret_cast<const double2*>(
                            Ar + 4 * i * S::LD);
                        a[mb][2 * i] = v.x * wk[i];
                        a[mb][2 * i + 1] = v.y * wk[i];
                    }
                }
#pragma unroll
                for (int p = 0; p < S::NP; ++p) {
                    const double* Br = Qs + (16 * s + t) * S::LD +
                                       S::WN * wn + 16 * p + 2 * g;
                    double be[4], bo[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const double2 v = *reinterpret_cast<const double2*>(
                            Br + 4 * i * S::LD);
                        be[i] = v.x;
                        bo[i] = v.y;
                    }
#pragma unroll
                    for (int mb = 0; mb < 2; ++mb) {
                        dmma16x16(acc[mb][2 * p], a[mb], be);
                        dmma16x16(acc[mb][2 * p + 1], a[mb], bo);
                    }
                }
            }
            mbar_arrive(release);             // the stage may be refilled
            // the chunk after the next one, into the stage of the chunk
            // before this one: a warp waits here only for warps more than
            // a chunk behind it
            issue();
        }

        // K = C0 + the sums + reg on the diagonal, within n.  Lane (g, t)
        // holds, for each of its row blocks mb and rows 2g + h, the four
        // columns 16 p + 4t + 2e + b of pair p in acc[mb][2p + b][2h + e].
        // A row block's C0 elements are all loaded before any is used, so
        // that their latency is paid twice a tile.
        const double* Cl = C0 ? C0 + lane * cs : nullptr;
        double* Kl = K + (size_t)lane * n * n;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            double2 c[2][S::NP][2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int p = 0; p < S::NP; ++p)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = I * T + 32 * wm + 16 * mb + 2 * g + h;
                        const int col =
                            J * T + S::WN * wn + 16 * p + 4 * t + 2 * e;
                        const size_t at = (size_t)row * n + col;
                        c[h][p][e] = make_double2(0.0, 0.0);
                        if (Cl && row < n && col < n) {
                            if (vec) {
                                c[h][p][e] =
                                    *reinterpret_cast<const double2*>(Cl + at);
                            } else {
                                c[h][p][e].x = Cl[at];
                                if (col + 1 < n) c[h][p][e].y = Cl[at + 1];
                            }
                        }
                    }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int p = 0; p < S::NP; ++p)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = I * T + 32 * wm + 16 * mb + 2 * g + h;
                        const int col =
                            J * T + S::WN * wn + 16 * p + 4 * t + 2 * e;
                        if (row >= n || col >= n) continue;
                        double2 v = c[h][p][e];
                        v.x += acc[mb][2 * p][2 * h + e];
                        v.y += acc[mb][2 * p + 1][2 * h + e];
                        if (row == col) v.x += reg;
                        if (row == col + 1) v.y += reg;
                        const size_t at = (size_t)row * n + col;
                        if (vec) {
                            *reinterpret_cast<double2*>(Kl + at) = v;
                        } else {
                            Kl[at] = v.x;
                            if (col + 1 < n) Kl[at + 1] = v.y;
                        }
                    }
        }
    }
}

// The launch of K7 at tile order T: the shared-memory limit set once, and
// as many CTAs as the card holds at once, or as there are tiles.
template <int T>
cudaError_t gram64_launch(const double* G, long long gs, int ldg,
                          const double* d, const double* zeros,
                          const double* C0, long long cs, double reg,
                          double* K, int B, int m, int n, bool vec,
                          cudaStream_t s)
{
    using S = K7Shape<T>;
    static unsigned smem_set;
    static int resident[64];
    cudaError_t e = smem_limit_once((const void*)gram64_kernel<T>, S::SMEM,
                                    &smem_set, true);
    if (e != cudaSuccess) return e;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && resident[dev] == 0) {
        int sms = 0, per = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, gram64_kernel<T>, S::NT, S::SMEM);
        if (e != cudaSuccess) return e;
        if (per < 1) return cudaErrorInvalidConfiguration;
        resident[dev] = sms * per;
    }
    const int nt = (n + T - 1) / T;
    const long long total = (long long)B * (nt * (nt + 1) / 2);
    const int hold = dev < 64 ? resident[dev] : 132;
    const int grid = (int)(total < hold ? total : hold);
    gram64_kernel<T><<<grid, S::NT, S::SMEM, s>>>(G, gs, ldg, d, zeros, C0,
                                                  cs, reg, K, B, m, n, vec);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K (B, n, n) row-major, contiguous = C0 + G' diag(d)^-2 G + reg I, its
// lower triangle and diagonal T x T tiles (T = 64 or 128, the wrapper's
// plan).  G (m, n) row-major, row stride ldg (even, at least n rounded
// up to even, 16-byte aligned), at lane stride gs (0: shared, or m ldg);
// d (B, m) contiguous; zeros at least 128 zeros, 16-byte aligned; C0
// (n, n) row-major at lane stride cs (0: shared, or n n) or null.
int kvx_gram64(const void* G, long long gs, int ldg, const void* d,
               const void* zeros, const void* C0, long long cs, double reg,
               void* K, int B, int m, int n, int T, void* stream)
{
    const double* g = (const double*)G;
    const double* z = (const double*)zeros;
    const double* c = (const double*)C0;
    double* k = (double*)K;
    cudaStream_t s = (cudaStream_t)stream;
    if (B < 1 || m < 1 || n < 1 || n > 46340 || ldg % 2 || ldg < n + n % 2
        || (long long)m * ldg >= (1LL << 31) || !aligned16(g)
        || !aligned16(z) || (T != 64 && T != 128))
        return (int)cudaErrorInvalidValue;
    const bool vec = n % 2 == 0 && aligned16(k) &&
                     (c == nullptr || aligned16(c));
    const cudaError_t e =
        T == 128 ? gram64_launch<128>(g, gs, ldg, (const double*)d, z, c, cs,
                                      reg, k, B, m, n, vec, s)
                 : gram64_launch<64>(g, gs, ldg, (const double*)d, z, c, cs,
                                     reg, k, B, m, n, vec, s);
    return (int)e;
}

}  // extern "C"
