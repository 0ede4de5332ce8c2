// Batched float64 Cholesky solve (K5), for Hopper (sm_90a): X = (L L^T)^{-1} R
// for lower factors L (B, n, n) and right-hand sides R (B, n, k), the
// forward and the backward sweep in one launch.
//
// Why it was added.  It replaces no Pallas kernel: the JAX package leaves
// its float64 solves to XLA, and the port sent them to two
// torch.linalg.solve_triangular calls, which run cuBLAS's batched trsm.
// In the batched QP path (kkt._kkt_chol2, B = 32, n = 1010, k = 1 and
// k = p = 11) those two calls took ~0.8 ms a sweep, about 20 times the
// time of the sweep's bytes.
//
// What bounds it.  A sweep reads the lower triangle of every factor once:
// 32 x 1010 x 1011 / 2 x 8 B = 130.7 MB at B = 32, 39 us at 3.35 TB/s;
// its n^2 k / 2 multiply-adds are negligible at k <= 16.  The one
// dependency runs through the solution: each 32-row block of it needs the
// blocks before it (after it, backward).  No tile of L depends on the
// solution, so the bytes can stream while the chain of diagonal-block
// solves runs; the chain, 2 ceil(n / 32) dependent block solves a call,
// has to stay short beside the bytes, and so does each tile's own
// latency, which a CTA-wide loop over 32 x 32 tiles paid at every tile.
//
// Design.
//  1. Workers: each warp is a worker with its own stream of tiles, its own
//     ring and its own accumulators; no CTA-wide barrier in the loop.  A
//     thread-block cluster of C CTAs of 4 warps serves one (lane, tile of
//     KB <= 8 columns of X), so P = 4 C workers; KB and C (1..8) come from
//     the wrapper's plan on (B, n, k): the clusters fill the SMs (C = 4 at
//     B = 32 and k = 1, P = 16; at k = 11 two column tiles of 8, C = 2) and
//     shared memory holds the receive slots; at large n, where a lane's
//     accumulators outgrow a CTA, C grows past the SMs and the clusters
//     run in waves (no cluster waits on another).  A diagonal block's
//     solve is serial in its columns, so wide right-hand sides take several
//     column tiles, each reading L, rather than one longer chain.  Worker v
//     owns the 32-row blocks b with b % P == v and keeps their
//     accumulators (32 x KB) for both sweeps: R, then Y = L^{-1} R, then X.
//  2. Right-looking with look-ahead.  Forward, at step j each worker
//     subtracts L[i, j] Y_j from each block i > j it owns; the owner of
//     block j + 1 first applies its tile (j + 1, j), solves block j + 1
//     and sends it, and only then does the rest of step j.  Backward
//     likewise over L^T: at step i, block b < i takes L[i, b]^T X_i.  With
//     P workers a worker has about (n / 32 - j) / P tiles a step, so the
//     chain per block is one tile product, one diagonal solve and one
//     exchange.
//  3. Exchange through distributed shared memory: the warp that solved a
//     block stores it from its registers into a receive slot of every CTA
//     of the cluster, its own included, with st.async, which completes the
//     bytes on that CTA's mbarrier for the block (2 ceil(n / 32) barriers
//     a CTA, each armed once and used once); a worker that needs the block
//     waits on its CTA's barrier.  No worker waits for a slower one except
//     through the data it needs.  The P + 3 receive slots are reused in
//     the chain's order: a worker owns a block among any P + 1 consecutive
//     ones and makes it only after it has finished with the block P + 3
//     earlier, so a slot is never overwritten while it is read.
//  4. Stream: each worker walks a fixed list of the tiles it needs, in the
//     order it uses them, and streams them through its ring of S (3..8)
//     32 x 32 stages with cp.async (16-byte copies where n is even and L
//     aligned, else 8-byte ones), zero-filling beyond n.  No tile depends
//     on the solution, so the ring runs ahead across steps and from the
//     forward into the backward sweep while the worker waits on the chain.
//  5. Diagonal solve: lane r holds row r of the block scaled by 1 / L_rr
//     (forward; column r backward) in 32 registers and the KB values of
//     row r; each step is one shuffle and one FMA per column.  No inverse
//     of L or of a block is formed.
//  6. Tile products: lane r makes row r of the 32 x KB update over the
//     tile's 32 depths, Y read as a broadcast from shared memory.
//  7. A NaN factor gives NaN in its lane only (as solve_triangular).
//     Rows and columns of L beyond n act as the identity; L's upper
//     triangle is never used.  L is read in place, row-major or
//     column-major (cuSOLVER's factors are the latter): a column-major
//     tile is the row-major tile of the transpose, loaded as it lies and
//     read with its indices swapped.  R is read in place with its own
//     strides.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K5_T = 32;                   // rows of a block
constexpr int K5_NW = 4;                   // warps (workers) of a CTA
constexpr int K5_NT = 32 * K5_NW;
constexpr int K5_LDT = 34;                 // doubles per ring-tile row
constexpr int K5_TILE = K5_T * K5_LDT;     // doubles per ring stage
constexpr int K5_SMEM_MAX = 232448;        // a CTA's shared memory on sm_90
constexpr unsigned K5_FULL = 0xffffffffu;

// Work items: a tile product, the look-ahead product (its diagonal block's
// solve follows), or a diagonal-block solve, forward or backward.
enum { K5_DONE, K5_TILE_F, K5_LOOK_F, K5_DIAG_F, K5_TILE_B, K5_LOOK_B,
       K5_DIAG_B };

// Shared memory in bytes: 2 nb mbarriers, P + 3 receive slots, and per
// warp its ring and the accumulators of its ceil(nb / P) blocks
int k5_smem(int nb, int C, int kb, int S)
{
    const int P = C * K5_NW;
    const int own = (nb + P - 1) / P;
    return 16 * nb +
           8 * ((P + 3) * K5_T * kb + K5_NW * (S * K5_TILE + own * K5_T * kb));
}

// Wait until at most n (0..6) of this thread's cp.async groups are
// pending: the ring's depth is a launch parameter, the instruction's count
// an immediate.
__device__ __forceinline__ void cp_async_wait_upto(int n)
{
    switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
    }
}

// Store v (and w) in a CTA's shared memory (addr, from mapa) and complete
// its 8 (16) bytes on that CTA's mbarrier bar.
__device__ __forceinline__ void st_async_f64(unsigned addr, double v,
                                             unsigned bar)
{
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64"
                 " [%0], %1, [%2];\n"
                 :: "r"(addr), "d"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async_f64x2(unsigned addr, double v,
                                               double w, unsigned bar)
{
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                 ".v2.f64 [%0], {%1, %2}, [%3];\n"
                 :: "r"(addr), "d"(v), "d"(w), "r"(bar) : "memory");
}

// The tiles worker v of P (a power of two) needs, in the order it uses
// them (the consumer and the ring's producer each walk one copy).
// Forward step j = -1 .. nb-2: the owner of o = j + 1 takes (o, j) then
// diag(o); then (i, j) for the owned i > o.  Backward step i = nb .. 1:
// the owner of o = i - 1 takes (i, o) then diag(o); then (i, b) for the
// owned b < o.
struct Sched {
    int v, m, nb;
    int sweep, step, ph, b;

    __device__ Sched(int v_, int P, int nb_)
        : v(v_), m(P - 1), nb(nb_), sweep(0), step(-1), ph(0), b(0) {}

    __device__ bool own(int x) const { return (x & m) == v; }

    __device__ int next(int& ti, int& tj)
    {
        for (;;) {
            if (sweep == 0) {
                const int j = step, o = j + 1;
                if (ph == 0) {
                    ph = 1;
                    if (j >= 0 && own(o)) {
                        ti = o; tj = j;
                        return K5_LOOK_F;
                    }
                } else if (ph == 1) {
                    ph = 2;
                    b = o + 1 + ((v - o - 1) & m);
                    if (own(o)) {
                        ti = tj = o;
                        return K5_DIAG_F;
                    }
                } else if (j >= 0 && b < nb) {
                    ti = b; tj = j;
                    b += m + 1;
                    return K5_TILE_F;
                } else {
                    ph = 0;
                    if (++step > nb - 2) { sweep = 1; step = nb; }
                }
            } else if (sweep == 1) {
                const int i = step, o = i - 1;
                if (ph == 0) {
                    ph = 1;
                    if (i < nb && own(o)) {
                        ti = i; tj = o;
                        return K5_LOOK_B;
                    }
                } else if (ph == 1) {
                    ph = 2;
                    b = v;
                    if (own(o)) {
                        ti = tj = o;
                        return K5_DIAG_B;
                    }
                } else if (i < nb && b < o) {
                    ti = i; tj = b;
                    b += m + 1;
                    return K5_TILE_B;
                } else {
                    ph = 0;
                    if (--step < 1) sweep = 2;
                }
            } else {
                return K5_DONE;
            }
        }
    }
};

// The warp starts the copy of the stored tile at (ti, tj) (rows 32 ti..,
// columns 32 tj.. of the row-major n x n array at Lb) into ring stage
// dst, zero-filling beyond n.
__device__ __forceinline__ void load_tile(double* dst, const double* Lb,
                                          int n, int ti, int tj, bool vec)
{
    const int r0 = ti * K5_T, c0 = tj * K5_T, ln = threadIdx.x & 31;
    if (vec) {
#pragma unroll
        for (int it = 0; it < K5_T * K5_T / 2 / 32; ++it) {
            const int r = it * 2 + (ln >> 4), c = (ln & 15) * 2;
            const bool ok = r0 + r < n && c0 + c < n;
            cp_async16(dst + r * K5_LDT + c,
                       ok ? Lb + (size_t)(r0 + r) * n + c0 + c : Lb, ok);
        }
    } else {
#pragma unroll
        for (int r = 0; r < K5_T; ++r) {
            const bool ok = r0 + r < n && c0 + ln < n;
            cp_async8(dst + r * K5_LDT + ln,
                      ok ? Lb + (size_t)(r0 + r) * n + c0 + ln : Lb, ok);
        }
    }
}

// Element (r, c) of a tile of L in a ring stage: stored as it lies in L,
// or transposed where L is column-major (cm).
__device__ __forceinline__ double at(const double* A, int r, int c, bool cm)
{
    return A[cm ? c * K5_LDT + r : r * K5_LDT + c];
}

// The warp's product t = A Y over a tile, A the tile (TR = false) or its
// transpose (TR), Y (32 x KB): lane r makes row r, in NP partial sums per
// column over the depths, Y read as a broadcast.
template <int KB, bool TR>
__device__ __forceinline__ void tile_product(double (&t)[KB], const double* A,
                                             const double* Y, bool cm)
{
    constexpr int NP = KB >= 4 ? 1 : 4 / KB;
    const int r = threadIdx.x & 31;
    double s[NP][KB];
#pragma unroll
    for (int h = 0; h < NP; ++h)
#pragma unroll
        for (int v = 0; v < KB; ++v) s[h][v] = 0.0;
#pragma unroll
    for (int d = 0; d < K5_T; ++d) {
        const double a = TR ? at(A, d, r, cm) : at(A, r, d, cm);
        double y[KB];
        if (KB == 1) {
            y[0] = Y[d];
        } else {
#pragma unroll
            for (int v = 0; v < KB; v += 2) {
                const double2 y2 =
                    *reinterpret_cast<const double2*>(Y + d * KB + v);
                y[v] = y2.x;
                y[v + 1] = y2.y;
            }
        }
#pragma unroll
        for (int v = 0; v < KB; ++v)
            s[d % NP][v] = fma(a, y[v], s[d % NP][v]);
    }
#pragma unroll
    for (int v = 0; v < KB; ++v) {
        t[v] = s[0][v];
#pragma unroll
        for (int h = 1; h < NP; ++h) t[v] += s[h][v];
    }
}

// The scaled diagonal block in registers: lane r holds row r of A / A_rr
// (forward) or column r (backward) below the diagonal, zeros elsewhere;
// returns 1 / A_rr.  nv rows are valid; the rest act as the identity.
template <bool BWD>
__device__ __forceinline__ double diag_prep(double (&l)[K5_T], const double* A,
                                            int nv, bool cm)
{
    const int r = threadIdx.x & 31;
    const bool ok = r < nv;
    const double rinv = 1.0 / (ok ? A[r * K5_LDT + r] : 1.0);
#pragma unroll
    for (int j = 0; j < K5_T; ++j) {
        if (BWD)
            l[j] = j > r && j < nv ? at(A, j, r, cm) * rinv : 0.0;
        else
            l[j] = j < r && ok ? at(A, r, j, cm) * rinv : 0.0;
    }
    return rinv;
}

// The warp finishes the diagonal solve A Z = acc (forward) or A^T Z = acc
// (backward), with a (lane r: row r of acc, scaled by 1 / A_rr) and l from
// diag_prep: each step is one shuffle and one FMA per column.  Lane r
// then keeps row r of Z in acc, sends it to the same place of every CTA's
// receive slot rs, completing bytes on that CTA's barrier bar, and
// backward writes it to X's rows from xr.
template <int KB, bool BWD>
__device__ __forceinline__ void diag_finish(double* acc, double (&a)[KB],
                                            const double (&l)[K5_T], int nv,
                                            unsigned rs, unsigned bar, int C,
                                            double* xr, int k, int col0)
{
    const int r = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < K5_T; ++s) {
        const int j = BWD ? K5_T - 1 - s : s;
#pragma unroll
        for (int v = 0; v < KB; ++v)
            a[v] = fma(-l[j], __shfl_sync(K5_FULL, a[v], j), a[v]);
    }
#pragma unroll
    for (int v = 0; v < KB; ++v) acc[r * KB + v] = a[v];
    for (int q = 0; q < C; ++q) {
        const unsigned dst = mapa(rs + 8 * r * KB, q), qb = mapa(bar, q);
        if (KB == 1) {
            st_async_f64(dst, a[0], qb);
        } else {
#pragma unroll
            for (int v = 0; v < KB; v += 2)
                st_async_f64x2(dst + 8 * v, a[v], a[v + 1], qb);
        }
    }
    if (BWD && r < nv)
#pragma unroll
        for (int v = 0; v < KB; ++v)
            if (col0 + v < k) xr[(size_t)r * k + col0 + v] = a[v];
}

// One work item of the warp: a tile product into the block it updates
// (kind TILE), the look-ahead product followed by the solve of that block
// from the next ring stage A2 (LOOK), or a solve alone (DIAG).  Y is the
// solved block the product multiplies, to be waited for on ybar where
// another worker sends it; a look-ahead scales its diagonal block first.
template <int KB, bool BWD>
__device__ __forceinline__ void work(int kind, double* acc, const double* A,
                                     const double* A2, const double* Y,
                                     uint64_t* ybar, int nv, bool cm,
                                     unsigned rs, unsigned bar, int C,
                                     double* xr, int k, int col0)
{
    const int r = threadIdx.x & 31;
    double t[KB];
    if (kind == (BWD ? K5_TILE_B : K5_TILE_F)) {
        if (ybar) mbar_wait(ybar, 0);
        tile_product<KB, BWD>(t, A, Y, cm);
#pragma unroll
        for (int v = 0; v < KB; ++v) acc[r * KB + v] -= t[v];
        return;
    }
    double l[K5_T];
    const double rinv = diag_prep<BWD>(l, kind == (BWD ? K5_DIAG_B : K5_DIAG_F)
                                              ? A : A2, nv, cm);
    if (kind == (BWD ? K5_DIAG_B : K5_DIAG_F)) {
#pragma unroll
        for (int v = 0; v < KB; ++v) t[v] = 0.0;
    } else {
        if (ybar) mbar_wait(ybar, 0);
        tile_product<KB, BWD>(t, A, Y, cm);
    }
    double a[KB];
#pragma unroll
    for (int v = 0; v < KB; ++v) a[v] = (acc[r * KB + v] - t[v]) * rinv;
    diag_finish<KB, BWD>(acc, a, l, nv, rs, bar, C, xr, k, col0);
}

template <int KB>
__global__ void __launch_bounds__(K5_NT, 1)
chol_solve64_kernel(const double* __restrict__ L,
                    const double* __restrict__ R, double* __restrict__ X,
                    int n, int k, long long sRb, long long sRr,
                    long long sRc, int S, bool vec, bool cm)
{
    extern __shared__ __align__(16) double k5_smem_d[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int c = (int)cluster.block_rank();
    const int lane = blockIdx.x / C;
    const int col0 = blockIdx.y * KB;
    const int nb = (n + K5_T - 1) / K5_T;
    const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
    const int P = C * K5_NW, v = c * K5_NW + w;
    const int nr = P + 3, nown = (nb + P - 1) / P;
    const double* Lb = L + (size_t)lane * n * n;
    const double* Rb = R + lane * sRb;
    double* Xb = X + (size_t)lane * n * k;

    // The same layout in every CTA of the cluster (peers write into it):
    // 2 nb barriers, one per solved block in the order the chain makes
    // them (item s: forward block s, then backward block 2 nb - 1 - s);
    // the receive slots; each warp's ring and accumulators.
    uint64_t* bars = reinterpret_cast<uint64_t*>(k5_smem_d);
    double* rbuf = k5_smem_d + 2 * nb;
    double* ring = rbuf + nr * K5_T * KB +
                   w * (S * K5_TILE + nown * K5_T * KB);
    double* accs = ring + S * K5_TILE;
    const int lp = __ffs(P) - 1;
    auto slot = [&](int b) { return accs + (b >> lp) * K5_T * KB; };
    auto item = [&](bool bwd, int b) { return bwd ? 2 * nb - 1 - b : b; };

    Sched prod(v, P, nb), cons(v, P, nb);
    for (int q = 0; q < S - 1; ++q) {
        int ti, tj;
        if (prod.next(ti, tj) != K5_DONE)
            load_tile(ring + q * K5_TILE, Lb, n, cm ? tj : ti, cm ? ti : tj,
                      vec);
        cp_async_commit();
    }
    if (tid == 0) {
        for (int i = 0; i < 2 * nb; ++i) mbar_init(&bars[i]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int i = 0; i < 2 * nb; ++i) mbar_arm(&bars[i], K5_T * KB * 8);
    }
    for (int b = v; b < nb; b += P)
#pragma unroll
        for (int e = 0; e < KB; ++e) {
            const int row = b * K5_T + ln, col = col0 + e;
            slot(b)[ln * KB + e] =
                row < n && col < k ? Rb[row * sRr + col * sRc] : 0.0;
        }
    // every CTA's barriers are armed before the first byte is sent
    cluster.sync();

    // ring stages of the next item to use (qs) and to fill (ps)
    int qs = 0, ps = S - 1;
    auto issue = [&]() {
        int pi, pj;
        if (prod.next(pi, pj) != K5_DONE)
            load_tile(ring + ps * K5_TILE, Lb, n, cm ? pj : pi, cm ? pi : pj,
                      vec);
        cp_async_commit();
        if (++ps == S) ps = 0;
    };
    for (;;) {
        int ti, tj;
        const int kind = cons.next(ti, tj);
        if (kind == K5_DONE) break;
        const bool bwd = kind >= K5_TILE_B;
        const bool look = kind == K5_LOOK_F || kind == K5_LOOK_B;
        const bool diag = kind == K5_DIAG_F || kind == K5_DIAG_B;
        // the tile (and for a look-ahead the diagonal block after it) has
        // landed; the stage of the last item takes the next tile
        cp_async_wait_upto(S - 2 - look);
        __syncwarp();
        issue();
        const double* A = ring + qs * K5_TILE;
        if (++qs == S) qs = 0;
        const double* A2 = ring + qs * K5_TILE;
        if (look && ++qs == S) qs = 0;
        if (look) {
            int oi, oj;
            cons.next(oi, oj);            // the diagonal block's solve
        }
        // the block the item updates and solves, and the solved block its
        // product multiplies: Y_tj forward, X_ti backward
        const int ob = bwd ? tj : ti, yb = bwd ? ti : tj;
        const double* Y = nullptr;
        uint64_t* ybar = nullptr;
        unsigned rs = 0, bar = 0;
        if (look || diag) {
            const int s = item(bwd, ob);
            rs = smem_u32(rbuf + (s % nr) * K5_T * KB);
            bar = smem_u32(&bars[s]);
        }
        if (!diag) {
            if (cons.own(yb)) {
                Y = slot(yb);
            } else {
                const int s = item(bwd, yb);
                ybar = &bars[s];
                Y = rbuf + (s % nr) * K5_T * KB;
            }
        }
        double* xr = Xb + (size_t)ob * K5_T * k;
        if (bwd)
            work<KB, true>(kind, slot(ob), A, A2, Y, ybar, n - ob * K5_T,
                           cm, rs, bar, C, xr, k, col0);
        else
            work<KB, false>(kind, slot(ob), A, A2, Y, ybar, n - ob * K5_T,
                            cm, rs, bar, C, xr, k, col0);
        __syncwarp();
        if (look) issue();
    }
    // every byte sent here has landed, and no CTA leaves while a peer may
    // still send to it
    for (int s = ln; s < 2 * nb; s += 32) mbar_wait(&bars[s], 0);
    cluster.sync();
}

template <int KB>
int k5_launch(const double* L, const double* R, double* X, int B, int n,
              int k, long long sRb, long long sRr, long long sRc, int C,
              int S, bool cm, cudaStream_t s)
{
    static unsigned smem_set;
    const auto fn = chol_solve64_kernel<KB>;
    cudaError_t e = smem_limit_once((const void*)fn, K5_SMEM_MAX, &smem_set,
                                    true);
    if (e != cudaSuccess) return (int)e;
    const int nb = (n + K5_T - 1) / K5_T;
    const bool vec = n % 2 == 0 && aligned16(L);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * B, (k + KB - 1) / KB);
    cfg.blockDim = dim3(K5_NT);
    cfg.dynamicSmemBytes = k5_smem(nb, C, KB, S);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, fn, L, R, X, n, k, sRb, sRr, sRc, S, vec,
                           cm);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// X (B, n, k) contiguous = (L L^T)^{-1} R for L (B, n, n) lower factors,
// each matrix row-major (cm = 0) or column-major (cm = 1) and the batch
// contiguous, and R (B, n, k) with strides (sRb, sRr, sRc) in doubles; kb
// (1, 2, 4 or 8) columns of X per cluster of C CTAs, S ring stages (the
// wrapper's plan).
int kvx_chol_solve64(const void* L, const void* R, void* X, int B, int n,
                     int k, long long sRb, long long sRr, long long sRc,
                     int cm, int kb, int C, int S, void* stream)
{
    const int nb = (n + K5_T - 1) / K5_T;
    if (B < 1 || n < 1 || k < 1 || (C != 1 && C != 2 && C != 4 && C != 8) ||
        S < 2 || S > 8 || k5_smem(nb, C, kb, S) > K5_SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    const double *l = (const double*)L, *r = (const double*)R;
    double* x = (double*)X;
    cudaStream_t s = (cudaStream_t)stream;
    switch (kb) {
    case 1:
        return k5_launch<1>(l, r, x, B, n, k, sRb, sRr, sRc, C, S, cm, s);
    case 2:
        return k5_launch<2>(l, r, x, B, n, k, sRb, sRr, sRc, C, S, cm, s);
    case 4:
        return k5_launch<4>(l, r, x, B, n, k, sRb, sRr, sRc, C, S, cm, s);
    case 8:
        return k5_launch<8>(l, r, x, B, n, k, sRb, sRr, sRc, C, S, cm, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
