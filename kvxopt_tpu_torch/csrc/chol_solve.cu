// Batched L L^T solve against the blocked Cholesky factor (K2), for Hopper
// (sm_90a): X = (L L^T)^{-1} R through the stored inverses of L's 128x128
// diagonal blocks, the forward and the backward sweep in one launch.
//
// Replaces the Pallas TPU kernel chol_solve_ls of kvxopt_tpu/ops/chol_ls.py
// (:517; body _solve_kernel :477 with _fwd_sweep :417 and _bwd_sweep :446).
//
// Contract (the JAX function's): L (B, n, n) f32 row-major and lower
// triangular, Dinv (nb, B, 128, 128) f32 with nb = ceil(n / 128), R
// (B, n, k) f32 with unit column stride and the batch and row strides
// given, X (B, n, k) f32 contiguous.  Rows and columns of L beyond n act
// as the identity: the kernel reads no padded copy of L, it zero-fills
// what lies beyond n (or beyond k) as it loads.  Nothing is inverted.
//
// Math, per 128-row block i (bi = 128 i, hi = bi + 128):
//   forward:  Y_i = Dinv_i   (R_i - L[bi:hi, 0:bi] Y[0:bi])
//   backward: X_i = Dinv_i^T (Y_i - L[hi:n, bi:hi]^T X[hi:n])
//
// What bounds it.  At the PCG's shape (B=16, n=512, k=1) a call reads the
// strictly block-lower part of L (6.3 MB) and the lower triangles of Dinv
// (2.1 MB) once and does 8.4 MFLOP: about 2.5 us of device memory at
// 3.35 TB/s, so it is bound by bytes, and by its chain of 2 nb dependent
// block steps.  At k = 32 the same bytes carry 32 times the FFMAs (269
// MFLOP, ~4 us at the 67 TFLOP/s f32 peak).  The sweep it replaces ran one CTA per (matrix, column): 16
// CTAs on 132 SMs pulled the bytes, with each load issued behind an FFMA
// chain and nothing prefetched.  Measured on the card this kernel is bound
// by the chain's latency, about 2 us per block step (PERF.md).
//
// Design.
//  1. Grid: a thread-block cluster of CS CTAs of 256 threads per (matrix,
//     tile of KC columns of X); CS = 8 where n > 128 (128 CTAs at B=16,
//     k=1), ceil(n / 16) for a single block (2 at the Schur shape n=32).
//     CTA c owns rows 16c .. 16c+15 of every 128-row block; backward, the
//     same columns of L's band and of Dinv_i.  Registers are capped and
//     shared memory kept under half an SM at the solves' shapes, so two
//     CTAs fit on an SM.
//  2. Ring: each CTA streams its slice of L and Dinv as 8 KB tiles through
//     a ring of shared memory with cp.async (16-byte copies where n and the
//     pointers allow, else 4-byte ones), zero-filling beyond n: forward
//     16 x 128 tiles L[bi+16c.., 128j..] and Dinv_i[16c.., :], backward
//     128 x 16 tiles L[128j.., bi+16c..] and Dinv_i[:, 16c..].  No tile
//     depends on the solution, so the ring runs ahead across block steps
//     and from the forward into the backward sweep.
//  3. Exchange through distributed shared memory, two per block step.
//     Each CTA forms its 16 x KC slice of R_i - band (Y_i - band backward)
//     and writes it into every peer's G (128 x KC) with st.async, which
//     completes bytes on the peer's mbarrier; each CTA waits on its own
//     barrier until all CS slices have arrived, applies its 16 rows
//     (columns) of Dinv_i to the whole of G, and sends its slice of Y_i
//     (X_i) the same way.  No cluster-wide barrier on the chain: a CTA
//     waits only for the bytes it needs, and re-arms its barrier after a
//     CTA barrier, once all its threads are past the wait (peers may
//     already be sending the next exchange's bytes).  R_i is read a block
//     step ahead.
//  4. The solved part of the tile (npad x KC) lives in every CTA's shared
//     memory while it fits (2 KB at k=1 n=512, 64 KB at k=32 n=512).
//     Beyond that (GY) it goes through X in device memory, is read back
//     from L2 (ld.global.cg), and a cluster barrier orders each step's
//     writes before the peers' reads, so shared memory does not bound n.
//  5. Two thread maps.  KC = 1 (k = 1): a 16 x 128 tile is 8 FFMAs per
//     thread from two float4 of L and two of y, reduced by shuffles once
//     per block step.  KC = 32 (k > 1): each thread keeps a 4 x 4 block of
//     the 16 x 32 slice in registers over 16 depths of the tile, 256 FFMAs
//     per 32 float4 shared loads; the four depth quarters of a warp are
//     summed by shuffles and the two halves through shared memory.
//  6. No copies: R is read in place (batch and row strides given) and X
//     written in its (B, n, k) layout; the wrapper allocates X and launches
//     once.
//  7. Precision: IEEE f32 FFMA with f32 accumulation, as in K1, K3 and K4.
//     No tensor-core instruction: TF32 fails the tolerances.
//
// The C entry point returns the launch's error code; it launches on the
// given stream, synchronises nothing and allocates nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CS_BS = 128;                 // diagonal block (Dinv contract)
constexpr int CS_R = 16;                   // rows of a block per CTA
constexpr int CS_MAX = CS_BS / CS_R;       // CTAs per cluster
constexpr int CS_THREADS = 256;
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_TILE = CS_BS * CS_R;      // floats per ring stage (8 KB)
constexpr int CS_SMEM_MAX = 232448;        // a CTA's shared memory on sm_90

__host__ __device__ constexpr int cs_stages(int kc)
{
    return kc == 1 ? 8 : 3;
}

// partial slices per element before the reduction: one per warp (KC = 1),
// one per depth half (KC = 32)
__host__ __device__ constexpr int cs_parts(int kc)
{
    return kc == 1 ? CS_WARPS : 2;
}

// Shared memory in floats: two mbarriers, ring, G, partial slices, and the
// solved tile unless it is in device memory (GY)
constexpr int cs_smem_floats(int kc, int npad, bool gy)
{
    return 4 + cs_stages(kc) * CS_TILE + CS_BS * kc +
           cs_parts(kc) * CS_R * kc + (gy ? 0 : npad * kc);
}

// KC = 1, forward (16 x 128 tile a, row r = tid / 16): acc[0] += a[r] . y
// over depths 4q.. and 64 + 4q.. (q = tid % 16).  y is in device memory
// when GLB, read there as float4 when Y4.
template <bool GLB, bool Y4>
__device__ __forceinline__ void fma_rows1(float (&acc)[1][4], const float* a,
                                          const float* y)
{
    const int r = threadIdx.x >> 4, q = threadIdx.x & 15;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int d = h * 64 + q * 4;
        const float4 av = *reinterpret_cast<const float4*>(a + r * CS_BS + d);
        float4 yv;
        if (!GLB)
            yv = *reinterpret_cast<const float4*>(y + d);
        else if (Y4)
            yv = __ldcg(reinterpret_cast<const float4*>(y + d));
        else
            yv = make_float4(__ldcg(y + d), __ldcg(y + d + 1),
                             __ldcg(y + d + 2), __ldcg(y + d + 3));
        acc[0][0] = fmaf(av.x, yv.x, acc[0][0]);
        acc[0][0] = fmaf(av.y, yv.y, acc[0][0]);
        acc[0][0] = fmaf(av.z, yv.z, acc[0][0]);
        acc[0][0] = fmaf(av.w, yv.w, acc[0][0]);
    }
}

// KC = 1, backward (128 x 16 tile a): acc[0][u] += sum_d a[d][4cq + u] x[d]
// over depths d = tid / 4 and d + 64 (cq = tid % 4); x rows >= tv are 0.
template <bool GLB>
__device__ __forceinline__ void fma_cols1(float (&acc)[1][4], const float* a,
                                          const float* x, int tv)
{
    const int cq = threadIdx.x & 3, d0 = threadIdx.x >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int d = d0 + h * 64;
        const float4 av = *reinterpret_cast<const float4*>(a + d * CS_R +
                                                           cq * 4);
        const float xv = GLB ? (d < tv ? __ldcg(x + d) : 0.0f) : x[d];
        acc[0][0] = fmaf(av.x, xv, acc[0][0]);
        acc[0][1] = fmaf(av.y, xv, acc[0][1]);
        acc[0][2] = fmaf(av.z, xv, acc[0][2]);
        acc[0][3] = fmaf(av.w, xv, acc[0][3]);
    }
}

// KC = 32: columns 4cg .. 4cg+3 of row t of the B operand (ld floats per
// row); in device memory (GLB) rows >= tv and columns >= vc read as 0.
template <bool GLB>
__device__ __forceinline__ void brow32(float (&v)[4], const float* p, int t,
                                       int ld, int tv, int vc)
{
    const int c = (threadIdx.x & 7) * 4;
    if (!GLB) {
        const float4 w = *reinterpret_cast<const float4*>(p + t * ld + c);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v[e] = (t < tv && c + e < vc) ? __ldcg(p + (size_t)t * ld + c + e)
                                          : 0.0f;
    }
}

// KC = 32 thread map: warp w owns rows 4rw .. 4rw+3 (rw = w % 4) of the
// slice and half h = w / 4 of the tile's depth; lane (dq = lane / 8, cg =
// lane % 8) owns columns 4cg .. 4cg+3 and depths d0 .. d0+15 of that half.
__device__ __forceinline__ int depth32()
{
    return (threadIdx.x >> 7) * 64 + ((threadIdx.x & 31) >> 3) * 16;
}

// KC = 32, forward: acc += a[rows, D] B[D, :] over the lane's depths D of a
// 16 x 128 tile.
template <bool GLB>
__device__ __forceinline__ void fma_rows32(float (&acc)[4][4], const float* a,
                                           const float* bm, int ld, int tv,
                                           int vc)
{
    const int rw = (threadIdx.x >> 5) & 3, d0 = depth32();
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
        float av[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const float4 t = *reinterpret_cast<const float4*>(
                a + (rw * 4 + u) * CS_BS + d0 + e);
            av[u][0] = t.x; av[u][1] = t.y; av[u][2] = t.z; av[u][3] = t.w;
        }
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
            float bv[4];
            brow32<GLB>(bv, bm, d0 + e + ee, ld, tv, vc);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                    acc[u][v] = fmaf(av[u][ee], bv[v], acc[u][v]);
        }
    }
}

// KC = 32, backward: acc (rows of the slice = columns of the 128 x 16 tile
// a) += a[D, rows]^T B[D, :] over the lane's depths D.
template <bool GLB>
__device__ __forceinline__ void fma_cols32(float (&acc)[4][4], const float* a,
                                           const float* bm, int ld, int tv,
                                           int vc)
{
    const int rw = (threadIdx.x >> 5) & 3, d0 = depth32();
#pragma unroll
    for (int e = 0; e < 16; ++e) {
        const float4 t = *reinterpret_cast<const float4*>(
            a + (d0 + e) * CS_R + rw * 4);
        const float av[4] = {t.x, t.y, t.z, t.w};
        float bv[4];
        brow32<GLB>(bv, bm, d0 + e, ld, tv, vc);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
                acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
}

// The partial slices of a block step into part[p * 16 * KC + e], e = r * KC
// + c; returns how many partials each element has.  Ends in a barrier.
template <int KC>
__device__ __forceinline__ int reduce_partials(float (&acc)[KC == 1 ? 1 : 4][4],
                                               float* part, bool fwd)
{
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    int nparts = cs_parts(KC);
    if constexpr (KC == 1) {
        if (fwd) {
            float s = acc[0][0];
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, o);
            if ((tid & 15) == 0) part[tid >> 4] = s;
            nparts = 1;
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int o = 4; o < 32; o <<= 1)
                    acc[0][u] += __shfl_xor_sync(0xffffffffu, acc[0][u], o);
            if (lane < 4)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    part[w * CS_R + lane * 4 + u] = acc[0][u];
        }
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
#pragma unroll
                for (int o = 8; o < 32; o <<= 1)
                    acc[u][v] += __shfl_xor_sync(0xffffffffu, acc[u][v], o);
        if (lane < 8)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                *reinterpret_cast<float4*>(part + (w >> 2) * CS_R * KC +
                                           ((w & 3) * 4 + u) * KC +
                                           lane * 4) =
                    make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
    __syncthreads();
    return nparts;
}

template <int KC, bool VEC, bool GY>
__global__ void __launch_bounds__(CS_THREADS, 2)
chol_solve_kernel(const float* __restrict__ L, const float* __restrict__ Dinv,
                  const float* __restrict__ R, float* __restrict__ X, int B,
                  int n, int k, long long sRb, long long sRr)
{
    constexpr int S = cs_stages(KC);
    constexpr int SL = CS_R * KC;                    // a CTA's slice
    constexpr int NQ = SL / 4;                       // its float4 quads
    static_assert(CS_THREADS % NQ == 0, "a thread keeps one quad");
    extern __shared__ __align__(16) float smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // G, Y exchanges
    float* ring = smem + 4;                          // S x CS_TILE
    float* G = ring + S * CS_TILE;                   // 128 x KC
    float* part = G + CS_BS * KC;                    // cs_parts x SL
    float* Ys = part + cs_parts(KC) * SL;            // npad x KC (!GY)

    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks();
    const int r0 = (int)cluster.block_rank() * CS_R;
    const int b = blockIdx.y, c0 = (blockIdx.x / cs) * KC;
    const int tid = threadIdx.x;
    const int nb = (n + CS_BS - 1) / CS_BS;
    const int vc = k - c0;                           // valid columns
    const float* Lb = L + (size_t)b * n * n;
    const float* Rb = R + b * sRb + c0;
    float* Xb = X + (size_t)b * n * k + c0;
    // the solved rows: this CTA's shared copy, or X itself (GY)
    const float* Ysol = GY ? Xb : Ys;
    const int ldy = GY ? k : KC;
    const unsigned xbytes = (unsigned)(cs * SL * sizeof(float));

    // The ring's tape: every tile this CTA reads, in the order it uses
    // them (sweep, block step, band tiles then Dinv_i).
    int t_sw = 0, t_st = 0, t_j = 0;
    auto issue = [&](int q) {
        if (t_sw < 2) {
            float* dst = ring + (q % S) * CS_TILE;
            const int i = t_sw == 0 ? t_st : nb - 1 - t_st;
            const int bi = i * CS_BS, hn = min(CS_BS, n - bi);
            const int nband = t_sw == 0 ? i : nb - 1 - i;
            const float* Di = Dinv + ((size_t)i * B + b) * CS_BS * CS_BS;
            if (t_sw == 0 && t_j < nband)
                tile_async<CS_R, CS_BS, VEC, CS_THREADS>(
                    dst, CS_BS, Lb + (size_t)(bi + r0) * n + t_j * CS_BS, n,
                    n - bi - r0, CS_BS);
            else if (t_sw == 0)
                tile_async<CS_R, CS_BS, VEC, CS_THREADS>(
                    dst, CS_BS, Di + r0 * CS_BS, CS_BS, hn - r0, hn);
            else if (t_j < nband) {
                const int t0 = (i + 1 + t_j) * CS_BS;
                tile_async<CS_BS, CS_R, VEC, CS_THREADS>(
                    dst, CS_R, Lb + (size_t)t0 * n + bi + r0, n, n - t0,
                    n - bi - r0);
            } else
                tile_async<CS_BS, CS_R, VEC, CS_THREADS>(
                    dst, CS_R, Di + r0, CS_BS, hn, hn - r0);
            if (++t_j > nband) {
                t_j = 0;
                if (++t_st == nb) { t_st = 0; ++t_sw; }
            }
        }
        cp_async_commit();
    };

    for (int q = 0; q < S - 1; ++q) issue(q);
    // rows of G that no CTA owns (one block, CS < 8) must read as 0
    for (int e = tid; e < CS_BS * KC; e += CS_THREADS) G[e] = 0.0f;
    if (tid == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arm(&bars[0], xbytes);
        mbar_arm(&bars[1], xbytes);
    }
    // Thread tid keeps quad (tid % NQ) of the slice: elements e0 .. e0+3,
    // rows r0 + e / KC, columns e % KC.
    const int e0 = (tid % NQ) * 4;
    const bool sender = tid < NQ * cs;
    unsigned phase[2] = {0, 0};                      // per barrier
    // The quad of R for forward step st, read one step before its use;
    // zero beyond n and k.
    auto load_r = [&](float (&rq)[4], int st) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int row = st * CS_BS + r0 + (e0 + u) / KC,
                      c = (e0 + u) % KC;
            rq[u] = sender && row < n && c < vc ? Rb[row * sRr + c] : 0.0f;
        }
    };
    float rnext[4];
    load_r(rnext, 0);
    // every peer runs, with G zeroed and its barriers armed, before the
    // first remote write
    cluster.sync();

    int q = 0;                                       // tiles consumed
    for (int sw = 0; sw < 2; ++sw) {
        const bool fwd = sw == 0;
        for (int st = 0; st < nb; ++st) {
            const int i = fwd ? st : nb - 1 - st;
            const int bi = i * CS_BS;
            const int nband = fwd ? i : nb - 1 - i;

            // The quad's right-hand side, R_i (forward, read a step ago)
            // or Y_i (backward, loaded now and used after the band).
            float init[4];
            bool ok[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int e = e0 + u, row = bi + r0 + e / KC, c = e % KC;
                ok[u] = row < n && c < vc;
                init[u] = rnext[u];
                if (!fwd)
                    init[u] = sender && ok[u]
                        ? (GY ? __ldcg(Xb + (size_t)row * k + c)
                              : Ys[row * KC + c])
                        : 0.0f;
            }
            if (fwd && st + 1 < nb) load_r(rnext, st + 1);

            // Send the quad, init - sums (band) or sums (Dinv_i), to `buf`
            // (G or Ys) of every peer on barrier `bar`, and (to_x) to X;
            // then wait until every peer's quads have arrived here.
            auto exchange = [&](int nparts, bool band, float* buf, int bar,
                                bool to_x) {
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    float sum = 0.0f;
                    for (int p = 0; p < nparts; ++p)
                        sum += part[p * SL + e0 + u];
                    v[u] = ok[u] ? (band ? init[u] - sum : sum) : 0.0f;
                }
                if (to_x && tid < NQ)
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (ok[u])
                            Xb[(size_t)(bi + r0 + (e0 + u) / KC) * k +
                               (e0 + u) % KC] = v[u];
                if (buf == nullptr) return;
                const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
                const unsigned la = smem_u32(buf + e0),
                               lb = smem_u32(&bars[bar]);
                for (int idx = tid; idx < NQ * cs; idx += CS_THREADS) {
                    const unsigned p = (unsigned)(idx / NQ);
                    st_async4(mapa(la, p), v4, mapa(lb, p));
                }
                mbar_wait(&bars[bar], phase[bar]);
                phase[bar] ^= 1u;
                // no thread may still wait on this phase when it re-opens
                __syncthreads();
                if (tid == 0) mbar_arm(&bars[bar], xbytes);
            };

            float acc[KC == 1 ? 1 : 4][4] = {};
            for (int j = 0; j <= nband; ++j, ++q) {
                if (j == nband) {
                    const int np = nband > 0
                        ? reduce_partials<KC>(acc, part, fwd) : 0;
                    exchange(np, true, G + r0 * KC, 0, false);
#pragma unroll
                    for (int u = 0; u < (KC == 1 ? 1 : 4); ++u)
#pragma unroll
                        for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
                }
                cp_async_wait<S - 2>();
                __syncthreads();
                issue(q + S - 1);
                const float* a = ring + (q % S) * CS_TILE;
                // B operand: solved rows of the band's block, or G
                const int t0 = fwd ? j * CS_BS : (i + 1 + j) * CS_BS;
                const bool onband = j < nband;
                if constexpr (KC == 1) {
                    if (fwd) {
                        if (onband && GY)
                            fma_rows1<true, VEC>(acc, a, Ysol + t0);
                        else
                            fma_rows1<false, true>(acc, a,
                                                   onband ? Ys + t0 : G);
                    } else {
                        if (onband && GY)
                            fma_cols1<true>(acc, a, Ysol + t0, n - t0);
                        else
                            fma_cols1<false>(acc, a, onband ? Ys + t0 : G,
                                             CS_BS);
                    }
                } else {
                    if (onband && GY) {
                        if (fwd)
                            fma_rows32<true>(acc, a, Ysol + (size_t)t0 * k,
                                             ldy, n - t0, vc);
                        else
                            fma_cols32<true>(acc, a, Ysol + (size_t)t0 * k,
                                             ldy, n - t0, vc);
                    } else {
                        const float* bm = onband ? Ys + t0 * KC : G;
                        if (fwd)
                            fma_rows32<false>(acc, a, bm, KC, CS_BS, KC);
                        else
                            fma_cols32<false>(acc, a, bm, KC, CS_BS, KC);
                    }
                }
            }
            const int np = reduce_partials<KC>(acc, part, fwd);
            // forward: Y_i to every peer (GY: to X, then a cluster barrier
            // before any peer reads it); backward: X_i to X, and to every
            // peer while earlier steps still need it
            if (GY) {
                exchange(np, false, nullptr, 1, true);
                cluster.sync();
            } else {
                exchange(np, false, fwd || i > 0 ? Ys + (bi + r0) * KC
                                                 : nullptr, 1, !fwd);
            }
        }
    }
}

// Launch the kernel for (KC, VEC, GY) as clusters of cs CTAs, its shared
// memory attributes set once per process.
template <int KC, bool VEC, bool GY>
int solve_launch(const float* L, const float* Dinv, const float* R, float* X,
                 int B, int n, int k, long long sRb, long long sRr, int cs,
                 int smem, cudaStream_t s)
{
    static unsigned smem_set;
    const auto fn = chol_solve_kernel<KC, VEC, GY>;
    cudaError_t e = smem_limit_once((const void*)fn, CS_SMEM_MAX, &smem_set,
                                    true);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs * ((k + KC - 1) / KC), B);
    cfg.blockDim = dim3(CS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, fn, L, Dinv, R, X, B, n, k, sRb, sRr);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// CTAs per cluster: 8, or one per 16 rows of a single block
int cluster_size(int n)
{
    return n > CS_BS ? CS_MAX : (n + CS_R - 1) / CS_R;
}

// Shared memory of a CTA in bytes, and whether the solved tile must go
// through device memory (GY) to stay within smem_max
int solve_smem(int kc, int n, int smem_max, bool* gy)
{
    const int npad = (n + CS_BS - 1) / CS_BS * CS_BS;
    const int bytes = cs_smem_floats(kc, npad, false) * (int)sizeof(float);
    *gy = bytes > min(smem_max, CS_SMEM_MAX);
    return *gy ? cs_smem_floats(kc, npad, true) * (int)sizeof(float) : bytes;
}

template <int KC>
int solve_dispatch(const float* L, const float* Dinv, const float* R,
                   float* X, int B, int n, int k, long long sRb,
                   long long sRr, bool vec, int smem_max, cudaStream_t s)
{
    const int cs = cluster_size(n);
    bool gy;
    const int smem = solve_smem(KC, n, smem_max, &gy);
    if (vec)
        return gy ? solve_launch<KC, true, true>(L, Dinv, R, X, B, n, k, sRb,
                                                 sRr, cs, smem, s)
                  : solve_launch<KC, true, false>(L, Dinv, R, X, B, n, k, sRb,
                                                  sRr, cs, smem, s);
    return gy ? solve_launch<KC, false, true>(L, Dinv, R, X, B, n, k, sRb,
                                              sRr, cs, smem, s)
              : solve_launch<KC, false, false>(L, Dinv, R, X, B, n, k, sRb,
                                               sRr, cs, smem, s);
}

}  // namespace

extern "C" {

// X (B, n, k) = (L L^T)^{-1} R.  R has unit column stride, batch stride sRb
// and row stride sRr (in floats); X must be 16-byte aligned.  The solved
// tile stays in shared memory when a CTA needs at most smem_max bytes
// with it there, else it goes through X.
int kvx_chol_solve(const void* L, const void* Dinv, const void* R, void* X,
                   int B, int n, int k, long long sRb, long long sRr,
                   int smem_max, void* stream)
{
    if (B < 1 || n < 1 || k < 1 || !aligned16(X))
        return (int)cudaErrorInvalidValue;
    const bool vec = n % 4 == 0 && aligned16(L) && aligned16(Dinv);
    const float *l = (const float*)L, *d = (const float*)Dinv,
                *r = (const float*)R;
    float* x = (float*)X;
    cudaStream_t s = (cudaStream_t)stream;
    if (k == 1)
        return solve_dispatch<1>(l, d, r, x, B, n, k, sRb, sRr, vec, smem_max,
                                 s);
    return solve_dispatch<32>(l, d, r, x, B, n, k, sRb, sRr, vec, smem_max, s);
}

}  // extern "C"
