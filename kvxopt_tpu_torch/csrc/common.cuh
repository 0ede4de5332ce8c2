// Helpers shared by the port's kernels: cp.async copies into shared
// memory with zero-fill, the f64 m16n8k16 tensor-core product,
// mbarriers across a cluster, and the once-per-process shared-memory
// limit.
//
// Everything here is static or in an anonymous namespace: each source
// that includes this header gets its own copy and builds as a separate
// object.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

// Copy 16 bytes (VEC) or 4 bytes into shared memory; ok = false writes
// zeros and reads nothing.
template <bool VEC>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (VEC)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy a ROWS x COLS tile from device memory (row stride ld) into shared
// memory (row stride dld) with the THREADS threads of the CTA; rows >= vr
// and columns >= vc are zero-filled.  VEC needs 16-byte aligned rows and
// vc a multiple of 4.
template <int ROWS, int COLS, bool VEC, int THREADS>
__device__ __forceinline__ void tile_async(float* dst, int dld,
                                           const float* src, size_t ld,
                                           int vr, int vc)
{
    constexpr int W = VEC ? 4 : 1;
    constexpr int CW = COLS / W;
    static_assert((ROWS * CW) % THREADS == 0, "tile must split evenly");
#pragma unroll
    for (int it = 0; it < ROWS * CW / THREADS; ++it) {
        const int idx = it * THREADS + threadIdx.x;
        const int r = idx / CW, c = (idx % CW) * W;
        const bool ok = r < vr && c < vc;
        cp_async_zfill<VEC>(dst + r * dld + c, ok ? src + r * ld + c : src,
                            ok);
    }
}

// mbarriers, st.async and remote arrivals: the exchanges between the CTAs
// of a cluster.  A receiver arms its barrier for the bytes of one exchange
// and every sender's st.async completes its share of them (K2), or its
// peers arrive on it once their writes to device memory are done (K1,
// K4).
__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

// Copy 16 or 8 bytes of doubles into shared memory; ok = false writes
// zeros and reads nothing (K5, K6, K7).
__device__ __forceinline__ void cp_async16(double* dst, const double* src,
                                           bool ok)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool ok)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}

// d += a b over a 16 x 16 by 16 x 8 f64 product on the tensor cores
// (K6, K7): lane (g, t) = (lane / 4, lane % 4) holds
// A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i], B[t + 4 i][g] in b[i] and
// D[g][2t + e], D[g + 8][2t + e] in d[e], d[2 + e] (e = 0, 1).  Hopper
// runs the m16n8 f64 shapes at the full f64 tensor rate, m8n8k4 at half.
__device__ __forceinline__ void dmma16x16(double (&d)[4], const double (&a)[8],
                                          const double (&b)[4])
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64"
                 " {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11},"
                 " {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                   "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                   "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity)
{
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                     " p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                     : "memory");
}

// the shared::cluster address of local shared address `addr` in CTA `rank`
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank)
{
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar)
{
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                 ".v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
                 :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
                    "r"(bar) : "memory");
}

// Arrive, with release at cluster scope, on the mbarrier at shared::cluster
// address `bar` (from mapa): the caller's earlier writes, and those its
// CTA ordered before it by a barrier, become visible to the CTA that
// waits on it.
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar)
{
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64"
                 " _, [%0];\n" :: "r"(bar) : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Raise a kernel's dynamic shared-memory limit once per process and
// device (a driver call on every launch costs host time on a path of
// many small launches); with max_shared, also ask for the largest shared
// memory carveout, so that two CTAs of over 100 KB fit on one SM.  `done`
// is a static flag word of the caller, one bit per device.
static inline cudaError_t smem_limit_once(const void* fn, int bytes,
                                          unsigned* done,
                                          bool max_shared = false)
{
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || (*done >> dev & 1u)) return e;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess && max_shared)
        e = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) *done |= 1u << dev;
    return e;
}
