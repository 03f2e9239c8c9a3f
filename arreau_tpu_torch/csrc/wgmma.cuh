// Hopper's own tensor-core and copy instructions for sm_90a, as inline PTX in
// the style of mma.cuh, free of anything one kernel needs:
//
//   - wgmma.mma_async: a warpgroup (four consecutive warps, 128 threads)
//     multiplies a 64-row A tile by an N-column B tile, both read from
//     shared memory through matrix descriptors, into float32 accumulators
//     in registers; bfloat16 at depth 16 (Wgmma<bf16, N>) or tf32 at depth 8
//     (Wgmma<float, N>, the operands already rounded to tf32: 3xTF32 issues
//     three products on big/small halves, split_tf32 in mma.cuh). N is any
//     multiple of 16 up to 256. The product runs asynchronously: fence before
//     the first, commit the issued products as a group, wait for groups.
//   - Shared-memory operands in the 128-byte swizzle ("SW128", K-major):
//     a tile is stored as panels of 128 bytes a row (64 bfloat16 or 32
//     float32 along K), rows at 128 bytes, the 16-byte chunk c of row r at
//     chunk c ^ (r % 8); a panel starts 1024-byte aligned. sw128_offset
//     gives an element's byte offset, sw128_desc a panel's descriptor; a
//     product step at depth k0 inside the panel starts k0 * sizeof(T) bytes
//     further. The Tensor Memory Accelerator writes the same layout with
//     CU_TENSOR_MAP_SWIZZLE_128B and a 128-byte box row.
//   - Bfloat16 operands in the MN-major 128-byte swizzle (wgmma's transposed
//     operands: tf32 has none): a box of K rows, each 128 bytes of 64
//     consecutive M (or N) elements, chunk c of row k at chunk c ^ (k % 8),
//     as TMA writes a box of a row-major [K, M] matrix; the 64-element blocks
//     of M (or N) lie lbo bytes apart, the 8-row groups of K 1024 bytes.
//     sw128_mn_desc gives its descriptor, Wgmma<bf16, N>::mma_mn the product
//     of two such operands; a k16 step starts 16 * 128 bytes further.
//   - Two warpgroups on one ring of TMA panels (Ring, release,
//     panel_product): the plumbing the sm_90 kernels share.
//   - cp.async.bulk.tensor (TMA) 2-D and 3-D loads into shared memory,
//     completing on an mbarrier with a byte count, and 2-D stores from shared
//     memory (a 3-D box of one outer index clips its rows at the middle
//     dimension's extent: zeros past a slab's end);
//     mbarrier init, arrive, arrive with expected bytes, and parity waits;
//     the proxy fence that makes the threads' shared-memory writes visible
//     to wgmma and TMA; an L2 prefetch of a contiguous range.
//
// Accumulators of a m64nN product (PTX ISA, "Matrix fragments for wgmma"):
// thread i of the warpgroup, w = i / 32, g = i % 32 / 4, t = i % 4, holds
// d[4j + 2h + e] = D[16w + g + 8h][8j + 2t + e], j < N / 8, h, e in {0, 1}:
// mma.sync's m16n8 C fragment, one n8 tile after another. wgmma_for_each
// walks them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "mma.cuh"

namespace arreau {

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}
// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}
// one arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::
                     "r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
// until the barrier's phase of this parity has completed; a wait longer than
// 2^34 clock cycles (~10 s) traps, so that a kernel whose copies never land
// fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t a = smem_addr(bar);
    const long long start = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
        if (!done && clock64() - start > (1LL << 34)) __trap();
    } while (!done);
}

// whether the barrier's phase of this parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// ---- TMA ------------------------------------------------------------------

// the box at (c0, c1) (innermost coordinate first, in elements) of `map` into
// shared memory at dst; its bytes complete on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
        : "memory");
}
// the box at (c0, c1, c2) of a 3-D `map` into shared memory at dst; its bytes
// complete on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
// the box at (c0, c1) of `map` from shared memory at src; the parts of the box
// outside the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                     "l"(reinterpret_cast<uint64_t>(map)),
                 "r"(smem_addr(src)), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// the threads' shared-memory writes, visible to wgmma and TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bytes (a multiple of 16) at p (16-byte aligned) into L2
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// bar.sync on barrier id (1..15) for `threads` threads (a warpgroup's 128)
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- shared-memory operands ----------------------------------------------

// byte offset of element (r, k) in SW128 K-major panels of `rows` rows:
// panel k / (128 / sizeof(T)), row r, swizzled chunk
template <class T>
__host__ __device__ __forceinline__ int sw128_offset(int r, int k, int rows) {
    constexpr int PER = 128 / sizeof(T);  // elements a panel row holds
    const int byte = (k % PER) * (int)sizeof(T);
    return (k / PER) * rows * 128 + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

// descriptor of a K-major SW128 operand whose 8-row groups lie 1024 bytes
// apart, starting at p (a panel's start, plus the product step's depth in
// bytes): start >> 4, leading offset unused (1), stride offset 1024 >> 4,
// swizzle mode 1 (128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    const uint64_t a = smem_addr(p);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// descriptor of an MN-major SW128 bfloat16 operand at p (1024-byte aligned
// plus the product step's 16 * 128 bytes): its 64-element blocks of M (or N)
// lbo bytes apart, its 8-row groups of K 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t lbo) {
    const uint64_t a = smem_addr(p);
    return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products (call before the first product and after the wait)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <class T, int N>
struct Wgmma;

// the accumulator list of one product: operands 0-2 are the descriptors and
// the scale flag, the N / 2 accumulators follow from operand 3
#define ARREAU_R0 "%3, %4, %5, %6, %7, %8, %9, %10"
#define ARREAU_R1 ", %11, %12, %13, %14, %15, %16, %17, %18"
#define ARREAU_R2 ", %19, %20, %21, %22, %23, %24, %25, %26"
#define ARREAU_R3 ", %27, %28, %29, %30, %31, %32, %33, %34"
#define ARREAU_R4 ", %35, %36, %37, %38, %39, %40, %41, %42"
#define ARREAU_R5 ", %43, %44, %45, %46, %47, %48, %49, %50"
#define ARREAU_R6 ", %51, %52, %53, %54, %55, %56, %57, %58"
#define ARREAU_R7 ", %59, %60, %61, %62, %63, %64, %65, %66"
#define ARREAU_R8 ", %67, %68, %69, %70, %71, %72, %73, %74"
#define ARREAU_R9 ", %75, %76, %77, %78, %79, %80, %81, %82"
#define ARREAU_R10 ", %83, %84, %85, %86, %87, %88, %89, %90"
#define ARREAU_R11 ", %91, %92, %93, %94, %95, %96, %97, %98"
#define ARREAU_R12 ", %99, %100, %101, %102, %103, %104, %105, %106"
#define ARREAU_R13 ", %107, %108, %109, %110, %111, %112, %113, %114"
#define ARREAU_R14 ", %115, %116, %117, %118, %119, %120, %121, %122"
#define ARREAU_R15 ", %123, %124, %125, %126, %127, %128, %129, %130"
#define ARREAU_REGS_16 ARREAU_R0
#define ARREAU_REGS_32 ARREAU_REGS_16 ARREAU_R1
#define ARREAU_REGS_48 ARREAU_REGS_32 ARREAU_R2
#define ARREAU_REGS_64 ARREAU_REGS_48 ARREAU_R3
#define ARREAU_REGS_80 ARREAU_REGS_64 ARREAU_R4
#define ARREAU_REGS_96 ARREAU_REGS_80 ARREAU_R5
#define ARREAU_REGS_112 ARREAU_REGS_96 ARREAU_R6
#define ARREAU_REGS_128 ARREAU_REGS_112 ARREAU_R7
#define ARREAU_REGS_144 ARREAU_REGS_128 ARREAU_R8
#define ARREAU_REGS_160 ARREAU_REGS_144 ARREAU_R9
#define ARREAU_REGS_176 ARREAU_REGS_160 ARREAU_R10
#define ARREAU_REGS_192 ARREAU_REGS_176 ARREAU_R11
#define ARREAU_REGS_208 ARREAU_REGS_192 ARREAU_R12
#define ARREAU_REGS_224 ARREAU_REGS_208 ARREAU_R13
#define ARREAU_REGS_240 ARREAU_REGS_224 ARREAU_R14
#define ARREAU_REGS_256 ARREAU_REGS_240 ARREAU_R15
// the operand lists of a product whose A is four registers (mma_rs): the N /
// 2 accumulators are operands 0.., the inputs follow them: the fragments and
// the descriptor of B (ARREAU_RS_IN_N), the scale flag (ARREAU_RS_S_N)
#define ARREAU_T0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define ARREAU_T1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define ARREAU_T2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ARREAU_T3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define ARREAU_T4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define ARREAU_T5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define ARREAU_T6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define ARREAU_T7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define ARREAU_T8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define ARREAU_T9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define ARREAU_T10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define ARREAU_T11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define ARREAU_T12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define ARREAU_T13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define ARREAU_T14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define ARREAU_T15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define ARREAU_TS_16 ARREAU_T0
#define ARREAU_TS_32 ARREAU_TS_16 ARREAU_T1
#define ARREAU_TS_48 ARREAU_TS_32 ARREAU_T2
#define ARREAU_TS_64 ARREAU_TS_48 ARREAU_T3
#define ARREAU_TS_80 ARREAU_TS_64 ARREAU_T4
#define ARREAU_TS_96 ARREAU_TS_80 ARREAU_T5
#define ARREAU_TS_112 ARREAU_TS_96 ARREAU_T6
#define ARREAU_TS_128 ARREAU_TS_112 ARREAU_T7
#define ARREAU_TS_144 ARREAU_TS_128 ARREAU_T8
#define ARREAU_TS_160 ARREAU_TS_144 ARREAU_T9
#define ARREAU_TS_176 ARREAU_TS_160 ARREAU_T10
#define ARREAU_TS_192 ARREAU_TS_176 ARREAU_T11
#define ARREAU_TS_208 ARREAU_TS_192 ARREAU_T12
#define ARREAU_TS_224 ARREAU_TS_208 ARREAU_T13
#define ARREAU_TS_240 ARREAU_TS_224 ARREAU_T14
#define ARREAU_TS_256 ARREAU_TS_240 ARREAU_T15
#define ARREAU_RS_IN_16 "{%8, %9, %10, %11}, %12"
#define ARREAU_RS_S_16 "%13"
#define ARREAU_RS_IN_32 "{%16, %17, %18, %19}, %20"
#define ARREAU_RS_S_32 "%21"
#define ARREAU_RS_IN_48 "{%24, %25, %26, %27}, %28"
#define ARREAU_RS_S_48 "%29"
#define ARREAU_RS_IN_64 "{%32, %33, %34, %35}, %36"
#define ARREAU_RS_S_64 "%37"
#define ARREAU_RS_IN_80 "{%40, %41, %42, %43}, %44"
#define ARREAU_RS_S_80 "%45"
#define ARREAU_RS_IN_96 "{%48, %49, %50, %51}, %52"
#define ARREAU_RS_S_96 "%53"
#define ARREAU_RS_IN_112 "{%56, %57, %58, %59}, %60"
#define ARREAU_RS_S_112 "%61"
#define ARREAU_RS_IN_128 "{%64, %65, %66, %67}, %68"
#define ARREAU_RS_S_128 "%69"
#define ARREAU_RS_IN_144 "{%72, %73, %74, %75}, %76"
#define ARREAU_RS_S_144 "%77"
#define ARREAU_RS_IN_160 "{%80, %81, %82, %83}, %84"
#define ARREAU_RS_S_160 "%85"
#define ARREAU_RS_IN_176 "{%88, %89, %90, %91}, %92"
#define ARREAU_RS_S_176 "%93"
#define ARREAU_RS_IN_192 "{%96, %97, %98, %99}, %100"
#define ARREAU_RS_S_192 "%101"
#define ARREAU_RS_IN_208 "{%104, %105, %106, %107}, %108"
#define ARREAU_RS_S_208 "%109"
#define ARREAU_RS_IN_224 "{%112, %113, %114, %115}, %116"
#define ARREAU_RS_S_224 "%117"
#define ARREAU_RS_IN_240 "{%120, %121, %122, %123}, %124"
#define ARREAU_RS_S_240 "%125"
#define ARREAU_RS_IN_256 "{%128, %129, %130, %131}, %132"
#define ARREAU_RS_S_256 "%133"
#define ARREAU_ACC8(i)                                                                  \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ARREAU_ACCS_16 ARREAU_ACC8(0)
#define ARREAU_ACCS_32 ARREAU_ACCS_16, ARREAU_ACC8(8)
#define ARREAU_ACCS_48 ARREAU_ACCS_32, ARREAU_ACC8(16)
#define ARREAU_ACCS_64 ARREAU_ACCS_48, ARREAU_ACC8(24)
#define ARREAU_ACCS_80 ARREAU_ACCS_64, ARREAU_ACC8(32)
#define ARREAU_ACCS_96 ARREAU_ACCS_80, ARREAU_ACC8(40)
#define ARREAU_ACCS_112 ARREAU_ACCS_96, ARREAU_ACC8(48)
#define ARREAU_ACCS_128 ARREAU_ACCS_112, ARREAU_ACC8(56)
#define ARREAU_ACCS_144 ARREAU_ACCS_128, ARREAU_ACC8(64)
#define ARREAU_ACCS_160 ARREAU_ACCS_144, ARREAU_ACC8(72)
#define ARREAU_ACCS_176 ARREAU_ACCS_160, ARREAU_ACC8(80)
#define ARREAU_ACCS_192 ARREAU_ACCS_176, ARREAU_ACC8(88)
#define ARREAU_ACCS_208 ARREAU_ACCS_192, ARREAU_ACC8(96)
#define ARREAU_ACCS_224 ARREAU_ACCS_208, ARREAU_ACC8(104)
#define ARREAU_ACCS_240 ARREAU_ACCS_224, ARREAU_ACC8(112)
#define ARREAU_ACCS_256 ARREAU_ACCS_240, ARREAU_ACC8(120)

// d += A B over one product step, A (64 x K) and B (N x K) both K-major in
// shared memory (descriptors da, db): bfloat16 at K = 16, tf32 at K = 8;
// mma_mn (bfloat16): both MN-major (sw128_mn_desc); mma_rs (bfloat16): A
// from registers, four packed bfloat16 pairs a thread in the layout of a
// m64n16 accumulator (a[0]: row 16w + g, k 2t..2t+1; a[1]: row + 8; a[2]
// and a[3]: k + 8), so that one product's accumulators, rounded, are the
// next one's A
#define ARREAU_WGMMA_N(N)                                                                    \
    template <>                                                                              \
    struct Wgmma<bf16, N> {                                                                  \
        static constexpr int K = 16;                                                         \
        __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t da,          \
                                                   uint64_t db) {                            \
            uint32_t scale = 1;                                                              \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                        \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"        \
                         ARREAU_REGS_##N "}, %0, %1, p, 1, 1, 0, 0;\n}\n"                    \
                         : "+l"(da), "+l"(db), "+r"(scale), ARREAU_ACCS_##N);               \
        }                                                                                    \
        __device__ __forceinline__ static void mma_mn(float (&d)[N / 2], uint64_t da,       \
                                                      uint64_t db) {                         \
            uint32_t scale = 1;                                                              \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                        \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"        \
                         ARREAU_REGS_##N "}, %0, %1, p, 1, 1, 1, 1;\n}\n"                    \
                         : "+l"(da), "+l"(db), "+r"(scale), ARREAU_ACCS_##N);               \
        }                                                                                    \
        __device__ __forceinline__ static void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], \
                                                      uint64_t db) {                         \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " ARREAU_RS_S_##N ", 0;\n"         \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"        \
                         ARREAU_TS_##N "}, " ARREAU_RS_IN_##N ", p, 1, 1, 0;\n}\n"         \
                         : ARREAU_ACCS_##N                                                   \
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));   \
        }                                                                                    \
    };                                                                                       \
    template <>                                                                              \
    struct Wgmma<float, N> {                                                                 \
        static constexpr int K = 8;                                                          \
        __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t da,          \
                                                   uint64_t db) {                            \
            uint32_t scale = 1;                                                              \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                        \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"         \
                         ARREAU_REGS_##N "}, %0, %1, p, 1, 1;\n}\n"                          \
                         : "+l"(da), "+l"(db), "+r"(scale), ARREAU_ACCS_##N);               \
        }                                                                                    \
    };

ARREAU_WGMMA_N(16)
ARREAU_WGMMA_N(32)
ARREAU_WGMMA_N(48)
ARREAU_WGMMA_N(64)
ARREAU_WGMMA_N(80)
ARREAU_WGMMA_N(96)
ARREAU_WGMMA_N(112)
ARREAU_WGMMA_N(128)
ARREAU_WGMMA_N(144)
ARREAU_WGMMA_N(160)
ARREAU_WGMMA_N(176)
ARREAU_WGMMA_N(192)
ARREAU_WGMMA_N(208)
ARREAU_WGMMA_N(224)
ARREAU_WGMMA_N(240)
ARREAU_WGMMA_N(256)

// f(k, m, n, d[2k], d[2k + 1]) for this thread's accumulator pairs k of a
// m64nN product (m < 64 the warpgroup's row, n even; k known at compile time)
template <int N, class Fn>
__device__ __forceinline__ void wgmma_for_each(float (&d)[N / 2], Fn f) {
    const int i = threadIdx.x % 128, w = i / 32, g = i % 32 / 4, t = i % 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            f(2 * j + h, 16 * w + g + 8 * h, 8 * j + 2 * t, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// dynamic shared memory aligned to 1024 bytes (the 128-byte swizzle's
// period); a kernel asks for 1024 bytes more than it uses
__device__ __forceinline__ unsigned char* aligned_smem() {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t a = smem_addr(smem_raw);
    return smem_raw + ((1024 - (a & 1023)) & 1023);
}

// ---- two warpgroups on one ring of TMA panels --------------------------------
//
// The layout the sm_90 kernels share (conv_sm90.cuh, basis_sm90.cuh,
// basis_f32_sm90.cuh): a block is two warpgroups, each on 64 rows (wgmma's
// M), and every product's operands come through one ring of shared-memory
// slots. The ring has no producer warp (one of its own capped the bf16 basis
// kernels' consumers at 168 registers): thread 0 issues the first panels,
// and the last warp to release a slot (a shared-memory count) issues the TMA
// loads of the slot's next panel at once, each completing on the slot's
// `full` mbarrier; so no warp waits for the other warpgroup to release a
// slot, and stages - 1 panels stay in flight. The panel count runs on across
// a persistent block's tiles, so the next tile's loads land during this
// tile's epilogue. (In development builds a producer thread that waited for
// every warp's release held its warpgroup to the other's pace, and one that
// refilled only slots already free let the ring run dry.)

constexpr int WG = 128;                // threads of a warpgroup
constexpr int BLOCK_THREADS = 2 * WG;  // a block: two warpgroups
constexpr int ROWS = 64;               // a warpgroup's rows (wgmma's M)
constexpr int PANEL = ROWS * 128;      // bytes of a 64-row panel (128 bytes of K a row)
constexpr int MAX_STAGES = 8;          // the ring's barriers are static arrays of this size

__host__ __device__ constexpr int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// the tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... < n of a persistent block
__device__ __forceinline__ int block_tiles(int n) {
    return ((int)(n - blockIdx.x) + (int)gridDim.x - 1) / (int)gridDim.x;
}

// the calling warpgroup's named barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync() { named_barrier(1 + threadIdx.x / WG, WG); }

// panels through `stages` slots of `bytes`; `on`: the slots are refilled by
// TMA as they are released (else each keeps what ring_fill or the block's
// threads put there: a conv's thread-staged panels, bfloat16 #8's resident
// W1); `total`: the block's panels; `released[s]`: the warps done with slot
// s's panel so far
struct Ring {
    uint64_t* full;
    int* released;
    unsigned char* base;
    int bytes, stages, total;
    bool on;
    __device__ __forceinline__ unsigned char* slot(int s) const { return base + s * bytes; }
};

// thread 0, once: the barriers (full: one arrival and the bytes) and the
// release counts; the caller fences and syncs
__device__ __forceinline__ void ring_init(const Ring& r) {
    for (int s = 0; s < r.stages; ++s) {
        mbar_init(&r.full[s], 1);
        r.released[s] = 0;
    }
}

// thread 0: the ring's first panels
template <class Issue>
__device__ __forceinline__ void ring_fill(const Ring& r, Issue& issue) {
    for (int q = 0; q < r.stages && q < r.total; ++q) issue(q, q);
}

// every thread: ring_init, then ring_fill, the barriers visible to the block
template <class Issue>
__device__ __forceinline__ void ring_start(const Ring& r, Issue& issue) {
    if (threadIdx.x == 0) {
        ring_init(r);
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) ring_fill(r, issue);
    __syncwarp();
}

// every warp: done with panel q's slot. The last of the block's warps to
// release it refills it with panel q + stages at once.
template <class Issue>
__device__ __forceinline__ void release(const Ring& r, int q, Issue& issue) {
    if (!r.on) return;
    if (threadIdx.x % 32 == 0) {
        const int s = q % r.stages;
        __threadfence_block();  // this warp's reads of the slot are done
        if (atomicAdd(&r.released[s], 1) == BLOCK_THREADS / 32 - 1) {
            r.released[s] = 0;
            __threadfence_block();
            if (q + r.stages < r.total) issue(q + r.stages, s);
        }
    }
    __syncwarp();
}

// acc += A B^T over one 128-byte K-panel: A the 64-row panel at a, B the
// NB-row panel at b, both K-major SW128; float32: 3xTF32 (as mma.cuh: a_small
// b_big + a_big b_small + a_big b_big a step), A's small halves a_small bytes
// after a, B's b_small bytes after b. Issued and committed, not waited for.
template <class T, int NB>
__device__ __forceinline__ void panel_product(float (&acc)[NB / 2], const unsigned char* a,
                                              const unsigned char* b, int b_small,
                                              int a_small = PANEL) {
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int off = 32 * k;
        if constexpr (sizeof(T) == 4) {
            Wgmma<float, NB>::mma(acc, sw128_desc(a + a_small + off), sw128_desc(b + off));
            Wgmma<float, NB>::mma(acc, sw128_desc(a + off), sw128_desc(b + b_small + off));
        }
        Wgmma<T, NB>::mma(acc, sw128_desc(a + off), sw128_desc(b + off));
    }
    wgmma_commit();
}

// the last panel's products done; its slot released
template <int NB, class Issue>
__device__ __forceinline__ void product_finish(float (&acc)[NB / 2], Ring& ring, int q_last,
                                               Issue& issue) {
    wgmma_wait<0>();
    fence_acc(acc);
    release(ring, q_last, issue);
}

// ---- launches (host) ------------------------------------------------------

// a kernel's dynamic shared memory limit, set the first time a launch on a
// device asks for more than it was set to there: one object a kernel (a
// static of its launch function), so that cudaFuncSetAttribute runs once
// for each kernel, device and size
struct SmemOptIn {
    static constexpr int DEVICES = 64;
    int set[DEVICES] = {};
    template <class Kernel>
    cudaError_t ensure(Kernel kernel, int bytes) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev < DEVICES && set[dev] >= bytes) return cudaSuccess;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess && dev < DEVICES) set[dev] = bytes;
        return err;
    }
};

inline int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

// the persistent grid: a block an SM, or a block a tile
inline int persistent_blocks(int n_tiles) { return n_tiles < sm_count() ? n_tiles : sm_count(); }

// a kernel's dynamic shared memory: the plan's bytes (given), checked to hold
// the layout the kernel addresses (need) with 2 .. MAX_STAGES ring slots, and
// set as the kernel's limit once for each device and size (SmemOptIn). One
// object for each kernel (a static of its launch function).
struct SmemLimit {
    SmemOptIn opt_in;
    template <class Kernel>
    cudaError_t check(Kernel kernel, size_t need, int given, int stages) {
        if (need > (size_t)given || stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
        return opt_in.ensure(kernel, given);
    }
};

// ---- tensor maps (host) ---------------------------------------------------

// cuTensorMapEncodeTiled, a libcuda entry point, fetched once through the
// runtime (cudaGetDriverEntryPoint*), so the library need not link libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a tensor map of the row-major [dim1, dim0] matrix at base (row stride
// stride bytes, a multiple of 16; base 16-byte aligned) whose boxes are box1
// rows of box0 elements (box0 * sizeof(T) == 128: one SW128 panel row), in
// the 128-byte swizzle; reads outside the matrix give zeros. Returns false if
// the encoding fails.
template <class T>
bool sw128_map(CUtensorMap* map, const void* base, long long dim0, long long dim1,
               long long stride, int box1) {
    static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bfloat16 or float32");
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)dim0, (cuuint64_t)dim1};
    const cuuint64_t strides[1] = {(cuuint64_t)stride};
    const cuuint32_t box[2] = {128 / (cuuint32_t)sizeof(T), (cuuint32_t)box1};
    const cuuint32_t unit[2] = {1, 1};
    return fn(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a tensor map of the row-major [dim2, dim1, dim0] tensor at base (strides
// stride1 and stride2 bytes, multiples of 16; base 16-byte aligned) whose
// boxes are box1 rows of one slab (index 2) by one SW128 panel row (box0 *
// sizeof(T) == 128), in the 128-byte swizzle; a box's rows past dim1 and
// elements past dim0 read as zeros. Returns false if the encoding fails.
template <class T>
bool sw128_map_3d(CUtensorMap* map, const void* base, long long dim0, long long dim1,
                  long long dim2, long long stride1, long long stride2, int box1) {
    static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bfloat16 or float32");
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)dim0, (cuuint64_t)dim1, (cuuint64_t)dim2};
    const cuuint64_t strides[2] = {(cuuint64_t)stride1, (cuuint64_t)stride2};
    const cuuint32_t box[3] = {128 / (cuuint32_t)sizeof(T), (cuuint32_t)box1, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace arreau
