// Warp-level tensor-core products for sm_90a through mma.sync, and the
// cp.async copies that stage their operands.
//
// Mma<T> holds one element type's fragments and product:
//   - bfloat16: m16n8k16, bf16 x bf16 products exact in float32, float32
//     sums; fragments from shared memory by ldmatrix (.trans where the
//     stored operand is contiguous along m or n instead of k);
//   - float32: m16n8k8 in 3xTF32. Each value v splits into big =
//     cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big), and
//     acc += a_small*b_big + a_big*b_small + a_big*b_big: the dropped
//     small*small term and small's own rounding are ~2^-22 of the product,
//     float32-level error where 1-pass TF32 would keep ~2^-11. 32-bit
//     fragments have no ldmatrix.trans, so they are read from shared memory
//     element by element, at row strides that keep a warp's reads on 32
//     distinct banks.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / k8"),
// with g = lane / 4 and t = lane % 4:
//   k16 bf16: a = A[g|g+8][2t..2t+1 | 2t+8..2t+9], b = B[2t..2t+1 | 2t+8..][g]
//   k8 tf32:  a = A[g|g+8][t | t+4],               b = B[t | t+4][g]
//   both:     c = C[g|g+8][2t..2t+1]
// Shared tiles are stored either k-contiguous (A as [m][k], B as [n][k]) or
// m/n-contiguous (A as [k][m], B as [k][n]); KMAJOR says which.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace arreau {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the last 16 - src_bytes of them zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32_1688(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cvt.rna.tf32.f32 (round to 10 mantissa bits, to nearest, ties away from
// zero), as integer operations on the bits: the same result, without the
// conversion instruction's slower pipe
__device__ __forceinline__ uint32_t to_tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
    big = to_tf32(v);
    small = to_tf32(v - __uint_as_float(big));
}

template <class T>
struct Mma;

template <>
struct Mma<bf16> {
    static constexpr int K = 16;  // depth of one product
    struct A {
        uint32_t r[4];
    };
    struct B {
        uint32_t r[2];
    };

    // A's 16 x 16 fragment at (m0, k0): s[m][k] (KMAJOR) or s[k][m]
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_a(A& a, const bf16* s, int ld, int m0, int k0) {
        const int lane = threadIdx.x % 32, r = lane % 8, mat = lane / 8;
        if constexpr (KMAJOR)
            ldmatrix_x4(a.r, s + (m0 + r + (mat % 2) * 8) * ld + k0 + (mat / 2) * 8);
        else
            ldmatrix_x4_trans(a.r, s + (k0 + r + (mat / 2) * 8) * ld + m0 + (mat % 2) * 8);
    }
    // B's 16 x 8 fragments at (k0, n0) and (k0, n1): s[n][k] (KMAJOR) or s[k][n]
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_b2(B& b0, B& b1, const bf16* s, int ld, int n0,
                                                   int n1, int k0) {
        const int lane = threadIdx.x % 32, r = lane % 8, mat = lane / 8;
        const int n = mat < 2 ? n0 : n1;
        uint32_t q[4];
        if constexpr (KMAJOR)
            ldmatrix_x4(q, s + (n + r) * ld + k0 + (mat % 2) * 8);
        else
            ldmatrix_x4_trans(q, s + (k0 + r + (mat % 2) * 8) * ld + n);
        b0.r[0] = q[0], b0.r[1] = q[1], b1.r[0] = q[2], b1.r[1] = q[3];
    }
    // B's 16 x 8 fragment at (k0, n0) alone (lanes 16-31 give no address)
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_b(B& b, const bf16* s, int ld, int n0, int k0) {
        const int lane = threadIdx.x % 32, r = lane % 8, half = lane / 8 % 2;
        if constexpr (KMAJOR)
            ldmatrix_x2(b.r, s + (n0 + r) * ld + k0 + half * 8);
        else
            ldmatrix_x2_trans(b.r, s + (k0 + r + half * 8) * ld + n0);
    }
    __device__ __forceinline__ static void mma(float d[4], const A& a, const B& b) {
        mma_bf16_16816(d, a.r, b.r);
    }
};

template <>
struct Mma<float> {
    static constexpr int K = 8;
    struct A {
        uint32_t big[4], small[4];
    };
    struct B {
        uint32_t big[2], small[2];
    };

    template <bool KMAJOR>
    __device__ __forceinline__ static float at(const float* s, int ld, int row, int k) {
        return KMAJOR ? s[row * ld + k] : s[k * ld + row];
    }
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_a(A& a, const float* s, int ld, int m0, int k0) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            split_tf32(at<KMAJOR>(s, ld, m0 + g + (i % 2) * 8, k0 + t + (i / 2) * 4), a.big[i],
                       a.small[i]);
    }
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_b(B& b, const float* s, int ld, int n0, int k0) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < 2; ++i)
            split_tf32(at<KMAJOR>(s, ld, n0 + g, k0 + t + i * 4), b.big[i], b.small[i]);
    }
    template <bool KMAJOR>
    __device__ __forceinline__ static void load_b2(B& b0, B& b1, const float* s, int ld, int n0,
                                                   int n1, int k0) {
        load_b<KMAJOR>(b0, s, ld, n0, k0);
        load_b<KMAJOR>(b1, s, ld, n1, k0);
    }
    __device__ __forceinline__ static void mma(float d[4], const A& a, const B& b) {
        mma_tf32_1688(d, a.small, b.big);
        mma_tf32_1688(d, a.big, b.small);
        mma_tf32_1688(d, a.big, b.big);
    }
};

}  // namespace arreau
