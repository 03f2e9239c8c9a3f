// Shared tile shape and inner product of the port's float32 SIMT kernels.
//
// A block of 256 threads owns a 64 x 64 output tile; each thread owns a
// 4 x 4 register sub-tile. The operands arrive BK = 16 deep in shared
// memory: A transposed (As[k][row], rows padded by 4 floats so the
// transposing stores spread over banks), B as is (Bs[k][col]). Both are
// read as float4, so every row start must stay 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace arreau {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // contraction depth staged per step
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int AS_LD = BM + 4;

static_assert((BM / TM) * (BN / TN) == THREADS, "tile does not match the block");
static_assert(AS_LD % 4 == 0 && BN % 4 == 0, "float4 reads need 16-byte rows");

// acc[i][j] += sum_k As[k][ty*TM + i] * Bs[k][tx*TN + j]
__device__ __forceinline__ void tile_fma(const float (*As)[AS_LD], const float (*Bs)[BN],
                                         int ty, int tx, float acc[TM][TN]) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// acc[i][j] += sum_{k < K} A(ty*TM + i, k) * B(k, tx*TN + j) for one 64 x 64
// tile, staged BK deep (spatial_conv.cu's forward keeps its own staging loop,
// which measured ~5% faster on the H100 than this helper at the same access
// pattern): load_a(r, k) returns A's tile row r at depth k and
// load_b(k, n) B's tile column n (each returns 0 outside its operand; depth
// k >= K is zero-filled here). A_K_CONTIG / B_N_CONTIG say which index is
// contiguous in memory, so that neighbouring threads load neighbouring
// addresses. Ends with a __syncthreads(): shared memory written before the
// call is visible to every thread after it.
template <bool A_K_CONTIG, bool B_N_CONTIG, class LoadA, class LoadB>
__device__ __forceinline__ void tile_gemm(int K, LoadA load_a, LoadB load_b,
                                          float (*As)[AS_LD], float (*Bs)[BN],
                                          float acc[TM][TN]) {
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int r = A_K_CONTIG ? i / BK : i % BM;
            const int kk = A_K_CONTIG ? i % BK : i / BM;
            As[kk][r] = k0 + kk < K ? load_a(r, k0 + kk) : 0.f;
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int n = B_N_CONTIG ? i % BN : i / BK;
            const int kk = B_N_CONTIG ? i / BN : i % BK;
            Bs[kk][n] = k0 + kk < K ? load_b(k0 + kk, n) : 0.f;
        }
        __syncthreads();
        tile_fma(As, Bs, ty, tx, acc);
        __syncthreads();
    }
}

// Tanh-approximation GELU (flax nn.gelu, torch approximate="tanh") and its
// derivative, from one tanh.
constexpr float GELU_C0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_C1 = 0.044715f;

__device__ __forceinline__ float gelu(float x) {
    const float t = tanhf(GELU_C0 * (x + GELU_C1 * x * x * x));
    return 0.5f * x * (1.f + t);
}

__device__ __forceinline__ float gelu_deriv(float x) {
    const float t = tanhf(GELU_C0 * (x + GELU_C1 * x * x * x));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * GELU_C0 * (1.f + 3.f * GELU_C1 * x * x);
}

// partial[split, m, n] = sum over the split's rows of A[row, m] * cot[row, n]
// with A = [feature(row, 0..M-1) | 1]: row M of the result is the bias
// gradient. One split-K weight gradient over every row of a layer; the
// second pass (sum_splits_kernel) adds the splits. cot is float or bf16.
template <class Feature, class Cot>
__global__ void __launch_bounds__(THREADS)
weight_grad_partial_kernel(Feature feature, const Cot* __restrict__ cot,  // [rows, N]
                           float* __restrict__ partial,  // [splits, M + 1, N]
                           long long rows, int M, int N, int rows_per_split) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const long long row0 = (long long)blockIdx.z * rows_per_split;
    const long long left = rows - row0;
    const int n_rows = left < rows_per_split ? (int)left : rows_per_split;

    float acc[TM][TN] = {};
    tile_gemm<false, true>(
        n_rows,
        [&](int m, int k) {
            const int mm = m0 + m;
            if (mm > M) return 0.f;
            return mm == M ? 1.f : feature(row0 + k, mm);
        },
        [&](int k, int n) {
            return n0 + n < N ? to_float(cot[(size_t)(row0 + k) * N + n0 + n]) : 0.f;
        },
        As, Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
    float* out = partial + (size_t)blockIdx.z * (M + 1) * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m > M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx * TN + j;
            if (n < N) out[(size_t)m * N + n] = acc[i][j];
        }
    }
}

// out[i] = sum_s partial[s * n + i]: the second pass of a split reduction
// (deterministic, unlike atomics). Static: every source file that includes
// this header gets its own copy.
static __global__ void __launch_bounds__(THREADS)
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out, int splits,
                  long long n) {
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        float s = 0.f;
        for (int k = 0; k < splits; ++k) s += partial[k * n + i];
        out[i] = s;
    }
}

inline int sum_splits_blocks(long long n) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

}  // namespace arreau
