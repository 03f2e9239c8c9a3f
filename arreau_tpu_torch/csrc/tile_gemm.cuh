// Shared tile shape and inner product of the port's float32 SIMT kernels.
//
// A block of 256 threads owns a 64 x 64 output tile; each thread owns a
// 4 x 4 register sub-tile. The operands arrive BK = 16 deep in shared
// memory: A transposed (As[k][row], rows padded by 4 floats so the
// transposing stores spread over banks), B as is (Bs[k][col]). Both are
// read as float4, so every row start must stay 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

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
