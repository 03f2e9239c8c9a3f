// What the port's kernels share outside their tile products: the
// tanh-approximation GELU and its derivative, and the fixed-order second
// passes of a split reduction (per-split float32 partials added in split
// order, or many row blocks' partials of a few outputs, so that every output
// is the same bit for bit on every call).
#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace arreau {

constexpr int THREADS = 256;  // threads of a block of the elementwise passes

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

// gelu(x) and gelu'(x) from one tanh, the same expressions
__device__ __forceinline__ void gelu_and_deriv(float x, float& value, float& deriv) {
    const float t = tanhf(GELU_C0 * (x + GELU_C1 * x * x * x));
    value = 0.5f * x * (1.f + t);
    deriv = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * GELU_C0 * (1.f + 3.f * GELU_C1 * x * x);
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

// out[i] = sum over the row blocks b of part[b * n + i], for many blocks and
// few outputs (a block of THREADS threads for each 32 outputs): a warp's
// lanes take 32 consecutive outputs, its 8 warps every 8th block (each in
// ascending order), and the warps' sums are added in warp order. Static, as
// sum_splits_kernel.
static __global__ void __launch_bounds__(THREADS)
sum_blocks_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks,
                  long long n) {
    constexpr int WARPS = THREADS / 32;
    __shared__ float warp_sum[WARPS][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const long long i = blockIdx.x * 32LL + lane;
    float v = 0.f;
    if (i < n)
        for (int b = warp; b < blocks; b += WARPS) v += part[b * n + i];
    warp_sum[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && i < n) {
        float total = 0.f;
        for (int w = 0; w < WARPS; ++w) total += warp_sum[w][lane];
        out[i] = total;
    }
}

inline int sum_splits_blocks(long long n) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

}  // namespace arreau
