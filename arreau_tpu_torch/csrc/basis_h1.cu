// First layer of the edge-basis MLP, forward, float32, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel
// (reached from basis_mlp_multi through _h1). For each (b', o) and edge e:
//
//   h1_pre[b',o,e,h] = b1[h] + sum_f poly(attrT[b',o,:,e])[f] * W1[f,h]
//
// where poly is the tensor-power feature vector [x, x(x)x, x(x)x(x)x] of the
// d edge invariants, in the order of polynomial_features
// (arreau_tpu/models/blocks.py:70): F = d + d^2 + d^3 = 258 for d = 6.
// GELU and the second Dense stay outside, as in the JAX package.
//
// Bound on the H100: 2*B'*O*E*F*H float32 operations (13.5 GFLOP at the
// sampler's shape) against a 105 MB output write, so float32 arithmetic
// bounds it. Design: the [E, F] feature tensor never reaches device memory.
// A block owns 64 edges x 64 hidden units of one (b', o); it stages the
// block's d x 64 invariants in shared memory once, then builds each 16-deep
// slice of the 258 features in shared memory right before the tile product
// consumes it, and adds the bias on the way out.

#include "poly_features.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

__global__ void __launch_bounds__(THREADS)
basis_h1_fwd_kernel(const float* __restrict__ attrT,  // [B'*O, d, E]
                    const float* __restrict__ w1,     // [F, H]
                    const float* __restrict__ b1,     // [H]
                    float* __restrict__ out,          // [B'*O, E, H]
                    int d, int E, int F, int H) {
    __shared__ float s_attr[MAX_D][BM];
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];

    const int e0 = blockIdx.x * BM;
    const int h0 = blockIdx.y * BN;
    const int bo = blockIdx.z;
    const float* attr_bo = attrT + (size_t)bo * d * E;

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    for (int i = tid; i < d * BM; i += THREADS) {
        const int r = i / BM, col = i % BM;
        s_attr[r][col] = e0 + col < E ? attr_bo[(size_t)r * E + e0 + col] : 0.f;
    }
    __syncthreads();

    float acc[TM][TN] = {};
    tile_gemm<false, true>(
        F, [&](int col, int f) { return poly_feature([&](int i) { return s_attr[i][col]; }, f, d); },
        [&](int f, int n) { return h0 + n < H ? w1[(size_t)f * H + h0 + n] : 0.f; }, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int e = e0 + ty * TM + i;
        if (e >= E) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int h = h0 + tx * TN + j;
            if (h < H) out[((size_t)bo * E + e) * H + h] = acc[i][j] + b1[h];
        }
    }
}

}  // namespace

extern "C" int arreau_basis_h1_fwd(const float* attrT, const float* w1, const float* b1,
                                   float* out, int Bp, int O, int d, int E, int F, int H,
                                   void* stream) {
    const dim3 grid((E + BM - 1) / BM, (H + BN - 1) / BN, Bp * O);
    basis_h1_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        attrT, w1, b1, out, d, E, F, H);
    return static_cast<int>(cudaGetLastError());
}
