// Edge-basis MLP, backward of all its consumers at once, float32 or bfloat16,
// for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_multi_bwd_kernel
// (the VJP of basis_mlp_multi, reached through _multi_bwd). The forward is
// basis = gelu(gelu(poly(attr) @ W1 + b1) @ W2 + b2), consumed by n_g conv
// layers; with g_i their cotangents, for every edge row:
//
//   h1_pre = poly @ W1 + b1,  h2_pre = gelu(h1_pre) @ W2 + b2
//   dpre2  = (g_0 + ... + g_{n_g-1}) * gelu'(h2_pre)
//   dpre1  = (dpre2 @ W2^T) * gelu'(h1_pre)
//   dW2 = sum_rows gelu(h1_pre)^T dpre2,  db2 = sum_rows dpre2
//   dW1 = sum_rows poly^T dpre1,          db1 = sum_rows dpre1
//
// GELU is the tanh approximation, value and derivative from one tanh. The
// attribute cotangent is not computed: attributes derive from positions and
// the lattice, which the training path does not differentiate.
//
// Bound on the H100: 2*rows*(2*F*H + 3*H*D) float32 operations (269 GFLOP at
// the training shape, rows = B'*O*E = 524288, F=258, H=200, D=256) against
// ~2.7 GB of cotangent reads, so float32 arithmetic bounds it. On the TPU one
// grid step held a (b', o) block's whole chain in VMEM and carried the four
// weight gradients across the sequential grid. A Hopper block has no such
// room and blocks run in no order, so the chain runs as SIMT tile products
// through device-memory scratch (h1_pre, dpre2: ~1 GB at the training
// shape, a fraction of a millisecond of traffic against the arithmetic):
//
//   1. h1_pre by the forward's own kernel (csrc/basis_h1.cu), which builds
//      the polynomial features in shared memory; poly never reaches memory.
//   2. dpre2: the product gelu(h1_pre) @ W2 with GELU applied as A is
//      staged; the epilogue reads each of the n_g cotangents once and sums
//      them in registers (the sum of the cotangents is never stored).
//   3. dW2|db2: split-K over the rows; A is [gelu(h1_pre) | 1], so the
//      bias gradient is the extra row of the same product.
//   4. dpre1: dpre2 @ W2^T times gelu'(h1_pre), written over h1_pre in
//      place (each element is read and written by the same thread).
//   5. dW1|db1: split-K with A = [poly | 1], the features rebuilt from the
//      invariants as A is staged.
//   Each split-K product ends in a second pass that adds the per-split
//   partial tiles in a fixed order (deterministic).
//
// Element type T (dtype.cuh) of the invariants, weights, biases, cotangents
// and the h1_pre / dpre2 scratch: float32, or bfloat16 on the
// compute_dtype="bfloat16" path, with the JAX kernel's rounding points
// (pallas_basis.py:289-331): h1_pre and h2_pre are rounded to T, as are
// gelu(h1_pre), gelu'(h1_pre) and gelu'(h2_pre) (the JAX kernel evaluates
// them in T); the cotangents are summed in float32; dpre2 and dpre1 are
// rounded to T before their products; the weight and bias gradients are
// float32 sums.

#include <type_traits>

#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_gemm.cuh"

extern "C" int arreau_basis_h1_fwd(const void* attrT, const void* w1, const void* b1, void* out,
                                   int Bp, int O, int d, int E, int F, int H, int is_bf16,
                                   void* stream);

namespace {

using namespace arreau;

constexpr int MAX_G = 16;  // cotangents (consuming layers) one launch sums

template <class T>
struct Cotangents {
    const T* g[MAX_G];
    int n;
};

// 2. dpre2[row, n] = (sum_i g_i[row, n]) * gelu'(gelu(h1_pre[row, :]) @ W2[:, n] + b2[n])
template <class T>
__global__ void __launch_bounds__(THREADS)
dpre2_kernel(const T* __restrict__ h1_pre,  // [rows, H]
             const T* __restrict__ w2,      // [H, D]
             const T* __restrict__ b2,      // [D]
             Cotangents<T> gs,              // n x [rows, D]
             T* __restrict__ dpre2,         // [rows, D]
             long long rows, int H, int D) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    float acc[TM][TN] = {};
    tile_gemm<true, true>(
        H,
        [&](int r, int k) {
            return row0 + r < rows ? round_to<T>(gelu(to_float(h1_pre[(size_t)(row0 + r) * H + k])))
                                   : 0.f;
        },
        [&](int k, int n) { return n0 + n < D ? to_float(w2[(size_t)k * D + n0 + n]) : 0.f; }, As,
        Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx * TN + j;
            if (n >= D) continue;
            const size_t at = (size_t)row * D + n;
            float g = to_float(gs.g[0][at]);
            for (int q = 1; q < gs.n; ++q) g += to_float(gs.g[q][at]);
            const float h2_pre = round_to<T>(acc[i][j] + to_float(b2[n]));
            dpre2[at] = from_float<T>(g * round_to<T>(gelu_deriv(h2_pre)));
        }
    }
}

// 4. dpre1[row, h] = (dpre2[row, :] @ W2[h, :]) * gelu'(h1_pre[row, h]), in place over h1_pre
template <class T>
__global__ void __launch_bounds__(THREADS)
dpre1_kernel(const T* __restrict__ dpre2,  // [rows, D]
             const T* __restrict__ w2,     // [H, D]
             T* h1_pre_dpre1,              // [rows, H]: h1_pre in, dpre1 out
             long long rows, int H, int D) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int h0 = blockIdx.y * BN;

    float acc[TM][TN] = {};
    tile_gemm<true, false>(
        D,
        [&](int r, int k) {
            return row0 + r < rows ? to_float(dpre2[(size_t)(row0 + r) * D + k]) : 0.f;
        },
        [&](int k, int n) { return h0 + n < H ? to_float(w2[(size_t)(h0 + n) * D + k]) : 0.f; },
        As, Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int h = h0 + tx * TN + j;
            if (h >= H) continue;
            const size_t at = (size_t)row * H + h;
            h1_pre_dpre1[at] =
                from_float<T>(acc[i][j] * round_to<T>(gelu_deriv(to_float(h1_pre_dpre1[at]))));
        }
    }
}

// Features of a row for the weight gradients: gelu(h1_pre) (for dW2) ...
template <class T>
struct HiddenFeature {
    const T* h1_pre;  // [rows, H]
    int H;
    __device__ __forceinline__ float operator()(long long row, int m) const {
        return round_to<T>(gelu(to_float(h1_pre[(size_t)row * H + m])));
    }
};

// ... and the polynomial features of the row's invariants (for dW1).
template <class T>
struct PolyFeature {
    const T* attrT;  // [B'*O, d, E]
    int d, E;
    __device__ __forceinline__ float operator()(long long row, int f) const {
        const long long bo = row / E;
        const T* a = attrT + (size_t)bo * d * E + (row - bo * E);
        return round_to<T>(poly_feature([&](int i) { return to_float(a[(size_t)i * E]); }, f, d));
    }
};

template <class T>
int basis_mlp_bwd(const T* attrT, const T* w1, const T* b1, const T* w2, const T* b2,
                  const void* const* gs, int n_g, T* h1_pre, T* dpre2, float* partial,
                  float* dw1_ext, float* dw2_ext, int Bp, int O, int d, int E, int F, int H,
                  int D, int splits, int rows_per_split, cudaStream_t stream) {
    const long long rows = (long long)Bp * O * E;
    const unsigned row_tiles = static_cast<unsigned>((rows + BM - 1) / BM);
    int status;

    status = arreau_basis_h1_fwd(attrT, w1, b1, h1_pre, Bp, O, d, E, F, H,
                                 std::is_same<T, bf16>::value, stream);
    if (status != 0) return status;

    Cotangents<T> cots{};
    for (int i = 0; i < n_g; ++i) cots.g[i] = static_cast<const T*>(gs[i]);
    cots.n = n_g;
    dpre2_kernel<T><<<dim3(row_tiles, (D + BN - 1) / BN), THREADS, 0, stream>>>(
        h1_pre, w2, b2, cots, dpre2, rows, H, D);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    weight_grad_partial_kernel<<<dim3((H + 1 + BM - 1) / BM, (D + BN - 1) / BN, splits), THREADS,
                                 0, stream>>>(HiddenFeature<T>{h1_pre, H}, dpre2, partial, rows, H,
                                              D, rows_per_split);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;
    const long long n2 = (long long)(H + 1) * D;
    sum_splits_kernel<<<sum_splits_blocks(n2), THREADS, 0, stream>>>(partial, dw2_ext, splits, n2);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    dpre1_kernel<T><<<dim3(row_tiles, (H + BN - 1) / BN), THREADS, 0, stream>>>(dpre2, w2, h1_pre,
                                                                                 rows, H, D);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    weight_grad_partial_kernel<<<dim3((F + 1 + BM - 1) / BM, (H + BN - 1) / BN, splits), THREADS,
                                 0, stream>>>(PolyFeature<T>{attrT, d, E}, h1_pre, partial, rows,
                                              F, H, rows_per_split);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;
    const long long n1 = (long long)(F + 1) * H;
    sum_splits_kernel<<<sum_splits_blocks(n1), THREADS, 0, stream>>>(partial, dw1_ext, splits, n1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw1_ext [F+1, H] = [dW1; db1], dw2_ext [H+1, D] = [dW2; db2] (float32).
// Scratch: h1_pre [rows, H] (ends as dpre1), dpre2 [rows, D], partial
// [splits * max((F+1)*H, (H+1)*D)] float32. gs is a host array of n_g
// device pointers. attrT, the weights, biases, cotangents and the h1_pre /
// dpre2 scratch are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
extern "C" int arreau_basis_mlp_bwd(const void* attrT, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* const* gs,
                                    int n_g, void* h1_pre, void* dpre2, float* partial,
                                    float* dw1_ext, float* dw2_ext, int Bp, int O, int d, int E,
                                    int F, int H, int D, int splits, int rows_per_split,
                                    int is_bf16, void* stream_ptr) {
    if (n_g < 1 || n_g > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = basis_mlp_bwd<T>(
            static_cast<const T*>(attrT), static_cast<const T*>(w1), static_cast<const T*>(b1),
            static_cast<const T*>(w2), static_cast<const T*>(b2), gs, n_g,
            static_cast<T*>(h1_pre), static_cast<T*>(dpre2), partial, dw1_ext, dw2_ext, Bp, O, d,
            E, F, H, D, splits, rows_per_split, stream);
    });
    return status;
}
