// Fused bias-free edge-basis MLP, backward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_bwd_kernel (called
// by _bwd, the VJP of fused_basis_mlp). With the forward of
// fused_basis_mlp.cu and g the cotangent of the basis, for every edge row
// (the steps of pallas_basis.py:119-143):
//
//   h_pre  = round_T(poly @ W1),        h = round_T(gelu(h_pre))
//   b_pre  = round_T(h @ W2)
//   db_pre = round_T(round_T(g) * round_T(gelu'(b_pre)))
//   dW2   += h^T db_pre
//   dh     = round_T(db_pre @ W2^T)
//   dh_pre = round_T(dh * round_T(gelu'(h_pre)))
//   dW1   += poly^T dh_pre
//
// The attribute cotangent is not computed: attributes derive from positions
// and the lattice, which the training path does not differentiate (the JAX
// VJP returns zeros for it, and so does the port's autograd Function).
//
// Bound on the H100: 2*rows*(2*F*H + 3*H*D) operations (the recomputed
// forward, dW2, dh and dW1: 269 GFLOP at the training shape, rows = 524288,
// F=258, H=200, D=256) against the cotangent read (537 MB float32), so
// arithmetic bounds it (4.0 ms at the float32 SIMT rate, 0.27 ms at the bf16
// tensor-core rate).
//
// Design. The TPU kernel carried per-b' weight-gradient partials across the
// sequential o axis in VMEM. Hopper's blocks run in no order, so, as in
// basis_mlp_bwd.cu (#7), the chain runs as SIMT tile products through
// device-memory scratch in T (h_pre [rows, H], db_pre [rows, D]):
//
//   1. h_pre: the first layer, with the features built in shared memory as
//      A is staged (the features never reach device memory);
//   2. db_pre: gelu(h_pre) @ W2 with GELU applied as A is staged, the
//      cotangent read once in the epilogue;
//   3. dW2: split-K over the rows, A = gelu(h_pre) rebuilt as it is staged;
//   4. dh_pre: db_pre @ W2^T times gelu'(h_pre), written over h_pre in place
//      (each element is read and written by the same thread);
//   5. dW1: split-K with A = poly, rebuilt from the invariants as staged.
//   Each split-K product writes per-split float32 partial tiles, and a
//   second pass adds them in a fixed order: no atomics, the same result on
//   every call. (The shared split-K kernel also forms a bias row, the sum of
//   the cotangent over the rows; this kernel has no bias and drops it.)
//
// Element type T (dtype.cuh) of attr, W1, W2, g and the scratch: float32, or
// bfloat16 under BasisMLP's bfloat16 compute type, with the rounding points
// above (pallas_basis.py:129-143); GELU and its derivative are evaluated in
// float32 from the rounded value and rounded once (the JAX kernel evaluates
// them in T step by step); the weight gradients are float32 sums.

#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

// 1. h_pre[row, h] = round_T(poly(attr[row, :]) @ W1[:, h])
template <class T>
__global__ void __launch_bounds__(THREADS)
h_pre_kernel(const T* __restrict__ attr,  // [rows, d]
             const T* __restrict__ w1,    // [F, H]
             T* __restrict__ h_pre,       // [rows, H]
             long long rows, int d, int F, int H) {
    __shared__ float s_attr[MAX_D][BM];
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int h0 = blockIdx.y * BN;
    const int tid = threadIdx.x;

    for (int i = tid; i < BM * d; i += THREADS) {
        const int r = i / d, j = i % d;
        s_attr[j][r] = row0 + r < rows ? to_float(attr[(size_t)row0 * d + i]) : 0.f;
    }
    __syncthreads();

    float acc[TM][TN] = {};
    tile_gemm<false, true>(
        F,
        [&](int r, int f) {
            return round_to<T>(poly_feature([&](int i) { return s_attr[i][r]; }, f, d));
        },
        [&](int f, int n) { return h0 + n < H ? to_float(w1[(size_t)f * H + h0 + n]) : 0.f; }, As,
        Bs, acc);

    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int h = h0 + tx * TN + j;
            if (h < H) h_pre[(size_t)row * H + h] = from_float<T>(acc[i][j]);
        }
    }
}

// 2. db_pre[row, n] = round_T(g[row, n] * round_T(gelu'(round_T(h[row, :] @ W2[:, n]))))
template <class T>
__global__ void __launch_bounds__(THREADS)
db_pre_kernel(const T* __restrict__ h_pre,  // [rows, H]
              const T* __restrict__ w2,     // [H, D]
              const T* __restrict__ g,      // [rows, D]
              T* __restrict__ db_pre,       // [rows, D]
              long long rows, int H, int D) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    float acc[TM][TN] = {};
    tile_gemm<true, true>(
        H,
        [&](int r, int k) {
            return row0 + r < rows ? round_to<T>(gelu(to_float(h_pre[(size_t)(row0 + r) * H + k])))
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
            const float b_pre = round_to<T>(acc[i][j]);
            db_pre[at] = from_float<T>(to_float(g[at]) * round_to<T>(gelu_deriv(b_pre)));
        }
    }
}

// 4. dh_pre[row, h] = round_T(round_T(db_pre[row, :] @ W2[h, :]) * round_T(gelu'(h_pre[row, h]))),
//    in place over h_pre
template <class T>
__global__ void __launch_bounds__(THREADS)
dh_pre_kernel(const T* __restrict__ db_pre,  // [rows, D]
              const T* __restrict__ w2,      // [H, D]
              T* h_pre_dh_pre,               // [rows, H]: h_pre in, dh_pre out
              long long rows, int H, int D) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int h0 = blockIdx.y * BN;

    float acc[TM][TN] = {};
    tile_gemm<true, false>(
        D,
        [&](int r, int k) {
            return row0 + r < rows ? to_float(db_pre[(size_t)(row0 + r) * D + k]) : 0.f;
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
            const float dg1 = round_to<T>(gelu_deriv(to_float(h_pre_dh_pre[at])));
            h_pre_dh_pre[at] = from_float<T>(round_to<T>(acc[i][j]) * dg1);
        }
    }
}

// Features of a row for the weight gradients: h = round_T(gelu(h_pre)) (for dW2) ...
template <class T>
struct HiddenFeature {
    const T* h_pre;  // [rows, H]
    int H;
    __device__ __forceinline__ float operator()(long long row, int m) const {
        return round_to<T>(gelu(to_float(h_pre[(size_t)row * H + m])));
    }
};

// ... and the polynomial features of the row's invariants (for dW1).
template <class T>
struct PolyFeature {
    const T* attr;  // [rows, d]
    int d;
    __device__ __forceinline__ float operator()(long long row, int f) const {
        const T* a = attr + (size_t)row * d;
        return round_to<T>(poly_feature([&](int i) { return to_float(a[i]); }, f, d));
    }
};

template <class T>
int fused_basis_mlp_bwd(const T* attr, const T* w1, const T* w2, const T* g, T* h_pre,
                        T* db_pre, float* partial, float* dw1_ext, float* dw2_ext, long long rows,
                        int d, int F, int H, int D, int splits, int rows_per_split,
                        cudaStream_t stream) {
    const unsigned row_tiles = static_cast<unsigned>((rows + BM - 1) / BM);
    int status;

    h_pre_kernel<T><<<dim3(row_tiles, (H + BN - 1) / BN), THREADS, 0, stream>>>(attr, w1, h_pre,
                                                                                  rows, d, F, H);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    db_pre_kernel<T><<<dim3(row_tiles, (D + BN - 1) / BN), THREADS, 0, stream>>>(h_pre, w2, g,
                                                                                   db_pre, rows,
                                                                                   H, D);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    weight_grad_partial_kernel<<<dim3((H + 1 + BM - 1) / BM, (D + BN - 1) / BN, splits), THREADS,
                                 0, stream>>>(HiddenFeature<T>{h_pre, H}, db_pre, partial, rows, H,
                                              D, rows_per_split);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;
    const long long n2 = (long long)(H + 1) * D;
    sum_splits_kernel<<<sum_splits_blocks(n2), THREADS, 0, stream>>>(partial, dw2_ext, splits, n2);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    dh_pre_kernel<T><<<dim3(row_tiles, (H + BN - 1) / BN), THREADS, 0, stream>>>(db_pre, w2,
                                                                                   h_pre, rows, H,
                                                                                   D);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;

    weight_grad_partial_kernel<<<dim3((F + 1 + BM - 1) / BM, (H + BN - 1) / BN, splits), THREADS,
                                 0, stream>>>(PolyFeature<T>{attr, d}, h_pre, partial, rows, F, H,
                                              rows_per_split);
    if ((status = static_cast<int>(cudaGetLastError())) != 0) return status;
    const long long n1 = (long long)(F + 1) * H;
    sum_splits_kernel<<<sum_splits_blocks(n1), THREADS, 0, stream>>>(partial, dw1_ext, splits, n1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw1_ext [F+1, H] and dw2_ext [H+1, D] (float32): dW1 and dW2 in their first
// F and H rows (the last row is the cotangent's column sum, unused). Scratch:
// h_pre [rows, H] (ends as dh_pre), db_pre [rows, D], partial [splits *
// max((F+1)*H, (H+1)*D)] float32. attr [B', O, E, d], w1, w2, g [B', O, E, D]
// and the h_pre / db_pre scratch are float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).
extern "C" int arreau_fused_basis_mlp_bwd(const void* attr, const void* w1, const void* w2,
                                          const void* g, void* h_pre, void* db_pre,
                                          float* partial, float* dw1_ext, float* dw2_ext, int Bp,
                                          int O, int E, int d, int F, int H, int D, int splits,
                                          int rows_per_split, int is_bf16, void* stream_ptr) {
    if (d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long rows = (long long)Bp * O * E;
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = fused_basis_mlp_bwd<T>(
            static_cast<const T*>(attr), static_cast<const T*>(w1), static_cast<const T*>(w2),
            static_cast<const T*>(g), static_cast<T*>(h_pre), static_cast<T*>(db_pre), partial,
            dw1_ext, dw2_ext, rows, d, F, H, D, splits, rows_per_split, stream);
    });
    return status;
}
