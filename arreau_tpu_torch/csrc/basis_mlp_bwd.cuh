// The backward of the fused, bias-free edge-basis MLP as five tensor-core
// tile products through device-memory scratch: #6's whole kernel
// (fused_basis_mlp_bwd.cu: one cotangent, the row-major invariants, and dh
// rounded to T before its product with gelu'(h_pre), as the JAX kernel
// rounds it). See fused_basis_mlp_bwd.cu for the design; the steps, for
// every edge row:
//
//   1. h1 = round_T(gelu(h1_pre)), dg1 = round_T(gelu'(h1_pre)) and the
//      invariants (basis_h1.cuh, RESIDUALS), h1_pre = poly @ W1;
//   2. dpre2 = round_T(g * round_T(gelu'(round_T(h1 @ W2))));
//   3. dW2 = h1^T dpre2, split-K over the rows;
//   4. dpre1 = round_T(round_T(dh) * dg1), dh = dpre2 @ W2^T, written over h1;
//   5. dW1 = poly^T dpre1, split-K, the features built from the invariants
//      as each stage is staged;
//   each split-K product's per-split partials added in split order.
#pragma once

#include "basis_h1.cuh"
#include "common.cuh"
#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

// 2. dpre2[row, n] = round_T(g[row, n] * round_T(gelu'(round_T(h1[row, :H] @ W2[:, n]))))
template <class T>
__global__ void __launch_bounds__(WideTile<T, true, false>::THREADS, MIN_BLOCKS)
basis_dpre2_kernel(Operand<T> h1,              // [rows, Hg]
                   Operand<T> w2,              // [H, D]
                   Operand<T> g,               // [rows, D]
                   T* __restrict__ dpre2,      // [rows, D]
                   long long rows, int H, int D, bool out_vec) {
    using P = WideTile<T, true, false>;
    const int n_tiles = (D + P::BN - 1) / P::BN;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = D - n0;
    typename P::Acc acc = {};
    P::run({h1.p + m0 * h1.ld, h1.ld, h1.vec}, {w2.p + n0, w2.ld, w2.vec}, H, m_lim, n_lim,
           shared_buffer<T>(), acc);
    float* s_acc = shared_buffer<float>();
    P::stage_acc(acc, s_acc);
    P::for_each_chunk([&](int m, int n) {
        constexpr int CH = P::CHUNK;
        if (m >= m_lim || n >= n_lim) return;
        const int count = min(CH, n_lim - n);
        const long long at = (m0 + m) * D + n0 + n;
        float v[CH];
        load_chunk(v, g.p + at, count, g.vec);
        const float* a = s_acc + m * P::ACC_LD + n;
#pragma unroll
        for (int j = 0; j < CH; ++j) v[j] *= round_to<T>(gelu_deriv(round_to<T>(a[j])));
        store_chunk(dpre2 + at, v, count, out_vec);
    });
}

// 4. dpre1[row, h] = round_T(round_T(dh) * dg1[row, h]) with dh = dpre2[row, :] @ W2[h, :],
//    into h1's scratch
template <class T>
__global__ void __launch_bounds__(WideTile<T, true, true>::THREADS, MIN_BLOCKS)
basis_dpre1_kernel(Operand<T> dpre2,           // [rows, D]
                   Operand<T> w2,              // [H, D]
                   const T* __restrict__ dg1,  // [rows, Hg]
                   T* __restrict__ dpre1,      // [rows, Hg]
                   long long rows, int H, int D, int Hg) {
    using P = WideTile<T, true, true>;
    const int n_tiles = (H + P::BN - 1) / P::BN;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = H - n0;
    typename P::Acc acc = {};
    P::run({dpre2.p + m0 * dpre2.ld, dpre2.ld, dpre2.vec},
           {w2.p + (long long)n0 * w2.ld, w2.ld, w2.vec}, D, m_lim, n_lim, shared_buffer<T>(),
           acc);
    float* s_acc = shared_buffer<float>();
    P::stage_acc(acc, s_acc);
    P::for_each_chunk([&](int m, int n) {
        constexpr int CH = P::CHUNK;
        if (m >= m_lim || n >= n_lim) return;
        const int count = min(CH, n_lim - n);
        const long long at = (m0 + m) * Hg + n0 + n;  // Hg is a multiple of 8: rows align
        float v[CH];
        load_chunk(v, dg1 + at, count, true);
        const float* a = s_acc + m * P::ACC_LD + n;
#pragma unroll
        for (int j = 0; j < CH; ++j) v[j] *= round_to<T>(a[j]);
        store_chunk(dpre1 + at, v, count, true);
    });
}

// 3. partial[split, m, n] = sum over the split's rows of A[row, m] * B[row, n]
//    with A = h1 ([rows, Hg], M = H) and B = dpre2 ([rows, D]):
//    wide_rows_partial_kernel (tile_product.cuh)

// 5. partial[split, f, h] = sum over the split's rows of poly[row, f] * dpre1[row, h]
//    (M = F): A built into each stage from the stage's rows of invariants
// dW1's block tile: 96 features x 128 hidden units (three tiles hold the
// F = 258 features at 90% where 128-row tiles would hold them at 67%)
template <class T>
using FeatureTile = TileProduct<T, false, false, 2, 4, 3, 4>;

template <class T, int D>
__global__ void __launch_bounds__(FeatureTile<T>::THREADS, MIN_BLOCKS)
basis_dw1_partial_kernel(const T* __restrict__ xr,  // [rows, XR]
                         Operand<T> dpre1,          // [rows, Hg]
                         float* __restrict__ partial, long long rows, int rows_per_split, int d,
                         int F, int H) {
    using P = FeatureTile<T>;
    __shared__ __align__(16) T s_inv[P::STAGES][P::BK][XR];
    const int M = F;
    const int n_tiles = (H + P::BN - 1) / P::BN;
    const int m0 = blockIdx.x / n_tiles * P::BM, n0 = blockIdx.x % n_tiles * P::BN;
    const long long k0 = (long long)blockIdx.y * rows_per_split;
    const int K = (int)min(rows - k0, (long long)rows_per_split);
    const T* split_xr = xr + k0 * XR;
    auto fetch = [&](int slot, int kk) {
        load_tile<T, P::BK, XR, XR, P::THREADS>(&s_inv[slot][0][0], split_xr + (long long)kk * XR,
                                                XR, K - kk, XR, true);
    };
    auto build = [&](T* sa, int slot, int kk) {
        if constexpr (D > 0) {
            // each stage row's BM features in parts of W, one thread each (the
            // part warp-uniform), formed in registers and stored as 16-byte
            // chunks
            constexpr int PER_ROW = P::THREADS / P::BK, W = P::BM / PER_ROW;
            constexpr int F3 = D + D * D + D * D * D;
            const int k = threadIdx.x % P::BK, q = threadIdx.x / P::BK;
            float x[D];  // zero past the split
#pragma unroll
            for (int i = 0; i < D; ++i) x[i] = to_float(s_inv[slot][k][i]);
            T* dst = sa + k * P::LDA + q * W;
            with_part<(F3 + P::BM) / P::BM * PER_ROW>(m0 / W + q, [&](auto p) {
                float v[W];
                poly_features_part<D, W, decltype(p)::value>(x, F, 0.f, v);
#pragma unroll
                for (int j = 0; j < W; j += P::CHUNK) store_chunk(dst + j, v + j, P::CHUNK, true);
            });
        } else {
            // any d: two adjacent columns at a time, their factors decoded
            // each time (off the model's path)
            for (int i = threadIdx.x; i < P::BM / 2 * P::BK; i += P::THREADS) {
                const int mc = i % (P::BM / 2) * 2, k = i / (P::BM / 2), f = m0 + mc;
                const PolyTerm t0 = poly_term(min(f, F - 1), d);
                const PolyTerm t1 = poly_term(min(f + 1, F - 1), d);
                // rows past the split have zero invariants
                const auto inv = [&](int j) { return to_float(s_inv[slot][k][j]); };
                store2(sa + k * P::LDA + mc, f < F ? poly_value(t0, inv) : 0.f,
                       f + 1 < F ? poly_value(t1, inv) : 0.f, true, true);
            }
        }
    };
    typename P::Acc acc = {};
    P::run_built(fetch, build, {dpre1.p + k0 * dpre1.ld + n0, dpre1.ld, dpre1.vec}, K, M - m0,
                 H - n0, shared_buffer<T>(), acc);
    float* out = partial + (size_t)blockIdx.y * M * H + (size_t)m0 * H + n0;
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m0 + m < M && n0 + n < H)
            store2(out + (size_t)m * H + n, v0, v1, n0 + n + 1 < H, H % 2 == 0);
    });
}

template <class T, int D>
cudaError_t launch_dw1(const T* xr, Operand<T> dpre1, float* partial, long long rows,
                       int rows_per_split, int splits, int d, int F, int H, cudaStream_t stream) {
    using P = FeatureTile<T>;
    cudaError_t err = allow_smem(basis_dw1_partial_kernel<T, D>, P::BUILT_SMEM);
    if (err != cudaSuccess) return err;
    basis_dw1_partial_kernel<T, D>
        <<<dim3(((F + P::BM - 1) / P::BM) * ((H + P::BN - 1) / P::BN), splits), P::THREADS,
           P::BUILT_SMEM, stream>>>(xr, dpre1, partial, rows, rows_per_split, d, F, H);
    return cudaGetLastError();
}

// The five products and the two fixed-order sums. dw1 [F, H] and dw2 [H, D]
// (float32). Scratch: h1 and dg1 [rows, Hg] (Hg = H rounded up to 8; h1
// ends as dpre1), dpre2 [rows, D], xr [rows, XR], partial [splits * max(F *
// H, H * D)] float32; g the cotangent [rows, D].
template <class T>
int basis_mlp_bwd(const T* attr, const T* w1, const T* w2, const T* g, T* h1, T* dg1, T* dpre2,
                  T* xr, float* partial, float* dw1, float* dw2, long long rows, int d, int F,
                  int H, int D, int Hg, int splits, int rows_per_split, cudaStream_t stream) {
    cudaError_t err;
    int status = launch_h1<T, H1Out::RESIDUALS>(attr, w1, h1, dg1, xr, rows, d, F, H, Hg, stream);
    if (status != 0) return status;

    using D2 = WideTile<T, true, false>;
    const long long m_tiles = (rows + D2::BM - 1) / D2::BM;
    const size_t d2_smem = D2::staged(D2::SMEM);
    if ((err = allow_smem(basis_dpre2_kernel<T>, d2_smem)) != cudaSuccess)
        return static_cast<int>(err);
    basis_dpre2_kernel<T>
        <<<(unsigned)(m_tiles * ((D + D2::BN - 1) / D2::BN)), D2::THREADS, d2_smem, stream>>>(
            operand<T>(h1, Hg), operand(w2, D), operand(g, D), dpre2, rows, H, D,
            rows_aligned(dpre2, D));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using WG = WideTile<T, false, false>;
    const int m2 = H;
    if ((err = allow_smem(wide_rows_partial_kernel<T>, WG::SMEM)) != cudaSuccess)
        return static_cast<int>(err);
    wide_rows_partial_kernel<T>
        <<<dim3(((m2 + WG::BM - 1) / WG::BM) * ((D + WG::BN - 1) / WG::BN), splits),
           WG::THREADS, WG::SMEM, stream>>>(operand<T>(h1, Hg), operand<T>(dpre2, D), partial,
                                            rows, rows_per_split, m2, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n2 = (long long)m2 * D;
    sum_splits_kernel<<<sum_splits_blocks(n2), THREADS, 0, stream>>>(partial, dw2, splits, n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using D1 = WideTile<T, true, true>;
    const size_t d1_smem = D1::staged(D1::SMEM);
    if ((err = allow_smem(basis_dpre1_kernel<T>, d1_smem)) != cudaSuccess)
        return static_cast<int>(err);
    basis_dpre1_kernel<T>
        <<<(unsigned)(m_tiles * ((H + D1::BN - 1) / D1::BN)), D1::THREADS, d1_smem, stream>>>(
            operand<T>(dpre2, D), operand(w2, D), dg1, h1, rows, H, D, Hg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // with the model's d at compile time or any d
    err = d == MODEL_D ? launch_dw1<T, MODEL_D>(xr, operand<T>(h1, Hg), partial, rows,
                                                rows_per_split, splits, d, F, H, stream)
                       : launch_dw1<T, 0>(xr, operand<T>(h1, Hg), partial, rows, rows_per_split,
                                          splits, d, F, H, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n1 = (long long)F * H;
    sum_splits_kernel<<<sum_splits_blocks(n1), THREADS, 0, stream>>>(partial, dw1, splits, n1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
