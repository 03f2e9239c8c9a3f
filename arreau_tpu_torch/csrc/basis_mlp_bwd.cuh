// The backward of the edge-basis MLP as five tensor-core tile products
// through device-memory scratch: #7's whole kernel in float32
// (basis_mlp_bwd.cu, with biases and n_g cotangents; in bfloat16:
// basis_sm90.cuh) and #6's (fused_basis_mlp_bwd.cu, FUSED: no
// biases, one cotangent, the row-major invariants, and dh rounded to T
// before its product with gelu'(h_pre), as the JAX kernel rounds it). See
// basis_mlp_bwd.cu for the design; the steps, for every edge row:
//
//   1. h1 = round_T(gelu(h1_pre)), dg1 = round_T(gelu'(h1_pre)) and the
//      invariants (basis_h1.cuh, RESIDUALS), h1_pre = poly @ W1 (+ b1);
//   2. dpre2 = round_T(g * round_T(gelu'(round_T(h1 @ W2 (+ b2))))),
//      g the sum of the cotangents, each read once;
//   3. dW2 (| db2) = [h1 (| 1)]^T dpre2, split-K over the rows;
//   4. dpre1 = round_T(dh * dg1), dh = dpre2 @ W2^T (FUSED: round_T(dh)),
//      written over h1;
//   5. dW1 (| db1) = [poly (| 1)]^T dpre1, split-K, the features built from
//      the invariants as each stage is staged;
//   each split-K product's per-split partials added in split order.
#pragma once

#include "basis_h1.cuh"
#include "common.cuh"
#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

constexpr int MAX_G = 16;  // cotangents (consuming layers) one launch sums

template <class T>
struct Cotangents {
    const T* g[MAX_G];
    int n;
    bool vec;  // every g_i's rows are 16-byte aligned
};

// 2. dpre2[row, n] = round_T(sum_i g_i[row, n]
//                             * round_T(gelu'(round_T(h1[row, :H] @ W2[:, n] + b2[n]))))
//    (FUSED: no b2)
template <class T, bool FUSED>
__global__ void __launch_bounds__(WideTile<T, true, false>::THREADS, MIN_BLOCKS)
basis_dpre2_kernel(Operand<T> h1,              // [rows, Hg]
                   Operand<T> w2,              // [H, D]
                   const T* __restrict__ b2,   // [D] (unless FUSED)
                   Cotangents<T> gs,           // n x [rows, D]
                   T* __restrict__ dpre2,      // [rows, D]
                   long long rows, int H, int D, bool b2_vec, bool out_vec) {
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
        // the cotangents summed in order, loaded G_BATCH at a time (32 floats
        // of registers) so that their loads are in flight together
        constexpr int G_BATCH = 32 / CH;
        float g[CH], b[CH];
        for (int q0 = 0; q0 < gs.n; q0 += G_BATCH) {
            float gq[G_BATCH][CH];
#pragma unroll
            for (int u = 0; u < G_BATCH; ++u)
                if (q0 + u < gs.n) load_chunk(gq[u], gs.g[q0 + u] + at, count, gs.vec);
#pragma unroll
            for (int u = 0; u < G_BATCH; ++u)
                if (q0 + u < gs.n)
#pragma unroll
                    for (int j = 0; j < CH; ++j) g[j] = q0 + u == 0 ? gq[u][j] : g[j] + gq[u][j];
        }
        const float* a = s_acc + m * P::ACC_LD + n;
        if constexpr (FUSED) {
#pragma unroll
            for (int j = 0; j < CH; ++j) g[j] *= round_to<T>(gelu_deriv(round_to<T>(a[j])));
        } else {
            load_chunk(b, b2 + n0 + n, count, b2_vec);
#pragma unroll
            for (int j = 0; j < CH; ++j) g[j] *= round_to<T>(gelu_deriv(round_to<T>(a[j] + b[j])));
        }
        store_chunk(dpre2 + at, g, count, out_vec);
    });
}

// 4. dpre1[row, h] = round_T(dh * dg1[row, h]) with dh = dpre2[row, :] @ W2[h, :]
//    (FUSED: round_T(dh)), into h1's scratch
template <class T, bool FUSED>
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
        for (int j = 0; j < CH; ++j) v[j] *= FUSED ? round_to<T>(a[j]) : a[j];
        store_chunk(dpre1 + at, v, count, true);
    });
}

// 3. partial[split, m, n] = sum over the split's rows of A[row, m] * B[row, n]
//    with A = [h1 | 1] ([rows, Hg], M = H + 1; FUSED: h1, M = H) and B =
//    dpre2 ([rows, D])
template <class T>
__global__ void __launch_bounds__(WideTile<T, false, false>::THREADS, MIN_BLOCKS)
basis_dw2_partial_kernel(Operand<T> a, Operand<T> b, float* __restrict__ partial,
                         long long rows, int rows_per_split, int M, int N) {
    using P = WideTile<T, false, false>;
    const int n_tiles = (N + P::BN - 1) / P::BN;
    const int m0 = blockIdx.x / n_tiles * P::BM, n0 = blockIdx.x % n_tiles * P::BN;
    const long long k0 = (long long)blockIdx.y * rows_per_split;
    const int K = (int)min(rows - k0, (long long)rows_per_split);
    typename P::Acc acc = {};
    P::run({a.p + k0 * a.ld + m0, a.ld, a.vec}, {b.p + k0 * b.ld + n0, b.ld, b.vec}, K, M - m0,
           N - n0, shared_buffer<T>(), acc);
    float* out = partial + (size_t)blockIdx.y * M * N + (size_t)m0 * N + n0;
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m0 + m < M && n0 + n < N)
            store2(out + (size_t)m * N + n, v0, v1, n0 + n + 1 < N, N % 2 == 0);
    });
}

// 5. partial[split, f, h] = sum over the split's rows of [poly | 1][row, f] * dpre1[row, h]
//    (M = F + 1; FUSED: poly, M = F, the ones row F outside M): A built into
//    each stage from the stage's rows of invariants
// dW1's block tile: 96 features x 128 hidden units (three tiles hold the
// F + 1 = 259 features at 90% where 128-row tiles would hold them at 67%)
template <class T>
using FeatureTile = TileProduct<T, false, false, 2, 4, 3, 4>;

template <class T, int D, bool FUSED>
__global__ void __launch_bounds__(FeatureTile<T>::THREADS, MIN_BLOCKS)
basis_dw1_partial_kernel(const T* __restrict__ xr,  // [rows, XR]
                         Operand<T> dpre1,          // [rows, Hg]
                         float* __restrict__ partial, long long rows, int rows_per_split, int d,
                         int F, int H) {
    using P = FeatureTile<T>;
    __shared__ __align__(16) T s_inv[P::STAGES][P::BK][XR];
    const int M = FUSED ? F : F + 1;
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
            const float one = k < K - kk ? 1.f : 0.f;
            T* dst = sa + k * P::LDA + q * W;
            with_part<(F3 + P::BM) / P::BM * PER_ROW>(m0 / W + q, [&](auto p) {
                float v[W];
                poly_features_part<D, W, decltype(p)::value>(x, F, one, v);
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
                // rows past the split have zero invariants, and no ones
                const auto inv = [&](int j) { return to_float(s_inv[slot][k][j]); };
                const float one = k < K - kk ? 1.f : 0.f;
                store2(sa + k * P::LDA + mc, f < F ? poly_value(t0, inv) : f == F ? one : 0.f,
                       f + 1 < F ? poly_value(t1, inv) : f + 1 == F ? one : 0.f, true, true);
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

template <class T, int D, bool FUSED>
cudaError_t launch_dw1(const T* xr, Operand<T> dpre1, float* partial, long long rows,
                       int rows_per_split, int splits, int d, int F, int H, cudaStream_t stream) {
    using P = FeatureTile<T>;
    cudaError_t err = allow_smem(basis_dw1_partial_kernel<T, D, FUSED>, P::BUILT_SMEM);
    if (err != cudaSuccess) return err;
    const int M = FUSED ? F : F + 1;
    basis_dw1_partial_kernel<T, D, FUSED>
        <<<dim3(((M + P::BM - 1) / P::BM) * ((H + P::BN - 1) / P::BN), splits), P::THREADS,
           P::BUILT_SMEM, stream>>>(xr, dpre1, partial, rows, rows_per_split, d, F, H);
    return cudaGetLastError();
}

// The five products and the two fixed-order sums. dw1 [F (+1), H] and dw2
// [H (+1), D] (float32; the bias rows unless FUSED). Scratch: h1 and dg1
// [rows, Hg] (Hg = H (+1) rounded up to 8; h1 ends as dpre1), dpre2 [rows,
// D], xr [rows, XR], partial [splits * max(rows of dw1 * H, rows of dw2 *
// D)] float32. gs holds n_g device pointers. FUSED: b1 and b2 are unused.
template <class T, bool FUSED>
int basis_mlp_bwd(const T* attr, const T* w1, const T* b1, const T* w2, const T* b2,
                  const void* const* gs, int n_g, T* h1, T* dg1, T* dpre2, T* xr, float* partial,
                  float* dw1, float* dw2, int Bp, int O, int d, int E, int F, int H, int D, int Hg,
                  int splits, int rows_per_split, cudaStream_t stream) {
    const long long rows = (long long)Bp * O * E;
    constexpr int BIAS_ROWS = FUSED ? 0 : 1;  // the ones column of each weight gradient
    cudaError_t err;
    int status = launch_h1<T, H1Out::RESIDUALS, FUSED>(attr, w1, b1, h1, dg1, xr, rows, d, E, F,
                                                        H, Hg, stream);
    if (status != 0) return status;

    Cotangents<T> cots{};
    cots.vec = true;
    for (int i = 0; i < n_g; ++i) {
        cots.g[i] = static_cast<const T*>(gs[i]);
        cots.vec &= rows_aligned(cots.g[i], D);
    }
    cots.n = n_g;
    using D2 = WideTile<T, true, false>;
    const long long m_tiles = (rows + D2::BM - 1) / D2::BM;
    const size_t d2_smem = D2::staged(D2::SMEM);
    if ((err = allow_smem(basis_dpre2_kernel<T, FUSED>, d2_smem)) != cudaSuccess)
        return static_cast<int>(err);
    basis_dpre2_kernel<T, FUSED>
        <<<(unsigned)(m_tiles * ((D + D2::BN - 1) / D2::BN)), D2::THREADS, d2_smem, stream>>>(
            operand<T>(h1, Hg), operand(w2, D), b2, cots, dpre2, rows, H, D, rows_aligned(b2, 0),
            rows_aligned(dpre2, D));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using WG = WideTile<T, false, false>;
    const int m2 = H + BIAS_ROWS;
    if ((err = allow_smem(basis_dw2_partial_kernel<T>, WG::SMEM)) != cudaSuccess)
        return static_cast<int>(err);
    basis_dw2_partial_kernel<T>
        <<<dim3(((m2 + WG::BM - 1) / WG::BM) * ((D + WG::BN - 1) / WG::BN), splits),
           WG::THREADS, WG::SMEM, stream>>>(operand<T>(h1, Hg), operand<T>(dpre2, D), partial,
                                            rows, rows_per_split, m2, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n2 = (long long)m2 * D;
    sum_splits_kernel<<<sum_splits_blocks(n2), THREADS, 0, stream>>>(partial, dw2, splits, n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using D1 = WideTile<T, true, true>;
    const size_t d1_smem = D1::staged(D1::SMEM);
    if ((err = allow_smem(basis_dpre1_kernel<T, FUSED>, d1_smem)) != cudaSuccess)
        return static_cast<int>(err);
    basis_dpre1_kernel<T, FUSED>
        <<<(unsigned)(m_tiles * ((H + D1::BN - 1) / D1::BN)), D1::THREADS, d1_smem, stream>>>(
            operand<T>(dpre2, D), operand(w2, D), dg1, h1, rows, H, D, Hg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // with the model's d at compile time or any d
    err = d == MODEL_D ? launch_dw1<T, MODEL_D, FUSED>(xr, operand<T>(h1, Hg), partial, rows,
                                                       rows_per_split, splits, d, F, H, stream)
                       : launch_dw1<T, 0, FUSED>(xr, operand<T>(h1, Hg), partial, rows,
                                                 rows_per_split, splits, d, F, H, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n1 = (long long)(F + BIAS_ROWS) * H;
    sum_splits_kernel<<<sum_splits_blocks(n1), THREADS, 0, stream>>>(partial, dw1, splits, n1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
