// The first layer of the fused, bias-free edge-basis MLP as one tensor-core
// tile product, poly(attr) @ W1, with the polynomial features built in
// shared memory: the first product of #5 and #6 (fused_basis_mlp.cu,
// fused_basis_mlp_bwd.cu), which differ in their epilogue (H1Out); both read
// the row-major attr [B'*O*E, d]. (#8 and #7, with biases and the lane-major
// attrT, run on wgmma: basis_sm90.cuh, basis_f32_sm90.cuh.)
//
// A block owns 128 edge rows x 128 hidden units (WideTile: 8 warps of
// mma.sync, tile_product.cuh). It stages its rows' d invariants in shared
// memory once; then, for each 64-deep (bfloat16) or 32-deep (float32)
// K-stage of the F features, the block's threads form the stage's A tile,
// rounded to T, while the tensor cores work on the stage before and W1's
// slices arrive by cp.async (run_built): with the model's d = 6 each thread
// forms half a row's stage from that row's invariants in registers (the
// factors fixed at compile time, poly_features_part) and stores it as
// 16-byte chunks; with any other d each thread forms two adjacent feature
// columns, their factors decoded once a stage (poly_term). The [rows, F] feature tensor never
// reaches device memory: at the training shape writing and reading it would
// cost about as much as the bfloat16 product itself. The epilogue stages
// the accumulators in shared memory and writes 16-byte row chunks.
#pragma once

#include "common.cuh"
#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_product.cuh"

namespace arreau {

template <class T>
using H1Tile = WideTile<T, true, false>;  // A = features [rows][F], B = W1 [F][H]

constexpr int XR = MAX_D;  // row stride of the backwards' invariant rows (16-byte aligned in T)

// What basis_h1_kernel's epilogue writes, with p = round_T(h1_pre)
enum class H1Out {
    RESIDUALS,  // #6: h1, gelu'(p) and the invariants for the backward (below)
    HIDDEN,     // #5: out [rows, ld] = [round_T(gelu(p)) | 0 ...]
};

}  // namespace arreau

namespace {

using namespace arreau;

// h1_pre = poly(attr) @ W1; out and the rest as OUT says, with p =
// round_T(h1_pre):
//   RESIDUALS (#6):
//     out [rows, ld] = [round_T(gelu(p)) | 0 ...] (h1, zero to the row's
//       16-byte aligned end ld),
//     dg1 [rows, ld] = [round_T(gelu'(p)) | 0 ...],
//     xr [rows, XR]  = the row's d invariants, zero-padded (the dW1 product
//       builds the features from them, a K-stage of rows at a time).
//   HIDDEN (#5): out [rows, ld] = [round_T(gelu(p)) | 0 ...].
template <class T, H1Out OUT, int D>
__global__ void __launch_bounds__(H1Tile<T>::THREADS, MIN_BLOCKS)
basis_h1_kernel(const T* __restrict__ attr,  // [rows, d]
                Operand<T> w1,               // [F, H]
                T* __restrict__ out, T* __restrict__ dg1, T* __restrict__ xr, long long rows,
                int d, int F, int H, int ld, bool out_vec) {
    using P = H1Tile<T>;
    constexpr bool RESIDUALS = OUT == H1Out::RESIDUALS;
    __shared__ float s_x[P::BM][MAX_D + 1];  // odd row stride: no bank conflicts
    const int n_tiles = (ld + P::BN - 1) / P::BN;  // the columns the epilogue writes
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = H - n0;

    for (int i = threadIdx.x; i < P::BM * d; i += P::THREADS) {
        const int m = i / d, j = i % d;  // neighbouring threads on neighbouring addresses
        s_x[m][j] = m < m_lim ? to_float(attr[(m0 + m) * d + j]) : 0.f;
    }
    if constexpr (RESIDUALS) {
        if (n0 == 0)
            for (int i = threadIdx.x; i < m_lim * XR; i += P::THREADS) {
                const int m = i / XR, j = i % XR;
                const long long row = m0 + m;
                xr[row * XR + j] = j < d ? attr[row * d + j] : from_float<T>(0.f);
            }
    }

    auto build = [&](T* sa, int, int k0) {
        if constexpr (D > 0) {
            // each row's stage in two halves of W features, one thread each
            // (the half warp-uniform), formed in registers and stored as
            // 16-byte chunks
            constexpr int W = P::BK / 2, F3 = D + D * D + D * D * D;
            static_assert(P::THREADS == 2 * P::BM, "two threads a row");
            const int m = threadIdx.x % P::BM, part = k0 / W + threadIdx.x / P::BM;
            float x[D];
#pragma unroll
            for (int i = 0; i < D; ++i) x[i] = s_x[m][i];  // zero past m_lim
            T* dst = sa + m * P::LDA + part % 2 * W;
            with_part<2 * ((F3 + P::BK - 1) / P::BK)>(part, [&](auto p) {
                float v[W];
                poly_features_part<D, W, decltype(p)::value>(x, F, 0.f, v);
#pragma unroll
                for (int j = 0; j < W; j += P::CHUNK) store_chunk(dst + j, v + j, P::CHUNK, true);
            });
        } else {
            // any d: two adjacent columns a thread, the features' factors
            // decoded once a stage
            constexpr int PAIRS = P::BK / 2;
            const int kc = 2 * (threadIdx.x % PAIRS), f = k0 + kc;
            const PolyTerm t0 = poly_term(min(f, F - 1), d), t1 = poly_term(min(f + 1, F - 1), d);
            for (int m = threadIdx.x / PAIRS; m < P::BM; m += P::THREADS / PAIRS) {
                const auto x = [&](int i) { return s_x[m][i]; };  // zero past m_lim
                store2(sa + m * P::LDA + kc, f < F ? poly_value(t0, x) : 0.f,
                       f + 1 < F ? poly_value(t1, x) : 0.f, true, true);
            }
        }
    };
    typename P::Acc acc = {};
    P::run_built([](int, int) {}, build, {w1.p + n0, w1.ld, w1.vec}, F, m_lim, n_lim,
                 shared_buffer<T>(), acc);

    float* s_acc = shared_buffer<float>();
    P::stage_acc(acc, s_acc);
    P::for_each_chunk([&](int m, int n) {
        constexpr int CH = P::CHUNK;
        const int col = n0 + n;
        if (m >= m_lim || col >= ld) return;
        const int count = min(CH, ld - col);
        float v[CH];
        const float* a = s_acc + m * P::ACC_LD + n;  // h1_pre's chunk
        T* o = out + (m0 + m) * ld + col;
        if constexpr (OUT == H1Out::HIDDEN) {
#pragma unroll
            for (int j = 0; j < CH; ++j) v[j] = col + j < H ? gelu(round_to<T>(a[j])) : 0.f;
            store_chunk(o, v, count, out_vec);
        } else {
            float dg[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j) {
                float gv, gd;
                gelu_and_deriv(round_to<T>(a[j]), gv, gd);
                v[j] = col + j < H ? gv : 0.f;
                dg[j] = col + j < H ? gd : 0.f;
            }
            store_chunk(o, v, count, out_vec);
            store_chunk(dg1 + (o - out), dg, count, out_vec);
        }
    });
}

// basis_h1_kernel's launch: rows = B'*O*E edge rows, out's row stride ld;
// D = d at compile time (0: d known at run time only)
template <class T, H1Out OUT, int D>
int launch_h1(const T* attr, const T* w1, T* out, T* dg1, T* xr, long long rows, int d, int F,
              int H, int ld, cudaStream_t stream) {
    using P = H1Tile<T>;
    const size_t smem = P::staged(P::BUILT_SMEM);
    cudaError_t err = allow_smem(basis_h1_kernel<T, OUT, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (rows + P::BM - 1) / P::BM * ((ld + P::BN - 1) / P::BN);
    basis_h1_kernel<T, OUT, D><<<(unsigned)blocks, P::THREADS, smem, stream>>>(
        attr, operand(w1, H), out, dg1, xr, rows, d, F, H, ld, rows_aligned(out, ld));
    return static_cast<int>(cudaGetLastError());
}

// the edges' six invariants of the diffusion model (models/ponita.py) take
// the kernels whose features are formed from registers
constexpr int MODEL_D = 6;

template <class T, H1Out OUT>
int launch_h1(const T* attr, const T* w1, T* out, T* dg1, T* xr, long long rows, int d, int F,
              int H, int ld, cudaStream_t stream) {
    return d == MODEL_D
               ? launch_h1<T, OUT, MODEL_D>(attr, w1, out, dg1, xr, rows, d, F, H, ld, stream)
               : launch_h1<T, OUT, 0>(attr, w1, out, dg1, xr, rows, d, F, H, ld, stream);
}

}  // namespace
