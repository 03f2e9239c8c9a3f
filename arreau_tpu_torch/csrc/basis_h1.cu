// First layer of the edge-basis MLP, forward, float32, for sm_90a (#8's
// bfloat16 instantiation: basis_h1_sm90.cu, on wgmma and TMA).
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
// Bound on the H100: 2*B'*O*E*F*H operations (54 GFLOP at the training
// shape, 524288 rows) against ~0.4 GB of output write; the product runs as
// 3xTF32 (mma.cuh, 495 / 3 = 165 TFLOP/s) and the operations bound it. Design (basis_h1.cuh): one mma.sync tile product
// over all B'*O*E rows, the features built in shared memory a K-stage at a
// time from the block's staged invariants (with the model's d = 6, from
// registers, the factors fixed at compile time) while the tensor cores work
// on the stage before, W1 by cp.async, the bias added in the epilogue; the
// [rows, F] features never reach device memory.
//
// arreau_tile_product_built runs run_built (tile_product.cuh) on two
// matrices, A copied into the stage by the block itself: the card test of
// the built operand's layouts.

#include "basis_h1.cuh"

namespace {

// d[m, n] = sum_k A[m, k] B[k, n] in float32 with A built by the block:
// fetch stages A's K-slice by cp.async into a slot, build copies the slot
// into the A tile element by element
template <class T, bool A_K, bool B_K>
__global__ void __launch_bounds__(WideTile<T, A_K, B_K>::THREADS)
tile_product_built_kernel(Operand<T> a, Operand<T> b, float* __restrict__ d, int M, int N,
                          int K) {
    using P = WideTile<T, A_K, B_K>;
    const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
    const int m_lim = M - m0, n_lim = N - n0;
    T* slots = shared_buffer<T>() + P::BUILT_SMEM / sizeof(T);
    const T* ap = a.p + (A_K ? (long long)m0 * a.ld : m0);
    auto fetch = [&](int slot, int k0) {
        T* s = slots + slot * P::A_SIZE;
        if constexpr (A_K)
            load_tile<T, P::BM, P::BK, P::LDA, P::THREADS>(s, ap + k0, a.ld, m_lim, K - k0, a.vec);
        else
            load_tile<T, P::BK, P::BM, P::LDA, P::THREADS>(s, ap + k0 * a.ld, a.ld, K - k0, m_lim,
                                                           a.vec);
    };
    auto build = [&](T* sa, int slot, int) {
        const T* s = slots + slot * P::A_SIZE;
        for (int i = threadIdx.x; i < P::A_SIZE; i += P::THREADS) sa[i] = s[i];
    };
    typename P::Acc acc = {};
    P::run_built(fetch, build, {b.p + (B_K ? (long long)n0 * b.ld : n0), b.ld, b.vec}, K, m_lim,
                 n_lim, shared_buffer<T>(), acc);
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m < m_lim && n < n_lim)
            store2(d + (size_t)(m0 + m) * N + n0 + n, v0, v1, n + 1 < n_lim, N % 2 == 0);
    });
}

template <class T, bool A_K, bool B_K>
int tile_product_built(const T* a, const T* b, float* d, int M, int N, int K,
                       cudaStream_t stream) {
    using P = WideTile<T, A_K, B_K>;
    const size_t smem = P::BUILT_SMEM + (size_t)P::STAGES * P::A_SIZE * sizeof(T);
    cudaError_t err = allow_smem(tile_product_built_kernel<T, A_K, B_K>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_product_built_kernel<T, A_K, B_K>
        <<<dim3((N + P::BN - 1) / P::BN, (M + P::BM - 1) / P::BM), P::THREADS, smem, stream>>>(
            operand(a, A_K ? K : M), operand(b, B_K ? K : N), d, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// attrT, w1, b1 and out are float32.
extern "C" int arreau_basis_h1_fwd(const float* attrT, const float* w1, const float* b1,
                                   float* out, int Bp, int O, int d, int E, int F, int H,
                                   void* stream) {
    return launch_h1<float, H1Out::PRE>(attrT, w1, b1, out, nullptr, nullptr,
                                        (long long)Bp * O * E, d, E, F, H, H,
                                        static_cast<cudaStream_t>(stream));
}

// d [M, N] float32 = a @ b through run_built: a is [M, K] (a_kmajor) or
// [K, M], b is [N, K] (b_kmajor) or [K, N], both float32 (3xTF32) or
// bfloat16 (is_bf16). The card tests hold it against a float64 product.
extern "C" int arreau_tile_product_built(const void* a, const void* b, float* d, int M, int N,
                                         int K, int a_kmajor, int b_kmajor, int is_bf16,
                                         void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        const T *ta = static_cast<const T*>(a), *tb = static_cast<const T*>(b);
        if (a_kmajor)
            status = b_kmajor ? tile_product_built<T, true, true>(ta, tb, d, M, N, K, stream)
                              : tile_product_built<T, true, false>(ta, tb, d, M, N, K, stream);
        else
            status = b_kmajor ? tile_product_built<T, false, true>(ta, tb, d, M, N, K, stream)
                              : tile_product_built<T, false, false>(ta, tb, d, M, N, K, stream);
    });
    return status;
}
