// Fused bias-free edge-basis MLP, forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_fwd_kernel (called
// by _fwd, public entry fused_basis_mlp, reached from BasisMLP(fused=True)).
// For every edge row of attr [B', O, E, d] (rows = B'*O*E):
//
//   h[row, :]     = gelu(round_T(poly(attr[row, :]) @ W1))      W1 [F, H]
//   basis[row, :] = gelu(round_T(h[row, :] @ W2))               W2 [H, D]
//
// where poly is the tensor-power feature vector [x, x(x)x, x(x)x(x)x] of the
// d invariants in the order of polynomial_features
// (arreau_tpu/models/blocks.py:70, the order of pallas_basis.py's one-hot
// selection matrices): F = d + d^2 + d^3 = 258 for d = 6, degree 3.
//
// Bound on the H100: 2*rows*(F*H + H*D) operations (107.8 GFLOP at the
// training shape, rows = 524288, F=258, H=200, D=256) against the output
// write (268 MB bfloat16, 537 MB float32): arithmetic bounds it, 0.11 ms on
// the bfloat16 tensor cores (989 TFLOP/s), 0.65 ms in float32 as 3xTF32
// (mma.cuh, 495 / 3 = 165 TFLOP/s).
//
// Design. On the TPU one grid cell held a (b', o) block's whole chain in
// VMEM. Here the chain runs as two mma.sync tile products over all rows
// (WideTile, tile_product.cuh: 128 x 128 tiles, cp.async stages):
//
//   1. h = round_T(gelu(round_T(poly @ W1))): #8's product (basis_h1.cuh,
//      HIDDEN), the features built in shared memory a K-stage at a time
//      from the block's staged invariants (from registers with the model's
//      d = 6), so they never reach device memory; the epilogue writes h into
//      a [rows, Hp] scratch in T (Hp = H rounded up to 8: 16-byte rows).
//   2. basis = round_T(gelu(round_T(h @ W2))): h and W2 staged by cp.async;
//      the epilogue stages the accumulators in shared memory and writes each
//      output element once, in 16-byte row chunks.
//
// The scratch costs one write and one read of h (210 MB bfloat16 at the
// training shape, ~0.13 ms of the card's memory rate); a block that kept
// its rows' h in shared memory between the two products (#9's row blocks,
// convnext_rows.cuh) would save it, but those products run at well below
// the 128 x 128 tiles' rate.
//
// arreau_tile_product_built runs run_built (tile_product.cuh), the
// mainloop of #5's first product, on two matrices, A copied into the stage
// by the block itself: the card test of the built operand's layouts.
//
// Element type T (dtype.cuh) of attr, W1, W2, h and the output: float32, or
// bfloat16 under BasisMLP's bfloat16 compute type, with the JAX kernel's
// rounding points (pallas_basis.py:77-83, :108-116): each feature is formed
// in float32 from the T invariants and rounded once to T; both products sum
// in float32 and are rounded to T before their GELU; GELU is evaluated in
// float32 from the rounded value and rounded once (the JAX kernel evaluates
// it in T step by step).

#include "basis_h1.cuh"
#include "common.cuh"
#include "dtype.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

// 2. out[row, n] = round_T(gelu(round_T(h[row, :H] @ W2[:, n])))
template <class T>
__global__ void __launch_bounds__(WideTile<T, true, false>::THREADS, MIN_BLOCKS)
basis_out_kernel(Operand<T> h,          // [rows, Hp]
                 Operand<T> w2,         // [H, D]
                 T* __restrict__ out,   // [rows, D]
                 long long rows, int H, int D, bool out_vec) {
    using P = WideTile<T, true, false>;
    const int n_tiles = (D + P::BN - 1) / P::BN;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = D - n0;
    typename P::Acc acc = {};
    P::run({h.p + m0 * h.ld, h.ld, h.vec}, {w2.p + n0, w2.ld, w2.vec}, H, m_lim, n_lim,
           shared_buffer<T>(), acc);
    float* s_acc = shared_buffer<float>();
    P::stage_acc(acc, s_acc);
    P::for_each_chunk([&](int m, int n) {
        constexpr int CH = P::CHUNK;
        if (m >= m_lim || n >= n_lim) return;
        const float* a = s_acc + m * P::ACC_LD + n;
        float v[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) v[j] = gelu(round_to<T>(a[j]));
        store_chunk(out + (m0 + m) * D + n0 + n, v, min(CH, n_lim - n), out_vec);
    });
}

template <class T>
int fused_basis_mlp(const T* attr, const T* w1, const T* w2, T* h, T* out, long long rows, int d,
                    int F, int H, int D, cudaStream_t stream) {
    const int Hp = (H + 7) / 8 * 8;
    int status = launch_h1<T, H1Out::HIDDEN>(attr, w1, h, nullptr, nullptr, rows, d, F, H, Hp,
                                              stream);
    if (status != 0) return status;
    using P = WideTile<T, true, false>;
    const size_t smem = P::staged(P::SMEM);
    cudaError_t err = allow_smem(basis_out_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (rows + P::BM - 1) / P::BM * ((D + P::BN - 1) / P::BN);
    basis_out_kernel<T><<<(unsigned)blocks, P::THREADS, smem, stream>>>(
        operand<T>(h, Hp), operand(w2, D), out, rows, H, D, rows_aligned(out, D));
    return static_cast<int>(cudaGetLastError());
}

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

// attr [B', O, E, d], w1 [F, H], w2 [H, D], the scratch h [rows, Hp] (Hp = H
// rounded up to 8) and out [B', O, E, D] are float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1).
extern "C" int arreau_fused_basis_mlp_fwd(const void* attr, const void* w1, const void* w2,
                                          void* h, void* out, int Bp, int O, int E, int d, int F,
                                          int H, int D, int is_bf16, void* stream_ptr) {
    if (d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long rows = (long long)Bp * O * E;
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = fused_basis_mlp<T>(static_cast<const T*>(attr), static_cast<const T*>(w1),
                                    static_cast<const T*>(w2), static_cast<T*>(h),
                                    static_cast<T*>(out), rows, d, F, H, D, stream);
    });
    return status;
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
