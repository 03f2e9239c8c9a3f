// Fused ConvNext MLP tail with the per-layer readout, forward, float32, for
// sm_90a (bfloat16: convnext_mlp_sm90.cu).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_fwd_kernel (the
// forward of fused_convnext_mlp, reached through _fwd). For each row (one
// (b', o, t) position) of the conv output xc and the residual res:
//
//   yl  = LayerNorm(xc) (scale ln_s, bias ln_b)
//   m   = gelu(yl @ W1 + b1) @ W2 + b2          (C -> W = 4C -> C)
//   out = res + gamma * m
//   r   = out @ Wr + br                          (optional readout)
//
// all in float32 (convnext_rows.cuh).
//
// Bound on the H100: 2*M*(2*C*W + C*R) operations (42.4 GFLOP at the
// training shape, M = 65536 rows, C = 200, W = 800, R = 19) against ~160 MB
// of traffic (xc, res and out, r), so arithmetic bounds it: 0.26 ms at
// float32's 3xTF32 rate. Design: rows are independent, so a block owns 64
// rows and their whole channel width (convnext_rows.cuh): LayerNorm into
// shared memory, then both products on the tensor cores, the hidden width in
// chunks whose activations are formed in shared memory and folded at once
// into m's float32 accumulators in registers, so neither pre1 nor h reaches
// device memory. The epilogue forms out from m in 16-byte row chunks and
// the readout, about 1% of the work, runs on the CUDA cores from out in
// shared memory.
//
// arreau_tile_product_staged runs TileProduct::product (tile_product.cuh)
// on two matrices, at the row blocks' odd count of n8 tiles a warp: the card
// test of that entry of the mainloop.

#include "convnext_rows.cuh"

namespace {

using namespace arreau;

template <int CN>
__global__ void __launch_bounds__(ROW_THREADS, 1)
convnext_fwd_kernel(ConvNextArgs a, float* __restrict__ out, float* __restrict__ r_out) {
    using B = RowBlock<CN>;
    const typename B::Smem s = B::carve();
    const long long row0 = (long long)blockIdx.x * B::RB;
    const int nch = B::chunks(a.W);

    B::fetch_chunk(a, s, 0, nch, nch);  // W's first chunk arrives during LayerNorm
    B::layer_norm(a, row0, s, nullptr, nullptr, 0);
    typename B::WideAcc m_acc = {};
    B::forward_chunks(a, row0, s, nch, nch, m_acc, nullptr, nullptr, 0);
    B::store_m(a, m_acc, s);
    __syncthreads();  // m is in sA
    B::for_each_chunk([&](int r, int c0) {
        const long long row = row0 + r;
        if (row >= a.M || c0 >= a.C) return;
        const int count = min(B::CH, a.C - c0);
        float* sa = s.a + r * B::LD_A + c0;
        float m[B::CH], o[B::CH];
        load_chunk(m, sa, B::CH, true);
        B::residual_out(a, row, c0, count, m, o);
        store_chunk(out + row * a.C + c0, o, count, a.rows_vec);
        store_chunk(sa, o, B::CH, true);  // out over m, for the readout
    });
    if (r_out == nullptr) return;
    __syncthreads();
    // r[row, q]: consecutive threads on consecutive q of a row, so that a
    // warp reads out from shared memory by broadcast and Wr's rows coalesced
    for (int i = threadIdx.x; i < B::RB * a.R; i += ROW_THREADS) {
        const int r = i / a.R, q = i - r * a.R;
        const long long row = row0 + r;
        if (row >= a.M) break;
        const float* o = s.a + r * B::LD_A;
        float v = 0.f;
        for (int c = 0; c < a.C; ++c) v += o[c] * a.wr[c * a.R + q];
        r_out[row * a.R + q] = v + a.br[q];
    }
}

template <int CN>
cudaError_t launch_fwd(const ConvNextArgs& a, float* out, float* r, cudaStream_t stream) {
    using B = RowBlock<CN>;
    const cudaError_t err = allow_smem(convnext_fwd_kernel<CN>, B::SMEM);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((a.M + B::RB - 1) / B::RB);
    convnext_fwd_kernel<CN><<<blocks, ROW_THREADS, B::SMEM, stream>>>(a, out, r);
    return cudaGetLastError();
}

// d [M, N] = A B in float32 through TileProduct::product on 64 x 208 tiles
// (8 warps of 16 rows x 13 n8 tiles, the row blocks' odd count), the
// block staging A's and B's K-slices itself
template <class T, bool A_K, bool B_K>
using StagedTile = TileProduct<T, A_K, B_K, 4, 2, 1, 13>;

template <class T, bool A_K, bool B_K>
__global__ void __launch_bounds__(ROW_THREADS)
tile_product_staged_kernel(Operand<T> a, Operand<T> b, float* __restrict__ d, int M, int N,
                           int K) {
    using P = StagedTile<T, A_K, B_K>;
    const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
    const int m_lim = M - m0, n_lim = N - n0;
    const Operand<T> at = {a.p + (A_K ? (long long)m0 * a.ld : m0), a.ld, a.vec};
    const Operand<T> bt = {b.p + (B_K ? (long long)n0 * b.ld : n0), b.ld, b.vec};
    T* s = shared_buffer<T>();
    typename P::Acc acc = {};
    for (int k0 = 0; k0 < K; k0 += P::BK) {
        P::load_stage(s, at, bt, k0, K, m_lim, n_lim);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        P::template product<P::BK>(s, P::LDA, s + P::A_SIZE, P::LDB, acc);  // zero past K
        __syncthreads();
    }
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m < m_lim && n < n_lim)
            store2(d + (size_t)(m0 + m) * N + n0 + n, v0, v1, n + 1 < n_lim, N % 2 == 0);
    });
}

template <class T, bool A_K, bool B_K>
int tile_product_staged(const T* a, const T* b, float* d, int M, int N, int K,
                        cudaStream_t stream) {
    using P = StagedTile<T, A_K, B_K>;
    const size_t smem = (size_t)P::STAGE * sizeof(T);
    cudaError_t err = allow_smem(tile_product_staged_kernel<T, A_K, B_K>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_product_staged_kernel<T, A_K, B_K>
        <<<dim3((N + P::BN - 1) / P::BN, (M + P::BM - 1) / P::BM), P::THREADS, smem, stream>>>(
            operand(a, A_K ? K : M), operand(b, B_K ? K : N), d, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xc [M, C], ln_s, ln_b, gamma [C], res [M, C], w1 [C, W], b1 [W], w2 [W, C],
// b2 [C] and out [M, C] float32; wr [C, R], br [R] and r [M, R] float32, or
// all three null (no readout). C <= 256. (bfloat16: convnext_mlp_sm90.cu.)
extern "C" int arreau_convnext_mlp_fwd(const float* xc, const float* res, const float* ln_s,
                                       const float* ln_b, const float* w1, const float* b1,
                                       const float* w2, const float* b2, const float* gamma,
                                       const float* wr, const float* br, float* out, float* r,
                                       int M, int C, int W, int R, void* stream_ptr) {
    if (C < 1 || C > MAX_CHANNELS) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bool rows_vec = rows_aligned(res, C) && rows_aligned(out, C);
    const ConvNextArgs a =
        convnext_args(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, M, C, W, R, rows_vec);
    const cudaError_t err = C <= MODEL_CN ? launch_fwd<MODEL_CN>(a, out, r, stream)
                                          : launch_fwd<MAX_CHANNELS>(a, out, r, stream);
    return static_cast<int>(err);
}

// d [M, N] float32 = a @ b through TileProduct::product: a is [M, K]
// (a_kmajor) or [K, M], b is [N, K] (b_kmajor) or [K, N], both float32
// (3xTF32) or bfloat16 (is_bf16). The card tests hold it against a float64
// product.
extern "C" int arreau_tile_product_staged(const void* a, const void* b, float* d, int M, int N,
                                          int K, int a_kmajor, int b_kmajor, int is_bf16,
                                          void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        const T *ta = static_cast<const T*>(a), *tb = static_cast<const T*>(b);
        if (a_kmajor)
            status = b_kmajor ? tile_product_staged<T, true, true>(ta, tb, d, M, N, K, stream)
                              : tile_product_staged<T, true, false>(ta, tb, d, M, N, K, stream);
        else
            status = b_kmajor ? tile_product_staged<T, false, true>(ta, tb, d, M, N, K, stream)
                              : tile_product_staged<T, false, false>(ta, tb, d, M, N, K, stream);
    });
    return status;
}
