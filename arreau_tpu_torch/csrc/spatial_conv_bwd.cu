// The spatial convolution's backward passes on mma.sync, float32 or bfloat16,
// for sm_90a: the spatial part of #2 (the fused fiber conv's backward,
// fiber_conv_bwd.cu, through the entry point arreau_spatial_conv_bwd with
// fiber_dx = 1), and the pass #4 (spatial_conv_bwd_sm90.cu, on wgmma)
// keeps: dx over each sender's run.
//
// With the forward out[b',o,t,c] = sum_k win[e] * kern[e,c] * x[src[e],c],
// e = k*TA + t, kern = basis @ W, and g the cotangent of out (the TPU
// kernels: arreau_tpu/ops/pallas_conv.py:_bwd_kernel, :108, for #2 and
// _bwd_spatial_kernel, :331, for #4):
//
//   gxw[e,c]    = g[t,c] * x[src[e],c] * win[e]          (0 on an empty slot)
//   dbasis[e,:] = gxw[e,:] @ W^T                          (contracts C, per edge)
//   dW          = sum over b', o, e of basis[e,:]^T gxw[e,:] (contracts every edge)
//   dx[s,c]     = sum over e with src[e] = s of kern[e,c] * win[e] * g[t,c]
//
// A sender outside [0, TA) is an empty slot: it is never read and adds
// nothing.
//
// Bound on the H100: three products of 2*B'*O*E*D*C operations against the
// basis in and dbasis out: bytes in bfloat16 (989 TFLOP/s), operations in
// float32 (3xTF32, mma.cuh: 495 / 3 = 165 TFLOP/s).
//
// Design: each product is an mma.sync tile product (mma.cuh; TileProduct in
// tile_product.cuh) over 128 x 128 output tiles, its operands copied into
// shared memory by 16-byte cp.async, three stages deep in bfloat16 and two
// in float32. Where a row length breaks 16-byte alignment (ragged D or C)
// the same loaders copy element by element. The three results reduce over
// different axes, and Hopper's blocks run in no order, so where the TPU
// walked the o axis in sequence and carried dW in VMEM, the entry point
// launches, in order:
//
//   0. gxw: the edge cotangent, made once into a scratch [B'*O*E, Cg] in T
//      (Cg = C rounded up to 8, so rows stay 16-byte aligned).
//   1. dbasis = gxw @ W^T over all B'*O*E rows.
//   2. dW: split-K over the rows; each block sums basis^T gxw over one slice
//      into its own float32 partial tile, and a second pass adds the
//      partials in a fixed order. No global atomics.
//   3. dxc: kern = basis @ W per edge row, and in the product's epilogue the
//      dx term, written over gxw (which dW has read by then).
//   4. dx: each sender's dx terms summed in ascending e, in float32. The
//      wrapper lists each b's live edges by sender with a stable sort (src
//      is shared over o), so a thread walks one sender's run. The TPU kernel
//      sums the same terms as the one-hot product sel^T dxc
//      (pallas_conv.py:376-377); on the tensor cores that product is 1/TA
//      dense, and the run costs one read of dxc. Both are fixed orders: dx,
//      like every output here, is the same bit for bit on every call.
//
// Element type T (dtype.cuh) of basis, W, x, gxw, dbasis and dx: float32, or
// bfloat16 on the compute_dtype="bfloat16" path. #2's cotangent g (type G) is
// float32 in both element types, and in bfloat16 each dx term rounds the
// per-edge kernel and g to T apart and multiplies them in T
// (pallas_conv.py:143, :158: kern_k and g_o cast to bf16, their product
// bf16); gxw is rounded to T before its products, every product and sum is
// float32, dbasis and dx are rounded once as they are stored, and the dW
// partials stay float32 (the wrapper rounds the sum to W's type). In float32
// every rounding is the identity.

#include <cstdint>

#include "dtype.cuh"
#include "mma.cuh"
#include "common.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

constexpr int GXW_THREADS = 256;
constexpr int GXW_EDGES = 32;   // edge rows per block of the gxw pass
constexpr int DX_THREADS = 128;  // channel pairs per block of the dx pass
constexpr int DX_SENDERS = 8;    // senders per block of the dx pass

// 0. gxw[b'o*E + e, c] = round_T(g[t,c] * x[src[e],c] * win[e]), 0 on an empty
//    slot and in the row's pad c >= C: a warp per edge row, its lanes along c
template <class T, class G>
__global__ void __launch_bounds__(GXW_THREADS)
gxw_kernel(const G* __restrict__ g,        // [B'*O, TA, C]
           const T* __restrict__ x,        // [B'*O, TA, C]
           const int* __restrict__ src,    // [B', E]
           const float* __restrict__ win,  // [B', E]
           T* __restrict__ gxw,            // [B'*O*E, Cg]
           int O, int TA, int E, int C, int Cg) {
    const int bo = blockIdx.y, b = bo / O, lane = threadIdx.x % 32;
    const int e_end = min(E, (int)(blockIdx.x + 1) * GXW_EDGES);
    for (int e = blockIdx.x * GXW_EDGES + threadIdx.x / 32; e < e_end; e += GXW_THREADS / 32) {
        const int s = src[(size_t)b * E + e];
        const bool live = s >= 0 && s < TA;
        const float wv = win[(size_t)b * E + e];
        const G* g_t = g + ((size_t)bo * TA + e % TA) * C;
        const T* x_s = x + ((size_t)bo * TA + (live ? s : 0)) * C;
        T* out = gxw + ((size_t)bo * E + e) * Cg;
        for (int c = lane; c < Cg; c += 32)
            out[c] = from_float<T>(live && c < C ? to_float(g_t[c]) * to_float(x_s[c]) * wv : 0.f);
    }
}

// 1. dbasis[row, d] = sum_c gxw[row, c] * W[d, c]
template <class T>
__global__ void __launch_bounds__(WideTile<T, true, true>::THREADS, MIN_BLOCKS)
dbasis_kernel(Operand<T> gxw, Operand<T> w, T* __restrict__ dbasis, long long rows, int D,
              int C) {
    using P = WideTile<T, true, true>;
    const int n_tiles = (D + P::BN - 1) / P::BN;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = D - n0;
    typename P::Acc acc = {};
    P::run({gxw.p + m0 * gxw.ld, gxw.ld, gxw.vec}, {w.p + (long long)n0 * w.ld, w.ld, w.vec}, C,
           m_lim, n_lim, shared_buffer<T>(), acc);
    T* out = dbasis + m0 * D + n0;
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m < m_lim && n < n_lim)
            store2(out + (long long)m * D + n, v0, v1, n + 1 < n_lim, D % 2 == 0);
    });
}

// 3. dxc[row, c] = the per-edge dx term of edge row (b', o, e), into the gxw
//    scratch once dW has read it: kern = basis @ W on the tensor cores, then
//    round_T(kern * win * g[t]) (with FIBER: kern * win and g rounded apart,
//    then their product), 0 on an empty slot
template <class T, class G, bool FIBER>
__global__ void __launch_bounds__(WideTile<T, true, false>::THREADS, MIN_BLOCKS)
dx_terms_kernel(Operand<T> basis,                  // [B'*O*E, D]
                Operand<T> w,                      // [D, C]
                const int* __restrict__ src,       // [B', E]
                const float* __restrict__ win,     // [B', E]
                const G* __restrict__ g,           // [B'*O, TA, C]
                T* __restrict__ dxc,               // [B'*O*E, Cg]
                long long rows, int O, int TA, int E, int D, int C, int Cg) {
    using P = WideTile<T, true, false>;
    const int n_tiles = (C + P::BN - 1) / P::BN;
    const long long m0 = (long long)(blockIdx.x / n_tiles) * P::BM;
    const int n0 = blockIdx.x % n_tiles * P::BN;
    const int m_lim = (int)min(rows - m0, (long long)P::BM), n_lim = C - n0;
    typename P::Acc acc = {};
    P::run({basis.p + m0 * basis.ld, basis.ld, basis.vec}, {w.p + n0, w.ld, w.vec}, D, m_lim,
           n_lim, shared_buffer<T>(), acc);
    struct Row {
        const G* g_t;  // g[t] at the block's first channel; null on an empty slot
        float wv;
        T* out;        // the row of dxc; null past the last row
    };
    auto row_of = [&](int m) -> Row {
        if (m >= m_lim) return {nullptr, 0.f, nullptr};
        const long long row = m0 + m;
        const long long bo = row / E;
        const int e = (int)(row - bo * E), b = (int)(bo / O);
        const int s = src[(size_t)b * E + e];
        T* out = dxc + row * Cg + n0;
        if (s < 0 || s >= TA) return {nullptr, 0.f, out};
        return {g + ((size_t)bo * TA + e % TA) * C + n0, win[(size_t)b * E + e], out};
    };
    P::for_each_row(acc, row_of, [&](const Row& r, int m, int n, float v0, float v1) {
        if (r.out == nullptr || n >= n_lim) return;
        const bool second = n + 1 < n_lim;
        float d[2] = {0.f, 0.f};
        if (r.g_t != nullptr) {
            const float2 gp = load2(r.g_t + n, second, C % 2 == 0);
            const float v[2] = {v0, v1}, gv[2] = {gp.x, gp.y};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if constexpr (FIBER)
                    d[q] = round_to<T>(round_to<T>(v[q] * r.wv) * round_to<T>(gv[q]));
                else
                    d[q] = round_to<T>(v[q] * r.wv * gv[q]);
            }
        }
        store2(r.out + n, d[0], d[1], second, true);
    });
}

// 4. dx[b',o,s,c] = sum over the edges e with src[e] = s, in ascending e, of
//    dxc[e,c]: order [B', E] lists each b's live edges by sender, stably (so
//    ascending e within a sender), and offsets [B', TA + 1] where each
//    sender's run starts. A thread sums one channel pair of DX_SENDERS
//    senders in float32, one after another: a fixed order, so dx is the same
//    bit for bit on every call.
template <class T>
__global__ void __launch_bounds__(DX_THREADS)
dx_kernel(const T* __restrict__ dxc,        // [B'*O*E, Cg]
          const int* __restrict__ order,    // [B', E]
          const int* __restrict__ offsets,  // [B', TA + 1]
          T* __restrict__ dx,               // [B'*O, TA, C]
          int BO, int O, int TA, int E, int C, int Cg) {
    const int c = 2 * (blockIdx.x * DX_THREADS + threadIdx.x);
    if (c >= C) return;
    const bool second = c + 1 < C;
    for (int bo = blockIdx.z; bo < BO; bo += gridDim.z) {  // gridDim.z <= 65535
        const int b = bo / O;
        const int* run = order + (size_t)b * E;
        const T* rows = dxc + (size_t)bo * E * Cg + c;
        const int s_end = min(TA, (int)(blockIdx.y + 1) * DX_SENDERS);
        for (int s = blockIdx.y * DX_SENDERS; s < s_end; ++s) {
            const int end = offsets[(size_t)b * (TA + 1) + s + 1];
            float a0 = 0.f, a1 = 0.f;
            for (int j = offsets[(size_t)b * (TA + 1) + s]; j < end; ++j) {
                const T* v = rows + (size_t)run[j] * Cg;  // Cg is even: a pair is aligned
                if constexpr (sizeof(T) == 2) {
                    const float2 f =
                        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
                    a0 += f.x, a1 += f.y;
                } else {
                    const float2 f = *reinterpret_cast<const float2*>(v);
                    a0 += f.x, a1 += f.y;
                }
            }
            store2(dx + ((size_t)bo * TA + s) * C + c, a0, a1, second, C % 2 == 0);
        }
    }
}

// 2. partial[split, d, c] = sum over this split's edge rows of basis[row, d] * gxw[row, c]
template <class T>
__global__ void __launch_bounds__(WideTile<T, false, false>::THREADS, MIN_BLOCKS)
dw_partial_kernel(Operand<T> basis, Operand<T> gxw, float* __restrict__ partial, long long rows,
                  int rows_per_split, int D, int C) {
    using P = WideTile<T, false, false>;
    const int n_tiles = (C + P::BN - 1) / P::BN;
    const int m0 = blockIdx.x / n_tiles * P::BM, n0 = blockIdx.x % n_tiles * P::BN;
    const long long k0 = (long long)blockIdx.y * rows_per_split;
    const int K = (int)min(rows - k0, (long long)rows_per_split);
    typename P::Acc acc = {};
    P::run({basis.p + k0 * basis.ld + m0, basis.ld, basis.vec},
           {gxw.p + k0 * gxw.ld + n0, gxw.ld, gxw.vec}, K, D - m0, C - n0, shared_buffer<T>(),
           acc);
    float* out = partial + (size_t)blockIdx.y * D * C + (size_t)m0 * C + n0;
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m0 + m < D && n0 + n < C)
            store2(out + (size_t)m * C + n, v0, v1, n0 + n + 1 < C, C % 2 == 0);
    });
}

// d[m, n] = sum_k A[m, k] B[k, n] in float32 through the tile product: the
// card test of mma.cuh's fragments in every operand layout
template <class T, bool A_K, bool B_K>
__global__ void __launch_bounds__(WideTile<T, A_K, B_K>::THREADS, MIN_BLOCKS)
tile_product_kernel(Operand<T> a, Operand<T> b, float* __restrict__ d, int M, int N, int K) {
    using P = WideTile<T, A_K, B_K>;
    const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
    typename P::Acc acc = {};
    P::run({a.p + (A_K ? (long long)m0 * a.ld : m0), a.ld, a.vec},
           {b.p + (B_K ? (long long)n0 * b.ld : n0), b.ld, b.vec}, K, M - m0, N - n0,
           shared_buffer<T>(), acc);
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m0 + m < M && n0 + n < N)
            store2(d + (size_t)(m0 + m) * N + n0 + n, v0, v1, n0 + n + 1 < N, N % 2 == 0);
    });
}

// Step 4 for B'*O = BO tiles
template <class T>
cudaError_t launch_dx(const T* dxc, const int* order, const int* offsets, T* dx, int Bp, int O,
                      int TA, int E, int C, int Cg, cudaStream_t stream) {
    const int BO = Bp * O;
    dx_kernel<T><<<dim3((C + 2 * DX_THREADS - 1) / (2 * DX_THREADS),
                        (TA + DX_SENDERS - 1) / DX_SENDERS, BO < 65535 ? BO : 65535),
                   DX_THREADS, 0, stream>>>(dxc, order, offsets, dx, BO, O, TA, E, C, Cg);
    return cudaGetLastError();
}

// Step 3
template <class T, class G, bool FIBER>
cudaError_t launch_dx_terms(const T* basis, const T* w, const int* src, const float* win,
                            const G* g, T* dxc, long long rows, int O, int TA, int E, int D,
                            int C, int Cg, cudaStream_t stream) {
    using KX = WideTile<T, true, false>;
    cudaError_t err = allow_smem(dx_terms_kernel<T, G, FIBER>, KX::SMEM);
    if (err != cudaSuccess) return err;
    const long long kx_tiles = ((rows + KX::BM - 1) / KX::BM) * ((C + KX::BN - 1) / KX::BN);
    dx_terms_kernel<T, G, FIBER><<<(unsigned)kx_tiles, KX::THREADS, KX::SMEM, stream>>>(
        operand(basis, D), operand(w, C), src, win, g, dxc, rows, O, TA, E, D, C, Cg);
    return cudaGetLastError();
}

// The passes and the split sum, for element type T, cotangent type G and dx
// rounding FIBER. Every launch goes on the caller's stream, in this order:
// dxc overwrites gxw after dW has read it.
template <class T, class G, bool FIBER>
int spatial_conv_bwd(const T* basis, const T* w, const T* x, const int* src, const float* win,
                     const int* order, const int* offsets, const G* g, T* dbasis, float* dw, T* dx,
                     T* gxw, float* partial, int Bp, int O, int K, int TA, int D, int C,
                     int splits, int rows_per_split, cudaStream_t stream) {
    const int E = K * TA, Cg = (C + 7) / 8 * 8;
    const long long rows = (long long)Bp * O * E;
    cudaError_t err;
    gxw_kernel<T, G><<<dim3((E + GXW_EDGES - 1) / GXW_EDGES, Bp * O), GXW_THREADS, 0, stream>>>(
        g, x, src, win, gxw, O, TA, E, C, Cg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using DB = WideTile<T, true, true>;
    const long long m_tiles = (rows + DB::BM - 1) / DB::BM;
    if ((err = allow_smem(dbasis_kernel<T>, DB::SMEM)) != cudaSuccess) return static_cast<int>(err);
    dbasis_kernel<T><<<(unsigned)(m_tiles * ((D + DB::BN - 1) / DB::BN)), DB::THREADS, DB::SMEM,
                       stream>>>(operand(gxw, Cg), operand(w, C), dbasis, rows, D, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    using DW = WideTile<T, false, false>;
    if ((err = allow_smem(dw_partial_kernel<T>, DW::SMEM)) != cudaSuccess)
        return static_cast<int>(err);
    dw_partial_kernel<T><<<dim3(((D + DW::BM - 1) / DW::BM) * ((C + DW::BN - 1) / DW::BN), splits),
                           DW::THREADS, DW::SMEM, stream>>>(operand(basis, D), operand(gxw, Cg),
                                                            partial, rows, rows_per_split, D, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)D * C;
    sum_splits_kernel<<<sum_splits_blocks(n), THREADS, 0, stream>>>(partial, dw, splits, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    if ((err = launch_dx_terms<T, G, FIBER>(basis, w, src, win, g, gxw, rows, O, TA, E, D, C, Cg,
                                            stream)) != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(launch_dx<T>(gxw, order, offsets, dx, Bp, O, TA, E, C, Cg, stream));
}

template <class T, bool A_K, bool B_K>
int tile_product(const T* a, const T* b, float* d, int M, int N, int K, cudaStream_t stream) {
    using P = WideTile<T, A_K, B_K>;
    cudaError_t err = allow_smem(tile_product_kernel<T, A_K, B_K>, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_product_kernel<T, A_K, B_K><<<dim3((N + P::BN - 1) / P::BN, (M + P::BM - 1) / P::BM),
                                       P::THREADS, P::SMEM, stream>>>(
        operand(a, A_K ? K : M), operand(b, B_K ? K : N), d, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace arreau {

// the dx pass for #4's wgmma design (conv_sm90.cuh, spatial_conv_bwd_sm90.cu)
int spatial_conv_dx(const void* dxc, const int* order, const int* offsets, void* dx, int Bp, int O,
                    int TA, int E, int C, int Cg, bool is_bf16, cudaStream_t stream) {
    if (is_bf16)
        return static_cast<int>(launch_dx<bf16>(static_cast<const bf16*>(dxc), order, offsets,
                                                static_cast<bf16*>(dx), Bp, O, TA, E, C, Cg,
                                                stream));
    return static_cast<int>(launch_dx<float>(static_cast<const float*>(dxc), order, offsets,
                                             static_cast<float*>(dx), Bp, O, TA, E, C, Cg, stream));
}

}  // namespace arreau

// #2's spatial passes: basis, w, x, dbasis, dx and the gxw scratch
// ([B'*O*K*TA, C rounded up to 8]) are float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1, with fiber_dx = 1); g, win, partial and dw are float32. order
// [B', K*TA] and offsets [B', TA + 1] (int32) list each b's live edges by
// sender, stably, and where each sender's run starts
// (kernels/spatial_conv.py:sender_order). dwin and dwin_partial must be null
// (the window cotangent is #4's, spatial_conv_bwd_sm90.cu).
extern "C" int arreau_spatial_conv_bwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, const int* order,
                                       const int* offsets, const void* g, void* dbasis, float* dw,
                                       void* dx, void* gxw, float* partial, float* dwin,
                                       float* dwin_partial, int Bp, int O, int K, int TA, int D,
                                       int C, int splits, int rows_per_split, int is_bf16,
                                       int fiber_dx, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (dwin != nullptr || dwin_partial != nullptr || (is_bf16 && !fiber_dx))
        return static_cast<int>(cudaErrorInvalidValue);
    if (!is_bf16)
        return spatial_conv_bwd<float, float, false>(
            static_cast<const float*>(basis), static_cast<const float*>(w),
            static_cast<const float*>(x), src, win, order, offsets, static_cast<const float*>(g),
            static_cast<float*>(dbasis), dw, static_cast<float*>(dx), static_cast<float*>(gxw),
            partial, Bp, O, K, TA, D, C, splits, rows_per_split, stream);
    return spatial_conv_bwd<bf16, float, true>(
        static_cast<const bf16*>(basis), static_cast<const bf16*>(w), static_cast<const bf16*>(x),
        src, win, order, offsets, static_cast<const float*>(g), static_cast<bf16*>(dbasis), dw,
        static_cast<bf16*>(dx), static_cast<bf16*>(gxw), partial, Bp, O, K, TA, D, C, splits,
        rows_per_split, stream);
}

// d [M, N] float32 = a @ b through mma.cuh: a is [M, K] (a_kmajor) or
// [K, M], b is [N, K] (b_kmajor) or [K, N], both float32 (3xTF32) or
// bfloat16 (is_bf16). The card tests hold it against a float64 product.
extern "C" int arreau_tile_product(const void* a, const void* b, float* d, int M, int N, int K,
                                   int a_kmajor, int b_kmajor, int is_bf16, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (is_bf16) {
        const bf16 *ta = static_cast<const bf16*>(a), *tb = static_cast<const bf16*>(b);
        if (a_kmajor)
            return b_kmajor ? tile_product<bf16, true, true>(ta, tb, d, M, N, K, stream)
                            : tile_product<bf16, true, false>(ta, tb, d, M, N, K, stream);
        return b_kmajor ? tile_product<bf16, false, true>(ta, tb, d, M, N, K, stream)
                        : tile_product<bf16, false, false>(ta, tb, d, M, N, K, stream);
    }
    const float *ta = static_cast<const float*>(a), *tb = static_cast<const float*>(b);
    if (a_kmajor)
        return b_kmajor ? tile_product<float, true, true>(ta, tb, d, M, N, K, stream)
                        : tile_product<float, true, false>(ta, tb, d, M, N, K, stream);
    return b_kmajor ? tile_product<float, false, true>(ta, tb, d, M, N, K, stream)
                    : tile_product<float, false, false>(ta, tb, d, M, N, K, stream);
}
