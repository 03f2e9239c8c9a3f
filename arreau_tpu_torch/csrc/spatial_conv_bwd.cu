// Spatial fiber-bundle convolution, backward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_bwd_spatial_kernel
// (the VJP of fused_spatial_conv, reached through _bwd_spatial). With the
// forward out[b',o,t,c] = sum_k win[e] * kern[e,c] * x[src[e],c], e = k*TA + t,
// kern = basis @ W, and g the cotangent of out:
//
//   gxw[e,c]    = g[t,c] * x[src[e],c] * win[e]          (0 on an empty slot)
//   dbasis[e,:] = gxw[e,:] @ W^T                          (contracts C, per edge)
//   dW          = sum over b', o, e of basis[e,:]^T gxw[e,:] (contracts every edge)
//   dx[s,c]    += kern[e,c] * win[e] * g[t,c]  for s = src[e] (scatter to senders)
//
// A sender outside [0, TA) is an empty slot: it is never read and adds
// nothing. The window cotangent is not computed: the window is a function of
// positions only, and the training path differentiates parameters (the JAX
// package's window_grad = position_grads = False).
//
// Bound on the H100: three products of 2*B'*O*E*D*C float32 operations each
// (161 GFLOP at the training shape, B'=32, O=16, E=1024, D=256, C=200)
// against ~1.1 GB of traffic (basis in, dbasis out), so float32 arithmetic
// bounds it. The three results reduce over different axes, and Hopper's
// blocks run in no order, so where the TPU walked the o axis in sequence and
// carried dW in VMEM the port launches one SIMT tile product per reduction:
//
//   1. dbasis: a block owns 64 edges x 64 basis columns of one (b', o); its
//      A operand gxw is built on the fly from g, the gathered x and the
//      window, so gxw never reaches device memory.
//   2. dx: a block owns one (b', o) and 64 channels, walks every edge tile,
//      recomputes the per-edge kernel basis @ W in registers (as the forward
//      does) and scatters kern * win * g into a [TA, 64] slice of dx held in
//      shared memory with shared-memory atomics: no global atomics, and each
//      dx element is written once. The atomics add in no fixed order, so dx
//      may differ by an ulp from one call to the next.
//   3. dW: split-K over all B'*O*E edge rows; each block sums basis^T gxw
//      over one slice of rows into its own partial tile, and a second pass
//      adds the partials in a fixed order (deterministic).
//
// Element type T (dtype.cuh) of basis, W, x, g, dbasis and dx: float32, or
// bfloat16 on the compute_dtype="bfloat16" path. There the JAX kernel's
// rounding points hold (pallas_conv.py:331-390): gxw and kern * win * g are
// rounded to T before their products (:371, :376), every product and sum is
// float32, dbasis and dx are rounded once as they are stored, and the dW
// partials stay float32 (the wrapper rounds the sum to W's type).
//
// The fused fiber conv's backward (fiber_conv_bwd.cu, #2) calls the same
// entry point with fiber_dx = 1: its cotangent g (type G) is float32 in both
// element types, and in bfloat16 each dx term rounds the per-edge kernel and
// g to T apart and multiplies them in T (pallas_conv.py:143, :158: kern_k
// and g_o cast to bf16, their product bf16) instead of rounding the float32
// product once (:376). In float32 both roundings are the identity, and the
// flag is not read.

#include "dtype.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

// gxw[e, c] of one (b', o): the receiver cotangent times the sender's
// features and the window, rounded to T; 0 on an empty slot.
template <class T, class G>
struct EdgeCotangent {
    const G* g_bo;       // [TA, C]
    const T* x_bo;       // [TA, C]
    const int* src_b;    // [E]
    const float* win_b;  // [E]
    int TA, C;

    __device__ __forceinline__ float operator()(int e, int c) const {
        const int s = src_b[e];
        if (s < 0 || s >= TA) return 0.f;
        return round_to<T>(to_float(g_bo[(size_t)(e % TA) * C + c]) *
                           to_float(x_bo[(size_t)s * C + c]) * win_b[e]);
    }
};

template <class T, class G>
__device__ __forceinline__ EdgeCotangent<T, G> edge_cotangent(const G* g, const T* x,
                                                              const int* src, const float* win,
                                                              int bo, int O, int TA, int E,
                                                              int C) {
    const int b = bo / O;
    return {g + (size_t)bo * TA * C, x + (size_t)bo * TA * C, src + (size_t)b * E,
            win + (size_t)b * E, TA, C};
}

// 1. dbasis[b',o,e,d] = sum_c gxw[e,c] * W[d,c]
template <class T, class G>
__global__ void __launch_bounds__(THREADS)
dbasis_kernel(const T* __restrict__ w,        // [D, C]
              const T* __restrict__ x,        // [B'*O, TA, C]
              const int* __restrict__ src,    // [B', E]
              const float* __restrict__ win,  // [B', E]
              const G* __restrict__ g,        // [B'*O, TA, C]
              T* __restrict__ dbasis,         // [B'*O, E, D]
              int O, int TA, int E, int D, int C) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const int e0 = blockIdx.x * BM;
    const int d0 = blockIdx.y * BN;
    const int bo = blockIdx.z;
    const EdgeCotangent<T, G> gxw = edge_cotangent(g, x, src, win, bo, O, TA, E, C);

    float acc[TM][TN] = {};
    tile_gemm<true, false>(
        C, [&](int r, int c) { return e0 + r < E ? gxw(e0 + r, c) : 0.f; },
        [&](int c, int n) { return d0 + n < D ? to_float(w[(size_t)(d0 + n) * C + c]) : 0.f; },
        As, Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int e = e0 + ty * TM + i;
        if (e >= E) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int d = d0 + tx * TN + j;
            if (d < D) dbasis[((size_t)bo * E + e) * D + d] = from_float<T>(acc[i][j]);
        }
    }
}

// 2. dx[b',o,s,c] = sum over edges e with src[e] = s of kern[e,c] * win[e] * g[t,c]
//    (each term rounded to T; with FIBER, kern * win and g rounded apart first)
template <class T, class G, bool FIBER>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const T* __restrict__ basis,      // [B'*O, E, D]
          const T* __restrict__ w,          // [D, C]
          const int* __restrict__ src,      // [B', E]
          const float* __restrict__ win,    // [B', E]
          const G* __restrict__ g,          // [B'*O, TA, C]
          T* __restrict__ dx,               // [B'*O, TA, C]
          int O, int K, int TA, int D, int C) {
    extern __shared__ float s_dx[];  // [TA][BN]: this block's channel slice of dx
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    __shared__ int s_src[BM];
    __shared__ float s_win[BM];

    const int c0 = blockIdx.x * BN;
    const int bo = blockIdx.y;
    const int b = bo / O;
    const int E = K * TA;
    const T* basis_bo = basis + (size_t)bo * E * D;
    const G* g_bo = g + (size_t)bo * TA * C;
    const int* src_b = src + (size_t)b * E;
    const float* win_b = win + (size_t)b * E;
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    for (int i = tid; i < TA * BN; i += THREADS) s_dx[i] = 0.f;
    for (int k = 0; k < K; ++k) {
        for (int t0 = 0; t0 < TA; t0 += BM) {
            const int e0 = k * TA + t0;
            if (tid < BM) {
                const bool live = t0 + tid < TA;
                s_src[tid] = live ? src_b[e0 + tid] : -1;
                s_win[tid] = live ? win_b[e0 + tid] : 0.f;
            }
            float kern[TM][TN] = {};
            // ends with a barrier: s_dx's zeros, s_src and s_win are visible after it
            tile_gemm<true, true>(
                D, [&](int r, int d) { return t0 + r < TA ? to_float(basis_bo[(size_t)(e0 + r) * D + d]) : 0.f; },
                [&](int d, int n) { return c0 + n < C ? to_float(w[(size_t)d * C + c0 + n]) : 0.f; },
                As, Bs, kern);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const int r = ty * TM + i;
                const int s = s_src[r];
                if (s < 0 || s >= TA) continue;
                const float wv = s_win[r];
                const G* g_t = g_bo + (size_t)(t0 + r) * C;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const int n = tx * TN + j;
                    if (c0 + n >= C) continue;
                    if constexpr (FIBER)
                        atomicAdd(&s_dx[s * BN + n],
                                  round_to<T>(round_to<T>(kern[i][j] * wv) *
                                              round_to<T>(to_float(g_t[c0 + n]))));
                    else
                        atomicAdd(&s_dx[s * BN + n],
                                  round_to<T>(kern[i][j] * wv * to_float(g_t[c0 + n])));
                }
            }
            __syncthreads();  // s_src / s_win are restaged for the next tile
        }
    }
    for (int i = tid; i < TA * BN; i += THREADS) {
        const int t = i / BN, n = i % BN;
        if (c0 + n < C) dx[((size_t)bo * TA + t) * C + c0 + n] = from_float<T>(s_dx[i]);
    }
}

// 3. partial[split, d, c] = sum over this split's edge rows of basis[row, d] * gxw[row, c]
template <class T, class G>
__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const T* __restrict__ basis,      // [B'*O*E, D]
                  const T* __restrict__ x,          // [B'*O, TA, C]
                  const int* __restrict__ src,      // [B', E]
                  const float* __restrict__ win,    // [B', E]
                  const G* __restrict__ g,          // [B'*O, TA, C]
                  float* __restrict__ partial,      // [splits, D, C]
                  int O, int TA, int E, int D, int C, long long rows, int rows_per_split) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const int d0 = blockIdx.x * BM;
    const int c0 = blockIdx.y * BN;
    const long long row0 = (long long)blockIdx.z * rows_per_split;
    const long long left = rows - row0;
    const int n_rows = left < rows_per_split ? (int)left : rows_per_split;

    float acc[TM][TN] = {};
    tile_gemm<false, true>(
        n_rows,
        [&](int m, int k) {
            return d0 + m < D ? to_float(basis[(size_t)(row0 + k) * D + d0 + m]) : 0.f;
        },
        [&](int k, int n) {
            if (c0 + n >= C) return 0.f;
            const long long row = row0 + k;
            const int bo = (int)(row / E);
            return edge_cotangent(g, x, src, win, bo, O, TA, E, C)((int)(row - (long long)bo * E),
                                                                   c0 + n);
        },
        As, Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
    float* out = partial + (size_t)blockIdx.z * D * C;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int d = d0 + ty * TM + i;
        if (d >= D) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + tx * TN + j;
            if (c < C) out[(size_t)d * C + c] = acc[i][j];
        }
    }
}

// The three products and the second pass, for element type T, cotangent
// type G and dx rounding FIBER.
template <class T, class G, bool FIBER>
int spatial_conv_bwd(const T* basis, const T* w, const T* x, const int* src, const float* win,
                     const G* g, T* dbasis, float* dw, T* dx, float* partial, int Bp, int O, int K,
                     int TA, int D, int C, int splits, int rows_per_split, cudaStream_t stream) {
    const int E = K * TA;
    cudaError_t err;
    dbasis_kernel<T, G><<<dim3((E + BM - 1) / BM, (D + BN - 1) / BN, Bp * O), THREADS, 0,
                          stream>>>(w, x, src, win, g, dbasis, O, TA, E, D, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    const size_t dx_smem = (size_t)TA * BN * sizeof(float);
    if (dx_smem > 48 * 1024) {
        err = cudaFuncSetAttribute(dx_kernel<T, G, FIBER>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(dx_smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    dx_kernel<T, G, FIBER><<<dim3((C + BN - 1) / BN, Bp * O), THREADS, dx_smem, stream>>>(
        basis, w, src, win, g, dx, O, K, TA, D, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    const long long rows = (long long)Bp * O * E;
    dw_partial_kernel<T, G><<<dim3((D + BM - 1) / BM, (C + BN - 1) / BN, splits), THREADS, 0,
                              stream>>>(basis, x, src, win, g, partial, O, TA, E, D, C, rows,
                                        rows_per_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    const long long n = (long long)D * C;
    sum_splits_kernel<<<sum_splits_blocks(n), THREADS, 0, stream>>>(partial, dw, splits, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis, w, x, dbasis and dx are float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); win, partial and dw are float32. g is of the element type,
// or float32 with fiber_dx = 1 (the fused fiber conv's backward, whose dx
// terms then round as its JAX kernel's; see the header).
extern "C" int arreau_spatial_conv_bwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, const void* g,
                                       void* dbasis, float* dw, void* dx, float* partial,
                                       int Bp, int O, int K, int TA, int D, int C, int splits,
                                       int rows_per_split, int is_bf16, int fiber_dx,
                                       void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (!is_bf16)
        return spatial_conv_bwd<float, float, false>(
            static_cast<const float*>(basis), static_cast<const float*>(w),
            static_cast<const float*>(x), src, win, static_cast<const float*>(g),
            static_cast<float*>(dbasis), dw, static_cast<float*>(dx), partial, Bp, O, K, TA, D, C,
            splits, rows_per_split, stream);
    if (fiber_dx)
        return spatial_conv_bwd<bf16, float, true>(
            static_cast<const bf16*>(basis), static_cast<const bf16*>(w),
            static_cast<const bf16*>(x), src, win, static_cast<const float*>(g),
            static_cast<bf16*>(dbasis), dw, static_cast<bf16*>(dx), partial, Bp, O, K, TA, D, C,
            splits, rows_per_split, stream);
    return spatial_conv_bwd<bf16, bf16, false>(
        static_cast<const bf16*>(basis), static_cast<const bf16*>(w), static_cast<const bf16*>(x),
        src, win, static_cast<const bf16*>(g), static_cast<bf16*>(dbasis), dw,
        static_cast<bf16*>(dx), partial, Bp, O, K, TA, D, C, splits, rows_per_split, stream);
}
