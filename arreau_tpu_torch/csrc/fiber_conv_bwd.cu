// Fused fiber-bundle convolution, backward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_bwd_kernel (called by
// _bwd, the VJP of fused_fiber_conv). With the forward
//
//   x_sp[b',o,t,c] = sum_k (basis[b',o,e,:] @ W)[c] * x[b',o,src[e],c],  e = k*TA + t
//   y[b',p,t,c]    = sum_o Kf[o,p,c] * x_sp[b',o,t,c]
//
// and g the cotangent of y, it returns
//
//   g_o[b',o,t,c] = sum_p g[b',p,t,c] * Kf[o,p,c]          (cotangent of x_sp)
//   dKf[o,p,c]    = sum_b' sum_t x_sp[b',o,t,c] * g[b',p,t,c]
//   dbasis, dW, dx: the spatial conv's backward for the cotangent g_o with a
//                   unit window (the window is folded into the basis here).
//
// x_sp is the forward's residual (fiber_conv.cu stores it when training); the
// TPU kernel recomputes it, which would cost one more edge product here.
//
// Bound on the H100: three products of 2*B'*O*E*D*C operations (dbasis,
// dW, dx; 146 GFLOP over the filled rows at the training shape B'=32, O=16,
// E=1024, D=256, C=200) plus 4*B'*O*P*TA*C for g_o and dKf, against ~0.5 GB
// (bfloat16) or ~1.2 GB (float32) of traffic (basis and x_sp in, dbasis
// out). The products run on the tensor cores (spatial_conv_bwd.cu): in
// bfloat16 bytes bound it; in float32 3xTF32 makes the products' rate 165
// TFLOP/s, and operations bound it.
//
// Design. One entry point makes every launch, on the caller's stream:
//   1. g_o, into a scratch [B', O, TA, C] buffer (52 MB at the training
//      shape): a thread per (b', t, c) holds g[b', :, t, c] in registers and
//      writes all O outputs, so g is read once;
//   2. dKf: per-b' partials partial[b', o, p, c] (a thread per (b', c) and
//      four orientations, its 4 x P sums over t in registers, g read once
//      for the four), then a second pass adds the B' partials in a fixed
//      order, as the TPU sums its per-b' dfk partials outside the kernel;
//   3. dbasis, dx and dW by the spatial conv backward (spatial_conv_bwd.cu)
//      for the cotangent g_o and the unit window: the edge cotangent gxw made
//      once into a scratch; mma.sync tile products with cp.async staging for
//      dbasis, for the split-K dW (a fixed-order second pass) and for the
//      per-edge kernel, whose epilogue writes the dx terms; dx as each
//      sender's terms summed in ascending e (the wrapper's sender order).
// No atomics: every result is the same bit for bit on every call.
//
// Element type T (dtype.cuh) of basis, W, x, Kf, dbasis and dx: float32, or
// bfloat16 on the compute_dtype="bfloat16" path, where the JAX kernel's
// rounding points hold (pallas_conv.py:108-161): g, x_sp, g_o and every sum
// stay float32; the spatial conv's backward gets the float32 g_o and its
// fiber rounding (fiber_dx = 1): gxw = round_T(g_o * x), and each dx term
// round_T(round_T(kern) * round_T(g_o)), kern and g_o rounded apart and
// multiplied in T (:143, :153, :158), where #4's own backward rounds the
// float32 product once (:376); dbasis and dx are rounded as stored; dW and
// dKf are float32 sums (the wrapper rounds them to the weights' type).

#include "dtype.cuh"
#include "common.cuh"

extern "C" int arreau_spatial_conv_bwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, const int* order,
                                       const int* offsets, const void* g, void* dbasis, float* dw,
                                       void* dx, void* gxw, float* partial, float* dwin,
                                       float* dwin_partial, int Bp, int O, int K, int TA, int D,
                                       int C, int splits, int rows_per_split, int is_bf16,
                                       int fiber_dx, void* stream_ptr);

namespace {

using namespace arreau;

constexpr int MAX_P = 16;  // output orientations a thread holds in registers
constexpr int DKF_THREADS = 128;

// 1. g_o[b',o,t,c] = sum_p g[b',p,t,c] * Kf[o,p,c]
template <class T>
__global__ void __launch_bounds__(THREADS)
fiber_cotangent_kernel(const float* __restrict__ g,   // [B', P, TA, C]
                       const T* __restrict__ fk,      // [O, P, C]
                       float* __restrict__ g_o,       // [B', O, TA, C]
                       int O, int P, int TA, int C, long long n) {  // n = B'*TA*C
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const int c = (int)(i % C);
        const long long b = i / ((long long)TA * C);
        const long long tc = i - b * TA * C;  // t * C + c
        const float* g_bt = g + b * P * TA * C + tc;
        float gv[MAX_P];
#pragma unroll
        for (int p = 0; p < MAX_P; ++p) gv[p] = p < P ? g_bt[(size_t)p * TA * C] : 0.f;
        for (int o = 0; o < O; ++o) {
            const T* fk_o = fk + (size_t)o * P * C + c;
            float s = 0.f;
#pragma unroll
            for (int p = 0; p < MAX_P; ++p)
                if (p < P) s = fmaf(gv[p], to_float(fk_o[(size_t)p * C]), s);
            g_o[(b * O + o) * TA * C + tc] = s;
        }
    }
}

// 2. partial[b',o,p,c] = sum_t x_sp[b',o,t,c] * g[b',p,t,c]: a thread per
// (b', c, OG orientations) keeps OG x P sums in registers (independent FMA
// chains, each over t in order) and reads g[b', :, t, c] once for all OG
constexpr int OG = 4;  // orientations a thread of the dKf pass holds
__global__ void __launch_bounds__(DKF_THREADS)
fiber_kernel_grad_partial(const float* __restrict__ x_sp,  // [B'*O, TA, C]
                          const float* __restrict__ g,     // [B', P, TA, C]
                          float* __restrict__ partial,     // [B'*O, P, C]
                          int O, int P, int TA, int C) {
    const int c = blockIdx.x * DKF_THREADS + threadIdx.x;
    const int o0 = blockIdx.y * OG, b = blockIdx.z;
    if (c >= C) return;
    const float* xs = x_sp + ((size_t)b * O + o0) * TA * C + c;
    const float* g_b = g + (size_t)b * P * TA * C + c;
    float sum[OG][MAX_P] = {};
    for (int t = 0; t < TA; ++t) {
        float gv[MAX_P], v[OG];
#pragma unroll
        for (int p = 0; p < MAX_P; ++p) gv[p] = p < P ? g_b[((size_t)p * TA + t) * C] : 0.f;
#pragma unroll
        for (int q = 0; q < OG; ++q) v[q] = o0 + q < O ? xs[((size_t)q * TA + t) * C] : 0.f;
#pragma unroll
        for (int q = 0; q < OG; ++q)
#pragma unroll
            for (int p = 0; p < MAX_P; ++p) sum[q][p] = fmaf(v[q], gv[p], sum[q][p]);
    }
#pragma unroll
    for (int q = 0; q < OG; ++q)
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
            if (o0 + q < O && p < P)
                partial[(((size_t)b * O + o0 + q) * P + p) * C + c] = sum[q][p];
}

}  // namespace

// basis, w, x, fk, dbasis, dx and the gxw scratch are float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1); g, x_sp, ones, the g_o and partial scratch, dw
// and dfk are float32; order and offsets are the spatial conv backward's
// sender order (int32).
extern "C" int arreau_fiber_conv_bwd(const void* basis, const void* w, const void* x,
                                     const int* src, const int* order, const int* offsets,
                                     const void* fk, const float* g,
                                     const float* x_sp, const float* ones, float* g_o,
                                     float* dfk_partial, float* dw_partial, void* gxw,
                                     void* dbasis,
                                     float* dw, void* dx, float* dfk, int Bp, int O, int P,
                                     int K, int TA, int D, int C, int splits, int rows_per_split,
                                     int is_bf16, void* stream_ptr) {
    if (P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int err = 0;
    const long long n_btc = (long long)Bp * TA * C;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        fiber_cotangent_kernel<T><<<sum_splits_blocks(n_btc), THREADS, 0, stream>>>(
            g, static_cast<const T*>(fk), g_o, O, P, TA, C, n_btc);
    });
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

    fiber_kernel_grad_partial<<<dim3((C + DKF_THREADS - 1) / DKF_THREADS, (O + OG - 1) / OG, Bp),
                                DKF_THREADS, 0, stream>>>(x_sp, g, dfk_partial, O, P, TA, C);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    const long long n_fk = (long long)O * P * C;
    sum_splits_kernel<<<sum_splits_blocks(n_fk), THREADS, 0, stream>>>(dfk_partial, dfk, Bp,
                                                                       n_fk);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

    return arreau_spatial_conv_bwd(basis, w, x, src, ones, order, offsets, g_o, dbasis, dw, dx,
                                   gxw, dw_partial, /*dwin=*/nullptr, /*dwin_partial=*/nullptr, Bp,
                                   O, K, TA, D, C, splits, rows_per_split, is_bf16,
                                   /*fiber_dx=*/1, stream_ptr);
}
