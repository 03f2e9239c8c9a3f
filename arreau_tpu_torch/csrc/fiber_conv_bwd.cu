// Fused fiber-bundle convolution, backward, float32, for sm_90a.
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
// Bound on the H100: three products of 2*B'*O*E*D*C float32 operations
// (dbasis, dW, dx; 146 GFLOP over the filled rows at the training shape
// B'=32, O=16, E=1024, D=256, C=200) plus 4*B'*O*P*TA*C for g_o and dKf,
// against ~1.2 GB of traffic (basis and x_sp in, dbasis out): float32
// arithmetic bounds it.
//
// Design. One entry point makes every launch, on the caller's stream:
//   1. g_o, into a scratch [B', O, TA, C] buffer (52 MB at the training
//      shape): a thread per (b', t, c) holds g[b', :, t, c] in registers and
//      writes all O outputs, so g is read once;
//   2. dKf: per-b' partials partial[b', o, p, c] (a thread per (b', o, c),
//      its P sums over t in registers), then a second pass adds the B'
//      partials in a fixed order, as the TPU sums its per-b' dfk partials
//      outside the kernel;
//   3. dbasis, dx and dW by the spatial conv backward (spatial_conv_bwd.cu)
//      for the cotangent g_o and the unit window: its dbasis tile product,
//      its shared-memory dx scatter and its split-K dW with a fixed-order
//      second pass.
// No global atomics. Every result but dx is deterministic; dx's
// shared-memory scatter adds in no fixed order, so it may differ by an ulp
// from one call to the next.

#include "tile_gemm.cuh"

extern "C" int arreau_spatial_conv_bwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, const void* g,
                                       void* dbasis, float* dw, void* dx, float* partial,
                                       int Bp, int O, int K, int TA, int D, int C, int splits,
                                       int rows_per_split, int is_bf16, void* stream_ptr);

namespace {

using namespace arreau;

constexpr int MAX_P = 16;  // output orientations a thread holds in registers

// 1. g_o[b',o,t,c] = sum_p g[b',p,t,c] * Kf[o,p,c]
__global__ void __launch_bounds__(THREADS)
fiber_cotangent_kernel(const float* __restrict__ g,   // [B', P, TA, C]
                       const float* __restrict__ fk,  // [O, P, C]
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
            const float* fk_o = fk + (size_t)o * P * C + c;
            float s = 0.f;
#pragma unroll
            for (int p = 0; p < MAX_P; ++p)
                if (p < P) s = fmaf(gv[p], fk_o[(size_t)p * C], s);
            g_o[(b * O + o) * TA * C + tc] = s;
        }
    }
}

// 2. partial[b',o,p,c] = sum_t x_sp[b',o,t,c] * g[b',p,t,c]: a thread per
// (b', o, c) keeps the P sums in registers (independent FMA chains) and reads
// its x_sp column once
__global__ void __launch_bounds__(THREADS)
fiber_kernel_grad_partial(const float* __restrict__ x_sp,  // [B'*O, TA, C]
                          const float* __restrict__ g,     // [B', P, TA, C]
                          float* __restrict__ partial,     // [B'*O, P, C]
                          int O, int P, int TA, int C) {
    const int c = blockIdx.x * THREADS + threadIdx.x;
    const int bo = blockIdx.y;
    if (c >= C) return;
    const int b = bo / O;
    const float* xs = x_sp + (size_t)bo * TA * C + c;
    const float* g_b = g + (size_t)b * P * TA * C + c;
    float sum[MAX_P] = {};
    for (int t = 0; t < TA; ++t) {
        const float v = xs[(size_t)t * C];
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
            if (p < P) sum[p] = fmaf(v, g_b[((size_t)p * TA + t) * C], sum[p]);
    }
#pragma unroll
    for (int p = 0; p < MAX_P; ++p)
        if (p < P) partial[((size_t)bo * P + p) * C + c] = sum[p];
}

}  // namespace

extern "C" int arreau_fiber_conv_bwd(const float* basis, const float* w, const float* x,
                                     const int* src, const float* fk, const float* g,
                                     const float* x_sp, const float* ones, float* g_o,
                                     float* dfk_partial, float* dw_partial, float* dbasis,
                                     float* dw, float* dx, float* dfk, int Bp, int O, int P,
                                     int K, int TA, int D, int C, int splits, int rows_per_split,
                                     void* stream_ptr) {
    if (P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int err;
    const long long n_btc = (long long)Bp * TA * C;
    fiber_cotangent_kernel<<<sum_splits_blocks(n_btc), THREADS, 0, stream>>>(g, fk, g_o, O, P,
                                                                             TA, C, n_btc);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

    fiber_kernel_grad_partial<<<dim3((C + THREADS - 1) / THREADS, Bp * O), THREADS, 0, stream>>>(
        x_sp, g, dfk_partial, O, P, TA, C);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    const long long n_fk = (long long)O * P * C;
    sum_splits_kernel<<<sum_splits_blocks(n_fk), THREADS, 0, stream>>>(dfk_partial, dfk, Bp,
                                                                       n_fk);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

    return arreau_spatial_conv_bwd(basis, w, x, src, ones, g_o, dbasis, dw, dx, dw_partial, Bp,
                                   O, K, TA, D, C, splits, rows_per_split, /*is_bf16=*/0,
                                   stream_ptr);
}
