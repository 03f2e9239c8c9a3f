// Spatial fiber-bundle convolution, forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_fwd_spatial_kernel
// (public entry fused_spatial_conv). For each super-crystal b' (T crystals,
// TA = T*A atoms), orientation o, receiver t and channel c:
//
//   out[b',o,t,c] = sum_k win[b',e] * (basis[b',o,e,:] @ W)[c] * x[b',o,src[b',e],c]
//
// with e = k*TA + t (k-major edge rows) and src the tile-local sender; a
// sender outside [0, TA) (-1 by convention) is an empty neighbour slot and
// is skipped. The TPU kernel gathered senders with a one-hot matmul; here
// the block indexes x directly.
//
// Bound on the H100: the per-edge kernel basis @ W is 2*B'*O*E*D*C float32
// operations (13.4 GFLOP at the sampler's shape) against a 134 MB basis
// read, so the kernel is bound by float32 arithmetic, not by memory. Design:
// each block owns a 64-receiver x 64-channel tile of one (b', o) and walks
// the K neighbour slots; per slot it runs the D-deep tile product in
// registers and folds it into the output with the window and the gathered
// sender features, so the [E, C] per-edge kernel never reaches device
// memory. The reduction over k stays in registers and accumulates in float32.
//
// Element type T (dtype.cuh) of basis, W, x and out: float32, or bfloat16
// for the compute_dtype="bfloat16" path. The JAX kernel's cast points hold
// for both: bf16 operands, float32 products and sums (the per-edge kernel
// is not rounded), one rounding as out is stored (pallas_conv.py:320, its
// out_dtype). The window stays float32.

#include "dtype.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

template <class T>
__global__ void __launch_bounds__(THREADS)
spatial_conv_fwd_kernel(const T* __restrict__ basis,      // [B'*O, E, D]
                        const T* __restrict__ w,          // [D, C]
                        const T* __restrict__ x,          // [B'*O, TA, C]
                        const int* __restrict__ src,      // [B', E]
                        const float* __restrict__ win,    // [B', E]
                        T* __restrict__ out,              // [B'*O, TA, C]
                        int O, int K, int TA, int D, int C) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    __shared__ int s_src[BM];
    __shared__ float s_win[BM];

    const int t0 = blockIdx.x * BM;
    const int c0 = blockIdx.y * BN;
    const int bo = blockIdx.z;  // b' * O + o
    const int b = bo / O;
    const int E = K * TA;
    const T* basis_bo = basis + (size_t)bo * E * D;
    const T* x_bo = x + (size_t)bo * TA * C;
    const int* src_b = src + (size_t)b * E;
    const float* win_b = win + (size_t)b * E;

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    float acc[TM][TN] = {};
    for (int k = 0; k < K; ++k) {
        const int e0 = k * TA + t0;
        if (tid < BM) {
            const bool live = t0 + tid < TA;
            s_src[tid] = live ? src_b[e0 + tid] : -1;
            s_win[tid] = live ? win_b[e0 + tid] : 0.f;
        }
        float part[TM][TN] = {};
        for (int d0 = 0; d0 < D; d0 += BK) {
            for (int i = tid; i < BM * BK; i += THREADS) {
                const int r = i / BK, kk = i % BK;
                const int d = d0 + kk;
                As[kk][r] = (t0 + r < TA && d < D) ? to_float(basis_bo[(size_t)(e0 + r) * D + d]) : 0.f;
            }
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int kk = i / BN, cc = i % BN;
                const int d = d0 + kk, c = c0 + cc;
                Bs[kk][cc] = (d < D && c < C) ? to_float(w[(size_t)d * C + c]) : 0.f;
            }
            __syncthreads();
            tile_fma(As, Bs, ty, tx, part);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = ty * TM + i;
            const int s = s_src[r];
            if (s < 0 || s >= TA) continue;
            const float wv = s_win[r];
            const T* xs = x_bo + (size_t)s * C;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = c0 + tx * TN + j;
                if (c < C) acc[i][j] += wv * part[i][j] * to_float(xs[c]);
            }
        }
        __syncthreads();  // s_src / s_win are restaged by the next slot
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int t = t0 + ty * TM + i;
        if (t >= TA) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + tx * TN + j;
            if (c < C) out[((size_t)bo * TA + t) * C + c] = from_float<T>(acc[i][j]);
        }
    }
}

}  // namespace

// basis, w, x and out are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
extern "C" int arreau_spatial_conv_fwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, void* out, int Bp,
                                       int O, int K, int TA, int D, int C, int is_bf16,
                                       void* stream) {
    const dim3 grid((TA + BM - 1) / BM, (C + BN - 1) / BN, Bp * O);
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        spatial_conv_fwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(basis), static_cast<const T*>(w), static_cast<const T*>(x), src,
            win, static_cast<T*>(out), O, K, TA, D, C);
    });
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arreau_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
