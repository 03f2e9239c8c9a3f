// Fused ConvNext MLP tail with the per-layer readout, forward, float32 or
// bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_fwd_kernel (the
// forward of fused_convnext_mlp, reached through _fwd). For each row (one
// (b', o, t) position) of the conv output xc and the residual res:
//
//   yl  = LayerNorm(xc) (scale ln_s, bias ln_b)
//   m   = gelu(yl @ W1 + b1) @ W2 + b2          (C -> W = 4C -> C)
//   out = res + gamma * m
//   r   = out @ Wr + br                          (optional readout, float32)
//
// with the JAX kernel's rounding points for the element type T (see
// convnext_rows.cuh). out is stored in T, r in float32.
//
// Bound on the H100: 2*M*(2*C*W + C*R) operations (42.4 GFLOP at the
// training shape, M = 65536 rows, C = 200, W = 800, R = 19) against ~110 MB
// of traffic (xc, res and out, r), so arithmetic bounds it: 0.043 ms at
// the 989 TFLOP/s of the bf16 tensor cores. Design: rows are independent,
// so a block owns 64 rows and their whole channel width (convnext_rows.cuh):
// LayerNorm into shared memory, then the hidden width in chunks of 64, each
// chunk's activations formed in shared memory and folded into m's float32
// accumulator at once, so neither pre1 nor h reaches device memory. The two
// products run as float32 SIMT tile products (the tensor cores are left to
// a later change). The readout takes out from shared memory in the epilogue.

#include "convnext_rows.cuh"

namespace {

using namespace arreau;

template <class T>
__global__ void __launch_bounds__(THREADS)
convnext_fwd_kernel(ConvNextArgs<T> a, T* __restrict__ out, float* __restrict__ r_out) {
    extern __shared__ __align__(16) float smem[];
    const int CP = padded_channels(a.C);
    const RowSmem sm = carve_row_smem(smem, CP);
    const long long row0 = (long long)blockIdx.x * RB;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int ct = CP / 16;

    layer_norm_rows<T>(a, row0, CP, sm.ylT, nullptr, nullptr, nullptr);
    float acc[TM][CT_MAX] = {};
    mlp_rows<T>(a, row0, CP, sm, acc, nullptr);

    float (*outT)[AS_LD] = sm.ylT;  // ylT is free after mlp_rows: out, k-major, for the readout
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const long long row = row0 + r;
#pragma unroll
        for (int j = 0; j < CT_MAX; ++j) {
            if (j >= ct) continue;
            const int c = tx + 16 * j;
            float o = 0.f;
            if (row < a.M && c < a.C) {
                float m;
                o = residual_out(a, row, c, acc[i][j], &m);
                out[(size_t)row * a.C + c] = from_float<T>(o);
            }
            outT[c][r] = o;
        }
    }
    if (r_out == nullptr) return;
    __syncthreads();
    for (int idx = tid; idx < RB * a.R; idx += THREADS) {
        const int r = idx % RB, q = idx / RB;
        const long long row = row0 + r;
        if (row >= a.M) continue;
        float s = 0.f;
        for (int c = 0; c < a.C; ++c) s += outT[c][r] * a.wr[(size_t)c * a.R + q];
        r_out[(size_t)row * a.R + q] = s + a.br[q];
    }
}

}  // namespace

// xc [M, C], ln_s, ln_b, gamma [C] float32; res [M, C], w1 [C, W], b1 [W],
// w2 [W, C], b2 [C] and out [M, C] float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); wr [C, R], br [R] and r [M, R] float32, or all three null
// (no readout). C <= 256.
extern "C" int arreau_convnext_mlp_fwd(const float* xc, const void* res, const float* ln_s,
                                       const float* ln_b, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const float* gamma,
                                       const float* wr, const float* br, void* out, float* r,
                                       int M, int C, int W, int R, int is_bf16,
                                       void* stream_ptr) {
    if (C < 1 || C > 16 * CT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const size_t smem = row_block_smem_floats(padded_channels(C)) * sizeof(float);
    const unsigned blocks = static_cast<unsigned>((M + RB - 1) / RB);
    cudaError_t err = cudaSuccess;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        err = cudaFuncSetAttribute(convnext_fwd_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const ConvNextArgs<T> a{xc,
                                static_cast<const T*>(res),
                                ln_s,
                                ln_b,
                                static_cast<const T*>(w1),
                                static_cast<const T*>(b1),
                                static_cast<const T*>(w2),
                                static_cast<const T*>(b2),
                                gamma,
                                wr,
                                br,
                                M,
                                C,
                                W,
                                wr != nullptr ? R : 0};
        convnext_fwd_kernel<T><<<blocks, THREADS, smem, stream>>>(a, static_cast<T*>(out), r);
    });
    return static_cast<int>(cudaGetLastError());
}
