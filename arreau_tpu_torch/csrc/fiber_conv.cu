// Fused fiber-bundle convolution (spatial conv, sum over the K neighbour
// slots, fiber mixing), forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_fwd_kernel (called by
// _fwd, public entry fused_fiber_conv). For each super-crystal b' (TA atoms),
// output orientation p, receiver t and channel c:
//
//   x_sp[b',o,t,c] = sum_k (basis[b',o,e,:] @ W)[c] * x[b',o,src[b',e],c]
//   y[b',p,t,c]    = sum_o Kf[o,p,c] * x_sp[b',o,t,c]
//
// with e = k*TA + t (k-major edge rows), the window already folded into the
// basis and Kf pre-scaled by 1/O. A sender outside [0, TA) (-1 by convention)
// is an empty neighbour slot and is skipped.
//
// Bound on the H100: the per-edge kernel basis @ W is 2*B'*O*E*D*C
// operations (53.7 GFLOP over all edge slots at the training shape B'=32,
// O=16, E=1024, D=256, C=200) against a 268 MB (bf16) / 537 MB (float32)
// basis read; the fiber mixing adds 2*B'*O*P*TA*C (0.4 GFLOP) and moves
// x_sp in and y out (52 MB each).
//
// Design, two launches on the caller's stream:
//   1. the spatial conv x_sp, windowless, into a float32 [B', O, TA, C]
//      buffer: conv_fwd.cuh's tensor-core mainloop (mma.sync products, bf16
//      or 3xTF32; the slots folded in registers in ascending k), the same
//      one #3 runs. The TPU carried y across a sequential o grid axis in
//      VMEM; Hopper's blocks run in no order, and P = 16 outputs for every
//      accumulator element do not fit in registers, so x_sp reaches device
//      memory: always (the wrapper passes a scratch buffer when nothing is
//      trained), and when training it is the backward's residual.
//   2. the fiber mixing: a block stages Kf[:, :, 32 channels] as float in
//      shared memory (32 KB at O = P = 16); a thread holds one channel of
//      4 receivers' x_sp for every o in registers and sums y over o in
//      ascending order (fmaf from 0), in float32: each Kf value read from
//      shared memory serves 4 outputs. Bound by its 104 MB of traffic.
// Every output is the same bit for bit on every call.
//
// Element type T (dtype.cuh) of basis, W, x and Kf: float32, or bfloat16 on
// the compute_dtype="bfloat16" path. y and x_sp stay float32 in both, as in
// the JAX kernel (pallas_conv.py:82-105: every product and sum float32,
// nothing rounded in between).

#include "conv_fwd.cuh"
#include "dtype.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

constexpr int MAX_O = 16;  // input orientations whose x_sp a mixing thread holds
constexpr int MAX_P = 16;
constexpr int MIX_COLS = 32;                                // channels per mixing block
constexpr int MIX_ROWS = 4;                                 // receivers per thread
constexpr int MIX_THREADS = 256;
constexpr int MIX_T = MIX_THREADS / MIX_COLS * MIX_ROWS;    // receivers per block (32)

template <class T>
__global__ void __launch_bounds__(CONV_THREADS, 1)
fiber_spatial_kernel(Operand<T> basis, Operand<T> w, const T* __restrict__ x,
                     const int* __restrict__ src, float* __restrict__ x_sp, int O, int K, int TA,
                     int D, int C, int x_ld, bool x_vec) {
    conv_fwd_block<T, float>(basis, w, x, src, nullptr, x_sp, O, K, TA, D, C, x_ld, x_vec);
}

// y[b',p,t,c] = sum_o Kf[o,p,c] * x_sp[b',o,t,c], ascending o, float32
template <class T>
__global__ void __launch_bounds__(MIX_THREADS)
fiber_mix_kernel(const float* __restrict__ x_sp,  // [B', O, TA, C]
                 const T* __restrict__ fk,        // [O, P, C]
                 float* __restrict__ y,           // [B', P, TA, C]
                 int O, int P, int TA, int C) {
    __shared__ float kf[MAX_O * MAX_P][MIX_COLS];
    const int c0 = blockIdx.x * MIX_COLS, b = blockIdx.z;
    for (int i = threadIdx.x; i < O * P * MIX_COLS; i += MIX_THREADS) {
        const int c = c0 + i % MIX_COLS;
        kf[i / MIX_COLS][i % MIX_COLS] = c < C ? to_float(fk[(size_t)(i / MIX_COLS) * C + c]) : 0.f;
    }
    __syncthreads();
    const int col = threadIdx.x % MIX_COLS, c = c0 + col;
    const int t0 = blockIdx.y * MIX_T + threadIdx.x / MIX_COLS * MIX_ROWS;
    if (c >= C) return;
    float xv[MAX_O][MIX_ROWS];
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
        if (o >= O) break;
        const float* xo = x_sp + (((size_t)b * O + o) * TA) * C + c;
#pragma unroll
        for (int r = 0; r < MIX_ROWS; ++r) xv[o][r] = t0 + r < TA ? xo[(size_t)(t0 + r) * C] : 0.f;
    }
    for (int p = 0; p < P; ++p) {
        float acc[MIX_ROWS] = {};
#pragma unroll
        for (int o = 0; o < MAX_O; ++o) {
            if (o >= O) break;
            const float k = kf[o * P + p][col];
#pragma unroll
            for (int r = 0; r < MIX_ROWS; ++r) acc[r] = fmaf(k, xv[o][r], acc[r]);
        }
        float* yp = y + (((size_t)b * P + p) * TA) * C + c;
#pragma unroll
        for (int r = 0; r < MIX_ROWS; ++r)
            if (t0 + r < TA) yp[(size_t)(t0 + r) * C] = acc[r];
    }
}

template <class T>
int launch(const T* basis, const T* w, const T* x, const int* src, const T* fk, float* y,
           float* x_sp, int Bp, int O, int P, int K, int TA, int D, int C, cudaStream_t stream) {
    if (O > MAX_O || P > MAX_P || x_sp == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    size_t smem;
    int x_ld;
    conv_fwd_smem<T>(K, TA, smem, x_ld);
    cudaError_t err = allow_smem(fiber_spatial_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fiber_spatial_kernel<T><<<conv_fwd_grid<T>(Bp, O, TA, C), CONV_THREADS, smem, stream>>>(
        operand(basis, D), operand(w, C), x, src, x_sp, O, K, TA, D, C, x_ld, rows_aligned(x, C));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fiber_mix_kernel<T><<<dim3((C + MIX_COLS - 1) / MIX_COLS, (TA + MIX_T - 1) / MIX_T, Bp),
                          MIX_THREADS, 0, stream>>>(x_sp, fk, y, O, P, TA, C);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis, w, x and fk are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); y
// and x_sp (a [B', O, TA, C] buffer that receives the spatial conv, always)
// are float32. O <= 16, P <= 16.
extern "C" int arreau_fiber_conv_fwd(const void* basis, const void* w, const void* x,
                                     const int* src, const void* fk, float* y, float* x_sp,
                                     int Bp, int O, int P, int K, int TA, int D, int C,
                                     int is_bf16, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (is_bf16)
        return launch<bf16>(static_cast<const bf16*>(basis), static_cast<const bf16*>(w),
                            static_cast<const bf16*>(x), src, static_cast<const bf16*>(fk), y,
                            x_sp, Bp, O, P, K, TA, D, C, stream);
    return launch<float>(static_cast<const float*>(basis), static_cast<const float*>(w),
                         static_cast<const float*>(x), src, static_cast<const float*>(fk), y, x_sp,
                         Bp, O, P, K, TA, D, C, stream);
}
