// Spatial fiber-bundle convolution, forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_fwd_spatial_kernel
// and _fwd_spatial_oblk_kernel (pallas_call at :412 / :429, public entry
// fused_spatial_conv). For each super-crystal b' (T crystals, TA = T*A
// atoms), orientation o, receiver t and channel c:
//
//   out[b',o,t,c] = sum_k win[b',e] * (basis[b',o,e,:] @ W)[c] * x[b',o,src[b',e],c]
//
// with e = k*TA + t (k-major edge rows) and src the tile-local sender; a
// sender outside [0, TA) (-1 by convention) is an empty neighbour slot and
// is skipped. The TPU kernel gathered senders with a one-hot matmul; here
// the block reads them from its shared copy of x.
//
// The kernel is conv_fwd.cuh's tensor-core mainloop (bound, design, shared
// memory and registers there): each neighbour slot's per-edge kernel
// basis @ W is a D-deep mma.sync tile product, folded with the window and
// the sender's features into the output in registers, in ascending k.
//
// Element type T (dtype.cuh) of basis, W, x and out: float32 (3xTF32
// products), or bfloat16 for the compute_dtype="bfloat16" path. The JAX
// kernel's cast points hold for both: bf16 operands, float32 products and
// sums (the per-edge kernel is not rounded), one rounding as out is stored
// (pallas_conv.py:320, its out_dtype). The window stays float32.

#include "conv_fwd.cuh"
#include "dtype.cuh"
#include "tile_product.cuh"

namespace {

using namespace arreau;

template <class T>
__global__ void __launch_bounds__(CONV_THREADS, 1)
spatial_conv_fwd_kernel(Operand<T> basis, Operand<T> w, const T* __restrict__ x,
                        const int* __restrict__ src, const float* __restrict__ win,
                        T* __restrict__ out, int O, int K, int TA, int D, int C, int x_ld,
                        bool x_vec) {
    conv_fwd_block<T, T>(basis, w, x, src, win, out, O, K, TA, D, C, x_ld, x_vec);
}

template <class T>
int launch(const T* basis, const T* w, const T* x, const int* src, const float* win, T* out,
           int Bp, int O, int K, int TA, int D, int C, cudaStream_t stream) {
    size_t smem;
    int x_ld;
    conv_fwd_smem<T>(K, TA, smem, x_ld);
    cudaError_t err = allow_smem(spatial_conv_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spatial_conv_fwd_kernel<T><<<conv_fwd_grid<T>(Bp, O, TA, C), CONV_THREADS, smem, stream>>>(
        operand(basis, D), operand(w, C), x, src, win, out, O, K, TA, D, C, x_ld,
        rows_aligned(x, C));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis, w, x and out are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// win is float32.
extern "C" int arreau_spatial_conv_fwd(const void* basis, const void* w, const void* x,
                                       const int* src, const float* win, void* out, int Bp,
                                       int O, int K, int TA, int D, int C, int is_bf16,
                                       void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch<bf16>(static_cast<const bf16*>(basis), static_cast<const bf16*>(w),
                            static_cast<const bf16*>(x), src, win, static_cast<bf16*>(out), Bp, O,
                            K, TA, D, C, s);
    return launch<float>(static_cast<const float*>(basis), static_cast<const float*>(w),
                         static_cast<const float*>(x), src, win, static_cast<float*>(out), Bp, O,
                         K, TA, D, C, s);
}

extern "C" const char* arreau_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
