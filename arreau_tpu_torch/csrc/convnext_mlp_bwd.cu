// Fused ConvNext MLP tail with the per-layer readout, backward, float32 or
// bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_bwd_kernel (the
// VJP of fused_convnext_mlp, reached through _bwd). The forward is recomputed
// (convnext_mlp.cu); with g_out and g_r the cotangents of out and r:
//
//   g_total = g_out + g_r @ Wr^T               dWr = out^T g_r, dbr = sum g_r
//   dgamma  = sum_rows g_total * m             dres = g_total (stored in T)
//   dm      = g_total * gamma                  dW2 = h^T dm,    db2 = sum dm
//   dh      = dm @ W2^T
//   dpre1   = dh * gelu'(pre1)                 dW1 = yl^T dpre1, db1 = sum dpre1
//   dyln    = dpre1 @ W1^T
//   dln_s   = sum_rows dyln * xhat             dln_b = sum_rows dyln
//   dxc     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),  dxhat = dyln * ln_s
//
// (the last line is the VJP of the fast-variance LayerNorm). Rounding points
// for T = bfloat16 (pallas_convnext.py:78-140): dm is rounded to T; dh is
// summed in float32 and rounded to T; dpre1 = dh * gelu'(pre1) is rounded to
// T; dyln, dxc and every parameter gradient are float32.
//
// Bound on the H100: about three times the forward's products, 2*M*(6*C*W
// + 2*C*R) operations (127 GFLOP at the training shape), so arithmetic
// bounds it: 0.13 ms at the bf16 tensor cores' rate. On the TPU each grid
// step held a (b', o) block and carried the parameter gradients across the
// sequential o axis. Hopper's blocks run in no order, and per-block partials
// of dW1 and dW2 would take about 1.3 GB, so the backward runs as a chain of
// launches through device-memory scratch (pre1 [M, W], yl, dm and out [M, C]
// in T: ~210 MB in bf16 at the training shape):
//
//   1. rows: a block recomputes the forward of its 64 rows (convnext_rows.cuh),
//      writing yl, pre1, the row statistics, out and, in the epilogue,
//      g_total, dres, dm and its partial column sums of g_total * m.
//   2. [dW2; db2]: split-K over the rows with A = [gelu(pre1) | 1].
//   3. dpre1: the tile product dm @ W2^T, times gelu'(pre1), over pre1 in
//      place.
//   4. [dW1; db1]: split-K with A = [yl | 1].
//   5. dxc: a block takes dyln = dpre1 @ W1^T for its 64 rows at full width,
//      so the LayerNorm VJP's row sums stay in the block (warp shuffles), and
//      writes its partial column sums of dyln * xhat and dyln.
//   6. [dWr; dbr]: split-K with A = [out | 1] and the cotangent g_r.
//   7. the per-split and per-block partials are added in a fixed order.
// No atomics: every sum has a fixed order, so the gradients are
// deterministic.

#include "convnext_rows.cuh"

namespace {

using namespace arreau;

// 1. The forward of 64 rows and the row-wise part of the backward.
template <class T>
__global__ void __launch_bounds__(THREADS)
convnext_bwd_rows_kernel(ConvNextArgs<T> a, const T* __restrict__ g_out,
                         const float* __restrict__ g_r, T* __restrict__ dres,
                         T* __restrict__ yl_s, T* __restrict__ pre1_s, T* __restrict__ dm_s,
                         T* __restrict__ out_s, float* __restrict__ stats,
                         float* __restrict__ colpart) {
    extern __shared__ __align__(16) float smem[];
    const int CP = padded_channels(a.C);
    const RowSmem sm = carve_row_smem(smem, CP);
    const long long row0 = (long long)blockIdx.x * RB;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int ct = CP / 16;

    layer_norm_rows<T>(a, row0, CP, sm.ylT, stats, stats + a.M, yl_s);
    float acc[TM][CT_MAX] = {};
    mlp_rows<T>(a, row0, CP, sm, acc, pre1_s);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < CT_MAX; ++j) {
            if (j >= ct) continue;
            const int c = tx + 16 * j;
            float dg = 0.f;
            if (row < a.M && c < a.C) {
                const size_t at = (size_t)row * a.C + c;
                float m;
                const float o = residual_out(a, row, c, acc[i][j], &m);
                float g = to_float(g_out[at]);
                if (a.wr != nullptr) {
                    out_s[at] = from_float<T>(o);
                    float gr = 0.f;
                    for (int q = 0; q < a.R; ++q)
                        gr += g_r[(size_t)row * a.R + q] * a.wr[(size_t)c * a.R + q];
                    g += gr;
                }
                dres[at] = from_float<T>(g);
                dm_s[at] = from_float<T>(g * a.gamma[c]);
                dg = g * m;
            }
            acc[i][j] = dg;
        }
    }
    // ylT is free after mlp_rows: it holds the column sums' staging
    column_sums(acc, CP, a.C, &sm.ylT[0][0], colpart + (size_t)blockIdx.x * 3 * a.C);
}

// A of [dW2; db2]: h = gelu(pre1) rounded to T.
template <class T>
struct HiddenOfPre {
    const T* pre1;  // [M, W]
    int W;
    __device__ __forceinline__ float operator()(long long row, int m) const {
        return round_to<T>(gelu(to_float(pre1[(size_t)row * W + m])));
    }
};

// A of [dW1; db1] (yl) and of [dWr; dbr] (out): a stored [M, C] tensor.
template <class T>
struct RowFeature {
    const T* v;  // [M, C]
    int C;
    __device__ __forceinline__ float operator()(long long row, int m) const {
        return to_float(v[(size_t)row * C + m]);
    }
};

// 3. dpre1[row, w] = round(round(dm[row, :] @ W2[w, :]) * gelu'(pre1[row, w])), over pre1
template <class T>
__global__ void __launch_bounds__(THREADS)
dpre1_kernel(const T* __restrict__ dm,  // [M, C]
             const T* __restrict__ w2,  // [W, C]
             T* pre1_dpre1,             // [M, W]: pre1 in, dpre1 out
             long long M, int C, int W) {
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];
    const long long row0 = (long long)blockIdx.x * BM;
    const int w0 = blockIdx.y * BN;

    float acc[TM][TN] = {};
    tile_gemm<true, false>(
        C, [&](int r, int k) { return row0 + r < M ? to_float(dm[(size_t)(row0 + r) * C + k]) : 0.f; },
        [&](int k, int n) { return w0 + n < W ? to_float(w2[(size_t)(w0 + n) * C + k]) : 0.f; },
        As, Bs, acc);

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int w = w0 + tx * TN + j;
            if (w >= W) continue;
            const size_t at = (size_t)row * W + w;
            pre1_dpre1[at] =
                from_float<T>(round_to<T>(acc[i][j]) * gelu_deriv(to_float(pre1_dpre1[at])));
        }
    }
}

// 5. dxc of 64 rows from dyln = dpre1 @ W1^T, and the block's partial column
//    sums of dyln * xhat (dln_s) and dyln (dln_b).
template <class T>
__global__ void __launch_bounds__(THREADS)
dxc_kernel(const float* __restrict__ xc,     // [M, C]
           const float* __restrict__ ln_s,   // [C]
           const T* __restrict__ dpre1,      // [M, W]
           const T* __restrict__ w1,         // [C, W]
           const float* __restrict__ stats,  // [2, M]: mean, 1/std
           float* __restrict__ dxc,          // [M, C]
           float* __restrict__ colpart,      // [blocks, 3, C]
           long long M, int C, int W) {
    extern __shared__ __align__(16) float smem[];
    const int CP = padded_channels(C);
    float (*As)[AS_LD] = reinterpret_cast<float (*)[AS_LD]>(smem);
    float* Bw = smem + BK * AS_LD;
    float* red = Bw + BK * CP;
    const long long row0 = (long long)blockIdx.x * RB;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int ct = CP / 16;

    float acc[TM][CT_MAX] = {};  // dyln: 0 on rows >= M and columns >= C
    rows_product(
        W,
        CP, [&](int r, int k) { return row0 + r < M ? to_float(dpre1[(size_t)(row0 + r) * W + k]) : 0.f; },
        [&](int k, int c) { return c < C ? to_float(w1[(size_t)c * W + k]) : 0.f; }, As, Bw, acc);
    float* part = colpart + (size_t)blockIdx.x * 3 * C;
    column_sums(acc, CP, C, red, part + 2 * C);  // dln_b

    float mu[TM], rstd[TM], s1[TM], s2[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        const bool live = row < M;
        mu[i] = live ? stats[row] : 0.f;
        rstd[i] = live ? stats[M + row] : 0.f;
        s1[i] = s2[i] = 0.f;
#pragma unroll
        for (int j = 0; j < CT_MAX; ++j) {
            const int c = tx + 16 * j;
            if (j >= ct || !live || c >= C) continue;
            const float xhat = (xc[(size_t)row * C + c] - mu[i]) * rstd[i];
            const float dxhat = acc[i][j] * ln_s[c];
            s1[i] += dxhat;
            s2[i] += dxhat * xhat;
        }
        // the row's 16 threads are lanes of one half-warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
            s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
            s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long row = row0 + ty * TM + i;
        const bool live = row < M;
#pragma unroll
        for (int j = 0; j < CT_MAX; ++j) {
            const int c = tx + 16 * j;
            if (j >= ct) continue;
            float v = 0.f;
            if (live && c < C) {
                const float xhat = (xc[(size_t)row * C + c] - mu[i]) * rstd[i];
                const float dxhat = acc[i][j] * ln_s[c];
                dxc[(size_t)row * C + c] =
                    rstd[i] * (dxhat - s1[i] / C - xhat * (s2[i] / C));
                v = acc[i][j] * xhat;
            }
            acc[i][j] = v;
        }
    }
    column_sums(acc, CP, C, red, part + C);  // dln_s
}

template <class T>
int convnext_mlp_bwd(const ConvNextArgs<T>& a, const T* g_out, const float* g_r, float* dxc,
                     T* dres, float* dw1_ext, float* dw2_ext, float* dwr_ext, float* colsum,
                     T* yl_s, T* pre1_s, T* dm_s, T* out_s, float* stats, float* colpart,
                     float* partial, int splits, int rows_per_split, cudaStream_t stream) {
    const int CP = padded_channels(a.C);
    const unsigned blocks = static_cast<unsigned>((a.M + RB - 1) / RB);
    cudaError_t err;

    const size_t rows_smem = row_block_smem_floats(CP) * sizeof(float);
    err = cudaFuncSetAttribute(convnext_bwd_rows_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(rows_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    convnext_bwd_rows_kernel<T><<<blocks, THREADS, rows_smem, stream>>>(
        a, g_out, g_r, dres, yl_s, pre1_s, dm_s, out_s, stats, colpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    weight_grad_partial_kernel<<<dim3((a.W + 1 + BM - 1) / BM, (a.C + BN - 1) / BN, splits),
                                 THREADS, 0, stream>>>(HiddenOfPre<T>{pre1_s, a.W}, dm_s, partial,
                                                       a.M, a.W, a.C, rows_per_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n2 = (long long)(a.W + 1) * a.C;
    sum_splits_kernel<<<sum_splits_blocks(n2), THREADS, 0, stream>>>(partial, dw2_ext, splits, n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    dpre1_kernel<T><<<dim3(blocks, (a.W + BN - 1) / BN), THREADS, 0, stream>>>(dm_s, a.w2, pre1_s,
                                                                                a.M, a.C, a.W);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    weight_grad_partial_kernel<<<dim3((a.C + 1 + BM - 1) / BM, (a.W + BN - 1) / BN, splits),
                                 THREADS, 0, stream>>>(RowFeature<T>{yl_s, a.C}, pre1_s, partial,
                                                       a.M, a.C, a.W, rows_per_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n1 = (long long)(a.C + 1) * a.W;
    sum_splits_kernel<<<sum_splits_blocks(n1), THREADS, 0, stream>>>(partial, dw1_ext, splits, n1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    const size_t dxc_smem = ((size_t)BK * AS_LD + 2 * (size_t)BK * CP) * sizeof(float);
    if (dxc_smem > 48 * 1024) {
        err = cudaFuncSetAttribute(dxc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(dxc_smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    dxc_kernel<T><<<blocks, THREADS, dxc_smem, stream>>>(a.xc, a.ln_s, pre1_s, a.w1, stats, dxc,
                                                        colpart, a.M, a.C, a.W);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    if (a.wr != nullptr) {
        weight_grad_partial_kernel<<<dim3((a.C + 1 + BM - 1) / BM, (a.R + BN - 1) / BN, splits),
                                     THREADS, 0, stream>>>(RowFeature<T>{out_s, a.C}, g_r,
                                                           partial, a.M, a.C, a.R,
                                                           rows_per_split);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        const long long nr = (long long)(a.C + 1) * a.R;
        sum_splits_kernel<<<sum_splits_blocks(nr), THREADS, 0, stream>>>(partial, dwr_ext, splits,
                                                                          nr);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    const long long nc = 3LL * a.C;
    sum_splits_kernel<<<sum_splits_blocks(nc), THREADS, 0, stream>>>(colpart, colsum,
                                                                      static_cast<int>(blocks), nc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as arreau_convnext_mlp_fwd, with g_out [M, C] (T) and g_r [M, R]
// (float32; null without a readout). Outputs: dxc [M, C] float32, dres
// [M, C] T, dw1_ext [C+1, W] = [dW1; db1], dw2_ext [W+1, C] = [dW2; db2],
// dwr_ext [C+1, R] = [dWr; dbr] (unused without a readout) and colsum [3, C]
// = (dgamma, dln_s, dln_b), all float32. Scratch: yl, dm and out [M, C] in T
// (out unused without a readout), pre1 [M, W] in T, stats [2, M], colpart
// [ceil(M/64), 3, C] and partial [splits * max((W+1)*C, (C+1)*W, (C+1)*R)]
// float32.
extern "C" int arreau_convnext_mlp_bwd(
    const float* xc, const void* res, const float* ln_s, const float* ln_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const float* gamma, const float* wr,
    const float* br, const void* g_out, const float* g_r, float* dxc, void* dres, float* dw1_ext,
    float* dw2_ext, float* dwr_ext, float* colsum, void* yl_s, void* pre1_s, void* dm_s,
    void* out_s, float* stats, float* colpart, float* partial, int M, int C, int W, int R,
    int splits, int rows_per_split, int is_bf16, void* stream_ptr) {
    if (C < 1 || C > 16 * CT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
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
        status = convnext_mlp_bwd<T>(a, static_cast<const T*>(g_out), g_r, dxc,
                                     static_cast<T*>(dres), dw1_ext, dw2_ext, dwr_ext, colsum,
                                     static_cast<T*>(yl_s), static_cast<T*>(pre1_s),
                                     static_cast<T*>(dm_s), static_cast<T*>(out_s), stats,
                                     colpart, partial, splits, rows_per_split, stream);
    });
    return status;
}
