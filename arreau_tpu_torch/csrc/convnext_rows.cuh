// Row blocks of the fused ConvNext MLP (csrc/convnext_mlp.cu, #9, and
// csrc/convnext_mlp_bwd.cu, #10): the pieces both kernels run on a block of
// 64 rows (one row = one (b', o, t) position, C channels wide).
//
// A block of 256 threads owns 64 rows and every one of their C <= 256
// channels. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + i
// (i < 4) and, in a full-width product, the columns tx + 16*j (j < C/16
// rounded up), so neighbouring threads touch neighbouring channels; in a
// 64-wide chunk product it owns the 4 x 4 sub-tile of tile_fma.
//
// The forward of a row block keeps the MLP's widened activations out of
// device memory: the LayerNorm output yl stays in shared memory (k-major,
// as tile_fma's A operand), the hidden width W is walked in chunks of 64,
// each chunk's h = gelu(yl @ W1 + b1) is formed in shared memory and
// folded at once into the float32 accumulator of m = h @ W2.
//
// Rounding points (pallas_convnext.py:_forward_block): LayerNorm in float32
// with the fast variance and eps 1e-5; yl rounded to T; pre1 = yl @ W1 + b1
// summed in float32 and rounded once to T; h = gelu(pre1) rounded to T (the
// JAX kernel evaluates gelu in T); m = h @ W2 + b2 summed in float32 and
// rounded once; out = res + gamma * m with gamma rounded to T and every
// step rounded to T. For T = float all of that is plain float32.
#pragma once

#include "dtype.cuh"
#include "tile_gemm.cuh"

namespace arreau {

constexpr int RB = BM;        // rows per block
constexpr int CT_MAX = 16;    // full-width columns per thread: C <= 16 * CT_MAX
constexpr int WC = BN;        // hidden units per chunk
constexpr float CONVNEXT_LN_EPS = 1e-5f;

template <class T>
struct ConvNextArgs {
    const float* xc;     // [M, C] conv output
    const T* res;        // [M, C] residual
    const float* ln_s;   // [C]
    const float* ln_b;   // [C]
    const T* w1;         // [C, W]
    const T* b1;         // [W]
    const T* w2;         // [W, C]
    const T* b2;         // [C]
    const float* gamma;  // [C] layer scale
    const float* wr;     // [C, R] readout, or null
    const float* br;     // [R]
    long long M;
    int C, W, R;
};

// Columns of a full-width product: C rounded up to a multiple of 16.
__host__ __device__ inline int padded_channels(int C) { return (C + 15) / 16 * 16; }

// Shared memory of a forward row block, in floats, carved from dynamic
// shared memory in this order.
__host__ __device__ inline size_t row_block_smem_floats(int CP) {
    return (size_t)CP * AS_LD + BK * BN + WC * AS_LD + BK * AS_LD + (size_t)BK * CP;
}

struct RowSmem {
    float (*ylT)[AS_LD];  // [CP][AS_LD] the block's LayerNorm output, k-major
    float (*Bs)[BN];      // [BK][BN] a slice of W1's chunk
    float (*hT)[AS_LD];   // [WC][AS_LD] the chunk's h, k-major
    float (*As)[AS_LD];   // [BK][AS_LD] the A slice of rows_product
    float* Bw;            // [BK][CP] the B slice of rows_product
};

__device__ inline RowSmem carve_row_smem(float* base, int CP) {
    RowSmem s;
    s.ylT = reinterpret_cast<float (*)[AS_LD]>(base);
    base += (size_t)CP * AS_LD;
    s.Bs = reinterpret_cast<float (*)[BN]>(base);
    base += BK * BN;
    s.hT = reinterpret_cast<float (*)[AS_LD]>(base);
    base += WC * AS_LD;
    s.As = reinterpret_cast<float (*)[AS_LD]>(base);
    base += BK * AS_LD;
    s.Bw = base;
    return s;
}

// acc[i][j] += sum_{k < K} A(r, k) * B(k, c) for the block's rows r = ty*4 + i
// and columns c = tx + 16*j < CP, staged BK deep (A transposed into As, B
// into Bw; load_b returns 0 for c >= C). Ends with a __syncthreads().
template <class LoadA, class LoadB>
__device__ __forceinline__ void rows_product(int K, int CP, LoadA load_a, LoadB load_b,
                                             float (*As)[AS_LD], float* Bw,
                                             float acc[TM][CT_MAX]) {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int ct = CP / 16;
    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < RB * BK; i += THREADS) {
            const int r = i / BK, kk = i % BK;
            As[kk][r] = k0 + kk < K ? load_a(r, k0 + kk) : 0.f;
        }
        for (int i = tid; i < BK * CP; i += THREADS) {
            const int kk = i / CP, c = i % CP;
            Bw[i] = k0 + kk < K ? load_b(k0 + kk, c) : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int j = 0; j < CT_MAX; ++j) {
                if (j < ct) {
                    const float b = Bw[kk * CP + tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
                }
            }
        }
        __syncthreads();
    }
}

// out[c] = sum over the block's rows of v[i][j] (c = tx + 16*j < C), added in
// a fixed order through red [16][CP] of shared memory.
__device__ __forceinline__ void column_sums(const float v[TM][CT_MAX], int CP, int C, float* red,
                                            float* out) {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int ct = CP / 16;
#pragma unroll
    for (int j = 0; j < CT_MAX; ++j)
        if (j < ct) red[ty * CP + tx + 16 * j] = v[0][j] + v[1][j] + v[2][j] + v[3][j];
    __syncthreads();
    for (int c = tid; c < C; c += THREADS) {
        float s = 0.f;
        for (int q = 0; q < 16; ++q) s += red[q * CP + c];
        out[c] = s;
    }
    __syncthreads();
}

// LayerNorm of the block's rows into ylT (rounded to T; 0 on rows >= M and
// columns >= C), four threads a row. Where given, each row's mean and 1/std
// go to mean_out / rstd_out and yl to yl_out [M, C]. Ends with a barrier.
template <class T>
__device__ __forceinline__ void layer_norm_rows(const ConvNextArgs<T>& a, long long row0, int CP,
                                                float (*ylT)[AS_LD], float* mean_out,
                                                float* rstd_out, T* yl_out) {
    const int tid = threadIdx.x;
    const int r = tid / 4, q = tid % 4;
    const long long row = row0 + r;
    const bool live = row < a.M;
    const float* xr = a.xc + (size_t)row * a.C;
    float s = 0.f, ss = 0.f;
    if (live) {
        for (int c = q; c < a.C; c += 4) {
            const float v = xr[c];
            s += v;
            ss += v * v;
        }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float mu = s / a.C;
    const float rstd = rsqrtf(fmaxf(ss / a.C - mu * mu, 0.f) + CONVNEXT_LN_EPS);
    for (int c = q; c < CP; c += 4) {
        float y = 0.f;
        if (live && c < a.C) {
            y = round_to<T>((xr[c] - mu) * rstd * a.ln_s[c] + a.ln_b[c]);
            if (yl_out != nullptr) yl_out[(size_t)row * a.C + c] = from_float<T>(y);
        }
        ylT[c][r] = y;
    }
    if (live && q == 0 && mean_out != nullptr) {
        mean_out[row] = mu;
        rstd_out[row] = rstd;
    }
    __syncthreads();
}

// acc[i][j] += m[r, c] = sum_w h[r, w] * W2[w, c] over every hidden chunk
// (without b2), h = gelu(pre1) and pre1 = yl @ W1 + b1 at the rounding points
// above; where given, pre1 [M, W] is written out. Reads ylT; ends with a
// barrier, after which ylT is free.
template <class T>
__device__ __forceinline__ void mlp_rows(const ConvNextArgs<T>& a, long long row0, int CP,
                                         const RowSmem& sm, float acc[TM][CT_MAX], T* pre1_out) {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    for (int w0 = 0; w0 < a.W; w0 += WC) {
        float h_acc[TM][TN] = {};
        for (int k0 = 0; k0 < CP; k0 += BK) {
            for (int i = tid; i < BK * BN; i += THREADS) {
                const int kk = i / BN, n = i % BN;
                const int k = k0 + kk, w = w0 + n;
                sm.Bs[kk][n] = (k < a.C && w < a.W) ? to_float(a.w1[(size_t)k * a.W + w]) : 0.f;
            }
            __syncthreads();
            tile_fma(sm.ylT + k0, sm.Bs, ty, tx, h_acc);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = ty * TM + i;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int n = tx * TN + j, w = w0 + n;
                float h = 0.f;
                if (w < a.W) {
                    const float pre = round_to<T>(h_acc[i][j] + to_float(a.b1[w]));
                    if (pre1_out != nullptr && row0 + r < a.M)
                        pre1_out[(size_t)(row0 + r) * a.W + w] = from_float<T>(pre);
                    h = round_to<T>(gelu(pre));
                }
                sm.hT[n][r] = h;
            }
        }
        __syncthreads();
        rows_product(
            WC, CP, [&](int r, int k) { return sm.hT[k][r]; },
            [&](int k, int c) {
                const int w = w0 + k;
                return (w < a.W && c < a.C) ? to_float(a.w2[(size_t)w * a.C + c]) : 0.f;
            },
            sm.As, sm.Bw, acc);
    }
}

// out = res + gamma * (m + b2) at the rounding points above, for one row and
// channel, given the float32 sum m.
template <class T>
__device__ __forceinline__ float residual_out(const ConvNextArgs<T>& a, long long row, int c,
                                              float m_sum, float* m_out) {
    const float m = round_to<T>(m_sum + to_float(a.b2[c]));
    *m_out = m;
    return round_to<T>(to_float(a.res[(size_t)row * a.C + c]) +
                       round_to<T>(round_to<T>(a.gamma[c]) * m));
}

}  // namespace arreau
