// Row blocks of the fused ConvNext MLP in float32 (csrc/convnext_mlp.cu, #9,
// and the rows pass of csrc/convnext_mlp_bwd.cu, #10; bfloat16 runs
// convnext_sm90.cuh's wgmma kernels): a block owns RB = 64 rows (one row =
// one (b', o, t) position) and every one of their C <= 256 channels, which
// LayerNorm and its VJP need whole.
//
// The widened activations never reach device memory in the forward: the
// LayerNorm output yl sits in shared memory (sA) as the A operand of pre1 =
// yl @ W1 + b1, which runs on the tensor cores (TileProduct::product,
// 3xTF32) one chunk of WC hidden units at a time. The chunk's epilogue adds
// b1, applies gelu and writes h into shared memory (sH) as the A operand of
// m += h @ W2[chunk, :], whose float32 accumulators stay in registers across
// the chunks. The chunks' slices of W1 ([C, WC]) and W2 ([WC, C]) arrive by
// cp.async in two alternating stages, the next chunk's while the tensor
// cores work on this one's.
//
// Shapes: 8 warps, 4 along the rows and 2 along the columns, a warp 16 rows.
// A block holds CN = 208 columns (any C <= 208: the model's C = 200 is 26 n8
// tiles, 4% padding where 256-wide tiles would pad 22%) or CN = 256 (C <=
// 256). The products over the channels are CN deep (zero past C), fixed at
// compile time, as is the chunk depth WC, so that every product unrolls.
//
// Arithmetic (pallas_convnext.py:_forward_block in float32): LayerNorm with
// the fast variance and eps 1e-5, every product summed in float32.
#pragma once

#include "dtype.cuh"
#include "common.cuh"
#include "tile_product.cuh"

namespace arreau {

constexpr float CONVNEXT_LN_EPS = 1e-5f;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int MAX_CHANNELS = 256;
constexpr int MODEL_CN = 208;  // the block width of C <= 208 (the model's C = 200)
constexpr int MAX_READOUT = 64;  // readout columns #10 takes (Wr^T in shared memory)

struct ConvNextArgs {
    const float* xc;     // [M, C] conv output
    const float* res;    // [M, C] residual
    const float* ln_s;   // [C]
    const float* ln_b;   // [C]
    const float* w1;     // [C, W]
    const float* b1;     // [W]
    const float* w2;     // [W, C]
    const float* b2;     // [C]
    const float* gamma;  // [C] layer scale
    const float* wr;     // [C, R] readout, or null
    const float* br;     // [R]
    long long M;
    int C, W, R;
    bool rows_vec;        // the [M, C] tensors have 16-byte aligned rows
    bool w1_vec, w2_vec;  // W1's and W2's rows are 16-byte aligned (cp.async)
};

// The C entry points' arguments as ConvNextArgs; R is 0 without a readout.
// rows_vec: whether every [M, C] tensor the caller reads or writes in
// 16-byte chunks has 16-byte aligned rows.
inline ConvNextArgs convnext_args(const float* xc, const float* res, const float* ln_s,
                                  const float* ln_b, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* gamma,
                                  const float* wr, const float* br, int M, int C, int W, int R,
                                  bool rows_vec) {
    ConvNextArgs a;
    a.xc = xc, a.res = res, a.ln_s = ln_s, a.ln_b = ln_b;
    a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2;
    a.gamma = gamma, a.wr = wr, a.br = br;
    a.M = M, a.C = C, a.W = W, a.R = wr != nullptr ? R : 0;
    a.rows_vec = rows_vec;
    a.w1_vec = rows_aligned(a.w1, W), a.w2_vec = rows_aligned(a.w2, C);
    return a;
}

template <int CN>
struct RowBlock {
    static_assert(CN % 16 == 0 && CN <= MAX_CHANNELS, "whole k16 steps, at most 256 channels");
    static constexpr int MT = 1;       // m16 tiles a warp
    static constexpr int RB = 4 * 16;  // rows a block
    // hidden units a chunk (16 at CN = 256, so that #10's shared memory fits)
    static constexpr int WC = CN <= MODEL_CN ? 32 : 16;
    static constexpr int NTC = WC / 16, NTW = CN / 16;  // n8 tiles a warp: chunk, full width
    // [RB, WC] (a chunk of pre1; of dh in #10) and [RB, CN] (m; dyln in #10)
    // products; B_K: B stored [n][k] (else [k][n]). The accumulator layouts
    // of both B layouts agree.
    template <bool B_K>
    using Chunk = TileProduct<float, true, B_K, 4, 2, MT, NTC>;
    template <bool B_K>
    using Wide = TileProduct<float, true, B_K, 4, 2, MT, NTW>;
    using ChunkAcc = typename Chunk<false>::Acc;
    using WideAcc = typename Wide<false>::Acc;
    static_assert(Chunk<false>::THREADS == ROW_THREADS, "8 warps");

    // Shared memory, in this order: sA [RB][LD_A] (yl; then m, out or dm),
    // sH [RB][LD_H] (a chunk's h; dpre1 in #10), two stages of [CN][LD_W1]
    // (W1's chunk) and [WC][LD_W2] (W2's chunk), #10's row statistics and
    // its two slots of [RB][LD_P] (a chunk of pre1, arriving with the stage).
    // Strides keep the tf32 reads on distinct banks and rows 16-byte
    // aligned.
    static constexpr int LD_A = CN + k_pad<float>();
    static constexpr int LD_H = WC + k_pad<float>();
    static constexpr int LD_W1 = WC + 8;
    static constexpr int LD_W2 = CN + 8;
    static constexpr int STAGE = CN * LD_W1 + WC * LD_W2;
    static constexpr int LD_P = WC + 8;
    static constexpr int LD_ACC = CN + 8;  // float [RB][LD_ACC] staged over the stages
    static constexpr size_t A_BYTES = (size_t)RB * LD_A * sizeof(float);
    static constexpr size_t H_BYTES = (size_t)RB * LD_H * sizeof(float);
    static constexpr size_t STAGE_BYTES = 2 * (size_t)STAGE * sizeof(float);
    static constexpr size_t SMEM = A_BYTES + H_BYTES + STAGE_BYTES + 2 * RB * sizeof(float);
    static constexpr size_t BWD_SMEM = SMEM + 2 * (size_t)RB * LD_P * sizeof(float);
    // 16-byte chunks of a row; for_each_chunk's row groups
    static constexpr int CH = 16 / sizeof(float), PER_ROW = CN / CH, RG = ROW_THREADS / PER_ROW;
    static_assert(BWD_SMEM <= 232448, "a block's shared memory");
    static_assert((size_t)MAX_READOUT * (CN + RB) * sizeof(float) <= STAGE_BYTES,
                  "Wr^T and the rows of g_r over the stages");
    static_assert((size_t)RB * LD_ACC * sizeof(float) <= STAGE_BYTES, "staged accumulators");
    static_assert((size_t)RG * CN * sizeof(float) <= H_BYTES, "column sums of the row groups");
    static_assert((size_t)2 * ROW_WARPS * CN * sizeof(float) <= A_BYTES, "column sums of warps");

    struct Smem {
        float* a;
        float* h;
        float* stage;
        float* stats;  // [2][RB]: each row's mean and 1/std
        float* pre1;       // two [RB][LD_P] slots (#10)
    };
    __device__ __forceinline__ static Smem carve() {
        unsigned char* p = shared_buffer<unsigned char>();
        unsigned char* stats = p + A_BYTES + H_BYTES + STAGE_BYTES;
        return {reinterpret_cast<float*>(p), reinterpret_cast<float*>(p + A_BYTES),
                reinterpret_cast<float*>(p + A_BYTES + H_BYTES), reinterpret_cast<float*>(stats),
                reinterpret_cast<float*>(stats + 2 * RB * sizeof(float))};
    }

    __host__ __device__ static int chunks(int W) { return (W + WC - 1) / WC; }

    // Starts the copies of stage q of the ring (chunk q % nch's slices of W1
    // and W2, zero outside C and W; with pre1, also the block's rows of that
    // chunk of pre1 [M, W] into slot q % 2) if q < total, and commits.
    __device__ __forceinline__ static void fetch_chunk(const ConvNextArgs& a, const Smem& s,
                                                       int q, int nch, int total,
                                                       long long row0 = 0,
                                                       const float* pre1 = nullptr,
                                                       bool pre1_vec = false) {
        if (q < total) {
            const int w0 = q % nch * WC;
            float* st = s.stage + q % 2 * STAGE;
            load_tile<float, CN, WC, LD_W1, ROW_THREADS>(st, a.w1 + w0, a.W, a.C, a.W - w0, a.w1_vec);
            load_tile<float, WC, CN, LD_W2, ROW_THREADS>(st + CN * LD_W1, a.w2 + (long long)w0 * a.C,
                                                     a.C, a.W - w0, a.C, a.w2_vec);
            if (pre1 != nullptr)
                load_tile<float, RB, WC, LD_P, ROW_THREADS>(
                    s.pre1 + q % 2 * RB * LD_P, pre1 + row0 * a.W + w0, a.W,
                    (int)min(a.M - row0, (long long)RB), a.W - w0, pre1_vec);
        }
        cp_async_commit();
    }

    // LayerNorm of the block's rows into sA (zero on rows >= M and columns
    // >= C), a warp a row, the lanes over the channels. Where
    // given, each row's mean and 1/std go to stats, and yl with a ones
    // column and zero padding to yl_ext [M, Cg].
    __device__ static void layer_norm(const ConvNextArgs& a, long long row0, const Smem& s,
                                      float* stats, float* yl_ext, int Cg) {
        constexpr int PER_LANE = (CN + 31) / 32;
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        for (int r = warp; r < RB; r += ROW_WARPS) {
            const long long row = row0 + r;
            float* ya = s.a + r * LD_A;
            if (row >= a.M) {  // warp-uniform
                for (int c = lane; c < CN; c += 32) ya[c] = 0.f;
                continue;
            }
            const float* xr = a.xc + row * a.C;
            float x[PER_LANE], sum = 0.f, sq = 0.f;
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const int c = lane + 32 * k;
                x[k] = c < a.C ? xr[c] : 0.f;
                sum += x[k];
                sq += x[k] * x[k];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
                sq += __shfl_xor_sync(0xffffffffu, sq, off);
            }
            const float mu = sum / a.C;
            const float rstd = rsqrtf(fmaxf(sq / a.C - mu * mu, 0.f) + CONVNEXT_LN_EPS);
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const int c = lane + 32 * k;
                if (c < CN)
                    ya[c] = (
                        c < a.C ? (x[k] - mu) * rstd * a.ln_s[c] + a.ln_b[c] : 0.f);
            }
            if (yl_ext != nullptr)  // each lane reads back the columns it wrote
                for (int c = lane; c < Cg; c += 32)
                    yl_ext[row * Cg + c] = c < a.C ? ya[c] : (c == a.C ? 1.f : 0.f);
            if (stats != nullptr && lane == 0) {
                stats[r] = mu;
                stats[RB + r] = rstd;
            }
        }
    }

    // f(i, hh, jj, m, n) for each column pair (m, n..n+1) of this thread's
    // chunk accumulators acc[i][jj][2*hh..2*hh+1]
    template <class Fn>
    __device__ __forceinline__ static void chunk_pairs(Fn f) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int jj = 0; jj < NTC; ++jj)
                    f(i, hh, jj, Chunk<false>::warp_m0() + i * 16 + g + hh * 8,
                      Chunk<false>::warp_n(jj) + 2 * t);
    }

    // m_acc += h @ W2 over the hidden chunks (b2 not added), h =
    // gelu(yl @ W1 + b1) from yl in sA; ring stage q holds
    // chunk q (the caller fetched stage 0). Where given, pre1 [M, W] (from the
    // accumulators) and h [M, Wg] (from sH, 16 bytes a thread) are written
    // out. Ends with every warp past its last read of sA
    // (the last chunk's barrier), possibly still in its last h @ W2.
    __device__ static void forward_chunks(const ConvNextArgs& a, long long row0,
                                          const Smem& s, int nch, int total, WideAcc& m_acc,
                                          float* pre1_out, float* h_out, int Wg) {
        for (int j = 0; j < nch; ++j) {
            cp_async_wait<0>();
            __syncthreads();  // stage j has landed; every warp is done with sH and stage j - 1
            fetch_chunk(a, s, j + 1, nch, total);
            const float* w1s = s.stage + j % 2 * STAGE;
            ChunkAcc acc = {};
            Chunk<false>::template product<CN>(s.a, LD_A, w1s, LD_W1, acc);
            const int w0 = j * WC;
            chunk_pairs([&](int i, int hh, int jj, int m, int n) {
                const int w = w0 + n;
                const bool live = w < a.W, second = w + 1 < a.W;
                const float p0 = live ? acc[i][jj][2 * hh] + a.b1[w] : 0.f;
                const float p1 =
                    second ? acc[i][jj][2 * hh + 1] + a.b1[w + 1] : 0.f;
                const float h0 = live ? gelu(p0) : 0.f;
                const float h1 = second ? gelu(p1) : 0.f;
                store2(s.h + m * LD_H + n, h0, h1, true, true);
                const long long row = row0 + m;
                if (pre1_out != nullptr && live && row < a.M)
                    store2(pre1_out + row * a.W + w, p0, p1, second, a.W % 2 == 0);
            });
            __syncthreads();  // the chunk's h is in sH
            if (h_out != nullptr)  // h to device memory in 16-byte row chunks
                for (int i = threadIdx.x; i < RB * (WC / CH); i += ROW_THREADS) {
                    const int m = i / (WC / CH), n = i % (WC / CH) * CH, w = w0 + n;
                    const long long row = row0 + m;
                    if (row >= a.M || w >= a.W) continue;
                    const float* src = s.h + m * LD_H + n;
                    float* dst = h_out + row * Wg + w;  // 16-byte aligned: Wg a multiple of 8
                    if (w + CH <= a.W)
                        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
                    else
                        for (int j = 0; j < a.W - w; ++j) dst[j] = src[j];
                }
            Wide<false>::template product<WC>(s.h, LD_H, w1s + CN * LD_W1, LD_W2, m_acc);
        }
    }

    // sA = m = m_acc + b2, zero in columns >= C. Call after
    // forward_chunks: no warp reads sA any more.
    __device__ static void store_m(const ConvNextArgs& a, const WideAcc& m_acc, const Smem& s) {
        Wide<false>::for_each(m_acc, [&](int m, int c, float v0, float v1) {
            const float m0 = c < a.C ? v0 + a.b2[c] : 0.f;
            const float m1 = c + 1 < a.C ? v1 + a.b2[c + 1] : 0.f;
            store2(s.a + m * LD_A + c, m0, m1, true, true);
        });
    }

    // f(r, c0) for every 16-byte chunk (CH columns from c0) of the block's
    // [RB, CN] tile: each thread takes one column chunk and the rows rg, rg +
    // RG, ... in ascending order, so that it can carry column sums over its
    // rows; consecutive threads take consecutive chunks of a row
    template <class Fn>
    __device__ __forceinline__ static void for_each_chunk(Fn f) {
        if (threadIdx.x >= PER_ROW * RG) return;
        const int c0 = threadIdx.x % PER_ROW * CH;
        for (int r = threadIdx.x / PER_ROW; r < RB; r += RG) f(r, c0);
    }

    // out = res + gamma * m for the `count` channels of
    // a chunk from c0 (0 past them)
    __device__ __forceinline__ static void residual_out(const ConvNextArgs& a, long long row,
                                                        int c0, int count, const float* m,
                                                        float* out) {
        float r[CH];
        load_chunk(r, a.res + row * a.C + c0, count, a.rows_vec);
#pragma unroll
        for (int j = 0; j < CH; ++j)
            out[j] = j < count
                         ? r[j] + a.gamma[c0 + j] * m[j]
                         : 0.f;
    }
};

}  // namespace arreau
