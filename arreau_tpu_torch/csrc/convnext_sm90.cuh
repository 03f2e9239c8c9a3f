// #9 (convnext_mlp) and #10 (convnext_mlp_bwd) in bfloat16 on Hopper's
// warpgroup products (wgmma) and the Tensor Memory Accelerator (TMA),
// wgmma.cuh's building blocks. Entry points: convnext_mlp_sm90.cu (#9 and
// the weights' copies) and convnext_mlp_bwd_sm90.cu (#10). (The float32
// instantiations keep the mma.sync row blocks of convnext_rows.cuh.)
//
// A block is two warpgroups, each on 64 rows (wgmma's M) of the block's
// 128-row tile with every one of their C <= 256 channels; persistent
// blocks, one an SM, walk the tiles. The hidden width W runs in chunks of
// WC = 64 units, the FlashAttention shape of two products back to back:
//
//   pre1 = yl @ W1[:, chunk]          A: yl in shared memory (K-major SW128,
//                                        K = C zero-padded to the width
//                                        class CN, 208 or 256)
//   h    = round(gelu(round(pre1 + b1)))       in registers
//   m   += h @ W2[chunk, :]           A: h from registers (mma_rs), N = CN
//
// so that neither pre1 nor h touches shared memory and m's CN float32
// columns stay in one accumulator across the chunks. Each chunk's slices of
// the weights arrive by TMA in one ring slot (wgmma.cuh's Ring, two slots):
// four 64-row panels of W1^T (K = C) and one CN-row panel of W2^T (K = the
// chunk), from K-major zero-padded copies each call makes first
// (weight_copies: two small passes).
// Both warpgroups consume the same slots, and run apart by up to a chunk:
// one's GELU epilogue runs while the other's products do. The chunk's GELU
// comes from the fast exponential and reciprocal (gelu_fast), its epilogue
// being the sweep's bound.
//
// #9 (cnx_fwd_kernel): LayerNorm prologue (float32 statistics, fast
//   variance, eps 1e-5; yl rounded to bfloat16), the chunks, then out =
//   round(res + round(round(gamma) * round(m + b2))); the float32 readout r
//   = out @ Wr + br, about 1% of the work, after it on the CUDA cores
//   (cnx_readout_kernel: in the persistent kernel it held the other
//   warpgroup, waiting on the ring, for a quarter of the time).
// #10: the row-wise work runs in two streaming passes, a warp a row at full
//   occupancy (cnx_prep_kernel before: the LayerNorm into yl | 1, g_total =
//   g_out + g_r @ Wr^T in float32, dres, dm = round(g_total * gamma);
//   cnx_post_kernel after: the LayerNorm VJP into dxc, out for [dWr; dbr],
//   each 64-row tile's column sums of g_total * m, dyln * xhat and dyln),
//   so that the persistent cnx_rows_kernel keeps only the chunks: yl's tile
//   by TMA, the forward again (writing h | 1 for the weight gradients, and
//   pre1 in the accumulators' own layout, each thread's 64 bytes a chunk, for
//   the second pass), m out; dm's tile by TMA over yl's, and the second pass
//   over the chunks with W2's and W1's other K-major copies:
//
//     dh    = dm @ W2[chunk, :]^T     A: dm in shared memory, N = 64
//     dpre1 = round(round(dh) * gelu'(pre1))   in registers (pre1 read back)
//     dyln += dpre1 @ W1[:, chunk]^T  A: dpre1 from registers, N = CN
//
//   and dyln out. (Epilogue work in the persistent kernel runs at 8 warps an
//   SM, two in a scheduler: there it took as long as the products.) Then
//   [dW2; db2] = [h | 1]^T dm and [dW1; db1] = [yl | 1]^T dpre1 split over
//   the rows in 64-row panels (cnx_dw_kernel: both operands MN-major boxes
//   by TMA, wgmma's transposed bfloat16 operands), [dWr; dbr] = [out | 1]^T
//   g_r on the CUDA cores (cnx_readout_dw_kernel), every partial added in a
//   fixed order: no atomics, so every output repeats bit for bit.
//
// Rounding points (the JAX kernel's, pallas_convnext.py:50-58 and :78-140):
// yl, pre1 + b1, gelu(pre1), m + b2, gamma, gamma * m and out are rounded to
// bfloat16; dm = g_total * gamma, dh and dpre1 too; every product sums in
// float32; dxc, dres's sum and every parameter gradient are float32.
#pragma once

#include "common.cuh"
#include "dtype.cuh"
#include "tile_product.cuh"
#include "wgmma.cuh"

namespace arreau {

// kernels/convnext_mlp.py:sm90_plan, as the kernels take it
struct CnxPlan {
    int cn;           // width class of C: 208 or 256 (wgmma's N of m and dyln)
    int nch;          // hidden chunks of WC units; kw = nch * WC
    int smem;         // dynamic shared memory of cnx_fwd_kernel and cnx_rows_kernel
    int cg, wg;       // row lengths of yl_ext and h_ext: C + 1 and W + 1 rounded up to 8
    int cp, wp;       // row lengths of dm / out and dpre1: C and W rounded up to 8
    int splits, per_split;      // the weight gradients' split over the rows
    int r_splits, r_per_split;  // [dWr; dbr]'s
    int dw_stages, dw_smem;     // cnx_dw_kernel's ring slots and shared memory
    int n1;                     // [dW1; db1]'s column tile (wgmma's N)
};

}  // namespace arreau

namespace {

using namespace arreau;

namespace cnx {

constexpr int WC = 64;       // hidden units a chunk
constexpr int KPANELS = 4;   // 64-element K panels of C (any C <= 256)
constexpr int KC = KPANELS * 64;
constexpr int TILE = 2 * ROWS;
constexpr int STAGES = 2;    // ring slots of the row kernels
constexpr int REGION = KPANELS * PANEL;  // a warpgroup's tile: yl, then dm
constexpr float LN_EPS = 1e-5f;

// bytes of a ring slot: W1^T's (or W2's) four 64-row panels and W2^T's (or
// W1's) CN-row panel
__host__ __device__ constexpr int slot_bytes(int cn) { return KPANELS * PANEL + cn * 128; }
// dynamic shared memory of the row kernels: alignment, the two warpgroups'
// tiles, the ring
__host__ __device__ constexpr int rows_smem(int cn) { return 1024 + 2 * REGION + STAGES * slot_bytes(cn); }

struct Args {
    const float* xc;     // [M, C]
    const bf16* res;     // [M, C]
    const float* ln_s;   // [C]
    const float* ln_b;
    const bf16* b1;      // [W]
    const bf16* b2;      // [C]
    const float* gamma;  // [C]
    long long M;
    int C, W, nch;
    // #9
    bool vec;      // res's and out's rows are 16-byte chunks (C a multiple of 8, aligned)
    bf16* out;     // [M, C]
    // #10
    bool pairs;    // dyln's element pairs are 8-byte aligned (C even)
    bf16* h_ext;   // [M, wg]: h | 1 | 0
    bf16* m_s;     // [M, cp]: m = round(m_acc + b2)
    float* dyln;   // [M, C]
    bf16* dpre1;   // [M, wp]
    uint4* pre1s;  // [2 * tiles][nch][4][128] 16-byte fragments
    int wg, cp, wp;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// gelu(x) and gelu'(x) (the tanh approximation) through r = 1 / (1 +
// exp(2u)) = (1 - tanh(u)) / 2, u = C0 (x + C1 x^3), from the fast
// exponential and reciprocal: gelu = x - x r, gelu' = (1 - r) + 2 x (1 - r) r
// C0 (1 + 3 C1 x^2), common.cuh's expressions rewritten; a few float32 ulps
// from them (closer where 1 + tanh(u) cancels, x below about -3) at a third
// of tanhf's instructions, so that the chunks' epilogues keep pace with the
// products
__device__ __forceinline__ float gelu_r(float x) {
    return __fdividef(1.f, 1.f + __expf(2.f * GELU_C0 * (x + GELU_C1 * x * x * x)));
}
__device__ __forceinline__ float gelu_fast(float x) { return fmaf(-x, gelu_r(x), x); }
__device__ __forceinline__ float gelu_deriv_fast(float x) {
    const float r = gelu_r(x), s = 1.f - r;
    return s + 2.f * x * s * r * GELU_C0 * (1.f + 3.f * GELU_C1 * x * x);
}

// the rows [row0, row0 + 64) of a row-major [M, ld] tensor into L2 (one
// thread), so that the epilogue's scattered loads of them wait on L2 only
template <class T>
__device__ __forceinline__ void prefetch_rows(const T* p, long long row0, long long M, int ld) {
    const long long rows = min((long long)ROWS, M - row0);
    if (rows > 0) prefetch_l2(p + row0 * ld, (unsigned)(rows * ld * sizeof(T)) / 16 * 16);
}

// f(k, jj, h, n, v0, v1) for this thread's accumulator pairs k = 2 jj + h of a
// m64nN product: row 16w + g + 8h, columns n, n + 1 (n = 8 jj + 2t); the
// pair is A fragment k % 4 of k16 step k / 4 (mma_rs's layout)
template <int N, class Fn>
__device__ __forceinline__ void for_pairs(float (&d)[N / 2], Fn f) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            f(2 * jj + h, jj, h, 8 * jj + 2 * t, d[4 * jj + 2 * h], d[4 * jj + 2 * h + 1]);
}

// this thread's rows of the warpgroup's tile: 16w + g (h = 0) and + 8 (h = 1)
__device__ __forceinline__ int frag_row(int h) {
    const int i = threadIdx.x % WG;
    return 16 * (i / 32) + i % 32 / 4 + 8 * h;
}

// thread 0: ring slot s for panel q: chunk j = q % per_tile of a tile's
// chunks (per_tile = nch, or 2 nch in #10: its second pass over the chunks
// reads the other copies): four 64-row boxes of the [W, KC] copy (W1^T, or
// W2 in the second pass) at rows w0, and one CN-row box of the [C, kw] copy
// (W2^T, or W1) at column w0
template <int CN>
__device__ __forceinline__ void issue_chunk(Ring& ring, int q, int s, int nch,
                                            const CUtensorMap* wc1, const CUtensorMap* cc1,
                                            const CUtensorMap* wc2, const CUtensorMap* cc2) {
    const int j = q % (cc2 != nullptr ? 2 * nch : nch);
    const bool second = j >= nch;
    const int w0 = (second ? j - nch : j) * WC;
    const CUtensorMap* wc = second ? wc2 : wc1;
    const CUtensorMap* cc = second ? cc2 : cc1;
    unsigned char* dst = ring.slot(s);
    mbar_arrive_expect_tx(&ring.full[s], slot_bytes(CN));
#pragma unroll
    for (int p = 0; p < KPANELS; ++p) tma_load_2d(dst + p * PANEL, wc, &ring.full[s], p * 64, w0);
    tma_load_2d(dst + KPANELS * PANEL, cc, &ring.full[s], w0, 0);
}

// the warpgroup's chunks: for each, acc = A_tile @ B1 (N = WC, K = CN: the
// slot's four panels), epi(j, acc, frag) forms the A fragments of the second
// product from acc, and wide += frag @ B2 (N = CN, K = WC: the slot's CN-row
// panel). The next chunk's first product is issued while this one's second
// runs; a slot is released once both its products are done.
template <int CN, class Issue, class Pre, class Epi>
__device__ __forceinline__ void chunk_sweep(Ring& ring, int& q, const unsigned char* a_tile,
                                            float (&wide)[CN / 2], int nch, Issue& issue,
                                            Pre pre, Epi epi) {
    for (int j = 0; j < nch; ++j, ++q) {
        const int s = q % ring.stages;
        pre(j);
        mbar_wait(&ring.full[s], (q / ring.stages) & 1);
        const unsigned char* slot = ring.slot(s);
        float acc[WC / 2];
#pragma unroll
        for (int i = 0; i < WC / 2; ++i) acc[i] = 0.f;
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int k = 0; k < CN / 16; ++k) {
            const int off = k / 4 * PANEL + k % 4 * 32;
            Wgmma<bf16, WC>::mma(acc, sw128_desc(a_tile + off), sw128_desc(slot + off));
        }
        wgmma_commit();
        wgmma_wait<0>();  // and the previous chunk's second product
        fence_acc(acc);
        fence_acc(wide);
        if (j > 0) release(ring, q - 1, issue);
        uint32_t frag[WC / 16][4];
        epi(j, acc, frag);
        wgmma_fence();
        fence_acc(wide);
        fence_frag(frag);
#pragma unroll
        for (int kk = 0; kk < WC / 16; ++kk)
            Wgmma<bf16, CN>::mma_rs(wide, frag[kk], sw128_desc(slot + KPANELS * PANEL + 32 * kk));
        wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(wide);
    release(ring, q - 1, issue);
}

// LayerNorm of the warpgroup's 64 rows from row0 into its tile (K-major
// SW128, zeros past C and on rows past M), a warp eight rows at a time
// (their loads in flight together)
__device__ __forceinline__ void layer_norm(const Args& a, long long row0, unsigned char* tile) {
    constexpr int PER = KC / 32, AT = 8;
    const int lane = threadIdx.x % 32, warp = threadIdx.x % WG / 32;
    float s[PER], b[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int c = lane + 32 * k;
        s[k] = c < a.C ? a.ln_s[c] : 0.f;
        b[k] = c < a.C ? a.ln_b[c] : 0.f;
    }
    for (int r0 = warp * AT; r0 < ROWS; r0 += (WG / 32) * AT) {
        float x[AT][PER];
#pragma unroll
        for (int u = 0; u < AT; ++u) {
            const long long row = row0 + r0 + u;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int c = lane + 32 * k;
                x[u][k] = row < a.M && c < a.C ? a.xc[row * a.C + c] : 0.f;
            }
        }
#pragma unroll
        for (int u = 0; u < AT; ++u) {
            const int r = r0 + u;
            const bool live = row0 + r < a.M;
            float sum = 0.f, sq = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                sum += x[u][k];
                sq += x[u][k] * x[u][k];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
                sq += __shfl_xor_sync(0xffffffffu, sq, off);
            }
            const float mu = sum / a.C;
            const float rstd = rsqrtf(fmaxf(sq / a.C - mu * mu, 0.f) + LN_EPS);
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int c = lane + 32 * k;
                *reinterpret_cast<bf16*>(tile + sw128_offset<bf16>(r, c, ROWS)) = __float2bfloat16_rn(
                    live && c < a.C ? (x[u][k] - mu) * rstd * s[k] + b[k] : 0.f);
            }
        }
    }
}

// this thread's b1 pairs of chunk j (columns w0 + 8 jj + 2t, 0 past W),
// loaded before the chunk's first product so that the epilogue does not wait
// on them
struct ChunkBias {
    float v[WC / 8][2];
    __device__ __forceinline__ void load(const Args& a, int j) {
        const int w0 = j * WC + 2 * (threadIdx.x % 4);
#pragma unroll
        for (int jj = 0; jj < WC / 8; ++jj) {
            const int w = w0 + 8 * jj;
            v[jj][0] = w < a.W ? to_float(a.b1[w]) : 0.f;
            v[jj][1] = w + 1 < a.W ? to_float(a.b1[w + 1]) : 0.f;
        }
    }
};

// the chunk's pre1 = round(acc + b1) and h = round(gelu(pre1)), h into the
// second product's fragments; f(k, n, p0, p1, h0, h1) for each pair. Past W,
// W1^T's copy and b1 are zero, so pre1 and h are too.
template <class Fn>
__device__ __forceinline__ void gelu_chunk(const ChunkBias& b1, float (&acc)[WC / 2],
                                           uint32_t (&frag)[WC / 16][4], Fn f) {
    for_pairs<WC>(acc, [&](int k, int jj, int, int n, float v0, float v1) {
        const float2 p = unpack_bf16(pack_bf16(v0 + b1.v[jj][0], v1 + b1.v[jj][1]));
        const float h0 = gelu_fast(p.x), h1 = gelu_fast(p.y);
        frag[k / 4][k % 4] = pack_bf16(h0, h1);
        f(k, n, p.x, p.y, h0, h1);
    });
}

// the bfloat16 pair (v0, v1) at element (m, n) of a 64-row K-major SW128 tile
__device__ __forceinline__ void put_pair(unsigned char* tile, int m, int n, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(tile + sw128_offset<bf16>(m, n, ROWS)) = pack_bf16(v0, v1);
}

}  // namespace cnx

using namespace cnx;

// ---- #9 ---------------------------------------------------------------------

// The epilogues run over the warpgroup's 64 x CN tile in its shared memory
// in rolled loops, the accumulators first staged there in one unrolled pass:
// code unrolled over the accumulators is tens of kilobytes executed once a
// tile, which the instruction caches do not hold.

// the tile (K-major SW128, 64 rows) = round(acc + bias) in bfloat16 (the
// staging pass of the out and dm epilogues)
template <int CN>
__device__ __forceinline__ void stage_rounded(unsigned char* tile, float (&acc)[CN / 2],
                                              const float* bias) {
    for_pairs<CN>(acc, [&](int, int, int h, int c, float v0, float v1) {
        put_pair(tile, frag_row(h), c, v0 + bias[c], v1 + bias[c + 1]);
    });
}

// the 8 bfloat16 values of a 16-byte chunk as floats, and back
__device__ __forceinline__ void unpack8(const uint4& q, float (&v)[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(w[j]);
        v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
}

// the 16-byte chunk of row r at channels c .. c + 7 of a 64-row SW128 tile
__device__ __forceinline__ uint4* tile_chunk(unsigned char* tile, int r, int c) {
    return reinterpret_cast<uint4*>(tile + sw128_offset<bf16>(r, c, ROWS));
}

// ---- #9 ---------------------------------------------------------------------

constexpr int LANE_CH = KC / 32;  // channels a lane holds

// the sum over the warp's lanes, the same in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int CN>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
cnx_fwd_kernel(const Args a, const __grid_constant__ CUtensorMap w1t_map,
               const __grid_constant__ CUtensorMap w2t_map) {
    __shared__ uint64_t full[STAGES];
    __shared__ int released[STAGES];
    __shared__ float s_b2[CN], s_gamma[CN];  // b2 and round(gamma), zero past C
    for (int c = threadIdx.x; c < CN; c += BLOCK_THREADS) {
        s_b2[c] = c < a.C ? to_float(a.b2[c]) : 0.f;
        s_gamma[c] = c < a.C ? round_to<bf16>(a.gamma[c]) : 0.f;
    }
    unsigned char* smem = aligned_smem();
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG, n_tiles = cdiv(a.M, TILE);
    unsigned char* tile = smem + wg * REGION;
    Ring ring{full, released, smem + 2 * REGION, slot_bytes(CN), STAGES,
              block_tiles(n_tiles) * a.nch, true};
    auto issue = [&](int q, int s) {
        issue_chunk<CN>(ring, q, s, a.nch, &w1t_map, &w2t_map, nullptr, nullptr);
    };
    ring_start(ring, issue);  // and s_b2, s_gamma visible
    const bool vec = a.vec;
    int q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long long row0 = (long long)t * TILE + wg * ROWS;
        wg_sync();  // the last tile's readout is done with the tile
        layer_norm(a, row0, tile);
        fence_proxy_async();
        wg_sync();
        if (i == 0) {  // this tile's residual and the next tile's conv output into L2
            prefetch_rows(a.res, row0, a.M, a.C);
            prefetch_rows(a.xc, row0 + (long long)gridDim.x * TILE, a.M, a.C);
        }
        float m[CN / 2];
#pragma unroll
        for (int k = 0; k < CN / 2; ++k) m[k] = 0.f;
        ChunkBias b1;
        chunk_sweep<CN>(ring, q, tile, m, a.nch, issue, [&](int j) { b1.load(a, j); },
                        [&](int j, float(&acc)[WC / 2], uint32_t(&frag)[WC / 16][4]) {
                            gelu_chunk(b1, acc, frag, [](int, int, float, float, float, float) {});
                        });
        wg_sync();  // every warp's products are done with yl: m over it
        stage_rounded<CN>(tile, m, s_b2);
        wg_sync();
        // out = round(res + round(round(gamma) * m)): a thread every WG-th
        // 16-byte chunk, four at a time with their residual loads in flight
        // together
        constexpr int CHUNKS = ROWS * (CN / 8), AT = 4;
        for (int e0 = i; e0 < CHUNKS; e0 += AT * WG) {
            float o[AT][8];
#pragma unroll
            for (int u = 0; u < AT; ++u) {
                const int e = e0 + u * WG, r = e / (CN / 8), c = e % (CN / 8) * 8;
                const long long row = row0 + r;
                const bool live = e < CHUNKS && row < a.M && c < a.C;
                load_chunk(o[u], a.res + (live ? row * a.C + c : 0), live ? min(8, a.C - c) : 0,
                           vec);
            }
#pragma unroll
            for (int u = 0; u < AT; ++u) {
                const int e = e0 + u * WG, r = e / (CN / 8), c = e % (CN / 8) * 8;
                const long long row = row0 + r;
                if (e >= CHUNKS || row >= a.M || c >= a.C) continue;
                uint4* at = tile_chunk(tile, r, c);
                float mv[8];
                unpack8(*at, mv);
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    o[u][k] = round_to<bf16>(o[u][k] + round_to<bf16>(s_gamma[c + k] * mv[k]));
                store_chunk(a.out + row * a.C + c, o[u], min(8, a.C - c), vec);
            }
        }
    }
}

// the row stride (bfloat16 elements) of cnx_readout_kernel's staged rows of out
__host__ __device__ constexpr int readout_ld(int C) { return (C + 3) / 4 * 4 + 2; }

// #9's readout after cnx_fwd_kernel: r [M, R] = out @ Wr + br in float32,
// the channels in order. A block stages 64 rows of out (bfloat16) and Wr
// [C][RP] (RP = R rounded up to 4) in shared memory; a thread two rows (r,
// r + 32) by four readout columns, so that each value it loads serves
// several products
__global__ void __launch_bounds__(arreau::THREADS)
cnx_readout_kernel(const bf16* __restrict__ out, const float* __restrict__ wr,
                   const float* __restrict__ br, float* __restrict__ r, long long M, int C,
                   int R, bool vec) {
    // out's rows at an odd count of words apart: a warp's 32 rows on 32 banks
    const int RP = (R + 3) / 4 * 4, groups = RP / 4, LDO = readout_ld(C);
    bf16* so = shared_buffer<bf16>();                         // [64][LDO]
    float* sw = reinterpret_cast<float*>(so + ROWS * LDO);  // [C][RP]
    const long long row0 = (long long)blockIdx.x * ROWS;
    const int rows = (int)min((long long)ROWS, M - row0);
    if (vec) {  // 16-byte chunks of out's rows
        const int chunks = C / 8;
#pragma unroll 4
        for (int e = threadIdx.x; e < ROWS * chunks; e += arreau::THREADS) {
            const int rr = e / chunks, c = e % chunks * 8;
            const uint4 v = rr < rows ? *reinterpret_cast<const uint4*>(out + (row0 + rr) * C + c)
                                      : make_uint4(0, 0, 0, 0);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};  // LDO is not a multiple of 8
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<uint32_t*>(so + rr * LDO + c + 2 * j) = w[j];
        }
    } else {
#pragma unroll 8
        for (int e = threadIdx.x; e < ROWS * C; e += arreau::THREADS)
            so[e / C * LDO + e % C] = e / C < rows ? out[row0 * C + e] : __float2bfloat16_rn(0.f);
    }
#pragma unroll 8
    for (int e = threadIdx.x; e < C * RP; e += arreau::THREADS)
        sw[e] = e % RP < R ? wr[e / RP * R + e % RP] : 0.f;
    __syncthreads();
    for (int e = threadIdx.x; e < 32 * groups; e += arreau::THREADS) {
        const int rr = e % 32, q0 = e / 32 * 4;
        float v[2][4] = {};
        for (int c = 0; c < C; ++c) {
            const float o0 = to_float(so[rr * LDO + c]), o1 = to_float(so[(rr + 32) * LDO + c]);
            const float4 w = *reinterpret_cast<const float4*>(sw + c * RP + q0);
            v[0][0] += o0 * w.x, v[0][1] += o0 * w.y, v[0][2] += o0 * w.z, v[0][3] += o0 * w.w;
            v[1][0] += o1 * w.x, v[1][1] += o1 * w.y, v[1][2] += o1 * w.z, v[1][3] += o1 * w.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (rr + 32 * h >= rows) continue;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (q0 + k < R) r[(row0 + rr + 32 * h) * R + q0 + k] = v[h][k] + br[q0 + k];
        }
    }
}

// ---- #10 --------------------------------------------------------------------

// #10's row-wise passes around cnx_rows_kernel: a warp a row, its lanes over
// the channels c = lane + 32k (the row sums over the lanes' partials, in
// order, then the warp's butterfly), full occupancy
struct RowPass {
    const float* xc;      // [M, C]
    const bf16* res;      // [M, C]
    const float* ln_s;    // [C]
    const float* ln_b;
    const float* gamma;
    const float* wr;      // [C, R] or null
    const bf16* g_out;    // [M, C]
    const float* g_r;     // [M, R]
    float* g_total;       // [M, C]
    bf16* dres;           // [M, C]
    bf16* yl_ext;         // [M, cg]
    bf16* h_ext;          // [M, wg]: its ones column and padding
    bf16* dm;             // [M, cp]
    float2* stats;        // [M]: each row's mean and 1/std
    const bf16* m_s;      // [M, cp]
    const float* dyln;    // [M, C]
    float* dxc;           // [M, C]
    bf16* out_s;          // [M, cp] (with a readout)
    float* colpart;       // [tiles64][3][C]: dgamma, dln_s, dln_b over each 64-row tile
    long long M;
    int C, W, R, cg, wg, cp;
};

// before cnx_rows_kernel, a warp a row: the LayerNorm (yl | 1 | 0 to
// yl_ext, the row's mean and 1/std to stats), g_total = g_out + (g_r @ Wr^T,
// summed over q in order) and dres = round(g_total), dm = round(g_total *
// gamma), and h_ext's ones column and padding. Wr^T staged in shared memory.
__global__ void __launch_bounds__(arreau::THREADS)
cnx_prep_kernel(const RowPass a) {
    float* wrt = shared_buffer<float>();  // [R][KC]
#pragma unroll 8
    for (int e = threadIdx.x; e < a.R * KC; e += arreau::THREADS) {
        const int qq = e / KC, c = e % KC;
        wrt[e] = c < a.C ? a.wr[c * a.R + qq] : 0.f;
    }
    __syncthreads();
    const int lane = threadIdx.x % 32, warps = arreau::THREADS / 32;
    for (long long row = blockIdx.x * (long long)warps + threadIdx.x / 32; row < a.M;
         row += (long long)gridDim.x * warps) {
        float x[LANE_CH], g[LANE_CH], sum = 0.f, sq = 0.f;
        const long long at = row * a.C;
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {  // the row's loads in flight together
            const int c = lane + 32 * k;
            x[k] = c < a.C ? a.xc[at + c] : 0.f;
            g[k] = c < a.C ? to_float(a.g_out[at + c]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {
            sum += x[k];
            sq += x[k] * x[k];
        }
        sum = warp_sum(sum), sq = warp_sum(sq);
        const float mu = sum / a.C;
        const float rstd = rsqrtf(fmaxf(sq / a.C - mu * mu, 0.f) + LN_EPS);
        if (lane == 0) a.stats[row] = make_float2(mu, rstd);
        float gr[LANE_CH] = {};
        for (int qq = 0; qq < a.R; ++qq) {
            const float gq = a.g_r[row * a.R + qq];
#pragma unroll
            for (int k = 0; k < LANE_CH; ++k) gr[k] += gq * wrt[qq * KC + lane + 32 * k];
        }
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {
            const int c = lane + 32 * k;
            if (c >= a.C) continue;
            const float gt = g[k] + gr[k];
            a.g_total[at + c] = gt;
            a.dres[at + c] = __float2bfloat16_rn(gt);
            a.dm[row * a.cp + c] = __float2bfloat16_rn(gt * a.gamma[c]);
            a.yl_ext[row * a.cg + c] = __float2bfloat16_rn((x[k] - mu) * rstd * a.ln_s[c] + a.ln_b[c]);
        }
        for (int c = a.C + lane; c < a.cg; c += 32)
            a.yl_ext[row * a.cg + c] = __float2bfloat16_rn(c == a.C ? 1.f : 0.f);
        for (int c = a.W + lane; c < a.wg; c += 32)
            a.h_ext[row * a.wg + c] = __float2bfloat16_rn(c == a.W ? 1.f : 0.f);
    }
}

// after cnx_rows_kernel, a block a 64-row tile, a warp every eighth row of
// it: the LayerNorm VJP (dxc from dyln), out = round(res + round(round(gamma)
// * m)) for [dWr; dbr], and the tile's column sums of g_total * m (dgamma),
// dyln * xhat and dyln (each lane's rows in order, then the warps in order)
__global__ void __launch_bounds__(arreau::THREADS)
cnx_post_kernel(const RowPass a) {
    constexpr int WARPS = arreau::THREADS / 32;
    __shared__ float red[WARPS][3][KC];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float cg[LANE_CH] = {}, cs[LANE_CH] = {}, cb[LANE_CH] = {};
    float gm[LANE_CH], ln[LANE_CH];
#pragma unroll
    for (int k = 0; k < LANE_CH; ++k) {
        const int c = lane + 32 * k;
        gm[k] = c < a.C ? round_to<bf16>(a.gamma[c]) : 0.f;
        ln[k] = c < a.C ? a.ln_s[c] : 0.f;
    }
    for (int r = warp; r < ROWS; r += WARPS) {
        const long long row = (long long)blockIdx.x * ROWS + r;
        if (row >= a.M) break;
        const long long at = row * a.C;
        const float2 st = a.stats[row];
        float y[LANE_CH], x[LANE_CH], m[LANE_CH], g[LANE_CH], res[LANE_CH];
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {  // the row's loads in flight together
            const int c = lane + 32 * k;
            const bool in = c < a.C;
            y[k] = in ? a.dyln[at + c] : 0.f;
            x[k] = in ? a.xc[at + c] : 0.f;
            m[k] = in ? to_float(a.m_s[row * a.cp + c]) : 0.f;
            g[k] = in ? a.g_total[at + c] : 0.f;
            res[k] = in && a.R > 0 ? to_float(a.res[at + c]) : 0.f;
        }
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {
            x[k] = lane + 32 * k < a.C ? (x[k] - st.x) * st.y : 0.f;  // xhat
            const float dxh = y[k] * ln[k];
            s1 += dxh;
            s2 += dxh * x[k];
        }
        s1 = warp_sum(s1) / a.C, s2 = warp_sum(s2) / a.C;
#pragma unroll
        for (int k = 0; k < LANE_CH; ++k) {
            const int c = lane + 32 * k;
            cg[k] += g[k] * m[k];
            cs[k] += y[k] * x[k];
            cb[k] += y[k];
            if (c >= a.C) continue;
            a.dxc[at + c] = st.y * (y[k] * ln[k] - s1 - x[k] * s2);
            if (a.R > 0)
                a.out_s[row * a.cp + c] =
                    __float2bfloat16_rn(res[k] + round_to<bf16>(gm[k] * m[k]));
        }
    }
#pragma unroll
    for (int k = 0; k < LANE_CH; ++k) {
        red[warp][0][lane + 32 * k] = cg[k];
        red[warp][1][lane + 32 * k] = cs[k];
        red[warp][2][lane + 32 * k] = cb[k];
    }
    __syncthreads();
    float* part = a.colpart + (long long)blockIdx.x * 3 * a.C;
    for (int e = threadIdx.x; e < 3 * a.C; e += arreau::THREADS) {
        const int j = e / a.C, c = e % a.C;
        float v = 0.f;
        for (int w = 0; w < WARPS; ++w) v += red[w][j][c];
        part[e] = v;
    }
}

// the rows of #10 between its row passes: per 64-row tile the forward's
// chunks again (h to h_ext, pre1 kept in its fragments' layout), m to m_s,
// then the second pass over the chunks (dpre1 to dpre1, dyln to dyln); the
// tile holds yl, then dm, both loaded by TMA (yl_map, dm_map: boxes of 64
// columns by 64 rows of yl_ext and dm), the next tile's yl while this tile's
// dyln goes out
template <int CN>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
cnx_rows_kernel(const Args a, const __grid_constant__ CUtensorMap w1t_map,
                const __grid_constant__ CUtensorMap w2t_map,
                const __grid_constant__ CUtensorMap w2k_map,
                const __grid_constant__ CUtensorMap w1k_map,
                const __grid_constant__ CUtensorMap yl_map,
                const __grid_constant__ CUtensorMap dm_map) {
    __shared__ uint64_t full[STAGES], tile_bar[2];
    __shared__ int released[STAGES];
    __shared__ float s_b2[CN];  // zero past C
    // a warpgroup's threads' pre1 fragments of a chunk in the second pass
    __shared__ __align__(16) uint4 pre1_frag[2][4][WG];
    for (int c = threadIdx.x; c < CN; c += BLOCK_THREADS) s_b2[c] = c < a.C ? to_float(a.b2[c]) : 0.f;
    unsigned char* smem = aligned_smem();
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG;
    const int n_tiles = cdiv(a.M, TILE);
    unsigned char* tile = smem + wg * REGION;
    Ring ring{full, released, smem + 2 * REGION, slot_bytes(CN), STAGES,
              block_tiles(n_tiles) * 2 * a.nch, true};
    auto issue = [&](int q, int s) {
        issue_chunk<CN>(ring, q, s, a.nch, &w1t_map, &w2t_map, &w2k_map, &w1k_map);
    };
    // thread 0 of the warpgroup: the tile's four 64-column boxes of map at row row0
    auto load_tile = [&](const CUtensorMap* map, long long row0) {
        mbar_arrive_expect_tx(&tile_bar[wg], REGION);
#pragma unroll
        for (int p = 0; p < KPANELS; ++p)
            tma_load_2d(tile + p * PANEL, map, &tile_bar[wg], p * 64, (int)row0);
    };
    if (threadIdx.x == 0) {
        mbar_init(&tile_bar[0], 1);
        mbar_init(&tile_bar[1], 1);
    }
    ring_start(ring, issue);  // and the tile barriers initialised, s_b2 visible
    if (i == 0 && blockIdx.x < n_tiles) load_tile(&yl_map, ((long long)blockIdx.x * 2 + wg) * ROWS);
    uint4* p_smem = pre1_frag[wg][0];
    int q = 0, loads = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int tile64 = 2 * t + wg;
        const long long row0 = (long long)tile64 * ROWS;
        mbar_wait(&tile_bar[wg], loads++ & 1);  // yl

        // 1. the forward's chunks: pre1 (kept in its fragments' layout), h
        float acc[CN / 2];
#pragma unroll
        for (int k = 0; k < CN / 2; ++k) acc[k] = 0.f;
        ChunkBias b1;
        chunk_sweep<CN>(ring, q, tile, acc, a.nch, issue, [&](int j) { b1.load(a, j); },
                        [&](int j, float(&c1)[WC / 2], uint32_t(&frag)[WC / 16][4]) {
            uint32_t p[WC / 4];
            gelu_chunk(b1, c1, frag, [&](int k, int n, float p0, float p1, float h0, float h1) {
                p[k] = pack_bf16(p0, p1);
                const long long row = row0 + frag_row(k % 2);
                const int w = j * WC + n;
                if (row < a.M && w < a.W) store2(a.h_ext + row * a.wg + w, h0, h1, w + 1 < a.W, true);
            });
            uint4* dst = a.pre1s + ((long long)tile64 * a.nch + j) * 4 * WG + i;
#pragma unroll
            for (int v = 0; v < 4; ++v)
                dst[v * WG] = make_uint4(p[4 * v], p[4 * v + 1], p[4 * v + 2], p[4 * v + 3]);
        });
        wg_sync();  // every warp's products are done with yl: dm over it
        if (i == 0) load_tile(&dm_map, row0);
        // m = round(acc + b2) out to m_s (the row pass after takes dgamma and out from it)
        for_pairs<CN>(acc, [&](int, int, int h, int c, float v0, float v1) {
            const long long row = row0 + frag_row(h);
            if (row < a.M && c < a.C)
                store2(a.m_s + row * a.cp + c, v0 + s_b2[c], v1 + s_b2[c + 1], c + 1 < a.C, true);
        });
        mbar_wait(&tile_bar[wg], loads++ & 1);  // dm

        // 2. the second pass: dpre1 and dyln; each chunk's pre1 fragments
        // copied into shared memory under the chunk's first product
#pragma unroll
        for (int k = 0; k < CN / 2; ++k) acc[k] = 0.f;
        chunk_sweep<CN>(ring, q, tile, acc, a.nch, issue,
                        [&](int j) {
                            const uint4* src = a.pre1s + ((long long)tile64 * a.nch + j) * 4 * WG + i;
#pragma unroll
                            for (int v = 0; v < 4; ++v) cp_async16(p_smem + v * WG + i, src + v * WG, 16);
                            cp_async_commit();
                        },
                        [&](int j, float(&dh)[WC / 2], uint32_t(&frag)[WC / 16][4]) {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            uint32_t p[WC / 4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const uint4 u = p_smem[v * WG + i];
                p[4 * v] = u.x, p[4 * v + 1] = u.y, p[4 * v + 2] = u.z, p[4 * v + 3] = u.w;
            }
            for_pairs<WC>(dh, [&](int k, int, int h, int n, float v0, float v1) {
                // past W, W2's copy is zero: dh and dpre1 are too
                const int w = j * WC + n;
                const float2 pre = unpack_bf16(p[k]);
                const float2 d = unpack_bf16(pack_bf16(v0, v1));  // round(dh)
                const float d0 = d.x * gelu_deriv_fast(pre.x);
                const float d1 = d.y * gelu_deriv_fast(pre.y);
                frag[k / 4][k % 4] = pack_bf16(d0, d1);  // dpre1, rounded
                const long long row = row0 + frag_row(h);
                if (row < a.M && w < a.W) store2(a.dpre1 + row * a.wp + w, d0, d1, w + 1 < a.W, true);
            });
        });
        wg_sync();  // every warp's products are done with dm: the next tile's yl over it
        const int next = t + gridDim.x;
        if (i == 0 && next < n_tiles) load_tile(&yl_map, ((long long)next * 2 + wg) * ROWS);
        for_pairs<CN>(acc, [&](int, int, int h, int c, float v0, float v1) {  // dyln out
            const long long row = row0 + frag_row(h);
            if (row < a.M && c < a.C) store2(a.dyln + row * a.C + c, v0, v1, c + 1 < a.C, a.pairs);
        });
    }
}

// partial[split, m, n] = sum over the split's rows k of A[k, m] B[k, n] for m
// < Mdim, n0 + n < Ndim (n0 = blockIdx.y * NW): A and B row-major [rows, *]
// in device memory, read by TMA as MN-major boxes of 64 columns x 64 rows
// (a_map: the block's two 64-column halves of M, b_map: NW / 64 boxes of N),
// the split in 64-row panels through a ring of `stages` slots
template <int NW>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
cnx_dw_kernel(float* __restrict__ partial, long long rows, int per_split, int Mdim, int Ndim,
              int stages, const __grid_constant__ CUtensorMap a_map,
              const __grid_constant__ CUtensorMap b_map) {
    constexpr int NBOX = (NW + 63) / 64;
    __shared__ uint64_t full[MAX_STAGES];
    __shared__ int released[MAX_STAGES];
    unsigned char* smem = aligned_smem();
    const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * NW;
    const long long k0 = (long long)blockIdx.z * per_split;
    const int K = (int)min((long long)per_split, rows - k0), kp = cdiv(K, ROWS);
    const int wg = threadIdx.x / WG;
    Ring ring{full, released, smem, (2 + NBOX) * PANEL, stages, kp, true};
    auto issue = [&](int q, int s) {
        const int row = (int)(k0 + (long long)q * ROWS);
        unsigned char* dst = ring.slot(s);
        mbar_arrive_expect_tx(&ring.full[s], (2 + NBOX) * PANEL);
        tma_load_2d(dst, &a_map, &ring.full[s], m0, row);
        tma_load_2d(dst + PANEL, &a_map, &ring.full[s], m0 + ROWS, row);
#pragma unroll
        for (int j = 0; j < NBOX; ++j) tma_load_2d(dst + (2 + j) * PANEL, &b_map, &ring.full[s], n0 + 64 * j, row);
    };
    ring_start(ring, issue);
    float acc[NW / 2];
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) acc[k] = 0.f;
    for (int p = 0; p < kp; ++p) {
        const int s = p % stages;
        const unsigned char* slot = ring.slot(s);
        mbar_wait(&ring.full[s], (p / stages) & 1);
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            Wgmma<bf16, NW>::mma_mn(acc, sw128_mn_desc(slot + wg * PANEL + 2048 * kk, PANEL),
                                    sw128_mn_desc(slot + 2 * PANEL + 2048 * kk, PANEL));
        wgmma_commit();
        if (p > 0) {
            wgmma_wait<1>();
            fence_acc(acc);
            release(ring, p - 1, issue);
        }
    }
    if (kp > 0) product_finish<NW>(acc, ring, kp - 1, issue);
    float* out = partial + (long long)blockIdx.z * Mdim * Ndim;
    const int mw = m0 + wg * ROWS;
    for_pairs<NW>(acc, [&](int, int, int h, int n, float v0, float v1) {
        const int m = mw + frag_row(h);
        if (m >= Mdim || n0 + n >= Ndim) return;
        out[(long long)m * Ndim + n0 + n] = v0;
        if (n0 + n + 1 < Ndim) out[(long long)m * Ndim + n0 + n + 1] = v1;
    });
}

// partial[split, c, q] = sum over the split's rows (in order) of [out | 1][row,
// c] g_r[row, q]: the split's rows staged in shared memory 64 at a time (out
// [64][C] bfloat16, g_r [64][RP] float32, RP = R rounded up to 4), a thread a
// channel and four readout columns at a time, the sums kept in shared memory
// across the staged rows
__global__ void __launch_bounds__(arreau::THREADS)
cnx_readout_dw_kernel(const bf16* __restrict__ out_s, int cp, const float* __restrict__ g_r,
                      float* __restrict__ partial, long long M, int C, int R, int per_split) {
    __shared__ __align__(16) bf16 so[ROWS][KC];
    __shared__ __align__(16) float sg[ROWS][64];
    float* sums = shared_buffer<float>();  // [(C + 1) * RP]
    const int RP = (R + 3) / 4 * 4, groups = RP / 4, items = (C + 1) * groups;
    const long long k0 = (long long)blockIdx.x * per_split;
    const int K = (int)min((long long)per_split, M - k0);
    for (int e = threadIdx.x; e < items * 4; e += arreau::THREADS) sums[e] = 0.f;
    for (int r0 = 0; r0 < K; r0 += ROWS) {
        const int rows = min(ROWS, K - r0);
        __syncthreads();  // every thread is done with the last rows
        const int chunks = cp / 8;  // out_s's rows: 16-byte chunks (cp a multiple of 8)
#pragma unroll 8
        for (int e = threadIdx.x; e < ROWS * chunks; e += arreau::THREADS) {
            const int r = e / chunks, c = (e - r * chunks) * 8;
            *reinterpret_cast<uint4*>(&so[r][c]) =
                r < rows ? *reinterpret_cast<const uint4*>(out_s + (k0 + r0 + r) * cp + c)
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll 8
        for (int e = threadIdx.x; e < ROWS * RP; e += arreau::THREADS) {
            const int r = e / RP, qq = e - r * RP;
            sg[r][qq] = r < rows && qq < R ? g_r[(k0 + r0 + r) * R + qq] : 0.f;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < items; e += arreau::THREADS) {
            const int c = e / groups, q0 = (e - c * groups) * 4;
            float4 v = *reinterpret_cast<const float4*>(sums + 4 * e);
            for (int r = 0; r < rows; ++r) {
                const float o = c < C ? to_float(so[r][c]) : 1.f;
                const float4 g = *reinterpret_cast<const float4*>(&sg[r][q0]);
                v.x += o * g.x, v.y += o * g.y, v.z += o * g.z, v.w += o * g.w;
            }
            *reinterpret_cast<float4*>(sums + 4 * e) = v;
        }
    }
    __syncthreads();
    float* dst = partial + (long long)blockIdx.x * (C + 1) * R;
    for (int e = threadIdx.x; e < (C + 1) * R; e += arreau::THREADS) {
        const int c = e / R, qq = e - c * R;
        dst[e] = sums[4 * (c * groups + qq / 4) + qq % 4];
    }
}

// K-major zero-padded copies of a ConvNext weight for the row kernels' B
// operands: wc [W, KC] (wc[w][c], the C axis padded to KC) and cc [C, kw]
// (cc[c][w], the W axis padded to kw) of W1 [C, W] (c_rows) or W2 [W, C]
__global__ void __launch_bounds__(arreau::THREADS)
cnx_weights_kernel(const bf16* __restrict__ w, bf16* __restrict__ wc, bf16* __restrict__ cc,
                   bool c_rows, int C, int W, int kw) {
    const long long n_wc = (long long)W * KC, n = n_wc + (long long)C * kw;
    for (long long e = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; e < n;
         e += (long long)gridDim.x * arreau::THREADS) {
        int c, ww;
        if (e < n_wc) {
            ww = (int)(e / KC), c = (int)(e % KC);
        } else {
            c = (int)((e - n_wc) / kw), ww = (int)((e - n_wc) % kw);
        }
        const bf16 v = c < C && ww < W ? w[c_rows ? (long long)c * W + ww : (long long)ww * C + c]
                                       : __float2bfloat16_rn(0.f);
        (e < n_wc ? wc[e] : cc[e - n_wc]) = v;
    }
}

// the elements of both weights' copies (copies [2][W * KC + C * kw])
inline long long weight_copy_elements(int C, int W, int kw) {
    return 2 * ((long long)W * KC + (long long)C * kw);
}

// W1's and W2's copies into copies (cnx_weights_kernel, on the call's stream)
// and their TMA tensor maps: m1 = {W1^T [W, KC] in boxes of 64 rows, W1 [C,
// kw] in boxes of cn rows}, m2 = {W2 [W, KC], W2^T [C, kw]}. A call makes its
// own: the weights change with every step, and the sampler's are cast anew
// on every call.
inline int weight_copies(const bf16* w1, const bf16* w2, bf16* copies, int C, int W,
                         const CnxPlan& p, CUtensorMap (&m1)[2], CUtensorMap (&m2)[2],
                         cudaStream_t stream) {
    const int kw = p.nch * WC;
    const long long half = weight_copy_elements(C, W, kw) / 2;
    const bf16* w[2] = {w1, w2};
    CUtensorMap* m[2] = {m1, m2};
    for (int i = 0; i < 2; ++i) {
        bf16* wc = copies + i * half;
        bf16* cc = wc + (long long)W * KC;
        if (!sw128_map<bf16>(&m[i][0], wc, KC, W, 2LL * KC, ROWS) ||
            !sw128_map<bf16>(&m[i][1], cc, kw, C, 2LL * kw, p.cn))
            return static_cast<int>(cudaErrorInvalidValue);
        cnx_weights_kernel<<<sum_splits_blocks(half), arreau::THREADS, 0, stream>>>(
            w[i], wc, cc, i == 0, C, W, kw);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace
