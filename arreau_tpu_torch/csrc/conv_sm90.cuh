// #3 (spatial_conv) and #4 (spatial_conv_bwd) on Hopper's warpgroup products
// (wgmma) and the Tensor Memory Accelerator (TMA), wgmma.cuh's building
// blocks, in float32 (3xTF32 on tf32 wgmma) and bfloat16. Entry points:
// spatial_conv_sm90.cu (#3), spatial_conv_bwd_sm90.cu (#4; its per-edge
// kernel pass in conv_kern_sm90.cu, compiled beside it).
//
// Replaces pallas_conv.py:_fwd_spatial (bodies :298 / :392, pallas_call
// :412 / :429) and _bwd_spatial (body :331, pallas_call :468); the math is
// in spatial_conv_sm90.cu and spatial_conv_bwd_sm90.cu.
//
// Bound on the H100 (training shape B'=32, O=16, K=8, TA=128, D=256,
// C=200): the per-edge kernel kern = basis @ W, 2*B'*O*E*D*C = 53.7 GFLOP,
// against one read of the basis (268 MB in bfloat16). bfloat16 on the tensor
// cores (989 TFLOP/s) is bound by the bytes; float32 as 3xTF32 (495 / 3
// TFLOP/s) by the operations. #4 does three such products.
//
// One design serves the products. A block is two warpgroups (256 threads)
// that share a 64-row A tile and split the N columns in two halves of NB
// (a width class: 32, 64, 112 or 128), so an accumulator is NB / 2 floats a
// thread and one wgmma covers a warpgroup's half (C = 200: N = 2 x 112, 12%
// padding where the mma.sync tiles padded 22%). A tile's rows are one
// neighbour slot's receivers t0 .. t0 + 63 of one bo = b'*O + o: TMA reads
// them through a 3-D map over basis viewed as [B'*O*K, TA, D], which clips
// the box at TA (rows past a slot's end arrive as zeros, so a tile never
// mixes slots, whatever TA). Where the basis rows break TMA's 16-byte stride
// rule (D * sizeof(T) not a multiple of 16) the block's threads stage the
// same boxes into the same swizzled layout (stage_box). B is W's copy in the
// K-major layout (W^T for basis @ W, W itself for gxw @ W^T), zero-padded by
// weights_kernel once for each version of W (arreau_conv_weights_sm90; the
// wrapper keeps the copies and their tensor maps): in bfloat16 it stays
// resident in shared memory (loaded once a block by TMA); in float32 its
// tf32 big and small halves (twice as large, ~450 KB at 224 x 256) stream
// through the ring with A, a K-panel at a time. A float32 A panel is split into its tf32 halves in
// shared memory by the block's threads (split_panel) after it lands.
//
// The ring is wgmma.cuh's (two warpgroups, the last warp to release a slot
// refills it). A warpgroup issues one K-panel's products (four k16 steps in
// bfloat16; four k8 steps of three tf32 products in float32) while the
// previous panel's finish, then releases that one. The epilogues' loads and
// stores go through a staging tile of each warpgroup's in 16-byte cp.async
// copies and stores.
//
// Where the rounding and summation orders come from: every product sums in
// float32 (bf16 x bf16 is exact in float32; 3xTF32 keeps ~2^-22 of each
// product); the sums the kernels add themselves (over the neighbour slots,
// over the columns of dwin, over the split partials of dW, over each
// sender's terms in dx) go in a fixed order, so every output is the same bit
// for bit on every call. No atomic touches an output (the ring's release
// count elects the warp that issues a copy, which copies the same bytes
// whichever warp it is).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "dtype.cuh"
#include "tile_product.cuh"
#include "wgmma.cuh"

namespace arreau {

// The tile plan (kernels/spatial_conv.py:conv_sm90_plan, the one place that
// chooses it): the width classes of a warpgroup's half of C and of D (nc, nd,
// 32 / 64 / 112 / 128) and of C in #4's dW (nw, up to 256); D and C
// rounded up to a 128-byte K-panel (kd, kc), the row lengths of W's copies;
// C rounded up to 8 (cg), the row length of #4's edge scratch; each kernel's
// ring slots and dynamic shared memory; dW's split over the edge rows. The
// launches take its bytes as they are and only check that the layouts they
// address fit in them.
struct ConvPlan {
    int nc, nd, nw, kd, kc, cg;
    int stages, smem;                // #3 and #4's per-edge pass
    int dbasis_stages, dbasis_smem;  // #4's dbasis
    int dw_stages, dw_smem;          // #4's dW
    int splits, per_split;
};

// #4's dx pass, defined in spatial_conv_bwd.cu beside #2's (which uses it
// too): each sender's dx terms summed over its run
int spatial_conv_dx(const void* dxc, const int* order, const int* offsets, void* dx, int Bp, int O,
                    int TA, int E, int C, int Cg, bool is_bf16, cudaStream_t stream);

// The convolution's tensors and shapes, as the kernels of this header take them
template <class T>
struct ConvArgs {
    const T* basis;       // [B'*O*K, TA, D]
    const T* x;           // [B'*O, TA, C]
    const T* g;           // [B'*O, TA, C], #4's output cotangent
    const int* src;       // [B', E], E = K*TA
    const float* win;     // [B', E]
    T* out;               // #3: [B'*O, TA, C]; #4: dbasis [B'*O*E, D], or dxc [B'*O*E, Cg]
    T* gxw;               // #4: the edge cotangent [B'*O*E, Cg]
    float* dwin_partial;  // #4 with the window cotangent: [2, B'*O*E]
    long long rows;       // edge rows: B'*O*E
    int O, K, TA, D, C, Cg;
    int tiles_t;          // 64-row tiles of a slot: ceil(TA / 64)
    int n_tiles;          // the kernel's tiles
    int kp;               // K-panels of one product
    int stages;           // ring slots
    bool tma;             // basis rows by TMA (else staged by the threads)
};

// the per-edge kernel pass of #4 (conv_kern_sm90.cu): kern = basis @ W per
// slot tile, dxc = round_T(kern * win * g[t]) into a.out, and with dwin the
// row sums of kern * g * x per warpgroup half into a.dwin_partial
template <class T>
int conv_kern_sm90(const ConvArgs<T>& a, const ConvPlan& plan, const CUtensorMap& w_map, int Bp,
                   cudaStream_t stream);

}  // namespace arreau

namespace {

using namespace arreau;

namespace conv90 {

template <class T>
constexpr int PK = 128 / (int)sizeof(T);  // elements of K a panel row holds
template <class T>
constexpr bool F32 = sizeof(T) == 4;

// ---- shared-memory operands ---------------------------------------------------

// a box of 64 rows x 128 bytes of the row-major matrix at src (row stride ld
// elements; rows >= nrows and elements >= ncols read as zeros) into dst in the
// 128-byte swizzle, as TMA writes the box: a 16-byte chunk a thread of the block
template <class T>
__device__ __forceinline__ void stage_box(unsigned char* dst, const T* src, long long ld,
                                          int nrows, int ncols) {
    constexpr int CH = 16 / sizeof(T);
    for (int e = threadIdx.x; e < ROWS * 8; e += BLOCK_THREADS) {
        const int r = e / 8, ch = e % 8;
        float v[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j)
            v[j] = r < nrows && ch * CH + j < ncols ? to_float(src[r * ld + ch * CH + j]) : 0.f;
        uint4 q;
        if constexpr (F32<T>) {
            q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                           __float_as_uint(v[3]));
        } else {
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) = q;
    }
}

// a float32 panel at a rewritten in place to its tf32 big halves, the small
// halves PANEL bytes further (split_tf32): each thread the chunks stage_box
// gives it, so a staged panel needs no barrier before its split
__device__ __forceinline__ void split_panel(unsigned char* a) {
    for (int e = threadIdx.x; e < ROWS * 8; e += BLOCK_THREADS) {
        const int r = e / 8, off = r * 128 + (((e % 8) ^ (r & 7)) << 4);
        uint4* p = reinterpret_cast<uint4*>(a + off);
        const uint4 v = *p;
        uint4 big, small;
        split_tf32(__uint_as_float(v.x), big.x, small.x);
        split_tf32(__uint_as_float(v.y), big.y, small.y);
        split_tf32(__uint_as_float(v.z), big.z, small.z);
        split_tf32(__uint_as_float(v.w), big.w, small.w);
        *p = big;
        *reinterpret_cast<uint4*>(a + PANEL + off) = small;
    }
}

// acc = (a slot tile's 64 basis rows) @ (the warpgroup's NB columns of B)
// over kp K-panels, the ring's panels q .. q + kp - 1 (A, and in float32 B,
// from the ring; bfloat16 B resident at w_res, kp panels of 2 NB rows).
// rows: the tile's first basis row, for the threads to stage where !tma
// (nrows rows of ld elements, ncols of them). Returns with the last panel's
// products in flight: the caller issues its epilogue's loads, then
// product_finish.
template <class T, int NB, class Issue>
__device__ __forceinline__ void slot_product(float (&acc)[NB / 2], Ring& ring, int q,
                                             int kp, const unsigned char* w_res, bool tma,
                                             const T* rows, int ld, int nrows, int ncols,
                                             Issue& issue) {
    const int wg = threadIdx.x / WG;
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    for (int p = 0; p < kp; ++p, ++q) {
        const int s = q % ring.stages;
        unsigned char* slot = ring.slot(s);
        if (!tma) {
            __syncthreads();  // every warp is past the products that last read the slot
            stage_box<T>(slot, rows + p * PK<T>, ld, nrows, ncols - p * PK<T>);
        }
        if (ring.on) mbar_wait(&ring.full[s], (q / ring.stages) & 1);
        if constexpr (F32<T>) split_panel(slot);
        if (!tma || F32<T>) {
            fence_proxy_async();
            __syncthreads();
        }
        if constexpr (F32<T>)
            panel_product<T, NB>(acc, slot, slot + 2 * PANEL + wg * NB * 128, 2 * NB * 128);
        else
            panel_product<T, NB>(acc, slot, w_res + p * (2 * NB * 128) + wg * NB * 128, 0);
        if (p > 0) {
            wgmma_wait<1>();
            fence_acc(acc);
            release(ring, q - 1, issue);
        }
    }
}

// bytes of a ring slot of the slot-tile products (#3, #4's kern): A, and in
// float32 its small half and both halves of B's 2 NB rows
template <class T>
__host__ __device__ constexpr int slot_bytes(int nb) {
    return F32<T> ? 2 * PANEL + 2 * (2 * nb * 128) : PANEL;
}

// a warpgroup's staging tile for the epilogues' loads and stores: 64 rows of
// NB elements, rows 16 bytes longer than NB (16-byte aligned for cp.async,
// the fragments' 4-byte accesses of a row's eight lanes on distinct banks)
template <class T>
__host__ __device__ constexpr int stage_ld(int nb) {
    return nb + 16 / (int)sizeof(T);
}
template <class T>
__host__ __device__ constexpr int stage_bytes(int nb) {
    return ROWS * stage_ld<T>(nb) * (int)sizeof(T);
}

// dynamic shared memory of the slot-tile products: bfloat16's resident B
// (kp panels of 2 NB rows), the ring, and the two warpgroups' staging tiles
// of stage_nb columns
template <class T>
__host__ __device__ constexpr size_t slot_smem(int nb, int kp, int stages, int stage_nb) {
    return 1024 + (F32<T> ? 0 : (size_t)kp * 2 * nb * 128) + (size_t)stages * slot_bytes<T>(nb) +
           2 * (size_t)stage_bytes<T>(stage_nb);
}

// ---- the epilogues' loads -----------------------------------------------------

template <class T>
struct PairOf {
    using type = float2;
};
template <>
struct PairOf<bf16> {
    using type = __nv_bfloat162;
};
template <class T>
using Pair = typename PairOf<T>::type;

__device__ __forceinline__ float2 pair_float(float2 v) { return v; }
__device__ __forceinline__ float2 pair_float(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// this thread's two rows of a warpgroup tile (m = 16 w + g + 8 h) at a
// neighbour slot: sender s (-1 on an empty slot or past TA) and window. The
// kernels load a slot's rows one slot (#3) or one tile (#4) ahead, so that
// the senders' features can be loaded before the slot's products and land
// under them.
struct SlotRows {
    int t[2], s[2];
    float w[2];
    __device__ __forceinline__ void load(const int* src, const float* win, int b, int k, int t0,
                                         int TA, int E) {
        const int i = threadIdx.x % WG, m = 16 * (i / 32) + i % 32 / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            t[h] = t0 + m + 8 * h;
            s[h] = -1;
            w[h] = 0.f;
            if (t[h] < TA) {
                const long long e = (long long)b * E + (long long)k * TA + t[h];
                const int v = src[e];
                const float wv = win[e];  // both loads in flight at once
                if (v >= 0 && v < TA) s[h] = v, w[h] = wv;
            }
        }
    }
};

// the warpgroup's staging tile (row stride stage_ld<T>(NB)): row r = row
// rows[r] of src (rows of C elements; -1: zeros), its NB columns from col0
// (zeros past C); 16-byte cp.async where vec (C * sizeof(T) a multiple of 16,
// src aligned), else element copies. The caller waits (cp_async_wait<0>)
// and syncs the warpgroup before reading it.
template <class T, int NB>
__device__ __forceinline__ void stage_rows(T* buf, const T* src, const int* rows, int col0, int C,
                                           bool vec) {
    constexpr int CH = 16 / sizeof(T), PER = NB / CH, LD = stage_ld<T>(NB);
    for (int i = threadIdx.x % WG; i < ROWS * PER; i += WG) {
        const int r = i / PER, c = i % PER * CH, row = rows[r];
        T* dst = buf + r * LD + c;
        const int n = row < 0 ? 0 : min(max(C - col0 - c, 0), CH);
        const T* p = src + (long long)max(row, 0) * C + col0 + c;
        if (vec) {
            cp_async16(dst, n ? p : src, n * (int)sizeof(T));
        } else {
#pragma unroll
            for (int j = 0; j < CH; ++j) dst[j] = j < n ? p[j] : from_float<T>(0.f);
        }
    }
    cp_async_commit();
}

// the warpgroup's staging tile (NB columns, row stride stage_ld<T>(NB)) out:
// row r < nrows to dst + r * ld, columns col0 + c < C; 16-byte stores where
// vec (dst, ld and col0 16-byte multiples), else element stores. The caller
// syncs the warpgroup before (the tile written) and after (before reusing it).
template <class T, int NB>
__device__ __forceinline__ void store_rows(const T* buf, T* dst, long long ld, int nrows, int col0,
                                           int C, bool vec) {
    constexpr int CH = 16 / sizeof(T), PER = NB / CH, LD = stage_ld<T>(NB);
    for (int i = threadIdx.x % WG; i < ROWS * PER; i += WG) {
        const int r = i / PER, c = i % PER * CH;
        if (r >= nrows || col0 + c >= C) continue;
        const T* q = buf + r * LD + c;
        T* p = dst + r * ld + col0 + c;
        if (vec) {
            *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
        } else {
            for (int j = 0; j < CH && col0 + c + j < C; ++j) p[j] = q[j];
        }
    }
}

// this thread's pair (m, n) of a staging tile
template <class T, int NB>
__device__ __forceinline__ Pair<T>& pair_at(T* buf, int m, int n) {
    return *reinterpret_cast<Pair<T>*>(buf + m * stage_ld<T>(NB) + n);
}
__device__ __forceinline__ float2 make_pair(float2*, float v0, float v1) {
    return make_float2(v0, v1);
}
__device__ __forceinline__ __nv_bfloat162 make_pair(__nv_bfloat162*, float v0, float v1) {
    return __floats2bfloat162_rn(v0, v1);
}
// (v0, v1) in T, as a staging tile's pair
template <class T>
__device__ __forceinline__ Pair<T> to_pair(float v0, float v1) {
    return make_pair(static_cast<Pair<T>*>(nullptr), v0, v1);
}

// ---- weights --------------------------------------------------------------------

// K-major, zero-padded copies of W [D, C] for the B operands: wt [2 nc, kd] =
// W^T (n: a column c, k: a row d) and, unless wk is null, wk [2 nd, kc] = W
// (n: a row d, k: a column c); float32 as tf32 big halves, then the small
// halves as many rows further (split_tf32)
template <class T>
__global__ void __launch_bounds__(arreau::THREADS)
weights_kernel(const T* __restrict__ w, T* __restrict__ wt, T* __restrict__ wk, int D, int C,
               int npc, int kd, int npd, int kc) {
    const long long n1 = (long long)npc * kd, n2 = wk ? (long long)npd * kc : 0;
    for (long long e = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; e < n1 + n2;
         e += (long long)gridDim.x * arreau::THREADS) {
        const bool first = e < n1;
        const long long i = first ? e : e - n1;
        const int kw = first ? kd : kc;
        const int n = (int)(i / kw), k = (int)(i % kw);
        float v = 0.f;
        if (first && n < C && k < D) v = to_float(w[(long long)k * C + n]);
        if (!first && n < D && k < C) v = to_float(w[(long long)n * C + k]);
        T* dst = first ? wt : wk;
        if constexpr (F32<T>) {
            uint32_t big, small;
            split_tf32(v, big, small);
            dst[i] = __uint_as_float(big);
            dst[(first ? n1 : n2) + i] = __uint_as_float(small);
        } else {
            dst[i] = from_float<T>(v);
        }
    }
}

// a tensor map of a weight copy (rows of kw elements), boxes of 2 nb rows
template <class T>
bool weight_map(CUtensorMap* map, const T* base, int nb, int kw) {
    return sw128_map<T>(map, base, kw, (F32<T> ? 2 : 1) * 2 * nb, (long long)kw * sizeof(T),
                        2 * nb);
}

// basis as [B'*O*K, TA, D]: 64-row boxes of one slot, clipped at TA
template <class T>
bool basis_map(CUtensorMap* map, const T* basis, int slabs, int TA, int D) {
    return sw128_map_3d<T>(map, basis, D, TA, slabs, (long long)D * sizeof(T),
                           (long long)TA * D * sizeof(T), ROWS);
}

// the plan's widths hold D and C, and its K-panels are whole
template <class T>
bool plan_fits(const ConvPlan& p, int D, int C) {
    return 2 * p.nc >= C && 2 * p.nd >= D && p.nw >= C && p.kd >= D && p.kc >= C &&
           p.kd % PK<T> == 0 && p.kc % PK<T> == 0 && p.cg >= C && p.cg % 8 == 0 && p.splits >= 1 &&
           p.per_split % ROWS == 0;
}

}  // namespace conv90

}  // namespace
