// #8 (basis_h1) and #7 (basis_mlp_bwd) in bfloat16 on Hopper's warpgroup
// products (wgmma) and the Tensor Memory Accelerator (TMA), wgmma.cuh's
// building blocks. Entry points: basis_h1_sm90.cu and basis_mlp_bwd_sm90.cu.
// (The float32 instantiations of #7 and #8 are basis_f32_sm90.cuh's; #5 and
// #6 keep the mma.sync products of basis_h1.cuh and basis_mlp_bwd.cuh.)
//
// One design serves the four kernels of this header. A block is two
// warpgroups; each owns 64 edge rows (wgmma's M) of the block's 128-row
// tile, or a 64-row slice of a weight gradient's rows. Every product's B
// operand comes through one ring of STAGES shared-memory panels (128 bytes
// of K a row, the 128-byte swizzle), wgmma.cuh's: TMA loads of the next
// panels stay in flight, each completing on its slot's `full` mbarrier, and
// the last warp to release a slot refills it, so that the warpgroups do not
// run in lockstep.
// The weights reach the ring from K-major, zero-padded copies (W1^T, W2^T
// and W2; TMA takes only row strides of 16-byte multiples), made once for
// each state of a weight with their tensor maps (basis_h1_sm90.cu:
// arreau_basis_weight_copy_sm90, kept by kernels/basis_h1.py); TMA
// fills everything outside a weight with zeros, so no width needs to
// divide a tile. A warpgroup multiplies one 64-row A panel by one B panel
// (four k16 steps) while it builds the next A panel, A from its own shared
// memory: the polynomial features it builds there panel by panel (formed
// in float32 from the invariants and rounded once to bfloat16, never in
// device memory), or the previous product's result. Every accumulator
// holds all N <= 256 columns of the product in registers (N = the width
// class NH of the hidden width H, ND of the basis width D; the columns
// beyond H or D multiply zeros). Persistent blocks, one an SM, walk the
// row tiles.
//
//   #8 (h1_kernel): h1_pre = poly @ W1 + b1, rounded once to bfloat16,
//     staged in shared memory as the 128-byte-swizzled 64 x 64 boxes of a
//     TMA store (rows whose byte length is a multiple of 16; any other H
//     is copied out by the threads). Where they fit, W1's panels each keep
//     a ring slot of their own and load once a block.
//   #7 (rows_kernel, then the split-K weight gradients): per tile, in
//     registers and shared memory,
//       1. h1_pre = poly @ W1 + b1; h1 = round(gelu(round(h1_pre))),
//          dg1 = round(gelu'(round(h1_pre))) (dg1 kept in shared memory);
//       2. dpre2 = round((g_0 + ... + g_{n-1}) * round(gelu'(round(h1 @ W2
//          + b2)))), the cotangents read once (prefetched into L2 while
//          epilogue 1 and h1 @ W2 run);
//       3. dpre1 = round((dpre2 @ W2^T) * dg1);
//     h1 (with db2's row of ones), dpre2 and dpre1 leave transposed
//     ([width, rows]: K-major for the weight gradients, 64-byte row runs).
//     Then dW2|db2 = [h1 | 1]^T dpre2 (dw2_kernel) and dW1|db1 = [poly |
//     1]^T dpre1 (dw1_kernel, the features built again, transposed, from the
//     invariants), each split over the rows in 64-row panels into float32
//     partials that sum_splits_kernel adds in split order: no atomics, so
//     every output repeats bit for bit.
// The rounding points are the JAX kernels' (pallas_basis.py:289-331 and
// :397-408), as in the mma.sync versions.
#pragma once

#include "common.cuh"
#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_product.cuh"
#include "wgmma.cuh"

namespace arreau {

constexpr int SM90_MAX_G = 16;  // cotangents one #7 launch sums

// #7's arguments (basis_mlp_bwd_sm90.cu), shared by the source files that
// hold its rows_kernel instantiations; the tensor maps of the weights'
// K-major copies W1^T (boxes of NH rows), W2^T (ND) and W2 (NH)
struct Sm90Bwd {
    const bf16 *attrT, *b1, *b2;
    const bf16* g[SM90_MAX_G];
    int n_g;
    CUtensorMap w1_map, w2t_map, w2c_map;
    bf16 *h1t, *dpre2t, *dpre1t;
    float* partial;
    long long rows, ld;
    int d, E, F, H, D, splits, per_split;
};

// rows_kernel<nh, 128> (basis_rows128_sm90.cu) and <nh, 256>
// (basis_rows256_sm90.cu): the instantiations compile in parallel
int sm90_rows_nd128(const Sm90Bwd& a, int nh, cudaStream_t stream);
int sm90_rows_nd256(const Sm90Bwd& a, int nh, cudaStream_t stream);

}  // namespace arreau

namespace {

using namespace arreau;

namespace sm90 {

constexpr int TILE = 2 * ROWS;     // a block's rows: two warpgroups
constexpr int PK = 64;             // bfloat16 elements of K a panel row holds
constexpr int STAGES = 3;          // ring slots (two where the warpgroups' tiles leave no room)
constexpr int PARTS = 12;          // 32-feature parts of up to 384 features
constexpr int MODEL_D = 6;         // the diffusion model's invariants: features from registers
constexpr int MAX_F = MAX_D + MAX_D * MAX_D + MAX_D * MAX_D * MAX_D;  // features of degree <= 3

// thread 0: panel q of `map` at (c0, c1) into its slot, box_rows x 128 bytes
__device__ __forceinline__ void load_panel(Ring& ring, int q, const CUtensorMap* map, int c0,
                                           int c1, int box_rows) {
    const int s = q % ring.stages;
    mbar_arrive_expect_tx(&ring.full[s], box_rows * 128);
    tma_load_2d(ring.slot(s), map, &ring.full[s], c0, c1);
}

// acc += A B^T over `panels` panels of the ring, the block's panels q, q + 1,
// ... (q is advanced past them), and ksteps k16 steps: a_panel(p, slot)
// returns the shared address of A's panel p (64 rows), called by the whole
// warpgroup before the panel's products (it may build the panel there, in
// one of two buffers that alternate, and must end with it visible to wgmma);
// B starts b_offset bytes into the slot. Panel p's products run while panel
// p + 1 is built: after issuing them the warpgroup waits only for panel p -
// 1's, then releases p - 1's slot. A ring that is not `on` holds W1's panels
// resident (h1_tiles): loaded once, never released.
template <int N, class APanel, class Issue>
__device__ __forceinline__ void ring_product(Ring& ring, int& q, float (&acc)[N / 2], int panels,
                                             int ksteps, APanel a_panel, Issue& issue,
                                             int b_offset = 0) {
    for (int p = 0; p < panels; ++p, ++q) {
        const int s = q % ring.stages;
        const unsigned char* a = a_panel(p, s);
        mbar_wait(&ring.full[s], ring.on ? (q / ring.stages) & 1 : 0);
        const unsigned char* b = ring.slot(s) + b_offset;
        const int steps = min(4, ksteps - 4 * p);
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (k < steps) Wgmma<bf16, N>::mma(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
        if (p > 0) release(ring, q - 1, issue);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (panels > 0) release(ring, q - 1, issue);
}

// the invariants of edge row `row` of the lane-major attrT [B'*O, d, E]
// (zeros past rows): x(j) = invariant j
struct RowInvariants {
    const bf16* p;  // invariant 0 of the row; invariant j lies j * E further
    int E;
    bool live;
    __device__ __forceinline__ RowInvariants(const bf16* attrT, long long row, long long rows,
                                             int d, int E_)
        : E(E_), live(row < rows) {
        const long long bo = live ? row / E_ : 0;
        p = attrT + bo * d * E_ + (row - bo * E_);
    }
    __device__ __forceinline__ float operator()(int j) const {
        return live ? to_float(p[(long long)j * E]) : 0.f;
    }
};

// the invariants of this thread's row: the model's d = MODEL_D in registers,
// any other d into the warpgroup's row r of s_x, which the panel builds read with
// each feature's factors from `terms` (fill_terms)
struct Invariants {
    float x[MODEL_D];
    const uint32_t* terms;
    __device__ __forceinline__ void load(const bf16* attrT, long long row, long long rows, int d,
                                         int E, float (*s_x)[MAX_D + 1], int r) {
        const RowInvariants a(attrT, row, rows, d, E);
        if (d == MODEL_D) {
#pragma unroll
            for (int j = 0; j < MODEL_D; ++j) x[j] = a(j);
        } else {
            for (int j = 0; j < d; ++j) s_x[r][j] = a(j);
        }
    }
};

// sink(v), v the features [32P, 32P + 32) of one edge from the model's
// invariants x, every factor a register (poly_features_part)
template <int P, class Sink>
__device__ __forceinline__ void model_part(const float (&x)[MODEL_D], int F, float one,
                                           const Sink& sink) {
    float v[32];
    poly_features_part<MODEL_D, 32, P>(x, F, one, v);
    sink(v);
}

// sink(v), v the features [f0, f0 + 32) of one edge as floats (f == F: `one`,
// beyond: 0); with the model's d the part's factors are fixed at compile
// time, any other d decodes each feature's factors (poly_term)
template <class Sink>
__device__ __forceinline__ void feature_part(const Invariants& inv, const float* s_x_row, int f0,
                                             int F, int d, float one, const Sink& sink) {
    if (d == MODEL_D) {
        static_assert(PARTS == 12, "one case a part");
        switch (f0 / 32) {
            case 0: model_part<0>(inv.x, F, one, sink); break;
            case 1: model_part<1>(inv.x, F, one, sink); break;
            case 2: model_part<2>(inv.x, F, one, sink); break;
            case 3: model_part<3>(inv.x, F, one, sink); break;
            case 4: model_part<4>(inv.x, F, one, sink); break;
            case 5: model_part<5>(inv.x, F, one, sink); break;
            case 6: model_part<6>(inv.x, F, one, sink); break;
            case 7: model_part<7>(inv.x, F, one, sink); break;
            case 8: model_part<8>(inv.x, F, one, sink); break;
            case 9: model_part<9>(inv.x, F, one, sink); break;
            case 10: model_part<10>(inv.x, F, one, sink); break;
            default: model_part<11>(inv.x, F, one, sink); break;
        }
    } else {
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int f = f0 + j;
            float val = f == F ? one : 0.f;
            if (f < F) {  // (x_a * x_b) * x_c, poly_value's order
                const uint32_t t = inv.terms[f];
                val = s_x_row[t & 255];
                if (t >> 24 > 1) val *= s_x_row[t >> 8 & 255];
                if (t >> 24 > 2) val *= s_x_row[t >> 16 & 255];
            }
            v[j] = val;
        }
        sink(v);
    }
}

// terms[f] = feature f's factors a | b << 8 | c << 16 | degree << 24
// (poly_term), decoded once a block for the panel builds of any d
__device__ __forceinline__ void fill_terms(uint32_t* terms, int F, int d) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const PolyTerm t = poly_term(f, d);
        terms[f] = t.a | t.b << 8 | t.c << 16 | t.deg << 24;
    }
}

// stores a row's 32 features as four 16-byte chunks of an A panel (rows:
// edges, K: features), half h of the panel's 64
struct RowsSink {
    unsigned char* dst;
    int r, half;
    __device__ __forceinline__ void operator()(const float (&v)[32]) const {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            uint4 q;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                h[e] = __floats2bfloat162_rn(v[8 * c + 2 * e], v[8 * c + 2 * e + 1]);
            *reinterpret_cast<uint4*>(dst + r * 128 + (((4 * half + c) ^ (r & 7)) << 4)) = q;
        }
    }
};

// stores an edge row's 32 features down a column of a transposed A panel
// (rows: features 32 half + j, K: edges)
struct FeaturesSink {
    unsigned char* dst;
    int r, half;
    __device__ __forceinline__ void operator()(const float (&v)[32]) const {
#pragma unroll
        for (int j = 0; j < 32; ++j)
            *reinterpret_cast<bf16*>(dst + sw128_offset<bf16>(32 * half + j, r, ROWS)) =
                __float2bfloat16_rn(v[j]);
    }
};

// A panel p of the warpgroup's 64 rows' features (rows: edges, K: features
// [64p, 64p + 64)), rounded to bfloat16, into dst: thread i forms row i % 64's
// features 64p + 32 (i / 64) .. + 32 and stores them as four 16-byte chunks
__device__ __forceinline__ void build_rows_panel(unsigned char* dst, const Invariants& inv,
                                                 const float* s_x_row, int p, int F, int d) {
    const int i = threadIdx.x % WG, r = i % ROWS, half = i / ROWS;
    feature_part(inv, s_x_row, 64 * p + 32 * half, F, d, 0.f, RowsSink{dst, r, half});
}

// A panel of [poly | 1]^T (rows: features [f0, f0 + 64), K: the 64 edge rows
// of the panel), into dst: thread i forms edge row i % 64's features f0 + 32
// (i / 64) .. + 32 (the ones column F where the row lies inside the split)
__device__ __forceinline__ void build_features_panel(unsigned char* dst, const Invariants& inv,
                                                     const float* s_x_row, int f0, int F, int d,
                                                     bool live) {
    const int i = threadIdx.x % WG, r = i % ROWS, half = i / ROWS;
    feature_part(inv, s_x_row, f0 + 32 * half, F, d, live ? 1.f : 0.f,
                 FeaturesSink{dst, r, half});
}

// dst[c * ld + row0 + r] = region (r, c) for r < nrows, c < ncols: the
// warpgroup's 64 x ncols tile (SW128, 64 rows) out transposed, 32 rows of a
// column a thread (four 16-byte stores: two whole 32-byte sectors;
// consecutive threads on consecutive columns, so the shared reads do not
// conflict)
__device__ __forceinline__ void store_transposed(const unsigned char* region, bf16* dst,
                                                 long long ld, long long row0, int nrows,
                                                 int ncols) {
    for (int i = threadIdx.x % WG; i < ncols * 2; i += WG) {
        const int c = i % ncols, r0 = i / ncols * 32;
        if (r0 >= nrows) continue;
        bf16 v[32];
#pragma unroll
        for (int e = 0; e < 32; ++e)
            v[e] = *reinterpret_cast<const bf16*>(region + sw128_offset<bf16>(r0 + e, c, ROWS));
        bf16* out = dst + c * ld + row0 + r0;
        if (r0 + 32 <= nrows) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                reinterpret_cast<uint4*>(out)[q] = reinterpret_cast<const uint4*>(v)[q];
        } else {
            for (int e = 0; e < nrows - r0; ++e) out[e] = v[e];
        }
    }
}

// f(r, c, v) for every 16-byte chunk (columns c .. c + 7) of the warpgroup's
// 64 x ncols bfloat16 tile in region (SW128), v its 8 values as floats,
// rounded back in place: the elementwise work of an epilogue in a loop,
// once, instead of unrolled over the accumulators
template <class Fn>
__device__ __forceinline__ void rewrite_chunks(unsigned char* region, int ncols, Fn f) {
    const int chunks = ncols / 8;
    for (int e = threadIdx.x % WG; e < ROWS * chunks; e += WG) {
        const int r = e / chunks, c = e % chunks * 8;
        uint4* at = reinterpret_cast<uint4*>(region + sw128_offset<bf16>(r, c, ROWS));
        uint4 q = *at;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 t = __bfloat1622float2(h[j]);
            v[2 * j] = t.x, v[2 * j + 1] = t.y;
        }
        f(r, c, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *at = q;
    }
}

// the bfloat16 pair (v0, v1) at element (m, n) of a 64-row SW128 tile
__device__ __forceinline__ void put_pair(unsigned char* region, int m, int n, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(region + sw128_offset<bf16>(m, n, ROWS)) =
        __floats2bfloat162_rn(v0, v1);
}

// ---- #8 -------------------------------------------------------------------

// out [rows, H] = round(poly(attrT) @ W1 + b1): the ring holds W1^T's panels
// (w1_map: boxes of NH rows of w1t), region (per warpgroup, NH / 64 panels)
// stages the output, `build` (per warpgroup, one panel) the features
template <int NH>
__device__ __forceinline__ void h1_tiles(const bf16* attrT, const float* s_b1, bf16* out,
                                         long long rows, int d, int E, int F, int H,
                                         const CUtensorMap* w1_map, const CUtensorMap* out_map,
                                         bool tma_store, Ring& ring, unsigned char* region,
                                         float (*s_x)[MAX_D + 1], const uint32_t* terms) {
    const int n_tiles = cdiv(rows, TILE), kp = cdiv(F, PK), ks = cdiv(F, 16);
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG;
    auto issue = [&](int q, int) { load_panel(ring, q, w1_map, q % kp * PK, 0, NH); };
    // with a slot for each of W1's panels they are loaded once, for every tile
    ring.on = ring.stages < kp;
    ring.total = ring.on ? block_tiles(n_tiles) * kp : kp;
    ring_start(ring, issue);
    int q = 0;
    Invariants inv;
    inv.terms = terms;
    inv.load(attrT, (long long)blockIdx.x * TILE + wg * ROWS + i % ROWS, rows, d, E, s_x, i % ROWS);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long long row0 = (long long)t * TILE + wg * ROWS;
        if (tma_store && i == 0) tma_store_wait_read<0>();  // the last tile's stores have read region
        wg_sync();  // the previous tile's stores and copies are done with region and s_x
        float acc[NH / 2] = {};
        ring_product<NH>(ring, q, acc, kp, ks, [&](int p, int) {
            wg_sync();  // every warp is done with the products of panel p - 2
            unsigned char* dst = region + p % 2 * PANEL;
            build_rows_panel(dst, inv, s_x[i % ROWS], p, F, d);
            fence_proxy_async();
            wg_sync();
            return dst;
        }, issue);
        wg_sync();  // every warp's products are done with the built panels
        // the next tile's invariants, their loads in flight during the epilogue
        inv.load(attrT, row0 + (long long)gridDim.x * TILE + i % ROWS, rows, d, E, s_x, i % ROWS);
        wgmma_for_each<NH>(acc, [&](int, int m, int n, float v0, float v1) {
            put_pair(region, m, n, v0 + s_b1[n], v1 + s_b1[n + 1]);
        });
        const int nrows = (int)min((long long)ROWS, rows - row0);
        if (tma_store) {
            fence_proxy_async();
            wg_sync();
            if (i == 0 && nrows > 0) {
                for (int p = 0; p < cdiv(H, PK); ++p)
                    tma_store_2d(out_map, region + p * PANEL, p * PK, (int)row0);
                tma_store_commit();
            }
        } else {
            wg_sync();
            for (int e = i; e < nrows * H; e += WG) {
                const int m = e / H, n = e % H;
                out[(row0 + m) * H + n] =
                    *reinterpret_cast<const bf16*>(region + sw128_offset<bf16>(m, n, ROWS));
            }
        }
    }
    if (tma_store && i == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a warpgroup's shared memory in h1_kernel: the built panels (two) and,
// after them, the output tile staged for its TMA stores (NH / 64 panels)
__host__ __device__ constexpr int h1_area(int NH) {
    return (cdiv(NH, PK) > 2 ? cdiv(NH, PK) : 2) * PANEL;
}

template <int NH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
h1_kernel(const bf16* __restrict__ attrT, const bf16* __restrict__ b1, bf16* __restrict__ out,
          long long rows, int d, int E, int F, int H, const __grid_constant__ CUtensorMap w1_map,
          const __grid_constant__ CUtensorMap out_map, bool tma_store, int stages) {
    __shared__ uint64_t full[MAX_STAGES];
    __shared__ int released[MAX_STAGES];
    __shared__ float s_x[2][ROWS][MAX_D + 1];
    __shared__ float s_b1[NH];  // b1, zero past H
    __shared__ uint32_t terms[MAX_F];
    for (int n = threadIdx.x; n < NH; n += BLOCK_THREADS) s_b1[n] = n < H ? to_float(b1[n]) : 0.f;
    fill_terms(terms, F, d);
    unsigned char* smem = aligned_smem();
    Ring ring{full, released, smem, NH * 128, stages, 0, true};
    const int wg = threadIdx.x / WG;
    unsigned char* region = smem + stages * NH * 128 + wg * h1_area(NH);
    h1_tiles<NH>(attrT, s_b1, out, rows, d, E, F, H, &w1_map, &out_map, tma_store, ring, region,
                 s_x[wg], terms);
}

// h1_kernel's shared memory with `stages` ring slots
template <int NH>
constexpr size_t h1_smem(int stages) {
    return 1024 + (size_t)stages * NH * 128 + 2 * h1_area(NH);
}

// ---- #7 -------------------------------------------------------------------

struct Cotangents {
    const bf16* g[SM90_MAX_G];
    int n;
};

// epilogue 2 where the cotangents' rows are 16-byte aligned (D a multiple of
// 8): region (64 x ND, SW128) holds round(h2_pre), rewritten in place to
// dpre2 = round(g * round(gelu'(h2_pre))), g = g_0 + ... + g_{n-1} in float32
// in that order. The tile's cotangent rows were prefetched into L2 before
// epilogue 1; a thread takes four 8-column chunks at a time and
// keeps four cotangents' 16-byte loads of each in flight (16 loads).
template <int ND>
__device__ __forceinline__ void dpre2_chunks(unsigned char* region, const Cotangents& gs,
                                             long long row0, int nrows, int Dw) {
    constexpr int CHUNKS = ND / 8, ITEMS = ROWS * CHUNKS, STEP = 4 * WG;
    for (int e0 = threadIdx.x % WG; e0 < ITEMS; e0 += STEP) {
        float g[4][8] = {};
        for (int u0 = 0; u0 < gs.n; u0 += 4) {
            uint4 raw[4][4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int e = e0 + k * WG, r = e / CHUNKS, c = e % CHUNKS * 8;
                    raw[k][u] = make_uint4(0, 0, 0, 0);
                    if (e < ITEMS && r < nrows && c < Dw && u0 + u < gs.n)
                        raw[k][u] = __ldcg(reinterpret_cast<const uint4*>(
                            gs.g[u0 + u] + (row0 + r) * Dw + c));
                }
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (u0 + u < gs.n) {
                        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[k][u]);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const float2 f = __bfloat1622float2(h[j]);
                            g[k][2 * j] = u0 + u == 0 ? f.x : g[k][2 * j] + f.x;
                            g[k][2 * j + 1] = u0 + u == 0 ? f.y : g[k][2 * j + 1] + f.y;
                        }
                    }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int e = e0 + k * WG, r = e / CHUNKS, c = e % CHUNKS * 8;
            if (e >= ITEMS) continue;
            uint4* at = reinterpret_cast<uint4*>(region + sw128_offset<bf16>(r, c, ROWS));
            uint4 q = *at;
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 pre = __bfloat1622float2(h[j]);
                const float v0 = c + 2 * j < Dw ? g[k][2 * j] * round_to<bf16>(gelu_deriv(pre.x)) : 0.f;
                const float v1 =
                    c + 2 * j + 1 < Dw ? g[k][2 * j + 1] * round_to<bf16>(gelu_deriv(pre.y)) : 0.f;
                h[j] = __floats2bfloat162_rn(v0, v1);
            }
            *at = q;
        }
    }
}

// per tile: the three row-local products (see the header), h1^T | 1, dpre2^T
// and dpre1^T out to h1t [H + 1, ld], dpre2t [D, ld], dpre1t [H, ld]
template <int NH, int ND>
__device__ __forceinline__ void rows_tiles(const bf16* attrT, const float* s_b1, const float* s_b2,
                                           const Cotangents& gs, bf16* h1t, bf16* dpre2t,
                                           bf16* dpre1t, long long rows, long long ld, int d,
                                           int E, int F, int H, int Dw, const CUtensorMap* w1_map,
                                           const CUtensorMap* w2t_map, const CUtensorMap* w2_map,
                                           Ring& ring, unsigned char* region,
                                           unsigned char* dg1s, float (*s_x)[MAX_D + 1],
                                           const uint32_t* terms) {
    const int n_tiles = cdiv(rows, TILE);
    const int kp1 = cdiv(F, PK), ks1 = cdiv(F, 16);
    const int ks2 = cdiv(H, 16), kp2 = cdiv(ks2, 4);
    const int ks3 = cdiv(Dw, 16), kp3 = cdiv(ks3, 4);
    const int per_tile = kp1 + kp2 + kp3;
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG;
    const bool vec = Dw % 8 == 0;  // the cotangents' rows are 16-byte aligned
    auto issue = [&](int q, int) {
        const int p = q % per_tile;
        if (p < kp1)
            load_panel(ring, q, w1_map, p * PK, 0, NH);
        else if (p < kp1 + kp2)
            load_panel(ring, q, w2t_map, (p - kp1) * PK, 0, ND);
        else
            load_panel(ring, q, w2_map, (p - kp1 - kp2) * PK, 0, NH);
    };
    ring.total = block_tiles(n_tiles) * per_tile;
    ring_start(ring, issue);
    int q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long long row0 = (long long)t * TILE + wg * ROWS;
        const int nrows = (int)max(0LL, min((long long)ROWS, rows - row0));
        Invariants inv;
        inv.terms = terms;
        wg_sync();  // the previous tile is done with region and s_x
        inv.load(attrT, row0 + i % ROWS, rows, d, E, s_x, i % ROWS);

        // 1. h1_pre = poly @ W1 + b1
        float acc1[NH / 2] = {};
        ring_product<NH>(ring, q, acc1, kp1, ks1, [&](int p, int) {
            wg_sync();
            unsigned char* dst = region + p % 2 * PANEL;
            build_rows_panel(dst, inv, s_x[i % ROWS], p, F, d);
            fence_proxy_async();
            wg_sync();
            return dst;
        }, issue);
        // the tile's cotangent rows into L2 while epilogue 1 and the next product run
        const unsigned g_bytes = (unsigned)(nrows * Dw * 2) / 16 * 16;
        if (vec && i < gs.n && g_bytes > 0) prefetch_l2(gs.g[i] + row0 * Dw, g_bytes);
        wg_sync();
        wgmma_for_each<NH>(acc1, [&](int, int m, int n, float v0, float v1) {
            put_pair(region, m, n, v0 + s_b1[n], v1 + s_b1[n + 1]);
        });
        wg_sync();
        // region: round(h1_pre) -> h1; dg1s [64, NH] = round(gelu'(h1_pre))
        rewrite_chunks(region, NH, [&](int r, int c, float(&v)[8]) {
            float g[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float h;
                gelu_and_deriv(v[j], h, g[j]);
                v[j] = c + j < H ? h : 0.f;
                g[j] = c + j < H ? g[j] : 0.f;
            }
            uint4 q;
            __nv_bfloat162* gq = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < 4; ++j) gq[j] = __floats2bfloat162_rn(g[2 * j], g[2 * j + 1]);
            *reinterpret_cast<uint4*>(dg1s + 2 * (r * NH + c)) = q;
        });
        fence_proxy_async();
        wg_sync();
        store_transposed(region, h1t, ld, row0, nrows, H);
        if (i < nrows) h1t[H * ld + row0 + i] = __float2bfloat16_rn(1.f);  // db2's row

        // 2. dpre2 = round(g * round(gelu'(round(h1 @ W2 + b2))))
        float acc2[ND / 2] = {};
        ring_product<ND>(ring, q, acc2, kp2, ks2, [&](int p, int) { return region + p * PANEL; },
                         issue);
        wg_sync();  // every warp's products have read h1
        wgmma_for_each<ND>(acc2, [&](int, int m, int n, float v0, float v1) {
            put_pair(region, m, n, v0 + s_b2[n], v1 + s_b2[n + 1]);
        });
        wg_sync();
        // region: round(h2_pre) -> dpre2, the cotangents summed in order
        if (vec) {
            dpre2_chunks<ND>(region, gs, row0, nrows, Dw);
        } else {
            rewrite_chunks(region, ND, [&](int r, int c, float(&v)[8]) {
            float g[8] = {};
            if (r < nrows && c < Dw) {
                const long long at = (row0 + r) * Dw + c;
                const int count = min(8, Dw - c);
                for (int u0 = 0; u0 < gs.n; u0 += 4) {  // four loads in flight
                    float gu[4][8];
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (u0 + k < gs.n) load_chunk(gu[k], gs.g[u0 + k] + at, count, false);
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (u0 + k < gs.n)
#pragma unroll
                            for (int j = 0; j < 8; ++j)
                                g[j] = u0 + k == 0 ? gu[k][j] : g[j] + gu[k][j];
                }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
                v[j] = c + j < Dw ? g[j] * round_to<bf16>(gelu_deriv(v[j])) : 0.f;
            });
        }
        fence_proxy_async();
        wg_sync();
        store_transposed(region, dpre2t, ld, row0, nrows, Dw);

        // 3. dpre1 = round((dpre2 @ W2^T) * dg1)
        float acc3[NH / 2] = {};
        ring_product<NH>(ring, q, acc3, kp3, ks3, [&](int p, int) { return region + p * PANEL; },
                         issue);
        wg_sync();
        wgmma_for_each<NH>(acc3, [&](int, int m, int n, float v0, float v1) {
            const float2 g =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dg1s + 2 * (m * NH + n)));
            put_pair(region, m, n, v0 * g.x, v1 * g.y);
        });
        wg_sync();
        store_transposed(region, dpre1t, ld, row0, nrows, H);
    }
}

// ring slots of rows_kernel: its shared memory holds the slots, and per
// warpgroup the A tiles and dg1 (64 x NH): three slots but at NH = 256
__host__ __device__ constexpr int rows_stages(int NH) { return NH > 208 ? 2 : STAGES; }

template <int NH, int ND>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
rows_kernel(const bf16* __restrict__ attrT, const bf16* __restrict__ b1,
            const bf16* __restrict__ b2, Cotangents gs, bf16* __restrict__ h1t,
            bf16* __restrict__ dpre2t, bf16* __restrict__ dpre1t, long long rows, long long ld,
            int d, int E, int F, int H, int Dw, const __grid_constant__ CUtensorMap w1_map,
            const __grid_constant__ CUtensorMap w2t_map,
            const __grid_constant__ CUtensorMap w2_map) {
    __shared__ uint64_t full[STAGES];
    __shared__ int released[STAGES];
    __shared__ float s_x[2][ROWS][MAX_D + 1];
    __shared__ float s_b1[NH], s_b2[ND];  // the biases, zero past H and D
    for (int n = threadIdx.x; n < NH; n += BLOCK_THREADS) s_b1[n] = n < H ? to_float(b1[n]) : 0.f;
    for (int n = threadIdx.x; n < ND; n += BLOCK_THREADS) s_b2[n] = n < Dw ? to_float(b2[n]) : 0.f;
    __shared__ uint32_t terms[MAX_F];
    fill_terms(terms, F, d);
    constexpr int NMAX = NH > ND ? NH : ND, RS = rows_stages(NH), SLOT = NMAX * 128;
    constexpr int REGION = cdiv(NMAX, PK) * PANEL + ROWS * NH * 2;
    unsigned char* smem = aligned_smem();
    Ring ring{full, released, smem, SLOT, RS, 0, true};
    const int wg = threadIdx.x / WG;
    unsigned char* region = smem + RS * SLOT + wg * REGION;
    unsigned char* dg1s = region + cdiv(NMAX, PK) * PANEL;
    rows_tiles<NH, ND>(attrT, s_b1, s_b2, gs, h1t, dpre2t, dpre1t, rows, ld, d, E, F, H, Dw, &w1_map,
                       &w2t_map, &w2_map, ring, region, dg1s, s_x[wg], terms);
}

template <int NH, int ND>
constexpr size_t rows_smem() {
    constexpr int NMAX = NH > ND ? NH : ND;
    return 1024 + rows_stages(NH) * NMAX * 128 + 2 * (cdiv(NMAX, PK) * PANEL + ROWS * NH * 2);
}

// partial[split, m, n] = sum over the split's rows k of A[m, k] B[n, k], A =
// h1t's rows (a_map: boxes of 128 rows, the block's two 64-row slices), B =
// dpre2t (b_map: boxes of ND rows); rows of M = H + 1, N = D
template <int ND>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
dw2_kernel(float* __restrict__ partial, long long rows, int per_split, int M, int N,
           const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map) {
    __shared__ uint64_t full[STAGES];
    __shared__ int released[STAGES];
    constexpr int SLOT = TILE * 128 + ND * 128;
    unsigned char* smem = aligned_smem();
    Ring ring{full, released, smem, SLOT, STAGES, 0, true};
    const int wg = threadIdx.x / WG, m0 = blockIdx.x * TILE;
    const long long k0 = (long long)blockIdx.y * per_split;
    const int K = (int)min((long long)per_split, rows - k0), kp = cdiv(K, PK);
    auto issue = [&](int q, int s) {
        mbar_arrive_expect_tx(&ring.full[s], SLOT);
        tma_load_2d(ring.slot(s), &a_map, &ring.full[s], (int)(k0 + q * PK), m0);
        tma_load_2d(ring.slot(s) + TILE * 128, &b_map, &ring.full[s], (int)(k0 + q * PK), 0);
    };
    ring.total = kp;
    ring_start(ring, issue);
    int q = 0;
    // A's panel is this warpgroup's 64 rows of the slot; B follows both
    float acc[ND / 2] = {};
    ring_product<ND>(ring, q, acc, kp, 4 * kp,
                     [&](int, int s) { return ring.slot(s) + wg * PANEL; }, issue, TILE * 128);
    float* out = partial + (size_t)blockIdx.y * M * N;
    const int mw = m0 + wg * ROWS;
    wgmma_for_each<ND>(acc, [&](int, int m, int n, float v0, float v1) {
        if (mw + m >= M) return;
        if (n < N) out[(size_t)(mw + m) * N + n] = v0;
        if (n + 1 < N) out[(size_t)(mw + m) * N + n + 1] = v1;
    });
}

template <int ND>
constexpr size_t dw2_smem() {
    return 1024 + STAGES * (TILE * 128 + ND * 128);
}

// partial[split, f, h] = sum over the split's rows k of [poly | 1][k, f]
// dpre1[k, h]: A built per panel from the rows' invariants (features [f0,
// f0 + 64) of this warpgroup), B = dpre1t (b_map: boxes of NH rows); rows of
// M = F + 1, N = H
template <int NH>
__device__ __forceinline__ void dw1_split(const bf16* attrT, float* partial, long long rows,
                                          int per_split, int d, int E, int F, int H,
                                          const CUtensorMap* b_map, Ring& ring,
                                          unsigned char* build, float (*s_x)[MAX_D + 1],
                                          const uint32_t* terms) {
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG;
    const int M = F + 1, f0 = blockIdx.x * TILE + wg * ROWS;
    const long long k0 = (long long)blockIdx.y * per_split;
    const int K = (int)min((long long)per_split, rows - k0), kp = cdiv(K, PK);
    auto issue = [&](int q, int) { load_panel(ring, q, b_map, (int)(k0 + q * PK), 0, NH); };
    ring.total = kp;
    ring_start(ring, issue);
    int q = 0;
    float acc[NH / 2] = {};
    ring_product<NH>(ring, q, acc, kp, 4 * kp, [&](int p, int) {
        const int r = i % ROWS;
        const bool live = p * PK + r < K;  // inside the split (and so inside rows)
        Invariants inv;
        inv.terms = terms;
        wg_sync();  // every warp is done with the previous panel and s_x
        inv.load(attrT, live ? k0 + p * PK + r : rows, rows, d, E, s_x, r);
        unsigned char* dst = build + p % 2 * PANEL;
        build_features_panel(dst, inv, s_x[r], f0, F, d, live);
        fence_proxy_async();
        wg_sync();
        return dst;
    }, issue);
    float* out = partial + (size_t)blockIdx.y * M * H;
    wgmma_for_each<NH>(acc, [&](int, int m, int n, float v0, float v1) {
        if (f0 + m >= M) return;
        if (n < H) out[(size_t)(f0 + m) * H + n] = v0;
        if (n + 1 < H) out[(size_t)(f0 + m) * H + n + 1] = v1;
    });
}

template <int NH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
dw1_kernel(const bf16* __restrict__ attrT, float* __restrict__ partial, long long rows,
           int per_split, int d, int E, int F, int H, const __grid_constant__ CUtensorMap b_map) {
    __shared__ uint64_t full[STAGES];
    __shared__ int released[STAGES];
    __shared__ float s_x[2][ROWS][MAX_D + 1];
    __shared__ uint32_t terms[MAX_F];
    fill_terms(terms, F, d);
    unsigned char* smem = aligned_smem();
    Ring ring{full, released, smem, NH * 128, STAGES, 0, true};
    const int wg = threadIdx.x / WG;
    unsigned char* build = smem + STAGES * NH * 128 + wg * 2 * PANEL;
    dw1_split<NH>(attrT, partial, rows, per_split, d, E, F, H, &b_map, ring, build, s_x[wg],
                  terms);
}

template <int NH>
constexpr size_t dw1_smem() {
    return 1024 + STAGES * NH * 128 + 4 * PANEL;
}

// rows_kernel<NH, ND>'s launch
template <int NH, int ND>
int launch_rows(const Sm90Bwd& a, cudaStream_t stream) {
    constexpr size_t smem = rows_smem<NH, ND>();
    static SmemOptIn opt_in;
    cudaError_t err = opt_in.ensure(rows_kernel<NH, ND>, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Cotangents gs{};
    gs.n = a.n_g;
    for (int i = 0; i < a.n_g; ++i) gs.g[i] = a.g[i];
    rows_kernel<NH, ND><<<persistent_blocks(cdiv(a.rows, TILE)), BLOCK_THREADS, smem, stream>>>(
        a.attrT, a.b1, a.b2, gs, a.h1t, a.dpre2t, a.dpre1t, a.rows, a.ld, a.d, a.E, a.F, a.H, a.D,
        a.w1_map, a.w2t_map, a.w2c_map);
    return static_cast<int>(cudaGetLastError());
}

template <int ND>
int launch_rows_nh(const Sm90Bwd& a, int nh, cudaStream_t stream) {
    switch (nh) {
        case 64: return launch_rows<64, ND>(a, stream);
        case 128: return launch_rows<128, ND>(a, stream);
        case 208: return launch_rows<208, ND>(a, stream);
        case 256: return launch_rows<256, ND>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace sm90

}  // namespace
