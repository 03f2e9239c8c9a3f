// #8 (basis_h1) and #7 (basis_mlp_bwd) in float32 on Hopper's tf32 warpgroup
// products (wgmma) and the Tensor Memory Accelerator (TMA), as 3xTF32:
// every product step multiplies tf32 big and small halves (split_tf32) in
// mma.cuh's order, a_small b_big + a_big b_small + a_big b_big, k8 steps in
// ascending K. Entry points: basis_h1_sm90.cu and basis_mlp_bwd_sm90.cu; the
// kernels' instantiations sit in basis_h1_f32_sm90.cu, basis_rows_f32_sm90.cu
// and basis_dw_f32_sm90.cu, which compile in parallel. (The bfloat16
// instantiations are basis_sm90.cuh's.)
//
// Replaces pallas_basis.py:_h1_fwd (body :397, pallas_call :415) and
// _multi_bwd (body :289, pallas_call :341); the math is in
// basis_h1_sm90.cu and basis_mlp_bwd_sm90.cu.
//
// Bound on the H100: the operations. At the training shape (524288 rows, F
// = 258, H = 200, D = 256) #8 is 54 GFLOP and #7 five products of that
// size, 269 GFLOP, against 165 TFLOP/s of 3xTF32 (495 / 3): 0.33 and 1.63
// ms. #7 also reads its n_g float32 cotangents once (2.7 GB at five).
//
// One design serves the products. A block is two warpgroups, each on 64 of
// the block's 128 rows with all N <= 256 columns of the product in one
// accumulator (N the width class NH of H or ND of D; the columns beyond H or
// D multiply the zeros of the weights' padding), so a row's A operand is
// formed or read once, and each B panel feeds 128 rows. B is a weight's
// K-major float32 copy (basis_h1_sm90.cu: arreau_basis_weight_copy_sm90, made
// once for each state of the weight, zero-padded to NB rows): its tf32
// halves would not stay resident (~420 KB for W1 at 258 x 208), so it
// streams through wgmma.cuh's ring, a 32-element K-panel a slot, by TMA,
// and the block's threads split each panel into its tf32 halves where it
// lands (the small halves NB rows further): half the L2 bytes of streaming
// both halves, and half the copy's memory, for a block-wide barrier a
// panel. (Development builds measured no gain from the halved bytes: they
// are not what holds the passes.) The last warp to release a slot refills
// it. A is each warpgroup's 64 x 32 panel in the same slot: the
// polynomial features built there by the warpgroup's threads (#8, and #7's
// first product), or a row-major float32 scratch read by TMA; either is
// split into its tf32 halves as it is written (the small halves a panel
// further), so the [rows, F] features never reach device memory.
// Persistent blocks, one an SM, walk the 128-row tiles; the ring's panel
// count runs on across a block's tiles. The epilogues read and write device
// memory from the accumulators' registers: a warp's store of a column pair
// covers eight rows of 32 whole bytes each.
//
//   #8 (f32_h1_kernel): out [rows, H] = poly @ W1 + b1.
//   #7, in five passes on the caller's stream:
//     1. f32_h1_kernel: h1_pre = poly @ W1 + b1 into a scratch [rows, hp]
//        (hp = H rounded up to 4: rows of 16-byte multiples, which TMA
//        reads);
//     2. f32_rows_kernel<DPRE2>: gelu'(gelu(h1_pre) @ W2 + b2), A = h1_pre by
//        TMA with GELU applied as it is split, into a scratch [rows, dp];
//        then dpre2_scale_kernel, a streaming pass: dpre2 = (g_0 + ... +
//        g_{n-1}) * that, in place, the cotangents read once and summed in
//        order. (A development build that summed them in the product's
//        epilogue, from the accumulators' layout, took longer than these
//        two passes together: a warpgroup's loads in flight could not cover
//        the latency of the 2.7 GB read.)
//     3. f32_rows_kernel<DPRE1>: dpre1 = (dpre2 @ W2^T) * gelu'(h1_pre), A =
//        dpre2 by TMA; into a scratch [rows, hp];
//     4. f32_dw_kernel<ND, false>: dW2|db2 = [gelu(h1_pre) | 1]^T dpre2, and
//     5. f32_dw_kernel<NH, true>: dW1|db1 = [poly | 1]^T dpre1 (the features
//        built again from the invariants), each split over the rows into
//        float32 partials that sum_splits_kernel adds in split order. tf32
//        wgmma takes K-major operands only, and both of a weight gradient's
//        contract over the rows, so the block's threads stage 32-row panels
//        transposed (#4's float32 dW, spatial_conv_bwd_sm90.cu: DwF32Panel),
//        loaded into registers a panel ahead. (A build whose row passes also
//        wrote h1, dpre2 and dpre1 transposed, [width, rows], and whose
//        weight gradients took both operands by TMA, split in place, was
//        slower on an H100: #7 7.86 against 7.48 ms at the training shape.
//        It wrote 0.96 GB more, and each of its panels made a further
//        round trip through shared memory, TMA's write and the split's read,
//        which the products share; PERF.md §6.)
//   Device memory: the three scratches written once (dpre2 twice) and read
//   three times (h1_pre), four times (dpre2: dW2 reads its B operand once
//   for each of its two 128-row blocks of H + 1) or three times (dpre1: dW1's
//   three blocks of F + 1): at the training shape 1.91 GB written and 4.66 GB
//   read, beside the cotangents' 2.68 GB.
//   In bfloat16 one row kernel holds h1, dg1 and dpre2 in shared memory
//   (basis_sm90.cuh); with tf32 halves h1 alone would take 106 KB a
//   warpgroup at NH = 208, so float32 passes its intermediates through
//   device memory.
//
// Every sum runs in a fixed order (ascending K in k8 steps, the splits in
// split order, the cotangents in their order) and no atomic touches an
// output, so every output repeats bit for bit. The float32 chain rounds
// nowhere between its products (the JAX kernel's points, pallas_basis.py:
// 289-331, are the identity in float32).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_product.cuh"
#include "wgmma.cuh"

namespace arreau {

constexpr int F32_MAX_G = 16;  // cotangents one #7 launch sums

// The host-side plan of #8 and #7 in both types (kernels/basis_h1.py:
// sm90_plan, the one place that sizes them); the launches check it. ld: the
// row length of bfloat16 #7's transposed scratch; nh, nd: the width classes
// of H and D; kw1, kw2, kw3: F, H, D rounded up to a K-panel (64 bfloat16 or
// 32 float32 elements), the row lengths of the weights' K-major copies; hp,
// dp: H and D rounded up to 4, float32 #7's scratch rows; tma_store:
// bfloat16 #8's rows by TMA; the weight gradients' splits; and float32's
// ring slots (or stage buffers) and dynamic shared memory of the kernels
// whose product is nh wide (h_*: #8 and #7's first pass, dpre1, dW1) or nd
// wide (d_*: dpre2, dW2), every slot row_slot(N) bytes.
struct BasisPlan {
    long long ld;
    int nh, nd, kw1, kw2, kw3, hp, dp, tma_store;
    int splits, per_split;
    int h_stages, h_smem, d_stages, d_smem;
};

// float32 #7's tensors, as its kernels take them
struct F32Bwd {
    const float *attrT, *b1, *b2;  // attrT [B'*O, d, E]
    const float* g[F32_MAX_G];      // n_g x [rows, D]
    int n_g;
    float *h1pre, *dpre2, *dpre1;   // [rows, hp], [rows, dp], [rows, hp]
    float* partial;                 // [splits, max((F+1) H, (H+1) D)]
    long long rows;
    int d, E, F, H, D, hp, dp;
};

// the passes (basis_h1_f32_sm90.cu, basis_rows_f32_sm90.cu,
// basis_dw_f32_sm90.cu); out [rows, ld] = poly @ W1 + b1
int f32_h1(const float* attrT, const float* b1, float* out, long long ld, long long rows, int d,
           int E, int F, int H, const CUtensorMap& w1_map, const BasisPlan& p,
           cudaStream_t stream);
int f32_dpre2(const F32Bwd& a, const CUtensorMap& w2t_map, const BasisPlan& p,
              cudaStream_t stream);
int f32_dpre1(const F32Bwd& a, const CUtensorMap& w2c_map, const BasisPlan& p,
              cudaStream_t stream);
// dw2_ext [H+1, D] = [dW2; db2], dw1_ext [F+1, H] = [dW1; db1], through a.partial
int f32_dw2(const F32Bwd& a, float* dw2_ext, const BasisPlan& p, cudaStream_t stream);
int f32_dw1(const F32Bwd& a, float* dw1_ext, const BasisPlan& p, cudaStream_t stream);

}  // namespace arreau

namespace {

namespace basis32 {

using namespace arreau;

constexpr int TILE = 2 * ROWS;  // a block's rows: two warpgroups of 64
constexpr int FK = 32;          // float32 elements of K a 128-byte panel row holds
constexpr int MAX_F = MAX_D + MAX_D * MAX_D + MAX_D * MAX_D * MAX_D;  // features of degree <= 3

// bytes of a ring slot (or of a weight gradient's stage buffer): both
// warpgroups' A panels (tf32 big half, then small), then the N rows of B's
// big halves, then their small halves
__host__ __device__ constexpr int row_slot(int n) { return 4 * PANEL + 2 * n * 128; }

// terms[f] = feature f's factors a | b << 8 | c << 16 | degree << 24
// (poly_term), decoded once a block
__device__ __forceinline__ void fill_terms(uint32_t* terms, int F, int d) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const PolyTerm t = poly_term(f, d);
        terms[f] = t.a | t.b << 8 | t.c << 16 | t.deg << 24;
    }
}

// feature f of the edge whose invariants are x, (x_a * x_b) * x_c as
// poly_feature forms it; f == F: `one` (the bias column); beyond: 0
__device__ __forceinline__ float feature(const uint32_t* terms, const float* x, int f, int F,
                                         float one) {
    if (f >= F) return f == F ? one : 0.f;
    const uint32_t t = terms[f];
    float v = x[t & 255];
    if (t >> 24 > 1) v *= x[t >> 8 & 255];
    if (t >> 24 > 2) v *= x[t >> 16 & 255];
    return v;
}

// four floats as one 16-byte chunk of tf32 big halves at p and one of small
// halves `small` bytes further
__device__ __forceinline__ void put_split(unsigned char* p, int small, const float (&v)[4]) {
    uint4 big, lo;
    split_tf32(v[0], big.x, lo.x);
    split_tf32(v[1], big.y, lo.y);
    split_tf32(v[2], big.z, lo.z);
    split_tf32(v[3], big.w, lo.w);
    *reinterpret_cast<uint4*>(p) = big;
    *reinterpret_cast<uint4*>(p + small) = lo;
}

// invariant j of edge row `row` of the lane-major attrT [B'*O, d, E]
__device__ __forceinline__ float invariant(const float* attrT, long long row, int j, int d, int E) {
    const long long bo = row / E;
    return attrT[(bo * d + j) * E + (row - bo * E)];
}

// this thread's share of a warpgroup's 64 rows' invariants: loaded into
// registers (zeros past rows) while the previous tile's epilogue runs, then
// stored to the warpgroup's s_x
struct TileInvariants {
    static constexpr int PER = ROWS * MAX_D / WG;
    float v[PER];
    __device__ __forceinline__ void load(const float* attrT, long long row0, long long rows, int d,
                                         int E) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int e = threadIdx.x % WG + k * WG, r = e % ROWS, j = e / ROWS;
            v[k] = e < ROWS * d && row0 + r < rows ? invariant(attrT, row0 + r, j, d, E) : 0.f;
        }
    }
    __device__ __forceinline__ void store(float (*s_x)[MAX_D + 1], int d) const {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int e = threadIdx.x % WG + k * WG;
            if (e < ROWS * d) s_x[e % ROWS][e / ROWS] = v[k];
        }
    }
};

// the warpgroup's A panel p (rows: its 64 edges, K: features [32p, 32p +
// 32)) into a, big halves, the small halves PANEL bytes further: thread i
// forms row i % 64's features 32p + 16 (i / 64) .. + 16, four 16-byte chunks
__device__ __forceinline__ void build_rows_panel(unsigned char* a, const uint32_t* terms,
                                                 const float* x, int p, int F) {
    const int i = threadIdx.x % WG, r = i % ROWS, half = i / ROWS;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int c = 4 * half + k, f0 = FK * p + 4 * c;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = feature(terms, x, f0 + j, F, 0.f);
        put_split(a + r * 128 + ((c ^ (r & 7)) << 4), PANEL, v);
    }
}

// the warpgroup's A panel at a, as TMA wrote it (float32), rewritten in place
// to its tf32 big halves, the small halves PANEL bytes further; with GELU,
// of gelu of each value
template <bool GELU>
__device__ __forceinline__ void split_rows_panel(unsigned char* a) {
    for (int e = threadIdx.x % WG; e < ROWS * 8; e += WG) {
        const int r = e / 8, off = r * 128 + (((e % 8) ^ (r & 7)) << 4);
        const uint4 q = *reinterpret_cast<const uint4*>(a + off);
        float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y), __uint_as_float(q.z),
                      __uint_as_float(q.w)};
        if constexpr (GELU) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = gelu(v[j]);
        }
        put_split(a + off, PANEL, v);
    }
}

// thread 0: B's panel p (N rows of a float32 weight copy, w_map) into the
// slot, after its A panels
template <int N>
__device__ __forceinline__ void load_weight_panel(unsigned char* slot, const CUtensorMap* w_map,
                                                  uint64_t* bar, int p) {
    tma_load_2d(slot + 4 * PANEL, w_map, bar, p * FK, 0);
}

// B's N-row float32 panel at b, as TMA wrote it, rewritten in place to its
// tf32 big halves, the small halves N * 128 bytes further: a share of its
// 16-byte chunks for each thread of the block
template <int N>
__device__ __forceinline__ void split_weight_panel(unsigned char* b) {
    for (int e = threadIdx.x; e < N * 8; e += BLOCK_THREADS) {
        const uint4 q = *reinterpret_cast<const uint4*>(b + e * 16);
        const float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y), __uint_as_float(q.z),
                            __uint_as_float(q.w)};
        put_split(b + e * 16, N * 128, v);
    }
}

// acc = (the warpgroup's 64 rows of A) @ (B's N rows)^T over kp K-panels,
// the ring's panels q .. q + kp - 1: for each, once its slot is full,
// prepare(a, p) writes (or splits) the warpgroup's A panel p at a, the
// block splits B's panel, the products of the panel are issued while the
// previous panel's finish, and that one's slot is released. Returns with
// the products done and every slot released. Both warpgroups call it for
// the same panels (a block-wide barrier a panel).
template <int N, class Prepare, class Issue>
__device__ __forceinline__ void row_product(float (&acc)[N / 2], Ring& ring, int q, int kp,
                                            Prepare prepare, Issue& issue) {
    const int wg = threadIdx.x / WG;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int p = 0; p < kp; ++p, ++q) {
        const int s = q % ring.stages;
        unsigned char* slot = ring.slot(s);
        mbar_wait(&ring.full[s], (q / ring.stages) & 1);
        unsigned char* a = slot + wg * 2 * PANEL;
        prepare(a, p);
        split_weight_panel<N>(slot + 4 * PANEL);
        fence_proxy_async();
        __syncthreads();  // A split by the warpgroup, B by the block
        panel_product<float, N>(acc, a, slot + 4 * PANEL, N * 128);
        if (p > 0) {
            wgmma_wait<1>();
            fence_acc(acc);
            release(ring, q - 1, issue);
        }
    }
    product_finish<N>(acc, ring, q - 1, issue);
}

// ---- #8, and #7's first pass ------------------------------------------------

// out [rows, ld] = poly(attrT) @ W1 + b1 (columns < H): the features built in
// each slot's A panels from the tile's invariants (s_x), W1^T through the
// ring (w_map: boxes of NH rows of the copy [NH, kw1])
template <int NH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
f32_h1_kernel(const float* __restrict__ attrT, const float* __restrict__ b1,
              float* __restrict__ out, long long ld, long long rows, int d, int E, int F, int H,
              int kp, int stages, const __grid_constant__ CUtensorMap w_map) {
    __shared__ uint64_t full[MAX_STAGES];
    __shared__ int released[MAX_STAGES];
    __shared__ float s_x[2][ROWS][MAX_D + 1];
    __shared__ uint32_t terms[MAX_F];
    __shared__ float s_b1[NH];  // b1, zero past H
    fill_terms(terms, F, d);
    for (int n = threadIdx.x; n < NH; n += BLOCK_THREADS) s_b1[n] = n < H ? b1[n] : 0.f;
    const int n_tiles = cdiv(rows, TILE);
    Ring ring{full, released, aligned_smem(), row_slot(NH), stages, block_tiles(n_tiles) * kp, true};
    auto issue = [&](int q, int s) {
        mbar_arrive_expect_tx(&ring.full[s], NH * 128);
        load_weight_panel<NH>(ring.slot(s), &w_map, &ring.full[s], q % kp);
    };
    ring_start(ring, issue);
    const int wg = threadIdx.x / WG, r = threadIdx.x % ROWS;
    const bool pair = ld % 2 == 0;
    TileInvariants inv;
    inv.load(attrT, (long long)blockIdx.x * TILE + wg * ROWS, rows, d, E);
    int q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, q += kp) {
        const long long row0 = (long long)t * TILE + wg * ROWS;
        inv.store(s_x[wg], d);  // (the last tile's builds were done before its last products)
        wg_sync();
        float acc[NH / 2];
        row_product<NH>(acc, ring, q, kp, [&](unsigned char* a, int p) {
            build_rows_panel(a, terms, s_x[wg][r], p, F);
        }, issue);
        // the next tile's invariants, their loads in flight during the epilogue
        inv.load(attrT, row0 + (long long)gridDim.x * TILE, rows, d, E);
        wgmma_for_each<NH>(acc, [&](int, int m, int n, float v0, float v1) {
            const long long row = row0 + m;
            if (row < rows && n < H)
                store2(out + row * ld + n, v0 + s_b1[n], v1 + s_b1[n + 1], n + 1 < H, pair);
        });
    }
}

// ---- #7's row passes 2 and 3 ----------------------------------------------

enum class Pass { DPRE2, DPRE1 };

// (a pair of float32 values at p, p[1] only where second; one 8-byte load
// where pair)
__device__ __forceinline__ float2 load_pair(const float* p, bool second, bool pair) {
    if (second && pair) return *reinterpret_cast<const float2*>(p);
    return make_float2(p[0], second ? p[1] : 0.f);
}

// DPRE2 (N = ND): dpre2 [rows, dp] = gelu'(gelu(h1_pre) @ W2 + b2) (which
// dpre2_scale_kernel then multiplies by the cotangents' sum), A = h1_pre
// (a_map over [rows, hp], K = H), B = W2^T (w_map);
// DPRE1 (N = NH): dpre1 [rows, hp] = (dpre2 @ W2^T) * gelu'(h1_pre), A =
// dpre2 (a_map over [rows, dp], K = D), B = W2 (w_map)
template <Pass PASS, int N>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
f32_rows_kernel(const F32Bwd a, int kp, int stages, const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map) {
    __shared__ uint64_t full[MAX_STAGES];
    __shared__ int released[MAX_STAGES];
    __shared__ float s_b2[PASS == Pass::DPRE2 ? N : 1];  // b2, zero past D
    if constexpr (PASS == Pass::DPRE2)
        for (int n = threadIdx.x; n < N; n += BLOCK_THREADS) s_b2[n] = n < a.D ? a.b2[n] : 0.f;
    const int n_tiles = cdiv(a.rows, TILE);
    Ring ring{full, released, aligned_smem(), row_slot(N), stages, block_tiles(n_tiles) * kp, true};
    auto issue = [&](int q, int s) {
        const int tile = blockIdx.x + q / kp * gridDim.x, p = q % kp;
        unsigned char* dst = ring.slot(s);
        mbar_arrive_expect_tx(&ring.full[s], 2 * PANEL + N * 128);
        tma_load_2d(dst, &a_map, &ring.full[s], p * FK, tile * TILE);
        tma_load_2d(dst + 2 * PANEL, &a_map, &ring.full[s], p * FK, tile * TILE + ROWS);
        load_weight_panel<N>(dst, &w_map, &ring.full[s], p);
    };
    ring_start(ring, issue);
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG, tq = i % 4;
    const int m = 16 * (i / 32) + i % 32 / 4;  // this thread's first row of the warpgroup's 64
    int q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, q += kp) {
        const long long row0 = (long long)t * TILE + wg * ROWS;
        float acc[N / 2];
        row_product<N>(acc, ring, q, kp, [&](unsigned char* panel, int) {
            split_rows_panel<PASS == Pass::DPRE2>(panel);
        }, issue);
        if constexpr (PASS == Pass::DPRE2) {
            wgmma_for_each<N>(acc, [&](int, int mm, int n, float v0, float v1) {
                const long long row = row0 + mm;
                if (row < a.rows && n < a.D)
                    store2(a.dpre2 + row * a.dp + n, gelu_deriv(v0 + s_b2[n]),
                           gelu_deriv(v1 + s_b2[n + 1]), n + 1 < a.D, true);
            });
        } else {
            // eight n8 tiles at a time: their h1_pre pairs loaded together
            // before any store (a store may alias a later load)
#pragma unroll
            for (int j0 = 0; j0 < N / 8; j0 += 8) {
                float2 pre[8][2];
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int n = 8 * (j0 + jj) + 2 * tq;
                        const long long row = row0 + m + 8 * h;
                        pre[jj][h] = j0 + jj < N / 8 && row < a.rows && n < a.H
                                         ? load_pair(a.h1pre + row * a.hp + n, n + 1 < a.H, true)
                                         : make_float2(0.f, 0.f);
                    }
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int j = j0 + jj, n = 8 * j + 2 * tq;
                        const long long row = row0 + m + 8 * h;
                        if (j < N / 8 && row < a.rows && n < a.H)
                            store2(a.dpre1 + row * a.hp + n, acc[4 * j + 2 * h] * gelu_deriv(pre[jj][h].x),
                                   acc[4 * j + 2 * h + 1] * gelu_deriv(pre[jj][h].y), n + 1 < a.H,
                                   true);
                    }
            }
        }
    }
}

// dpre2 [rows, dp] *= (g_0 + ... + g_{n-1}) [rows, D], summed in order: a
// streaming pass, four elements of a row a thread where the rows are
// 16-byte multiples (vec), else one
__global__ void __launch_bounds__(arreau::THREADS)
dpre2_scale_kernel(const F32Bwd a, bool vec) {
    const int w = vec ? 4 : 1, per_row = a.D / w;
    const long long n = a.rows * per_row;
    for (long long i = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * arreau::THREADS) {
        const long long row = i / per_row;
        const int c = (int)(i - row * per_row) * w;
        float* out = a.dpre2 + row * a.dp + c;
        const long long at = row * a.D + c;
        if (vec) {
            float4 s = *reinterpret_cast<const float4*>(a.g[0] + at);
            for (int u = 1; u < a.n_g; ++u) {
                const float4 v = *reinterpret_cast<const float4*>(a.g[u] + at);
                s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
            }
            const float4 d = *reinterpret_cast<const float4*>(out);
            *reinterpret_cast<float4*>(out) = make_float4(s.x * d.x, s.y * d.y, s.z * d.z,
                                                          s.w * d.w);
        } else {
            float s = a.g[0][at];
            for (int u = 1; u < a.n_g; ++u) s += a.g[u][at];
            *out = s * *out;
        }
    }
}

// ---- #7's weight gradients ------------------------------------------------------

// A K-panel of 32 edge rows of a weight gradient's two operands, transposed
// as the threads stage them (spatial_conv_bwd_sm90.cu: DwF32Panel): each
// thread loads four rows of one column at a time (A: one of the block's 128
// columns m; B: one of N's), a panel ahead, into registers, then writes each
// task's tf32 halves as one 16-byte chunk of the column's K-major row in
// the 128-byte swizzle. A is [gelu(h1_pre) | 1] (dW2), or with BUILT [poly |
// 1] (dW1), formed at staging from the panel's invariants in s_x.
template <int NW, bool BUILT>
struct DwPanel {
    static constexpr int A_TASKS = 2 * ROWS * 8 / BLOCK_THREADS;
    static constexpr int B_TASKS = (NW * 8 + BLOCK_THREADS - 1) / BLOCK_THREADS;
    float a[BUILT ? 1 : A_TASKS][4], b[B_TASKS][4];
    float x;  // BUILT: this thread's invariant (row i / 8, j = i % 8) of a later panel

    // rows r0 .. r0 + nrows - 1 (at most 32; the rest zeros): A's columns m0
    // .. m0 + 127 of h1_pre (unless BUILT) and B's N columns of b [rows, ldb]
    __device__ __forceinline__ void load(const F32Bwd& args, const float* __restrict__ bsrc,
                                         long long ldb, int N, long long r0, int nrows, int m0) {
        if constexpr (!BUILT) {
#pragma unroll
            for (int j = 0; j < A_TASKS; ++j) {
                const int i = threadIdx.x + j * BLOCK_THREADS, c = m0 + i % TILE;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int r = 4 * (i / TILE) + q;
                    a[j][q] = c < args.H && r < nrows ? args.h1pre[(r0 + r) * args.hp + c] : 0.f;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < B_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, c = i % NW;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 4 * (i / NW) + q;
                b[j][q] = i < NW * 8 && c < N && r < nrows ? bsrc[(r0 + r) * ldb + c] : 0.f;
            }
        }
    }

    // BUILT: this thread's invariant of the panel of rows r0 .. (nrows)
    __device__ __forceinline__ void load_invariant(const F32Bwd& args, long long r0, int nrows) {
        const int r = threadIdx.x / 8, j = threadIdx.x % 8;
        x = j < args.d && r < nrows ? invariant(args.attrT, r0 + r, j, args.d, args.E) : 0.f;
    }

    // the stage at st from the registers (A of the panel's nrows rows; with
    // BUILT from its invariants s_x and feature terms)
    __device__ __forceinline__ void store(unsigned char* st, const F32Bwd& args, int nrows, int m0,
                                          float (*s_x)[MAX_D + 1],
                                          const uint32_t* terms) const {
#pragma unroll
        for (int j = 0; j < A_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, cm = i % TILE, g = i / TILE;
            const int c = m0 + cm, mm = cm % ROWS;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 4 * g + q;
                const float one = r < nrows ? 1.f : 0.f;
                if constexpr (BUILT)
                    v[q] = feature(terms, s_x[r], c, args.F, one);
                else
                    v[q] = c < args.H ? gelu(a[j][q]) : c == args.H ? one : 0.f;
            }
            put_split(st + cm / ROWS * 2 * PANEL + mm * 128 + ((g ^ (mm & 7)) << 4), PANEL, v);
        }
#pragma unroll
        for (int j = 0; j < B_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, c = i % NW, g = i / NW;
            if (i < NW * 8) put_split(st + 4 * PANEL + c * 128 + ((g ^ (c & 7)) << 4), NW * 128, b[j]);
        }
    }
};

// partial[split, m, n] = sum over the split's rows k of A[k, m] B[k, n]: a
// block two warpgroups of 64 columns m each (M), N all in one accumulator
// (NW), K the split's rows in 32-row panels staged transposed (DwPanel) into
// `stages` buffers, a panel loaded ahead into registers.
//   dW2 (!BUILT): A = [gelu(h1_pre) | 1] (M = H + 1), B = dpre2 (N = D);
//   dW1 (BUILT):  A = [poly | 1] (M = F + 1), B = dpre1 (N = H).
template <int NW, bool BUILT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
f32_dw_kernel(const F32Bwd a, int per_split, int stages) {
    __shared__ float s_x[2][FK][MAX_D + 1];
    __shared__ uint32_t terms[BUILT ? MAX_F : 1];
    if constexpr (BUILT) fill_terms(terms, a.F, a.d);
    unsigned char* smem = aligned_smem();
    const int M = BUILT ? a.F + 1 : a.H + 1, N = BUILT ? a.H : a.D;
    const float* bsrc = BUILT ? a.dpre1 : a.dpre2;
    const long long ldb = BUILT ? a.hp : a.dp;
    const int m0 = blockIdx.x * TILE;
    const long long k0 = (long long)blockIdx.y * per_split;
    const int K = (int)min((long long)per_split, a.rows - k0), kp = cdiv(K, FK);
    const int wg = threadIdx.x / WG, i = threadIdx.x % WG, tq = i % 4;
    const int m = 16 * (i / 32) + i % 32 / 4;
    // a warpgroup whose 64 rows all lie past M (the last block of dW1 at F +
    // 1 = 259) stages its share of the panels but runs no products
    const bool live = m0 + wg * ROWS < M;
    float acc[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
    DwPanel<NW, BUILT> panel;
    if constexpr (BUILT) {
        panel.load_invariant(a, k0, K);
        s_x[0][threadIdx.x / 8][threadIdx.x % 8] = panel.x;
        panel.load_invariant(a, k0 + FK, K - FK);
    }
    panel.load(a, bsrc, ldb, N, k0, K, m0);
    // thread 0: panel p's rows of the row-major scratch into L2 (contiguous
    // ranges), two panels before the threads load them
    auto prefetch = [&](int p) {
        const int nr = min(FK, K - FK * p);
        if (threadIdx.x != 0 || nr <= 0) return;
        const long long r0 = k0 + FK * p;
        prefetch_l2(bsrc + r0 * ldb, (unsigned)(nr * ldb * 4));
        if constexpr (!BUILT) prefetch_l2(a.h1pre + r0 * a.hp, (unsigned)(nr * a.hp * 4));
    };
    prefetch(1);
    for (int p = 0; p < kp; ++p) {
        prefetch(p + 2);
        unsigned char* st = smem + (p % stages) * row_slot(NW);
        // both warpgroups are past the products that read this stage, and
        // panel p's invariants are in s_x[p % 2]
        __syncthreads();
        panel.store(st, a, K - FK * p, m0, s_x[p % 2], terms);
        if constexpr (BUILT) {
            s_x[(p + 1) % 2][threadIdx.x / 8][threadIdx.x % 8] = panel.x;
            panel.load_invariant(a, k0 + FK * (p + 2), K - FK * (p + 2));
        }
        if (p + 1 < kp) panel.load(a, bsrc, ldb, N, k0 + FK * (p + 1), K - FK * (p + 1), m0);
        fence_proxy_async();
        __syncthreads();  // the stage written, for the async proxy
        if (live) {
            panel_product<float, NW>(acc, st + wg * 2 * PANEL, st + 4 * PANEL, NW * 128);
            wgmma_wait<1>();
            fence_acc(acc);
        }
    }
    if (live) {
        wgmma_wait<0>();
        fence_acc(acc);
    }
    float* out = a.partial + (long long)blockIdx.y * M * N;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + wg * ROWS + m + 8 * h, c = 8 * j + 2 * tq;
            if (r < M && c < N)
                store2(out + (long long)r * N + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                       c + 1 < N, N % 2 == 0);
        }
}

// the plan's widths hold H (and D), its K-panels are whole, and its scratch
// rows are 16-byte multiples
inline bool f32_plan_fits(const BasisPlan& p, int F, int H, int D) {
    return p.nh >= H && p.kw1 >= F && p.kw1 % FK == 0 &&
           (D == 0 || (p.nd >= D && p.kw2 >= H && p.kw2 % FK == 0 && p.kw3 >= D &&
                       p.kw3 % FK == 0 && p.hp >= H && p.hp % 4 == 0 && p.dp >= D &&
                       p.dp % 4 == 0 && p.splits >= 1 && p.per_split % ROWS == 0));
}

}  // namespace basis32

}  // namespace
