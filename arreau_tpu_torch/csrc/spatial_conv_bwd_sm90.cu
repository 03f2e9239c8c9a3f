// Spatial fiber-bundle convolution, backward (#4), float32 or bfloat16, on
// Hopper's wgmma and TMA (conv_sm90.cuh: bound, design, operands).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_bwd_spatial_kernel
// (the VJP of fused_spatial_conv, reached through _bwd_spatial, pallas_call
// :468). With the forward out[b',o,t,c] = sum_k win[e] * kern[e,c] *
// x[src[e],c], e = k*TA + t, kern = basis @ W, and g the cotangent of out:
//
//   gxw[e,c]    = g[t,c] * x[src[e],c] * win[e]          (0 on an empty slot)
//   dbasis[e,:] = gxw[e,:] @ W^T                          (contracts C, per edge)
//   dW          = sum over b', o, e of basis[e,:]^T gxw[e,:] (contracts every edge)
//   dx[s,c]     = sum over e with src[e] = s of kern[e,c] * win[e] * g[t,c]
//   dwin[b',e]  = sum over o and c of kern[e,c] * g[t,c] * x[src[e],c]   (with dwin)
//
// A sender outside [0, TA) is an empty slot: it is never read and adds
// nothing (dwin is 0 there). The window cotangent (the TPU kernel's want_dwin
// branch, pallas_conv.py:352-353, :369-370) is computed only when the caller
// passes dwin (the JAX package's window_grad = position_grads).
//
// Bound: three products of 2*B'*O*E*D*C operations (161 GFLOP over all slots
// at the training shape) against the bytes of basis, g, x in and dbasis, dx
// out (~0.6 GB in bfloat16): bytes in bfloat16, operations in float32.
//
// The passes, in this order on the caller's stream:
//
//   0. (before the call, once for each version of W: arreau_conv_weights_sm90)
//      W^T and W as K-major zero-padded copies (tf32 halves in float32), the
//      B operands, and their tensor maps.
//   1. sconv_gxw_kernel: the edge cotangent gxw = round_T(g[t] * x[src[e]]
//      * win[e]) into a scratch [B'*O*E, Cg] (Cg = C rounded up to 8, so rows
//      are 16-byte multiples that TMA can address), a 16-byte chunk a thread.
//   2. sconv_dbasis_kernel: dbasis = gxw @ W^T, 64-row tiles of the scratch
//      read by TMA through the ring, B = W (N = D in two warpgroup halves),
//      rounded once as stored (through a staging tile, 16-byte stores).
//      Building gxw in shared memory inside this product instead, as the A
//      operand, saves the scratch's second read but waits on the gather's
//      loads a K-panel at a time: in a development build it took twice as
//      long as passes 1 and 2 together.
//      Each pass's blocks are persistent (one an SM) and walk their tiles.
//   3. dW = basis^T gxw on wgmma (sconv_dw_kernel), split over the edge rows
//      in 64-row panels into float32 partials that sum_splits_kernel adds in
//      split order, N = C in one accumulator. In bfloat16 both operands are
//      read from their row-major [rows, D] and [rows, Cg] layouts by TMA as
//      MN-major boxes (wgmma's transposed bfloat16 operands). tf32 wgmma takes
//      K-major operands only, and both of dW's contract over the rows, so in
//      float32 the block's threads transpose them as they stage them (3xTF32,
//      DwF32Panel).
//   4. conv_kern_sm90 (conv_kern_sm90.cu): kern = basis @ W per slot tile,
//      #3's mainloop, and in its epilogue dxc = round_T(kern * win * g[t])
//      into the scratch over gxw, with dwin also the row sums of kern * g *
//      x per warpgroup half.
//   5. dx: each sender's dxc terms summed in ascending e, in float32
//      (spatial_conv_bwd.cu, #2's pass): the wrapper lists each b's live
//      edges by sender with a stable sort.
//   6. dwin_sum_kernel (with dwin): the halves' partials summed over o, then
//      over the halves, in ascending order.
//
// Every output repeats bit for bit: fixed-order sums, no atomics.
//
// Element type T (dtype.cuh) of basis, W, x, g, the scratch, dbasis and dx:
// float32, or bfloat16 on the compute_dtype="bfloat16" path. There the JAX
// kernel's rounding points hold (pallas_conv.py:331-390): gxw and kern * win
// * g are rounded to T before their products (:371, :376), every product and
// sum is float32, dbasis and dx are rounded once as they are stored, and the
// dW partials stay float32 (the wrapper rounds the sum to W's type).

#include "conv_sm90.cuh"

namespace {

using namespace arreau;
using namespace conv90;

// 1. gxw[row, c] = round_T((g[t,c] * x[src[e],c]) * win[e]) for edge row
//    (b', o, e = k*TA + t), zeros on an empty slot and in [C, Cg): a 16-byte
//    chunk of a row a thread, into the edge-cotangent scratch [B'*O*E, Cg]
template <class T>
__global__ void __launch_bounds__(arreau::THREADS)
sconv_gxw_kernel(const ConvArgs<T> a) {
    constexpr int CH = 16 / sizeof(T);  // elements of a 16-byte chunk
    const int chunks = a.Cg / CH, E = a.K * a.TA;
    const bool vec = a.C % CH == 0 && reinterpret_cast<uintptr_t>(a.g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    const long long n = a.rows * chunks;
    for (long long i = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * arreau::THREADS) {
        const long long row = i / chunks, bo = row / E;
        const int c = (int)(i - row * chunks) * CH, e = (int)(row - bo * E);
        const long long be = bo / a.O * E + e;
        const int s = a.src[be];
        float v[CH];
        if (s >= 0 && s < a.TA && c < a.C) {
            float gv[CH], xv[CH];
            const int cnt = min(CH, a.C - c);
            load_chunk(gv, a.g + (bo * a.TA + e % a.TA) * a.C + c, cnt, vec);
            load_chunk(xv, a.x + (bo * a.TA + s) * a.C + c, cnt, vec);
            const float wv = a.win[be];
#pragma unroll
            for (int j = 0; j < CH; ++j) v[j] = gv[j] * xv[j] * wv;
        } else {
#pragma unroll
            for (int j = 0; j < CH; ++j) v[j] = 0.f;
        }
        store_chunk<T>(a.gxw + row * a.Cg + c, v, CH, true);
    }
}

// 2. dbasis [B'*O*E, D] (a.out) = gxw @ W^T: 64-row tiles of the edge
//    scratch, A by TMA (g_map: a 2-D map over gxw [rows, Cg]), B = W's copy
//    wk (w_map: N = D in two warpgroup halves), resident in bfloat16, through
//    the ring in float32; rounded once as stored
template <class T, int NB>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
sconv_dbasis_kernel(const ConvArgs<T> a, const __grid_constant__ CUtensorMap g_map,
                    const __grid_constant__ CUtensorMap w_map) {
    __shared__ uint64_t full[MAX_STAGES], w_bar;
    __shared__ int released[MAX_STAGES];
    constexpr int BROWS = 2 * NB;  // W's rows: both halves of D
    unsigned char* smem = aligned_smem();
    const int w_bytes = F32<T> ? 0 : a.kp * BROWS * 128;
    Ring ring{full,     released, smem + w_bytes, slot_bytes<T>(NB), a.stages,
              block_tiles(a.n_tiles) * a.kp, true};
    auto issue = [&](int q, int s) {
        const int tile = blockIdx.x + q / a.kp * gridDim.x, p = q % a.kp;
        unsigned char* dst = ring.slot(s);
        mbar_arrive_expect_tx(&ring.full[s], PANEL + (F32<T> ? 2 * BROWS * 128 : 0));
        tma_load_2d(dst, &g_map, &ring.full[s], p * PK<T>, tile * ROWS);
        if constexpr (F32<T>) {
            tma_load_2d(dst + 2 * PANEL, &w_map, &ring.full[s], p * PK<T>, 0);
            tma_load_2d(dst + 2 * PANEL + BROWS * 128, &w_map, &ring.full[s], p * PK<T>, BROWS);
        }
    };
    if (threadIdx.x == 0) {
        ring_init(ring);
        mbar_init(&w_bar, 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        if constexpr (!F32<T>) {
            mbar_arrive_expect_tx(&w_bar, w_bytes);
            for (int p = 0; p < a.kp; ++p)
                tma_load_2d(smem + p * BROWS * 128, &w_map, &w_bar, p * PK<T>, 0);
        }
        ring_fill(ring, issue);
    }
    __syncwarp();
    if constexpr (!F32<T>) mbar_wait(&w_bar, 0);

    const int wg = threadIdx.x / WG, col0 = wg * NB, tq = threadIdx.x % 4;
    const int m = 16 * (threadIdx.x % WG / 32) + threadIdx.x % 32 / 4;
    // this warpgroup's staging tile, DW = 64 columns: the output a window at a time
    constexpr int DW = 64;
    T* os = reinterpret_cast<T*>(ring.base + a.stages * ring.bytes) + wg * ROWS * stage_ld<T>(DW);
    const bool o_vec = a.D % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    int q = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, q += a.kp) {
        const long long row0 = (long long)tile * ROWS;
        float acc[NB / 2];
        slot_product<T, NB>(acc, ring, q, a.kp, smem, true, a.gxw + row0 * a.Cg, a.Cg,
                            (int)min((long long)ROWS, a.rows - row0), a.Cg, issue);
        product_finish<NB>(acc, ring, q + a.kp - 1, issue);
#pragma unroll
        for (int wnd = 0; wnd < (NB + DW - 1) / DW; ++wnd) {
            wg_sync();  // the previous window's stores have read the tile
#pragma unroll
            for (int j = 8 * wnd; j < NB / 8 && j < 8 * wnd + 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    pair_at<T, DW>(os, m + 8 * h, 8 * (j - 8 * wnd) + 2 * tq) =
                        to_pair<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            wg_sync();
            store_rows<T, DW>(os, a.out + row0 * a.D, a.D,
                              (int)min((long long)ROWS, a.rows - row0), col0 + DW * wnd,
                              min(a.D, col0 + min(NB, DW * (wnd + 1))), o_vec);
        }
    }
}

// 3. float32: a K-panel of 32 edge rows for the tf32 products, transposed
//    as the threads stage it. Each thread loads four rows of one column at a
//    time (a task: basis's column d of the block's 128, A; gxw's column c of
//    NW, B; consecutive threads on consecutive columns) into registers,
//    while the previous panel's products run; then splits them into tf32
//    halves and writes each half as one 16-byte chunk of the column's K-major
//    row in the 128-byte swizzle (eight consecutive columns take eight
//    distinct chunks: no bank conflicts). A stage: per warpgroup its 64 d
//    rows' big halves, then their small halves; then B's NW rows, big, then
//    small.
template <int NW>
struct DwF32Panel {
    static constexpr int A_TASKS = 2 * ROWS * 8 / BLOCK_THREADS;
    static constexpr int B_TASKS = (NW * 8 + BLOCK_THREADS - 1) / BLOCK_THREADS;
    static constexpr int STAGE = 4 * PANEL + 2 * NW * 128;
    float a[A_TASKS][4], b[B_TASKS][4];

    // rows r0 .. r0 + 31 (those past nrows as zeros) of columns m0 .. m0 + 127
    // of basis [rows, D] and of gxw [rows, Cg]
    __device__ __forceinline__ void load(const float* __restrict__ basis,
                                         const float* __restrict__ gxw, long long r0, int nrows,
                                         int m0, int D, int C, int Cg) {
#pragma unroll
        for (int j = 0; j < A_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, d = m0 + i % (2 * ROWS);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 4 * (i / (2 * ROWS)) + q;
                a[j][q] = d < D && r < nrows ? basis[(r0 + r) * D + d] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < B_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, c = i % NW;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = 4 * (i / NW) + q;
                b[j][q] = i < NW * 8 && c < C && r < nrows ? gxw[(r0 + r) * Cg + c] : 0.f;
            }
        }
    }

    __device__ __forceinline__ static void put(unsigned char* big, int small, const float (&v)[4]) {
        uint4 hi, lo;
        split_tf32(v[0], hi.x, lo.x);
        split_tf32(v[1], hi.y, lo.y);
        split_tf32(v[2], hi.z, lo.z);
        split_tf32(v[3], hi.w, lo.w);
        *reinterpret_cast<uint4*>(big) = hi;
        *reinterpret_cast<uint4*>(big + small) = lo;
    }

    __device__ __forceinline__ void store(unsigned char* st) const {
#pragma unroll
        for (int j = 0; j < A_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, d = i % (2 * ROWS), g = i / (2 * ROWS);
            const int m = d % ROWS;
            put(st + d / ROWS * 2 * PANEL + m * 128 + ((g ^ (m & 7)) << 4), PANEL, a[j]);
        }
#pragma unroll
        for (int j = 0; j < B_TASKS; ++j) {
            const int i = threadIdx.x + j * BLOCK_THREADS, c = i % NW, g = i / NW;
            if (i < NW * 8)
                put(st + 4 * PANEL + c * 128 + ((g ^ (c & 7)) << 4), NW * 128, b[j]);
        }
    }
};

// 3. partial[split, d, c] = sum over the split's edge rows of basis[row, d] *
//    gxw[row, c]: a block two warpgroups of 64 d each (M), N = all of C (NW),
//    K = the split's rows. bfloat16: 64-row panels through a TMA ring, A the
//    basis box {64 d, 64 rows} (b_map, or staged by the threads where !tma)
//    and B ceil(NW / 64) gxw boxes {64 c, 64 rows} (g_map), both MN-major.
//    float32: 32-row panels the threads stage transposed (DwF32Panel) into
//    `stages` buffers, one panel loaded ahead into registers.
template <class T, int NW>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
sconv_dw_kernel(const T* __restrict__ basis, const T* __restrict__ gxw, float* __restrict__ partial,
                long long rows, int per_split, int D, int C, int Cg, int stages, bool tma,
                const __grid_constant__ CUtensorMap b_map,
                const __grid_constant__ CUtensorMap g_map) {
    constexpr int NBOX = (NW + 63) / 64;
    __shared__ uint64_t full[MAX_STAGES];
    __shared__ int released[MAX_STAGES];
    unsigned char* smem = aligned_smem();
    const int m0 = blockIdx.x * 2 * ROWS;
    const long long k0 = (long long)blockIdx.y * per_split;
    const int K = (int)min((long long)per_split, rows - k0);
    const int wg = threadIdx.x / WG, tq = threadIdx.x % 4;
    const int m = 16 * (threadIdx.x % WG / 32) + threadIdx.x % 32 / 4;
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    if constexpr (F32<T>) {
        const int kp = cdiv(K, 32);
        DwF32Panel<NW> panel;
        panel.load(basis, gxw, k0, K, m0, D, C, Cg);
        for (int p = 0; p < kp; ++p) {
            unsigned char* st = smem + (p % stages) * DwF32Panel<NW>::STAGE;
            __syncthreads();  // both warpgroups are past the products that read this stage
            panel.store(st);
            if (p + 1 < kp)
                panel.load(basis, gxw, k0 + 32 * (p + 1), K - 32 * (p + 1), m0, D, C, Cg);
            fence_proxy_async();
            __syncthreads();  // the stage written, for the async proxy
            panel_product<float, NW>(acc, st + wg * 2 * PANEL, st + 4 * PANEL, NW * 128);
            wgmma_wait<1>();
            fence_acc(acc);
        }
        wgmma_wait<0>();
        fence_acc(acc);
    } else {
        const int kp = cdiv(K, ROWS);
        Ring ring{full, released, smem, (2 + NBOX) * PANEL, stages, kp, true};
        auto issue = [&](int q, int s) {
            const int row = (int)(k0 + (long long)q * ROWS);
            unsigned char* dst = ring.slot(s);
            mbar_arrive_expect_tx(&ring.full[s], (tma ? 2 * PANEL : 0) + NBOX * PANEL);
            if (tma) {
                tma_load_2d(dst, &b_map, &ring.full[s], m0, row);
                tma_load_2d(dst + PANEL, &b_map, &ring.full[s], m0 + ROWS, row);
            }
            for (int j = 0; j < NBOX; ++j)
                tma_load_2d(dst + (2 + j) * PANEL, &g_map, &ring.full[s], 64 * j, row);
        };
        if (threadIdx.x == 0) {
            ring_init(ring);
            mbar_fence_init();
        }
        __syncthreads();
        if (threadIdx.x == 0) ring_fill(ring, issue);
        __syncwarp();
        for (int p = 0; p < kp; ++p) {
            const int s = p % stages;
            unsigned char* slot = ring.slot(s);
            if (!tma) {
                __syncthreads();  // every warp is past the products that last read the slot
                for (int h = 0; h < 2; ++h)
                    stage_box<bf16>(slot + h * PANEL, basis + (k0 + p * ROWS) * D + m0 + h * ROWS,
                                    D, K - p * ROWS, D - m0 - h * ROWS);
            }
            mbar_wait(&ring.full[s], (p / stages) & 1);
            if (!tma) {
                fence_proxy_async();
                __syncthreads();
            }
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
    }
    float* out = partial + (long long)blockIdx.y * D * C;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int d = m0 + wg * ROWS + m + 8 * h, c = 8 * j + 2 * tq;
            if (d < D && c < C)
                store2(out + (long long)d * C + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                       c + 1 < C, C % 2 == 0);
        }
}

// 6. dwin[b', e] = sum over o, then over the two halves, in ascending order,
//    of dwin_partial[h, (b'*O + o)*E + e]
__global__ void __launch_bounds__(arreau::THREADS)
dwin_sum_kernel(const float* __restrict__ dwin_partial, float* __restrict__ dwin, int Bp, int O,
                int E, long long rows) {
    const long long n = (long long)Bp * E;
    for (long long i = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * arreau::THREADS) {
        const long long b = i / E, e = i - b * E;
        float s = 0.f;
        for (int o = 0; o < O; ++o)
            for (int h = 0; h < 2; ++h) s += dwin_partial[h * rows + (b * O + o) * E + e];
        dwin[i] = s;
    }
}

template <class T, int NB>
cudaError_t launch_dbasis(const ConvArgs<T>& a, int smem, const CUtensorMap& w_map,
                          cudaStream_t stream) {
    CUtensorMap g_map{};
    if (!sw128_map<T>(&g_map, a.gxw, a.Cg, a.rows, (long long)a.Cg * sizeof(T), ROWS))
        return cudaErrorInvalidValue;
    static SmemLimit limit;
    cudaError_t err = limit.check(sconv_dbasis_kernel<T, NB>, slot_smem<T>(NB, a.kp, a.stages, 64),
                                  smem, a.stages);
    if (err != cudaSuccess) return err;
    sconv_dbasis_kernel<T, NB><<<persistent_blocks(a.n_tiles), BLOCK_THREADS, smem, stream>>>(
        a, g_map, w_map);
    return cudaGetLastError();
}

template <class T>
cudaError_t launch_dbasis_nb(const ConvArgs<T>& a, const ConvPlan& p, const CUtensorMap& w_map,
                             cudaStream_t stream) {
    switch (p.nd) {
        case 32: return launch_dbasis<T, 32>(a, p.dbasis_smem, w_map, stream);
        case 64: return launch_dbasis<T, 64>(a, p.dbasis_smem, w_map, stream);
        case 112: return launch_dbasis<T, 112>(a, p.dbasis_smem, w_map, stream);
        case 128: return launch_dbasis<T, 128>(a, p.dbasis_smem, w_map, stream);
        default: return cudaErrorInvalidValue;
    }
}

// dynamic shared memory of sconv_dw_kernel<T, NW> with `stages` stages
template <class T, int NW>
constexpr size_t dw_smem(int stages) {
    return 1024 + (size_t)stages * (F32<T> ? DwF32Panel<NW>::STAGE : (2 + (NW + 63) / 64) * PANEL);
}

template <class T, int NW>
cudaError_t launch_dw(const T* basis, const T* gxw, float* partial, long long rows, int D, int C,
                      bool tma, const ConvPlan& p, cudaStream_t stream) {
    CUtensorMap b_map{}, g_map{};
    if constexpr (!F32<T>) {
        if ((tma && !sw128_map<bf16>(&b_map, basis, D, rows, 2LL * D, ROWS)) ||
            !sw128_map<bf16>(&g_map, gxw, p.cg, rows, 2LL * p.cg, ROWS))
            return cudaErrorInvalidValue;
    }
    static SmemLimit limit;
    cudaError_t err = limit.check(sconv_dw_kernel<T, NW>, dw_smem<T, NW>(p.dw_stages), p.dw_smem,
                                  p.dw_stages);
    if (err != cudaSuccess) return err;
    sconv_dw_kernel<T, NW><<<dim3(cdiv(D, 2 * ROWS), p.splits), BLOCK_THREADS, p.dw_smem, stream>>>(
        basis, gxw, partial, rows, p.per_split, D, C, p.cg, p.dw_stages, tma, b_map, g_map);
    return cudaGetLastError();
}

template <class T>
cudaError_t launch_dw_nw(const T* basis, const T* gxw, float* partial, long long rows, int D,
                         int C, bool tma, const ConvPlan& p, cudaStream_t stream) {
    switch (p.nw) {
        case 64: return launch_dw<T, 64>(basis, gxw, partial, rows, D, C, tma, p, stream);
        case 128: return launch_dw<T, 128>(basis, gxw, partial, rows, D, C, tma, p, stream);
        case 208: return launch_dw<T, 208>(basis, gxw, partial, rows, D, C, tma, p, stream);
        case 256: return launch_dw<T, 256>(basis, gxw, partial, rows, D, C, tma, p, stream);
        default: return cudaErrorInvalidValue;
    }
}

// the passes in order (see the header); w_maps: the maps of W^T's and W's
// copies
template <class T>
int conv_bwd(ConvArgs<T> a, int Bp, const CUtensorMap (&w_maps)[2], const int* order,
             const int* offsets, T* dbasis, float* dw, T* dx, float* partial, float* dwin,
             const ConvPlan& plan, cudaStream_t stream) {
    const int E = a.K * a.TA;
    a.Cg = plan.cg;
    a.rows = (long long)Bp * a.O * E;
    a.tiles_t = cdiv(a.TA, ROWS);
    a.n_tiles = Bp * a.O * a.K * a.tiles_t;
    cudaError_t err;
    sconv_gxw_kernel<T><<<cdiv(a.rows * (a.Cg / (16 / (int)sizeof(T))), arreau::THREADS),
                          arreau::THREADS, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    ConvArgs<T> db = a;
    db.out = dbasis;
    db.kp = plan.kc / PK<T>;
    db.stages = plan.dbasis_stages;
    db.n_tiles = cdiv(a.rows, ROWS);
    if ((err = launch_dbasis_nb<T>(db, plan, w_maps[1], stream)) != cudaSuccess)
        return static_cast<int>(err);

    if ((err = launch_dw_nw<T>(a.basis, a.gxw, partial, a.rows, a.D, a.C, a.tma, plan, stream)) !=
        cudaSuccess)
        return static_cast<int>(err);
    const long long n = (long long)a.D * a.C;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(partial, dw,
                                                                            plan.splits, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    ConvArgs<T> kx = a;
    kx.out = a.gxw;  // dxc over gxw, which dW has read
    kx.kp = plan.kd / PK<T>;
    kx.stages = plan.stages;
    int status;
    if ((status = conv_kern_sm90<T>(kx, plan, w_maps[0], Bp, stream)) != 0) return status;

    if ((status = spatial_conv_dx(a.gxw, order, offsets, dx, Bp, a.O, a.TA, E, a.C, a.Cg,
                                  !F32<T>, stream)) != 0 || dwin == nullptr)
        return status;
    dwin_sum_kernel<<<sum_splits_blocks((long long)Bp * E), arreau::THREADS, 0, stream>>>(
        a.dwin_partial, dwin, Bp, a.O, E, a.rows);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis, x, g, dbasis, dx and the scratch gxw ([B'*O*K*TA, plan.cg]) are
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); win, partial ([splits, D,
// C]) and dw are float32. w_maps: arreau_conv_weights_sm90's maps of W's two
// copies. order [B', K*TA] and offsets [B', TA + 1] (int32) list each b's
// live edges by sender, stably, and where each sender's run starts
// (kernels/spatial_conv.py:sender_order). dwin [B', K*TA] and its scratch
// dwin_partial [2, B'*O*K*TA] (float32) are both null or both given (the
// window cotangent). plan: the wrapper's tile plan; tma: TMA reads the basis
// rows (16-byte multiples at a 16-byte aligned base).
extern "C" int arreau_spatial_conv_bwd_sm90(
    const void* basis, const void* x, const int* src, const float* win, const int* order,
    const int* offsets, const void* g, void* dbasis, float* dw, void* dx, void* gxw,
    float* partial, float* dwin, float* dwin_partial, const void* w_maps, int Bp, int O, int K,
    int TA, int D, int C, const arreau::ConvPlan* plan, int tma, int is_bf16,
    void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if ((dwin == nullptr) != (dwin_partial == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[2];
    memcpy(maps, w_maps, sizeof maps);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        if (!plan_fits<T>(*plan, D, C)) return static_cast<int>(cudaErrorInvalidValue);
        ConvArgs<T> a{};
        a.basis = static_cast<const T*>(basis);
        a.x = static_cast<const T*>(x);
        a.g = static_cast<const T*>(g);
        a.src = src;
        a.win = win;
        a.gxw = static_cast<T*>(gxw);
        a.dwin_partial = dwin_partial;
        a.O = O, a.K = K, a.TA = TA, a.D = D, a.C = C;
        a.tma = tma != 0;
        status = conv_bwd<T>(a, Bp, maps, order, offsets, static_cast<T*>(dbasis), dw,
                             static_cast<T*>(dx), partial, dwin, *plan, stream);
    });
    return status;
}
