// #4's per-edge kernel pass on Hopper's wgmma and TMA (conv_sm90.cuh), in
// a file of its own so that its instantiations compile beside the rest of
// spatial_conv_bwd_sm90.cu's. For each edge row (b', o, e = k*TA + t):
//
//   kern[e,:]   = basis[e,:] @ W                    (float32, never stored)
//   dxc[e,c]    = round_T(kern[e,c] * win[e] * g[t,c])   (0 on an empty slot)
//   dwin_h[e]   = sum over warpgroup h's columns c of kern[e,c] * (g[t,c] * x[src[e],c])
//
// dxc goes into the edge-cotangent scratch (dW has read gxw from it by
// then), for the dx pass to sum each sender's run; with the window
// cotangent dwin_h goes to dwin_partial[h, row], which dwin_sum_kernel adds
// over o and the two halves in a fixed order. A tile is one neighbour slot's
// 64 receivers: the same mainloop as #3 (slot_product), an epilogue per slot
// instead of a fold over them. g (at the receivers) comes into a staging
// tile of the warpgroup's by 16-byte cp.async under the tile's products,
// its senders and windows a tile earlier; the dx terms replace it there and
// leave in 16-byte stores (with dwin, x at the senders follows through the
// same tile). In a warpgroup a row's column terms are added in ascending
// column pairs by each of a quad's four lanes, then across the quad by two
// butterfly steps: a fixed order, so dwin repeats bit for bit.

#include "conv_sm90.cuh"

namespace {

using namespace arreau;
using namespace conv90;

// tiles: (bo * K + k) * tiles_t + t0 / 64; a.out is dxc [B'*O*E, Cg]
template <class T, int NB, bool DWIN>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
sconv_kern_kernel(const ConvArgs<T> a, const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap w_map) {
    __shared__ uint64_t full[MAX_STAGES], w_bar;
    __shared__ int released[MAX_STAGES];
    __shared__ int s_rows[2][ROWS];  // a warpgroup's rows to stage: receivers, then senders
    constexpr int BROWS = 2 * NB;
    unsigned char* smem = aligned_smem();
    const int w_bytes = F32<T> ? 0 : a.kp * BROWS * 128;
    Ring ring{full,     released, smem + w_bytes, slot_bytes<T>(NB), a.stages,
              block_tiles(a.n_tiles) * a.kp, a.tma || F32<T>};
    auto issue = [&](int q, int s) {
        const int tile = blockIdx.x + q / a.kp * gridDim.x, p = q % a.kp;
        unsigned char* dst = ring.slot(s);
        mbar_arrive_expect_tx(&ring.full[s],
                              (a.tma ? PANEL : 0) + (F32<T> ? 2 * BROWS * 128 : 0));
        if (a.tma)
            tma_load_3d(dst, &b_map, &ring.full[s], p * PK<T>, tile % a.tiles_t * ROWS,
                        tile / a.tiles_t);
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
    // this warpgroup's staging tile: g at the receivers, rewritten in place to
    // the dx terms; with dwin then x at the senders
    T* gs = reinterpret_cast<T*>(ring.base + a.stages * ring.bytes) + wg * ROWS * stage_ld<T>(NB);
    constexpr int CH = 16 / sizeof(T);
    const bool g_vec = a.C % CH == 0 && reinterpret_cast<uintptr_t>(a.g) % 16 == 0;
    const bool x_vec = a.C % CH == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    const int E = a.K * a.TA;
    int q = 0;
    // a tile's rows: (bo * K + k) = tile / tiles_t, b = that / (K * O)
    SlotRows next;  // the rows of the block's next tile
    if (blockIdx.x < a.n_tiles)
        next.load(a.src, a.win, blockIdx.x / a.tiles_t / (a.K * a.O),
                  blockIdx.x / a.tiles_t % a.K, blockIdx.x % a.tiles_t * ROWS, a.TA, E);
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, q += a.kp) {
        const int z = tile / a.tiles_t, t0 = tile % a.tiles_t * ROWS;
        const int bo = z / a.K;
        const long long row0 = (long long)z * a.TA + t0;  // edge row of (bo, k, t0)
        const T* tile_g = a.g + (long long)bo * a.TA * a.C;
        // g at the tile's receivers into the staging tile, under the products;
        // then the next tile's rows
        const SlotRows rows = next;
        wg_sync();  // the previous tile's epilogue is done with the tile and s_rows
        if (tq == 0)
            for (int h = 0; h < 2; ++h) s_rows[wg][m + 8 * h] = rows.t[h] < a.TA ? rows.t[h] : -1;
        wg_sync();
        stage_rows<T, NB>(gs, tile_g, s_rows[wg], col0, a.C, g_vec);
        const int nt = tile + gridDim.x;
        if (nt < a.n_tiles)
            next.load(a.src, a.win, nt / a.tiles_t / (a.K * a.O), nt / a.tiles_t % a.K,
                      nt % a.tiles_t * ROWS, a.TA, E);
        float acc[NB / 2];
        slot_product<T, NB>(acc, ring, q, a.kp, smem, a.tma, a.basis + row0 * a.D, a.D,
                            a.TA - t0, a.D, issue);
        product_finish<NB>(acc, ring, q + a.kp - 1, issue);
        cp_async_wait<0>();
        wg_sync();
        float gk[DWIN ? NB / 2 : 1];  // g, kept for the window cotangent
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h;
                Pair<T>& at = pair_at<T, NB>(gs, m + 8 * h, 8 * j + 2 * tq);
                const float2 gf = pair_float(at);
                if constexpr (DWIN) gk[i] = gf.x, gk[i + 1] = gf.y;
                float d0 = 0.f, d1 = 0.f;
                if (rows.s[h] >= 0) {
                    d0 = round_to<T>(acc[i] * rows.w[h] * gf.x);
                    d1 = round_to<T>(acc[i + 1] * rows.w[h] * gf.y);
                }
                at = to_pair<T>(d0, d1);
            }
        wg_sync();
        store_rows<T, NB>(gs, a.out + row0 * a.Cg, a.Cg, a.TA - t0, col0, a.C, true);
        if constexpr (DWIN) {
            // x at the senders through the same tile (g kept in registers)
            wg_sync();  // the stores have read the tile
            if (tq == 0) s_rows[wg][m] = rows.s[0], s_rows[wg][m + 8] = rows.s[1];
            wg_sync();
            stage_rows<T, NB>(gs, a.x + (long long)bo * a.TA * a.C, s_rows[wg], col0, a.C, x_vec);
            cp_async_wait<0>();
            wg_sync();
            float dw[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NB / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = col0 + 8 * j + 2 * tq, i = 4 * j + 2 * h;
                    if (rows.s[h] < 0 || c >= a.C) continue;
                    const float2 xf = pair_float(pair_at<T, NB>(gs, m + 8 * h, 8 * j + 2 * tq));
                    dw[h] += acc[i] * (gk[i] * xf.x) + acc[i + 1] * (gk[i + 1] * xf.y);
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float v = dw[h];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                if (tq == 0 && rows.t[h] < a.TA)
                    a.dwin_partial[wg * a.rows + row0 + m + 8 * h] = rows.s[h] >= 0 ? v : 0.f;
            }
        }
    }
}

template <class T, int NB, bool DWIN>
int launch(const ConvArgs<T>& a, int smem, const CUtensorMap& w_map, int Bp, cudaStream_t stream) {
    CUtensorMap b_map{};
    if (a.tma && !basis_map<T>(&b_map, a.basis, Bp * a.O * a.K, a.TA, a.D))
        return static_cast<int>(cudaErrorInvalidValue);
    static SmemLimit limit;
    cudaError_t err = limit.check(sconv_kern_kernel<T, NB, DWIN>,
                                  slot_smem<T>(NB, a.kp, a.stages, NB), smem, a.stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    sconv_kern_kernel<T, NB, DWIN><<<persistent_blocks(a.n_tiles), BLOCK_THREADS, smem, stream>>>(
        a, b_map, w_map);
    return static_cast<int>(cudaGetLastError());
}

template <class T, int NB>
int launch_dwin(const ConvArgs<T>& a, int smem, const CUtensorMap& w_map, int Bp,
                cudaStream_t stream) {
    return a.dwin_partial ? launch<T, NB, true>(a, smem, w_map, Bp, stream)
                          : launch<T, NB, false>(a, smem, w_map, Bp, stream);
}

}  // namespace

namespace arreau {

// a: the slot tiles' arguments (a.kp K-panels of D, a.stages, a.tiles_t,
// a.n_tiles), a.out the dxc scratch; w_map: the map of W^T's copy, in the
// plan's width class nc; the plan's shared memory for the slot tiles
template <class T>
int conv_kern_sm90(const ConvArgs<T>& a, const ConvPlan& plan, const CUtensorMap& w_map, int Bp,
                   cudaStream_t stream) {
    switch (plan.nc) {
        case 32: return launch_dwin<T, 32>(a, plan.smem, w_map, Bp, stream);
        case 64: return launch_dwin<T, 64>(a, plan.smem, w_map, Bp, stream);
        case 112: return launch_dwin<T, 112>(a, plan.smem, w_map, Bp, stream);
        case 128: return launch_dwin<T, 128>(a, plan.smem, w_map, Bp, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template int conv_kern_sm90<float>(const ConvArgs<float>&, const ConvPlan&, const CUtensorMap&,
                                   int, cudaStream_t);
template int conv_kern_sm90<bf16>(const ConvArgs<bf16>&, const ConvPlan&, const CUtensorMap&, int,
                                  cudaStream_t);

}  // namespace arreau
