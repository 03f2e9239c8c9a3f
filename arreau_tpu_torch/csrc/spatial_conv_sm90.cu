// Spatial fiber-bundle convolution, forward (#3), float32 or bfloat16, on
// Hopper's wgmma and TMA (conv_sm90.cuh: bound, design, operands).
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
// adds nothing. The TPU kernel gathered senders with a one-hot matmul.
//
// Design. A persistent block walks tiles (bo = b'*O + o, receivers t0 ..
// t0 + 63) and, inside a tile, the K neighbour slots in ascending k. Slot
// k's A operand is the 64 rows basis[bo, k*TA + t0 ..], loaded by TMA through
// the 3-D map that clips it at TA; B is W^T (resident in bfloat16, streamed
// in float32). Each warpgroup's accumulator is its half of the slot's
// per-edge kernel, and it folds it into its running output in registers,
// out += win[e] * acc * x[src[e], c], in ascending k: the [E, C] kernel never
// reaches device memory, and the sums repeat bit for bit. The senders'
// features come from device memory (L2: x[bo] is one receiver tile's 25-100
// KB) into a staging tile of the warpgroup's by 16-byte cp.async, issued
// before the slot's products (its senders and windows a slot earlier), so
// that they land under them; the output leaves through the same tile in
// 16-byte stores. (Loads and stores in the accumulators' fragment layout,
// 4 bytes a thread and eight rows a warp instruction, took a large share of
// a tile's time in a development build.)
//
// Element type T (dtype.cuh) of basis, W, x and out: float32 (3xTF32
// products), or bfloat16 for the compute_dtype="bfloat16" path. The JAX
// kernel's cast points hold for both: float32 products and sums (the
// per-edge kernel is not rounded), one rounding as out is stored
// (pallas_conv.py:320, its out_dtype). The window stays float32.

#include "conv_sm90.cuh"

namespace {

using namespace arreau;
using namespace conv90;

// tiles: bo * tiles_t + (t0 / 64); a.out is out [B'*O, TA, C]
template <class T, int NB>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
sconv_fwd_kernel(const ConvArgs<T> a, const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap w_map) {
    __shared__ uint64_t full[MAX_STAGES], w_bar;
    __shared__ int released[MAX_STAGES];
    __shared__ int s_rows[2][ROWS];  // a warpgroup's rows to stage: the senders
    constexpr int BROWS = 2 * NB;    // W^T's rows: both warpgroups' columns
    unsigned char* smem = aligned_smem();
    const int w_bytes = F32<T> ? 0 : a.kp * BROWS * 128;
    const int per_tile = a.K * a.kp;
    Ring ring{full,     released, smem + w_bytes, slot_bytes<T>(NB), a.stages,
              block_tiles(a.n_tiles) * per_tile, a.tma || F32<T>};
    auto issue = [&](int q, int s) {
        const int tile = blockIdx.x + q / per_tile * gridDim.x, in = q % per_tile;
        const int k = in / a.kp, p = in % a.kp;
        unsigned char* dst = ring.slot(s);
        mbar_arrive_expect_tx(&ring.full[s],
                              (a.tma ? PANEL : 0) + (F32<T> ? 2 * BROWS * 128 : 0));
        if (a.tma)
            tma_load_3d(dst, &b_map, &ring.full[s], p * PK<T>, tile % a.tiles_t * ROWS,
                        tile / a.tiles_t * a.K + k);
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
        if constexpr (!F32<T>) {  // W^T resident: every K-panel once a block
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
    // this warpgroup's staging tile: the senders' features, then the output
    T* xs = reinterpret_cast<T*>(ring.base + a.stages * ring.bytes) + wg * ROWS * stage_ld<T>(NB);
    constexpr int CH = 16 / sizeof(T);
    const bool x_vec = a.C % CH == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    const bool o_vec = a.C % CH == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    const int E = a.K * a.TA;
    int q = 0;
    SlotRows next;  // the rows of the block's next slot
    if (blockIdx.x < a.n_tiles)
        next.load(a.src, a.win, blockIdx.x / a.tiles_t / a.O, 0, blockIdx.x % a.tiles_t * ROWS,
                  a.TA, E);
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int bo = tile / a.tiles_t, t0 = tile % a.tiles_t * ROWS, b = bo / a.O;
        float res[NB / 2];
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) res[i] = 0.f;
        for (int k = 0; k < a.K; ++k, q += a.kp) {
            const SlotRows rows = next;
            // the senders' features into the staging tile, by cp.async under
            // the slot's products; then the next slot's rows (this tile's, or
            // the block's next tile's first)
            wg_sync();  // the previous fold is done with the tile and s_rows
            if (tq == 0) s_rows[wg][m] = rows.s[0], s_rows[wg][m + 8] = rows.s[1];
            wg_sync();
            stage_rows<T, NB>(xs, a.x + (long long)bo * a.TA * a.C, s_rows[wg], col0, a.C, x_vec);
            const int nt = tile + gridDim.x;
            if (k + 1 < a.K)
                next.load(a.src, a.win, b, k + 1, t0, a.TA, E);
            else if (nt < a.n_tiles)
                next.load(a.src, a.win, nt / a.tiles_t / a.O, 0, nt % a.tiles_t * ROWS, a.TA, E);
            float acc[NB / 2];
            slot_product<T, NB>(acc, ring, q, a.kp, smem, a.tma,
                                a.basis + ((long long)(bo * a.K + k) * a.TA + t0) * a.D, a.D,
                                a.TA - t0, a.D, issue);
            product_finish<NB>(acc, ring, q + a.kp - 1, issue);
            cp_async_wait<0>();
            wg_sync();
#pragma unroll
            for (int j = 0; j < NB / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (rows.s[h] < 0) continue;
                    const float2 xf = pair_float(pair_at<T, NB>(xs, m + 8 * h, 8 * j + 2 * tq));
                    const int i = 4 * j + 2 * h;
                    res[i] += rows.w[h] * acc[i] * xf.x;
                    res[i + 1] += rows.w[h] * acc[i + 1] * xf.y;
                }
        }
        // the output, rounded once, through the staging tile
        wg_sync();  // every fold is done reading it
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                pair_at<T, NB>(xs, m + 8 * h, 8 * j + 2 * tq) =
                    to_pair<T>(res[4 * j + 2 * h], res[4 * j + 2 * h + 1]);
        wg_sync();
        store_rows<T, NB>(xs, a.out + ((long long)bo * a.TA + t0) * a.C, a.C, a.TA - t0, col0, a.C,
                          o_vec);
    }
}

template <class T, int NB>
int launch(ConvArgs<T> a, const ConvPlan& plan, const CUtensorMap& w_map, int Bp,
           cudaStream_t stream) {
    a.kp = plan.kd / PK<T>;
    a.stages = plan.stages;
    CUtensorMap b_map{};
    if (a.tma && !basis_map<T>(&b_map, a.basis, Bp * a.O * a.K, a.TA, a.D))
        return static_cast<int>(cudaErrorInvalidValue);
    static SmemLimit limit;
    cudaError_t err = limit.check(sconv_fwd_kernel<T, NB>, slot_smem<T>(NB, a.kp, a.stages, NB),
                                  plan.smem, a.stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.tiles_t = cdiv(a.TA, ROWS);
    a.n_tiles = Bp * a.O * a.tiles_t;
    sconv_fwd_kernel<T, NB><<<persistent_blocks(a.n_tiles), BLOCK_THREADS, plan.smem, stream>>>(
        a, b_map, w_map);
    return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_nb(const ConvArgs<T>& a, const ConvPlan& plan, const CUtensorMap& w_map, int Bp,
              cudaStream_t stream) {
    switch (plan.nc) {
        case 32: return launch<T, 32>(a, plan, w_map, Bp, stream);
        case 64: return launch<T, 64>(a, plan, w_map, Bp, stream);
        case 112: return launch<T, 112>(a, plan, w_map, Bp, stream);
        case 128: return launch<T, 128>(a, plan, w_map, Bp, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// W's two copies (weights_kernel) and their tensor maps, boxes of both
// warpgroups' rows: maps[0] over wt (2 nc rows), maps[1] over wk (2 nd rows)
template <class T>
int conv_weights(const T* w, T* wt, T* wk, CUtensorMap* maps, int D, int C, const ConvPlan& p,
                 cudaStream_t stream) {
    const long long n = 2LL * p.nc * p.kd + 2LL * p.nd * p.kc;
    weights_kernel<T><<<cdiv(n, arreau::THREADS), arreau::THREADS, 0, stream>>>(
        w, wt, wk, D, C, 2 * p.nc, p.kd, 2 * p.nd, p.kc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!weight_map<T>(&maps[0], wt, p.nc, p.kd) || !weight_map<T>(&maps[1], wk, p.nd, p.kc))
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

}  // namespace

// W [D, C] (float32 or bfloat16, is_bf16) into the B operands of #3 and #4:
// wt = W^T and wk = W, K-major and zero-padded (in float32 tf32 big halves,
// then the small ones), of plan.wt / plan.wk elements (kernels/spatial_conv.py:
// conv_sm90_plan), and their tensor maps into maps (two CUtensorMap, 256
// bytes), which the wrapper keeps with the copies for as long as W stays as
// it is and hands to the launches below.
extern "C" int arreau_conv_weights_sm90(const void* w, void* wt, void* wk, void* maps, int D,
                                        int C, const arreau::ConvPlan* plan, int is_bf16,
                                        void* stream) {
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        if (!plan_fits<T>(*plan, D, C)) return static_cast<int>(cudaErrorInvalidValue);
        CUtensorMap m[2];
        status = conv_weights<T>(static_cast<const T*>(w), static_cast<T*>(wt),
                                 static_cast<T*>(wk), m, D, C, *plan,
                                 static_cast<cudaStream_t>(stream));
        if (status == 0) memcpy(maps, m, sizeof m);
    });
    return status;
}

// basis, x and out are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// win is float32. w_maps: arreau_conv_weights_sm90's maps of W's copies;
// plan: the wrapper's tile plan; tma: TMA reads the basis rows (16-byte
// multiples at a 16-byte aligned base).
extern "C" int arreau_spatial_conv_fwd_sm90(const void* basis, const void* x, const int* src,
                                            const float* win, void* out, const void* w_maps,
                                            int Bp, int O, int K, int TA, int D, int C,
                                            const arreau::ConvPlan* plan, int tma, int is_bf16,
                                            void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        if (!plan_fits<T>(*plan, D, C)) return static_cast<int>(cudaErrorInvalidValue);
        ConvArgs<T> a{};
        a.basis = static_cast<const T*>(basis);
        a.x = static_cast<const T*>(x);
        a.src = src;
        a.win = win;
        a.out = static_cast<T*>(out);
        a.O = O, a.K = K, a.TA = TA, a.D = D, a.C = C, a.Cg = C;
        a.tma = tma != 0;
        CUtensorMap w_map;
        memcpy(&w_map, w_maps, sizeof w_map);
        status = launch_nb<T>(a, *plan, w_map, Bp, s);
    });
    return status;
}

extern "C" const char* arreau_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
