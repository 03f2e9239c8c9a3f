// The tensor-core tile product of the port's Hopper kernels: one block's
// BM x BN output tile as mma.sync fragments (mma.cuh), its operands staged
// in shared memory by 16-byte cp.async, several stages deep, so that the
// next tile's copies overlap this tile's products. Shared by #4/#2
// (spatial_conv_bwd.cu), #8/#7 (basis_h1.cuh, basis_mlp_bwd.cu), #3/#1
// (conv_fwd.cuh) and #9/#10 (convnext_rows.cuh, convnext_mlp_bwd.cu).
//
// TileProduct::run copies both operands; TileProduct::run_slots runs several
// products that share B (a conv's neighbour slots) through one ring, with a
// fold of each slot's product between them; TileProduct::run_built copies B and
// lets the block build A in shared memory itself, one K-stage at a time, the
// next stage's while the tensor cores work on this one's (the polynomial
// features of #8/#7, which never reach device memory); TileProduct::product
// runs the fragments alone on tiles a block stages itself (#9/#10's row
// blocks, which keep whole rows in shared memory).
#pragma once

#include <cstdint>

#include "dtype.cuh"
#include "mma.cuh"

namespace arreau {

constexpr int MIN_BLOCKS = 2;    // blocks per SM the tile products are compiled for

// cp.async stages of a tile product, and the depth of each: three of 64 in
// bfloat16 (half the barriers of 32-deep stages), two of 32 in float32: 110
// and 74 KB at 128 x 128, so two blocks of 256 threads fit an SM
template <class T>
constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }
template <class T>
constexpr int stage_depth() { return sizeof(T) == 2 ? 64 : 32; }

// A k-contiguous shared row holds BK elements and a pad that keeps
// ldmatrix rows (bf16: 144 bytes) and scalar tf32 reads (float: 36 words)
// on distinct banks; an m/n-contiguous row holds BM or BN and 8 more.
template <class T>
constexpr int k_pad() { return sizeof(T) == 2 ? 8 : 4; }

template <class T>
struct Operand {
    const T* p;  // the tile's origin
    long long ld;
    bool vec;    // rows 16-byte aligned: cp.async, else element copies
};

// ROWS x COLS elements from g (row stride ldg) into s (row stride LDS) by
// THREADS threads; outside row_lim x col_lim zero-filled
template <class T, int ROWS, int COLS, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ldg, int row_lim,
                                          int col_lim, bool vec) {
    constexpr int CH = 16 / sizeof(T);
    constexpr int PER_ROW = COLS / CH;
    static_assert(COLS % CH == 0, "a tile row is whole 16-byte chunks");
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
        T* dst = s + r * LDS + c;
        if (vec) {
            const int n = r < row_lim ? min(max(col_lim - c, 0), CH) : 0;
            cp_async16(dst, n ? g + r * ldg + c : g, n * (int)sizeof(T));
        } else {
#pragma unroll
            for (int j = 0; j < CH; ++j)
                dst[j] = r < row_lim && c + j < col_lim ? g[r * ldg + c + j] : from_float<T>(0.f);
        }
    }
}

// Stores v0, v1 at out[0], out[1] (out[1] only where n + 1 < n_lim), as one
// store when pair (the row stride and so the address is even).
template <class T>
__device__ __forceinline__ void store2(T* out, float v0, float v1, bool second, bool pair) {
    if constexpr (sizeof(T) == 2) {
        if (second && pair) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
            return;
        }
    } else {
        if (second && pair) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
            return;
        }
    }
    out[0] = from_float<T>(v0);
    if (second) out[1] = from_float<T>(v1);
}

// (p[0], p[1]) as floats, p[1] only where second (0 otherwise); one load
// when pair (the address is even)
template <class T>
__device__ __forceinline__ float2 load2(const T* p, bool second, bool pair) {
    if (second && pair) {
        if constexpr (sizeof(T) == 2)
            return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        else
            return *reinterpret_cast<const float2*>(p);
    }
    return make_float2(to_float(p[0]), second ? to_float(p[1]) : 0.f);
}

// acc += A B for one block's BM x BN tile: WARPS_M x WARPS_N warps, each
// MT m16 x NT n8 fragments. A warp's m16 rows are contiguous; its n8
// columns are interleaved with the other WARPS_N warps' (warp w holds n8
// tiles w, w + WARPS_N, ...). A (m, k) is a.p[m*ld + k] (A_K) or
// a.p[k*ld + m]; B (k, n) is b.p[n*ld + k] (B_K) or b.p[k*ld + n]. Rows
// m >= m_lim, columns n >= n_lim and depth k >= K read as zero; a warp whose
// rows or columns all lie outside skips its products. Ends with every copy
// landed and a barrier, so the caller may reuse shared memory.
template <class T, bool A_K, bool B_K, int WARPS_M, int WARPS_N, int MT, int NT>
struct TileProduct {
    static constexpr int THREADS = WARPS_M * WARPS_N * 32;
    static constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NT * 8;
    static constexpr int BK = stage_depth<T>();
    static constexpr int LDA = A_K ? BK + k_pad<T>() : BM + 8;
    static constexpr int LDB = B_K ? BK + k_pad<T>() : BN + 8;
    static constexpr int A_SIZE = (A_K ? BM : BK) * LDA;
    static constexpr int STAGE = A_SIZE + (B_K ? BN : BK) * LDB;
    static constexpr int STAGES = stages<T>();
    static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(T);
    // run_built's shared memory: STAGES B tiles, then two A tiles
    static constexpr int B_SIZE = (B_K ? BN : BK) * LDB;
    static constexpr size_t BUILT_SMEM = ((size_t)STAGES * B_SIZE + 2 * A_SIZE) * sizeof(T);
    using F = Mma<T>;
    using Acc = float[MT][NT][4];

    __device__ __forceinline__ static int warp_m0() {
        return (threadIdx.x / 32 % WARPS_M) * MT * 16;
    }
    // column of this warp's n8 tile j
    __device__ __forceinline__ static int warp_n(int j) {
        return (j * WARPS_N + threadIdx.x / 32 / WARPS_M) * 8;
    }

    __device__ __forceinline__ static void load_b(T* s, const Operand<T>& b, int k0, int K,
                                                  int n_lim) {
        if constexpr (B_K)
            load_tile<T, BN, BK, LDB, THREADS>(s, b.p + k0, b.ld, n_lim, K - k0, b.vec);
        else
            load_tile<T, BK, BN, LDB, THREADS>(s, b.p + k0 * b.ld, b.ld, K - k0, n_lim, b.vec);
    }

    __device__ __forceinline__ static void load_stage(T* s, const Operand<T>& a,
                                                      const Operand<T>& b, int k0, int K,
                                                      int m_lim, int n_lim) {
        if constexpr (A_K)
            load_tile<T, BM, BK, LDA, THREADS>(s, a.p + k0, a.ld, m_lim, K - k0, a.vec);
        else
            load_tile<T, BK, BM, LDA, THREADS>(s, a.p + k0 * a.ld, a.ld, K - k0, m_lim, a.vec);
        load_b(s + A_SIZE, b, k0, K, n_lim);
    }

    // every fragment of the stage (A at sa, B at sb), with no branch inside:
    // the tiles are zero-filled outside K, m_lim and n_lim, so the products
    // there add 0, and straight-line code lets the compiler issue the next
    // fragments' loads under this step's products. With depth < BK (a last,
    // ragged stage), only the product steps that reach into it.
    __device__ __forceinline__ static void compute_tiles(const T* sa, const T* sb, Acc& acc,
                                                         int depth = BK) {
        static_assert(NT % 2 == 0, "B fragments load in pairs");
#pragma unroll
        for (int kk = 0; kk < BK; kk += F::K) {
            if (kk >= depth) break;
            typename F::B fb[NT];
#pragma unroll
            for (int j = 0; j < NT; j += 2)
                F::template load_b2<B_K>(fb[j], fb[j + 1], sb, LDB, warp_n(j), warp_n(j + 1), kk);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                typename F::A fa;
                F::template load_a<A_K>(fa, sa, LDA, warp_m0() + i * 16, kk);
#pragma unroll
                for (int j = 0; j < NT; ++j) F::mma(acc[i][j], fa, fb[j]);
            }
        }
    }
    // acc += A B over depth K (a multiple of F::K, fixed at compile time so
    // that the steps unroll and the next step's fragments load under this
    // step's products) from tiles the caller keeps in shared memory itself,
    // at row strides lda and ldb (layouts A_K and B_K as in run; zero where
    // they lie outside the product): the row blocks of #9/#10
    // (convnext_rows.cuh). NT may be odd: the last n8 tile's fragment then
    // loads alone.
    template <int K>
    __device__ __forceinline__ static void product(const T* sa, int lda, const T* sb, int ldb,
                                                   Acc& acc) {
        static_assert(K % F::K == 0, "whole mma steps");
#pragma unroll
        for (int kk = 0; kk < K; kk += F::K) {
            typename F::B fb[NT];
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                if (j + 1 < NT)
                    F::template load_b2<B_K>(fb[j], fb[j + 1], sb, ldb, warp_n(j), warp_n(j + 1),
                                             kk);
                else
                    F::template load_b<B_K>(fb[j], sb, ldb, warp_n(j), kk);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                typename F::A fa;
                F::template load_a<A_K>(fa, sa, lda, warp_m0() + i * 16, kk);
#pragma unroll
                for (int j = 0; j < NT; ++j) F::mma(acc[i][j], fa, fb[j]);
            }
        }
    }
    __device__ __forceinline__ static void compute_stage(const T* s, Acc& acc) {
        compute_tiles(s, s + A_SIZE, acc);
    }

    __device__ static void run(const Operand<T>& a, const Operand<T>& b, int K, int m_lim,
                               int n_lim, T* smem, Acc& acc) {
        const int nk = (K + BK - 1) / BK;
        // warp-uniform: this warp's rows or columns all lie outside the output
        const bool live = warp_m0() < m_lim && warp_n(0) < n_lim;
#pragma unroll
        for (int st = 0; st < STAGES - 1; ++st) {
            if (st < nk) load_stage(smem + st * STAGE, a, b, st * BK, K, m_lim, n_lim);
            cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
            const int pf = kt + STAGES - 1;
            if (pf < nk) load_stage(smem + (pf % STAGES) * STAGE, a, b, pf * BK, K, m_lim, n_lim);
            cp_async_commit();
            if (live) compute_stage(smem + (kt % STAGES) * STAGE, acc);
        }
        cp_async_wait<0>();
        __syncthreads();
    }

    // As run, for `slots` products of depth K that share B, in one cp.async
    // ring: slot s's A starts a_step elements after slot s - 1's (same ld).
    // After slot s's last stage every thread calls fold(s, acc), acc holding
    // slot s's product alone, and acc restarts at zero. The ring does not
    // drain between slots: the next slot's first stages are in flight while
    // this one folds. Copies the caller issues before the call land with
    // the first stage (they join its commit group). Ends as run.
    template <class Fold>
    __device__ static void run_slots(const Operand<T>& a, long long a_step, int slots,
                                     const Operand<T>& b, int K, int m_lim, int n_lim, T* smem,
                                     Acc& acc, Fold fold) {
        const int nk = (K + BK - 1) / BK, total = slots * nk;
        const bool live = warp_m0() < m_lim && warp_n(0) < n_lim;
        auto load = [&](int q) {
            const int s = q / nk;
            const Operand<T> as = {a.p + s * a_step, a.ld, a.vec};
            load_stage(smem + (q % STAGES) * STAGE, as, b, (q - s * nk) * BK, K, m_lim, n_lim);
        };
#pragma unroll
        for (int st = 0; st < STAGES - 1; ++st) {
            if (st < total) load(st);
            cp_async_commit();
        }
        for (int q = 0; q < total; ++q) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();  // stage q has landed; every warp is done with stage q - 1
            const int pf = q + STAGES - 1;
            if (pf < total) load(pf);
            cp_async_commit();
            if (live) compute_stage(smem + (q % STAGES) * STAGE, acc);
            if ((q + 1) % nk == 0) {
                fold(q / nk, acc);
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                    for (int j = 0; j < NT; ++j)
#pragma unroll
                        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
            }
        }
        cp_async_wait<0>();
        __syncthreads();
    }

    // As run, with A built by the block into two shared tiles that
    // alternate: build(sa, slot, k0), called by every thread, writes A's
    // tile at depth k0 into sa (layout A_K, row stride LDA; zero outside K
    // and m_lim), reading what fetch(slot, k0) copied by cp.async for that
    // stage (slot in [0, STAGES)); fetch for a stage is issued with the B
    // copies of the stage before it. Stage kt + 1 is built right after
    // stage kt's products are issued, so that the building overlaps the
    // tensor cores, and one barrier a stage orders both. smem holds
    // BUILT_SMEM bytes.
    template <class Fetch, class Build>
    __device__ static void run_built(Fetch fetch, Build build, const Operand<T>& b, int K,
                                     int m_lim, int n_lim, T* smem, Acc& acc) {
        const int nk = (K + BK - 1) / BK;
        const bool live = warp_m0() < m_lim && warp_n(0) < n_lim;
        T* sa = smem + STAGES * B_SIZE;
        fetch(0, 0);
#pragma unroll
        for (int st = 0; st < STAGES - 1; ++st) {
            if (st < nk) load_b(smem + st * B_SIZE, b, st * BK, K, n_lim);
            if (st + 1 < nk) fetch((st + 1) % STAGES, (st + 1) * BK);
            cp_async_commit();
        }
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage 0 has landed
        build(sa, 0, 0);
        for (int kt = 0; kt < nk; ++kt) {
            cp_async_wait<STAGES - 2>();
            // B of kt and what stage kt + 1 builds from have landed; A of kt is
            // built; every warp is done with B of kt - 1 and A of kt - 1
            __syncthreads();
            const int pf = kt + STAGES - 1;
            if (pf < nk) load_b(smem + (pf % STAGES) * B_SIZE, b, pf * BK, K, n_lim);
            if (pf + 1 < nk) fetch((pf + 1) % STAGES, (pf + 1) * BK);
            cp_async_commit();
            if (live) {
                const T* sb = smem + (kt % STAGES) * B_SIZE;
                if (kt + 1 < nk)
                    compute_tiles(sa + (kt % 2) * A_SIZE, sb, acc);
                else  // the last stage: the steps that reach into K
                    compute_tiles(sa + (kt % 2) * A_SIZE, sb, acc, K - kt * BK);
            }
            if (kt + 1 < nk) build(sa + ((kt + 1) % 2) * A_SIZE, (kt + 1) % STAGES, (kt + 1) * BK);
        }
        cp_async_wait<0>();
        __syncthreads();
    }

    // The accumulators as floats into s[m * ACC_LD + n], the whole BM x BN
    // tile (float2 stores, conflict-free at this row stride), then a barrier:
    // an epilogue may then walk the tile a 16-byte row chunk at a time
    // (for_each_chunk), so that its device-memory reads and writes coalesce.
    // Call after run or run_built; the tile needs ACC_SMEM bytes.
    static constexpr int ACC_LD = BN + 8;
    static constexpr size_t ACC_SMEM = (size_t)BM * ACC_LD * sizeof(float);
    // shared memory of a kernel whose mainloop takes mainloop bytes and whose
    // epilogue stages the accumulators
    static constexpr size_t staged(size_t mainloop) {
        return mainloop > ACC_SMEM ? mainloop : ACC_SMEM;
    }
    __device__ __forceinline__ static void stage_acc(const Acc& acc, float* s) {
        for_each(acc, [&](int m, int n, float v0, float v1) {
            *reinterpret_cast<float2*>(s + m * ACC_LD + n) = make_float2(v0, v1);
        });
        __syncthreads();
    }
    // f(m, n) for every chunk of CHUNK = 16 / sizeof(T) columns of the tile,
    // consecutive threads on consecutive chunks of a row
    static constexpr int CHUNK = 16 / sizeof(T);
    template <class Fn>
    __device__ __forceinline__ static void for_each_chunk(Fn f) {
        constexpr int PER_ROW = BN / CHUNK;
        for (int i = threadIdx.x; i < BM * PER_ROW; i += THREADS)
            f(i / PER_ROW, i % PER_ROW * CHUNK);
    }

    // row(m) once for each of this thread's rows, then f(row(m), m, n,
    // acc[m][n], acc[m][n + 1]) for its column pairs (n even)
    template <class RowFn, class Fn>
    __device__ __forceinline__ static void for_each_row(const Acc& acc, RowFn row, Fn f) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
        const int m0 = warp_m0();
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + i * 16 + g + h * 8;
                const auto r = row(m);
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    f(r, m, warp_n(j) + 2 * t, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            }
    }

    // f(m, n, acc[m][n], acc[m][n + 1]) for every column pair of this thread
    // (n even)
    template <class Fn>
    __device__ __forceinline__ static void for_each(const Acc& acc, Fn f) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
        const int m0 = warp_m0();
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    f(m0 + i * 16 + g + h * 8, warp_n(j) + 2 * t, acc[i][j][2 * h],
                      acc[i][j][2 * h + 1]);
    }
};

// the products' block tile: 128 x 128 outputs, 8 warps of 64 rows x 4
// interleaved n8 tiles (larger warp tiles leave too few warps on an SM to
// hide the fragment loads)
template <class T, bool A_K, bool B_K>
using WideTile = TileProduct<T, A_K, B_K, 2, 4, 4, 4>;

// The first count (<= CHUNK = 16 / sizeof(T)) elements at p as floats, the
// rest 0; one 16-byte load where vec (p is 16-byte aligned) and count is
// the whole chunk
template <class T>
__device__ __forceinline__ void load_chunk(float* v, const T* p, int count, bool vec) {
    constexpr int CH = 16 / sizeof(T);
    if (vec && count == CH) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        if constexpr (sizeof(T) == 2) {
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < CH / 2; ++j) {
                const float2 f = __bfloat1622float2(h[j]);
                v[2 * j] = f.x, v[2 * j + 1] = f.y;
            }
        } else {
            v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
            v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) v[j] = j < count ? to_float(p[j]) : 0.f;
}

// v[0 .. count) rounded to T into p; one 16-byte store where vec and count
// is the whole chunk
template <class T>
__device__ __forceinline__ void store_chunk(T* p, const float* v, int count, bool vec) {
    constexpr int CH = 16 / sizeof(T);
    if (vec && count == CH) {
        uint4 q;
        if constexpr (sizeof(T) == 2) {
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < CH / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        } else {
            q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                           __float_as_uint(v[3]));
        }
        *reinterpret_cast<uint4*>(p) = q;
        return;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
        if (j < count) p[j] = from_float<T>(v[j]);
}

template <class T>
__device__ __forceinline__ T* shared_buffer() {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// whether p is 16-byte aligned and so is every row of stride ld (elements)
template <class T>
bool rows_aligned(const T* p, long long ld) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld * sizeof(T) % 16 == 0;
}

template <class T>
Operand<T> operand(const T* p, long long ld) {
    return {p, ld, rows_aligned(p, ld)};
}

}  // namespace arreau

namespace {

// partial[split, m, n] = sum over the split's rows of A[row, m] * B[row, n],
// A [rows, a.ld] and B [rows, b.ld] (m and n contiguous): the split-K
// weight gradients of #6 and float32 #10 on WideTile, blockIdx.y the split
template <class T>
__global__ void __launch_bounds__(arreau::WideTile<T, false, false>::THREADS, arreau::MIN_BLOCKS)
wide_rows_partial_kernel(arreau::Operand<T> a, arreau::Operand<T> b, float* __restrict__ partial,
                         long long rows, int rows_per_split, int M, int N) {
    using P = arreau::WideTile<T, false, false>;
    const int n_tiles = (N + P::BN - 1) / P::BN;
    const int m0 = blockIdx.x / n_tiles * P::BM, n0 = blockIdx.x % n_tiles * P::BN;
    const long long k0 = (long long)blockIdx.y * rows_per_split;
    const int K = (int)min(rows - k0, (long long)rows_per_split);
    typename P::Acc acc = {};
    P::run({a.p + k0 * a.ld + m0, a.ld, a.vec}, {b.p + k0 * b.ld + n0, b.ld, b.vec}, K, M - m0,
           N - n0, arreau::shared_buffer<T>(), acc);
    float* out = partial + (size_t)blockIdx.y * M * N + (size_t)m0 * N + n0;
    P::for_each(acc, [&](int m, int n, float v0, float v1) {
        if (m0 + m < M && n0 + n < N)
            arreau::store2(out + (size_t)m * N + n, v0, v1, n0 + n + 1 < N, N % 2 == 0);
    });
}

}  // namespace
