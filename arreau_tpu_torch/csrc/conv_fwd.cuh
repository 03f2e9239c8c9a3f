// The forward spatial conv on the tensor cores, shared by #3 (spatial_conv.cu)
// and #1 (fiber_conv.cu): for one super-crystal and orientation bo = b'*O + o,
//
//   out[bo,t,c] = sum_k win[b',e] * (basis[bo,e,:] @ W)[c] * x[bo,src[b',e],c]
//
// with e = k*TA + t and a sender outside [0, TA) an empty slot (adds
// nothing). #1 passes no window (its basis carries it): every slot weighs 1.
//
// Bound on the H100: the per-edge kernel basis @ W is 2*B'*O*E*D*C
// operations (53.7 GFLOP over all 32768 edge slots at the training shape
// B'=32, O=16, E=1024, D=256, C=200) against one read of the basis (268 MB
// in bfloat16). bfloat16 on the tensor cores (989 TFLOP/s) is bound by
// those bytes; float32 runs as 3xTF32 (mma.cuh, 495 / 3 TFLOP/s) and is
// bound by its operations.
//
// Design. A block owns one output tile of one bo: BM = 128 receivers t0..
// by BN = 128 channels c0.. (8 warps, TileProduct's 128 x 128 tile), and
// walks the K neighbour slots in ascending k. Slot k's A operand is a
// contiguous run of basis rows, basis[bo, k*TA + t0 ..] (ld D, m_lim =
// min(BM, TA - t0)); B is W's column tile. So each slot is an ordinary
// D-deep tile product (mma.sync: bf16, or 3xTF32 in float32), and row r of
// every slot's accumulator is the same receiver t0 + r: the fold
// out += win[e] * acc * x[src_e, c] is fragment for fragment, in registers,
// and the [E, C] per-edge kernel never reaches device memory. Sums are
// float32 in ascending k (deterministic: no atomics, every output the same
// bit for bit on every call).
//   - The slots run as one cp.async ring over K*D (TileProduct::run_slots):
//     with D = 256 a slot is only 4 stages deep in bf16 (8 in float32), and
//     a ring that drained between slots would idle the tensor cores at
//     every fold. The fold runs while the next slot's first stages land.
//   - The sender gather: every sender lies in the same bo's x, so the block
//     copies x[bo, 0:TA, c0:c0+BN] into shared memory once (by cp.async,
//     with the first stage) and every fold reads its senders there, two
//     channels at a time. Where TA rows do not fit (TA > ~430 in bf16, ~230
//     in float32) the fold reads x from device memory instead (x_ld = 0).
//   - src and win of the block's rows are staged in shared memory for
//     CONV_SLOT_CHUNK slots at a time (all K = 8 of the model's at once;
//     the ring drains between chunks, which only K > 32 sees).
//   - The ragged last column tile (C = 200: 128 + 72) computes the whole
//     128-wide tile on zero-filled columns of W: 22% of the products at
//     C = 200 are padding; no column is stored past C.
// Shared memory: the ring (3 stages of 64 in bf16: 107.5 KB; 2 of 32 in
// float32: 70 KB), src/win (8 KB at K = 8, at most 32 KB), the x tile (TA x 136: 34 KB in
// bf16, 68 KB in float32 at TA = 128): 150 / 146 KB, one block (8 warps) an
// SM. The accumulators (64 floats a thread) and the running output (64
// more) take ~170 registers, which the one block an SM allows.
//
// Element types: T (float32 or bfloat16) of basis, W and x; U of out: T for
// #3 (bfloat16 rounded once as it is stored, pallas_conv.py:320's
// out_dtype), float for #1's x_sp (float32 in both types, nothing rounded,
// pallas_conv.py:82-105). bf16 x bf16 products are exact in the float32
// accumulators; the window stays float32.
#pragma once

#include "dtype.cuh"
#include "mma.cuh"
#include "tile_product.cuh"

namespace arreau {

constexpr int CONV_MT = 4, CONV_NT = 4;  // a warp's m16 and n8 tiles
template <class T>
using ConvTile = TileProduct<T, true, false, 2, 4, CONV_MT, CONV_NT>;
constexpr int CONV_THREADS = 256;
constexpr int CONV_SLOT_CHUNK = 32;  // neighbour slots whose src / win a block stages at a time
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

// the x tile's row stride (elements): 16-byte rows, staggered banks
template <class T>
constexpr int conv_x_ld() { return ConvTile<T>::BN + 8; }

// The block's output tile (blockIdx.x: column tile, blockIdx.y: receiver
// tile, blockIdx.z: bo) into out [B'*O, TA, C]. win null: every slot
// weighs 1. x_ld: the x tile's row stride in shared memory, or 0 to read x
// from device memory; x_vec: x's rows are 16-byte aligned.
template <class T, class U>
__device__ __forceinline__ void conv_fwd_block(Operand<T> basis, Operand<T> w,
                                               const T* __restrict__ x,
                                               const int* __restrict__ src,
                                               const float* __restrict__ win,
                                               U* __restrict__ out, int O, int K, int TA,
                                               int D, int C, int x_ld, bool x_vec) {
    using P = ConvTile<T>;
    static_assert(P::THREADS == CONV_THREADS, "one thread per tile thread");
    const int c0 = blockIdx.x * P::BN, t0 = blockIdx.y * P::BM;
    const long long bo = blockIdx.z;
    const int b = (int)(bo / O), E = K * TA;
    const int m_lim = min(P::BM, TA - t0), n_lim = min(P::BN, C - c0);
    const int chunk = min(K, CONV_SLOT_CHUNK);
    T* smem = shared_buffer<T>();
    int* s_src = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) + P::SMEM);
    float* s_win = reinterpret_cast<float*>(s_src + chunk * P::BM);
    T* xs = reinterpret_cast<T*>(s_win + chunk * P::BM);
    const T* x_bo = x + bo * TA * C + c0;

    // the x tile, by cp.async: it lands with the ring's first stage
    if (x_ld) {
        constexpr int CH = 16 / sizeof(T), PER_ROW = P::BN / CH;
        for (int i = threadIdx.x; i < TA * PER_ROW; i += P::THREADS) {
            const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
            T* dst = xs + r * x_ld + c;
            if (x_vec) {
                const int n = min(max(n_lim - c, 0), CH);
                cp_async16(dst, n ? x_bo + (long long)r * C + c : x_bo, n * (int)sizeof(T));
            } else {
#pragma unroll
                for (int j = 0; j < CH; ++j)
                    dst[j] = c + j < n_lim ? x_bo[(long long)r * C + c + j] : from_float<T>(0.f);
            }
        }
    }
    const T* xt = x_ld ? xs : x_bo;
    const long long ldx = x_ld ? x_ld : C;
    const bool pair = ldx % 2 == 0;
    const int* src_b = src + (long long)b * E;
    typename P::Acc acc = {}, res = {};
    const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
    auto fold = [&](int k, const typename P::Acc& a) {  // k: the slot within the chunk
        const int* ks = s_src + k * P::BM;
        const float* kw = s_win + k * P::BM;
#pragma unroll
        for (int i = 0; i < CONV_MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = P::warp_m0() + i * 16 + g + h * 8;
                const int s = ks[m];
                if (s < 0) continue;
                const float wv = kw[m];
                const T* xr = xt + s * ldx;
#pragma unroll
                for (int j = 0; j < CONV_NT; ++j) {
                    const int n = P::warp_n(j) + 2 * tq;
                    if (n >= n_lim) continue;
                    const float2 xv = load2(xr + n, n + 1 < n_lim, pair);
                    res[i][j][2 * h] += wv * a[i][j][2 * h] * xv.x;
                    res[i][j][2 * h + 1] += wv * a[i][j][2 * h + 1] * xv.y;
                }
            }
    };
    for (int k0 = 0; k0 < K; k0 += chunk) {
        const int slots = min(chunk, K - k0);
        // the chunk's senders (-1 where empty or past TA) and windows for the
        // block's rows; the previous chunk's ring ended with a barrier
        for (int i = threadIdx.x; i < slots * P::BM; i += P::THREADS) {
            const int r = i % P::BM, e = (k0 + i / P::BM) * TA + t0 + r;
            const int s = r < m_lim ? src_b[e] : -1;
            s_src[i] = s >= 0 && s < TA ? s : -1;
            s_win[i] = win == nullptr || r >= m_lim ? 1.f : win[(long long)b * E + e];
        }
        P::run_slots({basis.p + (bo * E + (long long)k0 * TA + t0) * basis.ld, basis.ld,
                      basis.vec},
                     (long long)TA * basis.ld, slots, {w.p + c0, w.ld, w.vec}, D, m_lim, n_lim,
                     smem, acc, fold);
    }
    U* out_t = out + (bo * TA + t0) * C + c0;
    P::for_each(res, [&](int m, int n, float v0, float v1) {
        if (m < m_lim && n < n_lim)
            store2(out_t + (long long)m * C + n, v0, v1, n + 1 < n_lim, C % 2 == 0);
    });
}

// Shared memory of a block, and the x tile's row stride (0: x is read from
// device memory, its TA rows do not fit beside the ring)
template <class T>
void conv_fwd_smem(int K, int TA, size_t& bytes, int& x_ld) {
    using P = ConvTile<T>;
    const int chunk = K < CONV_SLOT_CHUNK ? K : CONV_SLOT_CHUNK;
    const size_t base = P::SMEM + (size_t)chunk * P::BM * (sizeof(int) + sizeof(float));
    const size_t with_x = base + (size_t)TA * conv_x_ld<T>() * sizeof(T);
    x_ld = with_x <= MAX_SMEM ? conv_x_ld<T>() : 0;
    bytes = x_ld ? with_x : base;
}

template <class T>
dim3 conv_fwd_grid(int Bp, int O, int TA, int C) {
    using P = ConvTile<T>;
    return dim3((C + P::BN - 1) / P::BN, (TA + P::BM - 1) / P::BM, Bp * O);
}

}  // namespace arreau
