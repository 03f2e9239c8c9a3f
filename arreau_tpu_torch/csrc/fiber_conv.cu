// Fused fiber-bundle convolution (spatial conv, sum over the K neighbour
// slots, fiber mixing), forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_conv.py:_fwd_kernel (called by
// _fwd, public entry fused_fiber_conv). For each super-crystal b' (TA atoms),
// output orientation p, receiver t and channel c:
//
//   y[b',p,t,c] = sum_o Kf[o,p,c] * sum_k (basis[b',o,e,:] @ W)[c] * x[b',o,src[b',e],c]
//
// with e = k*TA + t (k-major edge rows), the window already folded into the
// basis and Kf pre-scaled by 1/O. A sender outside [0, TA) (-1 by convention)
// is an empty neighbour slot and is skipped. The TPU gathered senders with a
// one-hot matmul; here the block indexes x directly.
//
// Bound on the H100: the per-edge kernel basis @ W is 2*B'*O*E*D*C float32
// operations (48.6 GFLOP over the filled rows at the training shape B'=32,
// O=16, E=1024, D=256, C=200) against a 537 MB basis read, so float32
// arithmetic bounds it; the fiber mixing adds 2*B'*O*P*TA*C (0.4 GFLOP).
//
// Design. The TPU carried y across a sequential o grid axis in VMEM.
// Hopper's blocks run in no order, so one block owns an output tile (b', 16
// receivers, 64 channels) for every p and walks the O*K slots (o, k) inside:
//   - the tile's 64 columns of W (D x 64, 64 KB at D = 256) are staged in
//     shared memory once and serve every slot;
//   - a slot's 16 basis rows (16 x D, 16 KB) arrive by cp.async into one of
//     two shared buffers while the previous slot computes, so the basis read
//     from device memory overlaps the arithmetic (one barrier pair per slot,
//     2048 FMAs a thread between them);
//   - per slot the 16 x 64 product basis-rows @ W runs in registers (2 x 4
//     per thread), is multiplied by the gathered sender features and summed
//     over k in registers: the per-edge kernel never reaches device memory;
//   - per o each thread folds its 2 x 4 x_sp values into its P x 2 x 4
//     outputs, which stay in registers (128 at P = 16; P is unrolled up to
//     MAX_P): no barrier and no atomics for y, which is written to device
//     memory once at the end (deterministic);
//   - when training, the caller passes an x_sp buffer and each thread also
//     stores its x_sp values there (52 MB at the training shape, ~16 us of
//     writes): the backward's residual, which spares it the recompute.
// Cost of the choice: ~215 registers a thread and 96 KB of shared memory
// allow two blocks (8 warps) per SM; the 2 x 4 sub-tiles read 2.5
// shared-memory wavefronts a warp per 8 FMAs. Why the pipeline: with so few
// warps, synchronous staging (a barrier pair per 16-deep step) leaves each
// global load's latency exposed; so staged, this kernel ran 2.8-3.0x slower
// than its plain version on the H100 (PERF.md).
//
// Element type T (dtype.cuh) of basis, W, x and Kf: float32, or bfloat16 on
// the compute_dtype="bfloat16" path. y and the x_sp residual stay float32 in
// both, as in the JAX kernel (pallas_conv.py:82-105: every product and sum
// float32, nothing rounded in between): values convert to float as they are
// read, W's slice is staged as float, and the slot buffers hold T (a
// bfloat16 slot is half the bytes, so its rows are padded to 8 elements to
// keep the 16-byte copies aligned). The float32 instantiation keeps the
// untemplated kernel's arithmetic.

#include <cuda_pipeline.h>

#include "dtype.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

constexpr int FBM = 16;                            // receivers per block
constexpr int FTM = 2;                             // receivers per thread
constexpr int FTHREADS = (FBM / FTM) * (BN / TN);  // 128
constexpr int MAX_P = 16;  // output orientations a thread holds in registers
static_assert(FTM == 2 && TN == 4, "the slot product reads A as 2 rows, W as float4");

// Four consecutive slot values as floats (8-byte aligned for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A slot row's stride in elements: D rounded up to 16 bytes of T.
template <class T>
__host__ __device__ __forceinline__ int slot_ld(int D) {
    constexpr int per16 = 16 / sizeof(T);
    return (D + per16 - 1) / per16 * per16;
}

// VEC: elements of T per copy (16 bytes when the basis rows are 16-byte
// aligned; a copy of under 4 bytes is a plain load and store)
template <class T, int VEC>
__global__ void __launch_bounds__(FTHREADS, 2)
fiber_conv_fwd_kernel(const T* __restrict__ basis,  // [B'*O, E, D]
                      const T* __restrict__ w,      // [D, C]
                      const T* __restrict__ x,      // [B'*O, TA, C]
                      const int* __restrict__ src,  // [B', E]
                      const T* __restrict__ fk,     // [O, P, C]
                      float* __restrict__ y,        // [B', P, TA, C]
                      float* __restrict__ x_sp,     // [B'*O, TA, C] or null
                      int O, int P, int K, int TA, int D, int C) {
    // dynamic shared memory: the W slice Ws [LD][BN] (float), then two slot
    // buffers As [2][FBM][LD] (T); LD = slot_ld<T>(D), the padding zero in both
    extern __shared__ __align__(16) float smem[];
    __shared__ int s_src[2][FBM];
    const int LD = slot_ld<T>(D);
    float* Ws = smem;
    T* As = reinterpret_cast<T*>(smem + (size_t)LD * BN);

    const int t0 = blockIdx.x * FBM;
    const int c0 = blockIdx.y * BN;
    const int b = blockIdx.z;
    const int E = K * TA;
    const int* src_b = src + (size_t)b * E;

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    for (int i = tid; i < LD * BN; i += FTHREADS) {
        const int d = i / BN, n = i % BN;
        Ws[i] = (d < D && c0 + n < C) ? to_float(w[(size_t)d * C + c0 + n]) : 0.f;
    }
    for (int i = tid; i < 2 * FBM * (LD - D); i += FTHREADS)
        As[(i / (LD - D)) * LD + D + i % (LD - D)] = from_float<T>(0.f);

    // slot s = o*K + k: rows e = k*TA + t0 .. + FBM of (b', o) into buffer buf;
    // rows past TA are left as they are (their sender is -1: never folded)
    auto stage = [&](int s, int buf) {
        const int o = s / K, e0 = (s % K) * TA + t0;
        const T* rows = basis + (((size_t)b * O + o) * E + e0) * D;
        T* dst = As + (size_t)buf * FBM * LD;
        const int live = TA - t0 < FBM ? TA - t0 : FBM;
        const int chunks = D / VEC;  // per row
        for (int i = tid; i < live * chunks; i += FTHREADS) {
            const int r = i / chunks, q = (i % chunks) * VEC;
            if constexpr (VEC * sizeof(T) >= 4)
                __pipeline_memcpy_async(dst + (size_t)r * LD + q, rows + (size_t)r * D + q,
                                        VEC * sizeof(T));
            else
                dst[(size_t)r * LD + q] = rows[(size_t)r * D + q];
        }
        if (tid < FBM) s_src[buf][tid] = tid < live ? src_b[e0 + tid] : -1;
    };

    const int S = O * K;
    stage(0, 0);
    __pipeline_commit();
    float out[MAX_P][FTM][TN] = {};  // y[b', p, t0 + ty*FTM + i, c0 + tx*TN + j]
    float acc[FTM][TN] = {};         // x_sp of the current o
    for (int s = 0; s < S; ++s) {
        const int buf = s & 1;
        if (s + 1 < S) stage(s + 1, buf ^ 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);  // this thread's copies of slot s have landed
        __syncthreads();           // everyone's have, and Ws and s_src[buf] are visible

        const T* a0 = As + ((size_t)buf * FBM + ty * FTM) * LD;
        const T* a1 = a0 + LD;
        float part[FTM][TN] = {};
        for (int d = 0; d < LD; d += 4) {
            const float4 u = load4(a0 + d);
            const float4 v = load4(a1 + d);
            const float av[2][4] = {{u.x, u.y, u.z, u.w}, {v.x, v.y, v.z, v.w}};
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
                const float4 bw = *reinterpret_cast<const float4*>(Ws + (size_t)(d + dd) * BN + tx * TN);
                const float bv[TN] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
                for (int i = 0; i < FTM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) part[i][j] = fmaf(av[i][dd], bv[j], part[i][j]);
            }
        }
        const int o = s / K;
        const T* x_bo = x + ((size_t)b * O + o) * TA * C;
#pragma unroll
        for (int i = 0; i < FTM; ++i) {
            const int sender = s_src[buf][ty * FTM + i];
            if (sender < 0 || sender >= TA) continue;
            const T* xs = x_bo + (size_t)sender * C;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = c0 + tx * TN + j;
                if (c < C) acc[i][j] = fmaf(part[i][j], to_float(xs[c]), acc[i][j]);
            }
        }
        if (s % K == K - 1) {
            if (x_sp != nullptr) {
                float* xo = x_sp + ((size_t)b * O + o) * TA * C;
#pragma unroll
                for (int i = 0; i < FTM; ++i) {
                    const int t = t0 + ty * FTM + i;
                    if (t >= TA) continue;
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        const int c = c0 + tx * TN + j;
                        if (c < C) xo[(size_t)t * C + c] = acc[i][j];
                    }
                }
            }
            // fiber mixing: y[p] += Kf[o, p] * x_sp[o] over this thread's elements
            const T* fk_o = fk + (size_t)o * P * C;
#pragma unroll
            for (int p = 0; p < MAX_P; ++p) {
                if (p >= P) break;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const int c = c0 + tx * TN + j;
                    const float kf = c < C ? to_float(fk_o[(size_t)p * C + c]) : 0.f;
#pragma unroll
                    for (int i = 0; i < FTM; ++i) out[p][i][j] = fmaf(kf, acc[i][j], out[p][i][j]);
                }
            }
#pragma unroll
            for (int i = 0; i < FTM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
        }
        __syncthreads();  // buffer buf and s_src[buf] are restaged by slot s + 2
    }
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
        if (p >= P) break;
#pragma unroll
        for (int i = 0; i < FTM; ++i) {
            const int t = t0 + ty * FTM + i;
            if (t >= TA) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = c0 + tx * TN + j;
                if (c < C) y[(((size_t)b * P + p) * TA + t) * C + c] = out[p][i][j];
            }
        }
    }
}

template <class T, int VEC>
int launch(const void* basis, const void* w, const void* x, const int* src, const void* fk,
           float* y, float* x_sp, int Bp, int O, int P, int K, int TA, int D, int C,
           cudaStream_t stream) {
    const size_t LD = slot_ld<T>(D);
    const size_t smem = LD * BN * sizeof(float) + 2 * FBM * LD * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(fiber_conv_fwd_kernel<T, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((TA + FBM - 1) / FBM, (C + BN - 1) / BN, Bp);
    fiber_conv_fwd_kernel<T, VEC><<<grid, FTHREADS, smem, stream>>>(
        static_cast<const T*>(basis), static_cast<const T*>(w), static_cast<const T*>(x), src,
        static_cast<const T*>(fk), y, x_sp, O, P, K, TA, D, C);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis, w, x and fk are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); y
// and x_sp are float32. x_sp: null, or a [B', O, TA, C] buffer that receives
// the spatial conv.
extern "C" int arreau_fiber_conv_fwd(const void* basis, const void* w, const void* x,
                                     const int* src, const void* fk, float* y, float* x_sp,
                                     int Bp, int O, int P, int K, int TA, int D, int C,
                                     int is_bf16, void* stream_ptr) {
    if (P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const size_t align = reinterpret_cast<size_t>(basis);
    if (is_bf16) {
        if (D % 8 == 0 && align % 16 == 0)
            return launch<bf16, 8>(basis, w, x, src, fk, y, x_sp, Bp, O, P, K, TA, D, C, stream);
        if (D % 2 == 0 && align % 4 == 0)
            return launch<bf16, 2>(basis, w, x, src, fk, y, x_sp, Bp, O, P, K, TA, D, C, stream);
        return launch<bf16, 1>(basis, w, x, src, fk, y, x_sp, Bp, O, P, K, TA, D, C, stream);
    }
    if (D % 4 == 0 && align % 16 == 0)
        return launch<float, 4>(basis, w, x, src, fk, y, x_sp, Bp, O, P, K, TA, D, C, stream);
    return launch<float, 1>(basis, w, x, src, fk, y, x_sp, Bp, O, P, K, TA, D, C, stream);
}
