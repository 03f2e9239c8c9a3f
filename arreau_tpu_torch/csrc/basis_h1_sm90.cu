// First layer of the edge-basis MLP, forward (#8), on Hopper's wgmma and TMA
// (sm_90a), in bfloat16 (basis_sm90.cuh: h1_kernel) and float32 (3xTF32 on
// tf32 wgmma, basis_f32_sm90.cuh: f32_h1_kernel, in basis_h1_f32_sm90.cu);
// and the weights' K-major copies both types' #8 and #7 read.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel
// (reached from basis_mlp_multi through _h1):
//
//   h1_pre[b',o,e,h] = round(b1[h] + sum_f round(poly(attrT[b',o,:,e])[f]) * W1[f,h])
//
// (round: to the element type; the identity in float32).
//
// Bound on the H100, bfloat16: the output write, B'*O*E*H*2 bytes (0.21 GB
// at the training shape, 0.063 ms at 3.35 TB/s), above its 54 GFLOP at 989
// TFLOP/s (0.055 ms). Design (basis_sm90.cuh, h1_kernel): one persistent
// block an SM, two warpgroups each on 64 rows of a 128-row tile with all H
// columns in one m64nNk16 accumulator, so each row's features are formed
// once; W1^T's K panels arrive by TMA, each into a slot of its own where
// they fit (the model's F = 258: five panels, loaded once a block), else
// through a three-slot ring, refilled every tile; the rows leave through
// shared memory by TMA stores that overlap the next tile's products.
// Float32: the 54 GFLOP at 165 TFLOP/s of 3xTF32 (0.33 ms) bound it; W1^T
// streams through a ring and is split into its tf32 halves where it lands
// (basis_f32_sm90.cuh).

#include <cstring>

#include "basis_f32_sm90.cuh"
#include "basis_sm90.cuh"

namespace {

using namespace sm90;

template <int NH>
int launch_h1(const bf16* attrT, const bf16* b1, bf16* out, const CUtensorMap& w1_map,
              long long rows, int d, int E, int F, int H, bool tma_store, cudaStream_t stream) {
    CUtensorMap out_map{};
    if (tma_store && !sw128_map<bf16>(&out_map, out, H, rows, 2LL * H, ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    // W1 resident (a slot for each of its K panels) where the slots fit in
    // the shared memory a block may take beside the kernel's static arrays
    // (queried once, with the opt-in allowed once)
    static size_t room = 0;
    if (room == 0) {
        cudaFuncAttributes attr{};
        int optin = 0, dev = 0;
        cudaError_t err = cudaFuncGetAttributes(&attr, h1_kernel<NH>);
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(h1_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       optin - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        room = optin - attr.sharedSizeBytes;
    }
    const int kp = cdiv(F, PK);
    const int stages = kp <= MAX_STAGES && h1_smem<NH>(kp) <= room ? kp : STAGES;
    const size_t smem = h1_smem<NH>(stages);
    h1_kernel<NH><<<persistent_blocks(cdiv(rows, TILE)), BLOCK_THREADS, smem, stream>>>(
        attrT, b1, out, rows, d, E, F, H, w1_map, out_map, tma_store, stages);
    return static_cast<int>(cudaGetLastError());
}

// K-major, zero-padded copy of W [R, C] (row-major) for the products' B
// operands: copy[n, k] = W[k, n] (transpose: N = C, K = R) or W[n, k] (N = R,
// K = C), for n < n_rows and k < kw
template <class T>
__global__ void __launch_bounds__(arreau::THREADS)
basis_weight_copy_kernel(const T* __restrict__ w, T* __restrict__ copy, int R, int C,
                         bool transpose, int n_rows, int kw) {
    const long long n1 = (long long)n_rows * kw;
    for (long long e = blockIdx.x * (long long)arreau::THREADS + threadIdx.x; e < n1;
         e += (long long)gridDim.x * arreau::THREADS) {
        const int n = (int)(e / kw), k = (int)(e % kw);
        const bool in = transpose ? n < C && k < R : n < R && k < C;
        copy[e] = in ? w[transpose ? (long long)k * C + n : (long long)n * C + k]
                     : from_float<T>(0.f);
    }
}

// copy: W's K-major copy (basis_weight_copy_kernel) and m: its TMA tensor
// map, boxes of nb rows. bfloat16: copy [N, kw], the map over its [N, K] part
// (zeros outside); float32: copy [nb, kw], zero-padded, the map over all of
// it. kw: K rounded up to a 128-byte panel row (kernels/basis_h1.py:
// sm90_plan); nb >= N.
int weight_copy(const void* w, void* copy, CUtensorMap* m, int R, int C, int transpose, int nb,
                int kw, int is_bf16, cudaStream_t s) {
    const int N = transpose ? C : R, K = transpose ? R : C;
    const int pk = is_bf16 ? 64 : 32;
    if (nb < N || kw < K || kw % pk != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int n_rows = is_bf16 ? N : nb;
    const bool ok = is_bf16 ? sw128_map<bf16>(m, copy, K, N, 2LL * kw, nb)
                            : sw128_map<float>(m, copy, kw, nb, 4LL * kw, nb);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        basis_weight_copy_kernel<T><<<sum_splits_blocks((long long)n_rows * kw), arreau::THREADS,
                                      0, s>>>(static_cast<const T*>(w), static_cast<T*>(copy), R,
                                              C, transpose != 0, n_rows, kw);
    });
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// weight_copy, its map written to map (128 bytes) once the copy is queued
extern "C" int arreau_basis_weight_copy_sm90(const void* w, void* copy, void* map, int R, int C,
                                             int transpose, int nb, int kw, int is_bf16,
                                             void* stream) {
    CUtensorMap m{};
    const int err = weight_copy(w, copy, &m, R, C, transpose, nb, kw, is_bf16,
                                static_cast<cudaStream_t>(stream));
    if (err == 0) memcpy(map, &m, sizeof m);
    return err;
}

// attrT [B'*O, d, E], b1 [H] and out [B'*O*E, H], all bfloat16 (is_bf16 = 1)
// or float32; w1_map: arreau_basis_weight_copy_sm90's map of W1^T's copy
// (boxes of nh rows), or null: then W1 [F, H] (w1) is copied into w1_copy
// (plan's w1t elements) first, on the same stream, for a W1 whose copy is
// not kept (an inference tensor); plan: kernels/basis_h1.py:sm90_plan's
// (nh: the width class of H; bfloat16's tma_store: out's rows are 16-byte
// multiples, written by TMA stores; float32's ring slots and shared memory).
extern "C" int arreau_basis_h1_sm90(const void* attrT, const void* w1, const void* b1, void* out,
                                    const void* w1_map, void* w1_copy, int Bp, int O, int d,
                                    int E, int F, int H, const arreau::BasisPlan* plan,
                                    int is_bf16, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long rows = (long long)Bp * O * E;
    CUtensorMap w1m{};
    if (w1_map != nullptr) {
        memcpy(&w1m, w1_map, sizeof w1m);
    } else {
        const int err =
            weight_copy(w1, w1_copy, &w1m, F, H, 1, plan->nh, plan->kw1, is_bf16, stream);
        if (err != 0) return err;
    }
    if (!is_bf16)
        return arreau::f32_h1(static_cast<const float*>(attrT), static_cast<const float*>(b1),
                              static_cast<float*>(out), H, rows, d, E, F, H, w1m, *plan, stream);
    if (plan->nh < H) return static_cast<int>(cudaErrorInvalidValue);
    const bf16* a = static_cast<const bf16*>(attrT);
    const bf16* b = static_cast<const bf16*>(b1);
    bf16* o = static_cast<bf16*>(out);
    const bool tma_store = plan->tma_store != 0;
    switch (plan->nh) {
        case 64: return launch_h1<64>(a, b, o, w1m, rows, d, E, F, H, tma_store, stream);
        case 128: return launch_h1<128>(a, b, o, w1m, rows, d, E, F, H, tma_store, stream);
        case 208: return launch_h1<208>(a, b, o, w1m, rows, d, E, F, H, tma_store, stream);
        case 256: return launch_h1<256>(a, b, o, w1m, rows, d, E, F, H, tma_store, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
