// First layer of the edge-basis MLP, forward, bfloat16, on Hopper's wgmma and
// TMA (sm_90a): #8's bfloat16 instantiation (basis_h1.cu keeps the float32
// one on mma.sync).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel
// (reached from basis_mlp_multi through _h1):
//
//   h1_pre[b',o,e,h] = round(b1[h] + sum_f round(poly(attrT[b',o,:,e])[f]) * W1[f,h])
//
// Bound on the H100: the bfloat16 output write, B'*O*E*H*2 bytes (0.21 GB
// at the training shape, 0.063 ms at 3.35 TB/s), above its 54 GFLOP at 989
// TFLOP/s (0.055 ms). Design (basis_sm90.cuh, h1_kernel): one persistent
// block an SM, two warpgroups each on 64 rows of a 128-row tile with all H
// columns in one m64nNk16 accumulator, so each row's features are formed
// once (the float32 mma.sync kernel forms them once a 128-column tile:
// twice at H = 200, the second tile 56 of its 128 columns wasted); W1^T's K
// panels arrive by TMA, each into a slot of its own where they fit (the
// model's F = 258: five panels, loaded once a block), else through a
// three-slot ring, refilled every tile; the rows leave through shared
// memory by TMA stores that overlap the next tile's products.

#include "basis_sm90.cuh"

namespace {

using namespace sm90;

template <int NH>
int launch_h1(const bf16* attrT, const bf16* b1, bf16* out, const bf16* w1t, long long rows,
              int d, int E, int F, int H, int kw1, bool tma_store, cudaStream_t stream) {
    CUtensorMap w1_map{}, out_map{};
    if (!sw128_map<bf16>(&w1_map, w1t, F, H, 2LL * kw1, NH) ||
        (tma_store && !sw128_map<bf16>(&out_map, out, H, rows, 2LL * H, ROWS)))
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
    const long long tiles = (rows + TILE - 1) / TILE;
    const int blocks = (int)(tiles < sm_count() ? tiles : sm_count());
    h1_kernel<NH><<<blocks, THREADS, smem, stream>>>(attrT, b1, out, rows, d, E, F, H, w1_map,
                                                      out_map, tma_store, stages);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// attrT [B'*O, d, E], w1 [F, H], b1 [H] and out [B'*O*E, H] bfloat16; w1t
// [H, kw1] scratch for W1^T (kw1 = F rounded up to 64); nh: the width class
// of H (64, 128, 208 or 256); tma_store: out's rows are 16-byte multiples,
// written by TMA stores (kernels/basis_h1.py:sm90_plan).
extern "C" int arreau_basis_h1_sm90(const void* attrT, const void* w1, const void* b1, void* out,
                                    void* w1t, int Bp, int O, int d, int E, int F, int H, int nh,
                                    int kw1, int tma_store, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long rows = (long long)Bp * O * E;
    const bf16* a = static_cast<const bf16*>(attrT);
    const bf16* b = static_cast<const bf16*>(b1);
    bf16* o = static_cast<bf16*>(out);
    bf16* wt = static_cast<bf16*>(w1t);
    weights_kernel<<<sum_splits_blocks((long long)H * kw1), arreau::THREADS, 0, stream>>>(
        static_cast<const bf16*>(w1), nullptr, wt, nullptr, nullptr, F, H, 0, kw1, 0, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (nh) {
        case 64: return launch_h1<64>(a, b, o, wt, rows, d, E, F, H, kw1, tma_store, stream);
        case 128: return launch_h1<128>(a, b, o, wt, rows, d, E, F, H, kw1, tma_store, stream);
        case 208: return launch_h1<208>(a, b, o, wt, rows, d, E, F, H, kw1, tma_store, stream);
        case 256: return launch_h1<256>(a, b, o, wt, rows, d, E, F, H, kw1, tma_store, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
