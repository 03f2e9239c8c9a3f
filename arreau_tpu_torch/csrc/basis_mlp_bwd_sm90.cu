// Edge-basis MLP, backward of all its consumers at once, bfloat16, on
// Hopper's wgmma and TMA (sm_90a): #7's bfloat16 instantiation
// (basis_mlp_bwd.cu keeps the float32 one on mma.sync).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_multi_bwd_kernel;
// the chain and its rounding points are basis_mlp_bwd.cu's.
//
// Bound on the H100: the n_g cotangent reads, n_g * rows * D * 2 bytes (1.34
// GB at the training shape, 0.40 ms), above 269 GFLOP at 989 TFLOP/s (0.27
// ms). The float32 kernel (basis_mlp_bwd.cu) runs the chain as five mma.sync
// tile products through ~2.3 GB (in bfloat16) of device-memory scratch. Here (basis_sm90.cuh) one kernel,
// rows_kernel (its instantiations in basis_rows128_sm90.cu and
// basis_rows256_sm90.cu, which compile in parallel with this file), runs the row-local part of the chain per 128-row tile in
// registers and shared memory (h1_pre, gelu and gelu', dpre2 with the
// cotangents, dpre1) and writes only what the weight gradients read: h1,
// dpre2 and dpre1, transposed (0.69 GB at the training shape, read back
// once); dw2_kernel and dw1_kernel then reduce over the rows on wgmma in
// 64-row panels, split-K with a fixed-order second pass.

#include "basis_sm90.cuh"

namespace {

using namespace sm90;

template <class Kernel>
cudaError_t allow(Kernel kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

using Args = Sm90Bwd;

template <int ND>
int launch_dw2(const Args& a, float* dw2, cudaStream_t stream) {
    CUtensorMap am{}, bm{};
    if (!sw128_map<bf16>(&am, a.h1t, a.rows, a.H + 1, 2LL * a.ld, TILE) ||
        !sw128_map<bf16>(&bm, a.dpre2t, a.rows, a.D, 2LL * a.ld, ND))
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = dw2_smem<ND>();
    cudaError_t err = allow(dw2_kernel<ND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw2_kernel<ND><<<dim3(cdiv(a.H + 1, TILE), a.splits), THREADS, smem, stream>>>(
        a.partial, a.rows, a.per_split, a.H + 1, a.D, am, bm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)(a.H + 1) * a.D;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(a.partial, dw2,
                                                                           a.splits, n);
    return static_cast<int>(cudaGetLastError());
}

template <int NH>
int launch_dw1(const Args& a, float* dw1, cudaStream_t stream) {
    CUtensorMap bm{};
    if (!sw128_map<bf16>(&bm, a.dpre1t, a.rows, a.H, 2LL * a.ld, NH))
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = dw1_smem<NH>();
    cudaError_t err = allow(dw1_kernel<NH>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw1_kernel<NH><<<dim3(cdiv(a.F + 1, TILE), a.splits), THREADS, smem, stream>>>(
        a.attrT, a.partial, a.rows, a.per_split, a.d, a.E, a.F, a.H, bm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)(a.F + 1) * a.H;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(a.partial, dw1,
                                                                           a.splits, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw1_ext [F+1, H] = [dW1; db1], dw2_ext [H+1, D] = [dW2; db2] (float32).
// attrT, the weights, biases and cotangents (gs: a host array of n_g device
// pointers) bfloat16. Scratch (bfloat16 unless said): w1t [H, kw1], w2t
// [D, kw2], w2c [H, kw3] (the weights K-major, kw* = F, H, D rounded up to
// 64); h1t [H+1, ld], dpre2t [D, ld], dpre1t [H, ld] (ld = rows rounded up
// to 64); partial [splits * max((F+1)*H, (H+1)*D)] float32. nh, nd: the
// width classes of H and D; splits of per_split rows (a multiple of 64;
// kernels/basis_h1.py:sm90_plan).
extern "C" int arreau_basis_mlp_bwd_sm90(
    const void* attrT, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* const* gs, int n_g, void* w1t, void* w2t, void* w2c, void* h1t, void* dpre2t,
    void* dpre1t, float* partial, float* dw1_ext, float* dw2_ext, int Bp, int O, int d, int E,
    int F, int H, int D, int nh, int nd, int kw1, int kw2, int kw3, long long ld, int splits,
    int per_split, void* stream_ptr) {
    if (n_g < 1 || n_g > SM90_MAX_G || per_split % PK != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    Args a{};
    a.attrT = static_cast<const bf16*>(attrT);
    a.b1 = static_cast<const bf16*>(b1);
    a.b2 = static_cast<const bf16*>(b2);
    a.n_g = n_g;
    for (int i = 0; i < n_g; ++i) a.g[i] = static_cast<const bf16*>(gs[i]);
    a.w1t = static_cast<const bf16*>(w1t);
    a.w2t = static_cast<const bf16*>(w2t);
    a.w2c = static_cast<const bf16*>(w2c);
    a.h1t = static_cast<bf16*>(h1t);
    a.dpre2t = static_cast<bf16*>(dpre2t);
    a.dpre1t = static_cast<bf16*>(dpre1t);
    a.partial = partial;
    a.rows = (long long)Bp * O * E;
    a.ld = ld;
    a.d = d, a.E = E, a.F = F, a.H = H, a.D = D, a.kw1 = kw1, a.kw2 = kw2, a.kw3 = kw3;
    a.splits = splits, a.per_split = per_split;

    const long long n_w = (long long)H * kw1 + (long long)D * kw2 + (long long)H * kw3;
    weights_kernel<<<sum_splits_blocks(n_w), arreau::THREADS, 0, stream>>>(
        static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), static_cast<bf16*>(w1t),
        static_cast<bf16*>(w2t), static_cast<bf16*>(w2c), F, H, D, kw1, kw2, kw3);
    int status = static_cast<int>(cudaGetLastError());
    if (status != 0) return status;
    status = nd == 128 ? sm90_rows_nd128(a, nh, stream)
                       : nd == 256 ? sm90_rows_nd256(a, nh, stream)
                                   : static_cast<int>(cudaErrorInvalidValue);
    if (status != 0) return status;
    status = nd == 128 ? launch_dw2<128>(a, dw2_ext, stream) : launch_dw2<256>(a, dw2_ext, stream);
    if (status != 0) return status;
    switch (nh) {
        case 64: return launch_dw1<64>(a, dw1_ext, stream);
        case 128: return launch_dw1<128>(a, dw1_ext, stream);
        case 208: return launch_dw1<208>(a, dw1_ext, stream);
        default: return launch_dw1<256>(a, dw1_ext, stream);
    }
}
