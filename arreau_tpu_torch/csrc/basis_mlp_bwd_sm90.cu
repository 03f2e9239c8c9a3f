// Edge-basis MLP, backward of all its consumers at once (#7), on Hopper's
// wgmma and TMA (sm_90a), in bfloat16 (basis_sm90.cuh) and float32 (3xTF32
// on tf32 wgmma, basis_f32_sm90.cuh).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_multi_bwd_kernel
// (the VJP of basis_mlp_multi, reached through _multi_bwd). The forward is
// basis = gelu(gelu(poly(attr) @ W1 + b1) @ W2 + b2), consumed by n_g conv
// layers; with g_i their cotangents, for every edge row:
//
//   h1_pre = poly @ W1 + b1,  h2_pre = gelu(h1_pre) @ W2 + b2
//   dpre2  = (g_0 + ... + g_{n_g-1}) * gelu'(h2_pre)
//   dpre1  = (dpre2 @ W2^T) * gelu'(h1_pre)
//   dW2 = sum_rows gelu(h1_pre)^T dpre2,  db2 = sum_rows dpre2
//   dW1 = sum_rows poly^T dpre1,          db1 = sum_rows dpre1
//
// GELU is the tanh approximation, value and derivative from one tanh. The
// attribute cotangent is not computed: attributes derive from positions and
// the lattice, which the training path does not differentiate. The JAX
// kernel's rounding points (pallas_basis.py:289-331), which the bfloat16
// kernels keep: h1_pre and h2_pre are rounded to bfloat16, as are gelu(h1_pre),
// gelu'(h1_pre) and gelu'(h2_pre); the cotangents are summed in float32;
// dpre2 and dpre1 are rounded before their products; every product sums in
// float32 and the weight and bias gradients are float32 sums. In float32
// every rounding is the identity.
//
// Bound on the H100, bfloat16: the n_g cotangent reads, n_g * rows * D * 2
// bytes (1.34 GB at the training shape, 0.40 ms), above 269 GFLOP at 989
// TFLOP/s (0.27 ms). One kernel, rows_kernel (its instantiations in
// basis_rows128_sm90.cu and basis_rows256_sm90.cu, which compile in
// parallel with this file), runs the row-local part of the chain per 128-row
// tile in registers and shared memory (h1_pre, gelu and gelu', dpre2 with the
// cotangents, dpre1) and writes only what the weight gradients read: h1,
// dpre2 and dpre1, transposed (0.69 GB at the training shape, read back
// once); dw2_kernel and dw1_kernel then reduce over the rows on wgmma in
// 64-row panels, split-K with a fixed-order second pass. Float32: the 269
// GFLOP at 165 TFLOP/s of 3xTF32 (1.63 ms) bound it; its five passes are
// basis_f32_sm90.cuh's.

#include <cstring>

#include "basis_f32_sm90.cuh"
#include "basis_sm90.cuh"

namespace {

using namespace sm90;

using Args = Sm90Bwd;

template <int ND>
int launch_dw2(const Args& a, float* dw2, cudaStream_t stream) {
    CUtensorMap am{}, bm{};
    if (!sw128_map<bf16>(&am, a.h1t, a.rows, a.H + 1, 2LL * a.ld, TILE) ||
        !sw128_map<bf16>(&bm, a.dpre2t, a.rows, a.D, 2LL * a.ld, ND))
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = dw2_smem<ND>();
    static SmemOptIn opt_in;
    cudaError_t err = opt_in.ensure(dw2_kernel<ND>, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw2_kernel<ND><<<dim3(cdiv(a.H + 1, TILE), a.splits), BLOCK_THREADS, smem, stream>>>(
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
    static SmemOptIn opt_in;
    cudaError_t err = opt_in.ensure(dw1_kernel<NH>, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw1_kernel<NH><<<dim3(cdiv(a.F + 1, TILE), a.splits), BLOCK_THREADS, smem, stream>>>(
        a.attrT, a.partial, a.rows, a.per_split, a.d, a.E, a.F, a.H, bm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)(a.F + 1) * a.H;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(a.partial, dw1,
                                                                           a.splits, n);
    return static_cast<int>(cudaGetLastError());
}

// float32: the five passes of basis_f32_sm90.cuh
int bwd_f32(const F32Bwd& a, const CUtensorMap (&maps)[3], float* dw1_ext, float* dw2_ext,
            const BasisPlan& p, cudaStream_t stream) {
    int status = arreau::f32_h1(a.attrT, a.b1, a.h1pre, a.hp, a.rows, a.d, a.E, a.F, a.H, maps[0], p,
                                stream);
    if (status == 0) status = arreau::f32_dpre2(a, maps[1], p, stream);
    if (status == 0) status = arreau::f32_dpre1(a, maps[2], p, stream);
    if (status == 0) status = arreau::f32_dw2(a, dw2_ext, p, stream);
    if (status == 0) status = arreau::f32_dw1(a, dw1_ext, p, stream);
    return status;
}

}  // namespace

// dw1_ext [F+1, H] = [dW1; db1], dw2_ext [H+1, D] = [dW2; db2] (float32).
// attrT, the biases and the cotangents (gs: a host array of n_g device
// pointers) bfloat16 (is_bf16 = 1) or float32; maps: the tensor maps of the
// weights' K-major copies (arreau_basis_weight_copy_sm90) W1^T (boxes of nh
// rows), W2^T (nd) and W2 (nh), 128 bytes each; plan: kernels/basis_h1.py:
// sm90_plan's. Scratch s1, s2, s3: bfloat16 h1t [H+1, ld], dpre2t [D, ld],
// dpre1t [H, ld] (ld = rows rounded up to 64); float32 h1_pre [rows, hp],
// dpre2 [rows, dp], dpre1 [rows, hp]; partial [splits * max((F+1)*H,
// (H+1)*D)] float32, splits of per_split rows (a multiple of 64).
extern "C" int arreau_basis_mlp_bwd_sm90(
    const void* attrT, const void* b1, const void* b2, const void* const* gs, int n_g,
    const void* maps, void* s1, void* s2, void* s3, float* partial, float* dw1_ext,
    float* dw2_ext, int Bp, int O, int d, int E, int F, int H, int D,
    const arreau::BasisPlan* plan, int is_bf16, void* stream_ptr) {
    const arreau::BasisPlan& p = *plan;
    if (n_g < 1 || n_g > SM90_MAX_G || p.per_split % PK != 0 || p.nh < H || p.nd < D)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    CUtensorMap m[3];
    memcpy(m, maps, sizeof m);
    if (!is_bf16) {
        F32Bwd a{};
        a.attrT = static_cast<const float*>(attrT);
        a.b1 = static_cast<const float*>(b1);
        a.b2 = static_cast<const float*>(b2);
        a.n_g = n_g;
        for (int i = 0; i < n_g; ++i) a.g[i] = static_cast<const float*>(gs[i]);
        a.h1pre = static_cast<float*>(s1);
        a.dpre2 = static_cast<float*>(s2);
        a.dpre1 = static_cast<float*>(s3);
        a.partial = partial;
        a.rows = (long long)Bp * O * E;
        a.d = d, a.E = E, a.F = F, a.H = H, a.D = D, a.hp = p.hp, a.dp = p.dp;
        return bwd_f32(a, m, dw1_ext, dw2_ext, p, stream);
    }
    Args a{};
    a.attrT = static_cast<const bf16*>(attrT);
    a.b1 = static_cast<const bf16*>(b1);
    a.b2 = static_cast<const bf16*>(b2);
    a.n_g = n_g;
    for (int i = 0; i < n_g; ++i) a.g[i] = static_cast<const bf16*>(gs[i]);
    a.w1_map = m[0], a.w2t_map = m[1], a.w2c_map = m[2];
    a.h1t = static_cast<bf16*>(s1);
    a.dpre2t = static_cast<bf16*>(s2);
    a.dpre1t = static_cast<bf16*>(s3);
    a.partial = partial;
    a.rows = (long long)Bp * O * E;
    a.ld = p.ld;
    a.d = d, a.E = E, a.F = F, a.H = H, a.D = D;
    a.splits = p.splits, a.per_split = p.per_split;
    int status = p.nd == 128 ? sm90_rows_nd128(a, p.nh, stream)
                 : p.nd == 256 ? sm90_rows_nd256(a, p.nh, stream)
                               : static_cast<int>(cudaErrorInvalidValue);
    if (status != 0) return status;
    status = p.nd == 128 ? launch_dw2<128>(a, dw2_ext, stream) : launch_dw2<256>(a, dw2_ext, stream);
    if (status != 0) return status;
    switch (p.nh) {
        case 64: return launch_dw1<64>(a, dw1_ext, stream);
        case 128: return launch_dw1<128>(a, dw1_ext, stream);
        case 208: return launch_dw1<208>(a, dw1_ext, stream);
        default: return launch_dw1<256>(a, dw1_ext, stream);
    }
}
