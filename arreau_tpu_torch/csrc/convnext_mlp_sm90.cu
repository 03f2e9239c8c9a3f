// Fused ConvNext MLP tail with the per-layer readout, forward (#9), in
// bfloat16 on Hopper's wgmma and TMA (sm_90a). The design is
// convnext_sm90.cuh's.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_fwd_kernel (the
// forward of fused_convnext_mlp, reached through _fwd). For each row (one
// (b', o, t) position) of the conv output xc and the residual res:
//
//   yl  = LayerNorm(xc) (scale ln_s, bias ln_b)
//   m   = gelu(yl @ W1 + b1) @ W2 + b2          (C -> W = 4C -> C)
//   out = res + gamma * m
//   r   = out @ Wr + br                          (optional readout, float32)
//
// Bound on the H100: 2*M*(2*C*W + C*R) operations (42.4 GFLOP at the
// training shape, M = 65536 rows, C = 200, W = 800, R = 19) against ~110 MB
// of traffic (xc, res and out, r), so arithmetic bounds it: 0.043 ms at the
// 989 TFLOP/s of the bf16 tensor cores. Both products run on wgmma, the
// second with h from registers (cnx_fwd_kernel); the readout's 1% runs on
// the CUDA cores after it (cnx_readout_kernel).
// (float32: convnext_mlp.cu.)

#include "convnext_sm90.cuh"

namespace {

template <int CN>
int launch_fwd(const Args& a, const CUtensorMap& w1t, const CUtensorMap& w2t, const CnxPlan& p,
               cudaStream_t stream) {
    static SmemLimit limit;
    cudaError_t err = limit.check(cnx_fwd_kernel<CN>, rows_smem(CN), p.smem, STAGES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cnx_fwd_kernel<CN><<<persistent_blocks(cdiv(a.M, TILE)), BLOCK_THREADS, p.smem, stream>>>(
        a, w1t, w2t);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xc [M, C], ln_s, ln_b, gamma [C] float32; res [M, C], w1 [C, W], b1 [W],
// w2 [W, C], b2 [C] and out [M, C] bfloat16; wr [C, R], br [R] and r [M, R]
// float32, or all three null (no readout); copies: bfloat16 scratch for the
// weights' K-major copies (the plan's `copies` elements); plan:
// kernels/convnext_mlp.py:sm90_plan's.
extern "C" int arreau_convnext_fwd_sm90(const float* xc, const void* res, const float* ln_s,
                                        const float* ln_b, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const float* gamma,
                                        const float* wr, const float* br, void* out, float* r,
                                        void* copies, int M, int C, int W, int R,
                                        const CnxPlan* plan, void* stream_ptr) {
    const CnxPlan& p = *plan;
    if (C < 1 || C > p.cn || p.nch * WC < W) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    CUtensorMap m1[2], m2[2];
    int status = weight_copies(static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
                               static_cast<bf16*>(copies), C, W, p, m1, m2, stream);
    if (status != 0) return status;
    Args a{};
    a.xc = xc, a.res = static_cast<const bf16*>(res), a.ln_s = ln_s, a.ln_b = ln_b;
    a.b1 = static_cast<const bf16*>(b1), a.b2 = static_cast<const bf16*>(b2), a.gamma = gamma;
    a.M = M, a.C = C, a.W = W, a.nch = p.nch;
    a.out = static_cast<bf16*>(out);
    a.vec = rows_aligned(a.res, C) && rows_aligned(a.out, C);
    status = p.cn == 208   ? launch_fwd<208>(a, m1[0], m2[1], p, stream)
             : p.cn == 256 ? launch_fwd<256>(a, m1[0], m2[1], p, stream)
                           : static_cast<int>(cudaErrorInvalidValue);
    if (status != 0 || wr == nullptr) return status;
    static SmemOptIn opt_in;
    const int smem = ROWS * readout_ld(C) * 2 + C * ((R + 3) / 4 * 4) * (int)sizeof(float);
    cudaError_t err = opt_in.ensure(cnx_readout_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cnx_readout_kernel<<<cdiv(M, ROWS), arreau::THREADS, smem, stream>>>(
        static_cast<const bf16*>(out), wr, br, r, M, C, R, a.vec);
    return static_cast<int>(cudaGetLastError());
}
