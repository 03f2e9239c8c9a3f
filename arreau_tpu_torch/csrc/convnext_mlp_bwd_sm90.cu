// Fused ConvNext MLP tail with the per-layer readout, backward (#10), in
// bfloat16 on Hopper's wgmma and TMA (sm_90a). The design is
// convnext_sm90.cuh's.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_bwd_kernel (the
// VJP of fused_convnext_mlp, reached through _bwd). The forward is recomputed,
// as the JAX VJP saves only the inputs; with g_out and g_r the cotangents of
// out and r:
//
//   g_total = g_out + g_r @ Wr^T               dWr = out^T g_r, dbr = sum g_r
//   dgamma  = sum_rows g_total * m             dres = g_total (stored in T)
//   dm      = g_total * gamma                  dW2 = h^T dm,    db2 = sum dm
//   dh      = dm @ W2^T
//   dpre1   = dh * gelu'(pre1)                 dW1 = yl^T dpre1, db1 = sum dpre1
//   dyln    = dpre1 @ W1^T
//   dln_s   = sum_rows dyln * xhat             dln_b = sum_rows dyln
//   dxc     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),  dxhat = dyln * ln_s
//
// Bound on the H100: 2*M*(6*C*W + 2*C*R) operations (127 GFLOP at the
// training shape), 0.13 ms at the bf16 tensor cores' rate. Passes:
//   1. cnx_prep_kernel: the LayerNorm (yl | 1), g_total (float32), dres, dm.
//   2. cnx_rows_kernel: per 64-row tile the forward's chunks (h | 1 and pre1
//      out), m out, the second pass's chunks (dpre1 and dyln out), on wgmma
//      with yl's and dm's tiles and the weights by TMA.
//   3. cnx_post_kernel: the LayerNorm VJP (dxc), out for [dWr; dbr], the
//      tiles' column sums of dgamma, dln_s, dln_b.
//   4. [dW2; db2] and [dW1; db1]: cnx_dw_kernel's split-K partials over the
//      rows (wgmma, MN-major operands by TMA), summed in split order.
//   5. [dWr; dbr]: cnx_readout_dw_kernel's split partials, summed in order.
//   6. dgamma, dln_s, dln_b: the tiles' column sums (sum_blocks_kernel).
// No atomics: every output repeats bit for bit. (float32: convnext_mlp_bwd.cu.)

#include <algorithm>

#include "convnext_sm90.cuh"

namespace {

template <int CN>
int launch_rows(const Args& a, const CUtensorMap (&m1)[2], const CUtensorMap (&m2)[2],
                const CUtensorMap& yl_map, const CUtensorMap& dm_map, const CnxPlan& p,
                cudaStream_t stream) {
    static SmemLimit limit;
    cudaError_t err = limit.check(cnx_rows_kernel<CN>, rows_smem(CN), p.smem, STAGES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cnx_rows_kernel<CN><<<persistent_blocks(cdiv(a.M, TILE)), BLOCK_THREADS, p.smem, stream>>>(
        a, m1[0], m2[1], m2[0], m1[1], yl_map, dm_map);
    return static_cast<int>(cudaGetLastError());
}

// out [Mdim, Ndim] = A^T B over the rows: A [rows, lda] (Mdim columns), B
// [rows, ldb] (Ndim columns), bfloat16 row-major; split-K partials, then
// their sum in split order
template <int NW>
int weight_grad(const bf16* A, int lda, int Mdim, const bf16* B, int ldb, int Ndim, float* partial,
                float* out, long long rows, const CnxPlan& p, cudaStream_t stream) {
    CUtensorMap am{}, bm{};
    if (!sw128_map<bf16>(&am, A, Mdim, rows, 2LL * lda, ROWS) ||
        !sw128_map<bf16>(&bm, B, Ndim, rows, 2LL * ldb, ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    static SmemLimit limit;
    cudaError_t err = limit.check(
        cnx_dw_kernel<NW>, 1024 + (size_t)p.dw_stages * (2 + (NW + 63) / 64) * PANEL, p.dw_smem,
        p.dw_stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    cnx_dw_kernel<NW><<<dim3(cdiv(Mdim, TILE), cdiv(Ndim, NW), p.splits), BLOCK_THREADS,
                        p.dw_smem, stream>>>(partial, rows, p.per_split, Mdim, Ndim, p.dw_stages,
                                             am, bm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)Mdim * Ndim;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(partial, out,
                                                                           p.splits, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as arreau_convnext_fwd_sm90's, with g_out [M, C] (bfloat16) and g_r
// [M, R] (float32; null without a readout). Outputs: dxc [M, C] float32, dres [M, C]
// bfloat16, dw1_ext [C+1, W] = [dW1; db1], dw2_ext [W+1, C] = [dW2; db2],
// dwr_ext [C+1, R] = [dWr; dbr] (unused without a readout) and colsum [3, C]
// = (dgamma, dln_s, dln_b), all float32. Scratch (plan: kernels/
// convnext_mlp.py:sm90_plan's): float32 g_total and dyln [M, C], stats [M, 2];
// bfloat16 yl_ext [M, cg], h_ext [M, wg], dm, m_s and out_s [M, cp], dpre1 [M,
// wp], pre1s [2 * ceil(M / 128) * nch * 4096]; float32 colpart [ceil(M / 64)
// * 3 * C] and partial [max(splits * max((W+1) * C, (C+1) * W), r_splits *
// (C+1) * R)].
extern "C" int arreau_convnext_bwd_sm90(
    const float* xc, const void* res, const float* ln_s, const float* ln_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const float* gamma, const float* wr,
    const void* g_out, const float* g_r, void* copies, float* dxc, void* dres, float* dw1_ext,
    float* dw2_ext, float* dwr_ext, float* colsum, float* g_total, float* dyln, float* stats,
    void* yl_ext, void* h_ext, void* dm, void* m_s, void* out_s, void* dpre1, void* pre1s,
    float* colpart, float* partial, int M, int C, int W, int R, const CnxPlan* plan,
    void* stream_ptr) {
    const CnxPlan& p = *plan;
    if (C < 1 || C > p.cn || p.nch * WC < W || (wr != nullptr && R < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    R = wr != nullptr ? R : 0;
    const long long rows = M;
    RowPass rp{};
    rp.xc = xc, rp.res = static_cast<const bf16*>(res), rp.ln_s = ln_s, rp.ln_b = ln_b;
    rp.gamma = gamma, rp.wr = wr, rp.g_out = static_cast<const bf16*>(g_out), rp.g_r = g_r;
    rp.g_total = g_total, rp.dres = static_cast<bf16*>(dres);
    rp.yl_ext = static_cast<bf16*>(yl_ext), rp.h_ext = static_cast<bf16*>(h_ext);
    rp.dm = static_cast<bf16*>(dm), rp.stats = reinterpret_cast<float2*>(stats);
    rp.m_s = static_cast<const bf16*>(m_s), rp.dyln = dyln, rp.dxc = dxc;
    rp.out_s = static_cast<bf16*>(out_s), rp.colpart = colpart;
    rp.M = M, rp.C = C, rp.W = W, rp.R = R, rp.cg = p.cg, rp.wg = p.wg, rp.cp = p.cp;

    // 1. the row pass before: LayerNorm, g_total, dres, dm
    static SmemOptIn prep_opt_in;
    const int prep_smem = R * KC * (int)sizeof(float);
    cudaError_t err = prep_opt_in.ensure(cnx_prep_kernel, prep_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int warps = arreau::THREADS / 32;
    cnx_prep_kernel<<<std::min(cdiv(rows, warps), 8 * sm_count()), arreau::THREADS, prep_smem,
                      stream>>>(rp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // 2. the rows on wgmma
    Args a{};
    a.b1 = static_cast<const bf16*>(b1), a.b2 = static_cast<const bf16*>(b2);
    a.M = M, a.C = C, a.W = W, a.nch = p.nch;
    a.pairs = C % 2 == 0;  // dyln is a fresh allocation
    a.h_ext = static_cast<bf16*>(h_ext), a.m_s = static_cast<bf16*>(m_s), a.dyln = dyln;
    a.dpre1 = static_cast<bf16*>(dpre1), a.pre1s = static_cast<uint4*>(pre1s);
    a.wg = p.wg, a.cp = p.cp, a.wp = p.wp;
    CUtensorMap m1[2], m2[2], yl_map{}, dm_map{};
    int status = weight_copies(static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
                               static_cast<bf16*>(copies), C, W, p, m1, m2, stream);
    if (status != 0) return status;
    if (!sw128_map<bf16>(&yl_map, yl_ext, p.cg, rows, 2LL * p.cg, ROWS) ||
        !sw128_map<bf16>(&dm_map, dm, C, rows, 2LL * p.cp, ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    status = p.cn == 208   ? launch_rows<208>(a, m1, m2, yl_map, dm_map, p, stream)
             : p.cn == 256 ? launch_rows<256>(a, m1, m2, yl_map, dm_map, p, stream)
                           : static_cast<int>(cudaErrorInvalidValue);
    if (status != 0) return status;

    // 3. the row pass after: dxc, out, the tiles' column sums
    cnx_post_kernel<<<cdiv(rows, ROWS), arreau::THREADS, 0, stream>>>(rp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // 4. the weight gradients
    status = p.cn == 208 ? weight_grad<208>(a.h_ext, p.wg, W + 1, rp.dm, p.cp, C, partial,
                                            dw2_ext, rows, p, stream)
                         : weight_grad<256>(a.h_ext, p.wg, W + 1, rp.dm, p.cp, C, partial,
                                            dw2_ext, rows, p, stream);
    if (status != 0) return status;
    if (p.n1 != 208) return static_cast<int>(cudaErrorInvalidValue);
    status = weight_grad<208>(rp.yl_ext, p.cg, C + 1, a.dpre1, p.wp, W, partial, dw1_ext, rows,
                              p, stream);
    if (status != 0) return status;

    if (R > 0) {
        // its sums, beside 48 KB of static staging: the opt-in at every size
        const size_t sums = (size_t)(C + 1) * ((R + 3) / 4 * 4) * sizeof(float);
        static SmemOptIn opt_in;
        if ((err = opt_in.ensure(cnx_readout_dw_kernel, (int)sums)) != cudaSuccess)
            return static_cast<int>(err);
        cnx_readout_dw_kernel<<<p.r_splits, arreau::THREADS, sums, stream>>>(
            rp.out_s, p.cp, g_r, partial, rows, C, R, p.r_per_split);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        const long long n = (long long)(C + 1) * R;
        sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(partial, dwr_ext,
                                                                               p.r_splits, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    const long long nc = 3LL * C;
    sum_blocks_kernel<<<(unsigned)((nc + 31) / 32), BLOCK_THREADS, 0, stream>>>(
        colpart, colsum, cdiv(rows, ROWS), nc);
    return static_cast<int>(cudaGetLastError());
}
