// Fused ConvNext MLP tail with the per-layer readout, backward, float32, for
// sm_90a (bfloat16: convnext_mlp_bwd_sm90.cu).
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_convnext.py:_bwd_kernel (the
// VJP of fused_convnext_mlp, reached through _bwd). The forward is recomputed
// (convnext_mlp.cu), as the JAX VJP saves only the inputs; with g_out and
// g_r the cotangents of out and r:
//
//   g_total = g_out + g_r @ Wr^T               dWr = out^T g_r, dbr = sum g_r
//   dgamma  = sum_rows g_total * m             dres = g_total
//   dm      = g_total * gamma                  dW2 = h^T dm,    db2 = sum dm
//   dh      = dm @ W2^T
//   dpre1   = dh * gelu'(pre1)                 dW1 = yl^T dpre1, db1 = sum dpre1
//   dyln    = dpre1 @ W1^T
//   dln_s   = sum_rows dyln * xhat             dln_b = sum_rows dyln
//   dxc     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),  dxhat = dyln * ln_s
//
// (the last line is the VJP of the fast-variance LayerNorm), all in float32.
//
// Bound on the H100: three times the forward's products, 2*M*(6*C*W +
// 2*C*R) operations (127 GFLOP at the training shape), so arithmetic bounds
// it: 0.77 ms at float32's 3xTF32 rate. On the TPU each grid step held a (b', o) block and carried the
// parameter gradients across the sequential o axis. Hopper's blocks run in
// no order and per-block partials of dW1 and dW2 would take about 1.3 GB, so
// the weight gradients are split-K products over device-memory scratch
// written by a rows pass. Every product of width C or W runs on the tensor
// cores (mma.sync in 3xTF32, tile_product.cuh):
//
//   1. rows (convnext_rows.cuh): a block of 64 rows
//      recomputes the forward (both products on the tensor cores, chunk by
//      chunk), writing yl and h, each with a ones column, and pre1. From m
//      it forms g_total (g_r @ Wr^T from Wr^T and g_r staged in shared
//      memory), dres and dm, keeps out in shared memory for its partial of
//      [dWr; dbr] = [out | 1]^T g_r (R = 19 columns: float32 on the CUDA
//      cores, about 1% of the work) and takes its column sums of g_total *
//      m. Then, with dm back in shared memory, chunk by chunk again (each
//      stage brings the chunk's pre1 with W's slices): dh = dm @ W2[chunk]^T,
//      dpre1 = dh * gelu'(pre1) (written over pre1 and into
//      shared memory) and dyln += dpre1 @ W1[:, chunk]^T, held in registers
//      at full width; last the LayerNorm VJP, whose row sums stay in the
//      block (a warp a row), writing dxc and the block's column sums of
//      dyln * xhat and dyln.
//   2. [dW2; db2]: split-K over the rows with A = [h | 1], B = dm
//      (wide_rows_partial_kernel, tile_product.cuh).
//   3. [dW1; db1]: split-K with A = [yl | 1], B = dpre1.
//   4. the per-split and per-block partials are added in a fixed order (the
//      row blocks' across a block's warps, sum_blocks_kernel).
// No atomics: every sum has a fixed order, so the gradients are the same bit
// for bit on every call.

#include <type_traits>

#include "convnext_rows.cuh"

namespace {

using namespace arreau;

// 1. The forward of a row block and the row-wise part of the backward.
template <int CN>
__global__ void __launch_bounds__(ROW_THREADS, 1)
convnext_bwd_rows_kernel(ConvNextArgs a, const float* __restrict__ g_out,
                         const float* __restrict__ g_r, float* __restrict__ dxc,
                         float* __restrict__ dres, float* __restrict__ yl_ext, int Cg,
                         float* pre1,  // [M, W]: pre1, then dpre1
                         bool pre1_vec, float* __restrict__ h_ext, int Wg, float* __restrict__ dm_out,
                         bool dm_vec, float* __restrict__ colpart) {
    using B = RowBlock<CN>;
    constexpr int CH = B::CH;
    const typename B::Smem s = B::carve();
    const long long row0 = (long long)blockIdx.x * B::RB;
    const int nch = B::chunks(a.W), total = 2 * nch;  // the ring walks the chunks twice
    float* part = colpart + (size_t)blockIdx.x * 3 * a.C;

    B::fetch_chunk(a, s, 0, nch, nch);
    B::layer_norm(a, row0, s, s.stats, yl_ext, Cg);
    // h's ones column (db2 in the [dW2; db2] product) and zero padding
    for (int i = threadIdx.x; i < B::RB * (Wg - a.W); i += ROW_THREADS) {
        const long long row = row0 + i / (Wg - a.W);
        const int c = a.W + i % (Wg - a.W);
        if (row < a.M) h_ext[row * Wg + c] = (c == a.W ? 1.f : 0.f);
    }
    typename B::WideAcc acc = {};
    B::forward_chunks(a, row0, s, nch, nch, acc, pre1, h_ext, Wg);
    B::store_m(a, acc, s);
    __syncthreads();  // m is in sA; every warp is done with sH and the stages
    // over the stages: Wr^T [R][CN] (zero past C) and the block's rows of
    // g_r [RB][RP] (zero past M and R; RP = R rounded up to 4), for g_r @
    // Wr^T and [dWr; dbr]
    const int RP = (a.R + 3) / 4 * 4;
    float* wrt = reinterpret_cast<float*>(s.stage);
    float* grs = wrt + a.R * CN;
    if (a.wr != nullptr) {
        for (int i = threadIdx.x; i < a.R * CN; i += ROW_THREADS) {
            const int q = i / CN, c = i - q * CN;
            wrt[i] = c < a.C ? a.wr[c * a.R + q] : 0.f;
        }
        for (int i = threadIdx.x; i < B::RB * RP; i += ROW_THREADS) {
            const int r = i / RP, q = i - r * RP;
            grs[i] = row0 + r < a.M && q < a.R ? g_r[(row0 + r) * a.R + q] : 0.f;
        }
        __syncthreads();
    }

    // g_total, dres, dm, out (into sA over m, for [dWr; dbr]), and the
    // thread's column sums of g_total * m over its rows
    float dg[CH] = {};
    B::for_each_chunk([&](int r, int c0) {
        const long long row = row0 + r;
        if (row >= a.M || c0 >= a.C) return;
        float* sa = s.a + r * B::LD_A + c0;
        const int count = min(CH, a.C - c0);
        const long long at = row * a.C + c0;
        float m[CH], g[CH], dm[CH] = {};
        load_chunk(m, sa, CH, true);
        load_chunk(g, g_out + at, count, a.rows_vec);
        if (a.wr != nullptr) {
            float o[CH], gr[CH] = {};
            B::residual_out(a, row, c0, count, m, o);
            store_chunk(sa, o, CH, true);
            for (int q = 0; q < a.R; ++q) {
                const float gq = grs[r * RP + q];
                const float* wq = wrt + q * CN + c0;  // 16-byte aligned: CN, c0 multiples of 4
#pragma unroll
                for (int j = 0; j < CH; j += 4) {
                    const float4 w = *reinterpret_cast<const float4*>(wq + j);
                    gr[j] += gq * w.x, gr[j + 1] += gq * w.y;
                    gr[j + 2] += gq * w.z, gr[j + 3] += gq * w.w;
                }
            }
#pragma unroll
            for (int j = 0; j < CH; ++j) g[j] += gr[j];
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            if (j >= count) continue;
            dm[j] = (g[j] * a.gamma[c0 + j]);
            dg[j] += g[j] * m[j];
        }
        store_chunk(dres + at, g, count, a.rows_vec);
        store_chunk(dm_out + at, dm, count, a.rows_vec);
    });
    float* red = reinterpret_cast<float*>(s.h);  // [RG][CN]: the row groups' column sums
    if (threadIdx.x < B::PER_ROW * B::RG) {
        const int c0 = threadIdx.x % B::PER_ROW * CH, rg = threadIdx.x / B::PER_ROW;
#pragma unroll
        for (int j = 0; j < CH; ++j) red[rg * CN + c0 + j] = dg[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < a.C; c += ROW_THREADS) {
        float v = 0.f;
        for (int q = 0; q < B::RG; ++q) v += red[q * CN + c];
        part[c] = v;  // dgamma
    }
    // [dWr; dbr]'s partial over the block's rows, [out | 1]^T g_r from sA
    // and the staged g_r: a thread a channel c and four readout columns from
    // q0, the rows in ascending order
    if (a.wr != nullptr) {
        float* rpart =
            colpart + (size_t)gridDim.x * 3 * a.C + (size_t)blockIdx.x * (a.C + 1) * a.R;
        const int rows = (int)min((long long)B::RB, a.M - row0), groups = RP / 4;
        for (int i = threadIdx.x; i < (a.C + 1) * groups; i += ROW_THREADS) {
            const int c = i / groups, q0 = (i - c * groups) * 4;
            float v[4] = {};
#pragma unroll 4
            for (int r = 0; r < rows; ++r) {
                const float o = c < a.C ? s.a[r * B::LD_A + c] : 1.f;
                const float4 gq = *reinterpret_cast<const float4*>(grs + r * RP + q0);
                v[0] += o * gq.x, v[1] += o * gq.y, v[2] += o * gq.z, v[3] += o * gq.w;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (q0 + k < a.R) rpart[c * a.R + q0 + k] = v[k];
        }
    }
    __syncthreads();  // every warp is done with sA and the stages
    // dm into sA (zero past M and C), with loop 2's first stage
    load_tile<float, B::RB, CN, B::LD_A, ROW_THREADS>(s.a, dm_out + row0 * a.C, a.C,
                                                  (int)min((long long)B::RB, a.M - row0), a.C,
                                                  dm_vec);
    B::fetch_chunk(a, s, nch, nch, total, row0, pre1, pre1_vec);

    // dpre1 and dyln, chunk by chunk; the ring's stages nch.. hold the chunks again
    typename B::WideAcc dyln = {};
    for (int j = 0; j < nch; ++j) {
        const int q = nch + j;
        cp_async_wait<0>();
        // stage q has landed; dm is in sA; every warp is done with sH and
        // with stage q - 1
        __syncthreads();
        B::fetch_chunk(a, s, q + 1, nch, total, row0, pre1, pre1_vec);
        const float* w1s = s.stage + q % 2 * B::STAGE;
        const float* sp = s.pre1 + q % 2 * B::RB * B::LD_P;  // the chunk's pre1
        const int w0 = j * B::WC;
        typename B::ChunkAcc dh = {};
        B::template Chunk<true>::template product<CN>(s.a, B::LD_A, w1s + CN * B::LD_W1,
                                                      B::LD_W2, dh);
        B::chunk_pairs([&](int i, int hh, int jj, int m, int n) {
            const int w = w0 + n;
            const long long row = row0 + m;
            const bool live = row < a.M && w < a.W, second = live && w + 1 < a.W;
            const float2 p = load2(sp + m * B::LD_P + n, true, true);
            const float d0 =
                live ? ((dh[i][jj][2 * hh]) * gelu_deriv(p.x)) : 0.f;
            const float d1 =
                second ? ((dh[i][jj][2 * hh + 1]) * gelu_deriv(p.y)) : 0.f;
            store2(s.h + m * B::LD_H + n, d0, d1, true, true);
            if (live) store2(pre1 + row * a.W + w, d0, d1, second, a.W % 2 == 0);
        });
        __syncthreads();  // the chunk's dpre1 is in sH
        B::template Wide<true>::template product<B::WC>(s.h, B::LD_H, w1s, B::LD_W1, dyln);
    }

    // the LayerNorm VJP: dyln staged over the stages, then a warp a row
    __syncthreads();  // every warp is done with the stages and sA
    float* dy = reinterpret_cast<float*>(s.stage);
    B::template Wide<true>::for_each(dyln, [&](int m, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(dy + m * B::LD_ACC + c) = make_float2(v0, v1);
    });
    __syncthreads();
    constexpr int PER_LANE = (CN + 31) / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float cs[PER_LANE] = {}, cb[PER_LANE] = {};  // column sums of dyln * xhat and dyln
    for (int r = warp; r < B::RB; r += ROW_WARPS) {
        const long long row = row0 + r;
        if (row >= a.M) break;
        const float mu = s.stats[r], rstd = s.stats[B::RB + r];
        const float* xr = a.xc + row * a.C;
        float xh[PER_LANE], dxh[PER_LANE], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int c = lane + 32 * k;
            xh[k] = dxh[k] = 0.f;
            if (c >= a.C) continue;
            const float d = dy[r * B::LD_ACC + c];
            xh[k] = (xr[c] - mu) * rstd;
            dxh[k] = d * a.ln_s[c];
            s1 += dxh[k];
            s2 += dxh[k] * xh[k];
            cs[k] += d * xh[k];
            cb[k] += d;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int c = lane + 32 * k;
            if (c < a.C) dxc[row * a.C + c] = rstd * (dxh[k] - s1 / a.C - xh[k] * (s2 / a.C));
        }
    }
    float* wred = reinterpret_cast<float*>(s.a);  // [warps][2][CN]
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        const int c = lane + 32 * k;
        if (c < CN) {
            wred[(2 * warp) * CN + c] = cs[k];
            wred[(2 * warp + 1) * CN + c] = cb[k];
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < a.C; c += ROW_THREADS) {
        float vs = 0.f, vb = 0.f;
        for (int w = 0; w < ROW_WARPS; ++w) {
            vs += wred[(2 * w) * CN + c];
            vb += wred[(2 * w + 1) * CN + c];
        }
        part[a.C + c] = vs;      // dln_s
        part[2 * a.C + c] = vb;  // dln_b
    }
}

// 2./3. [partial] = split-K partials of A^T B over the rows
// (wide_rows_partial_kernel: [dW2; db2] with A = [h | 1] and B = dm, [dW1;
// db1] with A = [yl | 1] and B = dpre1), then their fixed-order sum into out
cudaError_t weight_grad(Operand<float> a, Operand<float> b, float* partial, float* out,
                        long long rows, int M, int N, int splits, int rows_per_split,
                        cudaStream_t stream) {
    using P = WideTile<float, false, false>;
    cudaError_t err = allow_smem(wide_rows_partial_kernel<float>, P::SMEM);
    if (err != cudaSuccess) return err;
    wide_rows_partial_kernel<float>
        <<<dim3(((M + P::BM - 1) / P::BM) * ((N + P::BN - 1) / P::BN), splits), P::THREADS,
           P::SMEM, stream>>>(a, b, partial, rows, rows_per_split, M, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long n = (long long)M * N;
    sum_splits_kernel<<<sum_splits_blocks(n), THREADS, 0, stream>>>(partial, out, splits, n);
    return cudaGetLastError();
}

template <int CN>
int convnext_mlp_bwd(const ConvNextArgs& a, const float* g_out, const float* g_r, float* dxc,
                     float* dres, float* dw1_ext, float* dw2_ext, float* dwr_ext, float* colsum,
                     float* yl_s, float* pre1_s, float* h_s, float* dm_s, float* colpart,
                     float* partial, int splits, int rows_per_split, cudaStream_t stream) {
    using B = RowBlock<CN>;
    const int Cg = (a.C + 1 + 7) / 8 * 8, Wg = (a.W + 1 + 7) / 8 * 8;  // rows stay 16-byte aligned
    const unsigned blocks = static_cast<unsigned>((a.M + B::RB - 1) / B::RB);
    cudaError_t err = allow_smem(convnext_bwd_rows_kernel<CN>, B::BWD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    convnext_bwd_rows_kernel<CN><<<blocks, ROW_THREADS, B::BWD_SMEM, stream>>>(
        a, g_out, g_r, dxc, dres, yl_s, Cg, pre1_s, rows_aligned(pre1_s, a.W), h_s, Wg, dm_s,
        rows_aligned(dm_s, a.C), colpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    if ((err = weight_grad(operand(h_s, Wg), operand(dm_s, a.C), partial, dw2_ext, a.M, a.W + 1,
                           a.C, splits, rows_per_split, stream)) != cudaSuccess)
        return static_cast<int>(err);
    if ((err = weight_grad(operand(yl_s, Cg), operand(pre1_s, a.W), partial, dw1_ext, a.M,
                           a.C + 1, a.W, splits, rows_per_split, stream)) != cudaSuccess)
        return static_cast<int>(err);

    if (a.wr != nullptr) {
        const long long nr = (long long)(a.C + 1) * a.R;
        sum_blocks_kernel<<<(unsigned)((nr + 31) / 32), ROW_THREADS, 0, stream>>>(
            colpart + (size_t)blocks * 3 * a.C, dwr_ext, static_cast<int>(blocks), nr);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    const long long nc = 3LL * a.C;
    sum_blocks_kernel<<<(unsigned)((nc + 31) / 32), ROW_THREADS, 0, stream>>>(
        colpart, colsum, static_cast<int>(blocks), nc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as arreau_convnext_mlp_fwd, with g_out [M, C] and g_r [M, R] (null
// without a readout). Outputs: dxc [M, C], dres [M, C], dw1_ext [C+1, W] =
// [dW1; db1], dw2_ext [W+1, C] = [dW2; db2], dwr_ext [C+1, R] = [dWr; dbr]
// (unused without a readout) and colsum [3, C] = (dgamma, dln_s, dln_b).
// Scratch: yl_s [M, Cg] and h_s [M, Wg] (Cg, Wg = C + 1, W + 1 rounded up to
// 8), pre1_s [M, W] and dm_s [M, C]; colpart [at least ceil(M/64) * (3*C +
// (C+1)*R)] (the row blocks' column sums, then their [dWr; dbr] partials) and
// partial [splits * max((W+1)*C, (C+1)*W)]. All float32. R <= MAX_READOUT.
// (bfloat16: convnext_mlp_bwd_sm90.cu.)
extern "C" int arreau_convnext_mlp_bwd(
    const float* xc, const float* res, const float* ln_s, const float* ln_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* gamma, const float* wr,
    const float* br, const float* g_out, const float* g_r, float* dxc, float* dres,
    float* dw1_ext, float* dw2_ext, float* dwr_ext, float* colsum, float* yl_s, float* pre1_s,
    float* h_s, float* dm_s, float* colpart, float* partial, int M, int C, int W, int R,
    int splits, int rows_per_split, void* stream_ptr) {
    if (C < 1 || C > MAX_CHANNELS || (wr != nullptr && (R < 1 || R > MAX_READOUT)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bool rows_vec = rows_aligned(res, C) && rows_aligned(g_out, C) &&
                          rows_aligned(dres, C) && rows_aligned(dm_s, C);
    const ConvNextArgs a =
        convnext_args(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, M, C, W, R, rows_vec);
    const auto run = [&](auto cn) {
        return convnext_mlp_bwd<decltype(cn)::value>(a, g_out, g_r, dxc, dres, dw1_ext, dw2_ext,
                                                     dwr_ext, colsum, yl_s, pre1_s, h_s, dm_s,
                                                     colpart, partial, splits, rows_per_split,
                                                     stream);
    };
    return C <= MODEL_CN ? run(std::integral_constant<int, MODEL_CN>{})
                         : run(std::integral_constant<int, MAX_CHANNELS>{});
}
