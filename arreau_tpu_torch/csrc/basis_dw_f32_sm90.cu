// #7's float32 weight gradients (basis_f32_sm90.cuh: f32_dw_kernel, dW2 at
// each basis width class, dW1 at each hidden width class) and the
// fixed-order sums of their split partials: a source of its own so that the
// instantiations compile in parallel with the rest of #7
// (basis_mlp_bwd_sm90.cu).
//
// Replaces part of pallas_basis.py:_multi_bwd (body :289); the bound and the
// design are basis_f32_sm90.cuh's.

#include "basis_f32_sm90.cuh"

namespace {

using namespace basis32;

// the weight gradient [M, N] (M = H + 1 or F + 1 with the bias row) of
// f32_dw_kernel<NW, BUILT>: the split partials, then their sum in split order
template <int NW, bool BUILT>
int launch_dw(const F32Bwd& a, float* out, int M, int N, int stages, int smem,
              const BasisPlan& p, cudaStream_t stream) {
    static SmemLimit limit;
    cudaError_t err = limit.check(f32_dw_kernel<NW, BUILT>, 1024 + (size_t)stages * row_slot(NW),
                                  smem, stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    f32_dw_kernel<NW, BUILT><<<dim3(cdiv(M, TILE), p.splits), BLOCK_THREADS, smem, stream>>>(
        a, p.per_split, stages);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)M * N;
    sum_splits_kernel<<<sum_splits_blocks(n), arreau::THREADS, 0, stream>>>(a.partial, out,
                                                                           p.splits, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

int arreau::f32_dw2(const F32Bwd& a, float* dw2_ext, const BasisPlan& p, cudaStream_t stream) {
    if (!f32_plan_fits(p, a.F, a.H, a.D)) return static_cast<int>(cudaErrorInvalidValue);
    const int M = a.H + 1, st = p.d_stages, sm = p.d_smem;
    switch (p.nd) {
        case 128: return launch_dw<128, false>(a, dw2_ext, M, a.D, st, sm, p, stream);
        case 256: return launch_dw<256, false>(a, dw2_ext, M, a.D, st, sm, p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int arreau::f32_dw1(const F32Bwd& a, float* dw1_ext, const BasisPlan& p, cudaStream_t stream) {
    if (!f32_plan_fits(p, a.F, a.H, a.D)) return static_cast<int>(cudaErrorInvalidValue);
    const int M = a.F + 1, st = p.h_stages, sm = p.h_smem;
    switch (p.nh) {
        case 64: return launch_dw<64, true>(a, dw1_ext, M, a.H, st, sm, p, stream);
        case 128: return launch_dw<128, true>(a, dw1_ext, M, a.H, st, sm, p, stream);
        case 208: return launch_dw<208, true>(a, dw1_ext, M, a.H, st, sm, p, stream);
        case 256: return launch_dw<256, true>(a, dw1_ext, M, a.H, st, sm, p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
