// #7's float32 row passes 2 and 3 (basis_f32_sm90.cuh: f32_rows_kernel,
// dpre2 at each basis width class with its cotangent pass
// dpre2_scale_kernel, dpre1 at each hidden width class): a
// source of its own so that the instantiations compile in parallel with the
// rest of #7 (basis_mlp_bwd_sm90.cu).
//
// Replaces part of pallas_basis.py:_multi_bwd (body :289); the bound and the
// design are basis_f32_sm90.cuh's.

#include "basis_f32_sm90.cuh"

namespace {

using namespace basis32;

template <Pass PASS, int N>
int launch_rows(const F32Bwd& a, const CUtensorMap& a_map, const CUtensorMap& w_map, int kp,
                int stages, int smem, cudaStream_t stream) {
    static SmemLimit limit;
    cudaError_t err = limit.check(f32_rows_kernel<PASS, N>, 1024 + (size_t)stages * row_slot(N),
                                  smem, stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    f32_rows_kernel<PASS, N><<<persistent_blocks(cdiv(a.rows, TILE)), BLOCK_THREADS, smem,
                               stream>>>(a, kp, stages, a_map, w_map);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

int arreau::f32_dpre2(const F32Bwd& a, const CUtensorMap& w2t_map, const BasisPlan& p,
                      cudaStream_t stream) {
    CUtensorMap am{};
    if (!f32_plan_fits(p, a.F, a.H, a.D) ||
        !sw128_map<float>(&am, a.h1pre, a.H, a.rows, 4LL * a.hp, ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    const int kp = p.kw2 / FK, st = p.d_stages, sm = p.d_smem;
    const int status = p.nd == 128   ? launch_rows<Pass::DPRE2, 128>(a, am, w2t_map, kp, st, sm, stream)
                       : p.nd == 256 ? launch_rows<Pass::DPRE2, 256>(a, am, w2t_map, kp, st, sm, stream)
                                     : static_cast<int>(cudaErrorInvalidValue);
    if (status != 0) return status;
    bool vec = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.dpre2) % 16 == 0;
    for (int u = 0; u < a.n_g; ++u) vec &= reinterpret_cast<uintptr_t>(a.g[u]) % 16 == 0;
    const long long n = a.rows * (vec ? a.D / 4 : a.D);
    const int blocks = cdiv(n, arreau::THREADS);  // a grid-stride loop past 16 blocks an SM
    dpre2_scale_kernel<<<blocks < 16 * sm_count() ? blocks : 16 * sm_count(), arreau::THREADS, 0,
                         stream>>>(a, vec);
    return static_cast<int>(cudaGetLastError());
}

int arreau::f32_dpre1(const F32Bwd& a, const CUtensorMap& w2c_map, const BasisPlan& p,
                      cudaStream_t stream) {
    CUtensorMap am{};
    if (!f32_plan_fits(p, a.F, a.H, a.D) ||
        !sw128_map<float>(&am, a.dpre2, a.D, a.rows, 4LL * a.dp, ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    const int kp = p.kw3 / FK, st = p.h_stages, sm = p.h_smem;
    switch (p.nh) {
        case 64: return launch_rows<Pass::DPRE1, 64>(a, am, w2c_map, kp, st, sm, stream);
        case 128: return launch_rows<Pass::DPRE1, 128>(a, am, w2c_map, kp, st, sm, stream);
        case 208: return launch_rows<Pass::DPRE1, 208>(a, am, w2c_map, kp, st, sm, stream);
        case 256: return launch_rows<Pass::DPRE1, 256>(a, am, w2c_map, kp, st, sm, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
