// #8's float32 kernel (basis_f32_sm90.cuh: f32_h1_kernel, every hidden width
// class), which is also #7's first float32 pass: a source of its own so that
// its instantiations compile in parallel with the rest of the port.
//
// Replaces pallas_basis.py:_h1_fwd (body :397); the bound and the design are
// basis_f32_sm90.cuh's.

#include "basis_f32_sm90.cuh"

namespace {

using namespace basis32;

template <int NH>
int launch_h1(const float* attrT, const float* b1, float* out, long long ld, long long rows, int d,
              int E, int F, int H, const CUtensorMap& w_map, const BasisPlan& p,
              cudaStream_t stream) {
    static SmemLimit limit;
    cudaError_t err = limit.check(f32_h1_kernel<NH>, 1024 + (size_t)p.h_stages * row_slot(NH),
                                  p.h_smem, p.h_stages);
    if (err != cudaSuccess) return static_cast<int>(err);
    f32_h1_kernel<NH><<<persistent_blocks(cdiv(rows, TILE)), BLOCK_THREADS, p.h_smem, stream>>>(
        attrT, b1, out, ld, rows, d, E, F, H, p.kw1 / FK, p.h_stages, w_map);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

int arreau::f32_h1(const float* attrT, const float* b1, float* out, long long ld, long long rows,
                   int d, int E, int F, int H, const CUtensorMap& w1_map, const BasisPlan& p,
                   cudaStream_t stream) {
    if (!f32_plan_fits(p, F, H, 0) || d < 1 || d > MAX_D)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (p.nh) {
        case 64: return launch_h1<64>(attrT, b1, out, ld, rows, d, E, F, H, w1_map, p, stream);
        case 128: return launch_h1<128>(attrT, b1, out, ld, rows, d, E, F, H, w1_map, p, stream);
        case 208: return launch_h1<208>(attrT, b1, out, ld, rows, d, E, F, H, w1_map, p, stream);
        case 256: return launch_h1<256>(attrT, b1, out, ld, rows, d, E, F, H, w1_map, p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
