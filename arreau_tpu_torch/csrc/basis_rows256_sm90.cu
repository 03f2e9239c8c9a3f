// #7's rows_kernel (basis_sm90.cuh) at the basis width class ND = 256, every
// hidden width class: a source of its own so that the instantiations compile
// in parallel with the rest of #7 (basis_mlp_bwd_sm90.cu).

#include "basis_sm90.cuh"

int arreau::sm90_rows_nd256(const Sm90Bwd& a, int nh, cudaStream_t stream) {
    return sm90::launch_rows_nh<256>(a, nh, stream);
}
