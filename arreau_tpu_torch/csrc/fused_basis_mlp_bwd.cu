// Fused bias-free edge-basis MLP, backward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_bwd_kernel (called
// by _bwd, the VJP of fused_basis_mlp). With the forward of
// fused_basis_mlp.cu and g the cotangent of the basis, for every edge row
// (the steps of pallas_basis.py:119-143):
//
//   h_pre  = round_T(poly @ W1),        h = round_T(gelu(h_pre))
//   b_pre  = round_T(h @ W2)
//   db_pre = round_T(round_T(g) * round_T(gelu'(b_pre)))
//   dW2   += h^T db_pre
//   dh     = round_T(db_pre @ W2^T)
//   dh_pre = round_T(dh * round_T(gelu'(h_pre)))
//   dW1   += poly^T dh_pre
//
// The attribute cotangent is not computed: attributes derive from positions
// and the lattice, which the training path does not differentiate (the JAX
// VJP returns zeros for it, and so does the port's autograd Function).
//
// Bound on the H100: 2*rows*(2*F*H + 3*H*D) operations (the recomputed
// forward, dW2, dh and dW1: 269 GFLOP at the training shape, rows = 524288,
// F=258, H=200, D=256) against the cotangent read (268 MB bfloat16, 537 MB
// float32): arithmetic bounds it, 0.27 ms on the bfloat16 tensor cores (989
// TFLOP/s), 1.63 ms in float32 as 3xTF32 (mma.cuh, 495 / 3 = 165 TFLOP/s).
//
// Design. The TPU kernel carried per-b' weight-gradient partials across the
// sequential o axis in VMEM. Hopper's blocks run in no order, so this is
// a chain of five mma.sync tile products (basis_mlp_bwd.cuh) through
// device-memory scratch in T, each product's epilogue doing the elementwise
// work, the features built in shared memory from the invariants and never
// stored, the weight gradients as split-K products whose per-split float32
// partials a second pass adds in split order (no atomics: every output the
// same bit for bit on every call). It differs from #7 in no biases (no ones
// columns, no bias rows), one cotangent, the row-major attr [B'*O*E, d] and
// dh rounded to T before its product with gelu'(h_pre). The forward is
// recomputed, as the JAX VJP does (its residuals are its inputs): h_pre's
// product is 54 of the 269 GFLOP, against 0.2 (bfloat16) or 0.4 GB
// (float32) of h_pre held from forward to backward.
//
// Element type T (dtype.cuh) of attr, W1, W2, g and the scratch: float32, or
// bfloat16 under BasisMLP's bfloat16 compute type, with the rounding points
// above (pallas_basis.py:129-143); GELU and its derivative are evaluated in
// float32 from the rounded value and rounded once (the JAX kernel evaluates
// them in T step by step); every product sums in float32 and the weight
// gradients are float32 sums.

#include "basis_mlp_bwd.cuh"

// dw1 [F, H] and dw2 [H, D] (float32). Scratch: h1 and dg1 [rows, Hg] (Hg =
// H rounded up to 8; h1 ends as dh_pre), dpre2 [rows, D] (db_pre), xr
// [rows, 8], partial [splits * max(F*H, H*D)] float32. attr [B', O, E, d],
// w1, w2, g [B', O, E, D] and the scratch but partial are float32 (is_bf16
// = 0) or bfloat16 (is_bf16 = 1).
extern "C" int arreau_fused_basis_mlp_bwd(const void* attr, const void* w1, const void* w2,
                                          const void* g, void* h1, void* dg1, void* dpre2,
                                          void* xr, float* partial, float* dw1, float* dw2,
                                          int Bp, int O, int E, int d, int F, int H, int D,
                                          int splits, int rows_per_split, int is_bf16,
                                          void* stream_ptr) {
    if (d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int Hg = (H + 7) / 8 * 8;
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = basis_mlp_bwd<T>(
            static_cast<const T*>(attr), static_cast<const T*>(w1), static_cast<const T*>(w2),
            static_cast<const T*>(g), static_cast<T*>(h1), static_cast<T*>(dg1),
            static_cast<T*>(dpre2), static_cast<T*>(xr), partial, dw1, dw2, (long long)Bp * O * E,
            d, F, H, D, Hg, splits, rows_per_split, stream);
    });
    return status;
}
