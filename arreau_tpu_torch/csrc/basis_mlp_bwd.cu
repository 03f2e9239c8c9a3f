// Edge-basis MLP, backward of all its consumers at once, float32, for sm_90a
// (#7's bfloat16 instantiation: basis_mlp_bwd_sm90.cu, on wgmma and TMA).
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
// the lattice, which the training path does not differentiate.
//
// Bound on the H100: five products of 2*rows*(2*F*H + 3*H*D) operations
// (269 GFLOP at the training shape, rows = B'*O*E = 524288, F=258, H=200,
// D=256) against ~1.4 GB (bfloat16) or ~2.7 GB (float32) of cotangent
// reads. On the bfloat16 tensor cores (989 TFLOP/s) the cotangent reads
// bound it; in float32 the products run as 3xTF32 (mma.cuh, 495 / 3 = 165
// TFLOP/s) and the operations bound it. On the TPU one grid step held a
// (b', o) block's whole chain in VMEM and carried the four weight gradients
// across the sequential grid. A Hopper block has no such room and blocks run
// in no order, so the chain runs as five mma.sync tile products
// (tile_product.cuh: cp.async stages, 128 x 128 tiles; 96 x 128 for dW1)
// through device-memory scratch, each product's epilogue doing the
// elementwise work, in order (basis_mlp_bwd.cuh, which #6 shares):
//
//   1. h1_pre = poly @ W1 + b1, #8's product (basis_h1.cuh), the features
//      built in shared memory. Its epilogue writes h1 = round(gelu(h1_pre))
//      with a ones column (for db2) into a scratch [rows, Hg] (Hg = H + 1
//      rounded up to 8: rows stay 16-byte aligned), round(gelu'(h1_pre))
//      into a second, and the rows' invariants into a [rows, 8] scratch.
//   2. dpre2 = h1 @ W2 (K = H); the epilogue adds b2, rounds, takes gelu',
//      and multiplies by the n_g cotangents, each read once, several loads
//      in flight at a time, and summed in order in registers (their sum is
//      never stored).
//   3. dW2|db2 = [h1 | 1]^T dpre2 (M = H + 1), split-K over the rows.
//   4. dpre1 = dpre2 @ W2^T (K = D) times gelu'(h1_pre), written over h1
//      (which step 3 has read by then).
//   5. dW1|db1 = [poly | 1]^T dpre1 (M = F + 1), split-K, the features
//      built into each stage from the stage's rows of invariants (fetched by
//      cp.async a stage ahead); poly never reaches memory.
//   The products' epilogues stage the accumulators in shared memory and
//   read and write device memory in 16-byte row chunks. Each split-K product
//   writes per-split float32 partial tiles, and a second pass adds them in a
//   fixed order: every output is the same bit for bit on every call (no
//   atomics). h1 is recomputed rather than saved by the forward: 54 GFLOP on
//   the tensor cores against 0.2 (bfloat16) or 0.4 GB (float32) of residual
//   held from forward to backward. With the model's six invariants (d = 6)
//   the features are formed from registers (poly_features_part); any other
//   d takes a slower builder that decodes each feature's factors.

// The JAX kernel's rounding points (pallas_basis.py:289-331), T its compute
// type, which the bfloat16 kernels keep (#7's in basis_sm90.cuh, #6's through
// basis_mlp_bwd.cuh):
// h1_pre and h2_pre are rounded to T, as are gelu(h1_pre), gelu'(h1_pre) and
// gelu'(h2_pre) (the JAX kernel evaluates them in T); the cotangents are
// summed in float32; dpre2 and dpre1 are rounded to T before their products;
// every product sums in float32 and the weight and bias gradients are
// float32 sums.

#include "basis_mlp_bwd.cuh"

// dw1_ext [F+1, H] = [dW1; db1], dw2_ext [H+1, D] = [dW2; db2] (float32).
// Scratch: h1 and dg1 [rows, Hg] (Hg = H + 1 rounded up to 8; h1 ends as
// dpre1), dpre2 [rows, D], xr [rows, 8], partial [splits * max((F+1)*H,
// (H+1)*D)] float32. gs is a host array of n_g device pointers. attrT, the
// weights, biases, cotangents and the scratch are float32.
extern "C" int arreau_basis_mlp_bwd(const float* attrT, const float* w1, const float* b1,
                                    const float* w2, const float* b2, const void* const* gs,
                                    int n_g, float* h1, float* dg1, float* dpre2, float* xr,
                                    float* partial, float* dw1_ext, float* dw2_ext, int Bp, int O,
                                    int d, int E, int F, int H, int D, int splits,
                                    int rows_per_split, void* stream_ptr) {
    if (n_g < 1 || n_g > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
    return basis_mlp_bwd<float, false>(attrT, w1, b1, w2, b2, gs, n_g, h1, dg1, dpre2, xr,
                                       partial, dw1_ext, dw2_ext, Bp, O, d, E, F, H, D,
                                       (H + 1 + 7) / 8 * 8, splits, rows_per_split,
                                       static_cast<cudaStream_t>(stream_ptr));
}
