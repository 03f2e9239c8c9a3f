// Degree <= 3 tensor-power features of an edge's d invariants, one at a time,
// in the order of polynomial_features (arreau_tpu/models/blocks.py:70):
// [x, x (x) x, x (x) x (x) x], F = d + d^2 + d^3 features for degree 3.
#pragma once

namespace arreau {

constexpr int MAX_D = 8;  // invariants per edge the kernels stage

// Feature f of the invariants x_i = a(i), i < d.
template <class Invariant>
__device__ __forceinline__ float poly_feature(Invariant a, int f, int d) {
    if (f < d) return a(f);
    f -= d;
    if (f < d * d) return a(f / d) * a(f % d);
    f -= d * d;  // f = (i*d + j)*d + k  ->  (x_i * x_j) * x_k
    return a(f / (d * d)) * a((f / d) % d) * a(f % d);
}

}  // namespace arreau
