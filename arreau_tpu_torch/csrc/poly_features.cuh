// Degree <= 3 tensor-power features of an edge's d invariants, one at a time,
// in the order of polynomial_features (arreau_tpu/models/blocks.py:70):
// [x, x (x) x, x (x) x (x) x], F = d + d^2 + d^3 features for degree 3.
#pragma once

#include <utility>

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

// Feature f as the invariants it multiplies, decoded once where a thread
// forms feature f for many edges: x_a (deg 1), x_a * x_b (deg 2) or
// (x_a * x_b) * x_c (deg 3), the products of poly_feature in its order.
struct PolyTerm {
    int a, b, c, deg;
};

__device__ __forceinline__ PolyTerm poly_term(int f, int d) {
    if (f < d) return {f, 0, 0, 1};
    f -= d;
    if (f < d * d) return {f / d, f % d, 0, 2};
    f -= d * d;
    return {f / (d * d), (f / d) % d, f % d, 3};
}

template <class Invariant>
__device__ __forceinline__ float poly_value(const PolyTerm& t, Invariant a) {
    float v = a(t.a);
    if (t.deg > 1) v *= a(t.b);
    if (t.deg > 2) v *= a(t.c);
    return v;
}

// Features [P * W, P * W + W) of one edge from its D invariants x, D and
// the part P known at compile time, so that every factor is a register:
// feature f < F as poly_feature forms it, f == F the value one (a bias
// column), beyond that 0.
template <int D, int W, int P>
__device__ __forceinline__ void poly_features_part(const float (&x)[D], int F, float one,
                                                   float (&v)[W]) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int f = P * W + j;
        float val = 0.f;
        if (f < D) {
            val = x[f];
        } else if (f < D + D * D) {
            val = x[(f - D) / D] * x[(f - D) % D];
        } else if (f < D + D * D + D * D * D) {
            const int g = f - D - D * D;
            val = x[g / (D * D)] * x[(g / D) % D] * x[g % D];
        }
        v[j] = f < F ? val : f == F ? one : 0.f;
    }
}

template <class Fn, int... P>
__device__ __forceinline__ void with_part(int part, Fn& fn, std::integer_sequence<int, P...>) {
    ((part == P ? fn(std::integral_constant<int, P>{}) : void()), ...);
}
// fn(std::integral_constant<int, P>{}) for the P in [0, N) that equals part
template <int N, class Fn>
__device__ __forceinline__ void with_part(int part, Fn fn) {
    with_part(part, fn, std::make_integer_sequence<int, N>{});
}

}  // namespace arreau
