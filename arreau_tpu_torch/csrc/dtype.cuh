// The two element types the kernels load and store: float32 and bfloat16.
//
// A value is converted to float as it is staged, every sum is a float32 sum,
// and round_to<T> rounds a float32 value to T and back where the JAX package
// rounds to its compute dtype (round to nearest even, as XLA and PyTorch
// convert). For T = float every helper here is the identity, so a float32
// instantiation compiles to the same arithmetic as an untemplated kernel.
#pragma once

#include <cuda_bf16.h>

namespace arreau {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

template <class T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

}  // namespace arreau

// Calls body<T>() with T = float or bf16 after the C entry point's
// ``is_bf16`` flag (0: float32, 1: bfloat16).
#define ARREAU_DISPATCH_DTYPE(is_bf16, ...)      \
    do {                                         \
        if (is_bf16) {                           \
            using T = arreau::bf16;              \
            __VA_ARGS__                          \
        } else {                                 \
            using T = float;                     \
            __VA_ARGS__                          \
        }                                        \
    } while (0)
