// JAX's random draws on the card: threefry2x32 bits, uniforms and normals
// as jax.random computes them (jax_threefry_partitionable on), for K keys
// at once. It replaces no Pallas kernel: the JAX package draws through
// XLA's threefry. The port draws the sampler's and the loss's noise here so
// that one seed gives the JAX package's numbers (kernels/threefry.py).
//
// out[k, i] for key k < K and flat index i < n: the threefry2x32 hash of
// the counter pair (i >> 32, i & 0xFFFFFFFF) under keys[k] (20 rounds, a key
// injection after every four), its two words XORed into 32 random bits;
// then, by mode,
//   0  the bits (uint32);
//   1  a uniform on [lo, hi): the top mantissa bits under 1.0's exponent,
//      minus 1, times (hi - lo) plus lo in one fused multiply-add, clamped
//      below at lo (float32); bfloat16 takes the low 8 bits and rounds every
//      operation to bfloat16;
//   2  a standard normal sqrt(2) erfinv(u), u uniform on
//      [nextafter(-1, 0), 1), with XLA's erf_inv (its log1p and float32 log
//      copied) in float32; bfloat16 rounds erfinv(u), then the product.
// The arithmetic is ops/prng.py's, operation for operation: every fused
// multiply-add is __fmaf_rn and every other operation an explicitly rounded
// intrinsic, so nvcc contracts nothing. Bits and uniforms equal prng.py's
// bit for bit; normals are held within 3 ulp of them, as prng.py's are of
// JAX's (tests/test_torch_cuda.py).
//
// On the H100 its operations bound it, not its output write (4 bytes or 2
// an element): the hash takes 74 32-bit operations an element, 42 of them
// shifts and logic that only the INT32 lanes run (chip_smoke.py,
// THREEFRY_OPS). One thread an element, consecutive threads on consecutive
// outputs, so the stores coalesce; the keys are read through the cache.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int group = 0; group < 5; ++group) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[group % 2][j]) ^ x0;
        }
        x0 += ks[(group + 1) % 3];
        x1 += ks[(group + 2) % 3] + static_cast<uint32_t>(group + 1);
    }
    return x0 ^ x1;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float w) {
    float p = c[0];
#pragma unroll
    for (int i = 1; i < N; ++i) p = fma_(p, w, c[i]);
    return p;
}

// XLA's float32 log of a positive normal x (prng.py:_log_f32)
__device__ float log_f32(float x) {
    const int bits = __float_as_int(x);
    const float m = __int_as_float((bits & ~0x7F800000) | __float_as_int(0.5f));
    float e = add(1.f, static_cast<float>((bits >> 23) - 0x7F));
    const bool low = m < 0.707106781186547524f;
    float t = add(sub(m, 1.f), low ? m : 0.f);
    e = sub(e, low ? 1.f : 0.f);
    const float x2 = mul(t, t);
    const float x3 = mul(x2, t);
    float y = fma_(fma_(t, 7.0376836292e-2f, -1.1514610310e-1f), t, 1.1676998740e-1f);
    const float y1 = fma_(fma_(t, -1.2420140846e-1f, 1.4249322787e-1f), t, -1.6668057665e-1f);
    const float y2 = fma_(fma_(t, 2.0000714765e-1f, -2.4999993993e-1f), t, 3.3333331174e-1f);
    y = mul(fma_(fma_(y, x3, y1), x3, y2), x3);
    y = add(y, mul(-2.12194440e-4f, e));
    t = sub(t, mul(0.5f, x2));
    return add(add(t, y), mul(0.693359375f, e));
}

// XLA's float32 log1p of x in (-1, 0] (prng.py:_log1p)
__device__ float log1p_f32(float x) {
    const float num[7] = {4.5270000862445199635e-5f, 4.9854102823193375972e-1f,
                          6.5787325942061044846e0f,  2.9911919328553073277e1f,
                          6.0949667980987787057e1f,  5.7112963590585538103e1f,
                          2.0039553499201281259e1f};
    const float den[7] = {1.0f,
                          1.5062909083469192198e1f,
                          8.3047565967967209469e1f,
                          2.2176239823732856465e2f,
                          3.0909872225312059774e2f,
                          2.1642788614495947685e2f,
                          6.0118660497603843919e1f};
    if (fabsf(x) < 0.41421356237309504880f) {
        const float x2 = mul(x, x);
        const float r = __fdiv_rn(horner(num, x), horner(den, x));
        return add(x, add(mul(-0.5f, x2), mul(mul(x, x2), r)));
    }
    return log_f32(fmaxf(add(x, 1.f), 1e-30f));
}

// XLA's float32 erf_inv (prng.py:erfinv)
__device__ float erfinv_f32(float x) {
    const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                          -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                          -0.00417768164f, 0.246640727f,     1.50140941f};
    const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                          -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                          0.00943887047f,   1.00167406f,     2.83297682f};
    if (fabsf(x) == 1.f) return mul(x, __int_as_float(0x7F800000));
    const float w = -log1p_f32(mul(x, -x));
    const float p = w < 5.f ? horner(lt5, sub(w, 2.5f)) : horner(ge5, sub(__fsqrt_rn(w), 3.f));
    return mul(p, x);
}

// the uniform of 32 random bits on [lo, hi) in float32 (prng.py:uniform)
__device__ __forceinline__ float uniform_f32(uint32_t bits, float lo, float span) {
    const float f = sub(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
    return fmaxf(lo, fma_(f, span, lo));
}

// the same in bfloat16 from the low 8 bits, every operation rounded
__device__ __forceinline__ float uniform_bf16(uint32_t bits, float lo, float span) {
    const float f = __uint_as_float((((bits & 0xFFu) >> 1) | 0x3F80u) << 16) - 1.f;  // exact
    return fmaxf(lo, bf16_round(add(bf16_round(mul(f, span)), lo)));
}

constexpr float SQRT2 = 1.41421356237309504880f;
constexpr float SQRT2_BF16 = 1.4140625f;  // sqrt(2) rounded to bfloat16
constexpr float NORMAL_LO = -0.99999994f;  // nextafter(-1, 0) in float32
constexpr float NORMAL_LO_BF16 = -0.99609375f;  // ... in bfloat16

template <int MODE, bool BF16>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(const uint32_t* __restrict__ keys, long long n, long long total, float lo,
                float span, void* __restrict__ out) {
    for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
         e += (long long)gridDim.x * THREADS) {
        const long long k = e / n;
        const unsigned long long i = static_cast<unsigned long long>(e - k * n);
        const uint32_t bits = threefry_bits(__ldg(keys + 2 * k), __ldg(keys + 2 * k + 1),
                                            static_cast<uint32_t>(i >> 32),
                                            static_cast<uint32_t>(i & 0xFFFFFFFFull));
        if constexpr (MODE == 0) {
            static_cast<uint32_t*>(out)[e] = bits;
        } else {
            float v;
            if constexpr (MODE == 1) {
                v = BF16 ? uniform_bf16(bits, lo, span) : uniform_f32(bits, lo, span);
            } else if constexpr (BF16) {
                const float u = uniform_bf16(bits, NORMAL_LO_BF16, bf16_round(1.f - NORMAL_LO_BF16));
                v = bf16_round(mul(bf16_round(erfinv_f32(u)), SQRT2_BF16));
            } else {
                const float u = uniform_f32(bits, NORMAL_LO, sub(1.f, NORMAL_LO));
                v = mul(SQRT2, erfinv_f32(u));
            }
            if constexpr (BF16)
                static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(v);  // exact
            else
                static_cast<float*>(out)[e] = v;
        }
    }
}

template <int MODE, bool BF16>
int launch(const uint32_t* keys, long long n, long long total, float lo, float span, void* out,
           cudaStream_t stream) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(blocks < 132LL * 64 ? blocks : 132LL * 64);
    threefry_kernel<MODE, BF16><<<grid, THREADS, 0, stream>>>(keys, n, total, lo, span, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: uint32 [K, 2]; out: [K, n] uint32 (mode 0), float32 or bfloat16
// (is_bf16). lo and span: the uniform's lower bound and maxval - minval
// (mode 1), both already rounded to the draw's type by the wrapper.
extern "C" int arreau_threefry(const void* keys, long long K, long long n, int mode, int is_bf16,
                               float lo, float span, void* out, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const uint32_t* k = static_cast<const uint32_t*>(keys);
    const long long total = K * n;
    if (total == 0) return 0;
    if (mode == 0) return launch<0, false>(k, n, total, lo, span, out, stream);
    if (mode == 1)
        return is_bf16 ? launch<1, true>(k, n, total, lo, span, out, stream)
                       : launch<1, false>(k, n, total, lo, span, out, stream);
    return is_bf16 ? launch<2, true>(k, n, total, lo, span, out, stream)
                   : launch<2, false>(k, n, total, lo, span, out, stream);
}
