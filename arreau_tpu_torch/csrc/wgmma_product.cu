// The card test of wgmma.cuh's products, descriptors and TMA loads:
//
//   d [M, N] float32 = a [M, K] @ b [N, K]^T
//
// a and b contiguous and K-major (the only operand layout the port's wgmma
// kernels use), one warpgroup a 64-row block tile with all N columns in one
// accumulator (N <= NB, NB in 64, 128, 208, 256: the widths of
// basis_sm90.cuh), K in SW128 panels staged either by the block's threads
// (bfloat16, or float32 split into tf32 big and small panels for 3xTF32,
// acc += a_small b_big + a_big b_small + a_big b_big as mma.cuh) or, for
// bfloat16 with rows of 16-byte multiples, by TMA through tensor maps of a
// and b. The card tests hold it against a float64 product.

#include "wgmma.cuh"

namespace {

using namespace arreau;

constexpr int ROWS = 64;

// rows [r0, r0 + ROWS_) x K-panel k0 of src [R, K] into the panel at s (and
// for float32 its small half PANEL bytes further), zero outside
template <class T, int ROWS_>
__device__ void stage(unsigned char* s, const T* src, int R, int K, int r0, int k0) {
    constexpr int PER = 128 / sizeof(T), HALF = ROWS_ * 128;
    for (int e = threadIdx.x; e < ROWS_ * PER; e += 128) {
        const int r = e / PER, k = e % PER;
        const float v = r0 + r < R && k0 + k < K ? to_float(src[(long long)(r0 + r) * K + k0 + k]) : 0.f;
        const int off = sw128_offset<T>(r, k, ROWS_);
        if constexpr (sizeof(T) == 4) {
            uint32_t big, small;
            split_tf32(v, big, small);
            *reinterpret_cast<uint32_t*>(s + off) = big;
            *reinterpret_cast<uint32_t*>(s + HALF + off) = small;
        } else {
            *reinterpret_cast<T*>(s + off) = from_float<T>(v);
        }
    }
}

template <class T, int NB, bool TMA>
__global__ void __launch_bounds__(128)
wgmma_product_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ d,
                     int M, int N, int K, const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map) {
    using W = Wgmma<T, NB>;
    constexpr int PER = 128 / sizeof(T), HALVES = sizeof(T) == 4 ? 2 : 1;
    constexpr int A_BYTES = ROWS * 128, B_BYTES = NB * 128;
    __shared__ uint64_t bar;
    unsigned char* sa = aligned_smem();
    unsigned char* sb = sa + HALVES * A_BYTES;
    const int m0 = blockIdx.x * ROWS;
    if (TMA && threadIdx.x == 0) {
        mbar_init(&bar, 1);
        mbar_fence_init();
    }
    __syncthreads();
    float acc[NB / 2] = {};
    unsigned phase = 0;
    for (int k0 = 0; k0 < K; k0 += PER) {
        if constexpr (TMA) {
            if (threadIdx.x == 0) {
                mbar_arrive_expect_tx(&bar, A_BYTES + B_BYTES);
                tma_load_2d(sa, &a_map, &bar, k0, m0);
                tma_load_2d(sb, &b_map, &bar, k0, 0);
            }
            mbar_wait(&bar, phase);
            phase ^= 1;
        } else {
            stage<T, ROWS>(sa, a, M, K, m0, k0);
            stage<T, NB>(sb, b, N, K, 0, k0);
            fence_proxy_async();
            __syncthreads();
        }
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < PER; kk += W::K) {
            const int off = kk * sizeof(T);
            if constexpr (sizeof(T) == 4) {
                W::mma(acc, sw128_desc(sa + A_BYTES + off), sw128_desc(sb + off));
                W::mma(acc, sw128_desc(sa + off), sw128_desc(sb + B_BYTES + off));
            }
            W::mma(acc, sw128_desc(sa + off), sw128_desc(sb + off));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        __syncthreads();  // every warp is done with the panels
    }
    wgmma_for_each<NB>(acc, [&](int, int m, int n, float v0, float v1) {
        if (m0 + m >= M) return;
        if (n < N) d[(long long)(m0 + m) * N + n] = v0;
        if (n + 1 < N) d[(long long)(m0 + m) * N + n + 1] = v1;
    });
}

template <class T, int NB, bool TMA>
int launch(const T* a, const T* b, float* d, int M, int N, int K, cudaStream_t stream) {
    CUtensorMap a_map{}, b_map{};
    if (TMA && (!sw128_map<T>(&a_map, a, K, M, (long long)K * sizeof(T), ROWS) ||
                !sw128_map<T>(&b_map, b, K, N, (long long)K * sizeof(T), NB)))
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = 1024 + (sizeof(T) == 4 ? 2 : 1) * (ROWS + NB) * 128;
    cudaError_t err = cudaFuncSetAttribute(wgmma_product_kernel<T, NB, TMA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgmma_product_kernel<T, NB, TMA><<<(M + ROWS - 1) / ROWS, 128, smem, stream>>>(
        a, b, d, M, N, K, a_map, b_map);
    return static_cast<int>(cudaGetLastError());
}

template <class T, bool TMA>
int launch_nb(const T* a, const T* b, float* d, int M, int N, int K, cudaStream_t stream) {
    if (N <= 64) return launch<T, 64, TMA>(a, b, d, M, N, K, stream);
    if (N <= 128) return launch<T, 128, TMA>(a, b, d, M, N, K, stream);
    if (N <= 208) return launch<T, 208, TMA>(a, b, d, M, N, K, stream);
    if (N <= 256) return launch<T, 256, TMA>(a, b, d, M, N, K, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// d rows of the slab layout or of the MN-major operands (see the header),
// one warpgroup a 64-row tile, K in 64-element panels
template <int NB, bool MN>
__global__ void __launch_bounds__(128)
wgmma_layout_kernel(float* __restrict__ d, int M, int N, int K, int slab,
                    const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map) {
    constexpr int PANEL = ROWS * 128, NBOX = (NB + 63) / 64;
    constexpr unsigned B_BYTES = MN ? NBOX * PANEL : NB * 128;
    __shared__ uint64_t bar;
    unsigned char* sa = aligned_smem();
    unsigned char* sb = sa + PANEL;
    const int tiles = (slab + ROWS - 1) / ROWS;
    const int z = MN ? 0 : blockIdx.x / tiles;
    const int r0 = MN ? blockIdx.x * ROWS : blockIdx.x % tiles * ROWS;  // m0, or t0 in the slab
    if (threadIdx.x == 0) {
        mbar_init(&bar, 1);
        mbar_fence_init();
    }
    __syncthreads();
    float acc[NB / 2] = {};
    unsigned phase = 0;
    for (int k0 = 0; k0 < K; k0 += 64) {
        if (threadIdx.x == 0) {
            mbar_arrive_expect_tx(&bar, PANEL + B_BYTES);
            if constexpr (MN) {
                tma_load_2d(sa, &a_map, &bar, r0, k0);
                for (int j = 0; j < NBOX; ++j) tma_load_2d(sb + j * PANEL, &b_map, &bar, 64 * j, k0);
            } else {
                tma_load_3d(sa, &a_map, &bar, k0, r0, z);
                tma_load_2d(sb, &b_map, &bar, k0, 0);
            }
        }
        mbar_wait(&bar, phase);
        phase ^= 1;
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            if constexpr (MN)
                Wgmma<bf16, NB>::mma_mn(acc, sw128_mn_desc(sa + 2048 * kk, PANEL),
                                        sw128_mn_desc(sb + 2048 * kk, PANEL));
            else
                Wgmma<bf16, NB>::mma(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        __syncthreads();  // every warp is done with the panels
    }
    wgmma_for_each<NB>(acc, [&](int, int m, int n, float v0, float v1) {
        long long row;
        if constexpr (MN) {
            if (r0 + m >= M) return;
            row = r0 + m;
        } else {
            if (r0 + m >= slab) return;
            row = (long long)z * slab + r0 + m;
        }
        if (n < N) d[row * N + n] = v0;
        if (n + 1 < N) d[row * N + n + 1] = v1;
    });
}

template <int NB, bool MN>
int launch_layout(const bf16* a, const bf16* b, float* d, int M, int N, int K, int slab,
                  cudaStream_t stream) {
    CUtensorMap a_map{}, b_map{};
    const bool ok = MN ? sw128_map<bf16>(&a_map, a, M, K, 2LL * M, ROWS) &&
                             sw128_map<bf16>(&b_map, b, N, K, 2LL * N, ROWS)
                       : sw128_map_3d<bf16>(&a_map, a, K, slab, M / slab, 2LL * K,
                                            2LL * K * slab, ROWS) &&
                             sw128_map<bf16>(&b_map, b, K, N, 2LL * K, NB);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = 1024 + ROWS * 128 + (MN ? (NB + 63) / 64 * ROWS * 128 : NB * 128);
    cudaError_t err = cudaFuncSetAttribute(wgmma_layout_kernel<NB, MN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = MN ? (M + ROWS - 1) / ROWS : M / slab * ((slab + ROWS - 1) / ROWS);
    wgmma_layout_kernel<NB, MN><<<blocks, 128, smem, stream>>>(d, M, N, K, slab, a_map, b_map);
    return static_cast<int>(cudaGetLastError());
}

template <bool MN>
int launch_layout_nb(const bf16* a, const bf16* b, float* d, int M, int N, int K, int slab,
                     cudaStream_t stream) {
    if (N <= 64) return launch_layout<64, MN>(a, b, d, M, N, K, slab, stream);
    if (N <= 128) return launch_layout<128, MN>(a, b, d, M, N, K, slab, stream);
    if (N <= 208) return launch_layout<208, MN>(a, b, d, M, N, K, slab, stream);
    if (N <= 256) return launch_layout<256, MN>(a, b, d, M, N, K, slab, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bfloat16, by TMA: d [M, N] float32 = a [M, K] @ b [N, K]^T with A read
// through a 3-D map of slabs of `slab` rows (mn_major = 0; M a multiple of
// slab, K of 8), or d = a^T b for a [K, M] and b [K, N] (mn_major = 1; M and
// N multiples of 8). N <= 256.
extern "C" int arreau_wgmma_product_layout(const void* a, const void* b, float* d, int M, int N,
                                           int K, int slab, int mn_major, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bf16 *ta = static_cast<const bf16*>(a), *tb = static_cast<const bf16*>(b);
    if (mn_major) {
        if (M % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
        return launch_layout_nb<true>(ta, tb, d, M, N, K, slab, stream);
    }
    if (slab < 1 || M % slab || K % 8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_layout_nb<false>(ta, tb, d, M, N, K, slab, stream);
}

// d [M, N] float32 = a [M, K] @ b [N, K]^T, a and b float32 (3xTF32) or
// bfloat16 (is_bf16), contiguous; tma: stage both by TMA (bfloat16, K a
// multiple of 8). N <= 256.
extern "C" int arreau_wgmma_product(const void* a, const void* b, float* d, int M, int N, int K,
                                    int tma, int is_bf16, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (tma && (!is_bf16 || K % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
    if (tma)
        return launch_nb<bf16, true>(static_cast<const bf16*>(a), static_cast<const bf16*>(b), d,
                                     M, N, K, stream);
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = launch_nb<T, false>(static_cast<const T*>(a), static_cast<const T*>(b), d, M, N,
                                     K, stream);
    });
    return status;
}
