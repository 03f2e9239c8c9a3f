// Fused bias-free edge-basis MLP, forward, float32 or bfloat16, for sm_90a.
//
// Replaces the TPU kernel arreau_tpu/ops/pallas_basis.py:_fwd_kernel (called
// by _fwd, public entry fused_basis_mlp, reached from BasisMLP(fused=True)).
// For every edge row of attr [B', O, E, d] (rows = B'*O*E):
//
//   h[row, :]     = gelu(round_T(poly(attr[row, :]) @ W1))      W1 [F, H]
//   basis[row, :] = gelu(round_T(h[row, :] @ W2))               W2 [H, D]
//
// where poly is the tensor-power feature vector [x, x(x)x, x(x)x(x)x] of the
// d invariants in the order of polynomial_features
// (arreau_tpu/models/blocks.py:70, the order of pallas_basis.py's one-hot
// selection matrices): F = d + d^2 + d^3 = 258 for d = 6, degree 3.
//
// Bound on the H100: 2*rows*(F*H + H*D) operations (107.8 GFLOP at the
// training shape, rows = 524288, F=258, H=200, D=256) against the output
// write (537 MB float32, 268 MB bfloat16): arithmetic bounds it (1.61 ms at
// the float32 SIMT rate, 0.11 ms at the bf16 tensor-core rate).
//
// Design. On the TPU one grid cell held a (b', o) block's whole chain in
// VMEM. Here a block owns 64 rows and every column of H and D: it stages the
// rows' invariants in shared memory, builds each 16-deep slice of the F
// features in shared memory as the first tile product consumes it (as
// basis_h1.cu does), and keeps the rows' [64, H] hidden activations in
// shared memory (51 KB at H = 200): neither the features nor h reach device
// memory, and the only traffic is the invariants in and the basis out. The
// first product walks H in 64-wide chunks, each chunk's epilogue writing
// round_T(gelu(round_T(acc))) into the hidden buffer; after a barrier the
// second product walks D in 64-wide chunks with A staged from that buffer,
// and each output element is written once.
//
// Element type T (dtype.cuh) of attr, W1, W2 and the output: float32, or
// bfloat16 under BasisMLP's bfloat16 compute type, with the JAX kernel's
// rounding points (pallas_basis.py:77-83, :108-116): each feature is formed
// in float32 from the T invariants and rounded once to T; both products sum
// in float32 and are rounded to T before their GELU; GELU is evaluated in
// float32 from the rounded value and rounded once (the JAX kernel evaluates
// it in T step by step).

#include "dtype.cuh"
#include "poly_features.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace arreau;

template <class T>
__global__ void __launch_bounds__(THREADS)
fused_basis_mlp_fwd_kernel(const T* __restrict__ attr,  // [rows, d]
                           const T* __restrict__ w1,    // [F, H]
                           const T* __restrict__ w2,    // [H, D]
                           T* __restrict__ out,         // [rows, D]
                           long long rows, int d, int F, int H, int D) {
    extern __shared__ float s_h[];  // [BM][H]: the block's hidden activations
    __shared__ float s_attr[MAX_D][BM];
    __shared__ __align__(16) float As[BK][AS_LD];
    __shared__ __align__(16) float Bs[BK][BN];

    const long long row0 = (long long)blockIdx.x * BM;
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    for (int i = tid; i < BM * d; i += THREADS) {
        const int r = i / d, j = i % d;  // neighbouring threads, neighbouring addresses
        s_attr[j][r] = row0 + r < rows ? to_float(attr[(size_t)row0 * d + i]) : 0.f;
    }
    __syncthreads();

    for (int h0 = 0; h0 < H; h0 += BN) {
        float acc[TM][TN] = {};
        tile_gemm<false, true>(
            F,
            [&](int r, int f) {
                return round_to<T>(poly_feature([&](int i) { return s_attr[i][r]; }, f, d));
            },
            [&](int f, int n) { return h0 + n < H ? to_float(w1[(size_t)f * H + h0 + n]) : 0.f; },
            As, Bs, acc);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int h = h0 + tx * TN + j;
                if (h < H) s_h[(ty * TM + i) * H + h] = round_to<T>(gelu(round_to<T>(acc[i][j])));
            }
    }
    __syncthreads();  // every hidden activation is in s_h

    for (int n0 = 0; n0 < D; n0 += BN) {
        float acc[TM][TN] = {};
        tile_gemm<true, true>(
            H, [&](int r, int k) { return s_h[r * H + k]; },
            [&](int k, int n) { return n0 + n < D ? to_float(w2[(size_t)k * D + n0 + n]) : 0.f; },
            As, Bs, acc);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const long long row = row0 + ty * TM + i;
            if (row >= rows) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int n = n0 + tx * TN + j;
                if (n < D) out[(size_t)row * D + n] = from_float<T>(gelu(round_to<T>(acc[i][j])));
            }
        }
    }
}

template <class T>
int launch(const T* attr, const T* w1, const T* w2, T* out, long long rows, int d, int F, int H,
           int D, cudaStream_t stream) {
    const size_t smem = (size_t)BM * H * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fused_basis_mlp_fwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((rows + BM - 1) / BM);
    fused_basis_mlp_fwd_kernel<T><<<blocks, THREADS, smem, stream>>>(attr, w1, w2, out, rows, d,
                                                                      F, H, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// attr [B', O, E, d], w1 [F, H], w2 [H, D] and out [B', O, E, D] are float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
extern "C" int arreau_fused_basis_mlp_fwd(const void* attr, const void* w1, const void* w2,
                                          void* out, int Bp, int O, int E, int d, int F, int H,
                                          int D, int is_bf16, void* stream_ptr) {
    if (d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long rows = (long long)Bp * O * E;
    int status = 0;
    ARREAU_DISPATCH_DTYPE(is_bf16, {
        status = launch<T>(static_cast<const T*>(attr), static_cast<const T*>(w1),
                           static_cast<const T*>(w2), static_cast<T*>(out), rows, d, F, H, D,
                           stream);
    });
    return status;
}
