// Fused dequantize-matmul for W8A8 and W4A8 (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels w8a8_matmul and w4a8_matmul of
// src/repro/kernels/quant_matmul.py:
//
//   out[m, n] = (float(sum_k a_q[m, k] * w_q[k, n]) * a_scale[m]) * w_scale[n]
//
// a_q (M, K) int8 row-major, a_scale (M,) f32, w (K, N) int8 or, for W4,
// (K, N/2) uint8 holding two signed nibbles per byte (low nibble = even
// column), w_scale (N,) f32, out (M, N) f32.
//
// Design: one 64x64 output tile per block of 256 threads, each thread
// owning a 4x4 register tile. K advances in 32-wide steps through shared
// memory; the weight tile is staged transposed (n-major) so that four
// consecutive k of one column form one 32-bit word, and the product runs
// on __dp4a (four int8 MACs into an exact int32 sum). W4 weights are
// sign-extended from their nibbles while the tile is staged, so the inner
// loop is the same for both entries. Ragged M, N and K are masked with
// zeros in shared memory, so no caller pads. The epilogue multiplies in
// the order of the plain version (acc * a_scale, then * w_scale) with
// __fmul_rn, and the accumulation is exact, so the kernel matches its
// plain version bit for bit.
//
// What bounds it on the H100: at the serving shapes (M = 256 rows, K <= 80,
// N <= 192) the f32 output dominates the bytes moved and the integer work
// is a few million MACs, so the least time is set by memory traffic (and,
// in practice, by launch latency). The kernel reads each input once per
// output tile and writes each output once; the int8 tensor cores are left
// for a later, faster version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ int sext4(int nibble) {
    return nibble >= 8 ? nibble - 16 : nibble;
}

template <bool W4>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
           const uint8_t* __restrict__ w, const float* __restrict__ w_scale,
           float* __restrict__ out, int M, int N, int K) {
    __shared__ __align__(16) int8_t As[BM][BK];   // m-major
    __shared__ __align__(16) int8_t Ws[BN][BK];   // n-major (transposed)

    const int tid = threadIdx.x;
    const int tx = tid % 16;                      // column group
    const int ty = tid / 16;                      // row group
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // stage A: BM x BK bytes, consecutive threads on consecutive k
        for (int idx = tid; idx < BM * BK; idx += THREADS) {
            const int r = idx / BK, c = idx % BK;
            const int gm = m0 + r, gk = k0 + c;
            As[r][c] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0;
        }
        if (W4) {
            // stage W from packed bytes: BK rows x BN/2 bytes per row
            const int half_n = N / 2;
            for (int idx = tid; idx < BK * (BN / 2); idx += THREADS) {
                const int r = idx / (BN / 2), c = idx % (BN / 2);
                const int gk = k0 + r, gb = n0 / 2 + c;
                int lo = 0, hi = 0;
                if (gk < K && gb < half_n) {
                    const int byte = w[(size_t)gk * half_n + gb];
                    lo = sext4(byte & 0xF);
                    hi = sext4((byte >> 4) & 0xF);
                }
                Ws[2 * c][r] = (int8_t)lo;
                Ws[2 * c + 1][r] = (int8_t)hi;
            }
        } else {
            for (int idx = tid; idx < BK * BN; idx += THREADS) {
                const int r = idx / BN, c = idx % BN;
                const int gk = k0 + r, gn = n0 + c;
                Ws[c][r] = (gk < K && gn < N)
                    ? (int8_t)w[(size_t)gk * N + gn] : (int8_t)0;
            }
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            int av[4], wv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                av[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wv[j] = *reinterpret_cast<const int*>(&Ws[tx + 16 * j][kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty + 16 * i;
        if (gm >= M) continue;
        const float sa = a_scale[gm];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + tx + 16 * j;
            if (gn >= N) continue;
            out[(size_t)gm * N + gn] =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sa),
                          w_scale[gn]);
        }
    }
}

template <bool W4>
int launch(const void* a, const void* a_scale, const void* w,
           const void* w_scale, void* out, int M, int N, int K,
           void* stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_kernel<W4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)a, (const float*)a_scale, (const uint8_t*)w,
        (const float*)w_scale, (float*)out, M, N, K);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_qmm_w8a8(const void* a, const void* a_scale,
                              const void* w, const void* w_scale, void* out,
                              int M, int N, int K, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return launch<false>(a, a_scale, w, w_scale, out, M, N, K, stream);
}

extern "C" int repro_qmm_w4a8(const void* a, const void* a_scale,
                              const void* w_packed, const void* w_scale,
                              void* out, int M, int N, int K, int device,
                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return launch<true>(a, a_scale, w_packed, w_scale, out, M, N, K, stream);
}
