// MDDQ encode: nearest spherical codeword + log-magnitude code
// (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel mddq_encode_kernel of
// src/repro/kernels/mddq_kernel.py. Per vector v:
//
//   m    = sqrt((vx*vx + vy*vy) + vz*vz)
//   u    = v / max(m, 1e-12)                       (division, as ref.py)
//   idx  = argmax_c (ux*cx + uy*cy) + uz*cz         (first index wins)
//   mag  = clamp(rint((log(clamp(m, m_min, m_max)) - lo) / (hi - lo)
//                     * levels), 0, levels)
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction) in the order written above; the plain PyTorch version
// performs the same elementwise operations in the same order, so the two
// agree exactly. rintf rounds half to even, like torch.round.
//
// Design: one thread per vector. The codebook, (3, C) planar, streams
// through shared memory in 2048-codeword tiles (24 KB; the paper's 16-bit
// codebook is 768 KB and cannot sit in one SM's 227 KB). To fill the card
// when there are few vectors (4,096 per layer at the serving shapes), the
// codebook is also split across gridDim.y blocks: each writes its split's
// best (score, index) to scratch, and a second small kernel combines the
// splits in order with a strict '>' (so the first index still wins) and
// computes the magnitude code.
//
// What bounds it on the H100: operations. Each vector scores every
// codeword with 3 multiplies and 2 adds in FP32 on the CUDA cores (the
// fixed rounding order rules out the tensor cores), against only
// 12 bytes of input per vector and 12 bytes per codeword.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;

__device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z)));
}

__global__ void __launch_bounds__(THREADS)
search_kernel(const float* __restrict__ v, const float* __restrict__ cb_t,
              float* __restrict__ part_score, int* __restrict__ part_idx,
              int N, int C, int chunk) {
    __shared__ float cx[TILE], cy[TILE], cz[TILE];

    const int i = blockIdx.x * THREADS + threadIdx.x;
    const int lo = blockIdx.y * chunk;
    const int hi = min(C, lo + chunk);

    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (i < N) {
        const float x = v[3 * (size_t)i], y = v[3 * (size_t)i + 1],
                    z = v[3 * (size_t)i + 2];
        const float d = fmaxf(norm3(x, y, z), 1e-12f);
        ux = __fdiv_rn(x, d);
        uy = __fdiv_rn(y, d);
        uz = __fdiv_rn(z, d);
    }

    float best = -2.0f;
    int best_i = 0;
    for (int t0 = lo; t0 < hi; t0 += TILE) {
        const int cnt = min(TILE, hi - t0);
        for (int j = threadIdx.x; j < cnt; j += THREADS) {
            cx[j] = cb_t[t0 + j];
            cy[j] = cb_t[C + t0 + j];
            cz[j] = cb_t[2 * (size_t)C + t0 + j];
        }
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
            const float s = __fadd_rn(
                __fadd_rn(__fmul_rn(ux, cx[j]), __fmul_rn(uy, cy[j])),
                __fmul_rn(uz, cz[j]));
            if (s > best) {
                best = s;
                best_i = t0 + j;
            }
        }
        __syncthreads();
    }
    if (i < N) {
        part_score[(size_t)blockIdx.y * N + i] = best;
        part_idx[(size_t)blockIdx.y * N + i] = best_i;
    }
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ v,
               const float* __restrict__ part_score,
               const int* __restrict__ part_idx, int* __restrict__ idx,
               int* __restrict__ mag, int N, int n_split, int levels,
               float m_min, float m_max, float log_lo, float log_span) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= N) return;
    float best = -2.0f;
    int best_i = 0;
    for (int y = 0; y < n_split; ++y) {
        const float s = part_score[(size_t)y * N + i];
        if (s > best) {
            best = s;
            best_i = part_idx[(size_t)y * N + i];
        }
    }
    idx[i] = best_i;

    const float m = norm3(v[3 * (size_t)i], v[3 * (size_t)i + 1],
                          v[3 * (size_t)i + 2]);
    const float mc = fminf(fmaxf(m, m_min), m_max);
    const float t = __fdiv_rn(__fsub_rn(logf(mc), log_lo), log_span);
    float r = rintf(__fmul_rn(t, (float)levels));
    r = fminf(fmaxf(r, 0.0f), (float)levels);
    mag[i] = (int)r;
}

}  // namespace

extern "C" int repro_mddq_encode(const void* v, const void* codebook_t,
                                 void* idx, void* mag, void* part_score,
                                 void* part_idx, int N, int C, int n_split,
                                 int levels, float m_min, float m_max,
                                 float log_lo, float log_span, int device,
                                 void* stream) {
    if (N <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int chunk = (C + n_split - 1) / n_split;
    const int blocks = (N + THREADS - 1) / THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    search_kernel<<<dim3(blocks, n_split), THREADS, 0, s>>>(
        (const float*)v, (const float*)codebook_t, (float*)part_score,
        (int*)part_idx, N, C, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    combine_kernel<<<blocks, THREADS, 0, s>>>(
        (const float*)v, (const float*)part_score, (const int*)part_idx,
        (int*)idx, (int*)mag, N, n_split, levels, m_min, m_max, log_lo,
        log_span);
    return (int)cudaGetLastError();
}
