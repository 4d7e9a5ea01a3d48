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
// Two kernels, chosen by the wrapper from a property of the codebook that
// core/codebook.py records when it builds one:
//
// band_kernel, for a codebook whose z column strictly decreases with the
// index (every Fibonacci codebook). One launch, one warp per vector:
//   1. u == 0 exactly (zero or padded vectors): every score is +-0, so
//      the full scan's answer is index 0.
//   2. Seed: score the codewords i0 +- K0 in index order, with
//      i0 = rint((1 - hz) * C/2 - 1/2) (the Fibonacci index of height hz,
//      the z of u / |u|) and K0 = 2 * ceil(sqrt(C)). Lanes stride over
//      the range (the planar codebook sits in L2, so each step reads
//      3 x 128 bytes coalesced); a shuffle reduction of (score, index)
//      keeps the first index among equal scores.
//   3. Certify: every codeword that scores s or more lies in the z-band
//      |cz - hz| <= delta, delta^2 = 2 - 2 s / |u| + ETA, since
//      |cz - hz| <= |c - u/|u||, |c - u/|u||^2 = |c|^2 + 1 - 2<u, c>/|u|
//      and <u, c> >= s - err. (This is 1 + |u|^2 - 2s + ETA for a unit u;
//      dividing by |u| keeps the band narrow for the short u that a
//      vector under 1e-12 gives, and |u| and hz are taken from u scaled
//      by a power of two, exactly, so that no square underflows.)
//      ETA = 1e-5 covers, with a wide margin, the rounding of the scores
//      (|err| <= 3 * 2^-24 |u||c|), of |c|^2 - 1 (under 1e-7 for the
//      float32 codebooks), of |u| and hz, and of delta and the band's
//      ends themselves (about 1e-6 in all). The band is one index
//      range. If the codewords just outside the seed's range lie outside
//      the band, the seed held every maximizer and its answer is the full
//      scan's.
//      Otherwise the band's ends are found by a 32-ary search of z (four
//      rounds at 16 bits) and the band is rescanned from -2 in index
//      order. Either way every maximizer lies in a range scanned in
//      order, so ties resolve to the first index as in the full scan.
//   The magnitude code is computed in the same warp.
//
// full_kernel + combine_kernel, for any other codebook: one thread per
// vector; the (3, C) planar codebook streams through shared memory in
// 2048-codeword tiles and is split across gridDim.y blocks, and a second
// kernel combines the splits in order with a strict '>' and computes the
// magnitude code.
//
// What bounds it on the H100. The full search is bound by FP32
// operations: 5 per vector-codeword pair on the CUDA cores (the fixed
// rounding order rules out the tensor cores), 268 M pairs per 4,096
// vectors at 16 bits. The band search scores ~1,000 codewords per nonzero
// vector (the seed window; the band itself holds ~400), 12 KB of L2 reads
// each, so at the serving shapes it is bound by those reads and by each
// warp's chain of them, not by its operations or its device-memory bytes
// (its byte bound counts each input, output and band codeword once).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ETA = 1e-5f;

__device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z)));
}

__device__ __forceinline__ float score(float ux, float uy, float uz,
                                       float cx, float cy, float cz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ux, cx), __fmul_rn(uy, cy)),
                     __fmul_rn(uz, cz));
}

__device__ __forceinline__ int magnitude_code(float m, int levels,
                                              float m_min, float m_max,
                                              float log_lo, float log_span) {
    const float mc = fminf(fmaxf(m, m_min), m_max);
    const float t = __fdiv_rn(__fsub_rn(logf(mc), log_lo), log_span);
    float r = rintf(__fmul_rn(t, (float)levels));
    r = fminf(fmaxf(r, 0.0f), (float)levels);
    return (int)r;
}

// --- band search ------------------------------------------------------------

// First-index argmax of the scores of codewords [lo, hi] over the warp,
// from -2 with a strict '>' (so NaN scores never win); every lane returns
// the same (best, index), index INT_MAX when no score beats -2.
__device__ __forceinline__ void warp_scan(const float* __restrict__ cx,
                                          const float* __restrict__ cy,
                                          const float* __restrict__ cz,
                                          float ux, float uy, float uz,
                                          int lo, int hi, int lane,
                                          float& best, int& best_i) {
    best = -2.0f;
    best_i = INT_MAX;
#pragma unroll 4
    for (int j = lo + lane; j <= hi; j += 32) {
        const float s = score(ux, uy, uz, __ldg(cx + j), __ldg(cy + j),
                              __ldg(cz + j));
        if (s > best) {
            best = s;
            best_i = j;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int oi = __shfl_xor_sync(FULL, best_i, off);
        if (ob > best || (ob == best && oi < best_i)) {
            best = ob;
            best_i = oi;
        }
    }
}

// First index i in [0, C) with z[i] <= t (strict: z[i] < t), or C; z
// strictly decreasing. A 32-ary search: each round every lane tests one
// pivot and the ballot narrows the range 32-fold.
__device__ __forceinline__ int warp_first_below(const float* __restrict__ z,
                                                int C, float t, bool strict,
                                                int lane) {
    int lo = 0, hi = C;                      // the answer lies in [lo, hi]
    while (hi > lo) {
        const int step = (hi - lo + 31) / 32;
        const int q = lo + (lane + 1) * step - 1;
        bool p = true;                       // past hi: the answer is <= hi
        if (q < hi) {
            const float zq = __ldg(z + q);
            p = strict ? (zq < t) : (zq <= t);
        }
        const unsigned ballot = __ballot_sync(FULL, p);
        if (ballot == 0u) return hi;
        const int f = __ffs(ballot) - 1;
        const int nlo = lo + f * step;
        hi = min(nlo + step - 1, hi);
        lo = nlo;
    }
    return lo;
}

__global__ void __launch_bounds__(THREADS)
band_kernel(const float* __restrict__ v, const float* __restrict__ cb_t,
            int* __restrict__ idx, int* __restrict__ mag, int N, int C,
            int seed_half, int levels, float m_min, float m_max,
            float log_lo, float log_span) {
    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * THREADS + threadIdx.x) >> 5;
    if (i >= N) return;                      // whole warps leave together
    const float* cx = cb_t;
    const float* cy = cb_t + C;
    const float* cz = cb_t + 2 * (size_t)C;

    const float x = __ldg(v + 3 * (size_t)i), y = __ldg(v + 3 * (size_t)i + 1),
                z = __ldg(v + 3 * (size_t)i + 2);
    const float m = norm3(x, y, z);
    const float d = fmaxf(m, 1e-12f);
    const float ux = __fdiv_rn(x, d), uy = __fdiv_rn(y, d),
                uz = __fdiv_rn(z, d);
    if (lane == 0)
        mag[i] = magnitude_code(m, levels, m_min, m_max, log_lo, log_span);
    if (ux == 0.0f && uy == 0.0f && uz == 0.0f) {
        if (lane == 0) idx[i] = 0;
        return;
    }

    // |u| and the z of u / |u|, from u scaled by 2^-e into [0.5, 1)
    int e;
    frexpf(fmaxf(fmaxf(fabsf(ux), fabsf(uy)), fabsf(uz)), &e);
    const float wx = ldexpf(ux, -e), wy = ldexpf(uy, -e), wz = ldexpf(uz, -e);
    const float r = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(wx, wx),
                                              __fmul_rn(wy, wy)),
                                    __fmul_rn(wz, wz)));
    const float hz = __fdiv_rn(wz, r);
    const float fi0 = rintf(__fsub_rn(
        __fmul_rn(__fsub_rn(1.0f, hz), 0.5f * (float)C), 0.5f));
    const int i0 = (int)fminf(fmaxf(fi0, 0.0f), (float)(C - 1));
    const int a = max(i0 - seed_half, 0);
    const int b = min(i0 + seed_half, C - 1);
    float best;
    int best_i;
    warp_scan(cx, cy, cz, ux, uy, uz, a, b, lane, best, best_i);
    if (!(best > -2.0f)) {                   // NaN input: no score beats -2
        if (lane == 0) idx[i] = 0;
        return;
    }

    const float t = __fdiv_rn(ldexpf(best, -e), r);          // s / |u|
    const float d2 = __fadd_rn(__fsub_rn(2.0f, __fmul_rn(2.0f, t)), ETA);
    const float delta = sqrtf(fmaxf(d2, 0.0f));
    const float lo_t = __fsub_rn(hz, delta), hi_t = __fadd_rn(hz, delta);
    const bool certified = (a == 0 || __ldg(cz + a - 1) > hi_t) &&
                           (b == C - 1 || __ldg(cz + b + 1) < lo_t);
    if (!certified) {
        const int band_lo = warp_first_below(cz, C, hi_t, false, lane);
        const int band_hi = warp_first_below(cz, C, lo_t, true, lane) - 1;
        warp_scan(cx, cy, cz, ux, uy, uz, band_lo, band_hi, lane, best,
                  best_i);
    }
    if (lane == 0) idx[i] = best_i;
}

// --- full search ------------------------------------------------------------

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
            const float s = score(ux, uy, uz, cx[j], cy[j], cz[j]);
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
    mag[i] = magnitude_code(m, levels, m_min, m_max, log_lo, log_span);
}

}  // namespace

extern "C" int repro_mddq_encode_band(const void* v, const void* codebook_t,
                                      void* idx, void* mag, int N, int C,
                                      int seed_half, int levels, float m_min,
                                      float m_max, float log_lo,
                                      float log_span, int device,
                                      void* stream) {
    if (N <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int warps_per_block = THREADS / 32;
    const int blocks = (N + warps_per_block - 1) / warps_per_block;
    band_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const float*)codebook_t, (int*)idx, (int*)mag, N,
        C, seed_half, levels, m_min, m_max, log_lo, log_span);
    return (int)cudaGetLastError();
}

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
