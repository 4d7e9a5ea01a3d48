// One-token decode attention over an int8 K/V cache (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_int8kv of
// src/repro/kernels/attention_int8kv.py, in the grouped layout of the LM
// decode (src/repro/models/lm/attention.py) instead of the TPU wrapper's
// collapsed one:
//
//   q    (BH, G, D)  f32     BH = batch * kv heads, G query heads per kv head
//   k_q  (BH, S, D)  int8    v_q likewise
//   k_s  (BH, S)     f32     per-token scales, v_s likewise
//   out  (BH, G, D)  f32
//
//   k = k_q * k_s, v = v_q * v_s                       (dequantized in f32)
//   out[b, g] = softmax_s(<q[b, g], k[b, s]> * softmax_scale) @ v[b, s]
//
// over the tokens s < n_valid only (the decode's causal mask: a masked
// token's weight is exactly 0 in float32, so truncation is the same
// function). With G = 1 and n_valid = S it is the TPU kernel's function.
//
// Design: the grid is (BH, n_split). Block (b, y) takes the tokens
// [y * chunk, min((y + 1) * chunk, n_valid)) of row b and walks them in
// tiles of T tokens: it dequantizes the tile's K and V into shared memory
// (each cached token is read once for all G query heads of its group),
// scores every (head, token) pair, and folds the tile into a running max,
// denominator and accumulator per head with the online softmax, all in
// f32. Each block writes its partial (max, denominator, accumulator); a
// second kernel combines the splits of each row. The split over the
// sequence is what fills the card: BH is 16 at batch 8 with 2 kv heads,
// far below 132 SMs, so the wrapper picks n_split for about two blocks
// per SM (never a split without a token).
//
// What bounds it on the H100: bytes. Every cached token costs 2 * D bytes
// of codes and 8 bytes of scales against 4 * G * D + 2 * D flops, far below
// the card's flops-per-byte balance. This version stages through shared
// memory with plain loads; TMA and wider loads are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 32;          // tokens per shared-memory tile

__global__ void __launch_bounds__(THREADS)
partial_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_q,
               const float* __restrict__ k_s, const int8_t* __restrict__ v_q,
               const float* __restrict__ v_s, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int G, int D, int S, int n_valid, int chunk,
               float softmax_scale) {
    extern __shared__ float smem[];
    float* qs = smem;                          // G * D
    float* kt = qs + G * D;                    // TILE * (D + 1), padded rows
    float* vt = kt + TILE * (D + 1);           // TILE * D
    float* pt = vt + TILE * D;                 // G * TILE
    float* acc = pt + G * TILE;                // G * D
    float* run_m = acc + G * D;                // G
    float* run_l = run_m + G;                  // G
    float* corr = run_l + G;                   // G

    const int b = blockIdx.x;
    const int y = blockIdx.y;
    const int n_split = gridDim.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = THREADS / 32;
    const int s_begin = y * chunk;
    const int s_end = min(s_begin + chunk, n_valid);

    for (int i = tid; i < G * D; i += THREADS) {
        qs[i] = q[(size_t)b * G * D + i];
        acc[i] = 0.0f;
    }
    for (int g = tid; g < G; g += THREADS) {
        run_m[g] = -INFINITY;
        run_l[g] = 0.0f;
    }
    __syncthreads();

    const int8_t* kb = k_q + (size_t)b * S * D;
    const int8_t* vb = v_q + (size_t)b * S * D;
    const float* ksb = k_s + (size_t)b * S;
    const float* vsb = v_s + (size_t)b * S;

    for (int t0 = s_begin; t0 < s_end; t0 += TILE) {
        const int nt = min(TILE, s_end - t0);
        for (int i = tid; i < nt * D; i += THREADS) {
            const int t = i / D, d = i % D;
            const size_t at = (size_t)(t0 + t) * D + d;
            kt[t * (D + 1) + d] = __fmul_rn((float)kb[at], ksb[t0 + t]);
            vt[t * D + d] = __fmul_rn((float)vb[at], vsb[t0 + t]);
        }
        __syncthreads();

        for (int i = tid; i < G * nt; i += THREADS) {
            const int g = i / nt, t = i % nt;
            const float* qg = qs + g * D;
            const float* kr = kt + t * (D + 1);
            float dot = 0.0f;
            for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
            pt[g * TILE + t] = dot * softmax_scale;
        }
        __syncthreads();

        // one warp per head: tile max, new running max, weights, sums
        for (int g = warp; g < G; g += n_warps) {
            float* pg = pt + g * TILE;
            float mx = -INFINITY;
            for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pg[t]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_old = run_m[g];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
            for (int t = lane; t < nt; t += 32) {
                const float p = expf(pg[t] - m_new);
                pg[t] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            __syncwarp();
            if (lane == 0) {
                const float c = expf(m_old - m_new);   // 0 on the first tile
                run_l[g] = run_l[g] * c + sum;
                run_m[g] = m_new;
                corr[g] = c;
            }
        }
        __syncthreads();

        for (int i = tid; i < G * D; i += THREADS) {
            const int g = i / D, d = i % D;
            const float* pg = pt + g * TILE;
            float a = acc[i] * corr[g];
            for (int t = 0; t < nt; ++t) a = fmaf(pg[t], vt[t * D + d], a);
            acc[i] = a;
        }
        __syncthreads();
    }

    const size_t row = (size_t)b * n_split + y;
    for (int g = tid; g < G; g += THREADS) {
        part_m[row * G + g] = run_m[g];
        part_l[row * G + g] = run_l[g];
    }
    for (int i = tid; i < G * D; i += THREADS)
        part_acc[row * G * D + i] = acc[i];
}

// out[b, g, d] = sum_y acc_y * e^(m_y - M) / sum_y l_y * e^(m_y - M)
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, float* __restrict__ out,
               int G, int D, int n_split) {
    const int b = blockIdx.x;
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int g = i / D, d = i % D;
        float m = -INFINITY;
        for (int y = 0; y < n_split; ++y)
            m = fmaxf(m, part_m[((size_t)b * n_split + y) * G + g]);
        float l = 0.0f, a = 0.0f;
        for (int y = 0; y < n_split; ++y) {
            const size_t row = (size_t)b * n_split + y;
            const float w = expf(part_m[row * G + g] - m);
            l = fmaf(part_l[row * G + g], w, l);
            a = fmaf(part_acc[(row * G + g) * D + d], w, a);
        }
        out[((size_t)b * G + g) * D + d] = a / l;
    }
}

}  // namespace

extern "C" int repro_decode_attention_int8kv(
        const void* q, const void* k_q, const void* k_s, const void* v_q,
        const void* v_s, void* out, void* part_m, void* part_l,
        void* part_acc, int BH, int G, int D, int S, int n_valid,
        int chunk, int n_split, float softmax_scale, int device,
        void* stream) {
    if (BH <= 0 || G <= 0 || D <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) *
        ((size_t)G * D + TILE * (D + 1) + TILE * D + G * TILE + G * D + 3 * G);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(partial_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    cudaStream_t s = (cudaStream_t)stream;
    partial_kernel<<<dim3(BH, n_split), THREADS, smem, s>>>(
        (const float*)q, (const int8_t*)k_q, (const float*)k_s,
        (const int8_t*)v_q, (const float*)v_s, (float*)part_m,
        (float*)part_l, (float*)part_acc, G, D, S, n_valid, chunk,
        softmax_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    combine_kernel<<<BH, THREADS, 0, s>>>(
        (const float*)part_m, (const float*)part_l, (const float*)part_acc,
        (float*)out, G, D, n_split);
    return (int)cudaGetLastError();
}
