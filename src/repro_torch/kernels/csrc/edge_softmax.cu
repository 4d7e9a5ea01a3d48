// Fused edge-list attention: segment softmax + weighted segment sum
// (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel edge_softmax_kernel of
// src/repro/kernels/edge_softmax.py. For every node i:
//
//   out[i] = sum_{e real, recv(e) = i} alpha_e * values[e]
//   alpha  = softmax over those edges of  q[i] . k[send(e)] + bias[e]
//
// and out[i] = 0 exactly for a node that receives no real edge.
//
// Layout contract (serving/bucketing.build_edge_list): molecule b owns
// the edge slots [b * ec, (b + 1) * ec); its real edges come first, sorted
// by receiver, then masked padding slots (self-loops on the molecule's
// first atom, which are NOT in receiver order). Keyed by
// (mask ? receiver : INT_MAX), a molecule's slot range is therefore
// sorted, and node i's real edges are the range
// [lower_bound(i), lower_bound(i + 1)) of that key; each warp finds its
// range by binary search, so padding slots never enter a segment.
//
// Design: one warp per receiver node. The warp keeps the node's query row
// in registers (lanes across F), walks its edge range once with the online
// softmax recurrence (running max, denominator and accumulator), reducing
// each logit with warp shuffles, and keeps the accumulator in registers
// with lanes across the W value columns. The TPU kernel's one-hot
// (be, cap) matmuls existed to use the MXU for the scatter; here the
// segment ranges make the scatter free.
//
// What bounds it on the H100: memory. Per real edge it reads one key row
// (4F bytes) and one value row (4W bytes) and does ~2F + 3W flops, far
// below the card's flop-per-byte balance. Rows are read by whole warps on
// consecutive addresses, so every load is coalesced, and nothing but the
// output is written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAXQ = 4;   // F <= 128
constexpr int MAXV = 8;   // W <= 256

__device__ __forceinline__ int edge_key(const int* recv, const uint8_t* mask,
                                        int e) {
    return mask[e] ? recv[e] : INT_MAX;
}

// first slot in [lo, hi) whose key is >= target
__device__ __forceinline__ int lower_bound(const int* recv,
                                           const uint8_t* mask, int lo,
                                           int hi, int target) {
    while (lo < hi) {
        const int mid = lo + (hi - lo) / 2;
        if (edge_key(recv, mask, mid) < target) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(WARPS * 32)
edge_softmax_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ bias,
                    const float* __restrict__ values,
                    const int* __restrict__ senders,
                    const int* __restrict__ receivers,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int n_nodes, int cap, int ec,
                    int F, int W) {
    const int lane = threadIdx.x % 32;
    const int node = blockIdx.x * WARPS + threadIdx.x / 32;
    if (node >= n_nodes) return;

    const int b = node / cap;
    const int start = lower_bound(receivers, mask, b * ec, (b + 1) * ec,
                                  node);
    const int end = lower_bound(receivers, mask, start, (b + 1) * ec,
                                node + 1);

    float qr[MAXQ];
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
        const int f = lane + 32 * j;
        qr[j] = f < F ? q[(size_t)node * F + f] : 0.0f;
    }

    float m_run = -INFINITY;
    float l_run = 0.0f;
    float acc[MAXV];
#pragma unroll
    for (int j = 0; j < MAXV; ++j) acc[j] = 0.0f;

    for (int e = start; e < end; ++e) {
        const int s = senders[e];
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXQ; ++j) {
            const int f = lane + 32 * j;
            if (f < F) part += qr[j] * k[(size_t)s * F + f];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
        const float logit = part + bias[e];

        const float m_new = fmaxf(m_run, logit);
        const float corr = expf(m_run - m_new);   // 0 on the first edge
        const float p = expf(logit - m_new);
        l_run = l_run * corr + p;
#pragma unroll
        for (int j = 0; j < MAXV; ++j) {
            const int c = lane + 32 * j;
            if (c < W)
                acc[j] = acc[j] * corr + p * values[(size_t)e * W + c];
        }
        m_run = m_new;
    }

    const bool has_edges = end > start;
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
        const int c = lane + 32 * j;
        if (c < W)
            out[(size_t)node * W + c] = has_edges ? acc[j] / l_run : 0.0f;
    }
}

}  // namespace

extern "C" int repro_edge_softmax(const void* q, const void* k,
                                  const void* bias, const void* values,
                                  const void* senders, const void* receivers,
                                  const void* edge_mask, void* out,
                                  int n_nodes, int cap, int ec, int F, int W,
                                  int device, void* stream) {
    if (F > MAXQ * 32 || W > MAXV * 32) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n_nodes + WARPS - 1) / WARPS;
    edge_softmax_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)bias,
        (const float*)values, (const int*)senders, (const int*)receivers,
        (const uint8_t*)edge_mask, (float*)out, n_nodes, cap, ec, F, W);
    return (int)cudaGetLastError();
}
