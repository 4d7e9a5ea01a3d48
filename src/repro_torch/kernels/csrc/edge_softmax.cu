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
// Layout contract (serving/bucketing.build_edge_list, and
// device_edge_list for MD's skin lists): molecule b owns the edge slots
// [b * ec, (b + 1) * ec); the list's layout mask marks its listed edges,
// which come first, sorted by receiver, then padding slots (self-loops on
// the molecule's first atom, which are NOT in receiver order). Keyed by
// (layout ? receiver : INT_MAX), a molecule's slot range is therefore
// sorted, and node i's listed edges are the range
// [lower_bound(i), lower_bound(i + 1)) of that key, so padding slots never
// enter a segment. The edge mask may be any subset of the layout mask: a
// skin list refined to the true cutoff (kernels/ops.refine_edge_mask)
// masks edges in the middle of a receiver's run. Inside a segment an edge
// whose mask is false takes no part in the max, the sum or P.V, and a
// node whose listed edges are all masked writes exactly 0. The serving
// path passes its edge mask as the layout and runs an instantiation that
// reads no mask bit inside a segment, so serving pays nothing for refined
// lists; a distinct layout selects the one that does.
//
// What bounds it on the H100: at the serving shape (256 nodes, 2,856 real
// edges of 8,192 slots, F = 64, W = 112) the bytes take ~0.47 us; what a
// call pays for is the launch and each warp's chain of dependent loads.
//
// What the first design (PR 11) lost time to: each warp ran two binary
// searches of 10 dependent steps (a receiver and a mask load each), then
// walked its edges one at a time (sender -> key row -> five shuffles ->
// two expf -> value row), ~85 dependent round trips to memory per real
// atom; 8-warp blocks left 32 blocks for 132 SMs.
//
// Design: one warp per receiver node, 4 warps per block (64 blocks for 256
// nodes).
// * The query row goes to shared memory first, its loads in flight during
//   the search.
// * Segment bounds by a 32-ary search: each lane probes one key per round
//   and a ballot counts the keys below the target, so a 1,024-slot range
//   takes two rounds; start and end are found in the same rounds (one
//   probe serves both while their ranges coincide). Once start is known
//   to within 32 slots, the senders and biases of the 64 slots from there
//   are loaded during the last round. A node with no real edge writes
//   zeros and exits here.
// * Edges in chunks of up to 32, one per lane: lane j takes its sender,
//   bias and mask bit (loaded one chunk ahead), reads its key row as
//   float4s, all in
//   flight together, and computes its own logit against the shared query
//   row. One warp max and one warp sum per
//   chunk rescale a running (max, denominator, accumulator): the online
//   softmax taken per chunk.
// * P.V with lanes across the W value columns (float4s). The chunk's
//   value rows are loaded before the logits (all 32 for W <= 128, 16 at a
//   time for wider rows), so they arrive while the key rows do.
// Rows move as float4s when F % 4 == W % 4 == 0 and the rows are 16-byte
// aligned, else as single floats.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAXF = 128;
constexpr int MAXW = 256;

__device__ __forceinline__ int edge_key(const int* recv,
                                        const uint8_t* layout, int e) {
    return layout[e] ? recv[e] : INT_MAX;
}

// One round of the 32-ary lower_bound over the candidates [lo, hi] (hi
// meaning "no slot in [lo, hi) reaches target"): lane j probes
// lo + j * stride; the keys are sorted, so the probes below target are a
// prefix, counted by a ballot. Leaves lo == hi when resolved.
__device__ __forceinline__ void search_round(int& lo, int& hi, int key,
                                             bool probed, int stride,
                                             int target) {
    const unsigned below = __ballot_sync(0xffffffffu, probed && key < target);
    const int c = __popc(below);
    if (c == 0) {
        hi = lo;
    } else {
        const int next = lo + c * stride;
        lo = lo + (c - 1) * stride + 1;
        hi = min(hi, next);
    }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
    if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
        v[0] = *p;
    }
}

// V: floats per load (4: float4 rows); NG: value column groups per lane
// (V * 32 * NG >= W); REFINED: the edge mask is another array than the
// layout (a subset of it: a refined MD skin list), so each listed edge's
// mask bit is read; the serving path (mask == layout) runs without it
template <int V, int NG, bool REFINED>
__global__ void __launch_bounds__(WARPS * 32)
edge_softmax_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ bias,
                    const float* __restrict__ values,
                    const int* __restrict__ senders,
                    const int* __restrict__ receivers,
                    const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ layout,
                    float* __restrict__ out, int n_nodes, int cap, int ec,
                    int F, int W) {
    // value rows in flight per lane: a whole chunk (128 registers) with
    // float4 rows
    constexpr int UNROLL = V == 4 ? 32 / NG : 8;
    __shared__ __align__(16) float qs[WARPS][MAXF];

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int node = blockIdx.x * WARPS + warp;
    if (node >= n_nodes) return;

    for (int f = V * lane; f < F; f += 32 * V) {
        float v[V];
        load_vec<V>(q + (size_t)node * F + f, v);
#pragma unroll
        for (int i = 0; i < V; ++i) qs[warp][f + i] = v[i];
    }

    // segment bounds: start = lower_bound(node), end = lower_bound(node + 1)
    const int b = node / cap;
    int s_lo = b * ec, s_hi = (b + 1) * ec;
    int e_lo = s_lo, e_hi = s_hi;
    // once start is known to lie in [s_lo, s_lo + 32), the 64 slots from
    // s_lo hold the first chunk: their senders, biases and mask bits are
    // loaded while the search finishes
    int spec = -1, spec_snd[2] = {0, 0}, spec_m[2] = {0, 0};
    float spec_be[2] = {0.0f, 0.0f};
    while (s_lo < s_hi || e_lo < e_hi) {
        const int s_stride = (s_hi - s_lo + 31) / 32;
        const int e_stride = (e_hi - e_lo + 31) / 32;
        const int ps = s_lo + lane * s_stride, pe = e_lo + lane * e_stride;
        const bool s_in = ps < s_hi, e_in = pe < e_hi;
        const int ks = s_in ? edge_key(receivers, layout, ps) : INT_MAX;
        const int ke = (s_lo == e_lo && s_hi == e_hi)
                           ? ks
                           : (e_in ? edge_key(receivers, layout, pe)
                                   : INT_MAX);
        if (s_lo < s_hi) search_round(s_lo, s_hi, ks, s_in, s_stride, node);
        if (e_lo < e_hi)
            search_round(e_lo, e_hi, ke, e_in, e_stride, node + 1);
        if (spec < 0 && s_hi - s_lo < 32) {
            spec = s_lo;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int e = spec + 32 * h + lane;
                if (e < (b + 1) * ec) {
                    spec_snd[h] = senders[e];
                    spec_be[h] = bias[e];
                    if constexpr (REFINED) spec_m[h] = mask[e];
                }
            }
        }
    }
    const int start = s_lo, end = e_lo;

    float acc[NG][V];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] = 0.0f;

    if (end > start) {
        __syncwarp();   // qs written by the whole warp
        float m_run = -INFINITY, l_run = 0.0f;
        // each chunk's sender and bias are loaded one chunk ahead; the
        // first chunk's come from the speculative window
        const int off = start - spec + lane;
        const int s0 = __shfl_sync(0xffffffffu, spec_snd[0], off & 31);
        const int s1 = __shfl_sync(0xffffffffu, spec_snd[1], off & 31);
        const float b0 = __shfl_sync(0xffffffffu, spec_be[0], off & 31);
        const float b1 = __shfl_sync(0xffffffffu, spec_be[1], off & 31);
        int snd_next = off < 32 ? s0 : s1;
        float be_next = off < 32 ? b0 : b1;
        int m_next = 1;
        if constexpr (REFINED) {
            const int m0 = __shfl_sync(0xffffffffu, spec_m[0], off & 31);
            const int m1 = __shfl_sync(0xffffffffu, spec_m[1], off & 31);
            m_next = off < 32 ? m0 : m1;
        }
        for (int c0 = start; c0 < end; c0 += 32) {
            const int n = min(32, end - c0);
            const bool active = lane < n;
            // a listed edge the mask drops (a refined skin list) takes no
            // part in the softmax; its rows are read all the same, so no
            // load waits on the mask
            const bool live = active && (!REFINED || m_next != 0);
            const int snd = snd_next;
            const float be = be_next;
            if (c0 + 32 + lane < end) {
                snd_next = senders[c0 + 32 + lane];
                be_next = bias[c0 + 32 + lane];
                if constexpr (REFINED) m_next = mask[c0 + 32 + lane];
            }
            // the chunk's value rows (the first UNROLL), in flight while
            // the logits are formed
            float vb[UNROLL][NG][V];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                for (int j = 0; j < NG; ++j) {
                    const int col = V * (lane + 32 * j);
                    if (u < n && col < W)
                        load_vec<V>(values + (size_t)(c0 + u) * W + col,
                                    vb[u][j]);
                }

            float logit = -INFINITY;
            if (active) {
                const float* kr = k + (size_t)snd * F;
                float dot = 0.0f;
#pragma unroll
                for (int f = 0; f < MAXF; f += V) {
                    if (f < F) {
                        float kv[V];
                        load_vec<V>(kr + f, kv);
#pragma unroll
                        for (int i = 0; i < V; ++i)
                            dot = fmaf(qs[warp][f + i], kv[i], dot);
                    }
                }
                if (live) logit = dot + be;
            }
            float cmax = logit;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
            const float m_new = fmaxf(m_run, cmax);
            // 0 on the first chunk with an unmasked edge; 1 while every
            // edge so far was masked (m_new = -inf, nothing to rescale)
            const float corr = REFINED && m_new == -INFINITY
                                   ? 1.0f : expf(m_run - m_new);
            // exactly 0 for a masked edge, whose value row then adds 0
            const float p = live ? expf(logit - m_new) : 0.0f;
            float psum = p;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
            l_run = l_run * corr + psum;
            m_run = m_new;
#pragma unroll
            for (int j = 0; j < NG; ++j)
#pragma unroll
                for (int i = 0; i < V; ++i) acc[j][i] *= corr;

            for (int u0 = 0; u0 < n; u0 += UNROLL) {
                if (u0 > 0) {
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                        for (int j = 0; j < NG; ++j) {
                            const int col = V * (lane + 32 * j);
                            if (u0 + u < n && col < W)
                                load_vec<V>(values
                                            + (size_t)(c0 + u0 + u) * W + col,
                                            vb[u][j]);
                        }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const float pu = __shfl_sync(0xffffffffu, p, u0 + u);
                    if (u0 + u < n) {
#pragma unroll
                        for (int j = 0; j < NG; ++j)
#pragma unroll
                            for (int i = 0; i < V; ++i)
                                acc[j][i] = fmaf(pu, vb[u][j][i], acc[j][i]);
                    }
                }
            }
        }
        // l_run = 0: every listed edge masked, the accumulator is 0
        const float denom = !REFINED || l_run > 0.0f ? l_run : 1.0f;
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[j][i] = acc[j][i] / denom;
    }

#pragma unroll
    for (int j = 0; j < NG; ++j) {
        const int col = V * (lane + 32 * j);
        if (col >= W) continue;
        float* dst = out + (size_t)node * W + col;
        if constexpr (V == 4) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
            *dst = acc[j][0];
        }
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int repro_edge_softmax(const void* q, const void* k,
                                  const void* bias, const void* values,
                                  const void* senders, const void* receivers,
                                  const void* edge_mask,
                                  const void* layout_mask, void* out,
                                  int n_nodes, int cap, int ec, int F, int W,
                                  int device, void* stream) {
    if (F > MAXF || W > MAXW) return (int)cudaErrorInvalidValue;
    if (n_nodes <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n_nodes + WARPS - 1) / WARPS;
    const bool vec = F % 4 == 0 && W % 4 == 0 && aligned16(q)
                     && aligned16(k) && aligned16(values) && aligned16(out);
    // the serving path passes its edge mask as the layout
    const bool refined = layout_mask != edge_mask;
    const auto kernel =
        !vec ? (refined ? edge_softmax_kernel<1, MAXW / 32, true>
                        : edge_softmax_kernel<1, MAXW / 32, false>)
        : W <= 128 ? (refined ? edge_softmax_kernel<4, 1, true>
                              : edge_softmax_kernel<4, 1, false>)
                   : (refined ? edge_softmax_kernel<4, 2, true>
                              : edge_softmax_kernel<4, 2, false>);
    kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)bias,
        (const float*)values, (const int*)senders, (const int*)receivers,
        (const uint8_t*)edge_mask, (const uint8_t*)layout_mask, (float*)out,
        n_nodes, cap, ec, F, W);
    return (int)cudaGetLastError();
}
