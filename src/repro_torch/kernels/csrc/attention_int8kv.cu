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
// What bounds it on the H100. The work is far below the card's
// flops-per-byte balance (2 * D code bytes and 8 scale bytes per cached
// token against 4 * G * D flops), so the floor is bytes: 1.35 us for 16
// rows of 2,048 tokens. At the decode's shapes (16 rows, at most a few
// hundred valid tokens) it is latency: a launch, one round trip to device
// memory and each warp's chain of dependent arithmetic. The design keeps
// that chain short and the launch single:
//
// - One launch. The grid is (BH, n_split); block (b, y) takes the tokens
//   [y * chunk, min((y + 1) * chunk, n_valid)) of row b. The host plans
//   n_split, chunk and run from a host n_valid; with a device position
//   (pos_ptr non-null: n_valid = *pos_ptr + 1, the decode's position read by
//   every block, so a captured decode step serves every position) the
//   host sizes n_split from S, the most any position needs, and each block
//   derives from the n_valid it reads the host's own plan (its splits,
//   chunk and run; never more splits than S needs). The first n_live
//   splits hold tokens (all of them under the host's plan); a split past
//   them exits at once, so a device position costs what the host's plan
//   does, less the empty blocks' launch, and gives the same result bit
//   for bit (an empty partial, max -inf and denominator 0, would weigh
//   exactly 0 in the combine: skipping it gives the same sums). With one
//   live split
//   the block writes the output itself. Otherwise each live block writes
//   its partial (max, denominator, accumulator), and the last live block
//   of a row to finish (an atomic ticket after a __threadfence, counted to
//   n_live) combines the row's live splits in split order y = 0, 1, ...,
//   so the result does not depend on which block came last, and resets
//   the ticket to 0 for the next call.
// - No block barrier inside the token loop. Each of the block's 4 warps
//   owns a contiguous run of `run` tokens and its own online-softmax state
//   in registers: per head the running max, the denominator (per lane,
//   summed over the warp at the end) and the accumulator of the lane's
//   D / 32 dims. The warps merge once, through shared memory, at the end.
// - Heads padded to a compile-time count GM (1, 4, 8 or 16; zero query
//   rows past G), so that no loop over heads has a runtime bound: a
//   `g < G` guard on each head's work puts it behind a branch, turns
//   every shuffle into a collective and serializes the heads' chains.
// - 16-byte loads. In each step of 32 tokens lane t loads token t's K row
//   and V row as int4 vectors straight into registers (ld.global.nc; the
//   first step's loads are in flight with q's), and the token's two
//   scales; nothing is staged in float32 and no index is divided. K is
//   dequantized in registers (__fmul_rn(code, scale), as the plain
//   version multiplies).
// - Scores: one lane per token. Lane t scores its token against the GM
//   query heads; q sits in shared memory and every lane reads the same
//   16 bytes (a broadcast), and the GM dot products are independent
//   chains. The softmax takes each head's max over the warp with
//   __shfl_xor_sync.
// - P.V: each lane owns D / 32 fixed dims. The step's V rows (as loaded),
//   V scales and softmax weights go to the warp's shared slots, and every
//   lane accumulates its dims for the GM heads over the step's 32 tokens,
//   reading each token's weights as 16-byte broadcasts. A lane without a
//   token has scale 0 and weight 0, so the loop has a fixed trip count.
// The arithmetic stays float32 throughout (the gate against the plain
// version is 1e-5; TF32 tensor cores would break it and, this far below
// the balance point, buy nothing).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TARGET_BLOCKS = 2 * 132;   // attention_int8kv.py _TARGET_BLOCKS
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float code_at(int word, int k) {
    return (float)(int8_t)(word >> (8 * k));
}

// A cached row of D int8 codes as D / 4 words, in 16-byte vectors (8-byte
// ones where D is not a multiple of 16).
template <int D>
__device__ __forceinline__ void load_row(const int8_t* p, int (&wd)[D / 4]) {
    if constexpr (D % 16 == 0) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(p) + j);
            wd[4 * j] = x.x;
            wd[4 * j + 1] = x.y;
            wd[4 * j + 2] = x.z;
            wd[4 * j + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            const int2 x = __ldg(reinterpret_cast<const int2*>(p) + j);
            wd[2 * j] = x.x;
            wd[2 * j + 1] = x.y;
        }
    }
}

template <int D>
__device__ __forceinline__ void store_row(int8_t* p, const int (&wd)[D / 4]) {
    if constexpr (D % 16 == 0) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
            reinterpret_cast<int4*>(p)[j] =
                make_int4(wd[4 * j], wd[4 * j + 1], wd[4 * j + 2],
                          wd[4 * j + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            reinterpret_cast<int2*>(p)[j] = make_int2(wd[2 * j], wd[2 * j + 1]);
    }
}

// GM >= G heads, the query rows past G zero (see the note above).
template <int D, int GM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_q,
              const float* __restrict__ k_s, const int8_t* __restrict__ v_q,
              const float* __restrict__ v_s, float* __restrict__ out,
              float* __restrict__ part_m, float* __restrict__ part_l,
              float* __restrict__ part_acc, unsigned* __restrict__ tickets,
              int G, int S, int n_valid, int chunk, int run,
              const int* __restrict__ pos_ptr,
              float softmax_scale) {
    static_assert(D % 8 == 0 && D <= 256, "D: a multiple of 8, <= 256");
    static_assert(GM == 1 || GM % 4 == 0, "GM: 1 or a multiple of 4");
    constexpr int DPL = D >= 32 ? D / 32 : 1;   // dims per lane in P.V
    constexpr int NW = D / 4;                   // 32-bit words per row
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);             // GM * D
    float* wm = qs + GM * D;                                 // WARPS * GM
    float* wl = wm + WARPS * GM;                             // WARPS * GM
    float* wacc = wl + WARPS * GM;                           // WARPS*GM*D
    float* ps = wacc + WARPS * GM * D;                       // WARPS*32*GM
    float* vss = ps + WARPS * 32 * GM;                       // WARPS * 32
    int8_t* vrows = reinterpret_cast<int8_t*>(vss + WARPS * 32);
    float* vrows_end = reinterpret_cast<float*>(vrows + WARPS * 32 * D);
    __shared__ float head_m[GM], head_l[GM];
    __shared__ bool is_last;

    const int b = blockIdx.x;
    const int y = blockIdx.y;
    const int n_split = gridDim.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int w = tid >> 5;
    const bool owns_dims = lane * DPL < D;      // every lane once D >= 32
    if (pos_ptr != nullptr) {
        // the host's plan of this n_valid (attention_int8kv.py split_plan,
        // device_split_plan), with n_valid clamped to [1, S] as the
        // decode's position is to [0, S)
        n_valid = min(max(__ldg(pos_ptr) + 1, 1), S);
        const int splits = max(1, min((n_valid + WARPS * 32 - 1) / (WARPS * 32),
                                      (TARGET_BLOCKS + gridDim.x - 1) / gridDim.x));
        chunk = ((n_valid + splits - 1) / splits + 31) / 32 * 32;
        run = (chunk / 32 + WARPS - 1) / WARPS * 32;
    }
    const int n_live = (n_valid + chunk - 1) / chunk;   // n_split, host plan
    if (y >= n_live) return;                 // no token: the whole block

    const int split_end = min(y * chunk + chunk, n_valid);
    const int t_begin = y * chunk + w * run;
    const int t_end = min(t_begin + run, split_end);
    const int8_t* kb = k_q + (size_t)b * S * D;
    const int8_t* vb = v_q + (size_t)b * S * D;
    const float* ksb = k_s + (size_t)b * S;
    const float* vsb = v_s + (size_t)b * S;
    float* ps_w = ps + w * 32 * GM;
    float* vss_w = vss + w * 32;
    int8_t* vslot = vrows + (size_t)w * 32 * D;

    // token t0 + lane's K and V rows and scales into registers
    int kw[NW], vw[NW];
    float ks, vs;
    bool live;
    auto fetch = [&](int t0) {
        const int t = t0 + lane;
        live = t < t_end;
        ks = vs = 0.0f;
#pragma unroll
        for (int c = 0; c < NW; ++c) kw[c] = vw[c] = 0;
        if (live) {
            load_row<D>(kb + (size_t)t * D, kw);
            load_row<D>(vb + (size_t)t * D, vw);
            ks = __ldg(ksb + t);
            vs = __ldg(vsb + t);
        }
    };
    if (t_begin < t_end) fetch(t_begin);        // in flight with q's load

    {
        const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * G * D);
        float4* qs4 = reinterpret_cast<float4*>(qs);
        for (int i = tid; i < GM * D / 4; i += THREADS)
            qs4[i] = i < G * D / 4 ? __ldg(q4 + i)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();

    float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.0f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
    }

    for (int t0 = t_begin; t0 < t_end; t0 += 32) {
        if (t0 != t_begin) fetch(t0);
        // a dead lane's slot keeps old codes, which its zero scale and
        // zero weight turn into exact zeros below
        if (live) store_row<D>(vslot + lane * D, vw);
        vss_w[lane] = vs;

        // scores: lane t against the GM heads
        float sc[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) sc[g] = 0.0f;
#pragma unroll
        for (int c = 0; c < NW; ++c) {
            float kf[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) kf[k] = __fmul_rn(code_at(kw[c], k), ks);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + g * D + 4 * c);
                sc[g] = fmaf(qv.x, kf[0], sc[g]);
                sc[g] = fmaf(qv.y, kf[1], sc[g]);
                sc[g] = fmaf(qv.z, kf[2], sc[g]);
                sc[g] = fmaf(qv.w, kf[3], sc[g]);
            }
        }

        // online softmax per head; the weights go to the warp's slot
        float p[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            const float s = live ? sc[g] * softmax_scale : -INFINITY;
            float mx = s;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_new = fmaxf(m[g], mx);
            const float corr = expf(m[g] - m_new);   // 0 on the first step
            p[g] = expf(s - m_new);                  // 0 for a dead lane
            l[g] = fmaf(l[g], corr, p[g]);
#pragma unroll
            for (int j = 0; j < DPL; ++j) acc[g][j] *= corr;
            m[g] = m_new;
        }
        if constexpr (GM == 1) {
            ps_w[lane] = p[0];
        } else {
#pragma unroll
            for (int g = 0; g < GM; g += 4)
                *reinterpret_cast<float4*>(ps_w + lane * GM + g) =
                    make_float4(p[g], p[g + 1], p[g + 2], p[g + 3]);
        }
        __syncwarp();

        // P.V: every lane its DPL dims over the step's 32 tokens
        const int8_t* vcol = vslot + (owns_dims ? lane * DPL : 0);
#pragma unroll 4
        for (int tt = 0; tt < 32; ++tt) {
            const float vsc = vss_w[tt];
            const int8_t* row = vcol + tt * D;
            float vf[DPL];
            if constexpr (DPL == 1) {
                vf[0] = __fmul_rn((float)row[0], vsc);
            } else if constexpr (DPL == 2) {
                const short pair = *reinterpret_cast<const short*>(row);
                vf[0] = __fmul_rn((float)(int8_t)(pair & 0xff), vsc);
                vf[1] = __fmul_rn((float)(int8_t)(pair >> 8), vsc);
            } else {
                static_assert(DPL % 4 == 0,
                              "dims per lane: 1, 2 or a multiple of 4");
#pragma unroll
                for (int k4 = 0; k4 < DPL / 4; ++k4) {
                    const int quad = reinterpret_cast<const int*>(row)[k4];
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        vf[4 * k4 + k] = __fmul_rn(code_at(quad, k), vsc);
                }
            }
            float pt[GM];                // token tt's weights, broadcast
            if constexpr (GM == 1) {
                pt[0] = ps_w[tt];
            } else {
#pragma unroll
                for (int g = 0; g < GM; g += 4) {
                    const float4 p4 =
                        *reinterpret_cast<const float4*>(ps_w + tt * GM + g);
                    pt[g] = p4.x;
                    pt[g + 1] = p4.y;
                    pt[g + 2] = p4.z;
                    pt[g + 3] = p4.w;
                }
            }
#pragma unroll
            for (int g = 0; g < GM; ++g) {
#pragma unroll
                for (int j = 0; j < DPL; ++j)
                    acc[g][j] = fmaf(pt[g], vf[j], acc[g][j]);
            }
        }
        __syncwarp();                    // the slots are rewritten next step
    }

    // the warps' states to shared memory
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        float lsum = l[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            lsum += __shfl_xor_sync(FULL, lsum, off);
        if (lane == 0) {
            wm[w * GM + g] = m[g];
            wl[w * GM + g] = lsum;
        }
        if (owns_dims) {
#pragma unroll
            for (int j = 0; j < DPL; ++j)
                wacc[(w * GM + g) * D + lane * DPL + j] = acc[g][j];
        }
    }
    __syncthreads();

    // merge the warps: per head, each warp's weight e = exp(m_w - M) and
    // the denominator, once (an empty warp weighs 0; a block with no token
    // at all, possible only under the device plan, gives the empty
    // partial: M = -inf, denominator 0, accumulator 0)
    if (tid < G) {
        const int g = tid;
        float mx = -INFINITY;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) mx = fmaxf(mx, wm[v * GM + g]);
        float lsum = 0.0f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) {
            const float e = mx == -INFINITY ? 0.0f
                                            : expf(wm[v * GM + g] - mx);
            wm[v * GM + g] = e;
            lsum = fmaf(wl[v * GM + g], e, lsum);
        }
        head_m[g] = mx;
        head_l[g] = lsum;
    }
    __syncthreads();
    const size_t prow = (size_t)b * n_split + y;
    for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D;
        float a = 0.0f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v)
            a = fmaf(wacc[(v * GM + g) * D + (i - g * D)], wm[v * GM + g], a);
        if (n_live == 1) {
            out[(size_t)b * G * D + i] = a / head_l[g];
        } else {
            part_acc[prow * G * D + i] = a;
            if (i - g * D == 0) {
                part_m[prow * G + g] = head_m[g];
                part_l[prow * G + g] = head_l[g];
            }
        }
    }
    if (n_live == 1) return;

    // the last block of the row to finish combines its splits, in split
    // order: the row's maxima and denominators go to shared memory in one
    // round of loads, a warp per head turns them into weights, and every
    // thread sums its outputs' partial accumulators with those weights
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(tickets + b, 1u) == (unsigned)(n_live - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    float* sm = vrows_end;                       // n_live * GM
    float* sl = sm + n_split * GM;               // n_live * GM
    for (int k = tid; k < n_live * G; k += THREADS) {
        const int yy = k / G, g = k - yy * G;
        sm[yy * GM + g] = __ldcg(part_m + (size_t)b * n_split * G + k);
        sl[yy * GM + g] = __ldcg(part_l + (size_t)b * n_split * G + k);
    }
    __syncthreads();
    for (int g = w; g < G; g += WARPS) {
        float mx = -INFINITY;
        for (int yy = lane; yy < n_live; yy += 32) mx = fmaxf(mx, sm[yy * GM + g]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        float lsum = 0.0f;
        for (int yy = lane; yy < n_live; yy += 32) {
            const float e = expf(sm[yy * GM + g] - mx);
            sm[yy * GM + g] = e;
            lsum = fmaf(sl[yy * GM + g], e, lsum);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            lsum += __shfl_xor_sync(FULL, lsum, off);
        if (lane == 0) head_l[g] = lsum;
    }
    __syncthreads();
    // four outputs of one head per thread, each split's four partial
    // accumulators in one 16-byte load, 16 loads in flight at a time
    const float4* acc_row =
        reinterpret_cast<const float4*>(part_acc + (size_t)b * n_split * G * D);
    for (int i4 = tid; i4 < G * D / 4; i4 += THREADS) {
        const int g = 4 * i4 / D;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 16
        for (int yy = 0; yy < n_live; ++yy) {
            const float4 pa = __ldcg(acc_row + (size_t)yy * G * D / 4 + i4);
            const float e = sm[yy * GM + g];
            a.x = fmaf(pa.x, e, a.x);
            a.y = fmaf(pa.y, e, a.y);
            a.z = fmaf(pa.z, e, a.z);
            a.w = fmaf(pa.w, e, a.w);
        }
        const float lsum = head_l[g];
        reinterpret_cast<float4*>(out + (size_t)b * G * D)[i4] =
            make_float4(a.x / lsum, a.y / lsum, a.z / lsum, a.w / lsum);
    }
    if (tid == 0) tickets[b] = 0u;
}

template <int D, int GM>
cudaError_t launch(const void* q, const void* k_q, const void* k_s,
                   const void* v_q, const void* v_s, void* out, void* part_m,
                   void* part_l, void* part_acc, void* tickets, int BH, int G,
                   int S, int n_valid, int chunk, int run, int n_split,
                   const void* pos_ptr, float softmax_scale,
                   cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((size_t)GM * D + 2 * WARPS * GM +
                                         (size_t)WARPS * GM * D +
                                         (size_t)WARPS * 32 * GM +
                                         WARPS * 32) +
                        (size_t)WARPS * 32 * D +
                        (n_split > 1 ? sizeof(float) * 2 * n_split * GM : 0);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            decode_kernel<D, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    decode_kernel<D, GM><<<dim3(BH, n_split), THREADS, smem, stream>>>(
        (const float*)q, (const int8_t*)k_q, (const float*)k_s,
        (const int8_t*)v_q, (const float*)v_s, (float*)out, (float*)part_m,
        (float*)part_l, (float*)part_acc, (unsigned*)tickets, G, S, n_valid,
        chunk, run, (const int*)pos_ptr, softmax_scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int G, const void* q, const void* k_q, const void* k_s,
                     const void* v_q, const void* v_s, void* out,
                     void* part_m, void* part_l, void* part_acc,
                     void* tickets, int BH, int S, int n_valid, int chunk,
                     int run, int n_split, const void* pos_ptr,
                     float softmax_scale,
                     cudaStream_t stream) {
    if (G == 1)
        return launch<D, 1>(q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                            part_acc, tickets, BH, G, S, n_valid, chunk, run,
                            n_split, pos_ptr, softmax_scale,
                            stream);
    if (G <= 4)
        return launch<D, 4>(q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                            part_acc, tickets, BH, G, S, n_valid, chunk, run,
                            n_split, pos_ptr, softmax_scale,
                            stream);
    if (G <= 8)
        return launch<D, 8>(q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                            part_acc, tickets, BH, G, S, n_valid, chunk, run,
                            n_split, pos_ptr, softmax_scale,
                            stream);
    if (G <= 16)
        return launch<D, 16>(q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                             part_acc, tickets, BH, G, S, n_valid, chunk, run,
                             n_split, pos_ptr, softmax_scale, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// G <= 16 query heads per kv head and D in {8, 64, 128} (the wrapper
// checks both); q, k_q and v_q 16-byte aligned. pos_ptr null: the
// host's n_valid, chunk and run; else the device plan over n_split.
extern "C" int repro_decode_attention_int8kv(
        const void* q, const void* k_q, const void* k_s, const void* v_q,
        const void* v_s, void* out, void* part_m, void* part_l,
        void* part_acc, void* tickets, int BH, int G, int D, int S,
        int n_valid, int chunk, int run, int n_split,
        const void* pos_ptr, float softmax_scale,
        int device, void* stream) {
    if (BH <= 0 || G <= 0 || D <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (D == 8)
        err = launch_d<8>(G, q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                          part_acc, tickets, BH, S, n_valid, chunk, run,
                          n_split, pos_ptr, softmax_scale,
                          s);
    else if (D == 64)
        err = launch_d<64>(G, q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                           part_acc, tickets, BH, S, n_valid, chunk, run,
                           n_split, pos_ptr, softmax_scale,
                           s);
    else if (D == 128)
        err = launch_d<128>(G, q, k_q, k_s, v_q, v_s, out, part_m, part_l,
                            part_acc, tickets, BH, S, n_valid, chunk, run,
                            n_split, pos_ptr, softmax_scale, s);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}
