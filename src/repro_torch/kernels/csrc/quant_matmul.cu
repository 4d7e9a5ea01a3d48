// Fused dequantize-matmul for W8A8 and W4A8 on the int8 tensor cores
// (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernels w8a8_matmul and w4a8_matmul of
// src/repro/kernels/quant_matmul.py:
//
//   out[m, n] = (float(sum_k a_q[m, k] * w_q[k, n]) * a_scale[m]) * w_scale[n]
//
// a_q (M, K) int8 row-major, a_scale (M,) f32, w (K, N) int8 or, for W4,
// (K, N/2) uint8 holding two signed nibbles per byte (low nibble = even
// column), w_scale (N,) f32, out (M, N) f32. The f32-A entries take x
// (M, K) f32 instead of a_q and a_scale and quantize each row in the block
// first, with the act-quant kernel's arithmetic (act_quant.cuh): the A8
// step and the product are one launch.
//
// What bounds it on the H100: at the serving shapes (M = 256 rows, K <= 80,
// N <= 192) the bytes, dominated by the f32 output, take ~0.07 us and the
// integer work far less; what a call pays for is the launch and the chain of
// dependent steps inside a block (load, stage, product, store).
//
// What the first design (PR 11) lost time to: 64x64 tiles (12 blocks for
// 132 SMs at N = 192, 4 at N = 32), both tiles staged one byte per thread
// step with strided single-byte stores into the transposed weight tile,
// __dp4a instead of the tensor cores, two barriers per 32-wide K step, and a
// separate act-quant launch in front of every product on the SO3 path.
//
// Design:
// * 16x64 output tiles, one block of 4 warps each; warp w owns columns
//   16w..16w+15 as two m16n8 fragments of mma.sync m16n8k32 s8 x s8 -> s32
//   (48 blocks at M = 256, N = 192; 16 at N = 64 or 32). The accumulation is
//   exact int32, so any summation order matches the plain version.
// * The K of a tile is staged in one step of up to 128 bytes, zero-padded
//   to a multiple of 32 in shared memory; larger K loops over such steps.
//   Shared rows are 128 + 16 bytes apart (a stride of 4 mod 8 words), which
//   makes every fragment read conflict-free.
// * A (int8 entries): 16-byte loads when K % 16 == 0, one row per lane of
//   each 8-lane phase, so the 16-byte stores are conflict-free; else a
//   masked byte path. A (f32-A entries): 8 lanes per row, float4 loads
//   (masked when K % 4 != 0), abs-max by three shuffles, the scale, and the
//   codes packed four to a word, from registers, in one read of the row.
//   One row per thread keeps each thread's chain of shuffles and IEEE
//   divisions short: the prologue's latency, not its work, is what it
//   adds to the call.
// * W wants k contiguous per column but is (K, N) row-major, so each thread
//   loads 4 k-rows x 4 columns (4 bytes of W8, 2 bytes of packed W4 whose
//   nibbles are sign-extended with __vsub4), transposes the 4x4 bytes with
//   __byte_perm and stores four k-contiguous words; lanes take 8 k-quads x
//   4 column quads and the odd column pairs store in a rotated order, so the
//   stores are conflict-free too (kernels/quant_matmul.py's staging model
//   holds both layouts and their banks on the CPU). The first step's W
//   loads are issued before anything else, so they fly during the A step.
// * Epilogue in the plain version's order,
//   __fmul_rn(__fmul_rn(__int2float_rn(acc), a_scale), w_scale), adjacent
//   column pairs stored as float2; ragged M, N and K are masked in the
//   kernel, so callers pass unpadded operands.
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int BM = 16;           // rows per block: one m16 fragment
constexpr int BN = 64;           // columns per block: 4 warps x 2 n8
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 128;          // K bytes per staging step
constexpr int LPR = THREADS / BM;   // lanes per row in the f32-A prologue
constexpr int CPL = KC / 4 / LPR;   // float4s per lane and staging step
constexpr int SW = KC / 4 + 4;   // shared row stride in words (4 mod 8)

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four signed nibbles (low first) of a 16-bit word -> four int8 bytes
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t p) {
    const uint32_t x = (p & 0xFu) | ((p & 0xF0u) << 4) | ((p & 0xF00u) << 8)
                       | ((p & 0xF000u) << 12);
    return __vsub4(x ^ 0x08080808u, 0x08080808u);
}

// r[i] = the bytes of columns gn..gn+3 in k-row gk + i, as stored (W4: two
// packed bytes); zero outside K and N
template <bool W4>
__device__ __forceinline__ void load_w_rows(const uint8_t* __restrict__ w,
                                            int N, int K, int gk, int gn,
                                            bool fast, uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = gk + i;
        uint32_t word = 0;
        if (k < K && gn < N) {
            if (W4) {
                const uint8_t* row = w + (size_t)k * (N >> 1) + (gn >> 1);
                if (fast) {
                    word = *reinterpret_cast<const uint16_t*>(row);
                } else {
                    word = row[0];
                    if (gn + 2 < N) word |= (uint32_t)row[1] << 8;
                }
            } else {
                const uint8_t* row = w + (size_t)k * N + gn;
                if (fast) {
                    word = *reinterpret_cast<const uint32_t*>(row);
                } else {
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        if (gn + c < N) word |= (uint32_t)row[c] << (8 * c);
                }
            }
        }
        r[i] = word;
    }
}

// 4x4 byte transpose: c[j] holds byte j of r[0..3]
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    c[0] = __byte_perm(t0, t2, 0x5410);
    c[1] = __byte_perm(t0, t2, 0x7632);
    c[2] = __byte_perm(t1, t3, 0x5410);
    c[3] = __byte_perm(t1, t3, 0x7632);
}

// W's step [k0, k0 + kp) in units of 4 column quads x 8 k-quads, a warp's
// units warp, warp + 4, ...: lane -> column quad 4 (u % 4) + lane / 8,
// k-quad 8 (u / 4) + lane % 8. The loads go into registers first, so that
// they are in flight while the A step is staged.
constexpr int WU = (BN / 16) * (KC / 32) / WARPS;   // units per warp

__device__ __forceinline__ int w_units(int kp) { return 4 * (kp / 32); }

template <bool W4>
__device__ __forceinline__ void load_w_step(uint32_t (&wr)[WU][4],
                                            const uint8_t* __restrict__ w,
                                            int N, int K, int n0, int k0,
                                            int kp, bool vec_w, int warp,
                                            int lane) {
#pragma unroll
    for (int i = 0; i < WU; ++i) {
        const int u = warp + WARPS * i;
        if (u >= w_units(kp)) break;
        const int nq = 4 * (u & 3) + (lane >> 3);
        const int kq = 8 * (u >> 2) + (lane & 7);
        load_w_rows<W4>(w, N, K, k0 + 4 * kq, n0 + 4 * nq, vec_w, wr[i]);
    }
}

// ... then each unit is sign-extended (W4), transposed and stored as four
// k-contiguous words Ws[n][k / 4]; lanes 16..31 (odd column pairs) store
// in a rotated order, which with SW == 4 mod 8 makes every store
// conflict-free
template <bool W4>
__device__ __forceinline__ void store_w_step(uint32_t (*Ws)[SW],
                                             uint32_t (&wr)[WU][4], int kp,
                                             int warp, int lane) {
    const int h = lane >> 4;
#pragma unroll
    for (int i = 0; i < WU; ++i) {
        const int u = warp + WARPS * i;
        if (u >= w_units(kp)) break;
        const int nq = 4 * (u & 3) + (lane >> 3);
        const int kq = 8 * (u >> 2) + (lane & 7);
        if (W4) {
#pragma unroll
            for (int r = 0; r < 4; ++r) wr[i][r] = sext_nibbles(wr[i][r]);
        }
        uint32_t c[4];
        transpose4(wr[i], c);
#pragma unroll
        for (int s = 0; s < 4; ++s)
            Ws[4 * nq + ((s + 2 * h) & 3)][kq] = h ? c[(s + 2) & 3] : c[s];
    }
}

// a_q's step [k0, k0 + kp) into As[m][k / 4]
__device__ __forceinline__ void stage_a_int8(uint32_t (*As)[SW],
                                             const int8_t* __restrict__ a,
                                             int M, int K, int m0, int k0,
                                             int kp, bool vec_a) {
    const int units = BM * (kp / 16);  // 16-byte chunks, row fastest
    for (int u = threadIdx.x; u < units; u += THREADS) {
        const int row = u % BM, ch = u / BM;
        const int gm = m0 + row, gk = k0 + 16 * ch;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < M && gk < K) {
            const int8_t* src = a + (size_t)gm * K + gk;
            if (vec_a) {
                v = *reinterpret_cast<const uint4*>(src);
            } else {
                uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    if (gk + i < K)
                        b[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
                v = make_uint4(b[0], b[1], b[2], b[3]);
            }
        }
        *reinterpret_cast<uint4*>(&As[row][4 * ch]) = v;
    }
}

// four floats of row x at column k (zeros past K)
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x, int k,
                                          int K, bool vec) {
    if (vec && k < K) return *reinterpret_cast<const float4*>(x + k);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < K) v.x = x[k];
    if (k + 1 < K) v.y = x[k + 1];
    if (k + 2 < K) v.z = x[k + 2];
    if (k + 3 < K) v.w = x[k + 3];
    return v;
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
    return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
                 fabsf(v.w));
}

__device__ __forceinline__ uint32_t codes4(float4 v, float s) {
    return ((uint32_t)a8::code(v.x, s) & 0xFFu)
           | (((uint32_t)a8::code(v.y, s) & 0xFFu) << 8)
           | (((uint32_t)a8::code(v.z, s) & 0xFFu) << 16)
           | (((uint32_t)a8::code(v.w, s) & 0xFFu) << 24);
}

template <bool W4, bool F32A>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const void* __restrict__ a, const float* __restrict__ a_scale,
           const uint8_t* __restrict__ w, const float* __restrict__ w_scale,
           float* __restrict__ out, int M, int N, int K, bool vec_a,
           bool vec_w, bool vec_out) {
    __shared__ __align__(16) uint32_t As[BM][SW];
    __shared__ __align__(16) uint32_t Ws[BN][SW];
    __shared__ float sa[BM];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

    // the epilogue's column scales, loaded while the tiles stage
    float ws[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int col = n0 + 16 * warp + 8 * f + 2 * t + c;
            ws[f][c] = col < N ? w_scale[col] : 0.0f;
        }

    // the first step of W, in flight during the A8 prologue
    uint32_t wr[WU][4];
    load_w_step<W4>(wr, w, N, K, n0, 0, min(KC, (K + 31) & ~31), vec_w, warp,
                    lane);

    // f32-A prologue: 8 lanes per row (one row per thread), each lane
    // float4s 4 l, 4 (l + 8), ... of the row; the first step's values stay
    // in registers for its staging
    const int xrow = threadIdx.x / LPR, xl = threadIdx.x % LPR;
    const float* xr = static_cast<const float*>(a) + (size_t)(m0 + xrow) * K;
    const bool xlive = m0 + xrow < M;
    float4 x0[CPL];
    float xs = 0.0f;
    if (F32A) {
        float amax = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
            x0[j] = xlive ? load_x4(xr, 4 * (xl + LPR * j), K, vec_a)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < CPL; ++j) amax = abs_max4(amax, x0[j]);
        if (xlive)
            for (int k = KC + 4 * xl; k < K; k += 4 * LPR)
                amax = abs_max4(amax, load_x4(xr, k, K, vec_a));
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        xs = a8::row_scale<float>(amax);
        if (xl == 0) sa[xrow] = xs;
    } else if (threadIdx.x < BM) {
        const int gm = m0 + threadIdx.x;
        sa[threadIdx.x] = gm < M ? a_scale[gm] : 0.0f;
    }

    int acc[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][i] = 0;

    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kp = min(KC, (K - k0 + 31) & ~31);
        if (k0 > 0) {
            __syncthreads();           // the last step's fragments are read
            load_w_step<W4>(wr, w, N, K, n0, k0, kp, vec_w, warp, lane);
        }
        if (F32A) {
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int c = xl + LPR * j;          // word of the step
                if (4 * c >= kp) continue;
                float4 v = x0[j];
                if (k0 > 0)
                    v = xlive ? load_x4(xr, k0 + 4 * c, K, vec_a)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
                As[xrow][c] = codes4(v, xs);
            }
        } else {
            stage_a_int8(As, static_cast<const int8_t*>(a), M, K, m0, k0, kp,
                         vec_a);
        }
        store_w_step<W4>(Ws, wr, kp, warp, lane);
        __syncthreads();

#pragma unroll 4
        for (int ks = 0; ks < kp / 32; ++ks) {
            const int kw = 8 * ks + t;
            const uint32_t af[4] = {As[g][kw], As[g + 8][kw], As[g][kw + 4],
                                    As[g + 8][kw + 4]};
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                const int n = 16 * warp + 8 * f + g;
                mma_s8(acc[f], af, Ws[n][kw], Ws[n][kw + 4]);
            }
        }
    }
    if (K <= 0) __syncthreads();       // sa is written by other threads

    const float s_lo = sa[g], s_hi = sa[g + 8];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        const int col = n0 + 16 * warp + 8 * f + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int gm = m0 + g + 8 * h;
            if (gm >= M) continue;
            const float s = h ? s_hi : s_lo;
            const float o0 = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[f][2 * h]), s), ws[f][0]);
            const float o1 = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[f][2 * h + 1]), s), ws[f][1]);
            float* dst = out + (size_t)gm * N + col;
            if (vec_out && col + 1 < N) {
                *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
            } else {
                if (col < N) dst[0] = o0;
                if (col + 1 < N) dst[1] = o1;
            }
        }
    }
}

bool aligned(const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <bool W4, bool F32A>
int launch(const void* a, const void* a_scale, const void* w,
           const void* w_scale, void* out, int M, int N, int K, int device,
           void* stream) {
    if (M <= 0 || N <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const bool vec_a = F32A ? (K % 4 == 0 && aligned(a, 16))
                            : (K % 16 == 0 && aligned(a, 16));
    const bool vec_w = N % 4 == 0 && aligned(w, W4 ? 2 : 4);
    const bool vec_out = N % 2 == 0 && aligned(out, 8);
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    qmm_kernel<W4, F32A><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        a, (const float*)a_scale, (const uint8_t*)w, (const float*)w_scale,
        (float*)out, M, N, K, vec_a, vec_w, vec_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_qmm_w8a8(const void* a, const void* a_scale,
                              const void* w, const void* w_scale, void* out,
                              int M, int N, int K, int device, void* stream) {
    return launch<false, false>(a, a_scale, w, w_scale, out, M, N, K, device,
                                stream);
}

extern "C" int repro_qmm_w4a8(const void* a, const void* a_scale,
                              const void* w_packed, const void* w_scale,
                              void* out, int M, int N, int K, int device,
                              void* stream) {
    return launch<true, false>(a, a_scale, w_packed, w_scale, out, M, N, K,
                               device, stream);
}

extern "C" int repro_qmm_w8a8_f32a(const void* x, const void* w,
                                   const void* w_scale, void* out, int M,
                                   int N, int K, int device, void* stream) {
    return launch<false, true>(x, nullptr, w, w_scale, out, M, N, K, device,
                               stream);
}

extern "C" int repro_qmm_w4a8_f32a(const void* x, const void* w_packed,
                                   const void* w_scale, void* out, int M,
                                   int N, int K, int device, void* stream) {
    return launch<true, true>(x, nullptr, w_packed, w_scale, out, M, N, K,
                              device, stream);
}
