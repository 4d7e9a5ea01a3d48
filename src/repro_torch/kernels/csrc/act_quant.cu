// Per-row abs-max int8 quantization, the A8 step (Hopper, sm_90a), and the
// LM decode's int8 KV write built on it.
//
// Replaces the Pallas TPU kernel act_quant of src/repro/kernels/act_quant.py:
//
//   scale[m] = max(max_k |x[m, k]|, 1e-8) / 127
//   q[m, k]  = clip(round_half_even(x[m, k] / scale[m]), -127, 127)
//
// The arithmetic, bit for bit with kernels/ref.py's act_quant_ref in both
// input types, is in act_quant.cuh, which the f32-A entries of the
// quantized matmul share. Two kernels here:
//
// act_quant_kernel, the TPU kernel's own contract: x (M, K) row-major,
// float32 or bfloat16; q (M, K) int8; scale (M,) f32. One warp per row: a
// shuffle reduction of the abs-max, then a second pass over the row (from
// L1/L2: it was just read) that writes the codes; lane 0 writes the scale.
// Eight rows per 256-thread block. No main path runs it.
//
// kv_append_kernel, the LM decode's whole KV write (the JAX decode's KV
// quantization and its four dynamic_update_index_in_dim, one launch per
// layer): for every batch row b, effective head h and tensor K|V it
// quantizes the new token's row new[b, h / replicate] as above and stores
// the codes at q[b, h, cur, :] and the scale at s[b, h, cur] of the cache.
// The position cur is a host int, or (cur_ptr non-null) an int32 the
// kernel reads from device memory, so a captured step serves every
// position; a device position is clamped to [0, S), as the JAX decode's
// dynamic_update_index_in_dim clamps it.
// The new rows come as strided views of the projection (last dim
// contiguous); the replicated heads are found by index, so nothing is
// stacked or repeated first. One warp per (b, h, K|V) row, two warps (the K
// and V rows of one (b, h)) per 64-thread block, so the decode's 32 rows
// spread over 16 SMs. Each lane holds EPL consecutive elements in
// registers (2 at head_dim 8 and 64, 4 at 128; four lanes at 8): one
// vector load, the shuffle max, the scale, the codes from the registers,
// one 16- or 32-bit store per lane, and one scale store by lane 0.
//
// What bounds them on the H100: bytes (one read of each input element, one
// byte per code and four per scale written, a handful of operations per
// element); at the serving shapes (the KV write reads 4 KB and writes
// ~2.2 KB per layer) the launch itself takes far longer than that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int KV_WARPS = 2;            // the K and V rows of one (b, h)

template <typename T>
__global__ void __launch_bounds__(THREADS)
act_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale, int M, int K) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= M) return;
    const T* xr = x + (size_t)row * K;

    float amax = 0.0f;
    for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(a8::load(xr + k)));
    amax = a8::warp_max(amax);

    const float s = a8::row_scale<T>(amax);
    int8_t* qr = q + (size_t)row * K;
    for (int k = lane; k < K; k += 32)
        qr[k] = (int8_t)a8::code(a8::load(xr + k), s);
    if (lane == 0) scale[row] = s;
}

template <typename T>
int launch(const void* x, void* q, void* scale, int M, int K, int device,
           void* stream) {
    if (M <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    act_quant_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (int8_t*)q, (float*)scale, M, K);
    return (int)cudaGetLastError();
}

// EPL consecutive elements of a row, widened to float, in one vector load
template <typename T, int EPL>
__device__ __forceinline__ void load_lane(const T* p, float (&v)[EPL]);

template <>
__device__ __forceinline__ void load_lane<float, 2>(const float* p,
                                                    float (&v)[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
}

template <>
__device__ __forceinline__ void load_lane<float, 4>(const float* p,
                                                    float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
}

template <>
__device__ __forceinline__ void load_lane<__nv_bfloat16, 2>(
        const __nv_bfloat16* p, float (&v)[2]) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
}

template <>
__device__ __forceinline__ void load_lane<__nv_bfloat16, 4>(
        const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
}

// EPL int8 codes in one 16- or 32-bit store
template <int EPL>
__device__ __forceinline__ void store_codes(int8_t* p, const int (&c)[EPL]);

template <>
__device__ __forceinline__ void store_codes<2>(int8_t* p, const int (&c)[2]) {
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)((c[0] & 0xff) | ((c[1] & 0xff) << 8));
}

template <>
__device__ __forceinline__ void store_codes<4>(int8_t* p, const int (&c)[4]) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)((c[0] & 0xff) | ((c[1] & 0xff) << 8) |
                   ((c[2] & 0xff) << 16) | ((c[3] & 0xff) << 24));
}

template <typename T, int HD>
__global__ void __launch_bounds__(KV_WARPS * 32)
kv_append_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                 int k_sb, int k_sh, int v_sb, int v_sh,
                 int8_t* __restrict__ k_q, float* __restrict__ k_s,
                 int8_t* __restrict__ v_q, float* __restrict__ v_s,
                 int H, int rep, int S, const int* __restrict__ cur_ptr,
                 int cur) {
    constexpr int EPL = HD == 128 ? 4 : 2;
    constexpr int LANES = HD / EPL;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * KV_WARPS + (threadIdx.x >> 5);
    const int is_v = row & 1, bh = row >> 1;
    const int b = bh / H, src = (bh % H) / rep;
    const T* x = is_v ? v_new + (size_t)b * v_sb + (size_t)src * v_sh
                      : k_new + (size_t)b * k_sb + (size_t)src * k_sh;

    float v[EPL];
    float amax = 0.0f;
    if (lane < LANES) {
        load_lane<T, EPL>(x + lane * EPL, v);
#pragma unroll
        for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = a8::warp_max(amax);
    const float s = a8::row_scale<T>(amax);

    if (cur_ptr != nullptr) cur = min(max(__ldg(cur_ptr), 0), S - 1);
    const size_t slot = (size_t)bh * S + cur;
    if (lane < LANES) {
        int c[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) c[e] = a8::code(v[e], s);
        store_codes<EPL>((is_v ? v_q : k_q) + slot * HD + lane * EPL, c);
    }
    if (lane == 0) (is_v ? v_s : k_s)[slot] = s;
}

template <typename T, int HD>
int launch_kv_append(const void* k_new, const void* v_new, int k_sb,
                     int k_sh, int v_sb, int v_sh, void* k_q, void* k_s,
                     void* v_q, void* v_s, int B, int H, int rep, int S,
                     const void* cur_ptr, int cur, void* stream) {
    // one block per (b, h): its K row and its V row
    kv_append_kernel<T, HD><<<B * H, KV_WARPS * 32, 0,
                              (cudaStream_t)stream>>>(
        (const T*)k_new, (const T*)v_new, k_sb, k_sh, v_sb, v_sh,
        (int8_t*)k_q, (float*)k_s, (int8_t*)v_q, (float*)v_s, H, rep, S,
        (const int*)cur_ptr, cur);
    return (int)cudaGetLastError();
}

template <typename T>
int kv_append(const void* k_new, const void* v_new, int k_sb, int k_sh,
              int v_sb, int v_sh, void* k_q, void* k_s, void* v_q,
              void* v_s, int B, int H, int rep, int S, int hd,
              const void* cur_ptr, int cur, int device, void* stream) {
    if (B <= 0 || H <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    switch (hd) {
        case 8:
            return launch_kv_append<T, 8>(k_new, v_new, k_sb, k_sh, v_sb,
                                          v_sh, k_q, k_s, v_q, v_s, B, H,
                                          rep, S, cur_ptr, cur, stream);
        case 64:
            return launch_kv_append<T, 64>(k_new, v_new, k_sb, k_sh, v_sb,
                                           v_sh, k_q, k_s, v_q, v_s, B, H,
                                           rep, S, cur_ptr, cur, stream);
        case 128:
            return launch_kv_append<T, 128>(k_new, v_new, k_sb, k_sh, v_sb,
                                            v_sh, k_q, k_s, v_q, v_s, B, H,
                                            rep, S, cur_ptr, cur, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int repro_act_quant_f32(const void* x, void* q, void* scale,
                                   int M, int K, int device, void* stream) {
    return launch<float>(x, q, scale, M, K, device, stream);
}

extern "C" int repro_act_quant_bf16(const void* x, void* q, void* scale,
                                    int M, int K, int device, void* stream) {
    return launch<__nv_bfloat16>(x, q, scale, M, K, device, stream);
}

extern "C" int repro_kv_append_int8_f32(
        const void* k_new, const void* v_new, int k_sb, int k_sh, int v_sb,
        int v_sh, void* k_q, void* k_s, void* v_q, void* v_s, int B, int H,
        int rep, int S, int hd, const void* cur_ptr, int cur, int device,
        void* stream) {
    return kv_append<float>(k_new, v_new, k_sb, k_sh, v_sb, v_sh, k_q, k_s,
                            v_q, v_s, B, H, rep, S, hd, cur_ptr, cur, device,
                            stream);
}

extern "C" int repro_kv_append_int8_bf16(
        const void* k_new, const void* v_new, int k_sb, int k_sh, int v_sb,
        int v_sh, void* k_q, void* k_s, void* v_q, void* v_s, int B, int H,
        int rep, int S, int hd, const void* cur_ptr, int cur, int device,
        void* stream) {
    return kv_append<__nv_bfloat16>(k_new, v_new, k_sb, k_sh, v_sb, v_sh,
                                    k_q, k_s, v_q, v_s, B, H, rep, S, hd,
                                    cur_ptr, cur, device, stream);
}
