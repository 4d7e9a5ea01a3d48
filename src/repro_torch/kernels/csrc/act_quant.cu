// Per-row abs-max int8 quantization, the A8 step (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel act_quant of src/repro/kernels/act_quant.py:
//
//   scale[m] = max(max_k |x[m, k]|, 1e-8) / 127
//   q[m, k]  = clip(round_half_even(x[m, k] / scale[m]), -127, 127)
//
// x (M, K) row-major, float32 or bfloat16; q (M, K) int8; scale (M,) f32.
// The arithmetic, bit for bit with kernels/ref.py's act_quant_ref in both
// input types, is in act_quant.cuh, which the f32-A entries of the
// quantized matmul share; this kernel serves the LM decode's KV write.
//
// Design: one warp per row. The warp reduces the row's abs-max with
// shuffles, then makes a second pass over the row (from L1/L2: the row was
// just read) that writes the codes; lane 0 writes the scale. Eight rows per
// 256-thread block.
//
// What bounds it on the H100: bytes. It reads each input element once from
// device memory and writes one byte per element plus four per row, and does
// a handful of operations per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

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

}  // namespace

extern "C" int repro_act_quant_f32(const void* x, void* q, void* scale,
                                   int M, int K, int device, void* stream) {
    return launch<float>(x, q, scale, M, K, device, stream);
}

extern "C" int repro_act_quant_bf16(const void* x, void* q, void* scale,
                                    int M, int K, int device, void* stream) {
    return launch<__nv_bfloat16>(x, q, scale, M, K, device, stream);
}
