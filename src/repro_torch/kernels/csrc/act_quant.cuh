// The A8 step's arithmetic, shared by the act-quant kernel (act_quant.cu)
// and the f32-A entries of the quantized matmul (quant_matmul.cu), which
// quantize their activation rows in the block before the product:
//
//   scale = max(max_k |x[k]|, 1e-8) / 127
//   q[k]  = clip(round_half_even(x[k] / scale), -127, 127)
//
// For float32 input every operation is the plain version's float32
// operation (fmaxf, __fdiv_rn, rintf), so codes and scales match
// kernels/ref.py's act_quant_ref bit for bit. For bfloat16 input the scale
// follows the LM decode's KV write (src/repro/models/lm/attention.py), which
// computes it in the activation dtype: the floor is 1e-8 rounded to bf16, the
// max and the division by 127 are taken in bf16 (the float32 quotient rounded
// once to bf16, as XLA's and PyTorch's CPU bf16 division do), and only then
// is the scale widened to float32. The codes then divide in float32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace a8 {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float row_scale(float amax);

template <>
__device__ __forceinline__ float row_scale<float>(float amax) {
    return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

template <>
__device__ __forceinline__ float row_scale<__nv_bfloat16>(float amax) {
    const float floor = __bfloat162float(__float2bfloat16_rn(1e-8f));
    return __bfloat162float(
        __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, floor), 127.0f)));
}

// the int8 code of x under the row's scale s. A zero dividend sends the
// IEEE division to its slow path (a padded atom's all-zero row made the
// f32-A matmul ~1 us slower on an H100); its code is 0 whatever s is, so
// it divides 1 instead and the result is dropped.
__device__ __forceinline__ int code(float x, float s) {
    const float r = rintf(__fdiv_rn(x == 0.0f ? 1.0f : x, s));
    return x == 0.0f ? 0 : (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

}  // namespace a8
