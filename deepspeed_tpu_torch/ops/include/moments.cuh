// Optimizer moments stored as fp32 or bf16, read and written four at a
// time, for the Adam and LAMB kernels (fused_adam.cu, fused_lamb.cu).
//
// The math always runs in fp32: widen() is exact, and narrow() rounds to
// nearest even (__float2bfloat16_rn), as the JAX package's
// .astype(jnp.bfloat16) and PyTorch's cast do. load4 / store4 take the
// index of the first of four elements, which must be a multiple of 4 with
// the pointer aligned to four elements (16 bytes fp32, 8 bytes bf16).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 load4(const float* x, int64_t i) {
  return *reinterpret_cast<const float4*>(x + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, int64_t i) {
  const Bf16x4 t = *reinterpret_cast<const Bf16x4*>(x + i);
  const float2 lo = __bfloat1622float2(t.lo), hi = __bfloat1622float2(t.hi);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* x, int64_t i, float4 val) {
  *reinterpret_cast<float4*>(x + i) = val;
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t i,
                                       float4 val) {
  *reinterpret_cast<Bf16x4*>(x + i) =
      Bf16x4{__floats2bfloat162_rn(val.x, val.y),
             __floats2bfloat162_rn(val.z, val.w)};
}
