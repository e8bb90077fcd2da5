// Fused Adam/AdamW over one flat fp32 partition, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/adam/pallas_adam.py::
// _fused_adam_flat (pallas_call at :53, body _adam_kernel): the moments, the
// bias-corrected update, decoupled (AdamW) or L2 weight decay, and the
// parameter update, in place. The TPU kernel walks one flat [rows, 128]
// array per leaf; the engine's flat master buffer makes this one launch per
// optimizer step.
//
//   p, m, v   (n,) fp32, updated in place
//   g         (n,) fp32, read
//   scalars   lr, beta1, beta2, eps, weight_decay, bc1 = 1 - beta1^step and
//             bc2 = 1 - beta2^step, all fp32 (the caller computes bc1/bc2 in
//             fp32, as fused_adam.py does with jnp.power on f32)
//
// Every operation rounds once, in the TPU kernel's order: the __f*_rn
// intrinsics keep nvcc from contracting a multiply and an add into one FMA,
// so the result equals the plain PyTorch version (fused_adam_reference)
// operation for operation. The one deliberate FMA is the L2 mode's decayed
// gradient g + weight_decay * p, rounded once: XLA's CPU compiler fuses the
// TPU kernel's line so (the interpret-mode reference), as nvcc does the same
// line of DeepSpeed's CUDA Adam; the plain version rounds it once too
// (fma_f32).
//
// Bound on the H100: bytes. Each element reads 4 fp32 and writes 3 (28 bytes)
// for about 20 operations, far below the card's ~20 fp32 operations per byte.
// What the design does about it: one pass over the buffers, 16-byte loads
// and stores where all four pointers allow them (a scalar pass otherwise, and
// for the tail past a multiple of 4), a grid-stride loop sized to the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct AdamScalars {
  float lr, beta1, beta2, eps, weight_decay, bc1, bc2;
  int adam_w_mode;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const AdamScalars& s) {
  if (!s.adam_w_mode) g = __fmaf_rn(s.weight_decay, p, g);
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(__fsub_rn(1.f, s.beta1), g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fsub_rn(1.f, s.beta2), __fmul_rn(g, g)));
  float update = __fdiv_rn(__fdiv_rn(m, s.bc1),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (s.adam_w_mode) update = __fadd_rn(update, __fmul_rn(s.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, update));
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ m, float* __restrict__ v, int64_t n,
                      int vectorized, AdamScalars s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t i = first; i < n4; i += stride) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, s);
      adam_one(pp.y, gg.y, mm.y, vv.y, s);
      adam_one(pp.z, gg.z, mm.z, vv.z, s);
      adam_one(pp.w, gg.w, mm.w, vv.w, s);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, s);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// vectorized: 1 when all four pointers are 16-byte aligned. Returns a
// cudaError_t; the kernel runs on `stream` without a sync.
extern "C" int fused_adam_launch(void* p, const void* g, void* m, void* v,
                                 int64_t n, int vectorized, float lr,
                                 float beta1, float beta2, float eps,
                                 float weight_decay, float bc1, float bc2,
                                 int adam_w_mode, int num_sms, void* stream) {
  if (n <= 0 || num_sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{lr, beta1, beta2, eps, weight_decay, bc1, bc2,
                      adam_w_mode};
  const int64_t work = vectorized ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(num_sms) * 8;  // 8 blocks per SM
  if (blocks > cap) blocks = cap;
  fused_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, vectorized, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
