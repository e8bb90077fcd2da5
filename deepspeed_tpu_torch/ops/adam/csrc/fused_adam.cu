// Fused Adam/AdamW over one flat fp32 partition, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/adam/pallas_adam.py::
// _fused_adam_flat (pallas_call at :53, body _adam_kernel): the moments, the
// bias-corrected update, decoupled (AdamW) or L2 weight decay, and the
// parameter update, in place. The TPU kernel walks one flat [rows, 128]
// array per leaf; the engine's flat master buffer makes this one launch per
// optimizer step.
//
//   p         (n,) fp32, updated in place
//   m, v      (n,) fp32 or bf16 (the moment storage), updated in place
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
// bf16 moments (the JAX package's moments_dtype="bf16", adam_update's XLA
// leaf): m and v are read as bf16, widened to fp32 (exact), updated in fp32,
// and rounded back to bf16 to nearest even (__float2bfloat16_rn, as
// .astype(bfloat16) and PyTorch's cast round). The parameter update uses the
// fp32 m' and v' before that rounding, as the reference leaf does.
//
// Bound on the H100: bytes. Each element reads 4 fp32 and writes 3 (28 bytes;
// 20 with bf16 moments) for about 20 operations, far below the card's ~20
// fp32 operations per byte.
// What the design does about it: one pass over the buffers, four elements a
// thread a round (16-byte loads and stores of p and g, 16 or 8 of m and v)
// where all four pointers allow them (a scalar pass otherwise, and for the
// tail past a multiple of 4), a grid-stride loop sized to the card; one
// template over the moment type, so bf16 storage is the same pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moments.cuh"

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

// MT: the moments' storage type (float or __nv_bfloat16).
template <typename MT>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                      MT* __restrict__ m, MT* __restrict__ v, int64_t n,
                      int vectorized, AdamScalars s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = first; i < n4; i += stride) {
      float4 pp = p4[i], mm = load4(m, 4 * i), vv = load4(v, 4 * i);
      const float4 gg = g4[i];
      adam_one(pp.x, gg.x, mm.x, vv.x, s);
      adam_one(pp.y, gg.y, mm.y, vv.y, s);
      adam_one(pp.z, gg.z, mm.z, vv.z, s);
      adam_one(pp.w, gg.w, mm.w, vv.w, s);
      p4[i] = pp;
      store4(m, 4 * i, mm);
      store4(v, 4 * i, vv);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float pp = p[i], mm = widen(m[i]), vv = widen(v[i]);
    adam_one(pp, g[i], mm, vv, s);
    p[i] = pp;
    narrow(mm, m + i);
    narrow(vv, v + i);
  }
}

template <typename MT>
void launch(void* p, const void* g, void* m, void* v, int64_t n,
            int vectorized, const AdamScalars& s, unsigned blocks,
            cudaStream_t stream) {
  fused_adam_kernel<MT><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<MT*>(m), static_cast<MT*>(v), n, vectorized, s);
}

}  // namespace

// vectorized: 1 when p and g are 16-byte aligned and m and v 4-element
// aligned; moments_bf16: 1 when m and v are bf16, 0 when fp32. Returns a
// cudaError_t; the kernel runs on `stream` without a sync.
extern "C" int fused_adam_launch(void* p, const void* g, void* m, void* v,
                                 int64_t n, int vectorized, int moments_bf16,
                                 float lr, float beta1, float beta2,
                                 float eps, float weight_decay, float bc1,
                                 float bc2, int adam_w_mode, int num_sms,
                                 void* stream) {
  if (n <= 0 || num_sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{lr, beta1, beta2, eps, weight_decay, bc1, bc2,
                      adam_w_mode};
  const int64_t work = vectorized ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(num_sms) * 8;  // 8 blocks per SM
  if (blocks > cap) blocks = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (moments_bf16)
    launch<__nv_bfloat16>(p, g, m, v, n, vectorized, s,
                          static_cast<unsigned>(blocks), st);
  else
    launch<float>(p, g, m, v, n, vectorized, s, static_cast<unsigned>(blocks),
                  st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
