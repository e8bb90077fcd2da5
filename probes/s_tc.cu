// S = Q K^T (fp32) for one (s, 64) bf16 Q and K through the mma.sync chain
// of the flash backward kernels' tc_abt (flash_attention.cu), so that
// kernel_probe.py can hold the tensor cores' order of summation against
// cuBLAS's fp32 product. A measuring aid, on no path of the package; s a
// multiple of 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "sm90_mma.cuh"

constexpr int D = 64, LD = D + 8;

__global__ void s_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, float* S,
                     int s) {
  __shared__ __align__(16) __nv_bfloat16 qs[16 * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[64 * LD];
  const int r0 = blockIdx.y * 16, c0 = blockIdx.x * 64, lane = threadIdx.x;
  for (int i = lane; i < 16 * D; i += 32)
    qs[(i / D) * LD + i % D] = q[(r0 + i / D) * D + i % D];
  for (int i = lane; i < 64 * D; i += 32)
    ks[(i / D) * LD + i % D] = k[(c0 + i / D) * D + i % D];
  __syncwarp();
  float c[8][4] = {};
  const int mat = lane >> 3, r8 = lane & 7;
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, qs + (lane & 15) * LD + kd + (lane >> 4) * 8);
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t bf[4];
      sm90::ldmatrix_x4(bf, ks + (nn * 16 + r8 + (mat >> 1) * 8) * LD + kd +
                                (mat & 1) * 8);
      sm90::mma16816<__nv_bfloat16>(c[2 * nn], af, bf[0], bf[1]);
      sm90::mma16816<__nv_bfloat16>(c[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
  const int g = lane >> 2, tg = lane & 3;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e)
      S[(r0 + g + (e >> 1) * 8) * (int64_t)s + c0 + j * 8 + 2 * tg + (e & 1)] =
          c[j][e];
}

extern "C" int s_tc_launch(const void* q, const void* k, void* S, int s) {
  s_tc<<<dim3(s / 64, s / 16), 32>>>(static_cast<const __nv_bfloat16*>(q),
                                      static_cast<const __nv_bfloat16*>(k),
                                      static_cast<float*>(S), s);
  return static_cast<int>(cudaGetLastError());
}
