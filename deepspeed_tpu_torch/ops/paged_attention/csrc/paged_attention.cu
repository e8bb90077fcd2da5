// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py::
// paged_attention (kernel body _kernel): attention of the s new queries of
// every slot over that slot's keys in the paged KV pool, read through the
// slot's page table, with an online softmax in fp32.
//
//   q        (b, s, h, dh)                 float / bf16 / fp16
//   k_pool,
//   v_pool   (pages + 1, L, h, ps, dh)     same type as q; page 0 is garbage
//   page_tables (b, max_pages) int32; positions, valid_lens (b,) int32
//   out      (b, s, h, dh)                 fp32
//
// Contract (the same as the TPU kernel and the plain gather-back version):
// q is pre-scaled by 1/sqrt(dh); key k_pos counts for query q_pos = pos + j
// only if k_pos <= q_pos and k_pos <= live = pos + valid_len - 1; a masked
// score is -1e30, never -inf; a row whose sum is 0 divides by 1.
//
// Bound on the H100: bytes. A (slot, head) must read the K and V rows of its
// live keys, 2 * (live + 1) * dh elements, once. At s = 1 that is about one
// fp32 operation per byte read, far below the ~20 per byte at which the
// card's fp32 rate (67 TFLOP/s over 3.35 TB/s) would become the limit.
// What the design does about it:
//   * each live K/V row is read from device memory exactly once, with
//     coalesced 16-byte loads: the (ps, dh) rows of one (page, layer, head)
//     are contiguous in the pool, so a 64-key tile is a few contiguous runs;
//   * pages are read in place through the page table: nothing is gathered
//     into a contiguous copy in device memory first;
//   * the walk stops at the last live key, not at the end of its page, so
//     keys past the live window (stale, recycled or NaN-poisoned rows and
//     the garbage page) are never loaded at all.
// One block of 128 threads serves one (slot, head). A tile of 64 keys is
// staged in shared memory as fp32; 2 queries x 64 keys of scores are taken
// at a time, one per thread. Left for later work: overlapping the next
// tile's loads with this tile's math (cp.async or TMA double-buffering, the
// counterpart of the TPU kernel's make_async_copy pair), tensor-core math,
// and splitting a long context over several blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 64;                          // keys per staged tile
constexpr int kQueryTile = kThreads / kKeyTile;       // queries per pass
constexpr int kWarpsPerQuery = kKeyTile / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxAcc = kQueryTile * kMaxHeadDim / kThreads;
constexpr int kLoadBatch = 4;                         // loads in flight
                                                      // per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t shared_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(kKeyTile) * (dh + 1) +
                          static_cast<size_t>(kKeyTile) * dh +
                          static_cast<size_t>(kQueryTile) * dh +
                          static_cast<size_t>(kQueryTile) * kKeyTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ page_tables,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ valid_lens, float* __restrict__ out, int s,
    int h, int dh, int page_size, int max_pages, int num_layers,
    int layer_idx, float sm_scale) {
  extern __shared__ float smem[];
  const int kstride = dh + 1;  // padded rows: conflict-free per-key reads
  float* k_tile = smem;                              // [kKeyTile][dh + 1]
  float* v_tile = k_tile + kKeyTile * kstride;       // [kKeyTile][dh]
  float* q_tile = v_tile + kKeyTile * dh;            // [kQueryTile][dh]
  float* p_tile = q_tile + kQueryTile * dh;          // [kQueryTile][kKeyTile]
  __shared__ float red_max[kThreads / 32];
  __shared__ float red_sum[kThreads / 32];
  __shared__ float m_run[kQueryTile];
  __shared__ float l_run[kQueryTile];

  const int head = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int pos = positions[slot];
  const int live = pos + valid_lens[slot] - 1;  // last live absolute position
  const int n_keys = min(max(live + 1, 0), max_pages * page_size);
  const int32_t* pt = page_tables + static_cast<int64_t>(slot) * max_pages;
  // 64-bit offsets: the pool passes 2^31 elements at larger configurations
  const int64_t head_elems = static_cast<int64_t>(page_size) * dh;
  const int64_t page_elems = static_cast<int64_t>(num_layers) * h * head_elems;
  const int64_t tile_base =
      (static_cast<int64_t>(layer_idx) * h + head) * head_elems;

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vecs_per_row = dh / kVec;

  for (int q0 = 0; q0 < s; q0 += kQueryTile) {
    for (int i = tid; i < kQueryTile * dh; i += kThreads) {
      const int j = q0 + i / dh;
      q_tile[i] =
          j < s ? to_float(q[((static_cast<int64_t>(slot) * s + j) * h + head) *
                                 dh + i % dh]) * sm_scale
                : 0.f;
    }
    if (tid < kQueryTile) {
      m_run[tid] = kNegInf;
      l_run[tid] = 0.f;
    }
    float acc[kMaxAcc];
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

    for (int k0 = 0; k0 < n_keys; k0 += kKeyTile) {
      const int kt = min(kKeyTile, n_keys - k0);
      const int n_vecs = kt * vecs_per_row;
      __syncthreads();  // the previous tile's readers are done
      // each thread issues kLoadBatch K and V loads before it waits on
      // any of them: one memory round trip per tile at d_head 64 in bf16
      for (int base = tid; base < n_vecs; base += kThreads * kLoadBatch) {
        uint4 kraw[kLoadBatch];
        uint4 vraw[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int i = base + u * kThreads;
          if (i < n_vecs) {
            const int key = k0 + i / vecs_per_row;
            const int64_t src =
                static_cast<int64_t>(pt[key / page_size]) * page_elems +
                tile_base + static_cast<int64_t>(key % page_size) * dh +
                (i % vecs_per_row) * kVec;
            kraw[u] = *reinterpret_cast<const uint4*>(k_pool + src);
            vraw[u] = *reinterpret_cast<const uint4*>(v_pool + src);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int i = base + u * kThreads;
          if (i < n_vecs) {
            const int r = i / vecs_per_row;
            const int c = (i % vecs_per_row) * kVec;
            const T* kv = reinterpret_cast<const T*>(&kraw[u]);
            const T* vv = reinterpret_cast<const T*>(&vraw[u]);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              k_tile[r * kstride + c + e] = to_float(kv[e]);
              v_tile[r * dh + c + e] = to_float(vv[e]);
            }
          }
        }
      }
      __syncthreads();

      // one (query, key) score per thread
      const int qi = tid / kKeyTile;
      const int kk = tid % kKeyTile;
      const int j = q0 + qi;
      const bool present = kk < kt && j < s;
      float score = kNegInf;
      if (present) {
        const float* kr = k_tile + kk * kstride;
        const float* qr = q_tile + qi * dh;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int k_pos = k0 + kk;
        score = (k_pos <= pos + j && k_pos <= live) ? dot : kNegInf;
      }
      const float wmax = warp_max(score);
      if (lane == 0) red_max[warp] = wmax;
      __syncthreads();

      float m_new[kQueryTile];
      float corr[kQueryTile];
#pragma unroll
      for (int t = 0; t < kQueryTile; ++t) {
        float mt = red_max[t * kWarpsPerQuery];
#pragma unroll
        for (int w = 1; w < kWarpsPerQuery; ++w)
          mt = fmaxf(mt, red_max[t * kWarpsPerQuery + w]);
        m_new[t] = fmaxf(m_run[t], mt);
        corr[t] = expf(m_run[t] - m_new[t]);
      }
      const float p = present ? expf(score - m_new[qi]) : 0.f;
      p_tile[qi * kKeyTile + kk] = p;
      const float wsum = warp_sum(p);
      if (lane == 0) red_sum[warp] = wsum;
      __syncthreads();

      // acc = acc * corr + P @ V, one (query, d) pair per slot of acc
#pragma unroll
      for (int r = 0; r < kMaxAcc; ++r) {
        const int i = tid + r * kThreads;
        if (i < kQueryTile * dh) {
          const int qa = i / dh;
          const int d = i % dh;
          const float* pr = p_tile + qa * kKeyTile;
          float pv = 0.f;
          for (int t = 0; t < kt; ++t) pv = fmaf(pr[t], v_tile[t * dh + d], pv);
          acc[r] = acc[r] * corr[qa] + pv;
        }
      }
      if (tid < kQueryTile) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpsPerQuery; ++w)
          sum += red_sum[tid * kWarpsPerQuery + w];
        l_run[tid] = l_run[tid] * corr[tid] + sum;
        m_run[tid] = m_new[tid];
      }
    }
    __syncthreads();  // the final l_run is visible

#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int i = tid + r * kThreads;
      if (i < kQueryTile * dh) {
        const int qa = i / dh;
        const int j = q0 + qa;
        if (j < s) {
          const float l = l_run[qa];
          out[((static_cast<int64_t>(slot) * s + j) * h + head) * dh + i % dh] =
              acc[r] / (l == 0.f ? 1.f : l);
        }
      }
    }
    __syncthreads();  // before the next pass rewrites q_tile, m_run, l_run
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_tables, const void* positions,
                   const void* valid_lens, void* out, int b, int s, int h,
                   int dh, int page_size, int max_pages, int num_layers,
                   int layer_idx, float sm_scale, cudaStream_t stream) {
  if (dh % (16 / static_cast<int>(sizeof(T))) != 0) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(h, b);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_tables),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(valid_lens), static_cast<float*>(out), s, h,
      dh, page_size, max_pages, num_layers, layer_idx, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* positions, const void* valid_lens,
    void* out, int b, int s, int h, int dh, int page_size, int max_pages,
    int num_layers, int layer_idx, float sm_scale, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || dh <= 0 || dh > kMaxHeadDim ||
      page_size <= 0 || max_pages <= 0 || layer_idx < 0 ||
      layer_idx >= num_layers)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(
          q, k_pool, v_pool, page_tables, positions, valid_lens, out, b, s, h,
          dh, page_size, max_pages, num_layers, layer_idx, sm_scale, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          q, k_pool, v_pool, page_tables, positions, valid_lens, out, b, s, h,
          dh, page_size, max_pages, num_layers, layer_idx, sm_scale, st));
    case 2:
      return static_cast<int>(launch<__half>(
          q, k_pool, v_pool, page_tables, positions, valid_lens, out, b, s, h,
          dh, page_size, max_pages, num_layers, layer_idx, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
