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
// card's fp32 rate (67 TFLOP/s over 3.35 TB/s) would become the limit, so
// the tensor cores would not help: an m16n8k16 product at s = 1 wastes 15 of
// its 16 rows. The time goes to latency: at decode a slot's keys are a few
// hundred rows, and one block walking them in turn leaves most SMs idle.
//
// The design (flash-decoding): the grid is (h, b, splits). Each block takes
// one split, a fixed run of `chunk * rounds` keys of one (slot, head), and
// `splits` covers the page table's width (max_pages * page_size), which the
// host knows without reading positions. A block whose run starts past its
// slot's last live key exits at once; a slot whose live keys fit in one run
// has its output written by that run's block directly.
//   * Loads: each round stages `chunk` keys of K and V in shared memory in
//     the input type, by 16-byte cp.async straight from the pool, page by
//     page through the page table (no gathered copy), K in kKGroups commit
//     groups so the scores of the first keys overlap the later keys' loads.
//     Nothing past the last live key is loaded, so the NaN-poisoned or
//     recycled rows after it and the garbage page are never read.
//   * Scores: a K row is cut into 16-byte slices, one a lane (two for fp32
//     at d_head 256); the lanes of a row group reduce their partial dot
//     products by shuffles, so at s = 1 every thread holds work. The
//     chunk's scores go to shared memory, its max and sum are reduced over
//     the block, P overwrites the scores, and P.V runs in the same slices,
//     accumulated in registers across rounds (an online softmax a chunk at
//     a time).
//   * Combine: with more than one live run, each block writes its partial
//     (running max m, sum l, unnormalised acc) to an fp32 workspace and
//     takes a ticket; the last block of the (slot, head) combines the
//     partials in split order and resets the ticket. Every sum runs in a
//     fixed order, so the output has the same bits run to run, whatever
//     order the blocks ran in.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

// Launch arguments, mirrored by a ctypes.Structure in paged_attention.py.
struct PagedParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* page_tables;
  const int32_t* positions;
  const int32_t* valid_lens;
  float* out;
  float* ws;       // (b, h, splits, s, dh + 2): acc, then m and l
  int* tickets;    // (b, h), zero between launches
  int b, s, h, dh, page_size, max_pages, num_layers, layer_idx;
  int chunk;       // keys staged in shared memory a round
  int rounds;      // rounds a split
  int splits;      // grid.z; splits * chunk * rounds >= max_pages * page_size
  float sm_scale;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kKGroups = 2;  // commit groups of a round's K loads
constexpr float kNegInf = -1e30f;

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a slice
// 16-byte slices of a row a lane holds at most (d_head 256)
template <typename T>
constexpr int kLaneSlices = (kMaxHeadDim / kVec<T> + 31) / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ void slice_to_float(const void* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) f[e] = to_float(v[e]);
}

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

// score(g) for the K commit groups G.. in turn, each once its group has
// landed: the later K groups and V, kKGroups - g groups, may still be in
// flight.
template <int G, typename F>
__device__ __forceinline__ void for_landed_k_groups(F&& score) {
  if constexpr (G < kKGroups) {
    sm90::cp_async_wait<kKGroups - G>();
    __syncthreads();
    score(G);
    for_landed_k_groups<G + 1>(score);
  }
}

template <typename T>
size_t shared_bytes(int chunk, int dh, int qg) {
  return 2 * static_cast<size_t>(chunk) * dh * sizeof(T) +
         sizeof(float) * (static_cast<size_t>(qg) * chunk +
                          static_cast<size_t>(kWarps) * qg * dh +
                          2 * kWarps * qg);
}

// out of one (slot, head) from the partials of its n_live splits, summed in
// split order: out = sum_t acc_t e^(m_t - m) / sum_t l_t e^(m_t - m), m the
// largest m_t. The partials were written by other blocks: read through L2.
__device__ __forceinline__ void combine_splits(const PagedParams& p, int slot,
                                               int head, int n_live) {
  const int dh = p.dh;
  const int64_t part = (static_cast<int64_t>(slot) * p.h + head) * p.splits;
  const int64_t step = static_cast<int64_t>(p.s) * (dh + 2);
  for (int i = threadIdx.x; i < p.s * dh; i += kThreads) {
    const int j = i / dh, d = i % dh;
    const float* w0 = p.ws + (part * p.s + j) * (dh + 2);
    float m = kNegInf;
    for (int t = 0; t < n_live; ++t) m = fmaxf(m, __ldcg(w0 + t * step + dh));
    float l = 0.f, a = 0.f;
    for (int t = 0; t < n_live; ++t) {
      const float* w = w0 + t * step;
      const float c = expf(__ldcg(w + dh) - m);
      l = fmaf(__ldcg(w + dh + 1), c, l);
      a = fmaf(__ldcg(w + d), c, a);
    }
    p.out[((static_cast<int64_t>(slot) * p.s + j) * p.h + head) * dh + d] =
        a / (l == 0.f ? 1.f : l);
  }
}

// One split of one (slot, head): QG queries at a time.
template <typename T, int QG>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const PagedParams p) {
  constexpr int VEC = kVec<T>, LS = kLaneSlices<T>;
  const int head = blockIdx.x, slot = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dh = p.dh, chunk = p.chunk;

  const int pos = p.positions[slot];
  const int live = pos + p.valid_lens[slot] - 1;  // last live position
  const int n_keys = min(max(live + 1, 0), p.max_pages * p.page_size);
  const int run = chunk * p.rounds;
  const int n_live = max(1, (n_keys + run - 1) / run);
  if (split >= n_live) return;  // past the slot's last live key
  const int k_begin = split * run, k_end = min(k_begin + run, n_keys);

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                        // [chunk][dh]
  T* vs = ks + static_cast<size_t>(chunk) * dh;              // [chunk][dh]
  float* sc = reinterpret_cast<float*>(vs + static_cast<size_t>(chunk) * dh);
  float* red_acc = sc + QG * chunk;                          // [4][QG][dh]
  float* red_m = red_acc + kWarps * QG * dh;                 // [4][QG]
  float* red_l = red_m + kWarps * QG;                        // [4][QG]
  __shared__ int last_block;

  // lanes of a row group share a K / V row, one 16-byte slice a lane
  const int nsl = dh / VEC;
  int lpr = 1;
  while (lpr < nsl && lpr < 32) lpr <<= 1;
  const int rpb = kWarps * (32 / lpr);        // rows a block pass
  const int row = warp * (32 / lpr) + lane / lpr;
  const int gl = lane % lpr;

  const int32_t* pt = p.page_tables + static_cast<int64_t>(slot) * p.max_pages;
  // 64-bit offsets: the pool passes 2^31 elements at larger configurations
  const int64_t head_elems = static_cast<int64_t>(p.page_size) * dh;
  const int64_t page_elems = static_cast<int64_t>(p.num_layers) * p.h *
                             head_elems;
  const int64_t tile_base =
      (static_cast<int64_t>(p.layer_idx) * p.h + head) * head_elems;
  const T* k_pool = static_cast<const T*>(p.k_pool);
  const T* v_pool = static_cast<const T*>(p.v_pool);
  const int sub = (chunk + kKGroups - 1) / kKGroups;  // keys a K group

  const int64_t part = (static_cast<int64_t>(slot) * p.h + head) * p.splits;
  for (int q0 = 0; q0 < p.s; q0 += QG) {
    // this lane's slices of the QG queries, scaled, in fp32
    float qr[QG][LS][VEC];
#pragma unroll
    for (int j = 0; j < QG; ++j)
#pragma unroll
      for (int i = 0; i < LS; ++i) {
        const int sl = gl + i * lpr;
        const T* src = static_cast<const T*>(p.q) +
                       ((static_cast<int64_t>(slot) * p.s + q0 + j) * p.h +
                        head) * dh + sl * VEC;
        const bool have = q0 + j < p.s && sl < nsl;
        float f[VEC];
        if (have) slice_to_float<T>(src, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[j][i][e] = have ? f[e] * p.sm_scale
                                                         : 0.f;
      }
    float acc[QG][LS][VEC];
    float m_run[QG], l_run[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      m_run[j] = kNegInf;
      l_run[j] = 0.f;
#pragma unroll
      for (int i = 0; i < LS; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][i][e] = 0.f;
    }

    for (int kc0 = k_begin; kc0 < k_end; kc0 += chunk) {
      const int n = min(chunk, k_end - kc0);
      __syncthreads();  // the previous round's readers are done
      // K in kKGroups commit groups, then V in one
      for (int g = 0; g < kKGroups; ++g) {
        const int r0 = g * sub, r1 = min(n, r0 + sub);
        for (int i = tid; i < (r1 - r0) * nsl; i += kThreads) {
          const int r = r0 + i / nsl, sl = i % nsl, key = kc0 + r;
          const int64_t src = static_cast<int64_t>(pt[key / p.page_size]) *
                                  page_elems + tile_base +
                              static_cast<int64_t>(key % p.page_size) * dh +
                              sl * VEC;
          sm90::cp_async16(ks + r * dh + sl * VEC, k_pool + src, 16);
        }
        sm90::cp_async_commit();
      }
      for (int i = tid; i < n * nsl; i += kThreads) {
        const int r = i / nsl, sl = i % nsl, key = kc0 + r;
        const int64_t src = static_cast<int64_t>(pt[key / p.page_size]) *
                                page_elems + tile_base +
                            static_cast<int64_t>(key % p.page_size) * dh +
                            sl * VEC;
        sm90::cp_async16(vs + r * dh + sl * VEC, v_pool + src, 16);
      }
      sm90::cp_async_commit();

      // scores, one row group a key, a commit group at a time
      for_landed_k_groups<0>([&](int g) {
        const int r0 = g * sub, r1 = min(n, r0 + sub);
        for (int base = r0; base < r1; base += rpb) {  // block-uniform
          const int r = base + row;
          const bool ok = r < r1;
          float dot[QG];
#pragma unroll
          for (int j = 0; j < QG; ++j) dot[j] = 0.f;
#pragma unroll
          for (int i = 0; i < LS; ++i) {
            const int sl = gl + i * lpr;
            if (ok && sl < nsl) {
              float kf[VEC];
              slice_to_float<T>(ks + r * dh + sl * VEC, kf);
#pragma unroll
              for (int j = 0; j < QG; ++j)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  dot[j] = fmaf(qr[j][i][e], kf[e], dot[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < QG; ++j)
            for (int o = lpr / 2; o > 0; o >>= 1)
              dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
          if (ok && gl == 0) {
            const int key = kc0 + r;
#pragma unroll
            for (int j = 0; j < QG; ++j)
              sc[j * chunk + r] = (key <= pos + q0 + j && key <= live)
                                      ? dot[j] : kNegInf;
          }
        }
      });
      __syncthreads();  // the chunk's scores

      // the chunk's max, then P in place of the scores and its sum
      float m_new[QG], corr[QG];
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        float mx = kNegInf;
        for (int r = tid; r < n; r += kThreads) mx = fmaxf(mx, sc[j * chunk + r]);
        mx = warp_max(mx);
        if (lane == 0) red_m[warp * QG + j] = mx;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        float mx = red_m[j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * QG + j]);
        m_new[j] = fmaxf(m_run[j], mx);
        corr[j] = expf(m_run[j] - m_new[j]);
        float sum = 0.f;
        for (int r = tid; r < n; r += kThreads) {
          const float pr = m_new[j] <= kNegInf
                               ? 0.f : expf(sc[j * chunk + r] - m_new[j]);
          sc[j * chunk + r] = pr;
          sum += pr;
        }
        sum = warp_sum(sum);
        if (lane == 0) red_l[warp * QG + j] = sum;
      }
      sm90::cp_async_wait<0>();  // V has landed
      __syncthreads();           // P, the partial sums and V are visible

      // acc = acc * corr + P . V, in this lane's slices
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        float sum = red_l[j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += red_l[w * QG + j];
        l_run[j] = l_run[j] * corr[j] + sum;
        m_run[j] = m_new[j];
#pragma unroll
        for (int i = 0; i < LS; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][i][e] *= corr[j];
      }
      for (int r = row; r < n; r += rpb) {
#pragma unroll
        for (int i = 0; i < LS; ++i) {
          const int sl = gl + i * lpr;
          if (sl < nsl) {
            float vf[VEC];
            slice_to_float<T>(vs + r * dh + sl * VEC, vf);
#pragma unroll
            for (int j = 0; j < QG; ++j) {
              const float pr = sc[j * chunk + r];
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[j][i][e] = fmaf(pr, vf[e], acc[j][i][e]);
            }
          }
        }
      }
    }

    // acc summed over the row groups of a warp, then over the warps
#pragma unroll
    for (int j = 0; j < QG; ++j)
#pragma unroll
      for (int i = 0; i < LS; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          for (int o = lpr; o < 32; o <<= 1)
            acc[j][i][e] += __shfl_xor_sync(0xffffffffu, acc[j][i][e], o);
    __syncthreads();  // the last round's readers of red_acc's neighbours
    if (lane < lpr) {
#pragma unroll
      for (int j = 0; j < QG; ++j)
#pragma unroll
        for (int i = 0; i < LS; ++i) {
          const int sl = gl + i * lpr;
          if (sl < nsl)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              red_acc[(warp * QG + j) * dh + sl * VEC + e] = acc[j][i][e];
        }
    }
    __syncthreads();
    for (int i = tid; i < QG * dh; i += kThreads) {
      const int j = i / dh, d = i % dh;
      if (q0 + j >= p.s) continue;
      float a = red_acc[j * dh + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += red_acc[(w * QG + j) * dh + d];
      if (n_live == 1) {
        const float l = l_run[j];
        p.out[((static_cast<int64_t>(slot) * p.s + q0 + j) * p.h + head) *
                  dh + d] = a / (l == 0.f ? 1.f : l);
      } else {
        float* w = p.ws + ((part + split) * p.s + q0 + j) * (dh + 2);
        w[d] = a;
        if (d == 0) {
          w[dh] = m_run[j];
          w[dh + 1] = l_run[j];
        }
      }
    }
  }
  if (n_live == 1) return;

  // the last of the slot's live splits to finish combines them in order
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + static_cast<int64_t>(slot) * p.h + head;
  if (tid == 0) last_block = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  combine_splits(p, slot, head, n_live);
  if (tid == 0) *ticket = 0;  // ready for the next launch on the stream
}

template <typename T, int QG>
cudaError_t launch_qg(const PagedParams& p, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(p.chunk, p.dh, QG);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, QG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.h, p.b, p.splits);
  paged_attention_kernel<T, QG><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  if (p.dh % kVec<T> != 0) return cudaErrorInvalidValue;
  // one query at a time at decode; four at a time otherwise
  return p.s == 1 ? launch_qg<T, 1>(p, stream) : launch_qg<T, 4>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int paged_attention_launch(const PagedParams* p, int dtype,
                                      void* stream) {
  const int64_t table_keys =
      static_cast<int64_t>(p->max_pages) * p->page_size;
  if (p->b <= 0 || p->s <= 0 || p->h <= 0 || p->dh <= 0 ||
      p->dh > kMaxHeadDim || p->page_size <= 0 || p->max_pages <= 0 ||
      p->layer_idx < 0 || p->layer_idx >= p->num_layers || p->chunk <= 0 ||
      p->chunk > 1024 || p->rounds <= 0 || p->splits <= 0 ||
      p->splits > 65535 ||
      static_cast<int64_t>(p->splits) * p->chunk * p->rounds < table_keys ||
      (p->splits > 1 && (p->ws == nullptr || p->tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(*p, st));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(*p, st));
    case 2: return static_cast<int>(launch<__half>(*p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
