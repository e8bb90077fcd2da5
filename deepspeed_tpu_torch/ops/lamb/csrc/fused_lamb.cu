// Fused LAMB over one flat fp32 partition of many segments (one segment per
// parameter), for Hopper (sm_90a). Two kernels, one launch each per step:
//
//   lamb_stage1_kernel  <- deepspeed_tpu/ops/lamb/pallas_lamb.py::
//                          _lamb_stage1_flat (pallas_call at :74, body
//                          _lamb_stage1_kernel): m', v', the update direction
//                          u and the squared norms of p and u; here also the
//                          per-segment reduction and trust ratio that the TPU
//                          code takes in XLA ops (fused_lamb_shard, :120-125)
//   lamb_apply_kernel   <- the apply of fused_lamb_shard (:127):
//                          p' = p - (lr * ratio) * u
//
// Per element, in fp32, each operation rounded once in the TPU kernel's order
// (the __f*_rn intrinsics keep nvcc from contracting a multiply and an add
// into one FMA, so the result equals the plain PyTorch version
// fused_lamb_reference operation for operation):
//   m' = beta1 * m + (1 - beta1) * g
//   v' = beta2 * v + (1 - beta2) * (g * g)
//   denom = sqrt(v' / bc2) + eps      (sqrt(v' / bc2 + eps) if eps_inside_sqrt)
//   u = (m' / bc1) / denom + weight_decay * p
// Per segment: ratio = clip(|p| / |u|, min_coeff, max_coeff) when both norms
// are > 0, else 1.
//
// Layout: p, g, m, v are one flat (n,) fp32 buffer each; a segment is a
// (offset, numel) range of it. The host cuts every segment into chunks of at
// most kChunk elements (the chunk table: start, length, segment) and gives
// the first chunk of each segment (seg_first, n_seg + 1 entries). A block
// owns one chunk: thread t handles elements 4 * (r * kThreads + t) + j of the
// chunk for rounds r and lanes j, in that order, so every sum has a fixed
// order that the plain version repeats:
//   * a thread sums its elements' squares in (r, j) order; the block then
//     folds its 256 sums in a shared-memory tree (w = 128, 64, ..., 1:
//     s[t] += s[t + w]) into the chunk's partials, written without atomics;
//   * the block that finishes a segment's last chunk (a ticket counter per
//     segment) reduces that segment's partials the same way (thread t sums
//     chunks t, t + 256, ... in order, then the tree) and writes its ratio.
//     Which block that is varies from run to run; the order of the sum does
//     not, so the result is deterministic. That block also writes the
//     segment's two sums (|p|^2, |u|^2): under tensor parallelism the host
//     all-reduces a sharded segment's sums over the ring and recomputes its
//     ratio from the whole leaf's norms, as the reference's GSPMD psum does.
// u is not stored: the apply recomputes it from p, m' and v' with the same
// operations, the same bits, and saves a buffer of the partition's size.
//
// bf16 moments (the JAX package's moments_dtype="bf16", lamb_update's XLA
// leaf): u must come from the fp32 m' and v', not from their bf16 roundings.
// So with bf16 storage stage 1 leaves m and v untouched (it computes m', v'
// and u only for the norms), and the apply reads g, the old m and v, computes
// m', v' and u again with the same operations (the same bits), updates p and
// stores m' and v' rounded to bf16 (nearest even). No scratch buffer.
//
// Bound on the H100: bytes. fp32 moments: stage 1 reads p, g, m, v and writes
// m, v (24 bytes an element), the apply reads p, m, v and writes p (16
// bytes): 40 bytes an element. bf16 moments: stage 1 reads p, g, m, v (12
// bytes), the apply reads them again and writes p, m, v (20 bytes): 32. About
// 30 operations an element, far below the card's ~20 fp32 operations per
// byte. What the design does about it: one pass each, four elements a thread
// a round (16-byte loads and stores, 8 for bf16 moments) where every pointer
// and chunk start allows them, blocks of 8192 elements so that the per-chunk
// partials are 1/4096 of the traffic; one template over the moment type.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "moments.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;                       // elements per block
constexpr int kRounds = kChunk / (4 * kThreads);   // float4 rounds per thread

struct LambScalars {
  float lr, beta1, beta2, eps, weight_decay, bc1, bc2, max_coeff, min_coeff;
  int eps_inside_sqrt;
};

__device__ __forceinline__ float direction(float p, float m, float v,
                                           const LambScalars& s) {
  const float vh = __fdiv_rn(v, s.bc2);
  const float denom = s.eps_inside_sqrt ? __fsqrt_rn(__fadd_rn(vh, s.eps))
                                        : __fadd_rn(__fsqrt_rn(vh), s.eps);
  return __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), denom),
                   __fmul_rn(s.weight_decay, p));
}

// m, v (fp32 values) -> m', v' in place.
__device__ __forceinline__ void moments(float g, float& m, float& v,
                                        const LambScalars& s) {
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(__fsub_rn(1.f, s.beta1), g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fsub_rn(1.f, s.beta2), __fmul_rn(g, g)));
}

// m, v -> m', v' in place; psq / usq gain p * p and u * u.
__device__ __forceinline__ void stage1_one(float p, float g, float& m,
                                           float& v, const LambScalars& s,
                                           float& psq, float& usq) {
  moments(g, m, v, s);
  const float u = direction(p, m, v, s);
  psq = __fadd_rn(psq, __fmul_rn(p, p));
  usq = __fadd_rn(usq, __fmul_rn(u, u));
}

// The apply of one element: p -= scale * u. With fp32 moments m and v are
// stage 1's m' and v'; with bf16 moments (kRecompute) they are the old
// moments, made m' and v' here from g as stage 1 made them.
template <bool kRecompute>
__device__ __forceinline__ float apply_one(float p, float g, float& m,
                                           float& v, float scale,
                                           const LambScalars& s) {
  if (kRecompute) moments(g, m, v, s);
  return __fsub_rn(p, __fmul_rn(scale, direction(p, m, v, s)));
}

// The fixed tree over the block's 256 values of a and b; the sums land in
// a[0] and b[0].
__device__ __forceinline__ void block_tree(float* a, float* b) {
  const int t = threadIdx.x;
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      a[t] = __fadd_rn(a[t], a[t + w]);
      b[t] = __fadd_rn(b[t], b[t + w]);
    }
    __syncthreads();
  }
}

// MT: the moments' storage type. fp32 moments are updated in place here;
// bf16 moments are left untouched (the apply stores them).
template <typename MT>
__global__ void __launch_bounds__(kThreads)
    lamb_stage1_kernel(const float* __restrict__ p, const float* __restrict__ g,
                       MT* __restrict__ m, MT* __restrict__ v,
                       const int64_t* __restrict__ chunks,
                       const int64_t* __restrict__ seg_first,
                       float2* __restrict__ partials,
                       unsigned* __restrict__ tickets,
                       float* __restrict__ ratio, float2* __restrict__ sums,
                       int vectorized, LambScalars s) {
  constexpr bool kStore = std::is_same<MT, float>::value;
  __shared__ float sp[kThreads];
  __shared__ float su[kThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int64_t c = blockIdx.x;
  const int64_t start = chunks[3 * c];
  const int len = static_cast<int>(chunks[3 * c + 1]);
  const int seg = static_cast<int>(chunks[3 * c + 2]);

  float psq = 0.f, usq = 0.f;
  for (int r = 0; r < kRounds; ++r) {
    const int base = 4 * (r * kThreads + t);
    if (base >= len) break;
    const int64_t i = start + base;
    if (vectorized && base + 4 <= len) {
      const float4 pp = *reinterpret_cast<const float4*>(p + i);
      const float4 gg = *reinterpret_cast<const float4*>(g + i);
      float4 mm = load4(m, i), vv = load4(v, i);
      stage1_one(pp.x, gg.x, mm.x, vv.x, s, psq, usq);
      stage1_one(pp.y, gg.y, mm.y, vv.y, s, psq, usq);
      stage1_one(pp.z, gg.z, mm.z, vv.z, s, psq, usq);
      stage1_one(pp.w, gg.w, mm.w, vv.w, s, psq, usq);
      if (kStore) {
        store4(m, i, mm);
        store4(v, i, vv);
      }
    } else {
      for (int j = 0; j < 4 && base + j < len; ++j) {
        float mm = widen(m[i + j]), vv = widen(v[i + j]);
        stage1_one(p[i + j], g[i + j], mm, vv, s, psq, usq);
        if (kStore) {
          narrow(mm, m + i + j);
          narrow(vv, v + i + j);
        }
      }
    }
  }
  sp[t] = psq;
  su[t] = usq;
  __syncthreads();
  block_tree(sp, su);
  if (t == 0) {
    partials[c] = make_float2(sp[0], su[0]);
    __threadfence();  // the partials are visible before the ticket is
    const unsigned n_seg_chunks =
        static_cast<unsigned>(seg_first[seg + 1] - seg_first[seg]);
    last = atomicAdd(&tickets[seg], 1u) + 1u == n_seg_chunks;
  }
  __syncthreads();
  if (!last) return;

  // this block closed the segment: reduce its chunks' partials in order
  const int64_t first = seg_first[seg];
  const int64_t count = seg_first[seg + 1] - first;
  float ap = 0.f, au = 0.f;
  for (int64_t k = t; k < count; k += kThreads) {
    const float2 q = __ldcg(partials + first + k);  // past L1: other SMs' writes
    ap = __fadd_rn(ap, q.x);
    au = __fadd_rn(au, q.y);
  }
  sp[t] = ap;
  su[t] = au;
  __syncthreads();
  block_tree(sp, su);
  if (t == 0) {
    sums[seg] = make_float2(sp[0], su[0]);
    const float pn = __fsqrt_rn(sp[0]), un = __fsqrt_rn(su[0]);
    ratio[seg] = (pn > 0.f && un > 0.f)
                     ? fminf(fmaxf(__fdiv_rn(pn, un), s.min_coeff), s.max_coeff)
                     : 1.f;
  }
}

// MT: the moments' storage type. fp32: m and v hold stage 1's m', v' and
// are read; bf16: m and v hold the old moments, m', v' are made from g here
// and stored.
template <typename MT>
__global__ void __launch_bounds__(kThreads)
    lamb_apply_kernel(float* __restrict__ p, const float* __restrict__ g,
                      MT* __restrict__ m, MT* __restrict__ v,
                      const int64_t* __restrict__ chunks,
                      const float* __restrict__ ratio, int vectorized,
                      LambScalars s) {
  constexpr bool kRecompute = !std::is_same<MT, float>::value;
  const int t = threadIdx.x;
  const int64_t c = blockIdx.x;
  const int64_t start = chunks[3 * c];
  const int len = static_cast<int>(chunks[3 * c + 1]);
  const float scale = __fmul_rn(s.lr, ratio[chunks[3 * c + 2]]);
  for (int r = 0; r < kRounds; ++r) {
    const int base = 4 * (r * kThreads + t);
    if (base >= len) break;
    const int64_t i = start + base;
    if (vectorized && base + 4 <= len) {
      float4 pp = *reinterpret_cast<const float4*>(p + i);
      float4 gg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kRecompute) gg = *reinterpret_cast<const float4*>(g + i);
      float4 mm = load4(m, i), vv = load4(v, i);
      pp.x = apply_one<kRecompute>(pp.x, gg.x, mm.x, vv.x, scale, s);
      pp.y = apply_one<kRecompute>(pp.y, gg.y, mm.y, vv.y, scale, s);
      pp.z = apply_one<kRecompute>(pp.z, gg.z, mm.z, vv.z, scale, s);
      pp.w = apply_one<kRecompute>(pp.w, gg.w, mm.w, vv.w, scale, s);
      *reinterpret_cast<float4*>(p + i) = pp;
      if (kRecompute) {
        store4(m, i, mm);
        store4(v, i, vv);
      }
    } else {
      for (int j = 0; j < 4 && base + j < len; ++j) {
        float mm = widen(m[i + j]), vv = widen(v[i + j]);
        p[i + j] = apply_one<kRecompute>(p[i + j], kRecompute ? g[i + j] : 0.f,
                                         mm, vv, scale, s);
        if (kRecompute) {
          narrow(mm, m + i + j);
          narrow(vv, v + i + j);
        }
      }
    }
  }
}

LambScalars scalars(float lr, float beta1, float beta2, float eps,
                    float weight_decay, float bc1, float bc2, float max_coeff,
                    float min_coeff, int eps_inside_sqrt) {
  return LambScalars{lr,  beta1,     beta2,     eps,
                     weight_decay, bc1, bc2, max_coeff, min_coeff,
                     eps_inside_sqrt};
}

}  // namespace

// chunks: (n_chunks, 3) int64 rows (start, length <= 8192, segment);
// seg_first: (n_seg + 1) int64; partials: (n_chunks, 2) fp32 scratch;
// tickets: (n_seg) uint32 scratch, zeroed here; ratio: (n_seg) fp32 out;
// sums: (n_seg, 2) fp32 out, each segment's (|p|^2, |u|^2) (a segment of no
// chunk is not written). moments_bf16: 1 when m and v are bf16 (left
// untouched here), 0 when fp32 (updated in place).
// vectorized: 1 when p, g, m, v are 4-element aligned and every chunk starts
// at a multiple of 4. Returns a cudaError_t; runs on `stream` without a sync.
extern "C" int fused_lamb_launch(const void* p, const void* g, void* m,
                                 void* v, const void* chunks, int64_t n_chunks,
                                 const void* seg_first, int64_t n_seg,
                                 void* partials, void* tickets, void* ratio,
                                 void* sums, int vectorized, int moments_bf16,
                                 float beta1, float beta2, float eps,
                                 float weight_decay, float bc1, float bc2,
                                 float max_coeff, float min_coeff,
                                 int eps_inside_sqrt, void* stream) {
  if (n_chunks <= 0 || n_seg <= 0 || n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(tickets, 0, n_seg * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LambScalars s = scalars(0.f, beta1, beta2, eps, weight_decay, bc1,
                                bc2, max_coeff, min_coeff, eps_inside_sqrt);
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  const auto* pp = static_cast<const float*>(p);
  const auto* gg = static_cast<const float*>(g);
  const auto* ch = static_cast<const int64_t*>(chunks);
  const auto* sf = static_cast<const int64_t*>(seg_first);
  auto* pa = static_cast<float2*>(partials);
  auto* ti = static_cast<unsigned*>(tickets);
  auto* ra = static_cast<float*>(ratio);
  auto* su = static_cast<float2*>(sums);
  if (moments_bf16)
    lamb_stage1_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        pp, gg, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        ch, sf, pa, ti, ra, su, vectorized, s);
  else
    lamb_stage1_kernel<float><<<blocks, kThreads, 0, st>>>(
        pp, gg, static_cast<float*>(m), static_cast<float*>(v), ch, sf, pa,
        ti, ra, su, vectorized, s);
  return static_cast<int>(cudaGetLastError());
}

// g, beta1, beta2: read with bf16 moments only (the apply makes m', v' and
// stores them); with fp32 moments m and v already hold m', v' (g may be
// null).
extern "C" int fused_lamb_apply_launch(void* p, const void* g, void* m,
                                       void* v, const void* chunks,
                                       int64_t n_chunks, const void* ratio,
                                       int vectorized, int moments_bf16,
                                       float lr, float beta1, float beta2,
                                       float eps, float weight_decay,
                                       float bc1, float bc2,
                                       int eps_inside_sqrt, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffff || (moments_bf16 && !g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LambScalars s = scalars(lr, beta1, beta2, eps, weight_decay, bc1,
                                bc2, 0.f, 0.f, eps_inside_sqrt);
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  auto* pp = static_cast<float*>(p);
  const auto* gg = static_cast<const float*>(g);
  const auto* ch = static_cast<const int64_t*>(chunks);
  const auto* ra = static_cast<const float*>(ratio);
  if (moments_bf16)
    lamb_apply_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        pp, gg, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        ch, ra, vectorized, s);
  else
    lamb_apply_kernel<float><<<blocks, kThreads, 0, st>>>(
        pp, gg, static_cast<float*>(m), static_cast<float*>(v), ch, ra,
        vectorized, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_lamb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunk length the host must cut segments to (kChunk), so the host and
// this file cannot disagree.
extern "C" int fused_lamb_chunk() { return kChunk; }
