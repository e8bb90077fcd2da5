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
// Bound on the H100: bytes. Stage 1 reads p, g, m, v and writes m, v (24
// bytes an element), the apply reads p, m, v and writes p (16 bytes): 40
// bytes an element for about 30 operations, far below the card's ~20 fp32
// operations per byte. What the design does about it: one pass each, 16-byte
// loads and stores where every pointer and chunk start allows them, blocks
// of 8192 elements so that the per-chunk partials are 1/4096 of the traffic.

#include <cuda_runtime.h>
#include <stdint.h>

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

// m, v updated in place; returns u. psq / usq gain p * p and u * u.
__device__ __forceinline__ void stage1_one(float p, float g, float& m,
                                           float& v, const LambScalars& s,
                                           float& psq, float& usq) {
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(__fsub_rn(1.f, s.beta1), g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fsub_rn(1.f, s.beta2), __fmul_rn(g, g)));
  const float u = direction(p, m, v, s);
  psq = __fadd_rn(psq, __fmul_rn(p, p));
  usq = __fadd_rn(usq, __fmul_rn(u, u));
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

__global__ void __launch_bounds__(kThreads)
    lamb_stage1_kernel(const float* __restrict__ p, const float* __restrict__ g,
                       float* __restrict__ m, float* __restrict__ v,
                       const int64_t* __restrict__ chunks,
                       const int64_t* __restrict__ seg_first,
                       float2* __restrict__ partials,
                       unsigned* __restrict__ tickets,
                       float* __restrict__ ratio, float2* __restrict__ sums,
                       int vectorized, LambScalars s) {
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
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      stage1_one(pp.x, gg.x, mm.x, vv.x, s, psq, usq);
      stage1_one(pp.y, gg.y, mm.y, vv.y, s, psq, usq);
      stage1_one(pp.z, gg.z, mm.z, vv.z, s, psq, usq);
      stage1_one(pp.w, gg.w, mm.w, vv.w, s, psq, usq);
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (int j = 0; j < 4 && base + j < len; ++j) {
        float mm = m[i + j], vv = v[i + j];
        stage1_one(p[i + j], g[i + j], mm, vv, s, psq, usq);
        m[i + j] = mm;
        v[i + j] = vv;
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

__global__ void __launch_bounds__(kThreads)
    lamb_apply_kernel(float* __restrict__ p, const float* __restrict__ m,
                      const float* __restrict__ v,
                      const int64_t* __restrict__ chunks,
                      const float* __restrict__ ratio, int vectorized,
                      LambScalars s) {
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
      const float4 mm = *reinterpret_cast<const float4*>(m + i);
      const float4 vv = *reinterpret_cast<const float4*>(v + i);
      pp.x = __fsub_rn(pp.x, __fmul_rn(scale, direction(pp.x, mm.x, vv.x, s)));
      pp.y = __fsub_rn(pp.y, __fmul_rn(scale, direction(pp.y, mm.y, vv.y, s)));
      pp.z = __fsub_rn(pp.z, __fmul_rn(scale, direction(pp.z, mm.z, vv.z, s)));
      pp.w = __fsub_rn(pp.w, __fmul_rn(scale, direction(pp.w, mm.w, vv.w, s)));
      *reinterpret_cast<float4*>(p + i) = pp;
    } else {
      for (int j = 0; j < 4 && base + j < len; ++j) {
        const float pj = p[i + j];
        p[i + j] = __fsub_rn(pj, __fmul_rn(scale, direction(pj, m[i + j],
                                                            v[i + j], s)));
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
// chunk is not written).
// vectorized: 1 when p, g, m, v are 16-byte aligned and every chunk starts at
// a multiple of 4. Returns a cudaError_t; runs on `stream` without a sync.
extern "C" int fused_lamb_launch(const void* p, const void* g, void* m,
                                 void* v, const void* chunks, int64_t n_chunks,
                                 const void* seg_first, int64_t n_seg,
                                 void* partials, void* tickets, void* ratio,
                                 void* sums, int vectorized, float beta1, float beta2,
                                 float eps, float weight_decay, float bc1,
                                 float bc2, float max_coeff, float min_coeff,
                                 int eps_inside_sqrt, void* stream) {
  if (n_chunks <= 0 || n_seg <= 0 || n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(tickets, 0, n_seg * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  lamb_stage1_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, st>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const int64_t*>(chunks),
      static_cast<const int64_t*>(seg_first), static_cast<float2*>(partials),
      static_cast<unsigned*>(tickets), static_cast<float*>(ratio),
      static_cast<float2*>(sums), vectorized,
      scalars(0.f, beta1, beta2, eps, weight_decay, bc1, bc2, max_coeff,
              min_coeff, eps_inside_sqrt));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_lamb_apply_launch(void* p, const void* m, const void* v,
                                       const void* chunks, int64_t n_chunks,
                                       const void* ratio, int vectorized,
                                       float lr, float eps, float weight_decay,
                                       float bc1, float bc2,
                                       int eps_inside_sqrt, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  lamb_apply_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<const int64_t*>(chunks),
      static_cast<const float*>(ratio), vectorized,
      scalars(lr, 0.f, 0.f, eps, weight_decay, bc1, bc2, 0.f, 0.f,
              eps_inside_sqrt));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_lamb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunk length the host must cut segments to (kChunk), so the host and
// this file cannot disagree.
extern "C" int fused_lamb_chunk() { return kChunk; }
