// Packed flash attention for Hopper (sm_90a): forward, and the backward as
// two kernels (dk/dv, then dq).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   forward (flash_fwd_tc_kernel for bf16 and fp16, flash_fwd_kernel for
//     fp32) <- _fwd_packed (pallas_call at :540 resident, :566 streaming)
//     and, one head per (b * h) row, _fwd (:452)
//   dk/dv (flash_bwd_dkdv_tc_kernel; flash_bwd_dkdv_kernel for fp32) and
//   dq (flash_bwd_dq_tc_kernel; flash_bwd_dq_kernel for fp32)
//     <- _bwd_fused_packed (:795, :816), the dk/dv half (:962) and dq half
//     (:937) of _bwd_split_packed, and _bwd (:483): the TPU functions
//     compute the same (dq, dk, dv), which these kernels compute without
//     atomics, so dq is deterministic
//
// Layout: q, k, v, out, dout, dq, dk, dv are (b, s, h*d) "packed" rows, read
// through strides, never transposed to (b, h, s, d): q/k/v are usually the
// three column blocks of one (b, s, 3*h*d) QKV projection (row stride 3*h*d).
// lse and delta are (b, s, h) fp32. bias is an optional (b, s) fp32 additive
// score per KEY (null = zeros), the key-padding mask of the BERT path.
//
// Numerics (the TPU kernels' contract, and the plain PyTorch versions'):
// score = (q . k) * scale + bias[k]; masked scores are NEG_INF = -1e30, never
// -inf (key >= s, and key > query when causal); online softmax in fp32 with
// the probabilities rounded to the input type before the P.V product; a row
// whose sum is 0 divides by 1; lse = m + log(l). Backward terms as
// _bwd_head_terms: p = exp(score - lse) (0 where masked), ds = p * (dp -
// delta) * scale rounded to the input type, delta = rowsum(dout * out)
// computed outside. All accumulation is fp32.
//
// Bound on the H100 at the training shape (b 16, s 1024, h 16, d 64, bf16,
// causal): the forward is bound by bytes by a small margin (135 MB against
// 34 GFLOP), the backward by operations.
//
// bf16 and fp16 run on Hopper's tensor cores (flash_fwd_tc_kernel,
// flash_bwd_dkdv_tc_kernel, flash_bwd_dq_tc_kernel): blocks of 4 warps,
// each warp owning 16 rows of the block's 64 (queries for the forward and
// dq, keys for dk/dv), so no sum crosses warps and nothing needs atomics;
// the forward's row max and row sum cross only the 4 lanes of a quad. The
// resident operands (Q; K, V for dk/dv; Q, dO for dq) stay in shared memory
// in the input type; the streamed ones (K, V, bias; Q, dO, lse, delta) are
// double-buffered with 16-byte cp.async. Every product is mma.sync m16n8k16
// with fp32 accumulators, its fragments read with ldmatrix (ldmatrix.trans
// where the contraction runs along the rows: V for P.V, dO and Q for dV and
// dK, K for dQ); the score-side results (P; P^T, dS^T; dS) stay in
// registers and become the A operand of the next product, rounded to the
// input type there: the plain versions' rounding points, with each pair's
// P and dS at the plain versions' bits (below: the tensor cores sum S and
// dP in another order, so pairs near a rounding edge of the input type,
// fp16's own edges included, subnormal range and all, are summed again in
// the plain order; the forward also takes its running max exactly). Rows
// are padded to d + 8 elements, so the fragment loads meet no bank
// conflict. The split backward recomputes S and dP in both kernels (~1.4x
// the arithmetic of one fused backward). What holds them back on this card
// is that exactness work: about half of each backward kernel's time and
// ~40% of the forward's at the train shape, where they execute far more
// scalar instructions a pair than the products need.
//
// fp32 (the parity runs: TF32 would break them) keeps the simple first
// version: every product on the CUDA cores in fp32 FMA from tiles staged in
// shared memory, a 4x4 register tile per thread and float4 shared loads.
// Tiles: 64 query rows (fwd, dq) or 64 keys (dk/dv) per block of 256
// threads (16 x 16); each thread owns 4 rows x 4 columns of a 64 x 64 score
// tile and 4 rows x d/16 columns of the output tile.
//
// Causal tiles above the diagonal are skipped, not masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows (fwd, dq) and keys (all)
constexpr int kLd = kTile + 4;     // leading dim of a transposed 64-wide tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// x rounded to T's precision, as the TPU kernel's .astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max / sum over the 16 lanes that share a row (lanes tx = 0..15)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + R) of a (rows x D) slice (row stride ss) into shared memory
// as fp32, transposed (dst[c * ld + r]) or row-major (dst[r * D + c]); rows at
// or past `limit` read as 0.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile_t(float* dst, int ld, const T* src,
                                            int64_t ss, int r0, int limit) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[c * ld + r] = row < limit ? to_f(src[row * ss + c]) : 0.f;
  }
}

template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ss, int r0, int limit) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[i] = row < limit ? to_f(src[row * ss + c]) : 0.f;
  }
}

}  // namespace

// Launch arguments, mirrored by a ctypes.Structure in flash_attention.py.
// Strides are in elements; the head offset (head * d) is added here.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;     // (b, s) key bias with row stride bias_sb, or null
  const void* dout;      // backward only
  const float* lse_in;   // backward only, (b, s, h)
  const float* delta;    // backward only, (b, s, h)
  void* out;             // forward only
  float* lse;            // forward only, (b, s, h)
  void* dq;
  void* dk;
  void* dv;
  int64_t qkv_sb, qkv_ss;    // q, k and v share one batch/row stride
  int64_t bias_sb;
  int64_t out_sb, out_ss;    // out (forward) and dout (backward)
  int64_t grad_sb, grad_ss;  // dq, dk and dv share one batch/row stride
  int b, s, h, causal;
  float scale;
};

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][kLd]     q tile, transposed
  float* kt = qt + D * kLd;          // [D][kLd]     k tile, transposed
  float* vs = kt + D * kLd;          // [kTile][D]   v tile
  float* pt = vs + kTile * D;        // [kTile][kLd] probabilities, [key][row]
  float* bs = pt + kTile * kLd;      // [kTile]      key bias

  const int qi = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s = p.s;
  const int q0 = qi * kTile;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const float* biasb = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  load_tile_t<T, D, kTile>(qt, kLd, qb, p.qkv_ss, q0, s);

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int nk = (s + kTile - 1) / kTile;
  const int n_visible = p.causal ? min(qi + 1, nk) : nk;
  for (int kj = 0; kj < n_visible; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<T, D, kTile>(kt, kLd, kb, p.qkv_ss, k0, s);
    load_tile<T, D, kTile>(vs, vb, p.qkv_ss, k0, s);
    if (tid < kTile)
      bs[tid] = (biasb != nullptr && k0 + tid < s) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < s && (!p.causal || row >= col);
        const float val = sc[i][j] * p.scale + bs[tx * 4 + j];
        sc[i][j] = ok ? val : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(sc[i][j] - m_new);
        rs += pr;
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = round_to<T>(pr);
      }
      rs = row_sum(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + t * kLd + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = vs[t * D + tx * CD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < s) {
      const float ls = l[i] == 0.f ? 1.f : l[i];
      T* orow = out + bi * p.out_sb + row * p.out_ss + head * D + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) orow[c] = from_f<T>(acc[i][c] / ls);
      if (tx == 0)
        p.lse[(static_cast<int64_t>(bi) * s + row) * p.h + head] =
            m[i] + logf(ls);
    }
  }
}

// dq for one (batch, head, 64-row query tile), walking the key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashParams p) {
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][kLd]
  float* dot = qt + D * kLd;         // [D][kLd]     dout tile, transposed
  float* kt = dot + D * kLd;         // [D][kLd]
  float* vt = kt + D * kLd;          // [D][kLd]
  float* ks = vt + D * kLd;          // [kTile][D]   k tile, row-major
  float* dst = ks + kTile * D;       // [kTile][kLd] ds, [key][row]
  float* bs = dst + kTile * kLd;     // [kTile]

  const int qi = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s = p.s;
  const int q0 = qi * kTile;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const T* db = static_cast<const T*>(p.dout) + bi * p.out_sb + head * D;
  const float* biasb = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  load_tile_t<T, D, kTile>(qt, kLd, qb, p.qkv_ss, q0, s);
  load_tile_t<T, D, kTile>(dot, kLd, db, p.out_ss, q0, s);
  float lse_r[4], delta_r[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const int64_t at = (static_cast<int64_t>(bi) * s + row) * p.h + head;
    lse_r[i] = row < s ? p.lse_in[at] : 0.f;
    delta_r[i] = row < s ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int nk = (s + kTile - 1) / kTile;
  const int n_visible = p.causal ? min(qi + 1, nk) : nk;
  for (int kj = 0; kj < n_visible; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();
    load_tile_t<T, D, kTile>(kt, kLd, kb, p.qkv_ss, k0, s);
    load_tile_t<T, D, kTile>(vt, kLd, vb, p.qkv_ss, k0, s);
    load_tile<T, D, kTile>(ks, kb, p.qkv_ss, k0, s);
    if (tid < kTile)
      bs[tid] = (biasb != nullptr && k0 + tid < s) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 g = *reinterpret_cast<const float4*>(dot + d * kLd + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float4 bv = *reinterpret_cast<const float4*>(vt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float kv[4] = {bk.x, bk.y, bk.z, bk.w};
      const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(av[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = row < s && col < s && (!p.causal || row >= col);
        const float pr =
            ok ? expf(sc[i][j] * p.scale + bs[tx * 4 + j] - lse_r[i]) : 0.f;
        const float ds = pr * (dp[i][j] - delta_r[i]) * p.scale;
        dst[(tx * 4 + j) * kLd + ty * 4 + i] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + t * kLd + ty * 4);
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
      float kr[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kr[c] = ks[t * D + tx * CD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(dv4[i], kr[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < s) {
      T* drow = dq + bi * p.grad_sb + row * p.grad_ss + head * D + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) drow[c] = from_f<T>(acc[i][c]);
    }
  }
}

// dk and dv for one (batch, head, 64-key tile), walking the query tiles of
// BQ rows from the diagonal down. Scores are taken transposed: each thread
// owns 4 keys x BQ/16 queries.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const FlashParams p) {
  constexpr int CD = D / 16;
  constexpr int TQ = BQ / 16;  // query columns per thread
  constexpr int LQ = BQ + 4;   // leading dim of a transposed query tile
  extern __shared__ float smem[];
  float* kt = smem;                  // [D][kLd]
  float* vt = kt + D * kLd;          // [D][kLd]
  float* qt = vt + D * kLd;          // [D][LQ]
  float* dot = qt + D * LQ;          // [D][LQ]
  float* qs = dot + D * LQ;          // [BQ][D]
  float* dos = qs + BQ * D;          // [BQ][D]
  float* pq = dos + BQ * D;          // [BQ][kLd]   p rounded, [query][key]
  float* dsq = pq + BQ * kLd;        // [BQ][kLd]   ds rounded, [query][key]
  float* bs = dsq + BQ * kLd;        // [kTile]

  const int kj = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s = p.s;
  const int k0 = kj * kTile;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const T* db = static_cast<const T*>(p.dout) + bi * p.out_sb + head * D;
  const float* biasb = p.bias ? p.bias + bi * p.bias_sb : nullptr;

  load_tile_t<T, D, kTile>(kt, kLd, kb, p.qkv_ss, k0, s);
  load_tile_t<T, D, kTile>(vt, kLd, vb, p.qkv_ss, k0, s);
  if (tid < kTile)
    bs[tid] = (biasb != nullptr && k0 + tid < s) ? biasb[k0 + tid] : 0.f;

  float dk[4][CD], dv[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (s + BQ - 1) / BQ;
  for (int qi = p.causal ? k0 / BQ : 0; qi < nq; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();
    load_tile_t<T, D, BQ>(qt, LQ, qb, p.qkv_ss, q0, s);
    load_tile_t<T, D, BQ>(dot, LQ, db, p.out_ss, q0, s);
    load_tile<T, D, BQ>(qs, qb, p.qkv_ss, q0, s);
    load_tile<T, D, BQ>(dos, db, p.out_ss, q0, s);
    float lse_c[TQ], delta_c[TQ];
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int qrow = q0 + tx * TQ + j;
      const int64_t at = (static_cast<int64_t>(bi) * s + qrow) * p.h + head;
      lse_c[j] = qrow < s ? p.lse_in[at] : 0.f;
      delta_c[j] = qrow < s ? p.delta[at] : 0.f;
    }
    __syncthreads();

    float st[4][TQ], dpt[4][TQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(kt + d * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(vt + d * kLd + ty * 4);
      const float kv[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {b.x, b.y, b.z, b.w};
      float qv[TQ], gv[TQ];
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        qv[j] = qt[d * LQ + tx * TQ + j];
        gv[j] = dot[d * LQ + tx * TQ + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int qrow = q0 + tx * TQ + j;
        const bool ok = qrow < s && key < s && (!p.causal || qrow >= key);
        const float pr =
            ok ? expf(st[i][j] * p.scale + bs[ty * 4 + i] - lse_c[j]) : 0.f;
        const float ds = pr * (dpt[i][j] - delta_c[j]) * p.scale;
        pq[(tx * TQ + j) * kLd + ty * 4 + i] = round_to<T>(pr);
        dsq[(tx * TQ + j) * kLd + ty * 4 + i] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BQ; ++t) {
      const float4 p4 = *reinterpret_cast<const float4*>(pq + t * kLd + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(dsq + t * kLd + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float sv[4] = {d4.x, d4.y, d4.z, d4.w};
      float gr[CD], qr[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gr[c] = dos[t * D + tx * CD + c];
        qr[c] = qs[t * D + tx * CD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv[i][c] = fmaf(pv[i], gr[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qr[c], dk[i][c]);
        }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < s) {
      const int64_t at = bi * p.grad_sb + key * p.grad_ss + head * D + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkp[at + c] = from_f<T>(dk[i][c]);
        dvp[at + c] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// ------------------------------------- tensor-core kernels (bf16, fp16)

constexpr int kTcThreads = 128;  // 4 warps x 16 rows of the block's 64
constexpr int kTcRows = 64;      // keys (dk/dv) or queries (fwd, dq) a block

template <int D>
struct TcTile {
  static constexpr int ld = D + 8;                 // padded smem row
  static constexpr int bq = 32;  // dk/dv query tile: three blocks an SM
};

// The plain versions round P and dS to T from fp32 S and dP that cuBLAS
// sums over d in ascending order, one fp32 rounding per product (exact for
// bf16 and fp16 inputs). The tensor cores sum in another order, so a P or
// dS lying near a rounding edge of T could round the other way, and one
// term of a sum then moves by an ulp of the term: more than an ulp of a sum
// that cancels. So each pair's P and dS come from the tensor-core S and dP
// through the plain versions' operations, and where a bound on the
// difference to the plain values reaches a rounding edge, S and dP are
// summed again in the plain order (seq_dots) for that pair. The bound:
// |S_tc - S_plain| <= 6 * 2^-24 |q| |k| (row norms, the tile's largest);
// measured on the H100 at the train shape, at most 2.93 * 2^-24 |q| |k|.
// One to two pairs in a hundred take the second sum at bf16 (fp16's edges
// lie 8x closer): the flagged pairs of a warp's tile are listed in shared
// memory, up to kTcList at a time, and shared out over its lanes.
constexpr float kProductSlack = 6.f * 5.9604645e-8f;  // 6 * 2^-24
constexpr int kTcList = 64;  // flagged pairs a warp re-sums at a time

// S and dP of one pair as the plain version sums them: ascending over d,
// one fp32 rounding per step (rows in shared memory, 16-byte aligned).
template <typename T, int D>
__device__ __forceinline__ float2 seq_dots(const T* a1, const T* b1,
                                           const T* a2, const T* b2) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
  for (int i = 0; i < D; i += 8) {
    const uint4 w[4] = {*reinterpret_cast<const uint4*>(a1 + i),
                        *reinterpret_cast<const uint4*>(b1 + i),
                        *reinterpret_cast<const uint4*>(a2 + i),
                        *reinterpret_cast<const uint4*>(b2 + i)};
    const T* x = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 = fmaf(to_f(x[j]), to_f(x[8 + j]), s1);
      s2 = fmaf(to_f(x[16 + j]), to_f(x[24 + j]), s2);
    }
  }
  return make_float2(s1, s2);
}

// S alone, in the same order (the forward).
template <typename T, int D>
__device__ __forceinline__ float seq_dot(const T* a, const T* b) {
  float s = 0.f;
#pragma unroll 2
  for (int i = 0; i < D; i += 8) {
    const uint4 w[2] = {*reinterpret_cast<const uint4*>(a + i),
                        *reinterpret_cast<const uint4*>(b + i)};
    const T* x = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(to_f(x[j]), to_f(x[8 + j]), s);
  }
  return s;
}

// |row| of a D-long row in shared memory (16-byte aligned); a bound's
// input, so the order of the sum does not matter.
template <typename T, int D>
__device__ __forceinline__ float row_norm(const T* a) {
  float acc[8] = {};
#pragma unroll
  for (int i = 0; i < D; i += 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(a + i);
    const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(to_f(x[j]), to_f(x[j]), acc[j]);
  }
  return sqrtf(((acc[0] + acc[1]) + (acc[2] + acc[3])) +
               ((acc[4] + acc[5]) + (acc[6] + acc[7])));
}

// The score sc = S scale + bias in the plain version's order of fp32
// operations.
__device__ __forceinline__ float score_of(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

struct PairTerms {
  float p, ds, x, d1;
};

// P = exp(S * scale + bias - lse) and dS = P (dP - delta) scale in the
// plain versions' order of fp32 operations (and x, dP - delta).
__device__ __forceinline__ PairTerms pair_terms(float s, float dp, float scale,
                                                float bias, float lse,
                                                float delta) {
  const float x = __fsub_rn(score_of(s, scale, bias), lse);
  const float p = expf(x);
  const float d1 = __fsub_rn(dp, delta);
  return {p, __fmul_rn(__fmul_rn(p, d1), scale), x, d1};
}

// The distance from y to the nearest value where rounding to T changes (a
// midpoint between two neighbouring T values), in fp32 ulps of y; each such
// ulp is at least |y| 2^-24. bf16 has fp32's exponent range and drops the
// low 16 bits. fp16 drops 13 bits down to 2^-14; below it its step is a
// fixed 2^-24 (the subnormals), so the dropped bits grow as the exponent
// falls, and below 2^-24 the only edge left is 2^-25, between 0 and 2^-24.
// Just above a power of two the nearest edge may be the one below it, in
// the binade below (half the step, or the same step among the subnormals).
// fp16 counts it here. For bf16 it is at least kFarEdge = 0x4000 ulps
// away, and the checks count it instead (a bound of kFarEdge or more flags
// the pair): edge_ulps<bf16> is the distance within the value's binade,
// one operation fewer on the backward's path (~0.08 ms of the dq kernel
// at the train shape).
template <typename T>
__device__ __forceinline__ float edge_ulps(float y);
template <>
__device__ __forceinline__ float edge_ulps<__nv_bfloat16>(float y) {
  return static_cast<float>(
      abs(static_cast<int>(__float_as_uint(y) & 0xFFFFu) - 0x8000));
}
template <typename T>
constexpr float kFarEdge = 3.4e38f;  // edge_ulps<T> counts every edge
template <>
constexpr float kFarEdge<__nv_bfloat16> = 16384.f;
template <>
__device__ __forceinline__ float edge_ulps<__half>(float y) {
  const uint32_t a = __float_as_uint(y) & 0x7FFFFFFFu;
  const int e = static_cast<int>(a >> 23) - 127;  // -127: 0 or subnormal
  if (e >= -24) {
    const int drop = e >= -14 ? 13 : -1 - e;  // 13 .. 23 bits
    const int half = 1 << (drop - 1);
    const int v = static_cast<int>(a & ((1u << drop) - 1u));
    return static_cast<float>(
        min(abs(v - half), v + (e > -14 ? half / 2 : half)));
  }
  return ldexpf(fabsf(fabsf(y) - 0x1p-25f), 23 - max(e, -126));
}

// Is y within t fp32 ulps of a rounding edge of T? The bound is prepared
// once (a row's, in the forward): for bf16 the test is then one unsigned
// compare of the low 16 bits, |v - 0x8000| <= t as (unsigned)(v - 0x8000 +
// t) <= 2 t, and from t = kFarEdge on everything is flagged.
template <typename T>
struct NearEdge;
template <>
struct NearEdge<__nv_bfloat16> {
  int off;
  unsigned span;
  __device__ __forceinline__ explicit NearEdge(float t) {
    const int ti = static_cast<int>(fminf(t, 65536.f));
    off = ti - 0x8000;
    span = ti >= 0x4000 ? 0xFFFFFFFFu : 2u * static_cast<unsigned>(ti);
  }
  __device__ __forceinline__ bool operator()(float y) const {
    return static_cast<unsigned>(
               static_cast<int>(__float_as_uint(y) & 0xFFFFu) + off) <= span;
  }
};
template <>
struct NearEdge<__half> {
  float t;
  __device__ __forceinline__ explicit NearEdge(float bound) : t(bound) {}
  __device__ __forceinline__ bool operator()(float y) const {
    return edge_ulps<__half>(y) <= t;
  }
};

// Below this x (P = exp(x), x moved by at most the bound's ex), P rounds to
// 0 in T on both sides: bf16 keeps fp32's range, where exp underflows to 0
// below -103.98 and so does dS = P d1 scale; fp16 rounds P <= 2^-25 to 0
// (ln 2^-25 = -17.33), while dS may still be a subnormal fp16: it is
// checked on.
template <typename T>
__device__ __forceinline__ float p_zero_below();
template <>
__device__ __forceinline__ float p_zero_below<__nv_bfloat16>() {
  return -110.f;
}
template <>
__device__ __forceinline__ float p_zero_below<__half>() {
  return -17.4f;
}

// The bound of one check, fixed for a row (or column) of pairs over a tile:
// ex bounds |x - x_plain| for x = S scale + bias - lse (S within es of the
// plain S, a rounding of each of the three operations; in the forward lse
// is the running max); tp is the relative bound on |P - P_plain| (and the
// other roundings of dS) in fp32 ulps; ed the part of dS's bound from dP
// within edp of the plain dP.
struct EdgeBound {
  float ex, tp, ed;
};
__device__ __forceinline__ EdgeBound edge_bound(float es, float sx_max,
                                                float bias, float lse_max,
                                                float edp, float scale) {
  const float ex = es * scale + 1.2e-7f * (3.f * sx_max + 2.f * fabsf(bias) +
                                           lse_max);
  // expf of two arguments ex apart, each within two ulps: e^ex - 1 <=
  // ex (1 + ex) for ex <= 1, and past that P is flagged anyway
  const float rel = ex * (1.f + ex) + 4.8e-7f;
  return {ex, rel * 16777216.f + 10.f, (1.f + rel) * edp * 16777216.f};
}

// Could P or dS of a pair (t.x the exponent, t.d1 = dP - delta), taken from
// S and dP within the bound b of the plain version's, round to T otherwise
// than the plain version's? P: its distance to the edge against tp; dS = P
// d1 scale: against tp |d1| + ed, both sides divided by P scale (and the
// edge kFarEdge away against the same bound).
template <typename T>
__device__ __forceinline__ bool near_plain_edge(PairTerms t, EdgeBound b) {
  const bool p_zero = t.x + b.ex < p_zero_below<T>();
  if (!p_zero && NearEdge<T>(b.tp)(t.p)) return true;
  if (std::is_same<T, __nv_bfloat16>::value && p_zero)
    return false;  // dS = 0 as well
  const float d1 = fabsf(t.d1);
  return (edge_ulps<T>(t.ds) - b.tp) * d1 <= b.ed ||
         (kFarEdge<T> - b.tp) * d1 <= b.ed;
}

// The largest of v over a warp's lanes.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The largest of v over the 4 lanes of a quad (the lanes sharing C rows).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The flagged pairs of a warp's 16 x 8 NJ C tiles (bit j * 4 + e of each
// lane's flags) are listed in shared memory (wl) kTcList at a time, each
// lane's after the lanes before it, and shared out over the warp's lanes:
// value(owner lane, position j * 4 + e) computes each into wr, and the
// owner takes it back through apply(j, e, taken, value), called for every
// position without a branch (taken: the value is this pair's).
template <int NJ, typename V, typename Value, typename Apply>
__device__ __forceinline__ void resolve_flagged(uint32_t flags, V* wr,
                                                unsigned short* wl, int lane,
                                                Value value, Apply apply) {
  while (__any_sync(0xffffffffu, flags)) {
    const int cnt = __popc(flags);
    int base = cnt;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, base, o);
      if (lane >= o) base += v;
    }
    const int total = __shfl_sync(0xffffffffu, base, 31);
    base -= cnt;
    int k = base;
    for (uint32_t f = flags; f != 0u && k < kTcList; f &= f - 1u, ++k)
      wl[k] = static_cast<unsigned short>(lane << 8 | (__ffs(f) - 1));
    __syncwarp();
    for (int i = lane; i < min(total, kTcList); i += 32)
      wr[i] = value(wl[i] >> 8, wl[i] & 255);
    __syncwarp();
    k = base;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool mine = flags >> (j * 4 + e) & 1u;
        const bool done = mine && k < kTcList;
        apply(j, e, done, wr[min(k, kTcList - 1)]);
        k += mine;
      }
    // the pairs listed this round (each lane's lowest flags) are done
    for (int i = base; i < min(base + cnt, kTcList); ++i) flags &= flags - 1u;
    __syncwarp();
  }
}

// 16-byte loads are possible when the base, the row stride and the head
// offset keep every row's start on 16 bytes.
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* base, int64_t ss) {
  return (reinterpret_cast<uintptr_t>(base) % 16 == 0) &&
         ((ss * static_cast<int64_t>(sizeof(T))) % 16 == 0);
}

// Rows [r0, r0 + R) of a (rows x D) slice with row stride ss into dst[r][c]
// (row pitch ld), rows at or past `limit` zero: cp.async when vec, else
// plain loads stored directly.
template <typename T, int D, int R>
__device__ __forceinline__ void tc_rows(T* dst, int ld, const T* src,
                                       int64_t ss, int r0, int limit,
                                       bool vec) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < R * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    T* d = dst + r * ld + c;
    if (vec) {
      sm90::cp_async16(d, row < limit ? src + row * ss + c : src,
                       row < limit ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = row < limit ? src[row * ss + c + j] : from_f<T>(0.f);
    }
  }
}

// c[j] (16 rows x 8 columns each, j < N/8) = A (16 x D, rows of `a` at
// pitch ld) . B^T, B's N rows at pitch ld in `b`: both read as they lie
// ([row][d], d contiguous).
template <typename T, int D, int N>
__device__ __forceinline__ void tc_abt(float (&c)[N / 8][4], const T* a,
                                       const T* b, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, a + (lane & 15) * ld + kd + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bf[4];
      sm90::ldmatrix_x4(bf, b + (nn * 16 + r8 + (mat >> 1) * 8) * ld + kd +
                                (mat & 1) * 8);
      sm90::mma16816<T>(c[2 * nn], af, bf[0], bf[1]);
      sm90::mma16816<T>(c[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[j] (16 x 8 each, j < D/8) += P (16 x K, C tiles p[K/8], rounded to T
// here) . B (K x D, rows of `b` at pitch ld, read transposed). At fp16 each
// 16-deep product starts from zero and is added to acc with a rounded fp32
// add: the tensor cores align an accumulator to the largest term and drop
// the bits below, so a long chain through them drifts, and at fp16's finer
// ulp that showed (one dV element over 1000 queries two fp16 ulps off a
// cancelling sum, every P and dS at the plain bits); the plain version's
// sums round to nearest. bf16's ulp is 8x wider: its chain runs through
// the accumulator, ~0.1 ms less a backward kernel at the train shape.
template <typename T, int D, int K>
__device__ __forceinline__ void tc_pb(float (&acc)[D / 8][4],
                                      const float (&p)[K / 8][4], const T* b,
                                      int ld, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    sm90::pack_c_to_a<T>(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bf[4];
      sm90::ldmatrix_x4_trans(bf, b + (kk * 16 + r8 + (mat & 1) * 8) * ld +
                                      nd * 16 + (mat >> 1) * 8);
      if constexpr (std::is_same<T, __half>::value) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        sm90::mma16816<T>(t0, af, bf[0], bf[1]);
        sm90::mma16816<T>(t1, af, bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * nd][e] = __fadd_rn(acc[2 * nd][e], t0[e]);
          acc[2 * nd + 1][e] = __fadd_rn(acc[2 * nd + 1][e], t1[e]);
        }
      } else {
        sm90::mma16816<T>(acc[2 * nd], af, bf[0], bf[1]);
        sm90::mma16816<T>(acc[2 * nd + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// 16 rows x D of fp32 accumulators (C tiles) -> rows `row0 + g (+8)` of a
// packed output, rows at or past s skipped; two neighbouring columns a
// 32-bit store when the row stride and the base allow it.
template <typename T, int D>
__device__ __forceinline__ void tc_store(T* dst, int64_t ss, int row0, int s,
                                         const float (&acc)[D / 8][4],
                                         int lane) {
  const int g = lane >> 2, tg = lane & 3;
  const bool pairs = reinterpret_cast<uintptr_t>(dst) % 4 == 0 && ss % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= s) continue;
    T* r = dst + row * ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float lo = acc[j][2 * half], hi = acc[j][2 * half + 1];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(r + j * 8 + 2 * tg) =
            sm90::pack2<T>(lo, hi);
      } else {
        r[j * 8 + 2 * tg] = from_f<T>(lo);
        r[j * 8 + 2 * tg + 1] = from_f<T>(hi);
      }
    }
  }
}

// out and lse for one (batch, head, 64-query tile), walking the key tiles
// of 64 in ascending order (the plain version's tiles: its running max
// changes at the same keys); warp w owns queries q0 + 16 w .. + 15, so the
// row max and sum cross only the 4 lanes of a quad. The heaviest causal
// tiles (the last queries) are scheduled first.
//
// P = exp(sc - m_new) is rounded to T before P.V, so P must have the plain
// version's bits, and so must the running max m_new, which the plain
// version takes over its own scores. Each tile: the tensor-core scores sc
// (S within es of the plain S, so sc within e of the plain sc); the pairs
// that may hold the plain tile max (sc + e reaches both the best sc - e of
// the row and the running max: none in most later tiles) are summed again
// in the plain order, and their exact scores give m_new exactly; then each
// pair's P, and the pairs whose P lies within the bound of a rounding edge
// of T are summed again. Both re-sums are done by the lane that holds the
// pair: about ten a warp tile of 1024 pairs, where the backward's shared
// list cost more than the sums (probes/kernel_probe.py fwd_variants). BIAS
// switches the key bias's terms off at compile time (none on GPT-2's
// path); at d <= 64, 168 registers keep three blocks on an SM.
template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    flash_fwd_tc_kernel(const FlashParams p) {
  constexpr int LD = TcTile<D>::ld, NJ = kTcRows / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);       // [64][LD]
  T* ks = qs + kTcRows * LD;                   // [2][64][LD]
  T* vs = ks + 2 * kTcRows * LD;               // [2][64][LD]
  float* bias_s = reinterpret_cast<float*>(vs + 2 * kTcRows * LD);  // [2][64]
  float* kn_s = bias_s + 2 * kTcRows;  // [64] |k| of the tile's keys
  float* pw = kn_s + kTcRows + threadIdx.x * 33;  // [128][33] exact P slots

  const int s = p.s;
  const int nq = (s + kTcRows - 1) / kTcRows;
  const int qi = p.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = qi * kTcRows;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const float* biasb = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const bool vec = rows_aligned(qb, p.qkv_ss) && rows_aligned(kb, p.qkv_ss) &&
                   rows_aligned(vb, p.qkv_ss);

  auto stage = [&](int kt) {
    const int k0 = kt * kTcRows, st = kt & 1;
    tc_rows<T, D, kTcRows>(ks + st * kTcRows * LD, LD, kb, p.qkv_ss, k0, s,
                           vec);
    tc_rows<T, D, kTcRows>(vs + st * kTcRows * LD, LD, vb, p.qkv_ss, k0, s,
                           vec);
    for (int i = threadIdx.x; i < kTcRows; i += kTcThreads)
      bias_s[st * kTcRows + i] =
          (biasb != nullptr && k0 + i < s) ? biasb[k0 + i] : 0.f;
  };
  tc_rows<T, D, kTcRows>(qs, LD, qb, p.qkv_ss, q0, s, vec);
  stage(0);
  sm90::cp_async_commit();

  // this thread's two queries (rows g, g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + g;
  const T* qw = qs + warp * 16 * LD;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, qn[2];

  const int nk = (s + kTcRows - 1) / kTcRows;
  const int n = p.causal ? min(qi + 1, nk) : nk;
  for (int kt = 0; kt < n; ++kt) {
    if (kt + 1 < n) stage(kt + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q) landed
    const int k0 = kt * kTcRows, st = kt & 1;
    const T* k_t = ks + st * kTcRows * LD;
    const T* v_t = vs + st * kTcRows * LD;
    const float* b_t = bias_s + st * kTcRows;
    if (kt == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        qn[h2] = row_norm<T, D>(qw + (g + h2 * 8) * LD);
    }
    for (int i = threadIdx.x; i < kTcRows; i += kTcThreads)
      kn_s[i] = row_norm<T, D>(k_t + i * LD);
    __syncthreads();  // the tile's key norms
    float kmax = 0.f;
    for (int i = lane; i < kTcRows; i += 32) kmax = fmaxf(kmax, kn_s[i]);
    kmax = warp_max(kmax);
    // per row: a bound on |sc - sc_plain| before the key's bias term
    // (S within es of the plain S, two roundings a side), |S scale|, and
    // the last live key of the tile (past s, or above the row when causal;
    // none for rows past s)
    float err0[2], sx[2], es_s[2];
    int lim[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      sx[h2] = qn[h2] * kmax * p.scale;
      es_s[h2] = kProductSlack * qn[h2] * kmax * p.scale;
      err0[h2] = es_s[h2] + 2.4e-7f * sx[h2];
      const int row = row0 + h2 * 8;
      lim[h2] = row >= s ? -1 : (p.causal ? min(row, s - 1) : s - 1) - k0;
    }

    // the tensor-core scores of this warp's 16 queries x 64 keys; hi and lo
    // bound the plain tile max of each row from above and below
    float sc[NJ][4];
    tc_abt<T, D, kTcRows>(sc, qw, k_t, LD, lane);
    uint32_t live = 0;
    float hi[2] = {kNegInf, kNegInf}, lo[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, kc = j * 8 + 2 * tg + (e & 1);
        const bool ok = kc <= lim[h2];
        live |= ok ? 1u << (j * 4 + e) : 0u;
        if constexpr (BIAS) {
          const float bias = b_t[kc];
          const float err = err0[h2] + 1.2e-7f * fabsf(bias);
          sc[j][e] = ok ? score_of(sc[j][e], p.scale, bias) : kNegInf;
          hi[h2] = fmaxf(hi[h2], ok ? sc[j][e] + err : kNegInf);
          lo[h2] = fmaxf(lo[h2], ok ? sc[j][e] - err : kNegInf);
        } else {
          sc[j][e] = ok ? __fmul_rn(sc[j][e], p.scale) : kNegInf;
          hi[h2] = fmaxf(hi[h2], sc[j][e]);
        }
      }
    // the pairs that may hold the plain tile max where it may pass the
    // running max m (none when hi < m): the plain max is at least lo, so
    // no pair whose sc + err is below max(lo, m) matters; their scores
    // summed again in the plain order give the tile max, and m_new, exactly
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if constexpr (BIAS) {
        hi[h2] = quad_max(hi[h2]);
        lo[h2] = fmaxf(quad_max(lo[h2]), m[h2]);
      } else {
        const float mx = quad_max(hi[h2]);
        hi[h2] = mx > kNegInf ? mx + err0[h2] : kNegInf;
        lo[h2] = fmaxf(mx - err0[h2], m[h2]);
      }
    }
    uint32_t cand = 0;
    if (hi[0] >= m[0] || hi[1] >= m[1]) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1;
          const float err =
              BIAS ? err0[h2] +
                         1.2e-7f * fabsf(b_t[j * 8 + 2 * tg + (e & 1)])
                   : err0[h2];
          if (hi[h2] >= m[h2] && sc[j][e] + err >= lo[h2])
            cand |= live & 1u << (j * 4 + e);
        }
    }
    float mt[2] = {kNegInf, kNegInf};
    for (uint32_t f = cand; f != 0u; f &= f - 1u) {
      const int pos = __ffs(f) - 1, h2 = (pos & 3) >> 1;
      const int kc = (pos >> 2) * 8 + 2 * tg + (pos & 1);
      const float v = score_of(
          seq_dot<T, D>(qw + (g + h2 * 8) * LD, k_t + kc * LD), p.scale,
          BIAS ? b_t[kc] : 0.f);
      mt[0] = h2 ? mt[0] : fmaxf(mt[0], v);
      mt[1] = h2 ? fmaxf(mt[1], v) : mt[1];
    }
    float m_new[2], corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      m_new[h2] = fmaxf(m[h2], quad_max(mt[h2]));
      corr[h2] = expf(__fsub_rn(m[h2], m_new[h2]));
    }

    // P at the plain bits: the candidates, and the pairs whose P lies
    // within the bound of a rounding edge of T (edge_bound's ex and tp,
    // with each key's bias), are summed again
    float exb[2];
    NearEdge<T> near[2] = {NearEdge<T>(0.f), NearEdge<T>(0.f)};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      exb[h2] = es_s[h2] + 1.2e-7f * (3.f * sx[h2] + fabsf(m_new[h2]));
      near[h2] = NearEdge<T>((exb[h2] * (1.f + exb[h2]) + 4.8e-7f) *
                                 16777216.f + 10.f);
    }
    uint32_t flags = cand;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, bit = j * 4 + e;
        const float x = __fsub_rn(sc[j][e], m_new[h2]);
        const float pr = live >> bit & 1u ? expf(x) : 0.f;
        bool near_edge;
        if constexpr (BIAS) {
          const float ex =
              exb[h2] + 2.4e-7f * fabsf(b_t[j * 8 + 2 * tg + (e & 1)]);
          near_edge = x + ex >= p_zero_below<T>() &&
                      NearEdge<T>((ex * (1.f + ex) + 4.8e-7f) * 16777216.f +
                                  10.f)(pr);
        } else {
          near_edge = x + exb[h2] >= p_zero_below<T>() && near[h2](pr);
        }
        if ((live >> bit & 1u) && near_edge) flags |= 1u << bit;
        sc[j][e] = pr;  // P, rounded to T as the P.V product's A operand
      }
    // each lane sums its own flagged pairs again (a few a warp tile: one
    // lane seldom holds more than one), through its slots in shared memory
    for (uint32_t f = flags; f != 0u; f &= f - 1u) {
      const int pos = __ffs(f) - 1, h2 = (pos & 3) >> 1;
      const int kc = (pos >> 2) * 8 + 2 * tg + (pos & 1);
      const float v = score_of(
          seq_dot<T, D>(qw + (g + h2 * 8) * LD, k_t + kc * LD), p.scale,
          BIAS ? b_t[kc] : 0.f);
      pw[pos] = expf(__fsub_rn(v, h2 ? m_new[1] : m_new[0]));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (flags >> (j * 4 + e) & 1u) sc[j][e] = pw[j * 4 + e];

    // the online softmax: l and acc rescaled, then += P . V
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        rs += sc[j][2 * h2] + sc[j][2 * h2 + 1];
      l[h2] = l[h2] * corr[h2] + quad_sum(rs);
      m[h2] = m_new[h2];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    tc_pb<T, D, kTcRows>(acc, sc, v_t, LD, lane);
    __syncthreads();  // every warp is done with stage st
  }
  sm90::cp_async_wait<0>();

  float ls[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    ls[h2] = l[h2] == 0.f ? 1.f : l[h2];
    const int row = row0 + h2 * 8;
    if (tg == 0 && row < s)
      p.lse[(static_cast<int64_t>(bi) * s + row) * p.h + head] =
          m[h2] + logf(ls[h2]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fdiv_rn(acc[j][e], ls[e >> 1]);
  tc_store<T, D>(static_cast<T*>(p.out) + bi * p.out_sb + head * D, p.out_ss,
                 q0 + warp * 16, s, acc, lane);
}

// dk and dv for one (batch, head, 64-key tile), walking the query tiles of
// BQ rows from the diagonal down; warp w owns keys k0 + 16 w .. + 15.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    flash_bwd_dkdv_tc_kernel(const FlashParams p) {
  constexpr int LD = TcTile<D>::ld, BQ = TcTile<D>::bq;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* ks = reinterpret_cast<T*>(tc_smem);      // [64][LD]
  T* vs = ks + kTcRows * LD;                  // [64][LD]
  T* qs = vs + kTcRows * LD;                  // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;                  // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]
  float* qn_s = delta_s + 2 * BQ;   // [BQ] |q| of the tile's rows
  float* dn_s = qn_s + BQ;          // [BQ] |dO|
  float* kb_s = dn_s + BQ;          // [64] the keys' bias
  constexpr int NPOS = BQ / 2;      // a thread's pairs a tile (j * 4 + e)
  float2* wr = reinterpret_cast<float2*>(kb_s + kTcRows) +
               threadIdx.x / 32 * kTcList;  // this warp's re-summed pairs
  unsigned short* wl = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float2*>(kb_s + kTcRows) + 4 * kTcList) +
      threadIdx.x / 32 * kTcList;           // and their (lane, position)

  const int kj = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int s = p.s;
  const int k0 = kj * kTcRows;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const T* db = static_cast<const T*>(p.dout) + bi * p.out_sb + head * D;
  const bool vec_qkv = rows_aligned(qb, p.qkv_ss) &&
                       rows_aligned(kb, p.qkv_ss) && rows_aligned(vb, p.qkv_ss);
  const bool vec_do = rows_aligned(db, p.out_ss);
  const int64_t rows_at = static_cast<int64_t>(bi) * s;  // lse/delta row 0

  // this thread's two keys (rows g, g + 8 of the warp's 16) and their bias
  const int key0 = k0 + warp * 16 + g;
  for (int i = threadIdx.x; i < kTcRows; i += kTcThreads)
    kb_s[i] = (p.bias != nullptr && k0 + i < s) ? p.bias[bi * p.bias_sb + k0 + i]
                                                : 0.f;
  float kbias[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = key0 + h2 * 8;
    kbias[h2] = (p.bias != nullptr && key < s) ? p.bias[bi * p.bias_sb + key]
                                               : 0.f;
  }

  const int nq = (s + BQ - 1) / BQ;
  const int first = p.causal ? k0 / BQ : 0;
  const int n = nq - first;
  auto stage = [&](int it) {
    const int q0 = (first + it) * BQ, st = it & 1;
    tc_rows<T, D, BQ>(qs + st * BQ * LD, LD, qb, p.qkv_ss, q0, s, vec_qkv);
    tc_rows<T, D, BQ>(dos + st * BQ * LD, LD, db, p.out_ss, q0, s, vec_do);
    for (int i = threadIdx.x; i < BQ; i += kTcThreads) {
      const int row = q0 + i;
      const int64_t at = (rows_at + row) * p.h + head;
      lse_s[st * BQ + i] = row < s ? p.lse_in[at] : 0.f;
      delta_s[st * BQ + i] = row < s ? p.delta[at] : 0.f;
    }
  };
  tc_rows<T, D, kTcRows>(ks, LD, kb, p.qkv_ss, k0, s, vec_qkv);
  tc_rows<T, D, kTcRows>(vs, LD, vb, p.qkv_ss, k0, s, vec_qkv);
  stage(0);
  sm90::cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  float kn[2], vn[2];  // |k|, |v| of this thread's two keys
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) stage(it + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // tile it (and K, V) landed
    const int q0 = (first + it) * BQ, st = it & 1;
    const T* q_t = qs + st * BQ * LD;
    const T* do_t = dos + st * BQ * LD;
    if (it == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        kn[h2] = row_norm<T, D>(ks + (warp * 16 + g + h2 * 8) * LD);
        vn[h2] = row_norm<T, D>(vs + (warp * 16 + g + h2 * 8) * LD);
      }
    }
    for (int i = threadIdx.x; i < 2 * BQ; i += kTcThreads) {
      if (i < BQ)
        qn_s[i] = row_norm<T, D>(q_t + i * LD);
      else
        dn_s[i - BQ] = row_norm<T, D>(do_t + (i - BQ) * LD);
    }
    __syncthreads();  // the tile's row norms
    // the check's bounds for this thread's two keys over the tile
    float qmax = 0.f, dmax = 0.f, lmax = 0.f;
    for (int i = lane; i < BQ; i += 32) {
      qmax = fmaxf(qmax, qn_s[i]);
      dmax = fmaxf(dmax, dn_s[i]);
      lmax = fmaxf(lmax, fabsf(lse_s[st * BQ + i]));
    }
    qmax = warp_max(qmax);
    dmax = warp_max(dmax);
    lmax = warp_max(lmax);
    EdgeBound eb[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      eb[h2] = edge_bound(kProductSlack * kn[h2] * qmax,
                          qmax * kn[h2] * p.scale, kbias[h2], lmax,
                          kProductSlack * vn[h2] * dmax, p.scale);
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float sc[BQ / 8][4], dp[BQ / 8][4];
    tc_abt<T, D, BQ>(sc, ks + warp * 16 * LD, q_t, LD, lane);
    tc_abt<T, D, BQ>(dp, vs + warp * 16 * LD, do_t, LD, lane);
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, key = key0 + h2 * 8;
        const int qc = j * 8 + 2 * tg + (e & 1), query = q0 + qc;
        const bool ok = key < s && query < s && (!p.causal || query >= key);
        PairTerms t{0.f, 0.f, 0.f, 0.f};
        if (ok) {
          t = pair_terms(sc[j][e], dp[j][e], p.scale, kbias[h2],
                         lse_s[st * BQ + qc], delta_s[st * BQ + qc]);
          if (near_plain_edge<T>(t, eb[h2])) flags |= 1u << (j * 4 + e);
        }
        sc[j][e] = t.p;   // P^T, rounded to T as the dV product's A operand
        dp[j][e] = t.ds;  // dS^T, likewise for dK
      }
    resolve_flagged<BQ / 8>(
        flags, wr, wl, lane,
        [&](int owner, int pos) {
          const int qc = (pos >> 2) * 8 + 2 * (owner & 3) + (pos & 1);
          const int kl = warp * 16 + (owner >> 2) + ((pos & 3) >> 1) * 8;
          const float2 sd = seq_dots<T, D>(q_t + qc * LD, ks + kl * LD,
                                           do_t + qc * LD, vs + kl * LD);
          const PairTerms t = pair_terms(sd.x, sd.y, p.scale, kb_s[kl],
                                         lse_s[st * BQ + qc],
                                         delta_s[st * BQ + qc]);
          return make_float2(t.p, t.ds);
        },
        [&](int j, int e, bool taken, float2 v) {
          sc[j][e] = taken ? v.x : sc[j][e];
          dp[j][e] = taken ? v.y : dp[j][e];
        });
    tc_pb<T, D, BQ>(dv, sc, do_t, LD, lane);  // dV += P^T dO
    tc_pb<T, D, BQ>(dk, dp, q_t, LD, lane);   // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st
  }
  sm90::cp_async_wait<0>();

  const int64_t gbase = bi * p.grad_sb + head * D;
  tc_store<T, D>(static_cast<T*>(p.dk) + gbase, p.grad_ss, k0 + warp * 16, s,
                 dk, lane);
  tc_store<T, D>(static_cast<T*>(p.dv) + gbase, p.grad_ss, k0 + warp * 16, s,
                 dv, lane);
}

// dq for one (batch, head, 64-query tile), walking the key tiles of 64; warp
// w owns queries q0 + 16 w .. + 15. The heaviest causal tiles (the last
// queries) are scheduled first.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    flash_bwd_dq_tc_kernel(const FlashParams p) {
  constexpr int LD = TcTile<D>::ld;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);      // [64][LD]
  T* dos = qs + kTcRows * LD;                 // [64][LD]
  T* ks = dos + kTcRows * LD;                 // [2][64][LD]
  T* vs = ks + 2 * kTcRows * LD;              // [2][64][LD]
  float* bias_s = reinterpret_cast<float*>(vs + 2 * kTcRows * LD);  // [2][64]
  float* kn_s = bias_s + 2 * kTcRows;  // [64] |k| of the tile's keys
  float* vn_s = kn_s + kTcRows;        // [64] |v|
  float* lq_s = vn_s + kTcRows;        // [64] lse of the block's queries
  float* dq_s = lq_s + kTcRows;        // [64] delta
  constexpr int NPOS = kTcRows / 2;    // a thread's pairs a tile
  float* wr = dq_s + kTcRows +
              threadIdx.x / 32 * kTcList;  // this warp's re-summed dS
  unsigned short* wl = reinterpret_cast<unsigned short*>(
      dq_s + kTcRows + 4 * kTcList) + threadIdx.x / 32 * kTcList;

  const int s = p.s;
  const int nq = (s + kTcRows - 1) / kTcRows;
  const int qi = p.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = qi * kTcRows;
  const int64_t base = bi * p.qkv_sb + head * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const T* db = static_cast<const T*>(p.dout) + bi * p.out_sb + head * D;
  const float* biasb = p.bias ? p.bias + bi * p.bias_sb : nullptr;
  const bool vec_qkv = rows_aligned(qb, p.qkv_ss) &&
                       rows_aligned(kb, p.qkv_ss) && rows_aligned(vb, p.qkv_ss);
  const bool vec_do = rows_aligned(db, p.out_ss);

  // this thread's two queries (rows g, g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + h2 * 8;
    const int64_t at = (static_cast<int64_t>(bi) * s + row) * p.h + head;
    lse_r[h2] = row < s ? p.lse_in[at] : 0.f;
    delta_r[h2] = row < s ? p.delta[at] : 0.f;
  }
  for (int i = threadIdx.x; i < kTcRows; i += kTcThreads) {
    const int row = q0 + i;
    const int64_t at = (static_cast<int64_t>(bi) * s + row) * p.h + head;
    lq_s[i] = row < s ? p.lse_in[at] : 0.f;
    dq_s[i] = row < s ? p.delta[at] : 0.f;
  }

  const int nk = (s + kTcRows - 1) / kTcRows;
  const int n = p.causal ? min(qi + 1, nk) : nk;
  auto stage = [&](int kt) {
    const int k0 = kt * kTcRows, st = kt & 1;
    tc_rows<T, D, kTcRows>(ks + st * kTcRows * LD, LD, kb, p.qkv_ss, k0, s,
                           vec_qkv);
    tc_rows<T, D, kTcRows>(vs + st * kTcRows * LD, LD, vb, p.qkv_ss, k0, s,
                           vec_qkv);
    for (int i = threadIdx.x; i < kTcRows; i += kTcThreads)
      bias_s[st * kTcRows + i] =
          (biasb != nullptr && k0 + i < s) ? biasb[k0 + i] : 0.f;
  };
  tc_rows<T, D, kTcRows>(qs, LD, qb, p.qkv_ss, q0, s, vec_qkv);
  tc_rows<T, D, kTcRows>(dos, LD, db, p.out_ss, q0, s, vec_do);
  stage(0);
  sm90::cp_async_commit();

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  float qn[2], dn[2];  // |q|, |dO| of this thread's two queries
  for (int kt = 0; kt < n; ++kt) {
    if (kt + 1 < n) stage(kt + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kTcRows, st = kt & 1;
    const T* k_t = ks + st * kTcRows * LD;
    const T* v_t = vs + st * kTcRows * LD;
    if (kt == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        qn[h2] = row_norm<T, D>(qs + (warp * 16 + g + h2 * 8) * LD);
        dn[h2] = row_norm<T, D>(dos + (warp * 16 + g + h2 * 8) * LD);
      }
    }
    for (int i = threadIdx.x; i < 2 * kTcRows; i += kTcThreads) {
      if (i < kTcRows)
        kn_s[i] = row_norm<T, D>(k_t + i * LD);
      else
        vn_s[i - kTcRows] = row_norm<T, D>(v_t + (i - kTcRows) * LD);
    }
    __syncthreads();  // the tile's row norms
    // the check's bounds for this thread's two queries over the tile
    float kmax = 0.f, vmax = 0.f;
    for (int i = lane; i < kTcRows; i += 32) {
      kmax = fmaxf(kmax, kn_s[i]);
      vmax = fmaxf(vmax, vn_s[i]);
    }
    kmax = warp_max(kmax);
    vmax = warp_max(vmax);
    EdgeBound eb[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      eb[h2] = edge_bound(kProductSlack * qn[h2] * kmax,
                          qn[h2] * kmax * p.scale, 0.f, fabsf(lse_r[h2]),
                          kProductSlack * dn[h2] * vmax, p.scale);
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float sc[kTcRows / 8][4], dp[kTcRows / 8][4];
    tc_abt<T, D, kTcRows>(sc, qs + warp * 16 * LD, k_t, LD, lane);
    tc_abt<T, D, kTcRows>(dp, dos + warp * 16 * LD, v_t, LD, lane);
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < kTcRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, row = row0 + h2 * 8;
        const int kc = j * 8 + 2 * tg + (e & 1), key = k0 + kc;
        const bool ok = row < s && key < s && (!p.causal || row >= key);
        float ds = 0.f;
        if (ok) {
          const float bias = bias_s[st * kTcRows + kc];
          const PairTerms t = pair_terms(sc[j][e], dp[j][e], p.scale, bias,
                                         lse_r[h2], delta_r[h2]);
          EdgeBound b = eb[h2];
          if (bias != 0.f)
            b = edge_bound(kProductSlack * qn[h2] * kmax,
                           qn[h2] * kmax * p.scale, bias, fabsf(lse_r[h2]),
                           kProductSlack * dn[h2] * vmax, p.scale);
          if (near_plain_edge<T>(t, b)) flags |= 1u << (j * 4 + e);
          ds = t.ds;
        }
        dp[j][e] = ds;  // dS, rounded to T as the dQ product's A operand
      }
    resolve_flagged<kTcRows / 8>(
        flags, wr, wl, lane,
        [&](int owner, int pos) {
          const int kc = (pos >> 2) * 8 + 2 * (owner & 3) + (pos & 1);
          const int ql = warp * 16 + (owner >> 2) + ((pos & 3) >> 1) * 8;
          const float2 sd = seq_dots<T, D>(qs + ql * LD, k_t + kc * LD,
                                           dos + ql * LD, v_t + kc * LD);
          return pair_terms(sd.x, sd.y, p.scale, bias_s[st * kTcRows + kc],
                            lq_s[ql], dq_s[ql]).ds;
        },
        [&](int j, int e, bool taken, float v) {
          dp[j][e] = taken ? v : dp[j][e];
        });
    tc_pb<T, D, kTcRows>(dq, dp, k_t, LD, lane);  // dQ += dS K
    __syncthreads();
  }
  sm90::cp_async_wait<0>();

  tc_store<T, D>(static_cast<T*>(p.dq) + bi * p.grad_sb + head * D,
                 p.grad_ss, q0 + warp * 16, s, dq, lane);
}

// dk/dv query tile: 64 rows, or 32 at d = 128 (shared memory holds 227 KB)
template <int D>
struct DkdvTile {
  static constexpr int value = D > 64 ? 32 : 64;
};

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLd + kTile * D + kTile * kLd + kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLd + kTile * D + kTile * kLd + kTile);
}
template <int D, int BQ>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * D * kLd + 2 * D * (BQ + 4) + 2 * BQ * D +
                          2 * BQ * kLd + kTile);
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  return sizeof(__nv_bfloat16) * (2 * kTcRows + 4 * TcTile<D>::bq) *
             TcTile<D>::ld +
         sizeof(float) * (6 * TcTile<D>::bq + kTcRows) +
         (sizeof(float2) + sizeof(unsigned short)) * 4 * kTcList;
}
template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(__nv_bfloat16) * 6 * kTcRows * TcTile<D>::ld +
         sizeof(float) * 6 * kTcRows +
         (sizeof(float) + sizeof(unsigned short)) * 4 * kTcList;
}
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(__nv_bfloat16) * 5 * kTcRows * TcTile<D>::ld +
         sizeof(float) * (3 * kTcRows + kTcThreads * 33);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const FlashParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

// bf16 and fp16: the tensor-core kernels; fp32: the FMA kernels (the
// parity runs: TF32 would break them). Static: nothing falls back.
template <typename T, int D>
cudaError_t dispatch(Which which, const FlashParams& p, cudaStream_t st) {
  const int nq = (p.s + kTile - 1) / kTile;
  const dim3 grid(nq, p.h, p.b);
  constexpr bool tc = !std::is_same<T, float>::value;
  switch (which) {
    case kFwd:
      if constexpr (tc)
        return p.bias ? launch(flash_fwd_tc_kernel<T, D, true>, grid,
                               kTcThreads, fwd_tc_smem<D>(), p, st)
                      : launch(flash_fwd_tc_kernel<T, D, false>, grid,
                               kTcThreads, fwd_tc_smem<D>(), p, st);
      else
        return launch(flash_fwd_kernel<T, D>, grid, kThreads, fwd_smem<D>(),
                      p, st);
    case kDq:
      if constexpr (tc)
        return launch(flash_bwd_dq_tc_kernel<T, D>, grid, kTcThreads,
                      dq_tc_smem<D>(), p, st);
      else
        return launch(flash_bwd_dq_kernel<T, D>, grid, kThreads, dq_smem<D>(),
                      p, st);
    default:
      if constexpr (tc) {
        return launch(flash_bwd_dkdv_tc_kernel<T, D>, grid, kTcThreads,
                      dkdv_tc_smem<D>(), p, st);
      } else {
        constexpr int BQ = DkdvTile<D>::value;
        return launch(flash_bwd_dkdv_kernel<T, D, BQ>, grid, kThreads,
                      dkdv_smem<D, BQ>(), p, st);
      }
  }
}

template <typename T>
cudaError_t dispatch_d(Which which, int d, const FlashParams& p,
                       cudaStream_t st) {
  switch (d) {
    case 32:
      return dispatch<T, 32>(which, p, st);
    case 64:
      return dispatch<T, 64>(which, p, st);
    case 128:
      return dispatch<T, 128>(which, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Which which, const FlashParams* p, int dtype, int d, void* stream) {
  if (p == nullptr || p->b <= 0 || p->s <= 0 || p->h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_d<float>(which, d, *p, st));
    case 1:
      return static_cast<int>(dispatch_d<__nv_bfloat16>(which, d, *p, st));
    case 2:
      return static_cast<int>(dispatch_d<__half>(which, d, *p, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d: 32, 64 or 128.
// Each returns a cudaError_t; the kernels run on `stream` without a sync.
extern "C" int flash_fwd_launch(const FlashParams* p, int dtype, int d,
                                void* stream) {
  return run(kFwd, p, dtype, d, stream);
}

extern "C" int flash_bwd_dq_launch(const FlashParams* p, int dtype, int d,
                                   void* stream) {
  return run(kDq, p, dtype, d, stream);
}

extern "C" int flash_bwd_dkdv_launch(const FlashParams* p, int dtype, int d,
                                     void* stream) {
  return run(kDkdv, p, dtype, d, stream);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
