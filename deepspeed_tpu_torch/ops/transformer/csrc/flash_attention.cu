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
// P and dS at the plain versions' bits (tc_attention.cuh, shared with the
// block-sparse backward: the tensor cores sum S and dP in another order,
// so pairs near a rounding edge of the input type, fp16's own edges
// included, subnormal range and all, are summed again in the plain order;
// the forward also takes its running max exactly). Rows
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
#include "tc_attention.cuh"

namespace {

using namespace tc_attention;

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows (fwd, dq) and keys (all)
constexpr int kLd = kTile + 4;     // leading dim of a transposed 64-wide tile
constexpr float kNegInf = -1e30f;

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

constexpr int kTcRows = 64;      // keys (dk/dv) or queries (fwd, dq) a block

template <int D>
struct TcTile {
  static constexpr int ld = D + 8;                 // padded smem row
  static constexpr int bq = 32;  // dk/dv query tile: three blocks an SM
};

// out and lse for one (batch, head, 64-query tile), walking the key tiles
// of 64 in ascending order (the plain version's tiles: its running max
// changes at the same keys); warp w owns queries q0 + 16 w .. + 15, so the
// row max and sum cross only the 4 lanes of a quad. The heaviest causal
// tiles (the last queries) are scheduled first. Each tile is one
// tc_fwd_step (tc_attention.cuh, shared with the block-sparse forward): P
// and the running max at the plain version's bits. BIAS switches the key
// bias's terms off at compile time (none on GPT-2's path); at d <= 64, 168
// registers keep three blocks on an SM.
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
    // the last live key of the tile for each row (past s, or above the
    // row when causal; none for rows past s)
    int lim[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + h2 * 8;
      lim[h2] = row >= s ? -1 : (p.causal ? min(row, s - 1) : s - 1) - k0;
    }
    auto live = [&](int kc, int h2) { return kc <= lim[h2]; };
    // the tensor-core scores of this warp's 16 queries x 64 keys, then the
    // online softmax step with P and the running max at the plain bits
    float sc[NJ][4];
    tc_abt<T, D, kTcRows>(sc, qw, k_t, LD, lane);
    if constexpr (BIAS)
      tc_fwd_step<T, D, kTcRows, true>(sc, live, m, l, acc, qw, k_t, v_t, LD,
                                       qn, kmax, p.scale,
                                       FwdKeyBias{p.scale, b_t}, pw, lane);
    else
      tc_fwd_step<T, D, kTcRows, false>(sc, live, m, l, acc, qw, k_t, v_t, LD,
                                        qn, kmax, p.scale, FwdScale{p.scale},
                                        pw, lane);
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
