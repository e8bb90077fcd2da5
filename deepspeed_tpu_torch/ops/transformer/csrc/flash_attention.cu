// Packed flash attention for Hopper (sm_90a): forward, and the backward as
// two kernels (dk/dv, then dq).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_packed (pallas_call at :540 resident, :566
//                             streaming)
//   flash_bwd_dkdv_kernel  <- _bwd_fused_packed (:795, :816) and the dk/dv
//   flash_bwd_dq_kernel       half (:962) and dq half (:937) of
//                             _bwd_split_packed: both TPU functions compute the
//                             same (dq, dk, dv), which these two kernels
//                             compute without atomics, so dq is deterministic
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
// 34 GFLOP), the backward by operations. These kernels are the simple first
// version: every product runs on the CUDA cores in fp32 FMA from tiles staged
// in shared memory, with a 4x4 register tile per thread and float4 shared
// loads, so they run well above the tensor-core bound. Left for later work:
// wgmma/mma.sync tensor-core products, cp.async/TMA double-buffering of the
// next tile, and smaller tile transposes.
//
// Tiles: 64 query rows (fwd, dq) or 64 keys (dk/dv) per block of 256 threads
// (16 x 16); each thread owns 4 rows x 4 columns of a 64 x 64 score tile and
// 4 rows x d/16 columns of the output tile. Causal tiles above the diagonal
// are skipped, not masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const FlashParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

template <typename T, int D>
cudaError_t dispatch(Which which, const FlashParams& p, cudaStream_t st) {
  const int nq = (p.s + kTile - 1) / kTile;
  const dim3 grid(nq, p.h, p.b);
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, grid, fwd_smem<D>(), p, st);
    case kDq:
      return launch(flash_bwd_dq_kernel<T, D>, grid, dq_smem<D>(), p, st);
    default: {
      constexpr int BQ = DkdvTile<D>::value;
      return launch(flash_bwd_dkdv_kernel<T, D, BQ>, grid, dkdv_smem<D, BQ>(),
                    p, st);
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
