// Block-sparse attention over a layout for Hopper (sm_90a): forward, dq, and
// dk/dv.
//
// Replaces the TPU kernels of
// deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:
//   block_sparse_fwd_kernel      <- _fwd_pk (pallas_call :749, shared layouts,
//                                   all heads per grid step) and _fwd (:923,
//                                   per-head layouts)
//   block_sparse_bwd_dq_kernel   <- the dq halves of _bwd_pk (:792) and _bwd
//                                   (:959)
//   block_sparse_bwd_dkdv_kernel <- the dk/dv halves of _bwd_pk (:823) and
//                                   _bwd (:988), the transposed-layout walk
// Both TPU implementations compute one function; here the layout tables carry
// one layout head for a shared layout (every head reads head 0) and h heads
// otherwise, so one trio covers both.
//
// Layout: q, k, v, dout are (b, h, s, d) read through their (batch, head,
// row) strides with unit stride on d (the (b, h, s, d) views of one QKV
// projection); out, dq, dk, dv are written through the o_* strides (the
// wrapper gives (b, s, h, d) contiguous memory). lse and delta are (b, h, s)
// fp32. kpm is an optional (b, s) fp32 additive key bias, bias an optional
// (s, s) fp32 additive score bias.
//
// Numerics (the TPU kernels' contract, and the plain PyTorch versions'):
// score = (q . k) * scale + kpm[key] + bias[query, key]; a pair the layout
// does not hold, and when causal a key after its query, is NEG_INF = -1e30.
// Online softmax in fp32; a row whose running max is still NEG_INF gets p = 0;
// probabilities rounded to the input type before P.V; a row with no surviving
// key gets out = 0 and lse = NEG_INF. Backward: p = exp(score - lse) (0 where
// masked or lse is NEG_INF), ds = p * (dp - delta) * scale rounded to the
// input type, delta = rowsum(dout * out) taken outside in fp32. All sums fp32.
//
// The walk (built on the host, block_sparse_attention.py::Walk): the tokens
// of one side (queries for fwd/dq, keys for dk/dv) are cut into tiles of 64,
// each a group of layout "units" (gcd(block, 64) tokens: a whole block, or
// half of a 128 block). A tile walks the ascending union of its units'
// active blocks on the other side, 64 tokens a step (dk/dv: kBq queries),
// and masks each (unit, block) pair through the dense layout. One thread
// block per (batch x head, tile); tiles are launched longest walk first
// (blockIdx.y indexes the `order` table). No atomics: dq is deterministic.
// A warp owns 8 anchor rows (one unit) and skips a step's products when none
// of its pairs is in the layout, which is what keeps the transposed walk of
// a layout with global columns (fixed, bigbird) near its real work.
//
// Bound on the H100 at the training shape (b 2, s 8192, h 16, d 64, bf16,
// fixed layout, block 16: 33,792 active block pairs per head): operations,
// 71 GFLOP forward on active pairs against 0.04 ms of bytes. These kernels
// are the simple first version: every product on the CUDA cores in fp32 FMA
// from shared-memory tiles, each thread owning a 4x4 score tile, so they run
// far above the tensor-core bound. Left for later work: mma/wgmma products,
// cp.async/TMA double-buffering of the next step's gathered tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // anchor rows per tile, keys per fwd/dq step
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

// Rows at token positions pos[0..R) (-1 = a zero row) of a (s x D) slice with
// row stride ss, into shared memory as fp32, transposed (dst[c * ld + r]) or
// row-major (dst[r * D + c]).
template <typename T, int D, int R>
__device__ __forceinline__ void gather_t(float* dst, int ld, const T* src,
                                         int64_t ss, const int* pos) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int p = pos[r];
    dst[c * ld + r] = p >= 0 ? to_f(src[p * ss + c]) : 0.f;
  }
}

template <typename T, int D, int R>
__device__ __forceinline__ void gather(float* dst, const T* src, int64_t ss,
                                       const int* pos) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int p = pos[r];
    dst[i] = p >= 0 ? to_f(src[p * ss + c]) : 0.f;
  }
}

}  // namespace

// Launch arguments, mirrored by a ctypes.Structure in
// block_sparse_attention.py. Strides are in elements.
struct SparseParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;      // backward only
  const float* kpm;      // (b, s) key bias, batch stride kpm_sb, or null
  const float* bias;     // (s, s) score bias, row stride bias_ss, or null
  const float* lse_in;   // backward only, (b, h, s)
  const float* delta;    // backward only, (b, h, s)
  void* out;             // forward only
  float* lse;            // forward only, (b, h, s)
  void* dq;
  void* dk;
  void* dv;
  const unsigned char* layout;  // (layout_heads, nb, nb): [query blk][key blk]
  const int* units;      // (layout_heads, n_tiles, 64 / unit), -1 = none
  const int* ptr;        // (layout_heads, n_tiles + 1) into idx
  const int* idx;        // each tile's walk: ascending blocks
  const int* order;      // (layout_heads, n_tiles): longest walk first
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t o_sb, o_sh, o_ss;  // out / dq / dk and dv
  int64_t kpm_sb, bias_ss;
  int b, s, h, block, unit, nb, n_tiles, layout_heads, causal;
  float scale;
};

namespace {

// Where a block works: its batch, head, layout head, tile and walk.
struct TileWork {
  int bi, head, hl, tile, len;
  const int* walk;
};

__device__ __forceinline__ TileWork tile_work(const SparseParams& p) {
  TileWork w;
  w.bi = blockIdx.x / p.h;
  w.head = blockIdx.x % p.h;
  w.hl = p.layout_heads == 1 ? 0 : w.head;
  w.tile = p.order[w.hl * p.n_tiles + blockIdx.y];
  const int* ptr = p.ptr + w.hl * (p.n_tiles + 1) + w.tile;
  w.walk = p.idx + ptr[0];
  w.len = ptr[1] - ptr[0];
  return w;
}

// The 64 anchor positions of the tile (-1 past its units) and their blocks.
__device__ __forceinline__ void anchor_positions(const SparseParams& p,
                                                 const TileWork& w, int* pos,
                                                 int* blk) {
  const int per_tile = kTile / p.unit;
  const int* units = p.units + (w.hl * p.n_tiles + w.tile) * per_tile;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int u = units[r / p.unit];
    const int at = u >= 0 ? u * p.unit + r % p.unit : -1;
    pos[r] = at;
    blk[r] = at >= 0 ? at / p.block : -1;
  }
}

// Step j of the walk, n tokens wide: the token position of each column (-1
// past the walk) and its block.
__device__ __forceinline__ void step_positions(const SparseParams& p,
                                               const TileWork& w, int j,
                                               int n, int* pos, int* blk) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int f = j * n + c;
    const int slot = f / p.block;
    if (slot < w.len) {
      const int b = w.walk[slot];
      blk[c] = b;
      pos[c] = b * p.block + f % p.block;
    } else {
      blk[c] = -1;
      pos[c] = -1;
    }
  }
}

__device__ __forceinline__ bool in_layout(const SparseParams& p, int hl,
                                          int qblk, int kblk) {
  return qblk >= 0 && kblk >= 0 &&
         p.layout[(static_cast<int64_t>(hl) * p.nb + qblk) * p.nb + kblk] != 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    block_sparse_fwd_kernel(const SparseParams p) {
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][kLd]     q tile, transposed
  float* kt = qt + D * kLd;          // [D][kLd]     k step, transposed
  float* vs = kt + D * kLd;          // [kTile][D]   v step
  float* pt = vs + kTile * D;        // [kTile][kLd] probabilities, [key][row]
  float* bs = pt + kTile * kLd;      // [kTile]      kpm of the step's keys
  int* apos = reinterpret_cast<int*>(bs + kTile);  // [kTile] anchor rows
  int* ablk = apos + kTile;
  int* kpos = ablk + kTile;          // [kTile] the step's keys
  int* kblk = kpos + kTile;

  const TileWork w = tile_work(p);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = static_cast<const T*>(p.q) + w.bi * p.q_sb + w.head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + w.bi * p.k_sb + w.head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.bi * p.v_sb + w.head * p.v_sh;
  const float* kpmb = p.kpm ? p.kpm + w.bi * p.kpm_sb : nullptr;

  anchor_positions(p, w, apos, ablk);
  __syncthreads();
  gather_t<T, D, kTile>(qt, kLd, qb, p.q_ss, apos);
  const int qblk = ablk[ty * 4];  // the 4 rows of a thread share one unit
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = apos[ty * 4 + i];

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int steps = (w.len * p.block + kTile - 1) / kTile;
  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // the previous step's readers are done
    step_positions(p, w, j, kTile, kpos, kblk);
    __syncthreads();
    gather_t<T, D, kTile>(kt, kLd, kb, p.k_ss, kpos);
    gather<T, D, kTile>(vs, vb, p.v_ss, kpos);
    if (tid < kTile)
      bs[tid] = (kpmb != nullptr && kpos[tid] >= 0) ? kpmb[kpos[tid]] : 0.f;
    __syncthreads();
    // the 4 keys of a thread share one block
    const bool pair = in_layout(p, w.hl, qblk, kblk[tx * 4]);
    const bool active = __any_sync(0xffffffffu, pair);

    if (active) {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a =
            *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
        const float4 bk =
            *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[i][jj] = fmaf(av[i], bv[jj], sc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rows[i];
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int key = kpos[tx * 4 + jj];
          const bool ok = pair && row >= 0 && (!p.causal || row >= key);
          float val = __fmul_rn(sc[i][jj], p.scale) + bs[tx * 4 + jj];
          if (ok && p.bias != nullptr)
            val += p.bias[static_cast<int64_t>(row) * p.bias_ss + key];
          sc[i][jj] = ok ? val : kNegInf;
          mx = fmaxf(mx, sc[i][jj]);
        }
        mx = row_max(mx);
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float pr = m_new <= kNegInf ? 0.f : expf(sc[i][jj] - m_new);
          rs += pr;
          pt[(tx * 4 + jj) * kLd + ty * 4 + i] = round_to<T>(pr);
        }
        rs = row_sum(rs);
        l[i] = __fmul_rn(l[i], corr) + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
      }
    }
    __syncthreads();  // the probability tile is complete

    if (active) {
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pt + t * kLd + ty * 4);
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
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rows[i];
    if (row >= 0) {
      const float ls = l[i] == 0.f ? 1.f : l[i];
      T* orow = out + w.bi * p.o_sb + w.head * p.o_sh + row * p.o_ss + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) orow[c] = from_f<T>(acc[i][c] / ls);
      if (tx == 0)
        p.lse[(static_cast<int64_t>(w.bi) * p.h + w.head) * p.s + row] =
            l[i] == 0.f ? kNegInf : m[i] + logf(ls);
    }
  }
}

// dq for one (batch x head, query tile), walking the tile's key blocks.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    block_sparse_bwd_dq_kernel(const SparseParams p) {
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][kLd]
  float* dot = qt + D * kLd;         // [D][kLd]     dout tile, transposed
  float* kt = dot + D * kLd;         // [D][kLd]
  float* vt = kt + D * kLd;          // [D][kLd]
  float* ks = vt + D * kLd;          // [kTile][D]   k step, row-major
  float* dst = ks + kTile * D;       // [kTile][kLd] ds, [key][row]
  float* bs = dst + kTile * kLd;     // [kTile]
  int* apos = reinterpret_cast<int*>(bs + kTile);
  int* ablk = apos + kTile;
  int* kpos = ablk + kTile;
  int* kblk = kpos + kTile;

  const TileWork w = tile_work(p);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = static_cast<const T*>(p.q) + w.bi * p.q_sb + w.head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + w.bi * p.k_sb + w.head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.bi * p.v_sb + w.head * p.v_sh;
  const T* db =
      static_cast<const T*>(p.dout) + w.bi * p.do_sb + w.head * p.do_sh;
  const float* kpmb = p.kpm ? p.kpm + w.bi * p.kpm_sb : nullptr;
  const int64_t rows_at = (static_cast<int64_t>(w.bi) * p.h + w.head) * p.s;

  anchor_positions(p, w, apos, ablk);
  __syncthreads();
  gather_t<T, D, kTile>(qt, kLd, qb, p.q_ss, apos);
  gather_t<T, D, kTile>(dot, kLd, db, p.do_ss, apos);
  const int qblk = ablk[ty * 4];
  int rows[4];
  float lse_r[4], delta_r[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = apos[ty * 4 + i];
    lse_r[i] = rows[i] >= 0 ? p.lse_in[rows_at + rows[i]] : kNegInf;
    delta_r[i] = rows[i] >= 0 ? p.delta[rows_at + rows[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int steps = (w.len * p.block + kTile - 1) / kTile;
  for (int j = 0; j < steps; ++j) {
    __syncthreads();
    step_positions(p, w, j, kTile, kpos, kblk);
    __syncthreads();
    gather_t<T, D, kTile>(kt, kLd, kb, p.k_ss, kpos);
    gather_t<T, D, kTile>(vt, kLd, vb, p.v_ss, kpos);
    gather<T, D, kTile>(ks, kb, p.k_ss, kpos);
    if (tid < kTile)
      bs[tid] = (kpmb != nullptr && kpos[tid] >= 0) ? kpmb[kpos[tid]] : 0.f;
    __syncthreads();
    const bool pair = in_layout(p, w.hl, qblk, kblk[tx * 4]);
    const bool active = __any_sync(0xffffffffu, pair);

    if (active) {
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a =
            *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
        const float4 g =
            *reinterpret_cast<const float4*>(dot + d * kLd + ty * 4);
        const float4 bk =
            *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(vt + d * kLd + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {g.x, g.y, g.z, g.w};
        const float kv[4] = {bk.x, bk.y, bk.z, bk.w};
        const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            sc[i][jj] = fmaf(av[i], kv[jj], sc[i][jj]);
            dp[i][jj] = fmaf(gv[i], vv[jj], dp[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rows[i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int key = kpos[tx * 4 + jj];
          const bool ok = pair && row >= 0 && lse_r[i] > kNegInf &&
                          (!p.causal || row >= key);
          float pr = 0.f;
          if (ok) {
            float val = __fmul_rn(sc[i][jj], p.scale) + bs[tx * 4 + jj];
            if (p.bias != nullptr)
              val += p.bias[static_cast<int64_t>(row) * p.bias_ss + key];
            pr = expf(val - lse_r[i]);
          }
          const float ds = __fmul_rn(__fmul_rn(pr, dp[i][jj] - delta_r[i]),
                                     p.scale);
          dst[(tx * 4 + jj) * kLd + ty * 4 + i] = round_to<T>(ds);
        }
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dst + t * kLd + ty * 4);
        const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
        float kr[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) kr[c] = ks[t * D + tx * CD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c)
            acc[i][c] = fmaf(dv4[i], kr[c], acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rows[i];
    if (row >= 0) {
      T* drow = dq + w.bi * p.o_sb + w.head * p.o_sh + row * p.o_ss + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) drow[c] = from_f<T>(acc[i][c]);
    }
  }
}

// dk and dv for one (batch x head, key tile), walking the tile's transposed
// layout: BQ query tokens a step. Scores are taken transposed: each thread
// owns 4 keys x BQ/16 queries.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    block_sparse_bwd_dkdv_kernel(const SparseParams p) {
  constexpr int CD = D / 16;
  constexpr int TQ = BQ / 16;  // query columns per thread
  constexpr int LQ = BQ + 4;   // leading dim of a transposed query step
  extern __shared__ float smem[];
  float* kt = smem;                  // [D][kLd]
  float* vt = kt + D * kLd;          // [D][kLd]
  float* qt = vt + D * kLd;          // [D][LQ]
  float* dot = qt + D * LQ;          // [D][LQ]
  float* qs = dot + D * LQ;          // [BQ][D]
  float* dos = qs + BQ * D;          // [BQ][D]
  float* pq = dos + BQ * D;          // [BQ][kLd]   p rounded, [query][key]
  float* dsq = pq + BQ * kLd;        // [BQ][kLd]   ds rounded, [query][key]
  float* bs = dsq + BQ * kLd;        // [kTile]     kpm of the tile's keys
  int* apos = reinterpret_cast<int*>(bs + kTile);  // [kTile] the tile's keys
  int* ablk = apos + kTile;
  int* qpos = ablk + kTile;          // [BQ] the step's queries
  int* qblk = qpos + BQ;

  const TileWork w = tile_work(p);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = static_cast<const T*>(p.q) + w.bi * p.q_sb + w.head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + w.bi * p.k_sb + w.head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.bi * p.v_sb + w.head * p.v_sh;
  const T* db =
      static_cast<const T*>(p.dout) + w.bi * p.do_sb + w.head * p.do_sh;
  const float* kpmb = p.kpm ? p.kpm + w.bi * p.kpm_sb : nullptr;
  const int64_t rows_at = (static_cast<int64_t>(w.bi) * p.h + w.head) * p.s;

  anchor_positions(p, w, apos, ablk);
  __syncthreads();
  gather_t<T, D, kTile>(kt, kLd, kb, p.k_ss, apos);
  gather_t<T, D, kTile>(vt, kLd, vb, p.v_ss, apos);
  if (tid < kTile)
    bs[tid] = (kpmb != nullptr && apos[tid] >= 0) ? kpmb[apos[tid]] : 0.f;
  const int kblk_own = ablk[ty * 4];  // the 4 keys of a thread share a unit
  int keys[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) keys[i] = apos[ty * 4 + i];

  float dk[4][CD], dv[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int steps = (w.len * p.block + BQ - 1) / BQ;
  for (int j = 0; j < steps; ++j) {
    __syncthreads();
    step_positions(p, w, j, BQ, qpos, qblk);
    __syncthreads();
    gather_t<T, D, BQ>(qt, LQ, qb, p.q_ss, qpos);
    gather_t<T, D, BQ>(dot, LQ, db, p.do_ss, qpos);
    gather<T, D, BQ>(qs, qb, p.q_ss, qpos);
    gather<T, D, BQ>(dos, db, p.do_ss, qpos);
    int qrow[TQ];
    float lse_c[TQ], delta_c[TQ];
#pragma unroll
    for (int jj = 0; jj < TQ; ++jj) {
      qrow[jj] = qpos[tx * TQ + jj];
      lse_c[jj] = qrow[jj] >= 0 ? p.lse_in[rows_at + qrow[jj]] : kNegInf;
      delta_c[jj] = qrow[jj] >= 0 ? p.delta[rows_at + qrow[jj]] : 0.f;
    }
    __syncthreads();
    // the TQ queries of a thread share one block
    const bool pair = in_layout(p, w.hl, qblk[tx * TQ], kblk_own);
    const bool active = __any_sync(0xffffffffu, pair);

    if (active) {
      float st[4][TQ], dpt[4][TQ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < TQ; ++jj) st[i][jj] = dpt[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a =
            *reinterpret_cast<const float4*>(kt + d * kLd + ty * 4);
        const float4 b =
            *reinterpret_cast<const float4*>(vt + d * kLd + ty * 4);
        const float kv[4] = {a.x, a.y, a.z, a.w};
        const float vv[4] = {b.x, b.y, b.z, b.w};
        float qv[TQ], gv[TQ];
#pragma unroll
        for (int jj = 0; jj < TQ; ++jj) {
          qv[jj] = qt[d * LQ + tx * TQ + jj];
          gv[jj] = dot[d * LQ + tx * TQ + jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < TQ; ++jj) {
            st[i][jj] = fmaf(kv[i], qv[jj], st[i][jj]);
            dpt[i][jj] = fmaf(vv[i], gv[jj], dpt[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = keys[i];
#pragma unroll
        for (int jj = 0; jj < TQ; ++jj) {
          const int q = qrow[jj];
          const bool ok = pair && key >= 0 && q >= 0 &&
                          lse_c[jj] > kNegInf && (!p.causal || q >= key);
          float pr = 0.f;
          if (ok) {
            float val = __fmul_rn(st[i][jj], p.scale) + bs[ty * 4 + i];
            if (p.bias != nullptr)
              val += p.bias[static_cast<int64_t>(q) * p.bias_ss + key];
            pr = expf(val - lse_c[jj]);
          }
          const float ds = __fmul_rn(__fmul_rn(pr, dpt[i][jj] - delta_c[jj]),
                                     p.scale);
          pq[(tx * TQ + jj) * kLd + ty * 4 + i] = round_to<T>(pr);
          dsq[(tx * TQ + jj) * kLd + ty * 4 + i] = round_to<T>(ds);
        }
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll 4
      for (int t = 0; t < BQ; ++t) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pq + t * kLd + ty * 4);
        const float4 d4 =
            *reinterpret_cast<const float4*>(dsq + t * kLd + ty * 4);
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
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = keys[i];
    if (key >= 0) {
      const int64_t at =
          w.bi * p.o_sb + w.head * p.o_sh + key * p.o_ss + tx * CD;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkp[at + c] = from_f<T>(dk[i][c]);
        dvp[at + c] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// dk/dv query step: 64 queries, or 32 at d = 128 (shared memory holds 227 KB)
template <int D>
struct DkdvStep {
  static constexpr int value = D > 64 ? 32 : 64;
};

constexpr size_t kIndexBytes = 4 * kTile * sizeof(int);

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLd + kTile * D + kTile * kLd + kTile) +
         kIndexBytes;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLd + kTile * D + kTile * kLd + kTile) +
         kIndexBytes;
}
template <int D, int BQ>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * D * kLd + 2 * D * (BQ + 4) + 2 * BQ * D +
                          2 * BQ * kLd + kTile) +
         kIndexBytes;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem,
                   const SparseParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

template <typename T, int D>
cudaError_t dispatch(Which which, const SparseParams& p, cudaStream_t st) {
  const dim3 grid(p.b * p.h, p.n_tiles);
  switch (which) {
    case kFwd:
      return launch(block_sparse_fwd_kernel<T, D>, grid, fwd_smem<D>(), p, st);
    case kDq:
      return launch(block_sparse_bwd_dq_kernel<T, D>, grid, dq_smem<D>(), p,
                    st);
    default: {
      constexpr int BQ = DkdvStep<D>::value;
      return launch(block_sparse_bwd_dkdv_kernel<T, D, BQ>, grid,
                    dkdv_smem<D, BQ>(), p, st);
    }
  }
}

template <typename T>
cudaError_t dispatch_d(Which which, int d, const SparseParams& p,
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

int run(Which which, const SparseParams* p, int dtype, int d, void* stream) {
  if (p == nullptr || p->b <= 0 || p->s <= 0 || p->h <= 0 ||
      p->block <= 0 || p->block % 16 != 0 || p->unit <= 0 ||
      p->unit % 16 != 0 || kTile % p->unit != 0 || p->n_tiles <= 0 ||
      p->n_tiles > 65535 || (p->layout_heads != 1 && p->layout_heads != p->h))
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
extern "C" int block_sparse_fwd_launch(const SparseParams* p, int dtype, int d,
                                       void* stream) {
  return run(kFwd, p, dtype, d, stream);
}

extern "C" int block_sparse_bwd_dq_launch(const SparseParams* p, int dtype,
                                          int d, void* stream) {
  return run(kDq, p, dtype, d, stream);
}

extern "C" int block_sparse_bwd_dkdv_launch(const SparseParams* p, int dtype,
                                            int d, void* stream) {
  return run(kDkdv, p, dtype, d, stream);
}

extern "C" const char* block_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
