// Block-sparse attention over a layout for Hopper (sm_90a): forward, dq, and
// dk/dv.
//
// Replaces the TPU kernels of
// deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:
//   block_sparse_fwd_tc_kernel      <- _fwd_pk (pallas_call :749, shared
//     (fp32: block_sparse_fwd_kernel)  layouts, all heads per grid step) and
//                                      _fwd (:923, per-head layouts)
//   block_sparse_bwd_dq_tc_kernel   <- the dq halves of _bwd_pk (:792) and
//     (fp32, fp16: ..._dq_kernel)      _bwd (:959)
//   block_sparse_bwd_dkdv_tc_kernel <- the dk/dv halves of _bwd_pk (:823) and
//     (fp32, fp16: ..._dkdv_kernel)    _bwd (:988), the transposed-layout walk
// Both TPU implementations compute one function; here the layout tables carry
// one layout head for a shared layout (every head reads head 0) and h heads
// otherwise, so one set covers both.
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
// active blocks on the other side, a step of tokens at a time, and masks
// each (unit, block) pair through the dense layout. Tiles are launched
// longest walk first (blockIdx.y indexes the `order` table).
//
// Bound on the H100 at the training shape (b 2, s 8192, h 16, d 64, bf16,
// fixed layout, block 16: 33,792 active block pairs per head): operations
// (71 GFLOP forward, 106 dq, 142 dk/dv on active pairs, against 0.04 ms of
// bytes).
//
// bf16 and fp16 forward, bf16 backward (designed for Hopper): the flash
// kernels' tensor-core design (tc_attention.cuh) over gathered rows. Blocks
// of 4 warps; warp w owns anchor rows 16 w .. 16 w + 15, which lie in one
// unit and so in one layout block, and skips a step's products when the
// layout holds none of its pairs. The anchor rows (Q for the forward; Q,
// dO for dq; K, V for dk/dv) stay in shared memory in the input type; the
// step's rows of the other side (64 keys, or 32 queries) are gathered by
// 16-byte cp.async into two stages, each row wherever the walk puts it. S
// and dP (S^T, dP^T) come from mma.sync m16n8k16 with ldmatrix fragments
// and stay in registers as the next product's A operand.
//   Forward: each step is the flash forward's (tc_fwd_step): P and the
// running max at the plain version's bits (pairs that may hold the tile
// max, and pairs within the bound of a rounding edge of the input type,
// fp16's own edges included, are summed again in the plain order), P.V
// chained through the tensor cores' accumulator as flash does; the kpm and
// bias terms in the plain order, with their roundings in the bound; P = 0
// in a row whose running max is still NEG_INF, which flash's step leaves
// out (a row whose every pair kpm or bias masks).
//   Backward: P and dS follow the plain versions' operations from S and
// dP, and pairs within the bound of a bf16 rounding edge are summed again
// in the plain order, so each P and dS has the plain bits (the same check
// as flash). Each step's dQ / dK / dV product starts from zero and is added
// with a rounded fp32 add (tc_pb_step): the tensor cores' chained
// accumulation drifted a long walk's cancelling sum past one bf16 ulp.
// All three launch one block a (batch x head, tile), longest walk first,
// and each block stores its own rows: no sum depends on the order blocks
// run in, so out, lse, dq, dk and dv have the same bits run to run. The
// host packs units of like walks into a tile (Walk), so the `fixed`
// layout's global columns share tiles and their warps walk the same long
// steps together.
//
// fp32 (the parity runs: TF32 would break them) and the fp16 backward keep
// the simple first version: every product on the CUDA cores in fp32 FMA
// from shared-memory tiles, each thread owning a 4x4 score tile, a warp
// skipping a step when none of its pairs is in the layout. The fp16
// backward would need its own rounding edges and partial adds on the
// tensor cores (as the flash backward has); it stays here until then.

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
constexpr int kTile = 64;          // anchor rows per tile, keys per fwd/dq step
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

// ------------------------------- the tensor-core backward (bf16, Hopper)

constexpr int kTcBq = 32;             // dk/dv query step
constexpr int kTcGroups = kTcBq / 16;  // 16-query groups of a dk/dv step

// Token f of a walk (counted from the walk's first slot): its position on
// the other side, -1 at or past slot `end`.
__device__ __forceinline__ int walk_pos(const int* walk, int block, int f,
                                        int end) {
  const int slot = f / block;
  return slot < end ? walk[slot] * block + f % block : -1;
}

// Rows r < R at positions pos(r) (-1: a zero row) of N (s x D) slices (row
// strides ss[n]) into dst[n][r][*] (pitch ld): 16-byte cp.async copies when
// vec, else plain loads stored directly.
template <int D, int R, int N, typename T, typename Pos>
__device__ __forceinline__ void tc_gather(T* const (&dst)[N],
                                          const T* const (&src)[N],
                                          const int64_t (&ss)[N], int ld,
                                          bool vec, Pos pos) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < R * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int at = pos(r);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T* o = dst[n] + r * ld + c;
      if (vec) {
        sm90::cp_async16(o, at >= 0 ? src[n] + at * ss[n] + c : src[n],
                         at >= 0 ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = at >= 0 ? src[n][at * ss[n] + c + j] : from_f<T>(0.f);
      }
    }
  }
}

// P and dS of a pair in the plain versions' order of fp32 operations:
// score = ((S scale + kpm) + bias) (a term the plain version does not add
// is 0 here, which adds exactly), x = score - lse, P = exp(x), dS = P (dP -
// delta) scale.
__device__ __forceinline__ PairTerms sparse_pair_terms(float s, float dp,
                                                       float scale, float kpm,
                                                       float bias, float lse,
                                                       float delta) {
  const float x = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(s, scale), kpm), bias), lse);
  const float p = expf(x);
  const float d1 = __fsub_rn(dp, delta);
  return {p, __fmul_rn(__fmul_rn(p, d1), scale), x, d1};
}

// edge_bound for that x: four roundings, of results at most sx, sx + |kpm|,
// sx + |kpm| + |bias| and that + |lse|; edge_bound counts 3 sx + 2 |b| +
// |lse| for its three, so b = (sx + 3 |kpm| + 2 |bias|) / 2 covers the
// fourth (with neither term the additions of 0 are exact).
__device__ __forceinline__ EdgeBound sparse_edge_bound(float es, float sx,
                                                       float kpm, float bias,
                                                       float lse_abs,
                                                       float edp,
                                                       float scale) {
  const float b = (kpm == 0.f && bias == 0.f)
                      ? 0.f
                      : 0.5f * (sx + 3.f * fabsf(kpm) + 2.f * fabsf(bias));
  return edge_bound(es, sx, b, lse_abs, edp, scale);
}

// acc[j] (16 x 8 each, j < D/8) += P (16 x K, C tiles p[K/8], rounded to T
// here) . B (K x D, rows of `b` at pitch ld, read transposed), as tc_pb,
// except that the step's product (its K/16 chained 16-deep products)
// starts from zero and is added to acc with a rounded fp32 add. The tensor
// cores align an accumulator to its largest term and drop the bits below
// (tc_pb); chained over a walk of thousands of queries (a global column's)
// that drifts a cancelling sum away from the plain version's
// round-to-nearest one, so the chain is cut at every step.
template <typename T, int D, int K>
__device__ __forceinline__ void tc_pb_step(float (&acc)[D / 8][4],
                                           const float (&p)[K / 8][4],
                                           const T* b, int ld, int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
  uint32_t af[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::pack_c_to_a<T>(af[kk], p[2 * kk], p[2 * kk + 1]);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t bf[4];
      sm90::ldmatrix_x4_trans(bf, b + (kk * 16 + r8 + (mat & 1) * 8) * ld +
                                      nd * 16 + (mat >> 1) * 8);
      sm90::mma16816<T>(t0, af[kk], bf[0], bf[1]);
      sm90::mma16816<T>(t1, af[kk], bf[2], bf[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * nd][e] = __fadd_rn(acc[2 * nd][e], t0[e]);
      acc[2 * nd + 1][e] = __fadd_rn(acc[2 * nd + 1][e], t1[e]);
    }
  }
}

// The forward's score terms (tc_fwd_step): kpm per key, then bias per
// (query, key), added in that order as the plain version adds them (a term
// it does not add is 0 here, which adds exactly). Three roundings, of
// results at most sx, sx + |kpm| and that + |bias|, of which err0 counts
// 2 sx; bound() = sx + 2 |kpm| + |bias| covers the rest for the score
// (1.2e-7 b) and, with one more rounding of at most that + |m|, for x =
// score - m (2.4e-7 b). A row whose running max is still NEG_INF gets
// P = 0 (kZeroDead): a row whose every pair kpm or bias masks scores
// exactly NEG_INF, and its out is 0, not the mean of the masked V rows.
struct SparseFwdTerms {
  static constexpr bool kZeroDead = true;
  float scale;
  const float* kpm;   // the step's keys' kpm (zeros without kpm)
  const float* bias;  // (s, s) at row stride bias_ss, or null
  int64_t bias_ss;
  int row[2];         // this thread's two query positions (-1: none)
  const int* key;     // the step's key positions (-1: none)
  __device__ __forceinline__ float pair_bias(int kc, int h2) const {
    return bias != nullptr && row[h2] >= 0 && key[kc] >= 0
               ? bias[static_cast<int64_t>(row[h2]) * bias_ss + key[kc]]
               : 0.f;
  }
  __device__ __forceinline__ float score(float s, int kc, int h2) const {
    return __fadd_rn(__fadd_rn(__fmul_rn(s, scale), kpm[kc]),
                     pair_bias(kc, h2));
  }
  __device__ __forceinline__ float exact(float s, int kc, int h2) const {
    return score(s, kc, h2);
  }
  __device__ __forceinline__ float bound(int kc, int h2, float sx) const {
    return sx + 2.f * fabsf(kpm[kc]) + fabsf(pair_bias(kc, h2));
  }
};
// S scale alone, under the same contract.
struct SparseFwdScale : FwdScale {
  static constexpr bool kZeroDead = true;
};

// out and lse for one (batch x head, query tile), walking the tile's key
// blocks 64 keys a step with the flash forward's step (tc_fwd_step: P and
// the running max at the plain version's bits). The plain version walks
// the same steps, so its running max changes at the same keys. Warp w owns
// anchor rows 16 w .. 16 w + 15, which lie in one unit and so in one query
// block; Q of the tile stays in shared memory, the step's K and V rows are
// gathered by cp.async into two stages. A warp none of whose pairs the
// layout holds in a step skips it: the plain version's max, sum and acc do
// not move there either. TERMS: a kpm or bias term is given.
template <typename T, int D, bool TERMS>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    block_sparse_fwd_tc_kernel(const SparseParams p) {
  constexpr int LD = D + 8, R = kTile, NJ = R / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);  // [64][LD] the tile's rows
  T* ks = qs + R * LD;                    // [2][64][LD] the step's keys
  T* vs = ks + 2 * R * LD;                // [2][64][LD]
  float* kpm_s = reinterpret_cast<float*>(vs + 2 * R * LD);  // [2][64]
  float* kn_s = kpm_s + 2 * R;            // [64] |k| of the step's keys
  int* kpos_s = reinterpret_cast<int*>(kn_s + R);  // [2][64]
  int* act_s = kpos_s + 2 * R;            // [2][4 warps][4 key groups]
  float* pw = reinterpret_cast<float*>(act_s + 32) + threadIdx.x * 33;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;

  const TileWork w = tile_work(p);
  const T* qb = static_cast<const T*>(p.q) + w.bi * p.q_sb + w.head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + w.bi * p.k_sb + w.head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.bi * p.v_sb + w.head * p.v_sh;
  const float* kpmb = p.kpm ? p.kpm + w.bi * p.kpm_sb : nullptr;
  const bool vec_q = rows_aligned(qb, p.q_ss);
  const bool vec_k = rows_aligned(kb, p.k_ss) && rows_aligned(vb, p.v_ss);

  const int* units = p.units + (w.hl * p.n_tiles + w.tile) * (kTile / p.unit);
  auto anchor = [&](int r) {
    const int u = units[r / p.unit];
    return u >= 0 ? u * p.unit + r % p.unit : -1;
  };
  tc_gather<D, R, 1, T>({qs}, {qb}, {p.q_ss}, LD, vec_q, anchor);
  // the warp's first row, and this thread's two (g, g + 8 of the 16)
  const int row_w = anchor(warp * 16);
  int row[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) row[h2] = anchor(warp * 16 + g + h2 * 8);

  const int steps = (w.len * p.block + R - 1) / R;
  auto stage = [&](int j) {
    const int st = j & 1;
    auto kp = [&](int r) { return walk_pos(w.walk, p.block, j * R + r, w.len); };
    tc_gather<D, R, 2, T>({ks + st * R * LD, vs + st * R * LD}, {kb, vb},
                          {p.k_ss, p.v_ss}, LD, vec_k, kp);
    for (int i = threadIdx.x; i < R; i += kTcThreads) {
      const int at = kp(i);
      kpos_s[st * R + i] = at;
      kpm_s[st * R + i] = (kpmb != nullptr && at >= 0) ? kpmb[at] : 0.f;
    }
    if (threadIdx.x < 16) {  // (warp, 16-key group): any pair in the layout
      const int qa = anchor(threadIdx.x / 4 * 16);
      const int ka = kp(threadIdx.x % 4 * 16);
      act_s[st * 16 + threadIdx.x] = in_layout(
          p, w.hl, qa >= 0 ? qa / p.block : -1, ka >= 0 ? ka / p.block : -1);
    }
  };
  if (steps > 0) stage(0);
  sm90::cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
  const T* qw = qs + warp * 16 * LD;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) stage(j + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // step j (and Q) landed
    const int st = j & 1;
    const T* k_t = ks + st * R * LD;
    const T* v_t = vs + st * R * LD;
    const int* kpos = kpos_s + st * R;
    if (j == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        qn[h2] = row_norm<T, D>(qw + (g + h2 * 8) * LD);
    }
    for (int i = threadIdx.x; i < R; i += kTcThreads)
      kn_s[i] = row_norm<T, D>(k_t + i * LD);
    __syncthreads();  // the step's key norms
    const int* act = act_s + st * 16 + warp * 4;
    if (act[0] | act[1] | act[2] | act[3]) {  // warp-uniform
      float kmax = 0.f;
      for (int i = lane; i < R; i += 32) kmax = fmaxf(kmax, kn_s[i]);
      kmax = warp_max(kmax);
      // a pair counts where the layout holds its (16-key group) block pair
      // and both positions are real, the key not after the query if causal
      auto live = [&](int kc, int h2) {
        const int key = kpos[kc];
        return act[kc >> 4] && row[h2] >= 0 && key >= 0 &&
               (!p.causal || row[h2] >= key);
      };
      float sc[NJ][4];
      tc_abt<T, D, R>(sc, qw, k_t, LD, lane);
      if constexpr (TERMS)
        tc_fwd_step<T, D, R, true>(
            sc, live, m, l, acc, qw, k_t, v_t, LD, qn, kmax, p.scale,
            SparseFwdTerms{p.scale, kpm_s + st * R, p.bias, p.bias_ss,
                           {row[0], row[1]}, kpos},
            pw, lane);
      else
        tc_fwd_step<T, D, R, false>(sc, live, m, l, acc, qw, k_t, v_t, LD, qn,
                                    kmax, p.scale, SparseFwdScale{{p.scale}},
                                    pw, lane);
    }
    __syncthreads();  // every warp is done with stage st
  }
  sm90::cp_async_wait<0>();

  if (row_w < 0) return;  // a tile's rows past its units
  float ls[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    ls[h2] = l[h2] == 0.f ? 1.f : l[h2];
    if (tg == 0)
      p.lse[(static_cast<int64_t>(w.bi) * p.h + w.head) * p.s + row[h2]] =
          l[h2] == 0.f ? kNegInf : m[h2] + logf(ls[h2]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fdiv_rn(acc[j][e], ls[e >> 1]);
  tc_store<T, D>(static_cast<T*>(p.out) + w.bi * p.o_sb + w.head * p.o_sh,
                 p.o_ss, row_w, p.s, acc, lane);
}

// dq for one (batch x head, query tile), walking the tile's key blocks 64
// keys a step; warp w owns anchor rows 16 w .. 16 w + 15, which lie in one
// unit and so in one query block. Q and dO of the tile stay in shared
// memory, the step's K and V rows are gathered by cp.async into two
// stages; a warp none of whose pairs the layout holds in a step skips its
// products.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    block_sparse_bwd_dq_tc_kernel(const SparseParams p) {
  using T = __nv_bfloat16;
  constexpr int LD = D + 8, R = kTile;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);  // [64][LD] the tile's rows
  T* dos = qs + R * LD;                   // [64][LD]
  T* ks = dos + R * LD;                   // [2][64][LD] the step's keys
  T* vs = ks + 2 * R * LD;                // [2][64][LD]
  float* kpm_s = reinterpret_cast<float*>(vs + 2 * R * LD);  // [2][64]
  float* kn_s = kpm_s + 2 * R;            // [64] |k| of the step's keys
  float* vn_s = kn_s + R;                 // [64] |v|
  float* lq_s = vn_s + R;                 // [64] lse of the tile's rows
  float* dl_s = lq_s + R;                 // [64] delta
  int* kpos_s = reinterpret_cast<int*>(dl_s + R);  // [2][64]
  int* apos_s = kpos_s + 2 * R;           // [64] the tile's rows
  int* act_s = apos_s + R;                // [2][4 warps][4 key groups]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wr = reinterpret_cast<float*>(act_s + 32) + warp * kTcList;
  unsigned short* wl = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float*>(act_s + 32) + 4 * kTcList) + warp * kTcList;

  const TileWork w = tile_work(p);
  const int g = lane >> 2, tg = lane & 3;
  const T* qb = static_cast<const T*>(p.q) + w.bi * p.q_sb + w.head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + w.bi * p.k_sb + w.head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.bi * p.v_sb + w.head * p.v_sh;
  const T* db =
      static_cast<const T*>(p.dout) + w.bi * p.do_sb + w.head * p.do_sh;
  const float* kpmb = p.kpm ? p.kpm + w.bi * p.kpm_sb : nullptr;
  const int64_t rows_at = (static_cast<int64_t>(w.bi) * p.h + w.head) * p.s;
  const bool vec_q = rows_aligned(qb, p.q_ss) && rows_aligned(db, p.do_ss);
  const bool vec_k = rows_aligned(kb, p.k_ss) && rows_aligned(vb, p.v_ss);

  const int* units = p.units + (w.hl * p.n_tiles + w.tile) * (kTile / p.unit);
  auto anchor = [&](int r) {
    const int u = units[r / p.unit];
    return u >= 0 ? u * p.unit + r % p.unit : -1;
  };
  tc_gather<D, R, 2, T>({qs, dos}, {qb, db}, {p.q_ss, p.do_ss}, LD, vec_q,
                        anchor);
  for (int r = threadIdx.x; r < R; r += kTcThreads) {
    const int at = anchor(r);
    apos_s[r] = at;
    lq_s[r] = at >= 0 ? p.lse_in[rows_at + at] : kNegInf;
    dl_s[r] = at >= 0 ? p.delta[rows_at + at] : 0.f;
  }
  // this thread's two rows (g, g + 8 of the warp's 16)
  const int row_w = anchor(warp * 16);
  int row[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    row[h2] = anchor(warp * 16 + g + h2 * 8);
    lse_r[h2] = row[h2] >= 0 ? p.lse_in[rows_at + row[h2]] : kNegInf;
    delta_r[h2] = row[h2] >= 0 ? p.delta[rows_at + row[h2]] : 0.f;
  }

  const int steps = (w.len * p.block + R - 1) / R;
  auto stage = [&](int j) {
    const int st = j & 1;
    auto kp = [&](int r) { return walk_pos(w.walk, p.block, j * R + r, w.len); };
    tc_gather<D, R, 2, T>({ks + st * R * LD, vs + st * R * LD}, {kb, vb},
                          {p.k_ss, p.v_ss}, LD, vec_k, kp);
    for (int i = threadIdx.x; i < R; i += kTcThreads) {
      const int at = kp(i);
      kpos_s[st * R + i] = at;
      kpm_s[st * R + i] = (kpmb != nullptr && at >= 0) ? kpmb[at] : 0.f;
    }
    if (threadIdx.x < 16) {  // (warp, 16-key group): any pair in the layout
      const int qa = anchor(threadIdx.x / 4 * 16);
      const int ka = kp(threadIdx.x % 4 * 16);
      act_s[st * 16 + threadIdx.x] = in_layout(
          p, w.hl, qa >= 0 ? qa / p.block : -1, ka >= 0 ? ka / p.block : -1);
    }
  };
  if (steps > 0) stage(0);
  sm90::cp_async_commit();

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  float qn[2], dn[2];  // |q|, |dO| of this thread's two rows
  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) stage(j + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // step j (and Q, dO) landed
    const int st = j & 1;
    const T* k_t = ks + st * R * LD;
    const T* v_t = vs + st * R * LD;
    if (j == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        qn[h2] = row_norm<T, D>(qs + (warp * 16 + g + h2 * 8) * LD);
        dn[h2] = row_norm<T, D>(dos + (warp * 16 + g + h2 * 8) * LD);
      }
    }
    for (int i = threadIdx.x; i < 2 * R; i += kTcThreads) {
      if (i < R)
        kn_s[i] = row_norm<T, D>(k_t + i * LD);
      else
        vn_s[i - R] = row_norm<T, D>(v_t + (i - R) * LD);
    }
    __syncthreads();  // the step's row norms
    const int* act = act_s + st * 16 + warp * 4;
    if (act[0] | act[1] | act[2] | act[3]) {  // warp-uniform
      float kmax = 0.f, vmax = 0.f;
      for (int i = lane; i < R; i += 32) {
        kmax = fmaxf(kmax, kn_s[i]);
        vmax = fmaxf(vmax, vn_s[i]);
      }
      kmax = warp_max(kmax);
      vmax = warp_max(vmax);
      EdgeBound eb[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        eb[h2] = sparse_edge_bound(kProductSlack * qn[h2] * kmax,
                                   qn[h2] * kmax * p.scale, 0.f, 0.f,
                                   fabsf(lse_r[h2]),
                                   kProductSlack * dn[h2] * vmax, p.scale);
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
      float sc[R / 8][4], dp[R / 8][4];
      tc_abt<T, D, R>(sc, qs + warp * 16 * LD, k_t, LD, lane);
      tc_abt<T, D, R>(dp, dos + warp * 16 * LD, v_t, LD, lane);
      uint32_t flags = 0;
#pragma unroll
      for (int j8 = 0; j8 < R / 8; ++j8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1, qrow = row[h2];
          const int kc = j8 * 8 + 2 * tg + (e & 1), key = kpos_s[st * R + kc];
          const bool ok = act[j8 >> 1] && qrow >= 0 && key >= 0 &&
                          lse_r[h2] > kNegInf && (!p.causal || qrow >= key);
          float ds = 0.f;
          if (ok) {
            const float kpm = kpm_s[st * R + kc];
            const float bias =
                p.bias != nullptr
                    ? p.bias[static_cast<int64_t>(qrow) * p.bias_ss + key]
                    : 0.f;
            const PairTerms t = sparse_pair_terms(
                sc[j8][e], dp[j8][e], p.scale, kpm, bias, lse_r[h2],
                delta_r[h2]);
            EdgeBound b = eb[h2];
            if (kpm != 0.f || bias != 0.f)
              b = sparse_edge_bound(kProductSlack * qn[h2] * kmax,
                                    qn[h2] * kmax * p.scale, kpm, bias,
                                    fabsf(lse_r[h2]),
                                    kProductSlack * dn[h2] * vmax, p.scale);
            if (near_plain_edge<T>(t, b)) flags |= 1u << (j8 * 4 + e);
            ds = t.ds;
          }
          dp[j8][e] = ds;  // dS, rounded to T as the dQ product's A operand
        }
      resolve_flagged<R / 8>(
          flags, wr, wl, lane,
          [&](int owner, int pos) {
            const int kc = (pos >> 2) * 8 + 2 * (owner & 3) + (pos & 1);
            const int ql = warp * 16 + (owner >> 2) + ((pos & 3) >> 1) * 8;
            const float2 sd = seq_dots<T, D>(qs + ql * LD, k_t + kc * LD,
                                             dos + ql * LD, v_t + kc * LD);
            const float bias =
                p.bias != nullptr
                    ? p.bias[static_cast<int64_t>(apos_s[ql]) * p.bias_ss +
                             kpos_s[st * R + kc]]
                    : 0.f;
            return sparse_pair_terms(sd.x, sd.y, p.scale, kpm_s[st * R + kc],
                                     bias, lq_s[ql], dl_s[ql]).ds;
          },
          [&](int j8, int e, bool taken, float v) {
            dp[j8][e] = taken ? v : dp[j8][e];
          });
      tc_pb_step<T, D, R>(dq, dp, k_t, LD, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage st
  }
  sm90::cp_async_wait<0>();

  if (row_w >= 0)
    tc_store<T, D>(static_cast<T*>(p.dq) + w.bi * p.o_sb + w.head * p.o_sh,
                   p.o_ss, row_w, p.s, dq, lane);
}

// dk and dv for one (batch x head, key tile), walking the tile's transposed
// walk kTcBq queries a step; warp w owns anchor keys 16 w .. 16 w + 15 (one
// unit, one key block). K and V of the tile stay in shared memory, the
// step's Q and dO rows are gathered into two stages; a warp none of whose
// pairs the layout holds in a step skips its products.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
    block_sparse_bwd_dkdv_tc_kernel(const SparseParams p) {
  using T = __nv_bfloat16;
  constexpr int LD = D + 8, BQ = kTcBq, R = kTile;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* ks = reinterpret_cast<T*>(tc_smem);  // [64][LD] the tile's keys
  T* vs = ks + R * LD;                    // [64][LD]
  T* qs = vs + R * LD;                    // [2][BQ][LD] the step's queries
  T* dos = qs + 2 * BQ * LD;              // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;           // [2][BQ] delta
  float* qn_s = dl_s + 2 * BQ;            // [BQ] |q| of the step's rows
  float* dn_s = qn_s + BQ;                // [BQ] |dO|
  float* kb_s = dn_s + BQ;                // [64] kpm of the tile's keys
  int* qpos_s = reinterpret_cast<int*>(kb_s + R);  // [2][BQ]
  int* apos_s = qpos_s + 2 * BQ;          // [64] the tile's keys
  int* act_s = apos_s + R;                // [2][4 warps][kTcGroups]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* wr = reinterpret_cast<float2*>(act_s + 8 * kTcGroups) +
               warp * kTcList;
  unsigned short* wl = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float2*>(act_s + 8 * kTcGroups) + 4 * kTcList) +
      warp * kTcList;

  const TileWork w = tile_work(p);
  const int bi = w.bi, head = w.head, hl = w.hl;
  const int g = lane >> 2, tg = lane & 3;
  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + head * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + head * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + head * p.v_sh;
  const T* db = static_cast<const T*>(p.dout) + bi * p.do_sb + head * p.do_sh;
  const float* kpmb = p.kpm ? p.kpm + bi * p.kpm_sb : nullptr;
  const int64_t rows_at = (static_cast<int64_t>(bi) * p.h + head) * p.s;
  const bool vec_q = rows_aligned(qb, p.q_ss) && rows_aligned(db, p.do_ss);
  const bool vec_k = rows_aligned(kb, p.k_ss) && rows_aligned(vb, p.v_ss);

  const int* units = p.units + (hl * p.n_tiles + w.tile) * (kTile / p.unit);
  auto anchor = [&](int r) {
    const int u = units[r / p.unit];
    return u >= 0 ? u * p.unit + r % p.unit : -1;
  };
  tc_gather<D, R, 2, T>({ks, vs}, {kb, vb}, {p.k_ss, p.v_ss}, LD, vec_k,
                        anchor);
  for (int r = threadIdx.x; r < R; r += kTcThreads) {
    const int at = anchor(r);
    apos_s[r] = at;
    kb_s[r] = (kpmb != nullptr && at >= 0) ? kpmb[at] : 0.f;
  }
  // this thread's two keys (g, g + 8 of the warp's 16) and their kpm
  const int key_w = anchor(warp * 16);
  int key[2];
  float kpm_k[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    key[h2] = anchor(warp * 16 + g + h2 * 8);
    kpm_k[h2] = (kpmb != nullptr && key[h2] >= 0) ? kpmb[key[h2]] : 0.f;
  }

  const int n = (w.len * p.block + BQ - 1) / BQ;
  auto stage = [&](int it) {
    const int st = it & 1;
    auto qp = [&](int r) {
      return walk_pos(w.walk, p.block, it * BQ + r, w.len);
    };
    tc_gather<D, BQ, 2, T>({qs + st * BQ * LD, dos + st * BQ * LD},
                           {qb, db}, {p.q_ss, p.do_ss}, LD, vec_q, qp);
    for (int i = threadIdx.x; i < BQ; i += kTcThreads) {
      const int at = qp(i);
      qpos_s[st * BQ + i] = at;
      lse_s[st * BQ + i] = at >= 0 ? p.lse_in[rows_at + at] : kNegInf;
      dl_s[st * BQ + i] = at >= 0 ? p.delta[rows_at + at] : 0.f;
    }
    if (threadIdx.x < 4 * kTcGroups) {  // (warp, 16-query group)
      const int ka = anchor(threadIdx.x / kTcGroups * 16);
      const int qa = qp(threadIdx.x % kTcGroups * 16);
      act_s[st * 4 * kTcGroups + threadIdx.x] = in_layout(
          p, hl, qa >= 0 ? qa / p.block : -1, ka >= 0 ? ka / p.block : -1);
    }
  };
  if (n > 0) stage(0);
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
    __syncthreads();  // step it (and K, V) landed
    const int st = it & 1;
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
    __syncthreads();  // the step's row norms
    const int* act = act_s + st * 4 * kTcGroups + warp * kTcGroups;
    if (act[0] | act[1]) {  // warp-uniform
      // the check's bounds for this thread's two keys over the step (rows
      // without a softmax, lse = NEG_INF, hold no pair)
      float qmax = 0.f, dmax = 0.f, lmax = 0.f;
      for (int i = lane; i < BQ; i += 32) {
        qmax = fmaxf(qmax, qn_s[i]);
        dmax = fmaxf(dmax, dn_s[i]);
        const float l = lse_s[st * BQ + i];
        if (l > kNegInf) lmax = fmaxf(lmax, fabsf(l));
      }
      qmax = warp_max(qmax);
      dmax = warp_max(dmax);
      lmax = warp_max(lmax);
      EdgeBound eb[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        eb[h2] = sparse_edge_bound(kProductSlack * kn[h2] * qmax,
                                   qmax * kn[h2] * p.scale, kpm_k[h2], 0.f,
                                   lmax, kProductSlack * vn[h2] * dmax,
                                   p.scale);
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float sc[BQ / 8][4], dp[BQ / 8][4];
      tc_abt<T, D, BQ>(sc, ks + warp * 16 * LD, q_t, LD, lane);
      tc_abt<T, D, BQ>(dp, vs + warp * 16 * LD, do_t, LD, lane);
      uint32_t flags = 0;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1, kpos = key[h2];
          const int qc = j * 8 + 2 * tg + (e & 1);
          const int query = qpos_s[st * BQ + qc];
          const float lse = lse_s[st * BQ + qc];
          const bool ok = act[j >> 1] && kpos >= 0 && query >= 0 &&
                          lse > kNegInf && (!p.causal || query >= kpos);
          PairTerms t{0.f, 0.f, 0.f, 0.f};
          if (ok) {
            const float bias =
                p.bias != nullptr
                    ? p.bias[static_cast<int64_t>(query) * p.bias_ss + kpos]
                    : 0.f;
            t = sparse_pair_terms(sc[j][e], dp[j][e], p.scale, kpm_k[h2],
                                  bias, lse, dl_s[st * BQ + qc]);
            EdgeBound b = eb[h2];
            if (bias != 0.f)
              b = sparse_edge_bound(kProductSlack * kn[h2] * qmax,
                                    qmax * kn[h2] * p.scale, kpm_k[h2], bias,
                                    lmax, kProductSlack * vn[h2] * dmax,
                                    p.scale);
            if (near_plain_edge<T>(t, b)) flags |= 1u << (j * 4 + e);
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
            const float bias =
                p.bias != nullptr
                    ? p.bias[static_cast<int64_t>(qpos_s[st * BQ + qc]) *
                                 p.bias_ss +
                             apos_s[kl]]
                    : 0.f;
            const PairTerms t = sparse_pair_terms(
                sd.x, sd.y, p.scale, kb_s[kl], bias, lse_s[st * BQ + qc],
                dl_s[st * BQ + qc]);
            return make_float2(t.p, t.ds);
          },
          [&](int j, int e, bool taken, float2 v) {
            sc[j][e] = taken ? v.x : sc[j][e];
            dp[j][e] = taken ? v.y : dp[j][e];
          });
      tc_pb_step<T, D, BQ>(dv, sc, do_t, LD, lane);  // dV += P^T dO
      tc_pb_step<T, D, BQ>(dk, dp, q_t, LD, lane);   // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with stage st
  }
  sm90::cp_async_wait<0>();

  if (key_w >= 0) {
    const int64_t gbase = bi * p.o_sb + head * p.o_sh;
    tc_store<T, D>(static_cast<T*>(p.dk) + gbase, p.o_ss, key_w, p.s, dk, lane);
    tc_store<T, D>(static_cast<T*>(p.dv) + gbase, p.o_ss, key_w, p.s, dv, lane);
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

template <typename T, int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(T) * 5 * kTile * (D + 8) + sizeof(float) * 3 * kTile +
         sizeof(int) * (2 * kTile + 32) + sizeof(float) * kTcThreads * 33;
}
template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(__nv_bfloat16) * 6 * kTile * (D + 8) +
         sizeof(float) * 6 * kTile + sizeof(int) * (3 * kTile + 32) +
         (sizeof(float) + sizeof(unsigned short)) * 4 * kTcList;
}
template <int D>
constexpr size_t dkdv_tc_smem() {
  return sizeof(__nv_bfloat16) * (2 * kTile + 4 * kTcBq) * (D + 8) +
         sizeof(float) * (6 * kTcBq + kTile) +
         sizeof(int) * (2 * kTcBq + kTile + 8 * kTcGroups) +
         (sizeof(float2) + sizeof(unsigned short)) * 4 * kTcList;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const SparseParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

// bf16 and fp16 forward, bf16 backward: the tensor-core kernels; fp32 (the
// parity runs) and the fp16 backward: the FMA kernels. Static: nothing
// falls back.
template <typename T, int D>
cudaError_t dispatch(Which which, const SparseParams& p, cudaStream_t st) {
  const dim3 grid(p.b * p.h, p.n_tiles);
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  switch (which) {
    case kFwd:
      if constexpr (std::is_same<T, float>::value)
        return launch(block_sparse_fwd_kernel<T, D>, grid, kThreads,
                      fwd_smem<D>(), p, st);
      else if (p.kpm != nullptr || p.bias != nullptr)
        return launch(block_sparse_fwd_tc_kernel<T, D, true>, grid,
                      kTcThreads, fwd_tc_smem<T, D>(), p, st);
      else
        return launch(block_sparse_fwd_tc_kernel<T, D, false>, grid,
                      kTcThreads, fwd_tc_smem<T, D>(), p, st);
    case kDq:
      if constexpr (tc)
        return launch(block_sparse_bwd_dq_tc_kernel<D>, grid, kTcThreads,
                      dq_tc_smem<D>(), p, st);
      else
        return launch(block_sparse_bwd_dq_kernel<T, D>, grid, kThreads,
                      dq_smem<D>(), p, st);
    default:
      if constexpr (tc) {
        return launch(block_sparse_bwd_dkdv_tc_kernel<D>, grid, kTcThreads,
                      dkdv_tc_smem<D>(), p, st);
      } else {
        constexpr int BQ = DkdvStep<D>::value;
        return launch(block_sparse_bwd_dkdv_kernel<T, D, BQ>, grid, kThreads,
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
