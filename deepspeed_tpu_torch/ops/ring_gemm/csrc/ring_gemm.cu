// Per-ring-step GEMMs of the collective matmuls, for Hopper (sm_90a).
//
// Replaces the products inside the TPU ring kernels of
// deepspeed_tpu/ops/pallas/ring_gemm.py (each ring step's _dot2d):
//
//   ring_ag_gemm      _ag_kernel (ag_matmul_pallas, pallas_call :188):
//                     out[:, blk*s_loc:(blk+1)*s_loc, :] = cur @ w, written
//                     straight into its block of the (b, n*s_loc, f) output;
//   ring_rs_gemm_add  _rs_kernel (matmul_rs_pallas, pallas_call :258):
//                     out = recv + (x[:, blk] @ w).to(T), the add in the
//                     epilogue; out is the next hop's payload;
//   ring_gc_gemm_acc  _gc_kernel (gather_contract_pallas, pallas_call :321):
//                     acc (fp32) += cur^T @ fixed[:, blk] (or its transpose),
//                     and on the last ring step out = acc.to(T).
//
// The hop itself is not part of these kernels: the ring loop
// (ring_gemm.py) moves each payload with torch.distributed between
// launches, as the TPU kernels' remote copies become collectives outside
// the kernel on this card.
//
// Every operand is addressed through a "row-split" descriptor: the operand
// has one contiguous (unit-stride) index and one row index i whose offset
// is (i / rpb) * sb + (i % rpb) * sr. That reaches a ring block of a
// (b, n*s_loc, c) tensor (rpb = s_loc, sb = n*s_loc*c, sr = c) without a
// copy, a plain row-major matrix (rpb = INT_MAX), and a transposed weight
// view (w.T in the backward passes).
//
// Bound on the H100: operations at the main path's shapes (K = 512 to 8192,
// M = 8192 rows; ~1000 flops per byte moved).
//
// bf16 (all three, designed for Hopper) runs one main loop: 16-byte cp.async
// copies of 64-deep k steps into a ring of three shared-memory stages (rows
// padded by 16 bytes, so the fragment loads meet no bank conflict; each
// thread's row offsets computed once and advanced by additions, no division
// in the loop), fragments read with ldmatrix, and mma.sync m16n8k16 (fp32
// accumulators) over 128 x 128 output tiles of 8 warps (64 x 32 each).
//
// gc's operands both arrive k-major (the contraction index is the row
// index, M or N contiguous), so its tiles are staged as they lie and read
// with ldmatrix.trans. On the H100 it runs at ~190 TFLOP/s a site, bound by
// latency rather than bytes: more stages, 32-deep steps and 4-warp blocks
// ran no faster (probes/kernel_probe.py). The host splits K so that the
// tiles fill the card (gc_plan in ring_gemm.py): each split writes its fp32
// partial tile to a workspace, and the split that arrives last at a tile (a
// ticket per tile) folds acc + partial 0 + partial 1 + ... in split order,
// so the result has the same bits run to run.
//
// ag and rs share the k-contiguous A form of the loop (tc_kc_main_loop): A
// (the chunk for ag, the ring block of x for rs) is read with plain
// ldmatrix; B is the weight w (n-contiguous, staged as k rows,
// ldmatrix.trans) or, in the backward, the w^T view (k-contiguous, staged
// like A); each kernel is built for both (template KC). Their M = 8192 rows
// give 256-1024 tiles, so K is never split and the result has the same bits
// run to run. The epilogues differ: ag rounds each fp32 sum to bf16 once
// and stores neighbouring columns as one 32-bit word into its ring block;
// rs rounds the sum to bf16 (the partial), adds what arrived (recv, absent
// on the first ring step) in fp32 and rounds again, writing neighbouring
// columns as 32-bit words where out allows it. out may be recv:
// each element is read, then written, by the one thread that owns it, and
// neither pointer is __restrict__.
//
// fp32 operands take a plain FMA path (the parity runs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kLdF = kBK + 1;  // the fp32 tiles' 33-word rows

__device__ __forceinline__ __nv_bfloat16 bf16_zero() {
  return __float2bfloat16_rn(0.f);
}

// The offset of row i: (i / rpb) * sb + (i % rpb) * sr.
struct RowSplit {
  int rpb;
  int64_t sb, sr;
  __device__ __forceinline__ int64_t off(int i) const {
    return static_cast<int64_t>(i / rpb) * sb +
           static_cast<int64_t>(i % rpb) * sr;
  }
};

// An operand element (r, k) is at ptr + rows.off(row) + col: row = r and
// col = k when kcontig (k has unit stride), else row = k and col = r.
template <typename T>
struct Operand {
  const T* ptr;
  RowSplit rows;
  int kcontig;
  int vec;  // 16-byte loads along the unit-stride index are allowed
};

// s[r][kk] = op(r0 + r, k0 + kk) for a ROWS x kBK tile, zero outside
// (R, K). Consecutive threads read consecutive addresses in either layout.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float (*s)[kLdF],
                                          const Operand<float>& op, int r0,
                                          int k0, int R, int K) {
  constexpr int V = 4;
  union Vec {
    uint4 u;
    float e[V];
  };
  if (op.kcontig) {
    constexpr int CPR = kBK / V;  // chunks per row
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
      const int r = c / CPR, kk = (c % CPR) * V;
      const int gr = r0 + r, gk = k0 + kk;
      if (gr < R && op.vec && gk + V <= K) {
        Vec v;
        v.u = *reinterpret_cast<const uint4*>(op.ptr + op.rows.off(gr) + gk);
#pragma unroll
        for (int j = 0; j < V; ++j) s[r][kk + j] = v.e[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          s[r][kk + j] = (gr < R && gk + j < K)
                             ? op.ptr[op.rows.off(gr) + gk + j]
                             : 0.f;
      }
    }
  } else {
    constexpr int CPK = ROWS / V;  // chunks per k
    for (int c = threadIdx.x; c < CPK * kBK; c += THREADS) {
      const int kk = c / CPK, r = (c % CPK) * V;
      const int gr = r0 + r, gk = k0 + kk;
      if (gk < K && op.vec && gr + V <= R) {
        Vec v;
        v.u = *reinterpret_cast<const uint4*>(op.ptr + op.rows.off(gk) + gr);
#pragma unroll
        for (int j = 0; j < V; ++j) s[r + j][kk] = v.e[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          s[r + j][kk] = (gk < K && gr + j < R)
                             ? op.ptr[op.rows.off(gk) + gr + j]
                             : 0.f;
      }
    }
  }
}

// C[M, N] = sum_k A(m, k) B(k, n) for this block's BM x BN tile of fp32
// operands (the parity runs); `epi(m, n, value)` is called once for every
// in-bounds element. Each thread owns an (BM/TY) x (BN/16) strided block of
// FMA sums (rows ty + TY*i, columns tx + 16*j: conflict-free smem reads).
template <int BM, int BN, int WM, int WN, typename Epi>
__device__ __forceinline__ void gemm_tile(const Operand<float>& A,
                                          const Operand<float>& B, int M,
                                          int N, int K, Epi epi) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int TX = 16, TY = THREADS / TX;
  constexpr int RM = BM / TY, RN = BN / TX;
  __shared__ float As[BM][kLdF];
  __shared__ float Bs[BN][kLdF];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile<BM, THREADS>(As, A, m0, k0, M, K);
    load_tile<BN, THREADS>(Bs, B, n0, k0, N, K);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[ty + TY * i][kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[tx + TX * j][kk];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int m = m0 + ty + TY * i, n = n0 + tx + TX * j;
      if (m < M && n < N) epi(m, n, acc[i][j]);
    }
}

// ------------------------------------------------------ fp32 kernels

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_ag_gemm_fp32_kernel(Operand<float> A, Operand<float> B, int M, int N,
                             int K, float* __restrict__ out, RowSplit o) {
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    out[o.off(m) + n] = v;
  });
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_rs_gemm_add_fp32_kernel(Operand<float> A, Operand<float> B, int M,
                                 int N, int K, float* out, const float* recv) {
  // out may be recv (the ring loop adds into the slot that arrived): no
  // __restrict__ on either; each element is read, then written, by the
  // one thread that owns it.
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    const int64_t i = static_cast<int64_t>(m) * N + n;
    out[i] = recv != nullptr ? recv[i] + v : v;
  });
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_gc_gemm_acc_fp32_kernel(Operand<float> A, Operand<float> B, int M,
                                 int N, int K, float* __restrict__ acc,
                                 int first, float* __restrict__ out) {
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    const int64_t i = static_cast<int64_t>(m) * N + n;
    const float a = first ? v : acc[i] + v;
    acc[i] = a;
    if (out != nullptr) out[i] = a;
  });
}

// ------------------------------------------- the dW kernel (bf16, Hopper)

constexpr int kGcBM = 128, kGcBN = 128, kGcBK = 64, kGcStages = 3;
constexpr int kGcWM = 2, kGcWN = 4;  // warps along M and N
constexpr int kGcThreads = kGcWM * kGcWN * 32;

// A staged k-row of a 128-column tile, padded by 16 bytes (the fragment
// loads meet no bank conflict), and the shared memory of both operands'
// stages.
constexpr int kGcLd = kGcBM + 8;
constexpr size_t kGcSmem =
    sizeof(__nv_bfloat16) * kGcStages * kGcBK * 2 * kGcLd;  // 102 KB

// The k-rows one thread copies into every stage of a 128-column tile (rows
// kk0 + kStep j of the stage, at its one 16-byte column): their offsets,
// advanced a stage at a time without a division (the ring block wraps at
// rpb rows).
struct GcRows {
  static constexpr int kChunks = kGcBM / 8;           // 16-byte chunks a row
  static constexpr int kStep = kGcThreads / kChunks;  // rows a pass
  static constexpr int kRows = kGcBK / kStep;         // rows a thread
  int k;  // row j is k + kStep j
  int r[kRows];
  int64_t off[kRows];

  __device__ __forceinline__ void init(const RowSplit& rows, int kb) {
    k = kb + threadIdx.x / kChunks;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      r[j] = (k + j * kStep) % rows.rpb;
      off[j] = rows.off(k + j * kStep);
    }
  }
  __device__ __forceinline__ void advance(const RowSplit& rows) {
    k += kGcBK;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      r[j] += kGcBK;
      off[j] += kGcBK * rows.sr;
      while (r[j] >= rows.rpb) {
        r[j] -= rows.rpb;
        off[j] += rows.sb - static_cast<int64_t>(rows.rpb) * rows.sr;
      }
    }
  }

  // The next kGcBK rows (below k1) of a k-major operand, columns [c0, c0 +
  // 128) of its extent E, into a stage s[kk][c] (zero outside): 16-byte
  // cp.async copies when the operand allows them (vec), else plain loads
  // stored directly. Then advance.
  __device__ __forceinline__ void stage(__nv_bfloat16* s,
                                        const Operand<__nv_bfloat16>& op,
                                        int k1, int c0, int E) {
    const int kk0 = threadIdx.x / kChunks;
    const int cc = (threadIdx.x % kChunks) * 8, gc = c0 + cc;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int gk = k + j * kStep;
      __nv_bfloat16* dst = s + (kk0 + j * kStep) * kGcLd + cc;
      if (op.vec) {
        const bool ok = gk < k1 && gc < E;  // E % 8 == 0 under vec
        sm90::cp_async16(dst, ok ? op.ptr + off[j] + gc : op.ptr,
                         ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < k1 && gc + e < E) ? op.ptr[off[j] + gc + e]
                                           : bf16_zero();
      }
    }
    advance(op.rows);
  }
};

// acc (M x N fp32) (+)= sum_k A[k][m] B[k][n] over this split's rows of K
// (blockIdx.z: rows [z * k_split, (z + 1) * k_split)) for one 128 x 128
// output tile, 8 warps of 64 x 32; out = acc.to(bf16) when given. splits >
// 1: partials through ws (splits x M x N), folded in split order by the
// tile's last-arriving split.
__global__ void __launch_bounds__(kGcThreads, 2)
    ring_gc_gemm_acc_bf16_kernel(Operand<__nv_bfloat16> A,
                                 Operand<__nv_bfloat16> B, int M, int N, int K,
                                 int k_split, float* __restrict__ acc,
                                 int first, __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ ws,
                                 unsigned* __restrict__ tickets) {
  constexpr int BN = kGcBN, LA = kGcLd, LB = kGcLd;
  constexpr int MT = kGcBM / kGcWM / 16, NT = BN / kGcWN / 8;
  extern __shared__ __align__(16) unsigned char gc_smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(gc_smem);
  __nv_bfloat16* Bs = As + kGcStages * kGcBK * LA;
  const int m0 = blockIdx.y * kGcBM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int kb = split * k_split, ke = min(K, kb + k_split);
  const int nk = (ke - kb + kGcBK - 1) / kGcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / kGcWN) * (kGcBM / kGcWM);
  const int wn0 = (warp % kGcWN) * (BN / kGcWN);
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix.trans row addresses: matrix lane / 8 of each x4
  const int mat = lane >> 3, r8 = lane & 7;
  const int a_k = r8 + (mat >> 1) * 8, a_m = (mat & 1) * 8;
  const int b_k = r8 + (mat & 1) * 8, b_n = (mat >> 1) * 8;

  float c[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  GcRows a_rows, b_rows;
  a_rows.init(A.rows, kb);
  b_rows.init(B.rows, kb);
#pragma unroll
  for (int st = 0; st < kGcStages - 1; ++st) {
    if (st < nk) {
      a_rows.stage(As + st * kGcBK * LA, A, ke, m0, M);
      b_rows.stage(Bs + st * kGcBK * LB, B, ke, n0, N);
    }
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<kGcStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    const int nt = kt + kGcStages - 1;
    if (nt < nk) {
      const int st = nt % kGcStages;
      a_rows.stage(As + st * kGcBK * LA, A, ke, m0, M);
      b_rows.stage(Bs + st * kGcBK * LB, B, ke, n0, N);
    }
    sm90::cp_async_commit();
    const __nv_bfloat16* as = As + (kt % kGcStages) * kGcBK * LA;
    const __nv_bfloat16* bs = Bs + (kt % kGcStages) * kGcBK * LB;
#pragma unroll
    for (int kk = 0; kk < kGcBK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        sm90::ldmatrix_x4_trans(a[i],
                                as + (kk + a_k) * LA + wm0 + i * 16 + a_m);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        sm90::ldmatrix_x4_trans(r, bs + (kk + b_k) * LB + wn0 + jj * 16 + b_n);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sm90::mma16816<__nv_bfloat16>(c[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  sm90::cp_async_wait<0>();

  // element (i, j, e) of this thread: row m0 + wm0 + 16 i + g (+8 for e >=
  // 2), column n0 + wn0 + 8 j + 2 tg + (e & 1)
#define GC_FOR_EACH(body)                                                   \
  _Pragma("unroll") for (int i = 0; i < MT; ++i)                          \
  _Pragma("unroll") for (int j = 0; j < NT; ++j)                          \
  _Pragma("unroll") for (int e = 0; e < 4; ++e) {                         \
    const int m = m0 + wm0 + i * 16 + g + (e >> 1) * 8;                    \
    const int n = n0 + wn0 + j * 8 + 2 * tg + (e & 1);                     \
    if (m < M && n < N) {                                                  \
      const int64_t at = static_cast<int64_t>(m) * N + n;                  \
      body                                                                 \
    }                                                                      \
  }

  if (splits == 1) {
    GC_FOR_EACH({
      const float v = first ? c[i][j][e] : acc[at] + c[i][j][e];
      acc[at] = v;
      if (out != nullptr) out[at] = __float2bfloat16_rn(v);
    })
    return;
  }
  const int64_t mn = static_cast<int64_t>(M) * N;
  GC_FOR_EACH({ ws[split * mn + at] = c[i][j][e]; })
  __threadfence();  // the partial is visible before the ticket is
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.y * gridDim.x + blockIdx.x], 1u) + 1u ==
           static_cast<unsigned>(splits);
  __syncthreads();
  if (!last) return;
  __threadfence();
  GC_FOR_EACH({
    float v = 0.f;
    for (int z = 0; z < splits; ++z) {
      // this split's own partial from its registers: the same bits
      const float part = z == split ? c[i][j][e] : __ldcg(ws + z * mn + at);
      v = z == 0 ? (first ? part : acc[at] + part) : v + part;
    }
    acc[at] = v;
    if (out != nullptr) out[at] = __float2bfloat16_rn(v);
  })
#undef GC_FOR_EACH
}

// ------------------------------ the all-gather step kernel (bf16, Hopper)

// The rows one thread copies into every stage of a 128-row tile of a
// k-contiguous operand (A; B when kcontig): rows r0 + kStep j of the tile
// at its one 16-byte chunk of the stage's 64 k, their offsets computed once
// (rows past R read as zeros) and the column advanced a stage at a time.
struct KcRows {
  static constexpr int kChunks = kGcBK / 8;            // 16-byte chunks a row
  static constexpr int kStep = kGcThreads / kChunks;   // rows a pass
  static constexpr int kRows = kGcBM / kStep;          // rows a thread
  static constexpr int kLd = kGcBK + 8;                // padded stage row
  int k;  // this thread's column
  int64_t off[kRows];
  bool in[kRows];

  __device__ __forceinline__ void init(const RowSplit& rows, int r0, int R) {
    k = (threadIdx.x % kChunks) * 8;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + threadIdx.x / kChunks + j * kStep;
      in[j] = r < R;
      off[j] = in[j] ? rows.off(r) : 0;
    }
  }

  // The next kGcBK columns (below K) into a stage s[r][kk], zero outside:
  // 16-byte cp.async copies when the operand allows them (vec: K % 8 == 0),
  // else plain loads stored directly. Then advance.
  __device__ __forceinline__ void stage(__nv_bfloat16* s,
                                        const Operand<__nv_bfloat16>& op,
                                        int K) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      __nv_bfloat16* dst = s + (threadIdx.x / kChunks + j * kStep) * kLd +
                           threadIdx.x % kChunks * 8;
      if (op.vec) {
        const bool ok = in[j] && k < K;
        sm90::cp_async16(dst, ok ? op.ptr + off[j] + k : op.ptr, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (in[j] && k + e < K) ? op.ptr[off[j] + k + e]
                                        : bf16_zero();
      }
    }
    k += kGcBK;
  }
};

// Shared memory of the ag and rs kernels' stages: A [128][72] and B
// [128][72] (kcontig) or [64][136] (n-contiguous) each stage.
template <bool KC>
constexpr size_t kc_smem() {
  return sizeof(__nv_bfloat16) * kGcStages *
         (kGcBM * KcRows::kLd + (KC ? kGcBN * KcRows::kLd : kGcBK * kGcLd));
}

constexpr int kKcMT = kGcBM / kGcWM / 16, kKcNT = kGcBN / kGcWN / 8;

// c = sum_k A[m][k] B[k][n] (fp32) for one 128 x 128 output tile at (m0,
// n0), 8 warps of 64 x 32, A k-contiguous: 64-deep k steps staged by
// cp.async into a ring of three stages of `smem`, fragments by ldmatrix
// (A, and B when KC: k-contiguous, the w^T view; ldmatrix.trans for an
// n-contiguous w), mma.sync m16n8k16. Element (i, j, e) of a thread is row
// m0 + wm0 + 16 i + g (+8 for e >= 2), column n0 + wn0 + 8 j + 2 tg + (e &
// 1), with wm0, wn0 its warp's offsets.
template <bool KC>
__device__ __forceinline__ void tc_kc_main_loop(
    const Operand<__nv_bfloat16>& A, const Operand<__nv_bfloat16>& B, int M,
    int N, int K, int m0, int n0, unsigned char* smem,
    float (&c)[kKcMT][kKcNT][4]) {
  constexpr int LA = KcRows::kLd;
  constexpr int LB = KC ? KcRows::kLd : kGcLd;
  constexpr int SA = kGcBM * LA, SB = KC ? kGcBN * LB : kGcBK * LB;
  constexpr int MT = kKcMT, NT = kKcNT;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kGcStages * SA;
  const int nk = (K + kGcBK - 1) / kGcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / kGcWN) * (kGcBM / kGcWM);
  const int wn0 = (warp % kGcWN) * (kGcBN / kGcWN);
  const int mat = lane >> 3, r8 = lane & 7;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  KcRows a_rows;
  a_rows.init(A.rows, m0, M);
  KcRows b_kc;   // B when KC
  GcRows b_kr;   // B when n-contiguous (its rows are the k index)
  if constexpr (KC)
    b_kc.init(B.rows, n0, N);
  else
    b_kr.init(B.rows, 0);
  auto load = [&](int st) {
    a_rows.stage(As + st * SA, A, K);
    if constexpr (KC)
      b_kc.stage(Bs + st * SB, B, K);
    else
      b_kr.stage(Bs + st * SB, B, K, n0, N);
  };
#pragma unroll
  for (int st = 0; st < kGcStages - 1; ++st) {
    if (st < nk) load(st);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<kGcStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    const int nt = kt + kGcStages - 1;
    if (nt < nk) load(nt % kGcStages);
    sm90::cp_async_commit();
    const __nv_bfloat16* as = As + (kt % kGcStages) * SA;
    const __nv_bfloat16* bs = Bs + (kt % kGcStages) * SB;
#pragma unroll
    for (int kk = 0; kk < kGcBK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        sm90::ldmatrix_x4(a[i], as + (wm0 + i * 16 + (lane & 15)) * LA + kk +
                                    (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        if constexpr (KC)
          sm90::ldmatrix_x4(r, bs + (wn0 + jj * 16 + r8 + (mat >> 1) * 8) * LB +
                                   kk + (mat & 1) * 8);
        else
          sm90::ldmatrix_x4_trans(r, bs + (kk + r8 + (mat & 1) * 8) * LB +
                                         wn0 + jj * 16 + (mat >> 1) * 8);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sm90::mma16816<__nv_bfloat16>(c[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  sm90::cp_async_wait<0>();
}

// out[m][n] = sum_k A[m][k] B[k][n] on tc_kc_main_loop, each fp32 sum
// rounded to bf16 once, the pairs of neighbouring columns stored as 32-bit
// words into the ring block through `o`.
template <bool KC>
__global__ void __launch_bounds__(kGcThreads, 2)
    ring_ag_gemm_bf16_kernel(Operand<__nv_bfloat16> A,
                             Operand<__nv_bfloat16> B, int M, int N, int K,
                             __nv_bfloat16* __restrict__ out, RowSplit o) {
  extern __shared__ __align__(16) unsigned char kc_smem_raw[];
  const int m0 = blockIdx.y * kGcBM, n0 = blockIdx.x * kGcBN;
  float c[kKcMT][kKcNT][4];
  tc_kc_main_loop<KC>(A, B, M, N, K, m0, n0, kc_smem_raw, c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / kGcWN) * (kGcBM / kGcWM);
  const int wn0 = (warp % kGcWN) * (kGcBN / kGcWN);
  const int g = lane >> 2, tg = lane & 3;
  const bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                     o.sr % 2 == 0 && o.sb % 2 == 0;
#pragma unroll
  for (int i = 0; i < kKcMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + h * 8;
      if (m >= M) continue;
      __nv_bfloat16* row = out + o.off(m);
#pragma unroll
      for (int j = 0; j < kKcNT; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * tg;
        const float v0 = c[i][j][2 * h], v1 = c[i][j][2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<uint32_t*>(row + n) =
              sm90::pack2<__nv_bfloat16>(v0, v1);
        } else {
          if (n < N) row[n] = __float2bfloat16_rn(v0);
          if (n + 1 < N) row[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// out[m][n] = recv[m][n] + bf16(sum_k A[m][k] B[k][n]) on tc_kc_main_loop
// (out and recv (M, N) row-major; recv null on the first ring step): the
// partial rounds to bf16, the add is fp32 and rounds again, as the plain
// version's bf16 matmul and bf16 add. Neighbouring columns are written as
// 32-bit words where out and N allow it. out may be recv: no
// __restrict__; each element is read, then written, by the one thread that
// owns it.
template <bool KC>
__global__ void __launch_bounds__(kGcThreads, 2)
    ring_rs_gemm_add_bf16_kernel(Operand<__nv_bfloat16> A,
                                 Operand<__nv_bfloat16> B, int M, int N, int K,
                                 __nv_bfloat16* out,
                                 const __nv_bfloat16* recv) {
  extern __shared__ __align__(16) unsigned char kc_smem_raw[];
  const int m0 = blockIdx.y * kGcBM, n0 = blockIdx.x * kGcBN;
  float c[kKcMT][kKcNT][4];
  tc_kc_main_loop<KC>(A, B, M, N, K, m0, n0, kc_smem_raw, c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / kGcWN) * (kGcBM / kGcWM);
  const int wn0 = (warp % kGcWN) * (kGcBN / kGcWN);
  const int g = lane >> 2, tg = lane & 3;
  const bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0 && N % 2 == 0;
  // the partial rounded to bf16, plus what arrived, rounded again
  auto sum = [&](float v, int64_t at) {
    const float part = __bfloat162float(__float2bfloat16_rn(v));
    return recv != nullptr ? __fadd_rn(__bfloat162float(recv[at]), part)
                           : part;
  };
#pragma unroll
  for (int i = 0; i < kKcMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + h * 8;
      if (m >= M) continue;
      const int64_t row = static_cast<int64_t>(m) * N;
#pragma unroll
      for (int j = 0; j < kKcNT; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * tg;
        const float v0 = c[i][j][2 * h], v1 = c[i][j][2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<uint32_t*>(out + row + n) =
              sm90::pack2<__nv_bfloat16>(sum(v0, row + n),
                                         sum(v1, row + n + 1));
        } else {
          if (n < N) out[row + n] = __float2bfloat16_rn(sum(v0, row + n));
          if (n + 1 < N)
            out[row + n + 1] = __float2bfloat16_rn(sum(v1, row + n + 1));
        }
      }
    }
}

template <typename T>
Operand<T> operand(const void* ptr, int rpb, int64_t sb, int64_t sr,
                   int kcontig, int vec) {
  return Operand<T>{static_cast<const T*>(ptr), RowSplit{rpb, sb, sr},
                    kcontig, vec};
}

dim3 grid_of(int M, int N, int bm, int bn) {
  return dim3(static_cast<unsigned>((N + bn - 1) / bn),
              static_cast<unsigned>((M + bm - 1) / bm));
}

bool bad_sizes(int M, int N, int K) { return M <= 0 || N <= 0 || K <= 0; }

}  // namespace

// dtype: 0 fp32, 1 bf16. Each operand: pointer, rows-per-batch, batch and
// row strides (elements), kcontig, vec (see Operand). Returns a
// cudaError_t; the kernel runs on `stream` without a sync.
#define OPERANDS(T)                                                    \
  operand<T>(a, a_rpb, a_sb, a_sr, a_kcontig, a_vec),                  \
      operand<T>(b, b_rpb, b_sb, b_sr, b_kcontig, b_vec)
#define OPERAND_ARGS                                                   \
  const void *a, int a_rpb, int64_t a_sb, int64_t a_sr, int a_kcontig, \
      int a_vec, const void *b, int b_rpb, int64_t b_sb, int64_t b_sr, \
      int b_kcontig, int b_vec

extern "C" int ring_ag_gemm_launch(int dtype, OPERAND_ARGS, int M, int N,
                                   int K, void* out, int o_rpb, int64_t o_sb,
                                   int64_t o_sr, void* stream) {
  if (bad_sizes(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const RowSplit o{o_rpb, o_sb, o_sr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!a_kcontig) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = b_kcontig ? ring_ag_gemm_bf16_kernel<true>
                            : ring_ag_gemm_bf16_kernel<false>;
    const size_t smem = b_kcontig ? kc_smem<true>() : kc_smem<false>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_of(M, N, kGcBM, kGcBN), kGcThreads, smem, s>>>(
        OPERANDS(__nv_bfloat16), M, N, K, static_cast<__nv_bfloat16*>(out),
        o);
  } else {
    ring_ag_gemm_fp32_kernel<128, 128, 4, 2>
        <<<grid_of(M, N, 128, 128), 256, 0, s>>>(
            OPERANDS(float), M, N, K, static_cast<float*>(out), o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ring_rs_gemm_add_launch(int dtype, OPERAND_ARGS, int M, int N,
                                       int K, void* out, const void* recv,
                                       void* stream) {
  if (bad_sizes(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!a_kcontig) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = b_kcontig ? ring_rs_gemm_add_bf16_kernel<true>
                            : ring_rs_gemm_add_bf16_kernel<false>;
    const size_t smem = b_kcontig ? kc_smem<true>() : kc_smem<false>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_of(M, N, kGcBM, kGcBN), kGcThreads, smem, s>>>(
        OPERANDS(__nv_bfloat16), M, N, K, static_cast<__nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(recv));
  } else {
    ring_rs_gemm_add_fp32_kernel<128, 128, 4, 2>
        <<<grid_of(M, N, 128, 128), 256, 0, s>>>(
            OPERANDS(float), M, N, K, static_cast<float*>(out),
            static_cast<const float*>(recv));
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16: the Hopper kernel above on 128 x 128 output tiles, both operands
// k-major (kcontig 0), K cut into `splits` runs of k_split rows; ws ((splits, M, N) fp32) and tickets (one uint32 per output tile,
// zeroed here) are needed when splits > 1.
// fp32: the FMA tiles, 64 x 64 of 4 warps when small_tiles (the wrapper
// picks them when the 128 x 128 grid would not cover the card's SMs).
extern "C" int ring_gc_gemm_acc_launch(int dtype, OPERAND_ARGS, int M, int N,
                                       int K, float* acc, int first,
                                       void* out, int small_tiles, int splits,
                                       int k_split, float* ws, void* tickets,
                                       void* stream) {
  if (bad_sizes(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (a_kcontig || b_kcontig || splits < 1 || k_split <= 0 ||
        static_cast<int64_t>(splits - 1) * k_split >= K ||
        static_cast<int64_t>(splits) * k_split < K ||
        (splits > 1 && (ws == nullptr || tickets == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = ring_gc_gemm_acc_bf16_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kGcSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((N + kGcBN - 1) / kGcBN),
                    static_cast<unsigned>((M + kGcBM - 1) / kGcBM),
                    static_cast<unsigned>(splits));
    if (splits > 1) {
      err = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * grid.x * grid.y, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kGcThreads, kGcSmem, s>>>(
        OPERANDS(__nv_bfloat16), M, N, K, k_split, acc, first,
        static_cast<__nv_bfloat16*>(out), ws, static_cast<unsigned*>(tickets));
  } else {
    auto o = static_cast<float*>(out);
    if (small_tiles)
      ring_gc_gemm_acc_fp32_kernel<64, 64, 2, 2>
          <<<grid_of(M, N, 64, 64), 128, 0, s>>>(OPERANDS(float), M, N, K,
                                                 acc, first, o);
    else
      ring_gc_gemm_acc_fp32_kernel<128, 128, 4, 2>
          <<<grid_of(M, N, 128, 128), 256, 0, s>>>(OPERANDS(float), M, N, K,
                                                   acc, first, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dW kernel's bf16 output tile rows and k step, so the host's plan
// (gc_plan) and this file cannot disagree.
extern "C" int ring_gc_tile() { return kGcBM; }
extern "C" int ring_gc_k_step() { return kGcBK; }

extern "C" const char* ring_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
