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
// M = 8192 rows; ~1000 flops per byte moved). What this first design does
// about it: bf16 operands go through the tensor cores with mma.sync m16n8k16
// (fp32 accumulators), 128 x 128 output tiles of 8 warps (64 x 64 of 4 warps
// for the dW products, whose small outputs would otherwise leave most SMs
// idle), 16-byte global loads where the layout allows. No wgmma, TMA or
// multi-stage pipeline yet: the tiles are loaded, synchronised and consumed
// in turn. fp32 operands take a plain FMA path (the parity runs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 8;  // 80-byte rows: conflict-free fragments
};
template <>
struct Pad<float> {
  static constexpr int value = 1;  // 33-word rows
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero_of() {
  return from_f<T>(0.f);
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
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T (*s)[kBK + Pad<T>::value],
                                          const Operand<T>& op, int r0,
                                          int k0, int R, int K) {
  constexpr int V = 16 / sizeof(T);
  union Vec {
    uint4 u;
    T e[V];
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
                             : zero_of<T>();
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
                             : zero_of<T>();
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C[M, N] = sum_k A(m, k) B(k, n) in fp32 for this block's BM x BN tile;
// `epi(m, n, value)` is called once for every in-bounds element.
// bf16: WM x WN warps, each a (BM/WM) x (BN/WN) tile of m16n8k16 products.
template <int BM, int BN, int WM, int WN, typename Epi>
__device__ __forceinline__ void gemm_tile(const Operand<__nv_bfloat16>& A,
                                          const Operand<__nv_bfloat16>& B,
                                          int M, int N, int K, Epi epi) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  constexpr int P = Pad<__nv_bfloat16>::value;
  __shared__ __align__(16) __nv_bfloat16 As[BM][kBK + P];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][kBK + P];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int g = lane >> 2, tg = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile<__nv_bfloat16, BM, THREADS>(As, A, m0, k0, M, K);
    load_tile<__nv_bfloat16, BN, THREADS>(Bs, B, n0, k0, N, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm0 + i * 16 + g;
        af[i][0] = ld32(&As[r][kk + 2 * tg]);
        af[i][1] = ld32(&As[r + 8][kk + 2 * tg]);
        af[i][2] = ld32(&As[r][kk + 2 * tg + 8]);
        af[i][3] = ld32(&As[r + 8][kk + 2 * tg + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn0 + j * 8 + g;
        bfr[j][0] = ld32(&Bs[c][kk + 2 * tg]);
        bfr[j][1] = ld32(&Bs[c][kk + 2 * tg + 8]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                   bfr[j][0], bfr[j][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm0 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn0 + j * 8 + 2 * tg + (e & 1);
        if (m < M && n < N) epi(m, n, acc[i][j][e]);
      }
}

// fp32: the same tiles, each thread an (BM/TY) x (BN/16) strided block of
// FMA sums (rows ty + TY*i, columns tx + 16*j: conflict-free smem reads).
template <int BM, int BN, int WM, int WN, typename Epi>
__device__ __forceinline__ void gemm_tile(const Operand<float>& A,
                                          const Operand<float>& B, int M,
                                          int N, int K, Epi epi) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int TX = 16, TY = THREADS / TX;
  constexpr int RM = BM / TY, RN = BN / TX;
  constexpr int P = Pad<float>::value;
  __shared__ float As[BM][kBK + P];
  __shared__ float Bs[BN][kBK + P];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile<float, BM, THREADS>(As, A, m0, k0, M, K);
    load_tile<float, BN, THREADS>(Bs, B, n0, k0, N, K);
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

// ------------------------------------------------------------- kernels

template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_ag_gemm_kernel(Operand<T> A, Operand<T> B, int M, int N, int K,
                        T* __restrict__ out, RowSplit o) {
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    out[o.off(m) + n] = from_f<T>(v);
  });
}

template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_rs_gemm_add_kernel(Operand<T> A, Operand<T> B, int M, int N, int K,
                            T* out, const T* recv) {
  // out may be recv (the ring loop adds into the slot that arrived): no
  // __restrict__ on either; each element is read, then written, by the
  // one thread that owns it.
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    const int64_t i = static_cast<int64_t>(m) * N + n;
    T part = from_f<T>(v);  // the partial rounds to T before the add
    if (recv != nullptr) part = from_f<T>(to_f(recv[i]) + to_f(part));
    out[i] = part;
  });
}

template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM* WN * 32)
    ring_gc_gemm_acc_kernel(Operand<T> A, Operand<T> B, int M, int N, int K,
                            float* __restrict__ acc, int first,
                            T* __restrict__ out) {
  gemm_tile<BM, BN, WM, WN>(A, B, M, N, K, [&](int m, int n, float v) {
    const int64_t i = static_cast<int64_t>(m) * N + n;
    const float a = first ? v : acc[i] + v;
    acc[i] = a;
    if (out != nullptr) out[i] = from_f<T>(a);
  });
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
    ring_ag_gemm_kernel<__nv_bfloat16, 128, 128, 4, 2>
        <<<grid_of(M, N, 128, 128), 256, 0, s>>>(
            OPERANDS(__nv_bfloat16), M, N, K,
            static_cast<__nv_bfloat16*>(out), o);
  } else {
    ring_ag_gemm_kernel<float, 128, 128, 4, 2>
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
    ring_rs_gemm_add_kernel<__nv_bfloat16, 128, 128, 4, 2>
        <<<grid_of(M, N, 128, 128), 256, 0, s>>>(
            OPERANDS(__nv_bfloat16), M, N, K,
            static_cast<__nv_bfloat16*>(out),
            static_cast<const __nv_bfloat16*>(recv));
  } else {
    ring_rs_gemm_add_kernel<float, 128, 128, 4, 2>
        <<<grid_of(M, N, 128, 128), 256, 0, s>>>(
            OPERANDS(float), M, N, K, static_cast<float*>(out),
            static_cast<const float*>(recv));
  }
  return static_cast<int>(cudaGetLastError());
}

// small_tiles: 64 x 64 tiles of 4 warps (the wrapper picks them when the
// 128 x 128 grid would not cover the card's SMs).
extern "C" int ring_gc_gemm_acc_launch(int dtype, OPERAND_ARGS, int M, int N,
                                       int K, float* acc, int first,
                                       void* out, int small_tiles,
                                       void* stream) {
  if (bad_sizes(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    auto o = static_cast<__nv_bfloat16*>(out);
    if (small_tiles)
      ring_gc_gemm_acc_kernel<__nv_bfloat16, 64, 64, 2, 2>
          <<<grid_of(M, N, 64, 64), 128, 0, s>>>(OPERANDS(__nv_bfloat16), M,
                                                 N, K, acc, first, o);
    else
      ring_gc_gemm_acc_kernel<__nv_bfloat16, 128, 128, 4, 2>
          <<<grid_of(M, N, 128, 128), 256, 0, s>>>(OPERANDS(__nv_bfloat16),
                                                   M, N, K, acc, first, o);
  } else {
    auto o = static_cast<float*>(out);
    if (small_tiles)
      ring_gc_gemm_acc_kernel<float, 64, 64, 2, 2>
          <<<grid_of(M, N, 64, 64), 128, 0, s>>>(OPERANDS(float), M, N, K,
                                                 acc, first, o);
    else
      ring_gc_gemm_acc_kernel<float, 128, 128, 4, 2>
          <<<grid_of(M, N, 128, 128), 256, 0, s>>>(OPERANDS(float), M, N, K,
                                                   acc, first, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ring_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
