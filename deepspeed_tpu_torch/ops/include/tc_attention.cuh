// Tensor-core attention building blocks shared by the port's flash and
// block-sparse kernels, forward and backward (sm_90a): the type helpers,
// the exactness checks that give each pair's P (and the forward's running
// max) and dS the plain versions' bits, the forward's whole key-tile step
// (tc_fwd_step), and the mma.sync tile products over rows staged in shared
// memory. Blocks of kTcThreads threads, 4 warps of 16 rows each.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace tc_attention {

constexpr int kTcThreads = 128;  // 4 warps x 16 rows of a block's 64

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

constexpr float kTcNegInf = -1e30f;  // a masked score, never -inf

// The score terms of the forward's step (tc_fwd_step): score() takes the
// tensor-core S of live pair (kc, h2) to the score, exact() the re-summed
// S, both in the plain version's order of fp32 operations; bound(kc, h2,
// sx) is a value b whose 1.2e-7 b bounds the roundings of the per-pair
// terms on top of err0 and whose 2.4e-7 b does so for x = score - m_new
// (read only when PER_PAIR). kZeroDead: a row whose running max is still
// kTcNegInf gets P = 0 (the block-sparse contract; flash's plain version
// has no such rule). FwdScale: S scale alone (flash, no bias).
struct FwdScale {
  static constexpr bool kZeroDead = false;
  float scale;
  __device__ __forceinline__ float score(float s, int, int) const {
    return __fmul_rn(s, scale);
  }
  __device__ __forceinline__ float exact(float s, int, int) const {
    return score_of(s, scale, 0.f);
  }
  __device__ __forceinline__ float bound(int, int, float) const {
    return 0.f;
  }
};
// S scale + b[key] (flash's key-padding bias; the tile's keys in b):
// one rounding more, of a result at most sx + |b| (err0 counts the sx).
struct FwdKeyBias {
  static constexpr bool kZeroDead = false;
  float scale;
  const float* b;
  __device__ __forceinline__ float score(float s, int kc, int) const {
    return score_of(s, scale, b[kc]);
  }
  __device__ __forceinline__ float exact(float s, int kc, int) const {
    return score_of(s, scale, b[kc]);
  }
  __device__ __forceinline__ float bound(int kc, int, float) const {
    return fabsf(b[kc]);
  }
};

// One key tile of the tensor-core forward for a warp's 16 rows x N keys
// (flash_fwd_tc_kernel, block_sparse_fwd_tc_kernel). sc holds the
// tensor-core S (tc_abt); live_of(kc, h2) says whether the pair of key
// column kc and row g + 8 h2 counts (the others score kTcNegInf); m, l, acc
// are the rows' online
// softmax state (this thread's rows g and g + 8), updated in place; qw the
// warp's 16 query rows, k_t and v_t the tile's N key rows, at pitch ld in
// shared memory; qn the two rows' norms, kmax the tile's largest key norm;
// pw this thread's 32 slots in shared memory.
//
// P = exp(sc - m_new) is rounded to T before P.V, so P must have the plain
// version's bits, and so must the running max m_new, which the plain
// version takes over its own scores. The tensor-core scores sc lie within
// err of the plain sc; the pairs that may hold the plain tile max (sc +
// err reaches both the best sc - err of the row and the running max: none
// in most later tiles) are summed again in the plain order, and their
// exact scores give m_new exactly; then each pair's P, and the pairs whose
// P lies within the bound of a rounding edge of T are summed again. Both
// re-sums are done by the lane that holds the pair: about ten a warp tile
// of 1024 pairs, where the backward's shared list cost more than the sums
// (probes/kernel_probe.py fwd_variants). PER_PAIR: the terms' bound
// differs pair by pair (a bias), else it is 0 and the row's bounds hold.
template <typename T, int D, int N, bool PER_PAIR, typename Terms,
          typename Live>
__device__ __forceinline__ void tc_fwd_step(
    float (&sc)[N / 8][4], Live live_of, float (&m)[2], float (&l)[2],
    float (&acc)[D / 8][4], const T* qw, const T* k_t, const T* v_t, int ld,
    const float (&qn)[2], float kmax, float scale, const Terms& terms,
    float* pw, int lane) {
  static_assert(N == 64, "a warp tile's pairs are the 32 bits of live");
  constexpr int NJ = N / 8;
  const int g = lane >> 2, tg = lane & 3;
  // per row: a bound on |sc - sc_plain| before the per-pair terms (S
  // within es of the plain S, two roundings a side) and |S scale|
  float err0[2], sx[2], es_s[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    sx[h2] = qn[h2] * kmax * scale;
    es_s[h2] = kProductSlack * qn[h2] * kmax * scale;
    err0[h2] = es_s[h2] + 2.4e-7f * sx[h2];
  }

  // the scores of the live pairs; hi and lo bound the plain tile max of
  // each row from above and below
  uint32_t live = 0;
  float hi[2] = {kTcNegInf, kTcNegInf}, lo[2] = {kTcNegInf, kTcNegInf};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h2 = e >> 1, kc = j * 8 + 2 * tg + (e & 1);
      const bool ok = live_of(kc, h2);
      live |= ok ? 1u << (j * 4 + e) : 0u;
      if constexpr (PER_PAIR) {
        const float err = err0[h2] + 1.2e-7f * terms.bound(kc, h2, sx[h2]);
        sc[j][e] = ok ? terms.score(sc[j][e], kc, h2) : kTcNegInf;
        hi[h2] = fmaxf(hi[h2], ok ? sc[j][e] + err : kTcNegInf);
        lo[h2] = fmaxf(lo[h2], ok ? sc[j][e] - err : kTcNegInf);
      } else {
        sc[j][e] = ok ? terms.score(sc[j][e], kc, h2) : kTcNegInf;
        hi[h2] = fmaxf(hi[h2], sc[j][e]);
      }
    }
  // the pairs that may hold the plain tile max where it may pass the
  // running max m (none when hi < m): the plain max is at least lo, so
  // no pair whose sc + err is below max(lo, m) matters; their scores
  // summed again in the plain order give the tile max, and m_new, exactly
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if constexpr (PER_PAIR) {
      hi[h2] = quad_max(hi[h2]);
      lo[h2] = fmaxf(quad_max(lo[h2]), m[h2]);
    } else {
      const float mx = quad_max(hi[h2]);
      hi[h2] = mx > kTcNegInf ? mx + err0[h2] : kTcNegInf;
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
            PER_PAIR ? err0[h2] + 1.2e-7f * terms.bound(
                                            j * 8 + 2 * tg + (e & 1), h2,
                                            sx[h2])
                     : err0[h2];
        if (hi[h2] >= m[h2] && sc[j][e] + err >= lo[h2])
          cand |= live & 1u << (j * 4 + e);
      }
  }
  float mt[2] = {kTcNegInf, kTcNegInf};
  for (uint32_t f = cand; f != 0u; f &= f - 1u) {
    const int pos = __ffs(f) - 1, h2 = (pos & 3) >> 1;
    const int kc = (pos >> 2) * 8 + 2 * tg + (pos & 1);
    const float v = terms.exact(
        seq_dot<T, D>(qw + (g + h2 * 8) * ld, k_t + kc * ld), kc, h2);
    mt[0] = h2 ? mt[0] : fmaxf(mt[0], v);
    mt[1] = h2 ? fmaxf(mt[1], v) : mt[1];
  }
  float m_new[2], corr[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    m_new[h2] = fmaxf(m[h2], quad_max(mt[h2]));
    corr[h2] = expf(__fsub_rn(m[h2], m_new[h2]));
  }
  if constexpr (Terms::kZeroDead) {
    // a dead row's pairs (bits j * 4 + e, e >> 1 its h2) leave the live
    // set: P = 0, and no pair of it is summed again
    live &= (m_new[0] <= kTcNegInf ? 0xCCCCCCCCu : ~0u) &
            (m_new[1] <= kTcNegInf ? 0x33333333u : ~0u);
    cand &= live;
  }

  // P at the plain bits: the candidates, and the pairs whose P lies
  // within the bound of a rounding edge of T (edge_bound's ex and tp,
  // with each pair's terms), are summed again
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
      if constexpr (PER_PAIR) {
        const float ex =
            exb[h2] + 2.4e-7f * terms.bound(j * 8 + 2 * tg + (e & 1), h2,
                                            sx[h2]);
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
    const float v = terms.exact(
        seq_dot<T, D>(qw + (g + h2 * 8) * ld, k_t + kc * ld), kc, h2);
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
  tc_pb<T, D, N>(acc, sc, v_t, ld, lane);
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

}  // namespace tc_attention
