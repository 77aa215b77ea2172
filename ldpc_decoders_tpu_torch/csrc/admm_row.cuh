// Device code shared by the ADMM kernels: the exact projection of one check
// row onto the parity polytope and the fixed-order sum of the block sums
// of the two convergence norms. Included by admm_decode.cu (the whole-loop
// kernel) and admm_step.cu (the loop's iteration split around the
// z-update), so both compute the same bits.
//
// Every operation is rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn), as the plain PyTorch version (ops/projection.py) rounds it;
// a fused multiply-add appears only where its product is exact (a factor
// +1, -1 or 0 of the facet normal).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace admm_row {

// Widest check row a thread keeps in registers (the codes of the
// repository have check degree <= 6).
constexpr int kMaxD = 8;
constexpr int kRowBlock = 8;        // rows per block of the norm sums
constexpr unsigned kAll = 0xffffffffu;

// A clip to [0, 1] is the saturating form of the add before it: it
// differs from min(max(.)) only in the sign of a zero, which no later
// operation can see.
__device__ __forceinline__ float clip01(float v) { return __saturatef(v); }

// sum[n] over the block sums blk[n][0..nb), n = 0, 1: lane j adds blocks
// j, j + 32, ... in ascending order, then the lanes are halved.
__device__ __forceinline__ void fold_blocks(const float* blk, int nb,
                                            int lane, float tot[2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float* w = blk + n * nb;
    float acc = lane < nb ? w[lane] : 0.f;
    for (int b = lane + 32; b < nb; b += 32) acc = __fadd_rn(acc, w[b]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(kAll, acc, s));
    }
    tot[n] = acc;
  }
}

// The projection of the row v[0..kD) onto the parity polytope: descending
// rank with index tie-break, s = floor(sum clip(v)), r = s - (s mod 2),
// f = +1 where rank <= r else -1; if f.clip(v) <= r the clip is the
// answer (beta = 0), else clip(v - beta*f) with beta bracketed over the
// 2*kD + 1 candidates (0, and per slot max(v-1 or -v, 0) and max(v or
// 1-v, 0)) by T(beta) = f.clip(v - beta*f) against r and interpolated
// linearly, guarded by t_lo - t_hi > 0. Fills f and returns beta; the
// projection is clip01(fmaf(-f[d], beta, v[d])).
//
// A padded slot (its bit clear in `real`; kFull: none) has v = 0 and gets
// f = 0, so every term it adds to a fold is an exact zero. T depends only
// on the candidate's value, so lo, hi, T(lo) and T(hi) are tracked in one
// pass with no rule for ties, and the fold is compares and selects, no
// branch (as if/else chains it compiled to divergent branches and cost
// more than T itself).
template <int kD, bool kFull>
__device__ __forceinline__ float project_row(const float (&v)[kD],
                                             unsigned real, float (&f)[kD]) {
  // Cube clip and its slot-order sum; r = even floor.
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) s = __fadd_rn(s, clip01(v[d]));
  const int r_i = static_cast<int>(floorf(s)) & ~1;
  const float r = static_cast<float>(r_i);
  // Facet normal from the descending rank (ties by index): of two real
  // slots e < d exactly one outranks the other: e where v[e] >= v[d].
  int rank[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) rank[d] = 0;
#pragma unroll
  for (int d = 1; d < kD; ++d) {
#pragma unroll
    for (int e = 0; e < d; ++e) {
      if (!kFull && !((real >> d) & (real >> e) & 1u)) continue;
      const int e_first = v[e] >= v[d];
      rank[d] += e_first;
      rank[e] += 1 - e_first;
    }
  }
  // f * x below is an exact product (f is +-1 or 0), so a fused
  // multiply-add with it rounds once, as the sum alone does.
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    f[d] = rank[d] <= r_i ? 1.f : -1.f;
    if (!kFull && !((real >> d) & 1u)) f[d] = 0.f;
  }
  float fz = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) fz = __fmaf_rn(f[d], clip01(v[d]), fz);
  if (fz <= r) return 0.f;          // inside the polytope: the clip
  // beta = 0 is the first candidate: T(0) = fz > r.
  float lo = 0.f, t_lo = fz, hi = CUDART_INF_F, t_hi = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 2 * kD; ++k) {
    const int d = k >> 1;
    // top: v - 1 and v; else: -v and 1 - v.
    const float fv = __fmul_rn(f[d], v[d]);
    const float step = (k & 1) ? (f[d] > 0.f ? 0.f : 1.f)
                               : (f[d] > 0.f ? -1.f : 0.f);
    float cand = fmaxf(__fadd_rn(fv, step), 0.f);
    if (!kFull && !((real >> d) & 1u)) cand = 0.f;
    float t = 0.f;
#pragma unroll
    for (int e = 0; e < kD; ++e) {
      t = __fmaf_rn(f[e], clip01(__fmaf_rn(-f[e], cand, v[e])), t);
    }
    const bool up = t >= r && cand > lo;
    lo = up ? cand : lo;
    t_lo = up ? t : t_lo;
    const bool down = t <= r && cand < hi;
    hi = down ? cand : hi;
    t_hi = down ? t : t_hi;
  }
  const float denom = __fsub_rn(t_lo, t_hi);
  if (!(denom > 0.f)) return lo;
  return __fadd_rn(
      lo, __fdiv_rn(__fmul_rn(__fsub_rn(t_lo, r), __fsub_rn(hi, lo)), denom));
}

}  // namespace admm_row
