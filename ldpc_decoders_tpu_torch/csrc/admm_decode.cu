// Whole-loop ADMM LP decoding for one LDPC codeword per CTA.
//
// Replaces both ADMM kernels of ldpc_decoders_tpu/ops/pallas_bp.py:
//   - _admm_kernel + _admm_core (admm_decode_pallas -> pl.pallas_call), the
//     loop over dense one-hot tables (LDPC(1200,3,6));
//   - _admm_kernel_fac (admm_decode_pallas_factored -> pl.pallas_call), the
//     same core over digit-factorized tables, which exists only because
//     margulis' one-hots do not fit the TPU's VMEM.
// The TPU kernels move values between the variable and the check layout
// with 3-term-split one-hot matrix products because the TPU has no gather.
// Here both hops are exact gathers through the index tables of
// ops/graph.py:bp_tables (-1 = padded slot), so one kernel serves the
// regular codes, margulis, codes of non-uniform variable degree
// (Hamming(7,4)) and codes with padded check rows (the IREG members), which
// the TPU kernels refuse.
//
// It computes what decoders/admm.py and _admm_core compute, per word, from
// z = 0.5, lam = 0:
//   - x-update: x[v] = clip((sum over v's slots of (z - lam/mu) - gamma/mu)
//     / deg(v), 0, 1), deg(v) the variable's own degree;
//   - z-update: per check row, v = x_e + lam/mu, z_new = the Euclidean
//     projection of v onto the parity polytope (ops/projection.py):
//     descending rank with index tie-break, s = floor(sum clip(v)),
//     r = s - (s mod 2), f = +1 where rank <= r else -1; if f.clip(v) <= r
//     the clip is the answer, else clip(v - beta*f) with beta bracketed
//     over the 2*Dc + 1 candidates (0, and per slot max(v-1 or -v, 0) and
//     max(v or 1-v, 0)) by T(beta) = f.clip(v - beta*f) against r and
//     interpolated linearly, guarded by t_lo - t_hi > 0. T depends only on
//     the candidate's value, so lo, hi, T(lo) and T(hi) are tracked in one
//     pass over the candidates (the TPU kernel folds twice to save VMEM);
//   - dual: lam += mu * (x_e - z_new);
//   - the word is done when both ||x_e - z_new||^2 and ||z - z_new||^2 are
//     below eps^2 * nnz(H): its CTA leaves the loop (the Pallas kernel's
//     exit is per block of 32 or 64 words only because of the TPU), the
//     converging iteration's x kept;
//   - outputs: the decision x > 0.5, the fractional x itself (allow_pseudo
//     reads it), and iters = k - 1 for a word that converged at update k,
//     max_iter for one that did not (the reference's histogram).
//
// Bit-equality with the plain PyTorch version (ops/admm_kernel.py) on the
// card: lam/mu and gamma/mu are products with 1/mu rounded to float32 once
// (the TPU kernel's form; the plain version does the same), every product,
// sum and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no FMA contraction, IEEE division), a row's slots are folded
// in slot order, and the two norms are summed in a
// fixed tree: thread t adds the rows c = t, t + 256, ... in ascending
// order, a warp halves its 32 values by xor-shuffles with strides 16, 8,
// 4, 2, 1 (a + b is commutative, so every lane holds the halving tree's
// value), and every thread adds the 8 warp sums by halving with strides 4,
// 2, 1. The launch therefore always has 256 threads.
//
// Design. A CTA keeps its word's z and lam, [Dc][C] f32 slot-major each,
// and x, [V] f32, in shared memory for the whole loop (33.6 KB at
// LDPC(1200,3,6); 73.9 KB at margulis, which needs the > 48 KB opt-in).
// x_e and v are one gather and one product away from x and lam and are
// recomputed, not stored. One thread owns a check row and keeps it in
// registers: the kernel is a template over the row width Dc, one
// instantiation per width up to kMaxD (wider rows are refused), so every
// loop over a row's slots is unrolled to exactly Dc; the
// row's z and lam slots are only ever touched by that thread in the
// z-update. Two barriers per iteration: after the x-update, and between
// the warp sums and the exit decision, which every thread takes from the
// same 16 shared values, so no vote is needed.
//
// What bounds it on the card: operations, not bytes. The projection is
// O(Dc^2) per row (Dc*(Dc-1) rank compares, 2*Dc evaluations of T over Dc
// slots on rows outside the polytope); the state never leaves shared
// memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Widest check row a thread keeps in registers (the codes of the
// repository have check degree <= 6).
constexpr int kMaxD = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// llr [B, V] f32; chk_var [Dc][C]: variable of check slot (c, d), -1 if
// padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in the
// slot-major z and lam, -1 if padded. Outputs x_out [B][V] int32, it_out
// [B] int32, xf_out [B][V] f32.
template <int kD>
__global__ void __launch_bounds__(kThreads)
admm_decode_kernel(const float* __restrict__ llr,
                   const int* __restrict__ chk_var,
                   const int* __restrict__ var_slot, int* __restrict__ x_out,
                   int* __restrict__ it_out, float* __restrict__ xf_out,
                   int C, int V, int Dv, float mu, float inv_mu,
                   float thresh, int max_iter) {
  constexpr int Dc = kD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_z = reinterpret_cast<float*>(smem);
  float* s_lam = s_z + Dc * C;
  float* s_x = s_lam + Dc * C;
  __shared__ float s_red[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* llr_b = llr + static_cast<size_t>(b) * V;
  for (int i = tid; i < Dc * C; i += kThreads) {
    s_z[i] = __ldg(chk_var + i) >= 0 ? 0.5f : 0.f;
    s_lam[i] = 0.f;
  }
  for (int v = tid; v < V; v += kThreads) s_x[v] = 0.f;
  __syncthreads();

  int updates = 0;
  int done = 0;
  while (updates < max_iter) {
    // x-update: slots in slot order from 0, the prior last, then the
    // variable's own degree.
    for (int v = tid; v < V; v += kThreads) {
      float acc = 0.f;
      int deg = 0;
      for (int s = 0; s < Dv; ++s) {
        const int f = __ldg(var_slot + s * V + v);
        if (f < 0) continue;
        ++deg;
        acc = __fadd_rn(acc, __fsub_rn(s_z[f], __fmul_rn(s_lam[f], inv_mu)));
      }
      acc = __fsub_rn(acc, __fmul_rn(__ldg(llr_b + v), inv_mu));
      s_x[v] = clip01(__fdiv_rn(acc, static_cast<float>(deg)));
    }
    __syncthreads();

    // z-update, dual update and the two norms, one check row per thread.
    float d1 = 0.f, d2 = 0.f;
    for (int c = tid; c < C; c += kThreads) {
      float v[kD], xe[kD];
      unsigned real = 0u;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        v[d] = 0.f;
        xe[d] = 0.f;
        const int var = __ldg(chk_var + d * C + c);
        if (var >= 0) {
          real |= 1u << d;
          xe[d] = s_x[var];
          v[d] = __fadd_rn(xe[d], __fmul_rn(s_lam[d * C + c], inv_mu));
        }
      }
      // Cube clip and its slot-order sum; r = even floor.
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if ((real >> d) & 1u) s = __fadd_rn(s, clip01(v[d]));
      }
      const int r_i = static_cast<int>(floorf(s)) & ~1;
      const float r = static_cast<float>(r_i);
      // Facet normal from the descending rank (ties by index): bit d of
      // `top` set where rank <= r.
      unsigned top = 0u;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (!((real >> d) & 1u)) continue;
        int rank = 0;
#pragma unroll
        for (int e = 0; e < kD; ++e) {
          if (e == d || !((real >> e) & 1u)) continue;
          rank += (v[e] > v[d]) || (v[e] == v[d] && e < d);
        }
        if (rank <= r_i) top |= 1u << d;
      }
      float fz = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (!((real >> d) & 1u)) continue;
        const float zc = clip01(v[d]);
        fz = __fadd_rn(fz, ((top >> d) & 1u) ? zc : -zc);
      }
      const bool easy = fz <= r;
      float beta = 0.f;
      if (!easy) {
        // beta = 0 is the first candidate: T(0) = fz > r.
        float lo = 0.f, t_lo = fz, hi = CUDART_INF_F, t_hi = CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < 2 * kD; ++k) {
          const int d = k >> 1;
          if (!((real >> d) & 1u)) continue;
          const bool is_top = (top >> d) & 1u;
          float cand;
          if (k & 1) {
            cand = is_top ? v[d] : __fsub_rn(1.f, v[d]);
          } else {
            cand = is_top ? __fsub_rn(v[d], 1.f) : -v[d];
          }
          cand = fmaxf(cand, 0.f);
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < kD; ++e) {
            if (!((real >> e) & 1u)) continue;
            t = ((top >> e) & 1u)
                    ? __fadd_rn(t, clip01(__fsub_rn(v[e], cand)))
                    : __fsub_rn(t, clip01(__fadd_rn(v[e], cand)));
          }
          if (t >= r) {
            if (cand > lo) {
              lo = cand;
              t_lo = t;
            } else if (cand == lo) {
              t_lo = fmaxf(t_lo, t);
            }
          }
          if (t <= r) {
            if (cand < hi) {
              hi = cand;
              t_hi = t;
            } else if (cand == hi) {
              t_hi = fminf(t_hi, t);
            }
          }
        }
        const float denom = __fsub_rn(t_lo, t_hi);
        beta = lo;
        if (denom > 0.f) {
          beta = __fadd_rn(
              lo, __fdiv_rn(__fmul_rn(__fsub_rn(t_lo, r), __fsub_rn(hi, lo)),
                            denom));
        }
      }
      float row1 = 0.f, row2 = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (!((real >> d) & 1u)) continue;
        float zn;
        if (easy) {
          zn = clip01(v[d]);
        } else {
          zn = clip01(((top >> d) & 1u) ? __fsub_rn(v[d], beta)
                                        : __fadd_rn(v[d], beta));
        }
        const int i = d * C + c;
        const float e1 = __fsub_rn(xe[d], zn);
        const float e2 = __fsub_rn(s_z[i], zn);
        row1 = __fadd_rn(row1, __fmul_rn(e1, e1));
        row2 = __fadd_rn(row2, __fmul_rn(e2, e2));
        s_z[i] = zn;
        s_lam[i] = __fadd_rn(s_lam[i], __fmul_rn(mu, e1));
      }
      d1 = __fadd_rn(d1, row1);
      d2 = __fadd_rn(d2, row2);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      d1 = __fadd_rn(d1, __shfl_xor_sync(0xffffffffu, d1, s));
      d2 = __fadd_rn(d2, __shfl_xor_sync(0xffffffffu, d2, s));
    }
    if ((tid & 31) == 0) {
      s_red[0][tid >> 5] = d1;
      s_red[1][tid >> 5] = d2;
    }
    // Barrier: z, lam and the warp sums complete, x no longer read.
    __syncthreads();
    float tot[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* w = s_red[n];
      tot[n] = __fadd_rn(
          __fadd_rn(__fadd_rn(w[0], w[4]), __fadd_rn(w[2], w[6])),
          __fadd_rn(__fadd_rn(w[1], w[5]), __fadd_rn(w[3], w[7])));
    }
    ++updates;
    if (tot[0] < thresh && tot[1] < thresh) {
      done = 1;
      break;
    }
  }

  int* x_b = x_out + static_cast<size_t>(b) * V;
  float* xf_b = xf_out + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += kThreads) {
    const float x = s_x[v];
    x_b[v] = x > 0.5f ? 1 : 0;
    xf_b[v] = x;
  }
  if (tid == 0) it_out[b] = updates - done;
}

template <int kD>
cudaError_t launch(const float* llr, const int* chk_var, const int* var_slot,
                   int* x_out, int* it_out, float* xf_out, int B, int C,
                   int V, int Dv, float mu, float inv_mu, float thresh,
                   int max_iter, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(kD) * C +
                       static_cast<size_t>(V)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_decode_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  admm_decode_kernel<kD><<<B, kThreads, smem, stream>>>(
      llr, chk_var, var_slot, x_out, it_out, xf_out, C, V, Dv, mu, inv_mu,
      thresh, max_iter);
  return cudaGetLastError();
}

}  // namespace

// inv_mu is 1/mu rounded to float32 by the caller, the same value the plain
// version multiplies by.
extern "C" int admm_decode_launch(const void* llr, const void* chk_var,
                                  const void* var_slot, void* x_out,
                                  void* it_out, void* xf_out, int B, int C,
                                  int V, int Dc, int Dv, float mu,
                                  float inv_mu, float thresh, int max_iter,
                                  void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (max_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxD == 8, "one ADMM_DECODE_CASE per width up to kMaxD");
  cudaError_t e = cudaErrorInvalidValue;    // stays for Dc outside 1..kMaxD
  switch (Dc) {
#define ADMM_DECODE_CASE(D)                                                 \
  case D:                                                                   \
    e = launch<D>(static_cast<const float*>(llr),                           \
                  static_cast<const int*>(chk_var),                         \
                  static_cast<const int*>(var_slot),                        \
                  static_cast<int*>(x_out), static_cast<int*>(it_out),      \
                  static_cast<float*>(xf_out), B, C, V, Dv, mu, inv_mu,     \
                  thresh, max_iter, static_cast<cudaStream_t>(stream));     \
    break;
    ADMM_DECODE_CASE(1)
    ADMM_DECODE_CASE(2)
    ADMM_DECODE_CASE(3)
    ADMM_DECODE_CASE(4)
    ADMM_DECODE_CASE(5)
    ADMM_DECODE_CASE(6)
    ADMM_DECODE_CASE(7)
    ADMM_DECODE_CASE(8)
#undef ADMM_DECODE_CASE
  }
  return static_cast<int>(e);
}

extern "C" const char* admm_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
