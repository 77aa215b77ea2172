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
//     pass over the candidates (the TPU kernel folds twice to save VMEM).
//     The projection and the norms' block fold are in admm_row.cuh, which
//     admm_step.cu (ADMMA's loop, split around the z-update) shares;
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
// (the TPU kernel's form; the plain version does the same), every sum and
// quotient is rounded on its own (__fadd_rn, __fsub_rn, __fdiv_rn, IEEE
// division) and so is every product that is not exact, a row's slots are
// folded in slot order, and the two norms are summed in an order that no
// launch geometry enters: the check rows in blocks of 8 consecutive rows, a
// block halved with row strides 4, 2, 1; block b goes to lane b mod 32, a
// lane adding its blocks in ascending order; the 32 lanes halved with
// strides 16, 8, 4, 2, 1. Two forms differ from the plain version's in
// spelling only. A product with the facet normal f (+1, -1, or 0 on a
// padded slot) is exact, so f*a + b is one fused multiply-add, rounded
// once as the sum alone is. A clip to [0, 1] is the saturating form of the
// add before it (__saturatef): it differs from min(max(.)) only in the
// sign of a zero, which no later operation can see.
//
// Design. A CTA keeps its word's z and lam, [Dc][C] f32 slot-major each,
// and x, [V] f32, in shared memory for the whole loop (33.6 KB at
// LDPC(1200,3,6); 73.9 KB at margulis, which needs the > 48 KB opt-in),
// and beside them the 2 * ceil(C / 8) block sums of the two norms. x_e and
// v are one gather and one product away from x and lam and are recomputed,
// not stored. The launch geometry is the wrapper's choice per graph
// (ops/admm_kernel.py:admm_geometry): any whole number of warps per word. A warp takes a run of 32 consecutive check rows at a time, one
// row per lane (four whole blocks of 8, so a block's sum is three
// xor-shuffles and one shared store, whatever the geometry), runs going
// round-robin over the warps. The kernel is a template over
//   - the row width Dc (1..kMaxD, wider rows are refused): a row lives in
//     registers and every loop over its slots is unrolled to exactly Dc;
//   - kFull: every check row has Dc real slots (LDPC(1200,3,6), margulis,
//     Hamming(7,4)), so no slot mask is carried or tested;
//   - kDv: 3 where, besides, every variable has exactly 3 slots (the
//     (3,6)-regular LDPC(1200,3,6) and margulis): the x-update, a quarter
//     to a third of an iteration, is unrolled with no padding test and no
//     degree count; 0: the general loop over Dv slots.
// The bracket search has no branch: T at a candidate is 2*Dc fused
// multiply-adds, and because T depends on the candidate's value alone,
// equal candidates bring equal T, so the fold is four compares and four
// selects per candidate with no rule for ties. (As if/else chains the fold
// compiled to divergent branches and cost more than T itself.)
// Two barriers per iteration: after the x-update, and between the block
// sums and the exit decision, which every thread takes from the same
// shared values, so no vote is needed.
//
// What bounds it on the card: operations, not bytes, and of those the
// rate at which an SM starts instructions. Only the products with f can
// fuse with an add, so about half of the 67 TFLOP/s the bound is stated
// against is this arithmetic's ceiling. The projection is O(Dc^2) per
// row (Dc*(Dc-1)/2 rank compares, 2*Dc evaluations of T over Dc slots on
// rows outside the polytope); the state never leaves shared memory. Measured slower or no
// faster on an H100, so not done here: several lanes per check row with
// the candidates dealt out over them (every lane repeats the row's loads,
// rank and update); a second launch that carries a chunk's slowest words
// on at more threads (a chunk of 2048 margulis words does not wait on
// them); a cap of 40 registers per thread (ptxas takes 41 to 46 at Dc = 6,
// handed out as 48; the cap spills on padded rows).

#include "admm_row.cuh"

namespace {

using admm_row::clip01;
using admm_row::fold_blocks;
using admm_row::kAll;
using admm_row::kMaxD;
using admm_row::kRowBlock;
using admm_row::project_row;

constexpr int kMaxThreads = 1024;
// The variable degree with an x-update of its own (see kDv).
constexpr int kRegularDv = 3;

// llr [B, V] f32; chk_var [Dc][C]: variable of check slot (c, d), -1 if
// padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in the
// slot-major z and lam, -1 if padded. Outputs x_out [B][V] int32, it_out
// [B] int32, xf_out [B][V] f32.
template <int kD, bool kFull, int kDv>
__global__ void __launch_bounds__(kMaxThreads)
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
  float* s_blk = s_x + V;                   // [2][nb]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warp = n_thr >> 5;
  const int nb = (C + kRowBlock - 1) / kRowBlock;
  const int n_run = (C + 31) / 32;
  const float* llr_b = llr + static_cast<size_t>(b) * V;
  for (int i = tid; i < Dc * C; i += n_thr) {
    s_z[i] = (kFull || __ldg(chk_var + i) >= 0) ? 0.5f : 0.f;
    s_lam[i] = 0.f;
  }
  for (int v = tid; v < V; v += n_thr) s_x[v] = 0.f;
  __syncthreads();

  int updates = 0;
  int done = 0;
  while (updates < max_iter) {
    // x-update: slots in slot order from 0, the prior last, then the
    // variable's own degree.
    for (int v = tid; v < V; v += n_thr) {
      float acc = 0.f;
      float deg;
      if (kDv > 0) {
        // Every variable has kDv slots: no padding test, no count.
        int f[kDv > 0 ? kDv : 1];
#pragma unroll
        for (int j = 0; j < kDv; ++j) f[j] = __ldg(var_slot + j * V + v);
#pragma unroll
        for (int j = 0; j < kDv; ++j) {
          acc = __fadd_rn(
              acc, __fsub_rn(s_z[f[j]], __fmul_rn(s_lam[f[j]], inv_mu)));
        }
        deg = static_cast<float>(kDv);
      } else {
        int n = 0;
        // Four slots at a time, so that their index loads are in flight
        // together.
        for (int s0 = 0; s0 < Dv; s0 += 4) {
          int f[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f[j] = s0 + j < Dv ? __ldg(var_slot + (s0 + j) * V + v) : -1;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (f[j] < 0) continue;
            ++n;
            acc = __fadd_rn(
                acc, __fsub_rn(s_z[f[j]], __fmul_rn(s_lam[f[j]], inv_mu)));
          }
        }
        deg = static_cast<float>(n);
      }
      acc = __fsub_rn(acc, __fmul_rn(__ldg(llr_b + v), inv_mu));
      s_x[v] = clip01(__fdiv_rn(acc, deg));
    }
    __syncthreads();

    // z-update, dual update and the two norms: a run of 32 consecutive
    // check rows per warp and turn, one row per lane.
    for (int run = warp; run < n_run; run += n_warp) {
      const int c_own = run * 32 + lane;
      const bool live = c_own < C;
      // A lane past the last row shadows it and writes nothing, so that
      // the whole warp meets at every shuffle.
      const int c = live ? c_own : C - 1;
      // A padded slot is v = 0 with f = 0 below: every term it adds to a
      // fold is an exact zero, so the folds carry no mask.
      float v[kD], xe[kD];
      unsigned real = kFull ? (1u << kD) - 1u : 0u;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const int var = __ldg(chk_var + d * C + c);
        if (kFull || var >= 0) {
          if (!kFull) real |= 1u << d;
          xe[d] = s_x[var];
          v[d] = __fadd_rn(xe[d], __fmul_rn(s_lam[d * C + c], inv_mu));
        } else {
          xe[d] = 0.f;
          v[d] = 0.f;
        }
      }
      float f[kD];
      const float beta = project_row<kD, kFull>(v, real, f);
      float row1 = 0.f, row2 = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        // easy: beta = 0 and the clip of v itself.
        const float zn = clip01(__fmaf_rn(-f[d], beta, v[d]));
        const int i = d * C + c;
        const float e1 = __fsub_rn(xe[d], zn);
        const float e2 = __fsub_rn(s_z[i], zn);
        row1 = __fadd_rn(row1, __fmul_rn(e1, e1));
        row2 = __fadd_rn(row2, __fmul_rn(e2, e2));
        if (live && (kFull || ((real >> d) & 1u))) {
          s_z[i] = zn;
          s_lam[i] = __fadd_rn(s_lam[i], __fmul_rn(mu, e1));
        }
      }
      if (!live) {
        row1 = 0.f;
        row2 = 0.f;
      }
      // Block sums: 8 rows, strides 4, 2, 1.
#pragma unroll
      for (int m = 4; m > 0; m >>= 1) {
        row1 = __fadd_rn(row1, __shfl_xor_sync(kAll, row1, m));
        row2 = __fadd_rn(row2, __shfl_xor_sync(kAll, row2, m));
      }
      if (live && lane % kRowBlock == 0) {
        s_blk[c_own / kRowBlock] = row1;
        s_blk[nb + c_own / kRowBlock] = row2;
      }
    }
    // Barrier: z, lam and the block sums complete, x no longer read.
    __syncthreads();
    float tot[2];
    fold_blocks(s_blk, nb, lane, tot);
    ++updates;
    if (tot[0] < thresh && tot[1] < thresh) {
      done = 1;
      break;
    }
  }

  int* x_b = x_out + static_cast<size_t>(b) * V;
  float* xf_b = xf_out + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += n_thr) {
    const float x = s_x[v];
    x_b[v] = x > 0.5f ? 1 : 0;
    xf_b[v] = x;
  }
  if (tid == 0) it_out[b] = updates - done;
}

struct Args {
  const float* llr;
  const int* chk_var;
  const int* var_slot;
  int* x_out;
  int* it_out;
  float* xf_out;
  int B, C, V, Dv;
  float mu, inv_mu, thresh;
  int max_iter, threads;
  cudaStream_t stream;
};

template <int kD, bool kFull, int kDv>
cudaError_t launch(const Args& a) {
  const size_t nb = (a.C + kRowBlock - 1) / kRowBlock;
  const size_t smem = (2 * static_cast<size_t>(kD) * a.C +
                       static_cast<size_t>(a.V) + 2 * nb) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_decode_kernel<kD, kFull, kDv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  admm_decode_kernel<kD, kFull, kDv><<<a.B, a.threads, smem, a.stream>>>(
      a.llr, a.chk_var, a.var_slot, a.x_out, a.it_out, a.xf_out, a.C, a.V,
      a.Dv, a.mu, a.inv_mu, a.thresh, a.max_iter);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_width(const Args& a, bool full, int var_deg) {
  if (var_deg == kRegularDv) return launch<kD, true, kRegularDv>(a);
  return full ? launch<kD, true, 0>(a) : launch<kD, false, 0>(a);
}

}  // namespace

// inv_mu is 1/mu rounded to float32 by the caller, the same value the plain
// version multiplies by. full: no check slot is padded. var_deg: 3 where
// every check row is full and every variable has exactly 3 slots, else 0.
// threads: a multiple
// of 32 up to 1024.
extern "C" int admm_decode_launch(const void* llr, const void* chk_var,
                                  const void* var_slot, void* x_out,
                                  void* it_out, void* xf_out, int B, int C,
                                  int V, int Dc, int Dv, float mu,
                                  float inv_mu, float thresh, int max_iter,
                                  int full, int var_deg, int threads,
                                  void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  // The regular instantiations exist for full check rows only.
  if (var_deg != 0 && (var_deg != kRegularDv || !full || Dv != var_deg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_iter < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(llr),
               static_cast<const int*>(chk_var),
               static_cast<const int*>(var_slot),
               static_cast<int*>(x_out),
               static_cast<int*>(it_out),
               static_cast<float*>(xf_out),
               B, C, V, Dv, mu, inv_mu, thresh, max_iter, threads,
               static_cast<cudaStream_t>(stream)};
  static_assert(kMaxD == 8, "one case per width up to kMaxD");
  switch (Dc) {
    case 1: return static_cast<int>(launch_width<1>(a, full != 0, var_deg));
    case 2: return static_cast<int>(launch_width<2>(a, full != 0, var_deg));
    case 3: return static_cast<int>(launch_width<3>(a, full != 0, var_deg));
    case 4: return static_cast<int>(launch_width<4>(a, full != 0, var_deg));
    case 5: return static_cast<int>(launch_width<5>(a, full != 0, var_deg));
    case 6: return static_cast<int>(launch_width<6>(a, full != 0, var_deg));
    case 7: return static_cast<int>(launch_width<7>(a, full != 0, var_deg));
    case 8: return static_cast<int>(launch_width<8>(a, full != 0, var_deg));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* admm_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
