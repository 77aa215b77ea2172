// Whole-loop ternary erasure SPA (peeling) for one LDPC codeword per CTA.
//
// Replaces ldpc_decoders_tpu/ops/pallas_bp.py:_bec_kernel (reached through
// bec_spa_decode_pallas -> _launch_bp -> pl.pallas_call). It computes what
// that kernel and the gather route of decoders/bec_spa.py compute, symbol
// for symbol and iteration count for iteration count:
//   - channel symbols {0, 1, 2} (2 = erasure) become priors {-1, +1, 0};
//     x_hat starts as the priors; the first v2c on every edge is the prior;
//     a word with no erasure is done at once with iters = 0;
//   - check pass over the row's REAL slots (padded slots are skipped: they
//     are neutral for both counts): unknowns = #(v2c == 0), ones =
//     #(v2c > 0). No unknown: every slot gets its OWN message back (an
//     echo, not extrinsic). Exactly one: the unknown slot gets
//     2 * (ones mod 2) - 1 and every other slot 0. Two or more: all 0;
//   - variable pass: marg = prior + sum of c2v (small integers, any
//     order); v2c = sign(marg[var] - c2v); x_new = sign(marg);
//   - the word is done when no erasure is left in x_hat, or x_new == x_hat
//     in all V positions (a stopping set; the literal comparison, since on
//     an input that is no codeword's image two checks can disagree and a
//     marginal can return to 0). The iteration that detects the stop counts
//     in iters;
//   - output: sign -1 / 0 / +1 -> symbol 0 / 2 / 1.
// Snapshot planes: x_out is [K][B][V]; plane k holds the symbols after
// caps[k] iterations, or the final state where the word stopped earlier
// (_snap_write / _snap_fill of the TPU kernel). A single-cap decode is
// K = 1 with caps = {max_iter}.
//
// Design. Everything is a small integer, so the CTA keeps its word as
// int8 in shared memory for the whole loop: priors and marginals ([V]
// each) and the check-to-variable messages ([Dc][C], slot-major, so
// consecutive threads touch consecutive checks). v2c is never stored: the
// check pass rebuilds sign(marg - c2v) from the marginal and the old c2v
// (with c2v = 0 and marg = prior that is the prior, the first message).
// x_hat is the sign of the stored marginal, so the variable pass compares
// the new sign with the old one before it overwrites it. A snapshot is a
// pass of its own after the variable pass; a thread reads back exactly
// the marginals it has just written, so snapshots need no barrier of
// their own. The two CTA-wide tests (decisions
// unchanged, erasures left) are barrier votes that every thread reaches
// once per iteration. max_iter is a run-time bound (2000 in converge mode).
//
// What bounds it on the card: latency. Device memory sees V*4 bytes in and
// K*V*4 bytes out per word; an iteration is ~2E one-byte shared-memory
// reads and E writes around three barriers, with almost no arithmetic
// (~6 KB of state at LDPC(1200,3,6), ~13 KB at margulis, so many CTAs
// share an SM and hide each other's barrier stalls).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCaps = 16;

struct Caps {
  int n;
  int at[kMaxCaps];  // ascending, at[n-1] == max_iter
};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }
__device__ __forceinline__ int to_sym(int s) {
  return s < 0 ? 0 : (s > 0 ? 1 : 2);
}

// y [B, V] int32 symbols; chk_var [Dc][C]: variable of check slot (c, d),
// -1 if padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in
// the slot-major c2v, -1 if padded. Outputs x_out [K][B][V], it_out [B].
__global__ void bec_decode_kernel(const int* __restrict__ y,
                                  const int* __restrict__ chk_var,
                                  const int* __restrict__ var_slot,
                                  int* __restrict__ x_out,
                                  int* __restrict__ it_out, int B, int C,
                                  int V, int Dc, int Dv, int max_iter,
                                  Caps caps) {
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* s_prior = reinterpret_cast<signed char*>(smem);
  signed char* s_marg = s_prior + V;
  signed char* s_c2v = s_marg + V;

  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(B) * V;
  const int* y_b = y + static_cast<size_t>(b) * V;
  int* x_b = x_out + static_cast<size_t>(b) * V;

  int erased = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const int sym = y_b[v];
    const int p = sym == 2 ? 0 : 2 * sym - 1;
    s_prior[v] = static_cast<signed char>(p);
    s_marg[v] = static_cast<signed char>(p);
    erased |= (p == 0);
  }
  for (int i = threadIdx.x; i < Dc * C; i += blockDim.x) s_c2v[i] = 0;
  bool done = !__syncthreads_or(erased);  // also: state initialised

  int it = 0;
  int kn = 0;  // next snapshot plane to write
  while (it < max_iter && !done) {
    // Check pass: v2c = sign(marg - c2v) per real slot, then the new c2v.
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      unsigned zero = 0u, pos = 0u, real = 0u;
      for (int d = 0; d < Dc; ++d) {
        const int v = __ldg(chk_var + d * C + c);
        if (v < 0) continue;
        real |= 1u << d;
        const int m = static_cast<int>(s_marg[v]) -
                      static_cast<int>(s_c2v[d * C + c]);
        if (m == 0) zero |= 1u << d;
        if (m > 0) pos |= 1u << d;
      }
      const int unknowns = __popc(zero);
      const int parity = 2 * (__popc(pos) & 1) - 1;
      for (int d = 0; d < Dc; ++d) {
        if (!((real >> d) & 1u)) continue;
        int out = 0;
        if (unknowns == 0) {
          out = ((pos >> d) & 1u) ? 1 : -1;
        } else if (unknowns == 1 && ((zero >> d) & 1u)) {
          out = parity;
        }
        s_c2v[d * C + c] = static_cast<signed char>(out);
      }
    }
    __syncthreads();  // c2v complete, marg no longer read

    // Variable pass: marg = prior + sum of c2v; compare the decisions.
    int same = 1;
    erased = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      int acc = s_prior[v];
      for (int s = 0; s < Dv; ++s) {
        const int f = __ldg(var_slot + s * V + v);
        if (f >= 0) acc += s_c2v[f];
      }
      const int xs = sgn(acc);
      same &= (xs == sgn(s_marg[v]));
      erased |= (xs == 0);
      s_marg[v] = static_cast<signed char>(acc);
    }
    ++it;
    if (it == caps.at[kn]) {
      int* x_k = x_b + kn * plane;
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        x_k[v] = to_sym(sgn(s_marg[v]));
      }
      ++kn;
    }
    // Uniform votes; the first is also the barrier that completes marg.
    const bool stopped = __syncthreads_and(same);
    const bool left = __syncthreads_or(erased);
    done = stopped || !left;
  }

  // Planes the loop never reached hold the final state.
  for (int k = kn; k < caps.n; ++k) {
    int* x_k = x_b + k * plane;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      x_k[v] = to_sym(sgn(s_marg[v]));
    }
  }
  if (threadIdx.x == 0) it_out[b] = it;
}

}  // namespace

extern "C" int bec_decode_launch(const void* y, const void* chk_var,
                                 const void* var_slot, void* x_out,
                                 void* it_out, int B, int C, int V, int Dc,
                                 int Dv, int max_iter, const int* caps,
                                 int n_caps, int threads, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n_caps < 1 || n_caps > kMaxCaps || Dc > 32 ||
      caps[n_caps - 1] != max_iter) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Caps cp;
  cp.n = n_caps;
  for (int k = 0; k < kMaxCaps; ++k) cp.at[k] = k < n_caps ? caps[k] : -1;
  const size_t smem = 2 * static_cast<size_t>(V) +
                      static_cast<size_t>(Dc) * C;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bec_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bec_decode_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y), static_cast<const int*>(chk_var),
      static_cast<const int*>(var_slot), static_cast<int*>(x_out),
      static_cast<int*>(it_out), B, C, V, Dc, Dv, max_iter, cp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bec_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
