// Whole-loop ternary erasure SPA (peeling): G warps per LDPC codeword, W
// words per CTA, on a persistent grid.
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
// What bounds it on the card: latency and instruction issue in the two
// passes, not device memory (V*4 bytes in and K*V*4 out per word) nor
// arithmetic (a few integer operations per edge). The kernel it replaces
// gave each word a CTA of 256 threads (8 words per SM) and crossed three
// CTA-wide barriers per iteration, but thread 0 spent only 2-3% of its
// loop at them (scripts/profile_bp_kernel.py on an H100): the passes' own
// instructions and latencies, with run-time slot loops that read every
// index from L1 (twice per check slot), set its time.
//
// Design.
//   - A word per group of G warps (G in {1, 2, 4, 8}): W words of one
//     warp per CTA, syncing and voting with __syncwarp and __all_sync /
//     __any_sync, or one word of G > 1 warps per CTA, on the CTA's own
//     barrier (__syncthreads_and / _or). Either way a word's barrier waits
//     for no other word.
//   - A persistent grid: as many CTAs as the card holds
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); a group takes
//     its next word from a device counter (atomicAdd; the wrapper zeroes it
//     per launch) as soon as its word is done, in the same slice of shared
//     memory. Outputs are indexed by word, so the order is invisible.
//   - int8 state, exact: priors and marginals ([V] each) and the c2v
//     messages ([Dc][C], slot-major, so consecutive threads touch
//     consecutive checks). v2c is never stored: the check pass rebuilds
//     sign(marg - c2v) from the marginal and the old c2v. A word takes
//     Dc*C + 2V bytes (6 KB at LDPC(1200,3,6)).
//   - The index tables (the variable of each check slot; the slot-major
//     c2v index of each variable slot) are staged once per CTA into shared
//     memory as 16-bit, and the slot loops are unrolled over the graph's
//     degrees (exact for the (3,6)-regular codes and the irregular
//     1200-bit codes, masked up to kMaxD = 8 else). Each slot index is read
//     once per pass, and the new c2v go to the slots the row's own mask
//     marks real.
//   - Every check row and every variable is computed whole by one thread,
//     and the votes are exact AND / OR, so no output depends on G or W:
//     the wrapper picks them from the graph (ops/bec_kernel.py).
// max_iter is a run-time bound (2000 in converge mode).
// Tried on the H100 and not kept (scripts/profile_bp_kernel.py, PERF.md):
// several words of G > 1 warps per CTA on named barriers 1 + group (ptxas
// reserves all 16 barriers when the id is a register, so an SM then holds
// 4 CTAs; a tie with one word per CTA, within 1-4% either way),
// a packed row (two 8-bit slot masks, 2 bytes; its decode costs more
// instructions than the bytes it saves), the tables read through L1
// (__ldg), a static word assignment (word = group + k * groups).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 8;           // check-row slots
constexpr int kMaxCaps = 16;
constexpr int kMaxWords = 32;      // words per CTA: 1024 threads of one warp
constexpr int kMaxIndex = 32767;   // 16-bit table entries

struct Caps {
  int n;
  int at[kMaxCaps];  // ascending, at[n-1] == max_iter
};

// The threads of one word: `size` = 32 * G of them, thread `lane` of the
// group, group `id` of the CTA (a group of more than one warp is its CTA).
struct Group {
  int id, lane, size;

  __device__ void sync() const {
    if (size == 32) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
  // Barrier and vote in one: every thread of the group gets the AND (OR)
  // of `p` over the group.
  __device__ bool all(bool p) const {
    if (size == 32) {
      __syncwarp();
      return __all_sync(0xffffffffu, p);
    }
    return __syncthreads_and(p) != 0;
  }
  __device__ bool any(bool p) const {
    if (size == 32) {
      __syncwarp();
      return __any_sync(0xffffffffu, p);
    }
    return __syncthreads_or(p) != 0;
  }
};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }
__device__ __forceinline__ int to_sym(int s) {
  return s < 0 ? 0 : (s > 0 ? 1 : 2);
}
__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int table_bytes(int C, int V, int Dc, int Dv) {
  return align16(2 * (Dc * C + Dv * V));
}
__host__ __device__ constexpr int word_bytes(int C, int V, int Dc) {
  return align16(Dc * C + 2 * V);
}

// y [B, V] int32 symbols; chk_var [Dc][C]: variable of check slot (c, d),
// -1 if padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in
// the slot-major c2v, -1 if padded. Outputs x_out [K][B][V], it_out [B];
// next_word: the word counter, 0 at launch. kDc, kDv: the slot loops'
// bounds (Dc <= kDc, Dv <= kDv, or any Dv above kMaxD with kDv = kMaxD).
// kPlanes: K > 1, so the loop writes snapshot planes (a single-cap decode
// writes its one plane after the loop and skips the per-iteration test).
template <int kDc, int kDv, bool kPlanes>
__global__ void __launch_bounds__(1024)
    bec_decode_kernel(const int* __restrict__ y,
                      const int* __restrict__ chk_var,
                      const int* __restrict__ var_slot,
                      int* __restrict__ x_out, int* __restrict__ it_out,
                      int* __restrict__ next_word, int B, int C, int V,
                      int Dc, int Dv, int max_iter, Caps caps,
                      int group_size) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_next[kMaxWords];
  const Group grp{static_cast<int>(threadIdx.x) / group_size,
                  static_cast<int>(threadIdx.x) % group_size, group_size};

  short* t_chk = reinterpret_cast<short*>(smem);
  short* t_var = t_chk + Dc * C;
  for (int i = threadIdx.x; i < Dc * C; i += blockDim.x) t_chk[i] = chk_var[i];
  for (int i = threadIdx.x; i < Dv * V; i += blockDim.x) t_var[i] = var_slot[i];
  __syncthreads();  // the only CTA-wide barrier: tables staged

  signed char* s_c2v = reinterpret_cast<signed char*>(
      smem + table_bytes(C, V, Dc, Dv) + grp.id * word_bytes(C, V, Dc));
  signed char* s_prior = s_c2v + Dc * C;
  signed char* s_marg = s_prior + V;
  const size_t plane = static_cast<size_t>(B) * V;

  for (;;) {  // one word per turn
    if (grp.lane == 0) s_next[grp.id] = atomicAdd(next_word, 1);
    grp.sync();
    const int b = s_next[grp.id];
    if (b >= B) break;
    const int* y_b = y + static_cast<size_t>(b) * V;
    int* x_b = x_out + static_cast<size_t>(b) * V;

    int erased = 0;
    for (int v = grp.lane; v < V; v += grp.size) {
      const int sym = y_b[v];
      const int p = sym == 2 ? 0 : 2 * sym - 1;
      s_prior[v] = static_cast<signed char>(p);
      s_marg[v] = static_cast<signed char>(p);
      erased |= (p == 0);
    }
    for (int i = grp.lane; i < Dc * C; i += grp.size) s_c2v[i] = 0;
    bool done = !grp.any(erased);  // also: state initialised

    int it = 0;
    int kn = 0;  // next snapshot plane to write
    while (it < max_iter && !done) {
      // Check pass: v2c = sign(marg - c2v) per real slot, then the new c2v.
      for (int c = grp.lane; c < C; c += grp.size) {
        unsigned zero = 0u, pos = 0u, real = 0u;
#pragma unroll
        for (int d = 0; d < kDc; ++d) {
          const int v = (kDc == kMaxD && d >= Dc) ? -1 : t_chk[d * C + c];
          if (v >= 0) {
            const int m = static_cast<int>(s_marg[v]) - s_c2v[d * C + c];
            real |= 1u << d;
            zero |= static_cast<unsigned>(m == 0) << d;
            pos |= static_cast<unsigned>(m > 0) << d;
          }
        }
        // No unknown: echo every slot's sign. One: the parity of the ones
        // to the unknown slot, 0 to the others. More: all 0.
        const int unknowns = __popc(zero);
        const int parity = 2 * (__popc(pos) & 1) - 1;
#pragma unroll
        for (int d = 0; d < kDc; ++d) {
          if ((real >> d) & 1u) {
            int out = 0;
            if (unknowns == 0) {
              out = ((pos >> d) & 1u) ? 1 : -1;
            } else if (unknowns == 1 && ((zero >> d) & 1u)) {
              out = parity;
            }
            s_c2v[d * C + c] = static_cast<signed char>(out);
          }
        }
      }
      grp.sync();  // rows complete, marg no longer read

      // Variable pass: marg = prior + sum of c2v; compare the decisions.
      int same = 1;
      erased = 0;
      for (int v = grp.lane; v < V; v += grp.size) {
        int acc = s_prior[v];
#pragma unroll
        for (int s = 0; s < kDv; ++s) {
          const int f = (kDv == kMaxD && s >= Dv) ? -1 : t_var[s * V + v];
          if (f >= 0) acc += s_c2v[f];
        }
        for (int s = kMaxD; kDv == kMaxD && s < Dv; ++s) {
          const int f = t_var[s * V + v];
          if (f >= 0) acc += s_c2v[f];
        }
        const int xs = sgn(acc);
        same &= (xs == sgn(s_marg[v]));
        erased |= (xs == 0);
        s_marg[v] = static_cast<signed char>(acc);
      }
      ++it;
      // Snapshot: each thread reads back the marginals it has just written.
      if (kPlanes && it == caps.at[kn]) {
        int* x_k = x_b + kn * plane;
        for (int v = grp.lane; v < V; v += grp.size) {
          x_k[v] = to_sym(sgn(s_marg[v]));
        }
        ++kn;
      }
      // Votes: the first is also the barrier that completes marg.
      const bool stopped = grp.all(same);
      const bool left = grp.any(erased);
      done = stopped || !left;
    }

    // Planes the loop never reached hold the final state.
    for (int k = kn; k < caps.n; ++k) {
      int* x_k = x_b + k * plane;
      for (int v = grp.lane; v < V; v += grp.size) {
        x_k[v] = to_sym(sgn(s_marg[v]));
      }
    }
    if (grp.lane == 0) it_out[b] = it;
  }
}

using KernelFn = void (*)(const int*, const int*, const int*, int*, int*,
                          int*, int, int, int, int, int, int, Caps, int);

template <bool kPlanes>
KernelFn pick_degrees(int Dc, int Dv) {
  if (Dc == 6 && Dv == 3) return bec_decode_kernel<6, 3, kPlanes>;
  if (Dc == 6 && Dv == 8) return bec_decode_kernel<6, 8, kPlanes>;
  return bec_decode_kernel<kMaxD, kMaxD, kPlanes>;
}

// The instantiation for a graph and a cap list: exact slot loops for the
// (3,6)-regular codes and the irregular 1200-bit codes, masked loops over
// kMaxD else; the snapshot test only where there are planes to write.
KernelFn pick(int Dc, int Dv, int n_caps) {
  return n_caps > 1 ? pick_degrees<true>(Dc, Dv) : pick_degrees<false>(Dc, Dv);
}

// The launch's shape, or an error where the card or the kernel cannot take
// it.
cudaError_t plan(KernelFn kernel, int C, int V, int Dc, int Dv,
                 int group_warps, int words, int* threads, int* smem,
                 int* ctas_per_sm) {
  const bool g_ok = group_warps == 1 || group_warps == 2 ||
                    group_warps == 4 || group_warps == 8;
  if (!g_ok || words < 1 || words > kMaxWords ||
      32 * group_warps * words > 1024 || (group_warps > 1 && words > 1) ||
      Dc < 1 || Dc > kMaxD ||
      Dv < 1 || Dv > 126 || V > kMaxIndex || Dc * C > kMaxIndex) {
    return cudaErrorInvalidValue;
  }
  *threads = 32 * group_warps * words;
  *smem = table_bytes(C, V, Dc, Dv) + words * word_bytes(C, V, Dc);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  if (e != cudaSuccess) return e;
  if (*smem > optin) return cudaErrorInvalidConfiguration;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                    *threads, *smem);
  if (e != cudaSuccess) return e;
  return *ctas_per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// CTAs an SM holds at this geometry (> 0), or minus the error.
extern "C" int bec_decode_occupancy(int C, int V, int Dc, int Dv,
                                    int group_warps, int words) {
  int threads = 0, smem = 0, ctas = 0;
  const cudaError_t e = plan(pick(Dc, Dv, 1), C, V, Dc, Dv, group_warps,
                             words, &threads, &smem, &ctas);
  return e == cudaSuccess ? ctas : -static_cast<int>(e);
}

extern "C" int bec_decode_launch(const void* y, const void* chk_var,
                                 const void* var_slot, void* x_out,
                                 void* it_out, void* next_word, int B, int C,
                                 int V, int Dc, int Dv, int max_iter,
                                 const int* caps, int n_caps, int group_warps,
                                 int words, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n_caps < 1 || n_caps > kMaxCaps || caps[n_caps - 1] != max_iter) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Caps cp;
  cp.n = n_caps;
  for (int k = 0; k < kMaxCaps; ++k) cp.at[k] = k < n_caps ? caps[k] : -1;
  const KernelFn kernel = pick(Dc, Dv, n_caps);
  int threads = 0, smem = 0, ctas_per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = plan(kernel, C, V, Dc, Dv, group_warps, words, &threads,
                       &smem, &ctas_per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int fill = ctas_per_sm * sms, need = (B + words - 1) / words;
  kernel<<<fill < need ? fill : need, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y), static_cast<const int*>(chk_var),
      static_cast<const int*>(var_slot), static_cast<int*>(x_out),
      static_cast<int*>(it_out), static_cast<int*>(next_word), B, C, V, Dc,
      Dv, max_iter, cp, 32 * group_warps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bec_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
