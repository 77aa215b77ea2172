// Whole-loop min-sum belief propagation: G warps per LDPC codeword, W
// words per CTA, on a persistent grid.
//
// Replaces ldpc_decoders_tpu/ops/pallas_bp.py:_kernel (reached through
// msa_decode_pallas -> _launch_bp -> pl.pallas_call). It computes what
// that kernel computes, decision for decision:
//   - check node: leave-one-out two-min with argmin (strict `<` walking the
//     slots from 0 up, so the first minimal slot wins and a tie gives
//     min2 == min1), times the parity of the OTHER slots' `p < 0` (-0.0 is
//     not negative); min1/min2 start at the 1e30 degree-1 guard;
//   - variable node: marg = llr + (sum of c2v over the variable's slots,
//     in slot order), the prior added last;
//   - v2c = msg(f32(msg(marg)) - c2v): in bf16 the marginal is rounded to
//     bf16 BEFORE the subtraction (pallas_bp.py:427-428), with
//     round-to-nearest-even (__float2bfloat16_rn, like astype);
//   - the first v2c is msg(llr) (pallas_bp.py:357-358);
//   - x_hat = marg < 0, the syndrome (an XOR per check) is tested on the
//     updated x_hat after every iteration, a word whose syndrome passes is
//     frozen, and `iters` counts its active iterations.
// A frozen word's threads leave its loop: that is result-identical to the
// Pallas block loop (_bounded_loop), whose body is a no-op for finished
// words. Snapshot planes (the TPU kernel's caps=, _snap_write /
// _snap_fill): x_out is [K][B][V]; plane k holds the decisions after
// caps[k] iterations, or the final ones where the word finished earlier. A
// single-cap decode is K = 1 with caps = {max_iter}.
//
// What bounds it on the card: latency and instruction issue in the two
// passes, not device memory (V*4 bytes in, K*V*4 out per word) nor
// arithmetic (scripts/profile_bp_kernel.py on an H100: thread 0 of the
// kernel it replaces spent 64-74% of its loop in the check pass and 2-7%
// at its barriers). That kernel gave each word a CTA of 256 threads (8
// words per SM), run-time slot loops that read each index from L1 twice
// per check slot, and 78% of its lanes busy in the check pass.
//
// Design (shared with csrc/bec_decode.cu).
//   - A word per group of G warps (G in {1, 2, 4, 8}): W words of one
//     warp per CTA, syncing and voting with __syncwarp and __all_sync /
//     __any_sync, or one word of G > 1 warps per CTA, on the CTA's own
//     barrier (__syncthreads_and / _or). Either way a word's barrier waits
//     for no other word.
//   - A persistent grid: as many CTAs as the card holds
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); a group takes
//     its next word from a device counter (atomicAdd, zeroed by the wrapper
//     per launch) as soon as its word is done, in the same slice of shared
//     memory. Outputs are indexed by word, so the order is invisible.
//   - A word's state in shared memory: the marginals ([V], 32 bits each)
//     and the c2v messages ([Dc][C], message type, slot-major so
//     consecutive threads touch consecutive checks); 12 KB in bf16 and
//     19.2 KB in f32 at LDPC(1200,3,6). With bf16 messages a marginal's
//     word holds msg(marg) in its top half and marg < 0 (of the float32
//     marginal) in bit 0, so the check pass reads both without rounding
//     per edge; a row rounds its min1 and min2 once and flips sign bits
//     (round-to-nearest is symmetric). The LLRs are re-read from device
//     memory (L1/L2) in the variable pass. v2c is never stored: the check
//     pass rebuilds each one from marg and the old c2v, and folds the
//     syndrome of x_hat = marg < 0 into the same pass for the group's vote.
//   - Slot loops unrolled over the graph's degrees (exact for the
//     (3,6)-regular codes and the irregular 1200-bit codes, masked up to
//     kMaxD = 8 else); each slot index is read once per pass, through L1,
//     and the new c2v go to the slots the row's own mask marks real.
//   - Every check row and every variable is computed whole by one thread,
//     in the same slot order as the plain version, so no output depends on
//     G or W: the wrapper picks them from the graph (ops/msa_kernel.py).
// Tried on the H100 and not kept (scripts/profile_bp_kernel.py, PERF.md):
// several words of G > 1 warps per CTA on named barriers 1 + group (ptxas
// reserves all 16 barriers when the id is a register, so an SM then holds
// 4 CTAs; a tie with one word per CTA, within 1-4% either way),
// a check row packed as min1, min2, argmin and sign bits (8 / 16 bytes,
// exact; more words per SM, but its decode costs more instructions than
// the bytes save), 16-bit index tables staged in shared memory, the LLRs
// in shared memory, a static word assignment (word = group + k * groups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kDeg1Guard = 1e30f;  // only a degree-1 check keeps it
constexpr int kMaxD = 8;            // check-row slots
constexpr int kMaxCaps = 16;
constexpr int kMaxWords = 32;       // words per CTA: 1024 threads of one warp

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
  // Barrier and vote in one: every thread of the group gets the OR of `p`
  // over the group.
  __device__ bool any(bool p) const {
    if (size == 32) {
      __syncwarp();
      return __any_sync(0xffffffffu, p);
    }
    return __syncthreads_or(p) != 0;
  }
};

// A message type's roundings, and how the kernel keeps its state in shared
// memory: a message as its raw bits (`Bits`), a marginal as a 32-bit word
// from which the check pass reads both msg(marg) and marg < 0 (`mark`).
template <typename T>
struct Msg;

template <>
struct Msg<float> {
  using Bits = unsigned;
  static constexpr Bits kSign = 0x80000000u;
  __device__ static float round(float v) { return v; }
  __device__ static float load(Bits b) { return __uint_as_float(b); }
  __device__ static Bits store(float v) { return __float_as_uint(v); }
  __device__ static unsigned mark(float marg) { return __float_as_uint(marg); }
  __device__ static float rounded(unsigned w) { return __uint_as_float(w); }
  __device__ static bool negative(unsigned w) {
    return __uint_as_float(w) < 0.f;
  }
};

// bf16: msg(marg) in the top half of the word (round-to-nearest-even, as
// astype), marg < 0 of the float32 marginal in bit 0.
template <>
struct Msg<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr Bits kSign = 0x8000u;
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float load(Bits b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  __device__ static Bits store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static unsigned mark(float marg) {
    return (static_cast<unsigned>(store(marg)) << 16) |
           static_cast<unsigned>(marg < 0.f);
  }
  __device__ static float rounded(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ static bool negative(unsigned w) { return w & 1u; }
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
template <typename MsgT>
__host__ __device__ constexpr int word_bytes(int C, int V, int Dc) {
  return align16(4 * V) +
         align16(Dc * C * static_cast<int>(sizeof(typename Msg<MsgT>::Bits)));
}

// llr [B, V] f32; chk_var [Dc][C]: variable of check slot (c, d), -1 if
// padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in the
// slot-major c2v, -1 if padded. Outputs x_out [K][B][V] int32, it_out [B];
// next_word: the word counter, 0 at launch. kDc, kDv: the slot loops'
// bounds (Dc <= kDc, Dv <= kDv, or any Dv above kMaxD with kDv = kMaxD).
// kPlanes: K > 1, so the loop writes snapshot planes (a single-cap decode
// writes its one plane after the loop and skips the per-iteration test).
template <typename MsgT, int kDc, int kDv, bool kPlanes>
__global__ void __launch_bounds__(1024)
    msa_decode_kernel(const float* __restrict__ llr,
                      const int* __restrict__ chk_var,
                      const int* __restrict__ var_slot,
                      int* __restrict__ x_out, int* __restrict__ it_out,
                      int* __restrict__ next_word, int B, int C, int V,
                      int Dc, int Dv, int max_iter, int check_init, Caps caps,
                      int group_size) {
  using M = Msg<MsgT>;
  using Bits = typename M::Bits;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_next[kMaxWords];
  const Group grp{static_cast<int>(threadIdx.x) / group_size,
                  static_cast<int>(threadIdx.x) % group_size, group_size};
  unsigned char* mine = smem + grp.id * word_bytes<MsgT>(C, V, Dc);
  unsigned* s_marg = reinterpret_cast<unsigned*>(mine);
  Bits* s_c2v = reinterpret_cast<Bits*>(mine + align16(4 * V));
  const size_t plane = static_cast<size_t>(B) * V;

  for (;;) {  // one word per turn
    if (grp.lane == 0) s_next[grp.id] = atomicAdd(next_word, 1);
    grp.sync();
    const int b = s_next[grp.id];
    if (b >= B) break;
    const float* llr_b = llr + static_cast<size_t>(b) * V;
    int* x_b = x_out + static_cast<size_t>(b) * V;

    // With c2v = 0 the first check pass sees v2c = msg(llr).
    for (int v = grp.lane; v < V; v += grp.size) {
      s_marg[v] = M::mark(llr_b[v]);
    }
    for (int i = grp.lane; i < Dc * C; i += grp.size) s_c2v[i] = M::store(0.f);
    grp.sync();

    int it = 0;
    int kn = 0;  // next snapshot plane to write
    while (it < max_iter) {
      // Check pass: syndrome of x_hat = (marg < 0), and the new c2v.
      int unsat = 0;
      for (int c = grp.lane; c < C; c += grp.size) {
        float m1 = kDeg1Guard, m2 = kDeg1Guard;
        int am = 0, par = 0;
        unsigned neg = 0u, real = 0u;
#pragma unroll
        for (int d = 0; d < kDc; ++d) {
          const int v =
              (kDc == kMaxD && d >= Dc) ? -1 : __ldg(chk_var + d * C + c);
          if (v >= 0) {
            const unsigned mg = s_marg[v];
            par ^= M::negative(mg);
            const float p =
                M::round(M::rounded(mg) - M::load(s_c2v[d * C + c]));
            const float mag = fabsf(p);
            const bool lt = mag < m1;
            m2 = lt ? m1 : fminf(m2, mag);
            m1 = lt ? mag : m1;
            am = lt ? d : am;
            real |= 1u << d;
            neg |= static_cast<unsigned>(p < 0.f) << d;
          }
        }
        unsat |= par;
        // msg(-x) is msg(x) with its sign bit flipped (round-to-nearest is
        // symmetric), so each row rounds its two magnitudes once.
        const unsigned odd = __popc(neg) & 1u;
        const Bits e1 = M::store(m1), e2 = M::store(m2);
#pragma unroll
        for (int d = 0; d < kDc; ++d) {
          if ((real >> d) & 1u) {
            const Bits ext = (d == am) ? e2 : e1;
            const bool flip = (odd ^ (neg >> d)) & 1u;
            s_c2v[d * C + c] = flip ? static_cast<Bits>(ext ^ M::kSign) : ext;
          }
        }
      }
      // Barrier: c2v complete, marg no longer read. The vote is uniform.
      const bool unsat_any = grp.any(unsat);
      if (!unsat_any && (it > 0 || check_init)) break;

      // Variable pass: marg = llr + (c2v summed in slot order).
      for (int v = grp.lane; v < V; v += grp.size) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kDv; ++s) {
          const int f =
              (kDv == kMaxD && s >= Dv) ? -1 : __ldg(var_slot + s * V + v);
          if (f >= 0) acc += M::load(s_c2v[f]);
        }
        for (int s = kMaxD; kDv == kMaxD && s < Dv; ++s) {
          const int f = __ldg(var_slot + s * V + v);
          if (f >= 0) acc += M::load(s_c2v[f]);
        }
        s_marg[v] = M::mark(__ldg(llr_b + v) + acc);
      }
      ++it;
      // Snapshot: each thread reads back the marginals it has just written.
      if (kPlanes && it == caps.at[kn]) {
        int* x_k = x_b + kn * plane;
        for (int v = grp.lane; v < V; v += grp.size) {
          x_k[v] = M::negative(s_marg[v]) ? 1 : 0;
        }
        ++kn;
      }
      grp.sync();  // marg complete
    }

    // Planes the loop never reached hold the final decisions.
    for (int k = kn; k < caps.n; ++k) {
      int* x_k = x_b + k * plane;
      for (int v = grp.lane; v < V; v += grp.size) {
        x_k[v] = M::negative(s_marg[v]) ? 1 : 0;
      }
    }
    if (grp.lane == 0) it_out[b] = it;
  }
}

using KernelFn = void (*)(const float*, const int*, const int*, int*, int*,
                          int*, int, int, int, int, int, int, int, Caps, int);

template <typename MsgT, bool kPlanes>
KernelFn pick_degrees(int Dc, int Dv) {
  if (Dc == 6 && Dv == 3) return msa_decode_kernel<MsgT, 6, 3, kPlanes>;
  if (Dc == 6 && Dv == 8) return msa_decode_kernel<MsgT, 6, 8, kPlanes>;
  return msa_decode_kernel<MsgT, kMaxD, kMaxD, kPlanes>;
}

// The instantiation for a graph and a cap list: exact slot loops for the
// (3,6)-regular codes and the irregular 1200-bit codes, masked loops over
// kMaxD else; the snapshot test only where there are planes to write.
template <typename MsgT>
KernelFn pick(int Dc, int Dv, int n_caps) {
  return n_caps > 1 ? pick_degrees<MsgT, true>(Dc, Dv)
                    : pick_degrees<MsgT, false>(Dc, Dv);
}

// The launch's shape, or an error where the card or the kernel cannot take
// it.
template <typename MsgT>
cudaError_t plan(KernelFn kernel, int C, int V, int Dc, int Dv,
                 int group_warps, int words, int* threads, int* smem,
                 int* ctas_per_sm) {
  const bool g_ok = group_warps == 1 || group_warps == 2 ||
                    group_warps == 4 || group_warps == 8;
  if (!g_ok || words < 1 || words > kMaxWords ||
      32 * group_warps * words > 1024 || (group_warps > 1 && words > 1) ||
      Dc < 1 || Dc > kMaxD ||
      Dv < 1) {
    return cudaErrorInvalidValue;
  }
  *threads = 32 * group_warps * words;
  *smem = words * word_bytes<MsgT>(C, V, Dc);
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

template <typename MsgT>
cudaError_t launch(const float* llr, const int* chk_var, const int* var_slot,
                   int* x_out, int* it_out, int* next_word, int B, int C,
                   int V, int Dc, int Dv, int max_iter, int check_init,
                   const Caps& caps, int group_warps, int words,
                   cudaStream_t stream) {
  const KernelFn kernel = pick<MsgT>(Dc, Dv, caps.n);
  int threads = 0, smem = 0, ctas_per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = plan<MsgT>(kernel, C, V, Dc, Dv, group_warps, words,
                             &threads, &smem, &ctas_per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const int fill = ctas_per_sm * sms, need = (B + words - 1) / words;
  kernel<<<fill < need ? fill : need, threads, smem, stream>>>(
      llr, chk_var, var_slot, x_out, it_out, next_word, B, C, V, Dc, Dv,
      max_iter, check_init, caps, 32 * group_warps);
  return cudaGetLastError();
}

}  // namespace

// CTAs an SM holds at this geometry (> 0), or minus the error.
extern "C" int msa_decode_occupancy(int C, int V, int Dc, int Dv, int bf16,
                                    int group_warps, int words) {
  int threads = 0, smem = 0, ctas = 0;
  const cudaError_t e =
      bf16 ? plan<__nv_bfloat16>(pick<__nv_bfloat16>(Dc, Dv, 1), C, V, Dc,
                                 Dv, group_warps, words, &threads, &smem,
                                 &ctas)
           : plan<float>(pick<float>(Dc, Dv, 1), C, V, Dc, Dv, group_warps,
                         words, &threads, &smem, &ctas);
  return e == cudaSuccess ? ctas : -static_cast<int>(e);
}

extern "C" int msa_decode_launch(const void* llr, const void* chk_var,
                                 const void* var_slot, void* x_out,
                                 void* it_out, void* next_word, int B, int C,
                                 int V, int Dc, int Dv, int max_iter,
                                 int check_init, int bf16, const int* caps,
                                 int n_caps, int group_warps, int words,
                                 void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n_caps < 1 || n_caps > kMaxCaps || caps[n_caps - 1] != max_iter) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Caps cp;
  cp.n = n_caps;
  for (int k = 0; k < kMaxCaps; ++k) cp.at[k] = k < n_caps ? caps[k] : -1;
  const auto* l = static_cast<const float*>(llr);
  const auto* cv = static_cast<const int*>(chk_var);
  const auto* vs = static_cast<const int*>(var_slot);
  auto* x = static_cast<int*>(x_out);
  auto* it = static_cast<int*>(it_out);
  auto* nw = static_cast<int*>(next_word);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(l, cv, vs, x, it, nw, B, C, V, Dc, Dv,
                                   max_iter, check_init, cp, group_warps,
                                   words, s)
           : launch<float>(l, cv, vs, x, it, nw, B, C, V, Dc, Dv, max_iter,
                           check_init, cp, group_warps, words, s);
  return static_cast<int>(e);
}

extern "C" const char* msa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
