// Whole-loop sum-product (SPA) belief propagation for one LDPC codeword
// per CTA, under either inf policy.
//
// Replaces two TPU kernels of ldpc_decoders_tpu/ops/pallas_bp.py (both
// reached through _launch_bp -> pl.pallas_call):
//   - _spa_kernel (spa_decode_pallas), inf_policy "saturate": kRef = false;
//   - _spa_ref_kernel (spa_ref_decode_pallas), inf_policy "reference", the
//     reference decoder's float64 inf/NaN cascade, sentinel-encoded
//     (+-inf = +-1e9, NaN = 2e9): kRef = true.
// It computes what those kernels compute, decision for decision:
//   - check node in the phi domain: ph = phi(clip(|p|, PHI_EPS, LLR_CLIP))
//     per slot, the leave-one-out sum as prefix + suffix, both folded from
//     0 one slot at a time (prefix from slot 0 up, suffix from the last
//     slot down, pallas_bp.py:750-757), c2v = phi(max(excl, PHI_EPS)) times
//     the parity of the other slots' signs;
//   - kRef adds the sentinel classes (decoders/bp.py:spa_check_rows_ref):
//     +-inf classes and finite |p| >= 38 are "saturated" and contribute
//     ph = 0; an output whose every leave-one-out factor is saturated is
//     sgn * INF_S, counted against the check's REAL degree (so padded
//     irregular rows work; the Pallas kernel assumes a regular Dc); a
//     NaN-class input poisons its whole row with NAN_S;
//   - variable node: marg = llr + (sum over the variable's slots, in slot
//     order, of msg(c2v)), the prior added last. kRef sums msg(finite part)
//     and counts the +inf/-inf/NaN classes as integers (no base-8 packing:
//     the IREG codes have variable degree 8); the marginal's class rules
//     (pallas_bp.py:1073-1081) then encode it, and x_hat = marg < 0, so a
//     NaN marginal decides bit 0;
//   - the c2v messages stay float32 (pallas_bp.py:762-768, 1091): in bf16
//     they are rounded to bf16 only where they enter the marginal sum;
//     v2c = msg(msg(marg) - c2v) (saturate) or the em_p/em_n/em_nan
//     sentinel rules on msg(marg) and c2v (reference, :1086-1096);
//   - the first v2c is msg(llr): with c2v = 0 and marg = llr the general
//     rule gives exactly that (an |llr| beyond the sentinel bands falls in
//     the same class either way);
//   - the syndrome of x_hat is tested after every iteration (check_init
//     adds a test before the first); a word whose syndrome passes is
//     frozen: its CTA leaves the loop, and `iters` counts its iterations;
//   - snapshot planes (the TPU kernels' caps=, _snap_write / _snap_fill):
//     x_out is [K][B][V]; plane k holds the decisions after caps[k]
//     iterations, or the final ones where the word finished earlier, by
//     the same rule as the final output (marg < 0 on the encoded marginal,
//     so a NaN marginal decides bit 0 in a snapshot too). A single-cap
//     decode is K = 1 with caps = {max_iter}. A snapshot is a pass of its
//     own after the variable pass; a thread reads back exactly the
//     marginals it has just written: no extra barrier.
//
// Bit-equality with the plain PyTorch version (ops/spa_kernel.py) on the
// card: phi uses expf, log1pf and logf from the CUDA math library, IEEE
// division and no FMA contraction (__fmul_rn / __fdiv_rn / __fadd_rn), in
// the same order as the plain version's torch ops.
//
// The input phi of bf16 messages is a table. A v2c message is rounded to
// bf16, so its clipped magnitude cl is either PHI_EPS or one of the 7,560
// bf16 numbers 0x2491..0x4218 (bit patterns of the top half of a float32)
// in (PHI_EPS, 38]. spa_phi_table_fill computes phi on exactly those
// 7,561 inputs with the same __device__ phi, so a lookup is bit-equal to
// the call by construction. Entry i holds phi of the float32 whose top 16
// bits are kTabFirst + i and whose low 16 bits are 0, except entry 0,
// which holds phi(PHI_EPS): PHI_EPS's own top bits are kTabFirst, so the
// index (bits(cl) >> 16) - kTabFirst needs no branch. f32 messages take
// any float32 magnitude and keep calling phi.
//
// Design. Each CTA keeps its word's state in shared memory for the whole
// loop: priors and (encoded) marginals, [V] f32 each, and c2v, [Dc][C]
// f32, slot-major (~24 KB at LDPC(1200,3,6), ~52.8 KB at margulis, which
// needs the > 48 KB opt-in). v2c is never stored: the check pass rebuilds
// it from the marginal and the old c2v. One thread owns a check: it keeps
// the row's ph and prefix sums in registers (kMaxD, a compile-time bound
// on Dc, so the unrolled arrays stay in registers; wider rows are
// refused), writes the new c2v, and folds the row's parity into the CTA's
// exit vote (__syncthreads_or). Each row is owned by one thread, each
// variable sums its slots in slot order and the vote is an exact OR, so
// no output depends on the number of threads: the wrapper sets it from
// the graph (ops/spa_kernel.py:spa_geometry).
// Edge tables and the phi table are shared by all CTAs and stay in L1/L2.
//
// What bounds it on the card (scripts/profile_spa_kernel.py on an H100):
// the check pass's arithmetic, not device memory. With bf16 messages the
// input phi is a lookup (~3% of an iteration at thread 0); the output phi,
// Dc per row, takes about a third: both of phi's forms are inlined (exp:
// expf and two log1pf; series: logf and two IEEE divisions), logf and
// log1pf are polynomials on the FMA pipe (the SASS holds one MUFU.EX2 and
// one MUFU.RCP per inlined phi, so the SFU is not what bounds it), and at
// ~90% of the calls a warp's lanes fall on both sides of 0.1 and run both
// forms. The rest of the check pass (index loads, gathers, bf16 roundings,
// sentinel classes) takes ~35-40% and the variable pass ~20%; the vote
// barrier 2-4%. Not kept, measured slower: a warp that lists its outputs
// by form and runs each list 32 at a time (the lists cost more than the
// second form), a copy of the phi table in shared memory per word (fewer
// words per SM), and template flags that drop the padding tests on graphs
// without padded slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Bit-exact float32 values of the Python constants (ops/spa_kernel.py).
constexpr float kPhiEps = 0x1.212718p-54f;  // float32(6.27e-17)
constexpr float kLlrClip = 38.0f;
constexpr float kPhiSmall = 0x1.99999ap-4f;  // float32(0.1)
constexpr float kInfS = 1e9f;
constexpr float kNanS = 2e9f;
constexpr float kInfMin = 5e8f;
constexpr float kNanMin = 1.5e9f;
// Widest check row a thread keeps in registers (the codes of the
// repository have check degree <= 6).
constexpr int kMaxD = 8;
constexpr int kMaxCaps = 16;
// The bf16 phi table: top 16 bits of float32(PHI_EPS) (entry 0) up to
// those of 38.0f.
constexpr unsigned kTabFirst = 0x2490u;
constexpr unsigned kTabLast = 0x4218u;
constexpr int kTabSize = static_cast<int>(kTabLast - kTabFirst) + 1;  // 7561

struct Caps {
  int n;
  int at[kMaxCaps];  // ascending, at[n-1] == max_iter
};

template <typename T>
struct Msg;

template <>
struct Msg<float> {
  __device__ static float round(float v) { return v; }
};

template <>
struct Msg<__nv_bfloat16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Gallager phi(x) = -log(tanh(x/2)): the series log(2/x) + x*x/12 below
// 0.1, log1p(exp(-x)) - log1p(-exp(-x)) above (decoders/bp.py:phi).
__device__ __forceinline__ float phi(float x) {
  if (x < kPhiSmall) {
    return __fadd_rn(logf(__fdiv_rn(2.0f, x)),
                     __fdiv_rn(__fmul_rn(x, x), 12.0f));
  }
  const float ex = expf(-x);
  return __fsub_rn(log1pf(ex), log1pf(-ex));
}

// The input of table entry i (the module note above).
__device__ __forceinline__ float tab_input(int i) {
  return i == 0 ? kPhiEps : __uint_as_float((kTabFirst + i) << 16);
}

// The input phi of a clipped bf16 magnitude cl, read from the table.
__device__ __forceinline__ float tab_at(const float* tab, float cl) {
  return __ldg(tab + ((__float_as_uint(cl) >> 16) - kTabFirst));
}

__global__ void phi_table_kernel(float* __restrict__ tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kTabSize) tab[i] = phi(tab_input(i));
}

__device__ __forceinline__ bool nan_class(float v) { return v > kNanMin; }
__device__ __forceinline__ bool pinf_class(float v) {
  return v > kInfMin && v <= kNanMin;
}
__device__ __forceinline__ bool ninf_class(float v) { return v < -kInfMin; }

// v2c of one edge from the (encoded) marginal of its variable and the
// edge's current c2v (f32).
template <typename MsgT, bool kRef>
__device__ __forceinline__ float rebuild_v2c(float marg, float c2v) {
  const float ed = Msg<MsgT>::round(marg);
  if (!kRef) return Msg<MsgT>::round(__fsub_rn(ed, c2v));
  const bool cn = nan_class(c2v), cp = pinf_class(c2v), cm = ninf_class(c2v);
  const float finv = (cn || cp || cm) ? 0.f : c2v;
  float nv = __fsub_rn(ed, finv);
  if (pinf_class(ed)) nv = cp ? kNanS : kInfS;
  if (ninf_class(ed)) nv = cm ? kNanS : -kInfS;
  if (nan_class(ed)) nv = kNanS;
  return Msg<MsgT>::round(nv);
}

// llr [B, V] f32; chk_var [Dc][C]: variable of check slot (c, d), -1 if
// padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in the
// slot-major c2v, -1 if padded; phi_tab [kTabSize] (bf16 only). Outputs
// x_out [K][B][V] int32, it_out [B].
template <typename MsgT, bool kRef>
__global__ void spa_decode_kernel(const float* __restrict__ llr,
                                  const int* __restrict__ chk_var,
                                  const int* __restrict__ var_slot,
                                  const float* __restrict__ phi_tab,
                                  int* __restrict__ x_out,
                                  int* __restrict__ it_out, int B, int C,
                                  int V, int Dc, int Dv, int max_iter,
                                  int check_init, Caps caps) {
  constexpr bool kTab = std::is_same<MsgT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_llr = reinterpret_cast<float*>(smem);
  float* s_marg = s_llr + V;  // kRef: the class-encoded marginal
  float* s_c2v = s_marg + V;

  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(B) * V;
  const float* llr_b = llr + static_cast<size_t>(b) * V;
  int* x_b = x_out + static_cast<size_t>(b) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float l = llr_b[v];
    s_llr[v] = l;
    s_marg[v] = l;  // with c2v = 0 the first check pass sees v2c = msg(llr)
  }
  for (int i = threadIdx.x; i < Dc * C; i += blockDim.x) s_c2v[i] = 0.f;
  __syncthreads();

  int it = 0;
  int kn = 0;  // next snapshot plane to write
  while (it < max_iter) {
    // Check pass: syndrome of x_hat = (marg < 0), and the new c2v.
    int unsat = 0;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float ph[kMaxD], pre[kMaxD];
      unsigned real = 0u, neg = 0u, sat = 0u;
      bool nan_row = false;
      int par = 0;
      float run = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        ph[d] = 0.f;
        pre[d] = run;  // sum of ph over the slots before d
        if (d < Dc) {
          const int v = __ldg(chk_var + d * C + c);
          if (v >= 0) {
            real |= 1u << d;
            const float mg = s_marg[v];
            par ^= (mg < 0.f);
            const float p = rebuild_v2c<MsgT, kRef>(mg, s_c2v[d * C + c]);
            const float mag = fabsf(p);
            const float cl = fminf(fmaxf(mag, kPhiEps), kLlrClip);
            if (kRef) {
              const bool nn = nan_class(p), pi = pinf_class(p),
                         ni = ninf_class(p);
              const bool fin = !(nn || pi || ni);
              nan_row |= nn;
              if (pi || ni || mag >= kLlrClip) sat |= 1u << d;
              if (kTab) {
                const float t = tab_at(phi_tab, cl);
                ph[d] = (fin && mag < kLlrClip) ? t : 0.f;
              } else if (fin && mag < kLlrClip) {
                ph[d] = phi(cl);
              }
              if ((fin && p < 0.f) || ni) neg |= 1u << d;
            } else {
              ph[d] = kTab ? tab_at(phi_tab, cl) : phi(cl);
              if (p < 0.f) neg |= 1u << d;
            }
          }
          run = __fadd_rn(run, ph[d]);
        }
      }
      unsat |= par;
      const int nneg = __popc(neg), nsat = __popc(sat), deg = __popc(real);
      float suf = 0.f;  // sum of ph over the slots after d, last slot first
#pragma unroll
      for (int d = kMaxD - 1; d >= 0; --d) {
        if (d < Dc) {
          if ((real >> d) & 1u) {
            const float excl = __fadd_rn(pre[d], suf);
            const bool flip = (nneg - static_cast<int>((neg >> d) & 1u)) & 1;
            const float ext = phi(fmaxf(excl, kPhiEps));
            float out = flip ? -ext : ext;
            if (kRef) {
              if (nsat - static_cast<int>((sat >> d) & 1u) == deg - 1) {
                out = flip ? -kInfS : kInfS;
              }
              if (nan_row) out = kNanS;
            }
            s_c2v[d * C + c] = out;
          }
          suf = __fadd_rn(suf, ph[d]);
        }
      }
    }
    // Barrier: c2v complete, marg no longer read. The vote is uniform.
    if (!__syncthreads_or(unsat) && (it > 0 || check_init)) break;

    // Variable pass: marg = llr + (msg(c2v) summed in slot order).
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      float acc = 0.f;
      int n_p = 0, n_n = 0;
      for (int s = 0; s < Dv; ++s) {
        const int f = __ldg(var_slot + s * V + v);
        if (f < 0) continue;
        const float m = s_c2v[f];
        if (kRef) {
          const bool cn = nan_class(m), cp = pinf_class(m), cm = ninf_class(m);
          n_p += (cp || cn);
          n_n += (cm || cn);
          acc = __fadd_rn(acc, Msg<MsgT>::round((cn || cp || cm) ? 0.f : m));
        } else {
          acc = __fadd_rn(acc, Msg<MsgT>::round(m));
        }
      }
      float marg = __fadd_rn(s_llr[v], acc);
      if (kRef) {
        if (n_p > 0 && n_n > 0) {
          marg = kNanS;
        } else if (n_p > 0) {
          marg = kInfS;
        } else if (n_n > 0) {
          marg = -kInfS;
        }
      }
      s_marg[v] = marg;
    }
    ++it;
    if (it == caps.at[kn]) {
      int* x_k = x_b + kn * plane;
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        x_k[v] = s_marg[v] < 0.f ? 1 : 0;
      }
      ++kn;
    }
    __syncthreads();
  }

  // Planes the loop never reached hold the final decisions.
  for (int k = kn; k < caps.n; ++k) {
    int* x_k = x_b + k * plane;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      x_k[v] = s_marg[v] < 0.f ? 1 : 0;
    }
  }
  if (threadIdx.x == 0) it_out[b] = it;
}

template <typename MsgT, bool kRef>
cudaError_t launch(const float* llr, const int* chk_var, const int* var_slot,
                   const float* phi_tab, int* x_out, int* it_out, int B,
                   int C, int V, int Dc, int Dv, int max_iter, int check_init,
                   const Caps& caps, int threads, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(V) +
                       static_cast<size_t>(Dc) * C) * sizeof(float);
  auto kernel = spa_decode_kernel<MsgT, kRef>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, stream>>>(llr, chk_var, var_slot, phi_tab, x_out,
                                       it_out, B, C, V, Dc, Dv, max_iter,
                                       check_init, caps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spa_phi_table_size() { return kTabSize; }

// Fills phi_tab [kTabSize] f32 on the given stream.
extern "C" int spa_phi_table_fill(void* phi_tab, void* stream) {
  constexpr int kThreads = 256;
  phi_table_kernel<<<(kTabSize + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(phi_tab));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spa_decode_launch(const void* llr, const void* chk_var,
                                 const void* var_slot, const void* phi_tab,
                                 void* x_out, void* it_out, int B, int C,
                                 int V, int Dc, int Dv, int max_iter,
                                 int check_init, int bf16, int ref,
                                 const int* caps, int n_caps, int threads,
                                 void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (Dc > kMaxD || n_caps < 1 || n_caps > kMaxCaps ||
      caps[n_caps - 1] != max_iter || threads % 32 != 0 ||
      (bf16 && phi_tab == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Caps cp;
  cp.n = n_caps;
  for (int k = 0; k < kMaxCaps; ++k) cp.at[k] = k < n_caps ? caps[k] : -1;
  const auto* l = static_cast<const float*>(llr);
  const auto* cv = static_cast<const int*>(chk_var);
  const auto* vs = static_cast<const int*>(var_slot);
  const auto* tab = static_cast<const float*>(phi_tab);
  auto* x = static_cast<int*>(x_out);
  auto* it = static_cast<int*>(it_out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = ref ? launch<__nv_bfloat16, true>(l, cv, vs, tab, x, it, B, C, V, Dc,
                                          Dv, max_iter, check_init, cp,
                                          threads, s)
            : launch<__nv_bfloat16, false>(l, cv, vs, tab, x, it, B, C, V, Dc,
                                           Dv, max_iter, check_init, cp,
                                           threads, s);
  } else {
    e = ref ? launch<float, true>(l, cv, vs, nullptr, x, it, B, C, V, Dc, Dv,
                                  max_iter, check_init, cp, threads, s)
            : launch<float, false>(l, cv, vs, nullptr, x, it, B, C, V, Dc, Dv,
                                   max_iter, check_init, cp, threads, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* spa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
