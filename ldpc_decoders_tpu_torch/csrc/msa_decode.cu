// Whole-loop min-sum belief propagation for one LDPC codeword per CTA.
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
// With one CTA per word, "frozen" is "the CTA leaves its loop": that is
// result-identical to the Pallas block loop (_bounded_loop), whose body is
// a no-op for finished words. No batch padding is needed.
// Snapshot planes (the TPU kernel's caps=, _snap_write / _snap_fill): x_out
// is [K][B][V]; plane k holds the decisions after caps[k] iterations, or
// the final ones where the word finished earlier. A single-cap decode is
// K = 1 with caps = {max_iter}. A snapshot is a pass of its own after the
// variable pass (the hot loop stays free of it); a thread reads back
// exactly the marginals it has just written, so it needs no barrier.
//
// Design. The TPU kernel moves messages with one-hot MXU matmuls because
// the TPU has no fast gather. Here each CTA keeps its word's whole state in
// shared memory for the whole loop: the priors and marginals ([V] f32
// each) and the check-to-variable messages ([Dc][C], message type). The
// variable-to-check messages are never stored: the check pass rebuilds
// each one from marg and the old c2v as it reads them. The edge tables
// (variable of each check slot, check slot of each variable slot, both
// slot-major with -1 for padded slots, so irregular codes work too) are
// shared by every CTA and stay in L1/L2. The syndrome of the current x_hat
// is folded into the same check pass (x_hat = marg < 0 is read there
// anyway), and __syncthreads_or turns it into the CTA's exit decision.
//
// What bounds it on the card: shared-memory traffic and latency. Device
// memory sees only the word's LLRs in (V*4 bytes, ~4.8 KB at V=1200) and
// its decisions out (~4.8 KB); each iteration makes ~2E shared-memory
// reads and E writes plus the random marg gathers, separated by two CTA
// barriers. The design answers with slot-major c2v (consecutive threads
// touch consecutive checks: conflict-free), no stored v2c, a fused
// syndrome, and a small footprint (~17 KB bf16 / ~24 KB f32 at
// LDPC(1200,3,6)) so that many CTAs share an SM and hide each other's
// barrier and latency stalls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kDeg1Guard = 1e30f;  // only a degree-1 check keeps it
constexpr int kMaxCaps = 16;

struct Caps {
  int n;
  int at[kMaxCaps];  // ascending, at[n-1] == max_iter
};

template <typename T>
struct Msg;

template <>
struct Msg<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Msg<__nv_bfloat16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// llr [B, V] f32; chk_var [Dc][C]: variable of check slot (c, d), -1 if
// padded; var_slot [Dv][V]: index d*C + c of variable slot (v, s) in the
// slot-major c2v, -1 if padded. Outputs x_out [K][B][V] int32, it_out [B].
template <typename MsgT>
__global__ void msa_decode_kernel(const float* __restrict__ llr,
                                  const int* __restrict__ chk_var,
                                  const int* __restrict__ var_slot,
                                  int* __restrict__ x_out,
                                  int* __restrict__ it_out, int B, int C,
                                  int V, int Dc, int Dv, int max_iter,
                                  int check_init, Caps caps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_llr = reinterpret_cast<float*>(smem);
  float* s_marg = s_llr + V;
  MsgT* s_c2v = reinterpret_cast<MsgT*>(s_marg + V);

  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(B) * V;
  const float* llr_b = llr + static_cast<size_t>(b) * V;
  int* x_b = x_out + static_cast<size_t>(b) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float l = llr_b[v];
    s_llr[v] = l;
    s_marg[v] = l;  // with c2v = 0 the first check pass sees v2c = msg(llr)
  }
  for (int i = threadIdx.x; i < Dc * C; i += blockDim.x) {
    s_c2v[i] = Msg<MsgT>::store(0.f);
  }
  __syncthreads();

  int it = 0;
  int kn = 0;  // next snapshot plane to write
  while (it < max_iter) {
    // Check pass: syndrome of x_hat = (marg < 0), and the new c2v.
    int unsat = 0;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float m1 = kDeg1Guard, m2 = kDeg1Guard;
      int am = 0, nneg = 0, par = 0;
      unsigned negmask = 0u;
      for (int d = 0; d < Dc; ++d) {
        const int v = __ldg(chk_var + d * C + c);
        if (v < 0) continue;
        const float mg = s_marg[v];
        par ^= (mg < 0.f);
        const float p = Msg<MsgT>::round(Msg<MsgT>::round(mg) -
                                         Msg<MsgT>::load(s_c2v[d * C + c]));
        const float mag = fabsf(p);
        const bool lt = mag < m1;
        m2 = lt ? m1 : fminf(m2, mag);
        m1 = lt ? mag : m1;
        am = lt ? d : am;
        if (p < 0.f) {
          ++nneg;
          negmask |= 1u << d;
        }
      }
      unsat |= par;
      for (int d = 0; d < Dc; ++d) {
        if (__ldg(chk_var + d * C + c) < 0) continue;
        const float ext = (d == am) ? m2 : m1;
        const bool flip = ((nneg - static_cast<int>((negmask >> d) & 1u)) & 1);
        s_c2v[d * C + c] = Msg<MsgT>::store(flip ? -ext : ext);
      }
    }
    // Barrier: c2v complete, marg no longer read. The vote is uniform.
    if (!__syncthreads_or(unsat) && (it > 0 || check_init)) break;

    // Variable pass: marg = llr + (c2v summed in slot order).
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      float acc = 0.f;
      for (int s = 0; s < Dv; ++s) {
        const int f = __ldg(var_slot + s * V + v);
        if (f >= 0) acc += Msg<MsgT>::load(s_c2v[f]);
      }
      s_marg[v] = s_llr[v] + acc;
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

template <typename MsgT>
cudaError_t launch(const float* llr, const int* chk_var, const int* var_slot,
                   int* x_out, int* it_out, int B, int C, int V, int Dc,
                   int Dv, int max_iter, int check_init, const Caps& caps,
                   int threads, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(V) * sizeof(float) +
                      static_cast<size_t>(Dc) * C * sizeof(MsgT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        msa_decode_kernel<MsgT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  msa_decode_kernel<MsgT><<<B, threads, smem, stream>>>(
      llr, chk_var, var_slot, x_out, it_out, B, C, V, Dc, Dv, max_iter,
      check_init, caps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int msa_decode_launch(const void* llr, const void* chk_var,
                                 const void* var_slot, void* x_out,
                                 void* it_out, int B, int C, int V, int Dc,
                                 int Dv, int max_iter, int check_init,
                                 int bf16, const int* caps, int n_caps,
                                 int threads, void* stream) {
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
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(l, cv, vs, x, it, B, C, V, Dc, Dv,
                                   max_iter, check_init, cp, threads, s)
           : launch<float>(l, cv, vs, x, it, B, C, V, Dc, Dv, max_iter,
                           check_init, cp, threads, s);
  return static_cast<int>(e);
}

extern "C" const char* msa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
