// One iteration of ADMM LP decoding, split around the z-update, for
// ADMMA's loop (decoders/admma.py), whose z-update leaves the loop at every
// iteration: a learned projection, or the exact one plus one Adam step on
// the MLP. Three kernels, launched once each per loop iteration:
//   - K1 admm_iter_pre: the x-update and the rows v = x_e + lam/mu;
//   - K2 project_rows: the exact projection of [R, Dc] rows onto the parity
//     polytope (also the teacher of ADMMA's training, and the projection of
//     viz/polytope.py on a card);
//   - K3 admm_iter_post: the dual update, the two squared norms, the
//     convergence test, the freeze of converged words and the count of the
//     words not yet done (the host's stop test reads it).
//
// Together they compute one iteration of _admm_core's loop
// (ldpc_decoders_tpu/ops/pallas_bp.py:1219, behind admm_decode_pallas ->
// pl.pallas_call), the arithmetic the whole-loop kernel admm_decode.cu runs
// without leaving the CTA, and they equal the plain PyTorch steps of
// ops/admm_kernel.py (admm_iter_pre_plain, project_parity_polytope,
// admm_iter_post_plain) bit for bit: every product, sum and quotient is
// rounded on its own (__fmul_rn and the others: nvcc would otherwise
// contract lam*inv_mu + x_e or mu*e1 + lam into one FMA), a row's slots
// are folded in slot order, and the norms are summed in the order of
// ops/admm_kernel.py:word_sum. The projection and the block fold are
// admm_row.cuh's, the whole-loop kernel's own code.
//
// State between launches lives in device memory in the plain version's
// layout: z, lam, v [B, C, Dc] f32 row-major (check row c of word b at
// (b*C + c)*Dc), x [B, V]. Tables (ops/admm_step.py:step_tables):
// chk_var [C, Dc] int32, the variable of each check slot, -1 where padded;
// var_slot [V, Dv] int32, the flat index c*Dc + d of each variable slot,
// -1 where padded. K1 runs for every word, frozen ones included: ADMMA's
// Adam step trains on the rows of every word, as the JAX package's does.
//
// What bounds them on the card: bytes. K1 reads z and lam and writes v
// (three [B, C, Dc] planes), K3 reads z, lam and z_new and writes z and
// lam of the running words, K2 reads and writes one plane: each a few tens
// of microseconds at B=4096 on LDPC(1200,3,6) (59 MB a plane). So the
// design is plain: K1 and K3 run one CTA per word, K1's x-update gathers z
// and lam through L1 (a word's planes are 14.4 KB each at that size) and
// keeps x in shared memory for the gather to the rows; K3 takes a run of
// 32 check rows per warp and turn, one row per lane, so the norms' block
// sums are three xor-shuffles as in the whole-loop kernel (a form that
// read and wrote a run's slots coalesced, a lane per slot, and folded the
// rows from shared memory was slower on an H100: 0.43 against 0.31 ms at
// B=4096, measured in two calls); K2 runs one thread per row, the row in
// registers.

#include "admm_row.cuh"

namespace {

using admm_row::clip01;
using admm_row::fold_blocks;
using admm_row::kAll;
using admm_row::kMaxD;
using admm_row::kRowBlock;
using admm_row::project_row;

constexpr int kMaxThreads = 1024;
constexpr int kRowThreads = 256;        // K2: threads per CTA

// K1. One CTA per word. x_new[v] = clip((sum over v's slots of (z -
// lam*inv_mu) - g[v]) / deg(v), 0, 1), slots in slot order from 0, then
// v = x_e + lam*inv_mu per check slot (0 + lam*inv_mu where padded).
__global__ void __launch_bounds__(kMaxThreads)
admm_iter_pre_kernel(const float* __restrict__ z,
                     const float* __restrict__ lam,
                     const float* __restrict__ g,
                     const int* __restrict__ chk_var,
                     const int* __restrict__ var_slot,
                     float* __restrict__ x_new, float* __restrict__ v_out,
                     int C, int V, int Dc, int Dv, float inv_mu) {
  extern __shared__ float s_x[];
  const size_t b = blockIdx.x;
  const int n_slot = C * Dc;
  const float* z_b = z + b * n_slot;
  const float* lam_b = lam + b * n_slot;
  for (int var = threadIdx.x; var < V; var += blockDim.x) {
    float acc = 0.f;
    int deg = 0;
    for (int s = 0; s < Dv; ++s) {
      const int i = __ldg(var_slot + var * Dv + s);
      if (i < 0) continue;
      ++deg;
      acc = __fadd_rn(acc, __fsub_rn(z_b[i], __fmul_rn(lam_b[i], inv_mu)));
    }
    const float x = clip01(__fdiv_rn(__fsub_rn(acc, g[b * V + var]),
                                     static_cast<float>(deg)));
    s_x[var] = x;
    x_new[b * V + var] = x;
  }
  __syncthreads();
  float* v_b = v_out + b * n_slot;
  for (int i = threadIdx.x; i < n_slot; i += blockDim.x) {
    const int var = __ldg(chk_var + i);
    const float xe = var >= 0 ? s_x[var] : 0.f;
    v_b[i] = __fadd_rn(xe, __fmul_rn(lam_b[i], inv_mu));
  }
}

// K2. One thread per row of v [R, kD]; mask [M, kD] (row r reads mask row
// r mod M) marks the real slots, none with kFull. Padded slots project to 0.
template <int kD, bool kFull>
__global__ void __launch_bounds__(kRowThreads)
project_rows_kernel(const float* __restrict__ v,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ out, long long R, int M) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= R) return;
  const float* v_r = v + r * kD;
  unsigned real = (1u << kD) - 1u;
  if (!kFull) {
    const unsigned char* m_r = mask + (r % M) * kD;
    real = 0u;
#pragma unroll
    for (int d = 0; d < kD; ++d) real |= (m_r[d] != 0 ? 1u : 0u) << d;
  }
  float row[kD], f[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    row[d] = (kFull || ((real >> d) & 1u)) ? v_r[d] : 0.f;
  }
  const float beta = project_row<kD, kFull>(row, real, f);
  float* o_r = out + r * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    o_r[d] = (kFull || ((real >> d) & 1u))
                 ? clip01(__fmaf_rn(-f[d], beta, row[d]))
                 : 0.f;
  }
}

// K3. One CTA per word; a warp takes a run of 32 consecutive check rows per
// turn, one row per lane. e1 = x_e - z_new, e2 = z - z_new, lam_new = lam +
// mu*e1; the word's squared norms of e1 and e2 in the order of word_sum;
// a running word (done == 0) takes x_new, z_new and lam_new, counts one
// update, and is done when both norms are below thresh. Words not done
// after this iteration add one to *left (zeroed by the launcher).
__global__ void __launch_bounds__(kMaxThreads)
admm_iter_post_kernel(float* __restrict__ x, float* __restrict__ z,
                      float* __restrict__ lam,
                      const float* __restrict__ x_new,
                      const float* __restrict__ z_new,
                      const int* __restrict__ chk_var,
                      int* __restrict__ updates,
                      unsigned char* __restrict__ done,
                      int* __restrict__ left, int C, int V, int Dc,
                      float mu, float thresh) {
  extern __shared__ float s_blk[];          // [2][nb]
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warp = blockDim.x >> 5;
  const int nb = (C + kRowBlock - 1) / kRowBlock;
  const int n_run = (C + 31) / 32;
  const bool active = done[b] == 0;
  const size_t n_slot = static_cast<size_t>(C) * Dc;
  float* z_b = z + b * n_slot;
  float* lam_b = lam + b * n_slot;
  const float* zn_b = z_new + b * n_slot;
  const float* xn_b = x_new + b * V;
  for (int run = warp; run < n_run; run += n_warp) {
    const int c_own = run * 32 + lane;
    const bool live = c_own < C;
    // A lane past the last row shadows it and writes nothing, so that the
    // whole warp meets at every shuffle.
    const int c = live ? c_own : C - 1;
    float row1 = 0.f, row2 = 0.f;
    for (int d = 0; d < Dc; ++d) {
      const int i = c * Dc + d;
      const int var = __ldg(chk_var + i);
      const float xe = var >= 0 ? xn_b[var] : 0.f;
      const float zn = zn_b[i];
      const float e1 = __fsub_rn(xe, zn);
      const float e2 = __fsub_rn(z_b[i], zn);
      row1 = __fadd_rn(row1, __fmul_rn(e1, e1));
      row2 = __fadd_rn(row2, __fmul_rn(e2, e2));
      if (live && active) {
        z_b[i] = zn;
        lam_b[i] = __fadd_rn(lam_b[i], __fmul_rn(mu, e1));
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
  if (active) {
    for (int var = threadIdx.x; var < V; var += blockDim.x) {
      x[b * V + var] = xn_b[var];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float tot[2];
    fold_blocks(s_blk, nb, lane, tot);
    if (lane == 0) {
      const bool now_done =
          !active || (tot[0] < thresh && tot[1] < thresh);
      if (active) {
        updates[b] += 1;
        done[b] = now_done ? 1 : 0;
      }
      if (!now_done) atomicAdd(left, 1);
    }
  }
}

template <int kD>
cudaError_t launch_rows(const float* v, const unsigned char* mask, float* out,
                        long long R, int M, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((R + kRowThreads - 1) / kRowThreads);
  if (mask == nullptr) {
    project_rows_kernel<kD, true><<<grid, kRowThreads, 0, stream>>>(
        v, mask, out, R, 1);
  } else {
    project_rows_kernel<kD, false><<<grid, kRowThreads, 0, stream>>>(
        v, mask, out, R, M);
  }
  return cudaGetLastError();
}

bool bad_threads(int threads) {
  return threads < 32 || threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace

// inv_mu is 1/mu rounded to float32 by the caller, the value the plain
// version multiplies by; g = llr * inv_mu [B, V]. threads: a multiple of
// 32 up to 1024.
extern "C" int admm_iter_pre_launch(const void* z, const void* lam,
                                    const void* g, const void* chk_var,
                                    const void* var_slot, void* x_new,
                                    void* v, int B, int C, int V, int Dc,
                                    int Dv, float inv_mu, int threads,
                                    void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (bad_threads(threads) || C < 1 || V < 1 || Dc < 1 || Dv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_iter_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  admm_iter_pre_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(lam),
      static_cast<const float*>(g), static_cast<const int*>(chk_var),
      static_cast<const int*>(var_slot), static_cast<float*>(x_new),
      static_cast<float*>(v), C, V, Dc, Dv, inv_mu);
  return static_cast<int>(cudaGetLastError());
}

// v, out [R, D] f32; mask: null, or [M, D] bytes (non-zero = real slot)
// that row r reads at row r mod M.
extern "C" int project_rows_launch(const void* v, const void* mask, void* out,
                                   long long R, int D, int M, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (R < 0 || (mask != nullptr && M < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* vp = static_cast<const float*>(v);
  const auto* mp = static_cast<const unsigned char*>(mask);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxD == 8, "one case per width up to kMaxD");
  switch (D) {
    case 1: return static_cast<int>(launch_rows<1>(vp, mp, op, R, M, s));
    case 2: return static_cast<int>(launch_rows<2>(vp, mp, op, R, M, s));
    case 3: return static_cast<int>(launch_rows<3>(vp, mp, op, R, M, s));
    case 4: return static_cast<int>(launch_rows<4>(vp, mp, op, R, M, s));
    case 5: return static_cast<int>(launch_rows<5>(vp, mp, op, R, M, s));
    case 6: return static_cast<int>(launch_rows<6>(vp, mp, op, R, M, s));
    case 7: return static_cast<int>(launch_rows<7>(vp, mp, op, R, M, s));
    case 8: return static_cast<int>(launch_rows<8>(vp, mp, op, R, M, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Updates x [B, V], z, lam [B, C, Dc], updates [B] int32 and done [B] bytes
// in place; left: one int32, the words not done after this iteration.
extern "C" int admm_iter_post_launch(void* x, void* z, void* lam,
                                     const void* x_new, const void* z_new,
                                     const void* chk_var, void* updates,
                                     void* done, void* left, int B, int C,
                                     int V, int Dc, float mu, float thresh,
                                     int threads, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(left, 0, sizeof(int), s);
  if (e != cudaSuccess || B == 0) return static_cast<int>(e);
  if (bad_threads(threads) || C < 1 || V < 1 || Dc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t nb = (C + kRowBlock - 1) / kRowBlock;
  const size_t smem = 2 * nb * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(admm_iter_post_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  admm_iter_post_kernel<<<B, threads, smem, s>>>(
      static_cast<float*>(x), static_cast<float*>(z),
      static_cast<float*>(lam), static_cast<const float*>(x_new),
      static_cast<const float*>(z_new), static_cast<const int*>(chk_var),
      static_cast<int*>(updates), static_cast<unsigned char*>(done),
      static_cast<int*>(left), C, V, Dc, mu, thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* admm_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
