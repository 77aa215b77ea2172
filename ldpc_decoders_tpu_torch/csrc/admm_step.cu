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
// of microseconds at B=4096 on LDPC(1200,3,6) (59 MB a plane). K1 runs one
// CTA per word; its x-update gathers z and lam through L1 (a word's planes
// are 14.4 KB each at that size) and keeps x in shared memory for the
// gather to the rows. K2 runs one thread per row, the row in registers.
//
// K3's first form (one CTA per word, a lane per row reading and writing
// the planes in place) ran at a third of its bound on an H100, and its
// stores set the time: a warp's 4-byte stores, 24 bytes apart, wrote each
// sector in six pieces (0.31 ms; 0.064 ms with the stores left out). A
// frozen word, which stores nothing, cost it little, and the row width as
// a template argument made it slower, its stores then issued back to
// back. So K3 now writes each sector whole, once: a producer warp moves a
// unit of rows of z, z_new and lam into shared memory by bulk copies
// (TMA's one-dimensional form, completing on an mbarrier), two units in
// flight per CTA; the row threads, the width compiled in, fold the rows
// there and leave the new z and lam in place, which the producer stores
// in bulk. A persistent grid claims running words from a counter, so a
// frozen word costs a byte read. Units of 224 rows (CTAs of 256 threads,
// four an SM by their registers) beat a unit of the whole word (640
// threads, one CTA an SM) by 7%: K3 runs at ~76% of its bytes bound's
// rate, 0.131 ms against 0.100 (PERF.md PR 15).

#include <cstdint>

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

// K3's copies: TMA's one-dimensional bulk form, completing on mbarriers.
namespace bulk {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the CTA's threads and copies.
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transfers the phase waits for.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity` to complete. A phase that has not
// completed after ~2^34 cycles (seconds) traps, so that a lost copy fails
// the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  if (bar_try(bar, parity)) return;
  const long long start = clock64();
  while (!bar_try(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Device memory -> shared memory; `bytes` a multiple of 16, both addresses
// 16-byte aligned.
__device__ __forceinline__ void load(float* dst, const float* src,
                                     unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void store(float* dst, const float* src,
                                      unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The stores issued by this thread have read their shared memory.
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// This thread's writes to shared memory, before a bulk store reads them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk

constexpr int kStages = 2;   // K3: units in flight per CTA
constexpr int kPlanes = 3;   // K3's staged planes: z, z_new, lam

// The slots [g, g + n) of a plane, in global element indices, and their
// 16-byte-aligned middle [a0, a1): the part a bulk copy moves. A unit's
// slot gi sits at place sh + gi - g of its stage, sh = g mod 4, so that the
// middle starts 16-byte aligned there too.
struct Span {
  size_t g, a0, a1;
  int sh;
  __device__ __forceinline__ Span(size_t g_, int n) : g(g_) {
    a0 = (g + 3) & ~size_t{3};
    a1 = (g + n) & ~size_t{3};
    if (a1 < a0) a1 = a0;
    sh = static_cast<int>(g & 3);
  }
  __device__ __forceinline__ bool staged(size_t gi) const {
    return gi >= a0 && gi < a1;
  }
  __device__ __forceinline__ unsigned bytes() const {
    return static_cast<unsigned>((a1 - a0) * sizeof(float));
  }
  __device__ __forceinline__ int place(size_t gi) const {
    return sh + static_cast<int>(gi - g);
  }
};

// The next running word for this CTA from the launch's word counter, or
// -1. A frozen word costs one byte read.
__device__ __forceinline__ int claim_word(int* next_word,
                                          const unsigned char* done, int B) {
  for (;;) {
    const int w = atomicAdd(next_word, 1);
    if (w >= B) return -1;
    if (done[w] == 0) return w;
  }
}

// K3. A persistent grid; a unit is `rows` consecutive check rows of one
// running word, one row per consumer thread, in whole runs of 32 (C = 600:
// three units of at most 224 rows). The last warp of the CTA is the
// producer: its lane 0 claims words from the launch's counter, passes over
// frozen ones, and moves a unit's z, z_new and lam into a stage of shared
// memory by bulk copies (two stages, so the next unit's copy is in flight
// while this one is folded), then stores the unit's new z and lam back
// from the stage in bulk; the warp also folds the unit's block sums into
// the word's norms and, after the word's last unit, sets updates, done
// and the count of words left. Slots outside a unit's 16-byte-aligned
// middle (where C*Dc is not a multiple of 4) are read and written by the
// consumers directly. e1 = x_e - z_new, e2 = z - z_new, lam_new = lam +
// mu*e1; a running word takes x_new, z_new and lam_new, counts one update,
// and is done when both norms are below thresh. A frozen word is not
// touched. counts[0] (words not done after this iteration) and counts[1]
// (the word counter) are zeroed by the launcher.
template <int kD>
__global__ void __launch_bounds__(kMaxThreads)
admm_iter_post_kernel(float* __restrict__ x, float* __restrict__ z,
                      float* __restrict__ lam,
                      const float* __restrict__ x_new,
                      const float* __restrict__ z_new,
                      const int* __restrict__ chk_var,
                      int* __restrict__ updates,
                      unsigned char* __restrict__ done,
                      int* __restrict__ counts, int B, int C, int V, int rows,
                      int plane, float mu, float thresh) {
  extern __shared__ __align__(128) float s_buf[];  // [kStages][kPlanes][plane]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int s_word[kStages], s_unit[kStages];
  const int n_blk = rows / kRowBlock;              // block sums per unit
  float* s_blk = s_buf + kStages * kPlanes * plane;  // [kStages][2][n_blk]
  const int n_unit = (C + rows - 1) / rows;
  const size_t n_slot = static_cast<size_t>(C) * kD;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bulk::bar_init(&full[s], 1);
      bulk::bar_init(&empty[s], rows / 32);
    }
    bulk::bar_fence_init();
  }
  __syncthreads();

  if (tid < rows) {
    // Consumers: thread t takes row u*rows + t of the unit.
    const int t = tid;
    for (int k = 0;; ++k) {
      const int s = k & 1;
      bulk::bar_wait(&full[s], (k >> 1) & 1);
      const int w = s_word[s];
      if (w < 0) break;
      const int u = s_unit[s];
      const int r0 = u * rows;
      const int n_row = min(rows, C - r0);
      const Span sp(static_cast<size_t>(w) * n_slot +
                        static_cast<size_t>(r0) * kD,
                    n_row * kD);
      float* bz = s_buf + s * kPlanes * plane;
      float* bzn = bz + plane;
      float* bl = bzn + plane;
      float row1 = 0.f, row2 = 0.f;
      if (t < n_row) {
        const int* cv = chk_var + static_cast<size_t>(r0 + t) * kD;
        const float* xn = x_new + static_cast<size_t>(w) * V;
        const size_t gr = sp.g + static_cast<size_t>(t) * kD;
        int var[kD];
        float zv[kD], znv[kD], lv[kD], xe[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d) var[d] = __ldg(cv + d);
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const size_t gi = gr + d;
          const int p = sp.place(gi);
          const bool in = sp.staged(gi);
          zv[d] = in ? bz[p] : z[gi];
          znv[d] = in ? bzn[p] : z_new[gi];
          lv[d] = in ? bl[p] : lam[gi];
          xe[d] = var[d] >= 0 ? __ldg(xn + var[d]) : 0.f;
        }
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const float e1 = __fsub_rn(xe[d], znv[d]);
          const float e2 = __fsub_rn(zv[d], znv[d]);
          row1 = __fadd_rn(row1, __fmul_rn(e1, e1));
          row2 = __fadd_rn(row2, __fmul_rn(e2, e2));
          const float l = __fadd_rn(lv[d], __fmul_rn(mu, e1));
          const size_t gi = gr + d;
          const int p = sp.place(gi);
          if (sp.staged(gi)) {
            bz[p] = znv[d];
            bl[p] = l;
          } else {
            z[gi] = znv[d];
            lam[gi] = l;
          }
        }
      }
      // Block sums: 8 rows, strides 4, 2, 1 (rows past C add 0).
#pragma unroll
      for (int m = 4; m > 0; m >>= 1) {
        row1 = __fadd_rn(row1, __shfl_xor_sync(kAll, row1, m));
        row2 = __fadd_rn(row2, __shfl_xor_sync(kAll, row2, m));
      }
      if (lane % kRowBlock == 0) {
        s_blk[(2 * s) * n_blk + t / kRowBlock] = row1;
        s_blk[(2 * s + 1) * n_blk + t / kRowBlock] = row2;
      }
      if (u == 0) {
        const size_t o = static_cast<size_t>(w) * V;
        for (int v = t; v < V; v += rows) x[o + v] = __ldg(x_new + o + v);
      }
      bulk::fence_async();
      __syncwarp();
      if (lane == 0) bulk::bar_arrive(&empty[s]);
    }
  } else if (tid < rows + 32) {
    // Producer warp. Lane 0 keeps the claimed word and its next unit.
    int cur = -1, next_u = n_unit, left = 0;
    int word[kStages] = {-1, -1}, unit[kStages] = {0, 0};
    float acc1 = 0.f, acc2 = 0.f;
    auto issue = [&](int s) {  // lane 0: the CTA's next unit into stage s
      if (next_u >= n_unit) {
        cur = claim_word(counts + 1, done, B);
        next_u = 0;
      }
      const int w = cur, u = next_u++;
      word[s] = w;
      unit[s] = u;
      s_word[s] = w;
      s_unit[s] = u;
      if (w < 0) {
        bulk::bar_arrive(&full[s]);
        return;
      }
      const int r0 = u * rows;
      const Span sp(static_cast<size_t>(w) * n_slot +
                        static_cast<size_t>(r0) * kD,
                    min(rows, C - r0) * kD);
      if (sp.a1 == sp.a0) {
        bulk::bar_arrive(&full[s]);
        return;
      }
      float* dst = s_buf + s * kPlanes * plane + sp.place(sp.a0);
      bulk::bar_expect(&full[s], kPlanes * sp.bytes());
      bulk::load(dst, z + sp.a0, sp.bytes(), &full[s]);
      bulk::load(dst + plane, z_new + sp.a0, sp.bytes(), &full[s]);
      bulk::load(dst + 2 * plane, lam + sp.a0, sp.bytes(), &full[s]);
    };
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) issue(s);
    }
    for (int k = 0;; ++k) {
      const int s = k & 1;
      const int w = __shfl_sync(kAll, s ? word[1] : word[0], 0);
      const int u = __shfl_sync(kAll, s ? unit[1] : unit[0], 0);
      if (w < 0) break;
      bulk::bar_wait(&empty[s], (k >> 1) & 1);
      const int r0 = u * rows;
      const int n_row = min(rows, C - r0);
      if (lane == 0) {
        const Span sp(static_cast<size_t>(w) * n_slot +
                          static_cast<size_t>(r0) * kD,
                      n_row * kD);
        if (sp.a1 > sp.a0) {
          float* src = s_buf + s * kPlanes * plane + sp.place(sp.a0);
          bulk::store(z + sp.a0, src, sp.bytes());
          bulk::store(lam + sp.a0, src + 2 * plane, sp.bytes());
          bulk::commit();
        }
      }
      // The word's norms in word_sum's order: block b to lane b mod 32,
      // each lane adding its blocks in ascending order over the units,
      // then the lanes halved.
      const float* b1 = s_blk + (2 * s) * n_blk;
      const float* b2 = b1 + n_blk;
      const int nb = (n_row + kRowBlock - 1) / kRowBlock;
      for (int j = (lane - r0 / kRowBlock) & 31; j < nb; j += 32) {
        acc1 = __fadd_rn(acc1, b1[j]);
        acc2 = __fadd_rn(acc2, b2[j]);
      }
      if (u == n_unit - 1) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          acc1 = __fadd_rn(acc1, __shfl_xor_sync(kAll, acc1, m));
          acc2 = __fadd_rn(acc2, __shfl_xor_sync(kAll, acc2, m));
        }
        if (lane == 0) {
          const bool now_done = acc1 < thresh && acc2 < thresh;
          updates[w] += 1;
          done[w] = now_done ? 1 : 0;
          left += now_done ? 0 : 1;
        }
        acc1 = 0.f;
        acc2 = 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        bulk::wait_read();
        issue(s);
      }
    }
    if (lane == 0) {
      if (left) atomicAdd(counts, left);
      bulk::wait_all();
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

template <int kD>
cudaError_t launch_post(float* x, float* z, float* lam, const float* x_new,
                        const float* z_new, const int* chk_var, int* updates,
                        unsigned char* done, int* counts, int B, int C, int V,
                        int rows, int plane, float mu, float thresh,
                        cudaStream_t stream) {
  auto* kern = admm_iter_post_kernel<kD>;
  const int threads = rows + 32;
  const size_t smem = static_cast<size_t>(kStages) *
                      (kPlanes * plane + 2 * (rows / kRowBlock)) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // A persistent grid: the CTAs the card holds at once.
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = min(B, per_sm * sms);
  kern<<<grid, threads, smem, stream>>>(x, z, lam, x_new, z_new, chk_var,
                                        updates, done, counts, B, C, V, rows,
                                        plane, mu, thresh);
  return cudaGetLastError();
}

// Updates x [B, V], z, lam [B, C, Dc], updates [B] int32 and done [B] bytes
// in place; counts: two int32, [0] the words not done after this
// iteration. rows: check rows per unit, a multiple of 32 with rows + 32 <=
// 1024; plane: floats per staged plane, a multiple of 4 >= rows*Dc + 3.
// z, z_new and lam 16-byte aligned.
extern "C" int admm_iter_post_launch(void* x, void* z, void* lam,
                                     const void* x_new, const void* z_new,
                                     const void* chk_var, void* updates,
                                     void* done, void* counts, int B, int C,
                                     int V, int Dc, float mu, float thresh,
                                     int rows, int plane, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess || B == 0) return static_cast<int>(e);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (C < 1 || V < 1 || rows < 32 || rows % 32 != 0 ||
      rows + 32 > kMaxThreads || plane % 4 != 0 ||
      static_cast<long long>(plane) < static_cast<long long>(rows) * Dc + 3 ||
      !aligned(z) || !aligned(z_new) || !aligned(lam)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* xp = static_cast<float*>(x);
  auto* zp = static_cast<float*>(z);
  auto* lp = static_cast<float*>(lam);
  const auto* xn = static_cast<const float*>(x_new);
  const auto* zn = static_cast<const float*>(z_new);
  const auto* cv = static_cast<const int*>(chk_var);
  auto* up = static_cast<int*>(updates);
  auto* dp = static_cast<unsigned char*>(done);
  auto* cp = static_cast<int*>(counts);
#define ADMM_POST_CASE(D)                                                     \
  case D:                                                                     \
    return static_cast<int>(launch_post<D>(xp, zp, lp, xn, zn, cv, up, dp,   \
                                           cp, B, C, V, rows, plane, mu,      \
                                           thresh, s));
  static_assert(kMaxD == 8, "one case per width up to kMaxD");
  switch (Dc) {
    ADMM_POST_CASE(1)
    ADMM_POST_CASE(2)
    ADMM_POST_CASE(3)
    ADMM_POST_CASE(4)
    ADMM_POST_CASE(5)
    ADMM_POST_CASE(6)
    ADMM_POST_CASE(7)
    ADMM_POST_CASE(8)
  }
#undef ADMM_POST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* admm_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
