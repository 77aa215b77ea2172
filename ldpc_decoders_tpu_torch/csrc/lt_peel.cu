// Batched incremental peeling of LT fountain codes: one CTA per sim, the
// whole peel in one launch.
//
// Replaces the sparse engine of ldpc_decoders_tpu/fountain/lt.py
// (LTSimulator._segment, lt.py:290-375), which ran as XLA gathers and
// cumsums, not as a Pallas kernel; the JAX package's TPU default was its
// dense engine (batched products over a 0/1 generator per sim), whose
// ~480 MB per sim of float32 G a golden-scale batch cannot afford here.
// It computes, per sim, what _segment computes:
//   - the active prefix m starts at k;
//   - success: no unresolved edge has its symbol in the prefix; the result
//     is m (not every variable need be resolved);
//   - a prefix symbol of unresolved degree 1 resolves its last variable to
//     the symbol's residual bit, and that bit is XORed into every symbol
//     holding the variable, beyond the prefix too;
//   - stuck (no such symbol, no success): m jumps to 1 + the first symbol at
//     or past m of degree 1; with none the sim fails with result n.
// Peeling is confluent, so the fixpoint at each prefix, and with it the
// minimal prefix, the resolved set and the recovered bits, do not depend on
// the order in which ripple symbols are taken: the kernel equals the plain
// version (ops/lt_kernel.py:lt_peel_plain, whole rounds) bit for bit.
//
// What bounds it on the card: not device memory (each sim's edge lists,
// ~2 MB at k=10000, n=12000, are read a few times) nor arithmetic (a few
// integer operations per edge), but the dependency chain: a sim needs
// about a thousand rounds of peeling and prefix jumps, each waiting on the
// last, and a round is two CTA barriers, shared-memory atomics and loads of
// the edge lists from L2.
//
// Design.
//   - A symbol's state is one 32-bit word in shared memory: its unresolved
//     degree in the low 31 bits and its residual bit in bit 31. Retiring an
//     edge whose variable resolved to `val` is ONE atomicAdd of
//     (val << 31) - 1: adding 2^31 flips bit 31 and carries nowhere, so the
//     degree and the bit change together and any reader sees both from the
//     same moment.
//   - The ripple is a queue of 16-bit symbol ids in shared memory, two of
//     them (this round's and the next). A warp takes a ripple symbol, reads
//     its word once (lane 0, broadcast), and if its degree is still 1 its
//     lanes scan the symbol's edges (symbol order) for the one variable not
//     yet resolved. Lane 0 claims it with atomicOr on the resolved bitmap:
//     two ripple symbols holding the same variable race, one wins (both
//     carry the same bit), and a lost claim, or one made on a stale bitmap
//     read, moves on to the next candidate. The winner's warp then retires
//     the variable's edges (variable order), each with the add above; a
//     prefix symbol whose degree falls to 1 joins the next queue (exactly
//     once: degrees only fall).
//   - The count of unresolved prefix edges is kept in shared memory (minus
//     one per retired prefix edge, plus the degrees a jump brings in), so
//     success is a test of one integer when the next queue is empty. A jump
//     scans the symbols past m a CTA-width at a time, stopping at the first
//     block that holds one of degree 1 (__syncthreads_or, atomicMin).
//   - Every round either resolves a variable or ends in a jump, a success or
//     a failure, so k + n + 2 rounds bound the loop.
// Shared memory per sim: 4n (symbol words) + 4n (two queues) + k/4 bytes
// (resolved and recovered bitmaps): 98.5 KB at k=10000, n=12000.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSymbols = 65535;   // 16-bit queue entries
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBit = 0x80000000u;   // residual bit of a symbol word
constexpr uint32_t kDeg = 0x7fffffffu;   // unresolved degree of a symbol word

size_t shared_bytes(int n, int k) {
  return 8 * static_cast<size_t>(n) + 8 * static_cast<size_t>((k + 31) / 32);
}

__global__ void __launch_bounds__(kThreads)
lt_peel_kernel(const int* __restrict__ edge_sym,
               const int* __restrict__ edge_var,
               const int* __restrict__ indptr_sym,
               const int* __restrict__ sym_by_var,
               const int* __restrict__ indptr_var,
               const int* __restrict__ msg, int* __restrict__ result,
               int* __restrict__ est, bool* __restrict__ resolved,
               int* __restrict__ rounds, int E, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  volatile uint32_t* wv = w;
  uint16_t* queue0 = reinterpret_cast<uint16_t*>(w + n);
  const int kw = (k + 31) / 32;
  uint32_t* res = reinterpret_cast<uint32_t*>(queue0 + 2 * n);
  volatile uint32_t* resv = res;
  uint32_t* bits = res + kw;
  __shared__ int qlen[2];
  __shared__ int active;   // unresolved edges of prefix symbols
  __shared__ int nxt_sh;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t eo = static_cast<size_t>(b) * E;
  const int* es = edge_sym + eo;
  const int* ev = edge_var + eo;
  const int* sbv = sym_by_var + eo;
  const int* ips = indptr_sym + static_cast<size_t>(b) * (n + 2);
  const int* ipv = indptr_var + static_cast<size_t>(b) * (k + 2);
  const int* mb = msg + static_cast<size_t>(b) * k;

  for (int s = tid; s < n; s += kThreads) w[s] = ips[s + 1] - ips[s];
  for (int i = tid; i < 2 * kw; i += kThreads) res[i] = 0;
  if (tid == 0) {
    qlen[0] = qlen[1] = 0;
    active = 0;
    nxt_sh = n;
  }
  __syncthreads();
  // Residual bits: every real edge (symbol < n; they come first) adds its
  // variable's bit into bit 31 of its symbol.
  const int n_edges = ips[n];
  for (int e = tid; e < n_edges; e += kThreads) {
    if (mb[ev[e]] & 1) atomicAdd(&w[es[e]], kBit);
  }
  __syncthreads();
  int m = k;
  {
    int deg_sum = 0;
    for (int s = tid; s < min(m, n); s += kThreads) {
      const int d = w[s] & kDeg;
      deg_sum += d;
      if (d == 1) queue0[atomicAdd(&qlen[0], 1)] = static_cast<uint16_t>(s);
    }
    if (deg_sum) atomicAdd(&active, deg_sum);
  }

  int cur = 0, result_b = n, step = 0;
  const int max_steps = k + n + 2;
  for (; step < max_steps; ++step) {
    __syncthreads();   // this round's queue, counts and m are in place
    if (tid == 0) nxt_sh = n;
    const int len = qlen[cur];
    const uint16_t* q = queue0 + cur * n;
    uint16_t* qn = queue0 + (cur ^ 1) * n;
    int retired = 0;
    for (int i = warp; i < len; i += kWarps) {
      const int s = q[i];
      uint32_t ws = 0;
      if (lane == 0) ws = wv[s];
      ws = __shfl_sync(kFull, ws, 0);
      if ((ws & kDeg) != 1) continue;   // fell to 0 this round
      // Claim the variable: only s's last one can still be unclaimed, so a
      // won claim is always right, and a lost one (a stale bitmap read, or
      // another ripple symbol first) moves on to the next candidate.
      const int hi = ips[s + 1];
      int v = -1;
      for (int base = ips[s]; base < hi && v < 0; base += 32) {
        const int e = base + lane;
        int cand = 0;
        bool open = false;
        if (e < hi) {
          cand = ev[e];
          open = !((resv[cand >> 5] >> (cand & 31)) & 1u);
        }
        for (unsigned hit = __ballot_sync(kFull, open); hit;
             hit &= hit - 1) {
          const int c = __shfl_sync(kFull, cand, __ffs(hit) - 1);
          const uint32_t bit = 1u << (c & 31);
          int won = 0;
          if (lane == 0) won = !(atomicOr(&res[c >> 5], bit) & bit);
          if (__shfl_sync(kFull, won, 0)) {
            v = c;
            break;
          }
        }
      }
      if (v < 0) continue;   // claimed from another ripple symbol
      const uint32_t val = ws >> 31;
      if (lane == 0 && val) atomicOr(&bits[v >> 5], 1u << (v & 31));
      const uint32_t delta = (val ? kBit : 0u) - 1u;
      const int vhi = ipv[v + 1];
      for (int j = ipv[v] + lane; j < vhi; j += 32) {
        const int s2 = sbv[j];
        const uint32_t old = atomicAdd(&w[s2], delta);
        if (s2 < m) {
          ++retired;
          if ((old & kDeg) == 2) {
            qn[atomicAdd(&qlen[cur ^ 1], 1)] = static_cast<uint16_t>(s2);
          }
        }
      }
    }
    if (retired) atomicSub(&active, retired);
    __syncthreads();   // the round is done
    if (qlen[cur ^ 1] > 0) {
      if (tid == 0) qlen[cur] = 0;
      cur ^= 1;
      continue;
    }
    // The ripple is empty: a success, or a stuck fixpoint.
    if (active == 0) {
      result_b = m;
      break;
    }
    for (int base = m; base < n; base += kThreads) {
      const int s = base + tid;
      const bool hit = s < n && (wv[s] & kDeg) == 1;
      if (hit) atomicMin(&nxt_sh, s);
      if (__syncthreads_or(hit)) break;
    }
    const int nxt = nxt_sh;
    if (nxt >= n) break;   // no symbol can restart the ripple: failure
    int deg_sum = 0;
    for (int s = m + tid; s <= nxt; s += kThreads) deg_sum += w[s] & kDeg;
    if (deg_sum) atomicAdd(&active, deg_sum);
    if (tid == 0) {
      qn[0] = static_cast<uint16_t>(nxt);
      qlen[cur ^ 1] = 1;
      qlen[cur] = 0;
    }
    m = nxt + 1;
    cur ^= 1;
  }
  __syncthreads();

  if (tid == 0) {
    result[b] = result_b;
    rounds[b] = step < max_steps ? step + 1 : max_steps;
  }
  int* eb = est + static_cast<size_t>(b) * k;
  bool* rb = resolved + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += kThreads) {
    const uint32_t bit = 1u << (v & 31);
    rb[v] = (res[v >> 5] & bit) != 0;
    eb[v] = (bits[v >> 5] & bit) != 0;
  }
}

}  // namespace

extern "C" int lt_peel_launch(const void* edge_sym, const void* edge_var,
                              const void* indptr_sym, const void* sym_by_var,
                              const void* indptr_var, const void* msg,
                              void* result, void* est, void* resolved,
                              void* rounds, int B, int E, int n, int k,
                              void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || n > kMaxSymbols || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(n, k);
  cudaError_t e = cudaFuncSetAttribute(
      lt_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lt_peel_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(edge_sym), static_cast<const int*>(edge_var),
      static_cast<const int*>(indptr_sym), static_cast<const int*>(sym_by_var),
      static_cast<const int*>(indptr_var), static_cast<const int*>(msg),
      static_cast<int*>(result), static_cast<int*>(est),
      static_cast<bool*>(resolved), static_cast<int*>(rounds), E, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lt_peel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
