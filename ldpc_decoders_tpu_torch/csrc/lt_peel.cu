// Batched incremental peeling of LT fountain codes: one CTA per sim, the
// edge layout and the whole peel in one launch.
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
// the order in which ripple symbols are taken, nor on the order of a
// variable's edges: the kernel equals the plain version
// (ops/lt_kernel.py:lt_peel_plain, whole rounds) bit for bit.
//
// What bounds it on the card: not the bytes it must move (each sim's edge
// lists, ~1.4 MB at k=10000, n=12000, read once) nor arithmetic (a few
// integer operations per edge), but the dependency chain of the peel: the
// slowest sim needs about a thousand links of "a symbol falls to degree 1,
// a warp resolves its variable, the variable's symbols fall", each waiting
// on the last, plus a prefix jump whenever the ripple dies out. The layout
// reads the lists twice and its counting sort scatters one 16-bit store
// per edge at random into L2, the larger part of the layout's time.
//
// Design.
//   - A symbol's state is one 64-bit word: its unresolved degree (bits
//     0-19), the sum of its unresolved variables' ids (bits 20-59) and its
//     residual bit (bit 63). Retiring an edge whose variable v resolved to
//     `val` is ONE atomicAdd of (val << 63) - 1 - (v << 20): no field
//     borrows from the next (the degree counts v, the sum holds v), and
//     adding 2^63 flips bit 63 and carries nowhere. Any reader sees the
//     three fields from one moment, and a word of degree 1 names its last
//     variable: no scan of the symbol's edges. (k < 2^20 keeps the fields
//     apart: a degree is at most k, a sum below k^2 / 2.) On sm_90 a 64-bit
//     add to shared memory is a compare-and-swap loop; two 32-bit words
//     (degree and bit, id sum) would be native adds but cannot be right:
//     between the add that leaves one variable and the read of the sum, the
//     retirement of that last variable (claimed through another symbol)
//     can take its id out of the sum.
//   - The edge layout is built here, per sim, from the light lists, in two
//     passes whose loads are unrolled four deep. The first, in symbol
//     order (edge_sym is non-decreasing), folds each warp's run of one
//     symbol into one add to its word (count, id sum, parity of the
//     message bits, staged in shared memory as a bitmap first) and counts
//     the variables (a histogram). A warp scans the histogram (each bin
//     then holds the end of its variable's range), and the second pass
//     scatters edge_sym into sym_by_var (16-bit symbol ids: half the
//     scattered bytes of int32) at atomicSub(&bin, 1) - 1, which leaves
//     each bin at its range's start: a counting sort. Within a
//     variable the scatter leaves the edges in any order; by confluence
//     nothing depends on it. The peel needs no symbol offsets; a
//     layout-only launch writes them (where edge_sym steps up) for checks.
//   - The ripple is one queue of claimed variables in shared memory: 32-bit
//     items (variable << 1 | its bit), a slot per variable that can be
//     claimed (min(n, k)), since each is claimed once. The lane whose add
//     takes a prefix symbol from degree 2 to 1 reads the last variable and
//     its bit from the word that add returned, claims the variable with
//     atomicOr on the resolved bitmap (two symbols naming one variable
//     race, one wins; both carry the same bit) and, if it won, pushes it
//     and prefetches the line of that variable's edges into L1. A warp
//     takes a ticket (the next slot), polls that slot until an item is
//     published there (a fence, then the store; 0xffffffff marks an empty
//     slot), and retires the variable's edges (variable order), each with
//     the add above.
//   - No CTA barrier in the peel. One 32-bit word counts the slots handed
//     out (high half) and the claimed variables not yet retired (low
//     half): a push adds 0x10001, a finished item subtracts 1. The warp
//     whose subtraction leaves nothing pending ends the ripple alone: the
//     count of unresolved prefix edges (kept in shared memory, each
//     finished item subtracting the prefix edges it retired) decides
//     success, else that warp scans for the jump symbol, adds the degrees
//     the jump brings in, and claims and pushes its variable; or it marks
//     the sim failed. The other warps keep polling their tickets; slots and
//     tickets both run on over the whole peel, so nothing is reset between
//     ripples.
//   - Only `peel_warps` warps take tickets (24 of 32 measured best at the
//     golden configuration: more warps poll more, fewer leave symbols
//     waiting); the others wait at the final barrier. All 32 warps build
//     the layout.
//   - Where the symbol words and the variable offsets (8n and 4 (k + 1)
//     bytes) do not fit in shared memory beside the rest, they live in
//     device memory (the template flag kShared = false): the same code
//     through other pointers, with global atomics.
// Shared memory per sim: 32 bytes of counters, 4 min(n, k) (the queue),
// k / 4 bytes (resolved and recovered bitmaps), and with kShared
// 8n + 4 (k + 1): 178,540 bytes at k=10000, n=12000.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // chunks of loads in flight per thread
constexpr int kMaxSymbols = 65535;   // 16-bit symbol ids and queue counts
constexpr int kMaxVars = 1 << 20;    // the degree field
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumShift = 20;
constexpr u64 kDeg = (1ull << kSumShift) - 1;
constexpr u64 kSum = (1ull << 40) - 1;
constexpr u64 kBit = 1ull << 63;            // residual bit of a symbol word
constexpr uint32_t kEmpty = 0xffffffffu;   // a queue slot not yet written
constexpr uint32_t kPush = 0x10001u;     // one slot handed out, one pending

// The counters at the head of shared memory.
enum { kTake, kQueue, kActive, kM, kDone, kResult, kRipples, kReal,
       kHeader };

size_t shared_bytes(int n, int k, bool on_chip) {
  const size_t nn = n, kk = k;
  size_t b = 4 * kHeader + 4 * (nn < kk ? nn : kk) + 8 * ((kk + 31) / 32);
  if (on_chip) b += 8 * nn + 4 * (kk + 1);
  return b;
}

__device__ __forceinline__ int name_of(u64 word) {
  return static_cast<int>((word >> kSumShift) & kSum);
}

// The ripple's state and the peel steps one warp takes.
struct Peel {
  int* hdr;
  volatile int* hdrv;
  u64* w;
  volatile u64* wv;
  const int* ipv;   // the first edge of each variable (variable order), k + 1
  const uint16_t* sbv;   // sym_by_var
  volatile uint32_t* q;
  uint32_t* res;
  uint32_t* bits;
  int n;

  // Claim the variable a word of degree 1 names (a lane's own call): true,
  // with the queue item (variable << 1 | bit), if this call won it.
  __device__ bool claim(u64 word, uint32_t* item) const {
    const int v = name_of(word);
    const uint32_t bit = 1u << (v & 31);
    if (atomicOr(&res[v >> 5], bit) & bit) return false;
    const uint32_t val = static_cast<uint32_t>(word >> 63);
    if (val) atomicOr(&bits[v >> 5], bit);
    *item = (static_cast<uint32_t>(v) << 1) | val;
    return true;
  }

  // Push a claimed item (a lane's own call): a slot, then the item
  // published in it.
  __device__ void push_one(uint32_t item) const {
    const uint32_t old = atomicAdd(reinterpret_cast<uint32_t*>(hdr + kQueue),
                                   kPush);
    __threadfence_block();
    q[old >> 16] = item;
  }

  // The ripple is empty and nothing is in flight: success, a jump, or a
  // failure. Called by one whole warp.
  __device__ void end_ripple(int lane) const {
    __threadfence_block();
    const int m = hdrv[kM];
    if (hdrv[kActive] == 0) {
      if (lane == 0) {
        hdrv[kResult] = m;
        __threadfence_block();
        hdrv[kDone] = 1;
      }
      return;
    }
    int nxt = n;
    for (int base = m; base < n; base += 32) {
      const int s = base + lane;
      const unsigned hit =
          __ballot_sync(kFull, s < n && (wv[s] & kDeg) == 1);
      if (hit) {
        nxt = base + __ffs(hit) - 1;
        break;
      }
    }
    if (nxt >= n) {   // no symbol can restart the ripple: failure
      if (lane == 0) hdrv[kDone] = 1;
      return;
    }
    int deg_sum = 0;
    for (int s = m + lane; s <= nxt; s += 32) {
      deg_sum += static_cast<int>(wv[s] & kDeg);
    }
    deg_sum = __reduce_add_sync(kFull, deg_sum);
    if (lane == 0) {
      atomicAdd(hdr + kActive, deg_sum);
      hdrv[kM] = nxt + 1;
      ++hdrv[kRipples];
      // Nothing is in flight, so every claimed variable is retired and the
      // one nxt names is free: this claim wins.
      uint32_t item;
      if (claim(wv[nxt], &item)) push_one(item);
    }
    __syncwarp();
  }

  // Retire a claimed variable (one whole warp): each of its edges, with one
  // add to its symbol's word; a prefix symbol that falls to degree 1 names
  // its last variable, which the lane claims and pushes. Returns the
  // prefix edges retired.
  __device__ int take(uint32_t item, int m, int lane) const {
    const int v = static_cast<int>(item >> 1);
    const u64 delta = (static_cast<u64>(item & 1u) << 63) - 1ull -
                      (static_cast<u64>(v) << kSumShift);
    const int vhi = ipv[v + 1];
    int retired = 0;
    for (int base = ipv[v]; base < vhi; base += 32) {
      const int j = base + lane;
      uint32_t next = 0;
      bool won = false;
      if (j < vhi) {
        const int s2 = sbv[j];
        const u64 old = atomicAdd(&w[s2], delta);
        if (s2 < m) {
          ++retired;
          if ((old & kDeg) == 2) won = claim(old + delta, &next);
        }
      }
      const unsigned pushed = __ballot_sync(kFull, won);
      if (pushed) {
        uint32_t old = 0;
        if (lane == 0) {
          old = atomicAdd(reinterpret_cast<uint32_t*>(hdr + kQueue),
                          __popc(pushed) * kPush);
        }
        old = __shfl_sync(kFull, old, 0);
        if (won) {
          __threadfence_block();
          q[(old >> 16) + __popc(pushed & ((1u << lane) - 1))] = next;
          // The edges of that variable, for the warp that takes it.
          asm volatile("prefetch.global.L1 [%0];" ::"l"(sbv + ipv[next >> 1]));
        }
      }
    }
    return retired;
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
lt_peel_kernel(const int* __restrict__ edge_sym,
               const int* __restrict__ edge_var,
               const int* __restrict__ msg, uint16_t* sym_by_var,
               u64* words, int* indptr_var, int* __restrict__ indptr_sym,
               int* __restrict__ result, int* __restrict__ est,
               bool* __restrict__ resolved, int* __restrict__ rounds, int E,
               int n, int k, int peel_warps, int layout_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kw = (k + 31) / 32;
  int* hdr = reinterpret_cast<int*>(smem);
  unsigned char* rest = smem + 4 * kHeader;
  u64* w;
  int* ipv;
  if (kShared) {
    w = reinterpret_cast<u64*>(rest);
    ipv = reinterpret_cast<int*>(w + n);
    rest = reinterpret_cast<unsigned char*>(ipv + (k + 1));
  } else {
    w = words + static_cast<size_t>(b) * n;
    ipv = indptr_var + static_cast<size_t>(b) * (k + 2);
  }
  const int slots = min(n, k);   // a slot per claimed variable
  uint32_t* q = reinterpret_cast<uint32_t*>(rest);
  uint32_t* res = q + slots;
  uint32_t* bits = res + kw;
  const size_t eo = static_cast<size_t>(b) * E;
  const int* es = edge_sym + eo;
  const int* ev = edge_var + eo;
  uint16_t* sbv = sym_by_var + eo;
  int* ips = layout_only ? indptr_sym + static_cast<size_t>(b) * (n + 2)
                        : nullptr;
  const int* mb = msg + static_cast<size_t>(b) * k;

  // Zero the symbol words and the histogram; the message as a bitmap.
  for (int s = tid; s < n; s += kThreads) w[s] = 0;
  for (int v = tid; v <= k; v += kThreads) ipv[v] = 0;
  for (int base = warp * 32; base < k; base += kThreads) {
    const int v = base + lane;
    const unsigned one = __ballot_sync(kFull, v < k && (__ldg(mb + v) & 1));
    if (lane == 0) bits[base >> 5] = one;
  }
  if (tid < kHeader) {
    hdr[tid] = tid == kM ? k : tid == kResult ? n : tid == kReal ? E : 0;
  }
  if (layout_only && E == 0) {
    for (int s = tid; s <= n; s += kThreads) ips[s] = 0;
  }
  __syncthreads();

  // One pass over the edges in symbol order (pads, symbol n, come last):
  // each symbol's degree, id sum and residual bit, the variables'
  // histogram, and where the real edges end. A warp takes kUnroll chunks
  // of 32 edges at a time and stops after a chunk that ends in pads.
  for (int base = warp * 32 * kUnroll; base < E;
       base += kThreads * kUnroll) {
    int sv[kUnroll], vv[kUnroll];
    int before = -1;
    if (lane == 0 && base > 0) before = min(__ldg(es + base - 1), n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + 32 * u + lane;
      sv[u] = e < E ? min(__ldg(es + e), n) : n;
      vv[u] = e < E ? __ldg(ev + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + 32 * u + lane;
      const int s = sv[u];
      const int carried = u ? __shfl_sync(kFull, sv[u > 0 ? u - 1 : 0], 31)
                            : before;
      int sp = __shfl_up_sync(kFull, s, 1);
      if (lane == 0) sp = carried;
      if (s == n && sp < n && e < E) hdr[kReal] = e;   // the first pad
      if (layout_only) {
        for (int t = sp + 1; t <= s; ++t) ips[t] = e;
        if (e == E - 1) {
          for (int t = s + 1; t <= n; ++t) ips[t] = E;
        }
      }
      const bool real = s < n;
      const int v = real ? vv[u] : 0;
      const bool one = real && ((bits[v >> 5] >> (v & 31)) & 1u);
      const unsigned ones = __ballot_sync(kFull, one);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || sp != s);
      const int s_dn = __shfl_down_sync(kFull, s, 1);
      int incl = v;   // ids summed over the lanes up to this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
      const int start = 31 - __clz(heads & upto);
      const int pre = __shfl_sync(kFull, incl, start > 0 ? start - 1 : 0);
      if (real) {
        atomicAdd(&ipv[v], 1);
        if (lane == 31 || s_dn != s) {
          // This lane ends its symbol's run in the chunk: one add for it.
          const unsigned run = upto & ~((1u << start) - 1u);
          const u64 sum = static_cast<u64>(incl - (start > 0 ? pre : 0));
          atomicAdd(&w[s], static_cast<u64>(__popc(run)) +
                               (sum << kSumShift) +
                               ((__popc(ones & run) & 1) ? kBit : 0ull));
        }
      }
    }
    if (__shfl_sync(kFull, sv[kUnroll - 1], 31) >= n) break;
  }
  __syncthreads();

  // Warp 0: the inclusive scan of the histogram (each bin becomes the end
  // of its variable's range). The others: an empty queue, clear bitmaps.
  if (warp == 0) {
    constexpr int kPer = 8;
    int carry = 0;
    for (int base = 0; base <= k; base += 32 * kPer) {
      int x[kPer];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = base + lane * kPer + i;
        x[i] = v <= k ? ipv[v] : 0;
        sum += x[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int run = carry + incl - sum;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = base + lane * kPer + i;
        run += x[i];
        if (v <= k) ipv[v] = run;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
  } else {
    for (int i = tid - 32; i < slots; i += kThreads - 32) q[i] = kEmpty;
    for (int i = tid - 32; i < 2 * kw; i += kThreads - 32) res[i] = 0;
  }
  __syncthreads();

  // The counting sort's scatter, and the first ripple: the prefix symbols
  // of degree 1, and the prefix's unresolved edges.
  Peel p{hdr, hdr, w, w, ipv, sbv, q, res, bits, n};
  const int n_real = hdr[kReal];
  for (int base = tid; base < n_real; base += kThreads * kUnroll) {
    int sv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + kThreads * u;
      if (e < n_real) {
        sv[u] = __ldg(es + e);
        vv[u] = __ldg(ev + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + kThreads * u < n_real) {
        sbv[atomicSub(&ipv[vv[u]], 1) - 1] = static_cast<uint16_t>(sv[u]);
      }
    }
  }
  {
    int deg_sum = 0;
    for (int s = tid; s < min(k, n); s += kThreads) {
      const int d = static_cast<int>(w[s] & kDeg);
      deg_sum += d;
      uint32_t item;
      if (d == 1 && p.claim(w[s], &item)) p.push_one(item);
    }
    if (deg_sum) atomicAdd(hdr + kActive, deg_sum);
  }
  __syncthreads();

  if (layout_only) {
    // The variable offsets as edge_layout gives them (pads in segment k),
    // and the pads after the real edges in sym_by_var.
    int* gv = indptr_var + static_cast<size_t>(b) * (k + 2);
    if (kShared) {
      for (int v = tid; v <= k; v += kThreads) gv[v] = ipv[v];
    }
    if (tid == 0) {
      ips[n + 1] = E;
      gv[k + 1] = E;
    }
    for (int e = n_real + tid; e < E; e += kThreads) {
      sbv[e] = static_cast<uint16_t>(n);
    }
    return;
  }

  if (warp < peel_warps) {
    volatile int* hdrv = hdr;
    if (warp == 0 && (hdrv[kQueue] & 0xffff) == 0) p.end_ripple(lane);
    for (;;) {
      int t = 0;
      if (lane == 0) t = atomicAdd(hdr + kTake, 1);
      t = __shfl_sync(kFull, t, 0);
      uint32_t item = kEmpty;
      if (lane == 0) {
        for (;;) {
          if (t < slots) item = p.q[t];
          if (item != kEmpty || hdrv[kDone]) break;
        }
      }
      item = __shfl_sync(kFull, item, 0);
      if (item == kEmpty) break;   // the sim is done
      __threadfence_block();
      const int m = hdrv[kM];
      const int retired = __reduce_add_sync(kFull, p.take(item, m, lane));
      __syncwarp();
      uint32_t left = 0;
      if (lane == 0) {
        if (retired) atomicSub(hdr + kActive, retired);
        __threadfence_block();
        left = atomicSub(reinterpret_cast<uint32_t*>(hdr + kQueue), 1u);
      }
      left = __shfl_sync(kFull, left, 0);
      if ((left & 0xffff) == 1) p.end_ripple(lane);   // the last in flight
    }
  }
  __syncthreads();

  if (tid == 0) {
    result[b] = hdr[kResult];
    rounds[b] = hdr[kRipples] + 1;
  }
  int* eb = est + static_cast<size_t>(b) * k;
  bool* rb = resolved + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += kThreads) {
    const uint32_t bit = 1u << (v & 31);
    rb[v] = (res[v >> 5] & bit) != 0;
    eb[v] = (bits[v >> 5] & bit) != 0;
  }
}

template <bool kShared>
cudaError_t launch(const int* es, const int* ev, const int* msg,
                   uint16_t* sbv,
                   u64* words, int* ipv, int* ips, int* result, int* est,
                   bool* resolved, int* rounds, int B, int E, int n, int k,
                   int peel_warps, int layout_only, cudaStream_t stream) {
  const size_t smem = shared_bytes(n, k, kShared);
  cudaError_t e = cudaFuncSetAttribute(
      lt_peel_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lt_peel_kernel<kShared><<<B, kThreads, smem, stream>>>(
      es, ev, msg, sbv, words, ipv, ips, result, est, resolved, rounds, E,
      n, k, peel_warps, layout_only);
  return cudaGetLastError();
}

}  // namespace

// The wrapper's scratch: sym_by_var [B, E] uint16 and indptr_var
// [B, k + 2] int32 always; the symbol words [B, n] int64 where they do not fit in
// shared memory (`on_chip` = 0), else unused; indptr_sym [B, n + 2] int32
// for a layout-only launch, else unused.
extern "C" int lt_peel_launch(const void* edge_sym, const void* edge_var,
                              const void* msg, void* sym_by_var, void* words,
                              void* indptr_var, void* indptr_sym,
                              void* result, void* est, void* resolved,
                              void* rounds, int B, int E, int n, int k,
                              int on_chip, int peel_warps, int layout_only,
                              void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n < 1 || n > kMaxSymbols || k < 1 || k >= kMaxVars || E < 0 ||
      peel_warps < 1 || peel_warps > kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* es = static_cast<const int*>(edge_sym);
  auto* ev = static_cast<const int*>(edge_var);
  auto* mb = static_cast<const int*>(msg);
  auto* sbv = static_cast<uint16_t*>(sym_by_var);
  auto* wd = static_cast<u64*>(words);
  auto* ipv = static_cast<int*>(indptr_var);
  auto* ips = static_cast<int*>(indptr_sym);
  auto* r = static_cast<int*>(result);
  auto* e = static_cast<int*>(est);
  auto* v = static_cast<bool*>(resolved);
  auto* rd = static_cast<int*>(rounds);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      on_chip ? launch<true>(es, ev, mb, sbv, wd, ipv, ips, r, e, v, rd, B, E,
                             n, k, peel_warps, layout_only, st)
              : launch<false>(es, ev, mb, sbv, wd, ipv, ips, r, e, v, rd, B,
                              E, n, k, peel_warps, layout_only, st);
  return static_cast<int>(rc);
}

extern "C" const char* lt_peel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
