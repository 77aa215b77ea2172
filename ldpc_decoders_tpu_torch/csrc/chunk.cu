// The Monte-Carlo chunk's work around its decode: two kernels that take the
// place of the eager PyTorch chain the runners ran there
// (harness/runner.py, harness/cap_sweep.py, harness/ensemble_runner.py).
//   - C1 transmit: codeword and channel draw -> channel symbols and/or
//     LLRs, in one pass;
//   - C2 tally: decision planes -> the packed int64 [wec, bec] tally (or
//     [2, P] over P planes), with the 2000-bin iteration histogram.
//
// They replace no Pallas kernel. In the JAX package the chunk body
// (ldpc_decoders_tpu/harness/runner.py:_chunk_body, jitted whole) leaves
// sample -> send -> llr -> decode -> tally to XLA, which fuses the
// elementwise work around the decode. Eagerly, the port spent about
// 0.73 ms of the flagship step's 1.63 ms of device time there, in some
// twenty small launches (PERF.md, section 5: the parent's rows).
// The draw stays PyTorch's (torch.randn / torch.rand / torch.randint on the
// runner's generator): golden z-checks and exact replays depend on its
// streams. C1 reads the draw; C2 reads the decisions.
//
// C1 equals ops/chunk_kernel.py:transmit_plain, the composition of the
// channel modules' own functions, bit for bit. Every product, sum and
// quotient is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn), as
// PyTorch's separate kernels round them: nvcc would otherwise contract
// (2x-1) + std*noise into one FMA. The channel constants (biAWGN's std and
// var, the BSC's base) are the plain code's own 0-dim device tensors, read
// through pointers; the erasure and flip threshold p is the float32 that
// PyTorch compares a float32 tensor with (the Python float rounded to
// nearest).
//   biAWGN: y = (2x-1) + std*noise,  llr = (-2*y) / var
//   BSC:    y = x ^ (u < p),         llr = base * (1 - 2y)
//   BEC:    y = u < p ? 2 : x,       llr = {1e8, -1e8, 0}[y]
// C2's sums are integers, equal in any order: per-row error counts by warp
// reductions, per-CTA sums in shared memory, one 64-bit atomic add per CTA
// and column into the output the launcher zeroes; the histogram counts in
// shared memory, then one add per nonzero bin and CTA.
//
// What bounds them on the card: bytes. At the flagship size (B = 16384,
// V = 1200) C1 reads the f32 draw and writes the f32 LLRs, 157.3 MB
// (0.047 ms at 3.35 TB/s); C2 reads one int32 plane, 78.6 MB (0.023 ms),
// or K planes of the cap sweep. Both move 16 bytes a thread a load where
// a row is a multiple of 4 wide (every plane then starts 16-byte aligned),
// one element a load otherwise, on a grid of a few CTAs per SM that
// strides over the planes. A codebook row (codeword -1) is read per
// element from L1/L2; the codeword plane is never built for 0 and 1.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHistLen = 2000;     // ops/chunk_kernel.py:HIST_LEN
constexpr float kSafeInf = 1e8f;   // channels/bec.py:SAFE_INF
constexpr int kCtasPerSm = 8;

enum Channel { kAwgn = 0, kBsc = 1, kBec = 2 };

enum Error {
  kBadChannel = -1,
  kBadVector = -2,
  kBadShape = -3,
  kBadColumns = -4,
};

struct TransmitArgs {
  const float* noise;     // [B*V] the draw: N(0,1) (biAWGN) or U[0,1)
  const long long* idx;   // [B] codebook rows (codeword -1), or null
  const int* cb;          // [M, V] the codebook, int32
  const float* a;         // biAWGN: std; BSC: base (0-dim device tensors)
  const float* b;         // biAWGN: var
  float p;                // BSC, BEC: the flip / erasure threshold
  int bit;                // the codeword's bits where idx is null
  float* llr;             // [B*V] f32, or null
  void* sym;              // [B*V] f32 (biAWGN) or int32, or null
  long long n;            // B*V
  int V;
};

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int grid_for(long long items_per_cta_unit, long long items) {
  long long ctas = (items + items_per_cta_unit - 1) / items_per_cta_unit;
  long long cap = static_cast<long long>(sm_count()) * kCtasPerSm;
  if (ctas > cap) ctas = cap;
  return ctas < 1 ? 1 : static_cast<int>(ctas);
}

template <int kChan>
__device__ __forceinline__ void channel_one(float u, int x, float a, float b,
                                            float p, float& y_f, int& y_i,
                                            float& llr) {
  if constexpr (kChan == kAwgn) {
    y_f = __fadd_rn(x ? 1.0f : -1.0f, __fmul_rn(a, u));
    llr = __fdiv_rn(__fmul_rn(-2.0f, y_f), b);
  } else if constexpr (kChan == kBsc) {
    y_i = x ^ static_cast<int>(u < p);
    llr = __fmul_rn(a, y_i ? -1.0f : 1.0f);
  } else {
    y_i = u < p ? 2 : x;
    llr = y_i == 0 ? kSafeInf : (y_i == 1 ? -kSafeInf : 0.0f);
  }
}

template <int kChan, int kVec, bool kBook>
__global__ void __launch_bounds__(kThreads)
transmit_kernel(const TransmitArgs q) {
  float a = 0.0f, b = 0.0f;
  if constexpr (kChan != kBec) a = __ldg(q.a);
  if constexpr (kChan == kAwgn) b = __ldg(q.b);
  const long long nv = q.n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
           + threadIdx.x; i < nv; i += stride) {
    const long long e = i * kVec;
    float u[kVec];
    int x[kVec];
    if constexpr (kVec == 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(q.noise) + i);
      u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
    } else {
      u[0] = __ldcs(q.noise + e);
    }
    if constexpr (kBook) {
      const long long row = e / q.V;
      const int* src = q.cb + __ldg(q.idx + row) * q.V + (e - row * q.V);
      if constexpr (kVec == 4) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(src));
        x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
      } else {
        x[0] = __ldg(src);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[k] = q.bit;
    }
    float y_f[kVec], llr[kVec];
    int y_i[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      y_f[k] = 0.0f;
      y_i[k] = 0;
      channel_one<kChan>(u[k], x[k], a, b, q.p, y_f[k], y_i[k], llr[k]);
    }
    if (q.llr != nullptr) {
      if constexpr (kVec == 4) {
        reinterpret_cast<float4*>(q.llr)[i] =
            make_float4(llr[0], llr[1], llr[2], llr[3]);
      } else {
        q.llr[e] = llr[0];
      }
    }
    if (q.sym != nullptr) {
      if constexpr (kChan == kAwgn) {
        float* s = static_cast<float*>(q.sym);
        if constexpr (kVec == 4) {
          reinterpret_cast<float4*>(s)[i] =
              make_float4(y_f[0], y_f[1], y_f[2], y_f[3]);
        } else {
          s[e] = y_f[0];
        }
      } else {
        int* s = static_cast<int*>(q.sym);
        if constexpr (kVec == 4) {
          reinterpret_cast<int4*>(s)[i] =
              make_int4(y_i[0], y_i[1], y_i[2], y_i[3]);
        } else {
          s[e] = y_i[0];
        }
      }
    }
  }
}

template <int kChan, int kVec, bool kBook>
int transmit_go(const TransmitArgs& q, cudaStream_t stream) {
  const long long nv = q.n / kVec;
  if (nv == 0) return 0;
  transmit_kernel<kChan, kVec, kBook>
      <<<grid_for(kThreads, nv), kThreads, 0, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int kChan>
int transmit_chan(const TransmitArgs& q, int vec, cudaStream_t stream) {
  const bool book = q.idx != nullptr;
  if (vec == 4) {
    return book ? transmit_go<kChan, 4, true>(q, stream)
                : transmit_go<kChan, 4, false>(q, stream);
  }
  return book ? transmit_go<kChan, 1, true>(q, stream)
              : transmit_go<kChan, 1, false>(q, stream);
}

struct TallyArgs {
  const void* planes;     // [P, B, V] int32 or f32 decisions
  const int* raw;         // [B, V] int32 symbols tallied first, or null
  const long long* idx;   // [B] codebook rows (codeword -1), or null
  const int* cb;          // [M, V]
  const int* iters;       // [B] int32 iteration counts, or null
  unsigned long long* out;  // [2, cols] (+ kHistLen), zeroed
  int bit;
  int B, V, P;
  int first;              // 1: column 0 is raw or all-wrong, 0: none
  int all_wrong;          // column 0: every bit of every word wrong
  int cols;               // first + P
};

template <typename T, int kVec>
__device__ __forceinline__ int row_errors(const T* row, const int* xrow,
                                          int bit, int V, int lane) {
  int errs = 0;
  const int nv = V / kVec;
#pragma unroll 4
  for (int c = lane; c < nv; c += 32) {
    T h[kVec];
    int x[kVec];
    if constexpr (kVec == 4) {
      if constexpr (std::is_same<T, float>::value) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(row) + c);
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      } else {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(row) + c);
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      }
      if (xrow != nullptr) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(xrow) + c);
        x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
      }
    } else {
      h[0] = row[c];
      if (xrow != nullptr) x[0] = __ldg(xrow + c);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int xk = xrow != nullptr ? x[k] : bit;
      errs += h[k] != static_cast<T>(xk);
    }
  }
  return errs;
}

template <typename T, int kVec, bool kBook>
__global__ void __launch_bounds__(kThreads) tally_kernel(const TallyArgs q) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_wec = smem;
  unsigned long long* s_bec = smem + q.cols;
  int* s_hist = reinterpret_cast<int*>(smem + 2 * q.cols);
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * q.cols; i += kThreads) smem[i] = 0;
  if (q.iters != nullptr) {
    for (int i = tid; i < kHistLen; i += kThreads) s_hist[i] = 0;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int has_raw = q.raw != nullptr;
  const long long plane_elems = static_cast<long long>(q.B) * q.V;
  const long long rows = static_cast<long long>(q.P + has_raw) * q.B;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (tid >> 5);
       r < rows; r += static_cast<long long>(gridDim.x) * kWarps) {
    const int plane = static_cast<int>(r / q.B);
    const long long b = r - static_cast<long long>(plane) * q.B;
    const T* row = plane < has_raw
        ? reinterpret_cast<const T*>(q.raw) + b * q.V
        : static_cast<const T*>(q.planes)
              + (plane - has_raw) * plane_elems + b * q.V;
    const int* xrow = kBook ? q.cb + __ldg(q.idx + b) * q.V : nullptr;
    int errs = row_errors<T, kVec>(row, xrow, q.bit, q.V, lane);
    errs = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(errs));
    if (lane == 0 && errs != 0) {
      const int col = plane + q.all_wrong;
      atomicAdd(s_wec + col, 1ull);
      atomicAdd(s_bec + col, static_cast<unsigned long long>(errs));
    }
  }
  if (q.iters != nullptr) {
    for (long long b = static_cast<long long>(blockIdx.x) * kThreads + tid;
         b < q.B; b += static_cast<long long>(gridDim.x) * kThreads) {
      const int it = __ldg(q.iters + b);
      atomicAdd(s_hist + (it < 0 ? 0 : (it >= kHistLen ? kHistLen - 1 : it)),
                1);
    }
  }
  __syncthreads();
  if (q.all_wrong && blockIdx.x == 0 && tid == 0) {
    q.out[0] = static_cast<unsigned long long>(q.B);
    q.out[q.cols] = static_cast<unsigned long long>(plane_elems);
  }
  for (int i = tid; i < q.cols; i += kThreads) {
    if (s_wec[i] != 0) atomicAdd(q.out + i, s_wec[i]);
    if (s_bec[i] != 0) atomicAdd(q.out + q.cols + i, s_bec[i]);
  }
  if (q.iters != nullptr) {
    for (int i = tid; i < kHistLen; i += kThreads) {
      if (s_hist[i] != 0) {
        atomicAdd(q.out + 2 * q.cols + i,
                  static_cast<unsigned long long>(s_hist[i]));
      }
    }
  }
}

template <typename T, int kVec, bool kBook>
int tally_go(const TallyArgs& q, size_t smem, cudaStream_t stream) {
  const long long rows = static_cast<long long>(q.P + (q.raw != nullptr))
                         * q.B;
  tally_kernel<T, kVec, kBook>
      <<<grid_for(kWarps, rows), kThreads, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tally_type(const TallyArgs& q, int vec, size_t smem,
               cudaStream_t stream) {
  const bool book = q.idx != nullptr;
  if (vec == 4) {
    return book ? tally_go<T, 4, true>(q, smem, stream)
                : tally_go<T, 4, false>(q, smem, stream);
  }
  return book ? tally_go<T, 1, true>(q, smem, stream)
              : tally_go<T, 1, false>(q, smem, stream);
}

}  // namespace

extern "C" {

// C1 on ``stream``: ``chan`` 0 biAWGN, 1 BSC, 2 BEC; ``llr`` and ``sym``
// may each be null (not both); ``vec`` 4 where V % 4 == 0 and every
// pointer is 16-byte aligned, else 1. Returns 0 or an error code.
int chunk_transmit_launch(int chan, const float* noise, int bit,
                          const long long* idx, const int* cb,
                          const float* a, const float* b, float p,
                          float* llr, void* sym, long long n, int V, int vec,
                          void* stream) {
  if (vec != 1 && !(vec == 4 && V % 4 == 0)) return kBadVector;
  if (V < 1 || n < 0 || n % V != 0 || (llr == nullptr && sym == nullptr)) {
    return kBadShape;
  }
  const TransmitArgs q{noise, idx, cb, a, b, p, bit, llr, sym, n, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chan) {
    case kAwgn: return transmit_chan<kAwgn>(q, vec, s);
    case kBsc: return transmit_chan<kBsc>(q, vec, s);
    case kBec: return transmit_chan<kBec>(q, vec, s);
    default: return kBadChannel;
  }
}

// C2 on ``stream``: zeroes ``out`` ([2, first + P], plus kHistLen where
// ``iters`` is given) and tallies into it. ``is_float``: the planes are
// f32 (ADMM's pseudo-codewords), else int32; ``raw`` (int32 planes only)
// or ``all_wrong`` fills column 0. Returns 0 or an error code.
int chunk_tally_launch(const void* planes, int is_float, const int* raw,
                       int all_wrong, int bit, const long long* idx,
                       const int* cb, const int* iters, int B, int V, int P,
                       int vec, unsigned long long* out, void* stream) {
  if (vec != 1 && !(vec == 4 && V % 4 == 0)) return kBadVector;
  if (B < 0 || V < 1 || P < 0 || (raw != nullptr && is_float)) {
    return kBadShape;
  }
  const int first = (raw != nullptr || all_wrong) ? 1 : 0;
  const int cols = first + P;
  if (cols < 1 || (iters != nullptr && cols != 1)) {
    return kBadColumns;
  }
  const size_t smem = sizeof(unsigned long long) * 2 * cols
                      + (iters != nullptr ? sizeof(int) * kHistLen : 0);
  if (smem > 48 * 1024) return kBadColumns;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = sizeof(unsigned long long)
                           * (2 * cols + (iters != nullptr ? kHistLen : 0));
  cudaError_t rc = cudaMemsetAsync(out, 0, out_bytes, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const TallyArgs q{planes, raw, idx, cb, iters, out, bit, B, V, P,
                    first, all_wrong ? 1 : 0, cols};
  return is_float ? tally_type<float>(q, vec, smem, s)
                  : tally_type<int>(q, vec, smem, s);
}

const char* chunk_error_string(int rc) {
  switch (rc) {
    case kBadChannel: return "unknown channel";
    case kBadVector: return "vector width 4 needs rows a multiple of 4 wide";
    case kBadShape: return "bad shape, or no output asked for";
    case kBadColumns:
      return "no tally column, more than shared memory holds, or a "
             "histogram beside several columns";
    default: return cudaGetErrorString(static_cast<cudaError_t>(rc));
  }
}

}  // extern "C"
