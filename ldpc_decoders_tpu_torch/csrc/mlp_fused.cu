// ADMMA's MLP (decoders/admma.py: relu hidden layers, a sigmoid output,
// layer i computing x @ w{i} + b{i} with w{i} [n_in, n_out]) as one fused
// kernel whose products run on the tensor cores in split TF32 at float32
// accuracy. Two entry points:
//   - forward (eval): rows [R, D] -> sigmoid(...relu(x @ w0 + b0)...);
//   - train: the forward, the loss mean((out - target)^2) and its gradient
//     with respect to every w{i} and b{i}. Each CTA writes its partial
//     gradients and its partial sum of squares to a [G, P] buffer (P = the
//     parameter count + 1, in the order w0, b0, w1, b1, ..., then the sum);
//     a second launch (mlp_reduce_kernel) sums them over G in a fixed order:
//     lane l of the warp of a parameter adds rows l, l + 32, ... in
//     ascending order, then the 32 lanes are halved. No float atomics, a
//     static assignment of row tiles to CTAs: two runs give the same bits.
// It replaces the JAX package's XLA products (ldpc_decoders_tpu/decoders/
// admma.py:56, mlp_apply, under jax.grad in train mode); the JAX package
// has no Pallas kernel for it. The plain version is the MLP's own forward
// with autograd's backward in true float32 (ops/mlp_kernel.py:
// mlp_forward_plain, mlp_train_plain); the two agree within 1e-5, not bit
// for bit.
//
// Split TF32 ("3xTF32"). A TF32 value keeps 11 significant bits. Each
// float32 operand x is split into big = tf32(x) (to nearest, ties away, as
// an integer add and mask) and small = tf32(x - big), the rest being exact
// in float32; then x = big + small up to 2^-22 |x|. A product a b is taken
// as small_a big_b + big_a small_b + big_a big_b (small_a small_b, below
// 2^-22 |a b|, is dropped), three mma.sync.m16n8k8 TF32 products with
// float32 accumulation, the small terms first. A product thus carries up
// to ~2^-21 of itself, where an FFMA rounds to 2^-24: float32 accuracy in
// the sense of CUTLASS's 3xTF32, not float32's rounding. Each product's
// accumulator starts at 0 and sums one layer's K (or one row tile), and
// the bias, the running gradient sums and the epilogues are IEEE float32
// (__fadd_rn). The forward stays within 1e-5 absolute of the true-float32
// plain MLP, the loss and gradients within 1e-5 relative (chip_smoke.py
// phase 7 on ADMMA's rows; tests/test_torch_admma.py emulates the split on
// the CPU against the JAX package). Where a hidden pre-activation lies
// within rounding of 0, the kernel and the float32 plain MLP may decide
// its relu differently, and over ~10^5 rows one such decision moves a
// summed gradient by ~1e-5 relative; float32 itself does so against
// float64. tests/test_torch_cuda.py therefore holds the gradients against
// the plain MLP in float64 on rows with no such tie.
//
// What bounds it on the card: operations. ADMMA's [6, 100, 100, 6] does
// 2 * (6*100 + 100*100 + 100*6) = 22,400 flops per row forward and about
// twice that backward, over 2.46 M rows an iteration at B=4096 on
// LDPC(1200,3,6); in split TF32 each multiply-add is three tensor-core
// ones. Its bytes are the rows in and out. A tile of rows keeps every
// activation (and in train mode every gradient of one) in shared memory,
// beside the weights, staged once per CTA, and the CTA's partial
// gradients; CTAs are persistent, one wave, each walking tiles blockIdx.x,
// + gridDim.x, ...; the forward fetches a tile's rows (cp.async) while the
// tile before runs its last layer.
//
// The products of a layer, with activations and gradients kept row-major
// [tile rows][ld]:
//   - forward  act'[r][j] = f(sum over k of act[r][k] w[k][j] + b[j]);
//   - backward d[r][k] = (sum over j of d'[r][j] w[k][j]) where act > 0,
//              written over act in place once dw has read it, and
//              dw[k][j] += sum over r of act[r][k] d'[r][j], db[j] with
//              it as the row k = n_in, a column of 1s beside act.
// Each is C[m][n] = sum over k of A(m, k) B(k, n), cut into 16 x 8 blocks
// of C (mma.sync.m16n8k8); a warp takes up to 2 x 4 of them (the groups
// balanced, tasks ordered so that the warps of one SM sub-partition hold
// different column groups), and per step of 8 along k loads its A and B
// fragments from shared memory and splits them. A task's block counts are
// template arguments, so its inner loop has no branch; a task of one or
// two blocks (the 6-wide layers) sums the three products and alternate
// steps into six sets of accumulators, to shorten its chain of dependent
// products. A lane's two k slots of a step are (2t, 2t + 1) where A is
// stored along k (one 8-byte load a row), else (t, t + 4); both operands
// take the same pair, which leaves the sum unchanged. The row strides make
// every fragment load free of bank conflicts but one: activations and
// gradients ld % 16 == 8 (8-byte loads along k at rows g, and 4-byte loads
// at rows t, t + 4), weights ld % 8 == 4 (4-byte loads at rows 2t, 2t + 1);
// the backward's 8-byte loads of the weights along their rows meet two-way
// conflicts. Out-of-range rows and columns read a clamped address and are
// not stored; padded k slots (6 -> 8, 100 -> 104) read as 0 in the last
// step along k and are never stored.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/
// profile_mlp_kernel.py, 2,457,600 rows): forward 1.85 ms, train 5.98 ms;
// the FFMA form before it 2.43-2.53 and 9.14-9.63 in the same process.
// Slower beside this form, and not kept: a predicate on every mma (each
// became WARPSYNC, NOP, HMMA), cvt.rna.tf32 (four instructions with its
// inf test), zeros kept in the padded k slots in place of the last step's
// masks, 16 forward warps at 128 rows, 8 train warps, the k loop unrolled
// twice; and, for the relu ties above, the training pass's hidden layers in
// six products (each operand split exactly in three): train +13%, and a
// tie still went the other way.
//
// The row tile is the first of the wrapper's list (ops/mlp_kernel.py:
// mlp_plan, the same formula as smem_floats below) whose layout fits the
// 227 KB of shared memory a block can have; a net that does not fit at 8
// rows, with unpadded strides, is refused. The 8-row layout takes every
// net the FFMA form took.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kFwdWarps = 8;            // two CTAs an SM at [6, 100, 100, 6]
constexpr int kTrainWarps = 16;         // one CTA an SM
constexpr unsigned kAll = 0xffffffffu;

struct Net {
  int n_layers;                         // weight matrices
  int sizes[kMaxLayers + 1];            // widths, input first
  const float* w[kMaxLayers];           // [sizes[l], sizes[l + 1]]
  const float* b[kMaxLayers];           // [sizes[l + 1]]
  bool pad;                             // row strides padded (tile >= 16)
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// Row strides. At tiles of 16 rows or more (net.pad): an activation or
// gradient buffer of n columns ld % 16 == 8, a staged weight matrix of
// n_out columns ld % 8 == 4, the CTA's gradients ld_a(n_out). At 8 rows,
// the last resort for wide nets, none of that padding: activations and
// weights n rounded up to 8 (the last k-step's 8-byte loads stay in the
// row), the gradients n_out; their fragment loads then meet bank
// conflicts.
__host__ __device__ inline int ld_a(const Net& net, int n) {
  const int x = round_up(n, 8);
  return !net.pad || x % 16 == 8 ? x : x + 8;
}
__host__ __device__ inline int ld_w(const Net& net, int n_out) {
  return round_up(n_out, 8) + (net.pad ? 4 : 0);
}
__host__ __device__ inline int ld_g(const Net& net, int n_out) {
  return net.pad ? ld_a(net, n_out) : n_out;
}

__host__ __device__ inline int widest(const Net& net, int first) {
  int m = 1;
  for (int l = first; l <= net.n_layers; ++l) {
    m = net.sizes[l] > m ? net.sizes[l] : m;
  }
  return m;
}

// Train: layer l's activations, and the column of 1s beside them but the
// output's.
__host__ __device__ inline int ld_act(const Net& net, int l) {
  return ld_a(net, net.sizes[l] + (l < net.n_layers ? 1 : 0));
}

// Offsets (in floats, each a multiple of 4) of the shared-memory layout.
struct Layout {
  int w[kMaxLayers], b[kMaxLayers];     // staged weights and biases
  int act[kMaxLayers + 1];              // train: every layer's activations
                                        // (in the backward its gradient)
  int buf[2];                           // eval: two activation buffers
  int sq;                               // train: squared errors of a tile
  int gw[kMaxLayers];                   // train: the CTA's gradients, each
                                        // layer's b as w's row n_in
};

__host__ __device__ inline int take(long long* off, long long n) {
  const int at = static_cast<int>(*off);
  *off += (n + 3) / 4 * 4;
  return at;
}

// The layout's size in floats; fills lay where given.
__host__ __device__ inline long long smem_floats(const Net& net, int tile,
                                                 bool train, Layout* lay) {
  Layout t;
  long long off = 0;
  const int L = net.n_layers;
  const int* s = net.sizes;
  for (int l = 0; l < L; ++l) {
    t.w[l] = take(&off,
                  static_cast<long long>(s[l]) * ld_w(net, s[l + 1]));
    t.b[l] = take(&off, s[l + 1]);
  }
  if (!train) {
    const long long buf =
        static_cast<long long>(tile) * ld_a(net, widest(net, 0));
    t.buf[0] = take(&off, buf);
    t.buf[1] = take(&off, buf);
  } else {
    for (int l = 0; l <= L; ++l) {
      t.act[l] = take(&off, static_cast<long long>(tile) * ld_act(net, l));
    }
    t.sq = take(&off, static_cast<long long>(tile) * s[L]);
    for (int l = 0; l < L; ++l) {
      t.gw[l] = take(&off,
                     static_cast<long long>(s[l] + 1) * ld_g(net, s[l + 1]));
    }
  }
  if (lay != nullptr) *lay = t;
  return off;
}

enum Epilogue {
  kRelu,          // c = max(acc + bias[n], 0)
  kSigmoid,       // c = sigmoid(acc + bias[n])
  kReluMask,      // c = acc where c > 0, else 0 (in place)
  kAccumulate,    // c += acc
};

// The destination of C[m][n]: c[m * ld + n].
struct Out {
  float* c;
  int ld;
  const float* bias;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int kEpi>
__device__ __forceinline__ void store(const Out& o, int m, int n, float y) {
  float* dst = o.c + m * o.ld + n;
  if (kEpi == kRelu) {
    *dst = fmaxf(__fadd_rn(y, o.bias[n]), 0.f);
  } else if (kEpi == kSigmoid) {
    *dst = sigmoid(__fadd_rn(y, o.bias[n]));
  } else if (kEpi == kReluMask) {
    *dst = *dst > 0.f ? y : 0.f;
  } else {
    *dst = __fadd_rn(*dst, y);
  }
}

// TF32 rounding of a finite float32 value, to nearest with ties away from
// zero (cvt.rna's rounding, without its test for inf and NaN): add half of
// the 13 dropped bits' unit, then clear them.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + (at most 2^-22 |x|). small's 13 low bits are left
// uncleared: the tensor cores ignore them.
__device__ __forceinline__ void split(float x, uint32_t* big,
                                      uint32_t* small) {
  *big = to_tf32(x);
  *small = __float_as_uint(__fsub_rn(x, __uint_as_float(*big))) + 0x1000u;
}

// c += a b on one 16 x 8 block: a[0..3] A(g, lo), A(g + 8, lo), A(g, hi),
// A(g + 8, hi); b[0..1] B(lo, g), B(hi, g); c[0..3] C(g, 2t), C(g, 2t + 1),
// C(g + 8, 2t), C(g + 8, 2t + 1), for g = lane / 4, t = lane % 4 and the
// lane's k slots lo, hi.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A lane's k slots in the step at k0: (2t, 2t + 1) where A is stored along
// k (kPi), else (t, t + 4).
template <bool kPi>
__device__ __forceinline__ int k_lo(int k0, int t) {
  return k0 + (kPi ? 2 * t : t);
}
template <bool kPi>
__device__ __forceinline__ int k_hi(int k0, int t) {
  return k0 + (kPi ? 2 * t + 1 : t + 4);
}

// A's fragment at rows m0 (g) and m1 (g + 8), both clamped: stored [m][k]
// (kAk; the pair along k is one 8-byte load) or [k][m]. In the last step
// (kTail) slots at or past K read 0.
template <bool kAk, bool kTail>
__device__ __forceinline__ void load_a(const float* A, int ld, int m0, int m1,
                                       int k0, int K, int t, float* a) {
  const int lo = k_lo<kAk>(k0, t), hi = k_hi<kAk>(k0, t);
  if (kAk) {
    const float2 x = *reinterpret_cast<const float2*>(A + m0 * ld + lo);
    const float2 y = *reinterpret_cast<const float2*>(A + m1 * ld + lo);
    a[0] = x.x;
    a[1] = y.x;
    a[2] = x.y;
    a[3] = y.y;
  } else {
    const int rl = kTail ? min(lo, K - 1) : lo;
    const int rh = kTail ? min(hi, K - 1) : hi;
    a[0] = A[rl * ld + m0];
    a[1] = A[rl * ld + m1];
    a[2] = A[rh * ld + m0];
    a[3] = A[rh * ld + m1];
  }
  if (kTail) {
    if (lo >= K) a[0] = a[1] = 0.f;
    if (hi >= K) a[2] = a[3] = 0.f;
  }
}

// B's fragment at column n (g, clamped): stored [n][k] (kBk, which needs
// the pair along k: kPi) or [k][n].
template <bool kBk, bool kPi, bool kTail>
__device__ __forceinline__ void load_b(const float* B, int ld, int n, int k0,
                                       int K, int t, float* b) {
  static_assert(kPi || !kBk, "B stored along k takes the slots (2t, 2t+1)");
  const int lo = k_lo<kPi>(k0, t), hi = k_hi<kPi>(k0, t);
  if (kBk) {
    const float2 x = *reinterpret_cast<const float2*>(B + n * ld + lo);
    b[0] = x.x;
    b[1] = x.y;
  } else {
    const int rl = kTail ? min(lo, K - 1) : lo;
    const int rh = kTail ? min(hi, K - 1) : hi;
    b[0] = B[rl * ld + n];
    b[1] = B[rh * ld + n];
  }
  if (kTail) {
    if (lo >= K) b[0] = 0.f;
    if (hi >= K) b[1] = 0.f;
  }
}

// Where a warp's MC x NC blocks read: rows rm[i][0] (g) and rm[i][1] (g +
// 8) of A, clamped; columns cn[j] (g) of B, clamped.
template <int MC, int NC>
struct Frame {
  int rm[MC][2], cn[NC];
};

// One step of 8 along k for a warp's MC x NC blocks: load, split, then the
// three products, small terms first, each into its own accumulators (the
// same ones where the three are given the same).
template <bool kAk, bool kBk, bool kTail, int MC, int NC>
__device__ __forceinline__ void mma_step(const float* A, int lda,
                                         const float* B, int ldb,
                                         const Frame<MC, NC>& f, int k0,
                                         int K, int t, float (*c_sb)[NC][4],
                                         float (*c_bs)[NC][4],
                                         float (*c_bb)[NC][4]) {
  uint32_t ab[MC][4], as[MC][4], bb[NC][2], bs[NC][2];
#pragma unroll
  for (int i = 0; i < MC; ++i) {
    float a[4];
    load_a<kAk, kTail>(A, lda, f.rm[i][0], f.rm[i][1], k0, K, t, a);
#pragma unroll
    for (int q = 0; q < 4; ++q) split(a[q], &ab[i][q], &as[i][q]);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float b[2];
    load_b<kBk, kAk, kTail>(B, ldb, f.cn[j], k0, K, t, b);
    split(b[0], &bb[j][0], &bs[j][0]);
    split(b[1], &bb[j][1], &bs[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MC; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) mma_tf32(c_sb[i][j], as[i], bb[j]);
  }
#pragma unroll
  for (int i = 0; i < MC; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) mma_tf32(c_bs[i][j], ab[i], bs[j]);
  }
#pragma unroll
  for (int i = 0; i < MC; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) mma_tf32(c_bb[i][j], ab[i], bb[j]);
  }
}

// One warp task: the MC x NC blocks from row block mb0 and column block
// nb0, summed over K, then the epilogue. The counts are compile-time, so
// the inner loop holds no branch.
template <int kEpi, bool kAk, bool kBk, int MC, int NC>
__device__ __forceinline__ void warp_task(const float* A, int lda,
                                          const float* B, int ldb, int M,
                                          int N, int K, int mb0, int nb0,
                                          const Out& o) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Frame<MC, NC> f;
#pragma unroll
  for (int i = 0; i < MC; ++i) {
    f.rm[i][0] = min((mb0 + i) * 16 + g, M - 1);
    f.rm[i][1] = min((mb0 + i) * 16 + g + 8, M - 1);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) f.cn[j] = min((nb0 + j) * 8 + g, N - 1);
  float acc[MC][NC][4];
  const int K8 = K & ~7;
  if constexpr (MC * NC <= 2) {
    // Few blocks: the three products of a step, and alternate steps, into
    // six sets of accumulators, so that no chain of dependent products is
    // longer than K / 16.
    float c[6][MC][NC][4];
#pragma unroll
    for (int u = 0; u < 6; ++u) {
#pragma unroll
      for (int i = 0; i < MC; ++i) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) c[u][i][j][q] = 0.f;
        }
      }
    }
    int k0 = 0;
    for (; k0 + 16 <= K8; k0 += 16) {
      mma_step<kAk, kBk, false, MC, NC>(A, lda, B, ldb, f, k0, K, t, c[0],
                                        c[1], c[2]);
      mma_step<kAk, kBk, false, MC, NC>(A, lda, B, ldb, f, k0 + 8, K, t,
                                        c[3], c[4], c[5]);
    }
    if (k0 < K8) {
      mma_step<kAk, kBk, false, MC, NC>(A, lda, B, ldb, f, k0, K, t, c[0],
                                        c[1], c[2]);
    }
    if (K8 < K) {
      mma_step<kAk, kBk, true, MC, NC>(A, lda, B, ldb, f, K8, K, t, c[3],
                                       c[4], c[5]);
    }
#pragma unroll
    for (int i = 0; i < MC; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float small =
              __fadd_rn(__fadd_rn(c[0][i][j][q], c[1][i][j][q]),
                        __fadd_rn(c[3][i][j][q], c[4][i][j][q]));
          acc[i][j][q] = __fadd_rn(__fadd_rn(c[2][i][j][q], c[5][i][j][q]),
                                   small);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MC; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
      }
    }
    for (int k0 = 0; k0 < K8; k0 += 8) {
      mma_step<kAk, kBk, false, MC, NC>(A, lda, B, ldb, f, k0, K, t, acc,
                                        acc, acc);
    }
    if (K8 < K) {
      mma_step<kAk, kBk, true, MC, NC>(A, lda, B, ldb, f, K8, K, t, acc, acc,
                                       acc);
    }
  }
  // The epilogue: without a test per value where every block lies in range.
  const bool full = (mb0 + MC) * 16 <= M && (nb0 + NC) * 8 <= N;
#pragma unroll
  for (int i = 0; i < MC; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = (mb0 + i) * 16 + g + (q >= 2 ? 8 : 0);
        const int n = (nb0 + j) * 8 + 2 * t + (q & 1);
        if (full || (m < M && n < N)) store<kEpi>(o, m, n, acc[i][j][q]);
      }
    }
  }
}

// warp_task at the task's own counts mc <= MC, nc <= NC.
template <int kEpi, bool kAk, bool kBk, int MC, int NC>
__device__ __forceinline__ void warp_task_at(int mc, int nc, const float* A,
                                             int lda, const float* B,
                                             int ldb, int M, int N, int K,
                                             int mb0, int nb0, const Out& o) {
  if constexpr (MC > 1) {
    if (mc < MC) {
      warp_task_at<kEpi, kAk, kBk, MC - 1, NC>(mc, nc, A, lda, B, ldb, M, N,
                                               K, mb0, nb0, o);
      return;
    }
  }
  if constexpr (NC > 1) {
    if (nc < NC) {
      warp_task_at<kEpi, kAk, kBk, MC, NC - 1>(mc, nc, A, lda, B, ldb, M, N,
                                               K, mb0, nb0, o);
      return;
    }
  }
  warp_task<kEpi, kAk, kBk, MC, NC>(A, lda, B, ldb, M, N, K, mb0, nb0, o);
}

// C = A B (epilogue), M x N over K, by the CTA's warps: the 16-row blocks
// in n_mg groups of at most MT, the 8-column blocks in n_ng groups of at
// most NT (group sizes differ by one at most); task = mg + n_mg * ng, so
// that warps w, w + 4, ... (one SM sub-partition) take different column
// groups.
template <int kEpi, bool kAk, bool kBk, int MT, int NT>
__device__ void tiled_product(const float* A, int lda, const float* B,
                              int ldb, int M, int N, int K, const Out& o) {
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_mb = (M + 15) >> 4, n_nb = (N + 7) >> 3;
  const int n_mg = (n_mb + MT - 1) / MT, n_ng = (n_nb + NT - 1) / NT;
  for (int task = warp; task < n_mg * n_ng; task += n_warps) {
    const int mg = task % n_mg, ng = task / n_mg;
    const int mb0 = mg * n_mb / n_mg, mc = (mg + 1) * n_mb / n_mg - mb0;
    const int nb0 = ng * n_nb / n_ng, nc = (ng + 1) * n_nb / n_ng - nb0;
    warp_task_at<kEpi, kAk, kBk, MT, NT>(mc, nc, A, lda, B, ldb, M, N, K,
                                         mb0, nb0, o);
  }
}

// C = A B (epilogue): a warp's tile 2 x 4 blocks where there are four
// column blocks or more (one row of blocks where M <= 16), else one block.
template <int kEpi, bool kAk, bool kBk>
__device__ __forceinline__ void product(const float* A, int lda,
                                        const float* B, int ldb, int M, int N,
                                        int K, const Out& o) {
  if (N > 24) {
    if (M > 16) {
      tiled_product<kEpi, kAk, kBk, 2, 4>(A, lda, B, ldb, M, N, K, o);
    } else {
      tiled_product<kEpi, kAk, kBk, 1, 4>(A, lda, B, ldb, M, N, K, o);
    }
  } else {
    tiled_product<kEpi, kAk, kBk, 1, 1>(A, lda, B, ldb, M, N, K, o);
  }
}

// Weights into [n_in][ld_w(n_out)] rows (the padding is never read
// unmasked), and the biases.
__device__ void stage_weights(const Net& net, const Layout& lay, float* sm) {
  for (int l = 0; l < net.n_layers; ++l) {
    const int n_in = net.sizes[l], n_out = net.sizes[l + 1];
    const int ld = ld_w(net, n_out);
    for (int e = threadIdx.x; e < n_in * n_out; e += blockDim.x) {
      sm[lay.w[l] + e / n_out * ld + e % n_out] = net.w[l][e];
    }
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      sm[lay.b[l] + e] = net.b[l][e];
    }
  }
}

// Copies from device to shared memory that land while the CTA computes
// (cp.async, 4 bytes each): issue, close the group, wait for the thread's
// own (a barrier then shows them to the others).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A tile's rows [rows][s0] of x into act [rows][ld], asynchronously.
__device__ __forceinline__ void rows_async(const float* x, float* act,
                                           int rows, int s0, int ld) {
  for (int e = threadIdx.x; e < rows * s0; e += blockDim.x) {
    copy_async(act + e / s0 * ld + e % s0, x + e);
  }
  copy_async_commit();
}

// Layer l forward, act [rows][ld_in] -> o (relu, or sigmoid for the last).
template <int kEpi>
__device__ __forceinline__ void layer_forward(const Net& net,
                                              const Layout& lay,
                                              const float* sm, int l,
                                              const float* act, int ld_in,
                                              int rows, const Out& o) {
  const int n_in = net.sizes[l], n_out = net.sizes[l + 1];
  product<kEpi, true, false>(act, ld_in, sm + lay.w[l], ld_w(net, n_out),
                             rows, n_out, n_in, o);
}

__global__ void __launch_bounds__(kFwdWarps * 32, 2)
mlp_forward_kernel(Net net, const float* __restrict__ x,
                   float* __restrict__ out, long long R, int tile) {
  extern __shared__ __align__(16) float sm[];
  Layout lay;
  smem_floats(net, tile, false, &lay);
  const int L = net.n_layers;
  const int* s = net.sizes;
  const int ld = ld_a(net, widest(net, 0));
  stage_weights(net, lay, sm);
  const long long n_tiles = (R + tile - 1) / tile;
  auto rows_of = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(tile), R - t * tile));
  };
  // Each tile's rows are fetched while the tile before computes, into the
  // buffer its last layer does not read; the first tile's now.
  float* cur = sm + lay.buf[0];
  float* nxt = sm + lay.buf[1];
  if (blockIdx.x < n_tiles) {
    rows_async(x + blockIdx.x * tile * s[0], cur, rows_of(blockIdx.x), s[0],
               ld);
  }
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = rows_of(t);
    // This tile's rows have landed, and the tile before read its buffers
    // until its end.
    copy_async_wait();
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float* bias = sm + lay.b[l];
      if (l + 1 < L) {
        layer_forward<kRelu>(net, lay, sm, l, cur, ld, rows,
                             Out{nxt, ld, bias});
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      } else {
        // The last layer reads cur only: nxt takes the next tile's rows.
        const long long tn = t + gridDim.x;
        if (tn < n_tiles) {
          rows_async(x + tn * tile * s[0], nxt, rows_of(tn), s[0], ld);
        }
        // The output rows [rows][s_L] straight to device memory.
        layer_forward<kSigmoid>(net, lay, sm, l, cur, ld, rows,
                                Out{out + row0 * s[L], s[L], bias});
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
  }
}

// gscale = 2 / (R * D): the gradient of the mean with respect to an output
// is gscale * (out - target).
__global__ void __launch_bounds__(kTrainWarps * 32, 1)
mlp_train_kernel(Net net, const float* __restrict__ x,
                 const float* __restrict__ target,
                 float* __restrict__ partial, long long R, int tile,
                 float gscale, int P) {
  extern __shared__ __align__(16) float sm[];
  Layout lay;
  smem_floats(net, tile, true, &lay);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = net.n_layers;
  const int* s = net.sizes;
  stage_weights(net, lay, sm);
  for (int l = 0; l < L; ++l) {
    // dw and db, zeroed; the column of 1s beside each layer's input, by
    // which the weight gradient's product also sums db over the rows.
    const int n = (s[l] + 1) * ld_g(net, s[l + 1]);
    for (int e = threadIdx.x; e < n; e += blockDim.x) sm[lay.gw[l] + e] = 0.f;
    for (int r = threadIdx.x; r < tile; r += blockDim.x) {
      sm[lay.act[l] + r * ld_act(net, l) + s[l]] = 1.f;
    }
  }
  float loss = 0.f;                     // warp 0
  const long long n_tiles = (R + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = static_cast<int>(min(static_cast<long long>(tile),
                                          R - row0));
    // The previous tile's backward pass read act[0] until its end. Rows
    // past the last are 0: the products run over the whole tile.
    __syncthreads();
    {
      float* a0 = sm + lay.act[0];
      const int ld0 = ld_act(net, 0);
      const float* xt = x + row0 * s[0];
      for (int e = threadIdx.x; e < tile * s[0]; e += blockDim.x) {
        a0[e / s[0] * ld0 + e % s[0]] = e < rows * s[0] ? xt[e] : 0.f;
      }
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const Out o{sm + lay.act[l + 1], ld_act(net, l + 1), sm + lay.b[l]};
      if (l + 1 < L) {
        layer_forward<kRelu>(net, lay, sm, l, sm + lay.act[l],
                             ld_act(net, l), tile, o);
      } else {
        layer_forward<kSigmoid>(net, lay, sm, l, sm + lay.act[l],
                                ld_act(net, l), tile, o);
      }
      __syncthreads();
    }
    // The output's gradient through the sigmoid, in place of the output
    // (0 past the last row), and the squared errors.
    {
      float* y = sm + lay.act[L];
      const int ldy = ld_act(net, L);
      float* sq = sm + lay.sq;
      const float* tgt = target + row0 * s[L];
      for (int e = threadIdx.x; e < tile * s[L]; e += blockDim.x) {
        const int i = e / s[L] * ldy + e % s[L];
        if (e < rows * s[L]) {
          const float diff = __fsub_rn(y[i], tgt[e]);
          sq[e] = __fmul_rn(diff, diff);
          y[i] = __fmul_rn(__fmul_rn(gscale, diff),
                           __fmul_rn(y[i], __fsub_rn(1.f, y[i])));
        } else {
          y[i] = 0.f;
        }
      }
      __syncthreads();
      if (warp == 0) {
        // This tile's sum of squares: lane j adds j, j + 32, ...; halving.
        float acc = 0.f;
        for (int e = lane; e < rows * s[L]; e += 32) {
          acc = __fadd_rn(acc, sq[e]);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          acc = __fadd_rn(acc, __shfl_xor_sync(kAll, acc, m));
        }
        loss = __fadd_rn(loss, acc);
      }
    }
    for (int l = L - 1; l >= 0; --l) {
      const int n_in = s[l], n_out = s[l + 1];
      float* act = sm + lay.act[l];
      const float* d = sm + lay.act[l + 1];     // the output's gradient
      const int ldi = ld_act(net, l), ldo = ld_act(net, l + 1);
      // dw[k][j] += sum over the tile's rows of act[r][k] * d[r][j]; row
      // k = n_in, the 1s, gives db[j] += sum over r of d[r][j].
      product<kAccumulate, false, false>(
          act, ldi, d, ldo, n_in + 1, n_out, tile,
          Out{sm + lay.gw[l], ld_g(net, n_out), nullptr});
      if (l > 0) {
        // act[r][k] = sum over j of d[r][j] * w[k][j] where act > 0, once
        // every warp has read act for dw.
        __syncthreads();
        product<kReluMask, true, true>(d, ldo, sm + lay.w[l],
                                       ld_w(net, n_out), tile, n_in, n_out,
                                       Out{act, ldi, nullptr});
        __syncthreads();
      }
    }
  }
  __syncthreads();                      // the last tile's dw
  float* part = partial + static_cast<size_t>(blockIdx.x) * P;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    const int n_out = s[l + 1], ld = ld_g(net, n_out);
    const int n = (s[l] + 1) * n_out;           // w, then b
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      part[off + e] = sm[lay.gw[l] + e / n_out * ld + e % n_out];
    }
    off += n;
  }
  if (threadIdx.x == 0) part[off] = loss;
}

// out[p] = sum over g of partial[g][p]; the last entry, the sum of
// squares, is divided by n (R * D): the loss.
__global__ void __launch_bounds__(256)
mlp_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int G, int P, float n) {
  const int p = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  float acc = 0.f;
  for (int g = lane; g < G; g += 32) {
    acc = __fadd_rn(acc, partial[static_cast<size_t>(g) * P + p]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(kAll, acc, m));
  }
  if (lane == 0) out[p] = p == P - 1 ? __fdiv_rn(acc, n) : acc;
}

// Checks the arguments, fills net and opts the kernel into its shared
// memory; returns the bytes or -1.
template <class Kernel>
long long prepare(Kernel kernel, Net* net, int n_layers, const int* sizes,
                  const void* const* w, const void* const* b, int tile,
                  bool train, int smem_bytes) {
  if (n_layers < 1 || n_layers > kMaxLayers || tile < 8 || tile % 8 != 0) {
    return -1;
  }
  net->n_layers = n_layers;
  net->pad = tile >= 16;
  for (int l = 0; l <= n_layers; ++l) {
    if (sizes[l] < 1) return -1;
    net->sizes[l] = sizes[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    net->w[l] = static_cast<const float*>(w[l]);
    net->b[l] = static_cast<const float*>(b[l]);
  }
  const long long bytes =
      smem_floats(*net, tile, train, nullptr) * sizeof(float);
  // The caller's plan (ops/mlp_kernel.py:mlp_plan) must be this layout's.
  if (bytes != smem_bytes) return -1;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

}  // namespace

// x, out [R, sizes[0]] f32 rows; w[l] [sizes[l], sizes[l + 1]], b[l]
// [sizes[l + 1]]; tile rows and smem_bytes as mlp_plan gives them; grid:
// the CTAs (at most one per tile).
extern "C" int mlp_forward_launch(const void* x, void* out, long long R,
                                  int n_layers, const int* sizes,
                                  const void* const* w, const void* const* b,
                                  int tile, int smem_bytes, int grid,
                                  void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  Net net;
  const long long bytes = prepare(mlp_forward_kernel, &net, n_layers, sizes,
                                  w, b, tile, false, smem_bytes);
  if (bytes < 0 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  mlp_forward_kernel<<<grid, kFwdWarps * 32, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const float*>(x), static_cast<float*>(out), R, tile);
  return static_cast<int>(cudaGetLastError());
}

// partial [grid, P] scratch, P = the parameter count + 1; grads [P]: the
// gradients in the order w0, b0, w1, b1, ..., then the loss.
extern "C" int mlp_train_launch(const void* x, const void* target,
                                void* partial, void* grads, long long R,
                                int n_layers, const int* sizes,
                                const void* const* w, const void* const* b,
                                int tile, int smem_bytes, int grid, int P,
                                float gscale, float n, void* stream) {
  Net net;
  const long long bytes = prepare(mlp_train_kernel, &net, n_layers, sizes,
                                  w, b, tile, true, smem_bytes);
  if (bytes < 0 || grid < 1 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  mlp_train_kernel<<<grid, kTrainWarps * 32, bytes, s>>>(
      net, static_cast<const float*>(x), static_cast<const float*>(target),
      static_cast<float*>(partial), R, tile, gscale, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlp_reduce_kernel<<<(P + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads), grid,
      P, n);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of one kind an SM holds at this layout, or a negative error.
extern "C" int mlp_blocks_per_sm(int train, int smem_bytes) {
  int blocks = 0;
  cudaError_t e;
  if (train) {
    e = cudaFuncSetAttribute(mlp_train_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mlp_train_kernel, kTrainWarps * 32, smem_bytes);
    }
  } else {
    e = cudaFuncSetAttribute(mlp_forward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mlp_forward_kernel, kFwdWarps * 32, smem_bytes);
    }
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

extern "C" const char* mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
