// ADMMA's MLP (decoders/admma.py: relu hidden layers, a sigmoid output,
// layer i computing x @ w{i} + b{i} with w{i} [n_in, n_out]) as one fused
// kernel in true float32: FFMA on the CUDA cores, no TF32, no tensor cores.
// Two entry points:
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
// with autograd's backward (ops/mlp_kernel.py: mlp_forward_plain,
// mlp_train_plain); the two agree within float32 rounding, not bit for bit
// (cuBLAS's order of summation is unspecified).
//
// What bounds it on the card: operations. ADMMA's [6, 100, 100, 6] does
// 2 * (6*100 + 100*100 + 100*6) = 22,400 flops per row forward and about
// twice that backward, over 2.46 M rows an iteration at B=4096 on
// LDPC(1200,3,6); its bytes are the rows in and out. Unfused, each hidden
// activation (0.98 GB) goes through device memory several times a layer.
// Here a tile of rows keeps every activation (and in train mode every
// gradient of one) in shared memory, beside the weights, staged once per
// CTA, and the CTA's partial gradients; CTAs are persistent, one wave,
// each walking tiles blockIdx.x, + gridDim.x, ...
//
// Activations and their gradients are kept feature-major, [width][tile
// rows + 4]. The products of a layer:
//   - forward  act'[j][r] = f(sum over k of w[k][j] act[k][r] + b[j]);
//   - backward dact[k][r] = (sum over j of w[k][j] d[j][r]) where act > 0,
//              dw[k][j] += sum over r of act[k][r] d[j][r], and db[j] with
//              it, as the row of a row of 1s under act.
// A wide one (both output sides more than 8) is register-tiled: a warp
// computes a 16 x 64 block of the output, a lane 8 x 4 of it (lanes 2 x
// 16), and per 4 steps of the sum loads its A and B values as twelve 16-byte
// shared loads, however each operand lies (along the output side or along
// the sum), for 128 FFMAs (blocks of 16 x 32, a lane's 8 x 2, where 16 x
// 64 blocks are fewer than the 7 warps). The row strides (weights: a
// multiple of 16 floats; activations and gradients: tile + 4) keep the
// 16-byte loads aligned and free of bank conflicts. A narrow one (an
// output side of at most 8 values: ADMMA's 6-wide input and output) gives
// a thread each value of the wide side and all the narrow side's outputs.
// Out-of-range rows and columns read a clamped address and are not
// stored: the inner loops have no branch.
//
// Measured on an H100 (clock64() per phase of a tile, thread 0): the
// 100 x 100 products run at a third of the FFMA rate (12.7 K cycles a tile
// for the forward's, 30.5 K for the backward's two, against 5 K each at
// 128 FFMAs a cycle), and the 6-wide layers' products and the output's
// gradient take a third of a train tile. A lane reads 12 values from
// shared memory for every 32 FFMAs, and with one CTA of 7 warps an SM (the
// train layout takes 215 KB) little hides the loads' latency. Not kept,
// each timed beside this form in one call at B=4096: 14 warps with 16 x 32
// blocks (forward 3.07 against 2.75 ms), and 13 warps of 8 x 32*CN blocks
// with the lanes along one side and broadcast loads of the other (forward
// 3.53 against 2.57 ms, train 10.90 against 9.57).
//
// The row tile is the largest of 64, 32, 16 and 8 rows whose layout fits
// the 227 KB of shared memory a block can have (ops/mlp_kernel.py:mlp_plan,
// the same formula as smem_floats below); a net that does not fit at 8
// rows is refused. [6, 100, 100, 6] takes 64 rows: 109,120 bytes in eval
// (two CTAs an SM), 214,768 in train (one).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kWarps = 7;               // a 100 x 64 product: 7 blocks
constexpr int kThreads = kWarps * 32;
constexpr int kNarrow = 8;              // a side this wide or less: narrow
constexpr unsigned kAll = 0xffffffffu;

struct Net {
  int n_layers;                         // weight matrices
  int sizes[kMaxLayers + 1];            // widths, input first
  const float* w[kMaxLayers];           // [sizes[l], sizes[l + 1]]
  const float* b[kMaxLayers];           // [sizes[l + 1]]
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// Row strides: a staged weight matrix; an activation or gradient buffer.
__host__ __device__ inline int ld_w(int n_out) { return round_up(n_out, 16); }
__host__ __device__ inline int ld_a(int tile) { return tile + 4; }

__host__ __device__ inline int widest(const Net& net, int first) {
  int m = 1;
  for (int l = first; l <= net.n_layers; ++l) {
    m = net.sizes[l] > m ? net.sizes[l] : m;
  }
  return m;
}

// Offsets (in floats, each a multiple of 4) of the shared-memory layout.
struct Layout {
  int w[kMaxLayers], b[kMaxLayers];     // staged weights and biases
  int act[kMaxLayers + 1];              // train: every layer's activations,
                                        // each but the last with a row of 1s
  int buf[2];                           // eval: two activation buffers;
                                        // train: two gradient buffers
  int sq;                               // train: squared errors of a tile
  int gw[kMaxLayers];                   // train: the CTA's gradients, each
                                        // layer's b right after its w
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
  const long long row = ld_a(tile);
  for (int l = 0; l < L; ++l) {
    t.w[l] = take(&off, static_cast<long long>(s[l]) * ld_w(s[l + 1]));
    t.b[l] = take(&off, s[l + 1]);
  }
  if (!train) {
    t.buf[0] = take(&off, widest(net, 0) * row);
    t.buf[1] = take(&off, widest(net, 0) * row);
  } else {
    for (int l = 0; l <= L; ++l) {
      t.act[l] = take(&off, (s[l] + (l < L ? 1 : 0)) * row);
    }
    t.buf[0] = take(&off, widest(net, 1) * row);
    t.buf[1] = take(&off, widest(net, 1) * row);
    t.sq = take(&off, static_cast<long long>(tile) * s[L]);
    for (int l = 0; l < L; ++l) {
      t.gw[l] = take(&off, static_cast<long long>(s[l] + 1) * s[l + 1]);
    }
  }
  if (lay != nullptr) *lay = t;
  return off;
}

enum Epilogue {
  kRelu,          // c = max(acc + bias[m], 0)
  kSigmoid,       // c = sigmoid(acc + bias[m])
  kReluMask,      // c = acc where h > 0, else 0
  kAccumulate,    // c += acc
};

// An operand of C[m][n] = sum over k of A(m, k) B(k, n): p[i*si + k*sk]
// for i its output index (m or n); contiguous along the output side (si =
// 1) or along the sum (sk = 1).
struct Operand {
  const float* p;
  int si, sk;
};

// The destination of C[m][n]: c[m*cm + n*cn]; h (kReluMask) is read at
// h[m*hm + n].
struct Out {
  float* c;
  int cm, cn;
  const float* bias;
  const float* h;
  int hm;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int kEpi>
__device__ __forceinline__ void store(const Out& o, int m, int n, float y) {
  float* dst = o.c + m * o.cm + n * o.cn;
  if (kEpi == kRelu) {
    *dst = fmaxf(__fadd_rn(y, o.bias[m]), 0.f);
  } else if (kEpi == kSigmoid) {
    *dst = sigmoid(__fadd_rn(y, o.bias[m]));
  } else if (kEpi == kReluMask) {
    *dst = o.h[m * o.hm + n] > 0.f ? y : 0.f;
  } else {
    *dst = __fadd_rn(*dst, y);
  }
}

template <int CN>
struct Vec;
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

// A narrow product, one of whose output sides has at most kNarrow values: a
// thread per value of the wide side computes all the narrow side's outputs,
// each a chain of FFMAs in k order. Where both operands are contiguous
// along the sum, four steps of it are one 16-byte load of each row.
template <int kEpi, bool kNarrowM>
__device__ void narrow_product(const Operand& A, const Operand& B, int M,
                               int N, int K, const Out& o) {
  const Operand& X = kNarrowM ? B : A;      // the wide side's operand
  const Operand& Y = kNarrowM ? A : B;      // the narrow side's
  const int n_wide = kNarrowM ? N : M;
  const int n_narrow = kNarrowM ? M : N;
  const bool vec = X.sk == 1 && Y.sk == 1 && X.si % 4 == 0 && Y.si % 4 == 0;
  const int K4 = vec ? K & ~3 : 0;
  for (int w = threadIdx.x; w < n_wide; w += blockDim.x) {
    const float* x = X.p + w * X.si;
    float acc[kNarrow];
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) acc[c] = 0.f;
    for (int k = 0; k < K4; k += 4) {
      float xv[4];
      Vec<4>::load(x + k, xv);
#pragma unroll
      for (int c = 0; c < kNarrow; ++c) {
        if (c < n_narrow) {
          float yv[4];
          Vec<4>::load(Y.p + c * Y.si + k, yv);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[c] = __fmaf_rn(xv[q], yv[q], acc[c]);
        }
      }
    }
    for (int k = K4; k < K; ++k) {
      const float xv = x[k * X.sk];
#pragma unroll
      for (int c = 0; c < kNarrow; ++c) {
        if (c < n_narrow) {
          acc[c] = __fmaf_rn(xv, Y.p[c * Y.si + k * Y.sk], acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kNarrow; ++c) {
      if (c < n_narrow) {
        store<kEpi>(o, kNarrowM ? c : w, kNarrowM ? w : c, acc[c]);
      }
    }
  }
}

// A wide product, register-tiled: warps take 16 x 16*CN blocks of C in
// turn; lane (lm, ln) of a warp (lanes 2 x 16) computes rows m of its
// block, lm's eight, and columns n, ln's CN. An operand contiguous along
// its output side (kAm / kBn) gives a lane its values as vector loads along
// that side (rows m0 + 8*lm + i, columns n0 + CN*ln + c); one contiguous
// along the sum, as 16-byte loads along the sum (rows m0 + 2*i + lm,
// columns n0 + ln + 16*c, so that the lanes of one load read consecutive
// rows). Strides are multiples of 4 floats; an operand along its output
// side is readable to the next multiple of 16 (A) or from b_lim to b_lim +
// CN - 1 (B).
template <int kEpi, bool kAm, bool kBn, int CN>
__device__ void tiled_product(const Operand& A, const Operand& B, int M,
                              int N, int K, int b_lim, const Out& o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lm = lane >> 4, ln = lane & 15;
  const int n_nb = (N + 16 * CN - 1) / (16 * CN);
  const int n_task = (M + 15) / 16 * n_nb;
  for (int task = warp; task < n_task; task += kWarps) {
    const int m0 = task / n_nb * 16, n0 = task % n_nb * 16 * CN;
    int mi[8], ni[CN];
#pragma unroll
    for (int i = 0; i < 8; ++i) mi[i] = kAm ? m0 + 8 * lm + i : m0 + 2 * i + lm;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      ni[c] = kBn ? n0 + CN * ln + c : n0 + ln + 16 * c;
    }
    // Where each lane reads: along the output side one base, else a row
    // (clamped into range) per output index.
    const float* a_base = A.p + (m0 + 8 * lm) * A.si;
    const float* b_base = B.p + min(n0 + CN * ln, b_lim) * B.si;
    int a_row[8], b_row[CN];
#pragma unroll
    for (int i = 0; i < 8; ++i) a_row[i] = min(mi[i], M - 1) * A.si;
#pragma unroll
    for (int c = 0; c < CN; ++c) b_row[c] = min(ni[c], N - 1) * B.si;
    float acc[8][CN];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
    }
    const int K4 = K & ~3;
    for (int k = 0; k < K4; k += 4) {
      float a[4][8], b[4][CN];
      if (kAm) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          Vec<4>::load(a_base + (k + q) * A.sk, a[q]);
          Vec<4>::load(a_base + (k + q) * A.sk + 4, a[q] + 4);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v[4];
          Vec<4>::load(A.p + a_row[i] + k, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q][i] = v[q];
        }
      }
      if (kBn) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          Vec<CN>::load(b_base + (k + q) * B.sk, b[q]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          float v[4];
          Vec<4>::load(B.p + b_row[c] + k, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) b[q][c] = v[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            acc[i][c] = __fmaf_rn(a[q][i], b[q][c], acc[i][c]);
          }
        }
      }
    }
#pragma unroll 2
    for (int k = K4; k < K; ++k) {
      float a[8], b[CN];
      if (kAm) {
        Vec<4>::load(a_base + k * A.sk, a);
        Vec<4>::load(a_base + k * A.sk + 4, a + 4);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = A.p[a_row[i] + k];
      }
      if (kBn) {
        Vec<CN>::load(b_base + k * B.sk, b);
      } else {
#pragma unroll
        for (int c = 0; c < CN; ++c) b[c] = B.p[b_row[c] + k];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          acc[i][c] = __fmaf_rn(a[i], b[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        if (mi[i] < M && ni[c] < N) store<kEpi>(o, mi[i], ni[c], acc[i][c]);
      }
    }
  }
}

// C = A B (epilogue): narrow where an output side has at most kNarrow
// values, else tiled (clamped reads and guarded stores take any size), with
// blocks of 16 x 64 where there are enough of them to keep every warp busy,
// else 16 x 32.
// b_end: the end of B's rows along its output side (kBn): the last vector
// load of a lane starts at b_end - CN or before.
template <int kEpi, bool kAm, bool kBn>
__device__ __forceinline__ void product(const Operand& A, const Operand& B,
                                        int M, int N, int K, int b_end,
                                        const Out& o) {
  if (M <= kNarrow) {
    narrow_product<kEpi, true>(A, B, M, N, K, o);
  } else if (N <= kNarrow) {
    narrow_product<kEpi, false>(A, B, M, N, K, o);
  } else if ((M + 15) / 16 * ((N + 63) / 64) >= kWarps) {
    tiled_product<kEpi, kAm, kBn, 4>(A, B, M, N, K, b_end - 4, o);
  } else {
    tiled_product<kEpi, kAm, kBn, 2>(A, B, M, N, K, b_end - 2, o);
  }
}

// Weights into [n_in][ld_w(n_out)] rows (zero-padded), and the biases.
__device__ void stage_weights(const Net& net, const Layout& lay, float* sm) {
  for (int l = 0; l < net.n_layers; ++l) {
    const int n_in = net.sizes[l], n_out = net.sizes[l + 1];
    const int ld = ld_w(n_out);
    for (int e = threadIdx.x; e < n_in * ld; e += blockDim.x) {
      const int k = e / ld, j = e % ld;
      sm[lay.w[l] + e] = j < n_out ? net.w[l][k * n_out + j] : 0.f;
    }
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      sm[lay.b[l] + e] = net.b[l][e];
    }
  }
}

// The tile's rows [rows][s0] of x, feature-major into act [s0][ld_a].
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          float* act, int rows, int s0,
                                          int tile) {
  for (int e = threadIdx.x; e < rows * s0; e += blockDim.x) {
    act[(e % s0) * ld_a(tile) + e / s0] = x[e];
  }
}

// One layer forward, act_in [n_in][ld_a] -> o.
template <int kEpi>
__device__ __forceinline__ void layer_forward(const Net& net,
                                              const Layout& lay,
                                              const float* sm, int l,
                                              const float* act_in, int rows,
                                              int tile, const Out& o) {
  const int n_in = net.sizes[l], n_out = net.sizes[l + 1];
  product<kEpi, true, true>(Operand{sm + lay.w[l], 1, ld_w(n_out)},
                            Operand{act_in, 1, ld_a(tile)}, n_out, rows, n_in,
                            ld_a(tile), o);
}

__global__ void __launch_bounds__(kThreads, 2)
mlp_forward_kernel(Net net, const float* __restrict__ x,
                   float* __restrict__ out, long long R, int tile) {
  extern __shared__ __align__(16) float sm[];
  Layout lay;
  smem_floats(net, tile, false, &lay);
  const int L = net.n_layers;
  const int* s = net.sizes;
  const int lda = ld_a(tile);
  stage_weights(net, lay, sm);
  const long long n_tiles = (R + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = static_cast<int>(min(static_cast<long long>(tile),
                                          R - row0));
    float* cur = sm + lay.buf[0];
    float* nxt = sm + lay.buf[1];
    // The previous tile's last layer read buf[0] or buf[1] until its end.
    __syncthreads();
    load_rows(x + row0 * s[0], cur, rows, s[0], tile);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float* bias = sm + lay.b[l];
      if (l + 1 < L) {
        layer_forward<kRelu>(net, lay, sm, l, cur, rows, tile,
                             Out{nxt, lda, 1, bias, nullptr, 0});
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      } else {
        // The output rows [rows][s_L] straight to device memory.
        layer_forward<kSigmoid>(net, lay, sm, l, cur, rows, tile,
                                Out{out + row0 * s[L], 1, s[L], bias,
                                    nullptr, 0});
      }
    }
  }
}

// gscale = 2 / (R * D): the gradient of the mean with respect to an output
// is gscale * (out - target).
__global__ void __launch_bounds__(kThreads, 1)
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
  const int lda = ld_a(tile);
  stage_weights(net, lay, sm);
  for (int l = 0; l < L; ++l) {
    // dw and db, zeroed; the row of 1s under each layer's input, by which
    // the weight gradient's product also sums db over the rows.
    for (int e = threadIdx.x; e < (s[l] + 1) * s[l + 1]; e += blockDim.x) {
      sm[lay.gw[l] + e] = 0.f;
    }
    for (int r = threadIdx.x; r < tile; r += blockDim.x) {
      sm[lay.act[l] + s[l] * lda + r] = 1.f;
    }
  }
  float loss = 0.f;                     // warp 0
  const long long n_tiles = (R + tile - 1) / tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = static_cast<int>(min(static_cast<long long>(tile),
                                          R - row0));
    // The previous tile's backward pass read act[0] until its end.
    __syncthreads();
    load_rows(x + row0 * s[0], sm + lay.act[0], rows, s[0], tile);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const Out o{sm + lay.act[l + 1], lda, 1, sm + lay.b[l], nullptr, 0};
      if (l + 1 < L) {
        layer_forward<kRelu>(net, lay, sm, l, sm + lay.act[l], rows, tile, o);
      } else {
        layer_forward<kSigmoid>(net, lay, sm, l, sm + lay.act[l], rows, tile,
                                o);
      }
      __syncthreads();
    }
    // The output's gradient, through the sigmoid, and the squared errors.
    float* cur = sm + lay.buf[0];
    float* nxt = sm + lay.buf[1];
    const float* y = sm + lay.act[L];
    float* sq = sm + lay.sq;
    const float* tgt = target + row0 * s[L];
    for (int e = threadIdx.x; e < rows * s[L]; e += blockDim.x) {
      const int i = (e % s[L]) * lda + e / s[L];
      const float diff = __fsub_rn(y[i], tgt[e]);
      sq[e] = __fmul_rn(diff, diff);
      cur[i] = __fmul_rn(__fmul_rn(gscale, diff),
                         __fmul_rn(y[i], __fsub_rn(1.f, y[i])));
    }
    __syncthreads();
    if (warp == 0) {
      // This tile's sum of squares: lane j adds j, j + 32, ...; halving.
      float acc = 0.f;
      for (int e = lane; e < rows * s[L]; e += 32) acc = __fadd_rn(acc, sq[e]);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        acc = __fadd_rn(acc, __shfl_xor_sync(kAll, acc, m));
      }
      loss = __fadd_rn(loss, acc);
    }
    for (int l = L - 1; l >= 0; --l) {
      const int n_in = s[l], n_out = s[l + 1];
      const float* act = sm + lay.act[l];
      const float* w = sm + lay.w[l];
      // dw[k][j] += sum over the tile's rows of act[k][r] * cur[j][r];
      // row k = n_in, the 1s, gives db[j] += sum over r of cur[j][r].
      product<kAccumulate, false, false>(
          Operand{act, lda, 1}, Operand{cur, lda, 1}, n_in + 1, n_out, rows,
          0, Out{sm + lay.gw[l], n_out, 1, nullptr, nullptr, 0});
      if (l > 0) {
        // nxt[k][r] = sum over j of w[k][j] * cur[j][r], where act > 0.
        product<kReluMask, false, true>(
            Operand{w, ld_w(n_out), 1}, Operand{cur, 1, lda}, n_in, rows,
            n_out, lda, Out{nxt, lda, 1, nullptr, act, lda});
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  float* part = partial + static_cast<size_t>(blockIdx.x) * P;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    const int n = (s[l] + 1) * s[l + 1];          // w, then b
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      part[off + e] = sm[lay.gw[l] + e];
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
  mlp_forward_kernel<<<grid, kThreads, bytes,
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
  mlp_train_kernel<<<grid, kThreads, bytes, s>>>(
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
          &blocks, mlp_train_kernel, kThreads, smem_bytes);
    }
  } else {
    e = cudaFuncSetAttribute(mlp_forward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mlp_forward_kernel, kThreads, smem_bytes);
    }
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

extern "C" const char* mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
