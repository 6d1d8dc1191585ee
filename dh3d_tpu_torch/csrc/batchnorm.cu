// Kernel J: train-mode BatchNorm over the last axis of [rows, C], with an
// optional fused ReLU, forward and backward (ops/batchnorm.py; the layer is
// nn/layers.py:BatchNorm).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it on the TPU (Flax's nn.BatchNorm, dh3d_tpu/nn/layers.py).  Added
// for ROADMAP R1: in plain PyTorch a train-mode BatchNorm + ReLU is a chain
// of broadcast elementwise ops and column reductions that moves its
// [rows, C] tensor some 40 times over the forward and autograd's backward,
// the largest block of device time in both training cells (PERF.md §5).
//
// What bounds it on an H100: memory.  A handful of operations an element
// against 4 bytes read or written: at least 3 passes over [rows, C] f32
// forward (x read for the statistics, x read and the output written) and 5
// backward (dy and x read for the sums, both read again and dx written), at
// 3.35 TB/s: 1.9 ms at stage 3's [196608, 1024].  The design:
//   - a thread owns V = 4 adjacent channels (one float4 a row; V = 1 when C
//     is no multiple of 4 or a pointer is not 16-byte aligned); a block of
//     256 threads covers `tile` = min(C / V, 256) channel groups and walks
//     256 / tile rows side by side, so a warp reads 512 contiguous bytes of
//     a row, or whole narrow rows; blockIdx.x takes the channel tiles,
//     blockIdx.y a fixed slice of rows (the plan, ops/batchnorm.py:
//     bn_plan: one wave of blocks over the SMs);
//   - column sums (Σx and Σx² forward, Σg and Σg·(x - mean) backward): a
//     thread keeps 4 loads in flight (4 rows of one input, 2 of two) and
//     adds every value, and every product, in f64 (a product of two f32 is
//     exact there); the block's row lanes are added in f64 in lane order
//     in shared memory, and the row slices in f64 in a fixed order by a
//     second small kernel.  No atomics: two runs give the same bits.  And
//     as the sums are exact to f64 rounding, the f32 statistics do not
//     depend on how the plan splits the rows: a rank of sync BatchNorm, or
//     a card with another SM count, rounds them as the one-process step
//     does (but for a sum within f64 rounding of an f32 rounding point);
//   - the elementwise passes turn the sums into their per-channel
//     coefficients themselves, each thread for its channels, and the first
//     row slice writes what is kept (the statistics, the running update,
//     dscale and dbias), so each direction is three launches;
//   - the backward recomputes the ReLU mask from x with the device function
//     the forward applies (bn_affine), so that only x is kept for it and
//     the two masks agree bit for bit.
//
// Contract, shared with ops/batchnorm.py (batch_norm_plain: the layer's
// plain code; batch_norm_backward_plain: the closed form below):
//   mean = Σx / n and meansq = Σx² / n, from the f64 sums rounded to f32;
//   var = max(0, meansq - mean*mean) in f32 (Flax's formula; NaN stays
//   NaN); rstd = 1 / sqrt(var + eps) rounded once; mul = rstd * scale;
//   y = ((x - mean) * mul) + bias, each operation rounded on its own (no
//   FMA contraction, as PyTorch's separate ops round); out = y, or relu(y)
//   (0 where y <= 0, NaN kept) when asked; the running statistics become
//   m * old + (1 - m) * new (mean and the biased var) when updated.
//   Backward, with g = dy where the ReLU passed (!(y <= 0)) and xc = x -
//   mean: dbias = Σg, dscale = Σ(g·xc) * rstd, dvar = -0.5 Σ(g·xc) * scale
//   * rstd³ where meansq - mean*mean >= 0 (clamp_min's gradient) else 0,
//   dx = g * mul - mul * Σg / n + 2 dvar / n * xc: the gradient through
//   mean and through meansq.  Sync BatchNorm: the caller all-reduces the
//   sums and n between the passes; dscale and dbias stay the rank's own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads a block (ops/batchnorm.py)
constexpr int kMinBlocks = 4;     // blocks an SM the plan aims at
constexpr int kLoads = 4;         // loads a thread keeps in flight
constexpr int kCombineLanes = 8;  // row slices a combine column sums apart
constexpr int kCombineCols = kThreads / kCombineLanes;

template <int V>
__device__ __forceinline__ void ld(const float* __restrict__ p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st(float* __restrict__ p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// The forward's normalisation of one element, shared by every pass that
// needs y (the output, and the ReLU mask in the backward).
__device__ __forceinline__ float bn_affine(float x, float mean, float mul,
                                           float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

__device__ __forceinline__ bool relu_passes(float y) { return !(y <= 0.f); }

// Where a thread works: channels [c0, c0 + V) of rows r0 + lane, r0 + lane
// + lanes, ... below r1.
struct Slot {
  int lanes, lane, c0, r0, r1;
  bool live;
  template <int V>
  __device__ __forceinline__ void at(int rows, int C, int tile,
                                     int rows_per_block) {
    const int t = threadIdx.x, bx = blockIdx.x, by = blockIdx.y;
    lanes = kThreads / tile;
    lane = t / tile;
    c0 = (bx * tile + t % tile) * V;
    live = lane < lanes && c0 < C;
    r0 = by * rows_per_block + lane;
    r1 = min(rows, (by + 1) * rows_per_block);
  }
};

// The block's per-thread sums a[V] and b[V] added over its row lanes, in
// f64 and lane order, written to part[0, C) and part[C, 2C) at the block's
// channels.
template <int V>
__device__ __forceinline__ void block_sums(const Slot& s, int tile, int C,
                                           const double* a, const double* b,
                                           double* __restrict__ part) {
  __shared__ double sa[kThreads * V], sb[kThreads * V];
  const int width = tile * V;
  const int col = ((int)threadIdx.x % tile) * V;
  if (s.lane < s.lanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[s.lane * width + col + j] = a[j];
      sb[s.lane * width + col + j] = b[j];
    }
  }
  __syncthreads();
  const int base = (int)blockIdx.x * width;
  for (int q = threadIdx.x; q < width && base + q < C; q += kThreads) {
    double ta = 0.0, tb = 0.0;
    for (int l = 0; l < s.lanes; ++l) {
      ta += sa[l * width + q];
      tb += sb[l * width + q];
    }
    part[base + q] = ta;
    part[C + base + q] = tb;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_stats_reduce_kernel(const float* __restrict__ x, int rows, int C,
                           int tile, int rows_per_block,
                           double* __restrict__ partials) {
  constexpr int U = kLoads;  // rows a step
  Slot s;
  s.at<V>(rows, C, tile, rows_per_block);
  double sx[V] = {}, sq[V] = {};
  if (s.live) {
    const float* p = x + s.c0;
    int r = s.r0;
    for (; r + (U - 1) * s.lanes < s.r1; r += U * s.lanes) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        ld<V>(p + (int64_t)(r + u * s.lanes) * C, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const double d = (double)v[u][j];
          sx[j] += d;
          sq[j] += d * d;
        }
    }
    for (; r < s.r1; r += s.lanes) {
      float v[V];
      ld<V>(p + (int64_t)r * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = (double)v[j];
        sx[j] += d;
        sq[j] += d * d;
      }
    }
  }
  block_sums<V>(s, tile, C, sx, sq,
                partials + (int64_t)blockIdx.y * 2 * C);
}

// sums[j] = the sum over p of partials[p][j], j < width, in f64 and a fixed
// order (lane l takes p = l, l + kCombineLanes, ...; then the lanes in
// order); sums[width] = rows, the count (all-reduced with the sums under
// sync BatchNorm).
__global__ void __launch_bounds__(kThreads)
    bn_sums_combine_reduce_kernel(const double* __restrict__ partials,
                                  int parts, int width, int rows,
                                  double* __restrict__ sums) {
  __shared__ double s[kCombineLanes][kCombineCols];
  const int lane = threadIdx.x / kCombineCols;
  const int k = threadIdx.x % kCombineCols;
  const int j = blockIdx.x * kCombineCols + k;
  double t = 0.0;
  if (j < width)
    for (int p = lane; p < parts; p += kCombineLanes)
      t += partials[(int64_t)p * width + j];
  s[lane][k] = t;
  __syncthreads();
  if (lane == 0 && j < width) {
    for (int l = 1; l < kCombineLanes; ++l) t += s[l][k];
    sums[j] = t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[width] = (double)rows;
}

// Channel c's statistics from the forward's sums [2C + 1] (Σx, Σx², n):
// mean, mul = rstd * scale, rstd, and 1 where meansq - mean*mean >= 0
// (else 0), the layout of `stats` [4C].
struct Stats {
  float mean, mul, rstd, clamp, var;
  __device__ __forceinline__ Stats(const double* __restrict__ sums, int C,
                                   int c, float scale, float eps) {
    const double n = sums[2 * C];
    mean = (float)(sums[c] / n);
    const float meansq = (float)(sums[C + c] / n);
    const float raw = __fsub_rn(meansq, __fmul_rn(mean, mean));
    var = raw < 0.f ? 0.f : raw;
    rstd = (float)(1.0 / sqrt((double)__fadd_rn(var, eps)));
    mul = __fmul_rn(rstd, scale);
    clamp = raw >= 0.f ? 1.f : 0.f;
  }
};

// out = y or relu(y), the statistics from `sums`; the first row slice's
// first row lane also writes stats [4C] and, with `update`, the running
// mean and var (each channel once).
template <int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_relu_elementwise_kernel(const float* __restrict__ x,
                               const double* __restrict__ sums,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, float eps,
                               float m, float one_minus_m, int update,
                               float* __restrict__ run_mean,
                               float* __restrict__ run_var,
                               float* __restrict__ stats, int rows, int C,
                               int tile, int rows_per_block,
                               float* __restrict__ out) {
  constexpr int U = kLoads;  // rows a step
  Slot s;
  s.at<V>(rows, C, tile, rows_per_block);
  if (!s.live) return;
  const bool keeper = blockIdx.y == 0 && s.lane == 0;
  float mean[V], mul[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = s.c0 + j;
    const Stats k(sums, C, c, scale[c], eps);
    mean[j] = k.mean;
    mul[j] = k.mul;
    b[j] = bias[c];
    if (keeper) {
      stats[c] = k.mean;
      stats[C + c] = k.mul;
      stats[2 * C + c] = k.rstd;
      stats[3 * C + c] = k.clamp;
      if (update) {
        run_mean[c] = __fadd_rn(__fmul_rn(m, run_mean[c]),
                                __fmul_rn(one_minus_m, k.mean));
        run_var[c] = __fadd_rn(__fmul_rn(m, run_var[c]),
                               __fmul_rn(one_minus_m, k.var));
      }
    }
  }
  const float* p = x + s.c0;
  float* q = out + s.c0;
  int r = s.r0;
  for (; r + (U - 1) * s.lanes < s.r1; r += U * s.lanes) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
      ld<V>(p + (int64_t)(r + u * s.lanes) * C, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = bn_affine(v[u][j], mean[j], mul[j], b[j]);
        v[u][j] = kRelu && y <= 0.f ? 0.f : y;
      }
      st<V>(q + (int64_t)(r + u * s.lanes) * C, v[u]);
    }
  }
  for (; r < s.r1; r += s.lanes) {
    float v[V];
    ld<V>(p + (int64_t)r * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = bn_affine(v[j], mean[j], mul[j], b[j]);
      v[j] = kRelu && y <= 0.f ? 0.f : y;
    }
    st<V>(q + (int64_t)r * C, v);
  }
}

// g = dy where the forward's ReLU passed (all of dy without one).
template <bool kRelu>
__device__ __forceinline__ float masked(float d, float x, float mean,
                                        float mul, float b) {
  return kRelu && !relu_passes(bn_affine(x, mean, mul, b)) ? 0.f : d;
}

template <int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_grad_reduce_kernel(const float* __restrict__ dy,
                          const float* __restrict__ x,
                          const float* __restrict__ stats,
                          const float* __restrict__ bias, int rows, int C,
                          int tile, int rows_per_block,
                          double* __restrict__ partials) {
  constexpr int U = kLoads / 2;  // rows a step (two inputs)
  Slot s;
  s.at<V>(rows, C, tile, rows_per_block);
  double sg[V] = {}, sgc[V] = {};
  if (s.live) {
    float mean[V], mul[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[j] = stats[s.c0 + j];
      mul[j] = stats[C + s.c0 + j];
      b[j] = bias[s.c0 + j];
    }
    const float* pd = dy + s.c0;
    const float* px = x + s.c0;
    int r = s.r0;
    for (; r + (U - 1) * s.lanes < s.r1; r += U * s.lanes) {
      float d[U][V], v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t at = (int64_t)(r + u * s.lanes) * C;
        ld<V>(pd + at, d[u]);
        ld<V>(px + at, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const double g =
              masked<kRelu>(d[u][j], v[u][j], mean[j], mul[j], b[j]);
          sg[j] += g;
          sgc[j] += g * (double)__fsub_rn(v[u][j], mean[j]);
        }
    }
    for (; r < s.r1; r += s.lanes) {
      float d[V], v[V];
      ld<V>(pd + (int64_t)r * C, d);
      ld<V>(px + (int64_t)r * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double g = masked<kRelu>(d[j], v[j], mean[j], mul[j], b[j]);
        sg[j] += g;
        sgc[j] += g * (double)__fsub_rn(v[j], mean[j]);
      }
    }
  }
  block_sums<V>(s, tile, C, sg, sgc,
                partials + (int64_t)blockIdx.y * 2 * C);
}

// dx = g * mul + k0 + k1 * (x - mean), with channel c's k0 = -mul * Σg / n
// and k1 = 2 dvar / n from the group's sums `global` (the same sums as
// `local` without sync BatchNorm) and n = fwd_sums[2C]; the first row
// slice's first row lane also writes dscale and dbias from the rank's own
// sums `local`.
template <int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_dx_elementwise_kernel(const float* __restrict__ dy,
                             const float* __restrict__ x,
                             const float* __restrict__ stats,
                             const float* __restrict__ bias,
                             const float* __restrict__ scale,
                             const double* __restrict__ fwd_sums,
                             const double* __restrict__ local,
                             const double* __restrict__ global, int rows,
                             int C, int tile, int rows_per_block,
                             float* __restrict__ dscale,
                             float* __restrict__ dbias,
                             float* __restrict__ dx) {
  constexpr int U = kLoads / 2;  // rows a step (two inputs)
  Slot s;
  s.at<V>(rows, C, tile, rows_per_block);
  if (!s.live) return;
  const bool keeper = blockIdx.y == 0 && s.lane == 0;
  const double n = fwd_sums[2 * C];
  float mean[V], mul[V], b[V], k0[V], k1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = s.c0 + j;
    mean[j] = stats[c];
    mul[j] = stats[C + c];
    b[j] = bias[c];
    const double rstd = stats[2 * C + c];
    const double dvar = stats[3 * C + c] != 0.f
                            ? -0.5 * global[C + c] * (double)scale[c] *
                                  rstd * rstd * rstd
                            : 0.0;
    k0[j] = (float)(-(double)mul[j] * global[c] / n);
    k1[j] = (float)(2.0 * dvar / n);
    if (keeper) {
      dbias[c] = (float)local[c];
      dscale[c] = (float)(local[C + c] * rstd);
    }
  }
  const float* pd = dy + s.c0;
  const float* px = x + s.c0;
  float* q = dx + s.c0;
  int r = s.r0;
  for (; r + (U - 1) * s.lanes < s.r1; r += U * s.lanes) {
    float d[U][V], v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t at = (int64_t)(r + u * s.lanes) * C;
      ld<V>(pd + at, d[u]);
      ld<V>(px + at, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float g = masked<kRelu>(d[u][j], v[u][j], mean[j], mul[j], b[j]);
        d[u][j] = fmaf(k1[j], __fsub_rn(v[u][j], mean[j]),
                       fmaf(g, mul[j], k0[j]));
      }
      st<V>(q + (int64_t)(r + u * s.lanes) * C, d[u]);
    }
  }
  for (; r < s.r1; r += s.lanes) {
    float d[V], v[V];
    ld<V>(pd + (int64_t)r * C, d);
    ld<V>(px + (int64_t)r * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float g = masked<kRelu>(d[j], v[j], mean[j], mul[j], b[j]);
      d[j] = fmaf(k1[j], __fsub_rn(v[j], mean[j]), fmaf(g, mul[j], k0[j]));
    }
    st<V>(q + (int64_t)r * C, d);
  }
}

// The launch geometry of a plan; false for one the kernels do not take.
struct Grid {
  int tile, rows_per_block;
  dim3 blocks;
  bool set(int rows, int C, int vec, int row_blocks) {
    if (rows < 1 || C < 1 || (vec != 1 && vec != 4) || C % vec ||
        row_blocks < 1 || row_blocks > 65535 || row_blocks > rows)
      return false;
    const int groups = C / vec;
    tile = groups < kThreads ? groups : kThreads;
    rows_per_block = (int)(((int64_t)rows + row_blocks - 1) / row_blocks);
    blocks = dim3((groups + tile - 1) / tile, row_blocks);
    return true;
  }
};

}  // namespace

// Pass 1 of the forward.  x [rows, C] f32 -> sums [2C + 1] f64: Σx, Σx²,
// then rows.  partials: [row_blocks, 2C] f64 scratch.  The plan: `vec`
// channels a thread (4, or 1), `row_blocks` row slices (1..min(rows,
// 65535)); with vec 4, C % 4 == 0 and x 16-byte aligned.  Returns
// cudaErrorInvalidValue for sizes or a plan it does not take.  Launches on
// `stream` and does not synchronise (so do the entry points below).
extern "C" int dh3d_bn_stats(const void* x, void* partials, void* sums,
                             int rows, int C, int vec, int row_blocks,
                             void* stream) {
  Grid g;
  if (!g.set(rows, C, vec, row_blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  double* part = static_cast<double*>(partials);
  if (vec == 4)
    bn_stats_reduce_kernel<4><<<g.blocks, kThreads, 0, st>>>(
        xp, rows, C, g.tile, g.rows_per_block, part);
  else
    bn_stats_reduce_kernel<1><<<g.blocks, kThreads, 0, st>>>(
        xp, rows, C, g.tile, g.rows_per_block, part);
  bn_sums_combine_reduce_kernel<<<(2 * C + kCombineCols - 1) / kCombineCols,
                                  kThreads, 0, st>>>(
      part, row_blocks, 2 * C, rows, static_cast<double*>(sums));
  return (int)cudaGetLastError();
}

// Pass 2 of the forward: the statistics from `sums` (pass 1's, all-reduced
// under sync BatchNorm) into stats [4C] f32 (mean, mul, rstd, the var
// clamp's mask) and, with `update`, into the running mean and var (in
// place), and out [rows, C] = y or relu(y), in one launch.  eps, m and
// 1 - m are rounded to f32, as PyTorch takes a Python number into an f32
// op.
extern "C" int dh3d_bn_forward(const void* x, const void* sums,
                               const void* scale, const void* bias,
                               void* run_mean, void* run_var, void* stats,
                               void* out, int rows, int C, double eps,
                               double momentum, double one_minus_momentum,
                               int update, int relu, int vec, int row_blocks,
                               void* stream) {
  Grid g;
  if (!g.set(rows, C, vec, row_blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const double* sm = static_cast<const double*>(sums);
  const float* cp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* rm = static_cast<float*>(run_mean);
  float* rv = static_cast<float*>(run_var);
  float* sp = static_cast<float*>(stats);
  float* op = static_cast<float*>(out);
  const float e = (float)eps, m = (float)momentum;
  const float m1 = (float)one_minus_momentum;
#define DH3D_BN_FWD(V, R)                                                 \
  bn_relu_elementwise_kernel<V, R><<<g.blocks, kThreads, 0, st>>>(         \
      xp, sm, cp, bp, e, m, m1, update, rm, rv, sp, rows, C, g.tile,      \
      g.rows_per_block, op)
  if (vec == 4) {
    if (relu) DH3D_BN_FWD(4, true); else DH3D_BN_FWD(4, false);
  } else {
    if (relu) DH3D_BN_FWD(1, true); else DH3D_BN_FWD(1, false);
  }
#undef DH3D_BN_FWD
  return (int)cudaGetLastError();
}

// Pass 1 of the backward.  dy, x [rows, C] f32, stats and bias of the
// forward -> sums [2C + 1] f64: Σg, Σg·(x - mean), then rows.  partials
// and the plan as dh3d_bn_stats's (with vec 4, dy aligned too).
extern "C" int dh3d_bn_grad_sums(const void* dy, const void* x,
                                 const void* stats, const void* bias,
                                 void* partials, void* sums, int rows, int C,
                                 int relu, int vec, int row_blocks,
                                 void* stream) {
  Grid g;
  if (!g.set(rows, C, vec, row_blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(dy);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(stats);
  const float* bp = static_cast<const float*>(bias);
  double* part = static_cast<double*>(partials);
#define DH3D_BN_SUMS(V, R)                                   \
  bn_grad_reduce_kernel<V, R><<<g.blocks, kThreads, 0, st>>>( \
      dp, xp, sp, bp, rows, C, g.tile, g.rows_per_block, part)
  if (vec == 4) {
    if (relu) DH3D_BN_SUMS(4, true); else DH3D_BN_SUMS(4, false);
  } else {
    if (relu) DH3D_BN_SUMS(1, true); else DH3D_BN_SUMS(1, false);
  }
#undef DH3D_BN_SUMS
  bn_sums_combine_reduce_kernel<<<(2 * C + kCombineCols - 1) / kCombineCols,
                                  kThreads, 0, st>>>(
      part, row_blocks, 2 * C, rows, static_cast<double*>(sums));
  return (int)cudaGetLastError();
}

// Pass 2 of the backward: dscale, dbias [C] from `local` (this rank's pass-1
// sums), dx [rows, C] from `global` (the group's; `local` itself without
// sync BatchNorm) and n = fwd_sums[2C], in one launch.  With vec 4, dy, x
// and dx aligned.
extern "C" int dh3d_bn_grad_dx(const void* dy, const void* x,
                               const void* stats, const void* bias,
                               const void* scale, const void* fwd_sums,
                               const void* local, const void* global,
                               void* dscale, void* dbias, void* dx, int rows,
                               int C, int relu, int vec, int row_blocks,
                               void* stream) {
  Grid g;
  if (!g.set(rows, C, vec, row_blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(dy);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(stats);
  const float* bp = static_cast<const float*>(bias);
  const float* cp = static_cast<const float*>(scale);
  const double* fs = static_cast<const double*>(fwd_sums);
  const double* lo = static_cast<const double*>(local);
  const double* gl = static_cast<const double*>(global);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* op = static_cast<float*>(dx);
#define DH3D_BN_DX(V, R)                                                  \
  bn_dx_elementwise_kernel<V, R><<<g.blocks, kThreads, 0, st>>>(           \
      dp, xp, sp, bp, cp, fs, lo, gl, rows, C, g.tile, g.rows_per_block,  \
      ds, db, op)
  if (vec == 4) {
    if (relu) DH3D_BN_DX(4, true); else DH3D_BN_DX(4, false);
  } else {
    if (relu) DH3D_BN_DX(1, true); else DH3D_BN_DX(1, false);
  }
#undef DH3D_BN_DX
  return (int)cudaGetLastError();
}
