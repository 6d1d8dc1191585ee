// Kernels C, D, E and F: reductions over a gathered neighbourhood and
// their transposes.
//
//   C  weighted_sum:  out[b, n, p*C + c] = sum_k w[b, n, k, p] * f[b, nbh[b, n, k], c]
//      flex_moments: the same with w[b, n, k, :] = [1, pos[nbh[b, n, k]] -
//                    pos[nbh[b, n, 0]]] built in the kernel from positions
//                    [b, m, P - 1] (one __fsub_rn a coordinate)
//   D  neighbor_max:  val[b, n, c] = max_k f[b, nbh[b, n, k], c]
//                     slot[b, n, c] = k*, the k that wins (int8, optional:
//                     written only when the caller will need the backward)
//                     arg[b, n, c] = nbh[b, n, k*] (int64, optional)
//      The rule for k*, which is torch.argmax's and jnp.argmax's: a
//      candidate replaces the best so far when it is greater (strict, so
//      ties keep the lowest k, flex_pool_kernel.cc:44-49), or when it is NaN
//      and the best so far is not.  So the first NaN in k order wins and
//      nothing replaces a NaN: val is NaN, slot and arg are that NaN's.
//      -inf and +inf are ordinary values.  F routes by the slot, so a
//      cotangent goes to the first NaN's row.
//   E  weighted_sum_backward (the transpose of C with respect to f):
//      dfeat[b, j, c] = sum_{(n, k): nbh[b, n, k] = j} sum_p w[b, n, k, p] * dM[b, n, p*C + c]
//   F  neighbor_max_backward (the transpose of D's value with respect to f):
//      dfeat[b, j, c] = sum_{(n, k): nbh[b, n, k] = j} [slot[b, n, c] == k] * dval[b, n, c]
//
// Replaces (dh3d_tpu/ops/pallas/banded_pallas.py):
//   C: _fwd_kernel (P = 1: conv_pointset on raw xyz, three_interpolate) and
//      _moments_fwd_kernel (the flex-conv moments, P = 4 with weights
//      [1, dx, dy, dz]: the p-major output is exactly the moment layout);
//   D: _max_kernel (value, global argmax id and the argmax slot);
//   E: _moments_bwd_kernel (P = 4: the moments are C with weights
//      [1, delta], so their transpose is E with the same weights, built in
//      the kernel from the positions likewise; the centred-position trick of
//      the TPU kernel has no counterpart),
//      _bwd_kernel (generic P > 1) and _bwd_w1_kernel (P = 1, the
//      three_interpolate transpose);
//   F: _bwd_slot_kernel (max-pool backward routed by the slot);
//   and the work of _slot_kernel, which delivers the neighbours that fall
//   outside the Morton band in both directions: these kernels read any index
//   directly.
// Mosaic has no gather and no scatter, so the TPU kernels turn each
// neighbour lookup into a one-hot matmul over a Morton window of the
// features, split f32 into bf16 hi/lo planes for the MXU, and patch the
// out-of-window neighbours with a compacted plan; the backward needs four
// kernels for the same reason.  A Hopper thread can load any row, so none of
// that is carried over: indices may be arbitrary, N and M need not divide
// anything, and all arithmetic is f32.
//
// The transposes E and F are gathers too, not scatters.  They read a CSR
// inverse of the neighbourhood (`inverse_neighbors` in ops/neighborhood.py,
// integer sorts in PyTorch, built once per neighbourhood and shared by every
// backward over it): int32 row pointers rowptr[b, j] and int32 entries
// ent[b, e] = (n << 6) | k (exact: k < 64 and n < 2^25), grouped by key j,
// ascending within it.  Each output row dfeat[b, j, :] is owned by one row
// group of threads, which walks its key's entries in that order and sums in
// f32.  No atomics: every output element is written once, by one thread,
// with a fixed summation order, so the gradients are the same from run to
// run (the JAX package has no atomics either).
//
// What bounds them on an H100: device memory.  Per query row kernel C reads
// K indices (8 B each), K*P weights (4 B; the moments: K positions of 12 B
// instead, L2 hits), K gathered feature rows of C floats and writes P*C
// floats: at P = 4, C = 64, K = 8 that is 64 + 128 + 2048 + 1024 bytes for
// 2*K*P*C = 4096 flops, about 1.3 flop/byte, far below the card's balance
// point.  The gathered rows are the bulk; a cloud's feature table (8192 x
// 64 x 4 B = 2 MB) sits in the 50 MB L2, so most of them are L2 hits, and
// what is left is latency: a thread must have many gathers in flight.
// Kernel D moves the same rows and writes a value a channel and, when
// asked, a byte of slot and an int64 id.
//
// C and D are row-major: a row group of `lanes` threads (a power of two up
// to a warp) owns one query row, each thread VEC = 4, 2 or 1 adjacent
// channels, loaded as one float4, float2 or float, so that a gathered row is
// one coalesced read of 16 bytes a lane.  Channels beyond lanes * VEC take
// further passes: a row's ids and weights are loaded once for all of them,
// which is why 8 lanes a row (four rows a warp, 128 bytes a row and pass)
// measured faster at K = 8 than a lane for every vector.  The plan (VEC,
// lanes, passes) comes from `row_plan` in ops/neighborhood.py; the entry
// points check it against C and the bases' alignment and refuse what does
// not fit.  For the K the model uses (8, and 3 for the upsample) K is a
// template argument: lane kk of the group loads neighbour kk's id and its P
// weights (the moments: its position, and subtracts the centre's, shuffled
// from lane 0) in one coalesced load, the group shuffles them round, and
// each thread has all K gathers of a pass in flight before the first fmaf,
// with the P * VEC sums in registers.  Any other K (up to 64), or a group
// of fewer than K lanes, takes a loop over k in which every thread reads
// the ids and weights itself (broadcast loads).
// The moments are far larger than L2 (168 MB at [20, 8192, 4 * 64]) and
// their reader is a matrix product that streams them, so C writes its
// output with streaming stores (__stcs), which leave the feature tables in
// L2.
// E and F move the same bytes as C and D the other way round: for every
// entry of its key a row group reads one entry id (4 B, broadcast to the
// group), P weights (broadcast) and one cotangent row of P*C floats (F: C
// floats and C slot bytes), coalesced across the group's channels.
//
// E and F are entry-major, so that the bytes above are all they move: a
// row group keeps the accumulators of its channels in registers (each
// thread VEC = 1, 2 or 4 adjacent channels, loaded as one float, float2 or
// float4 and, for F's slot, one int8, char2 or char4), loads each entry id
// once, unpacks it with a shift and a mask (no 64-bit division), loads the
// entry's P weights once, and issues the next entry's id, weights and rows
// before it adds the current entry's terms, so that the dependent chain
// rowptr -> entry -> row overlaps from one entry to the next.  Channels
// beyond 32 * VEC (C > 128) take a second walk of the entries.
//
// Accumulation: over k (C, D) or over the key's CSR entries (E, F) in
// ascending order, one fmaf or add a term, in f32; in C and E the P terms
// of a neighbour or entry in ascending p.  Each output element sees the
// same terms in the same order whatever the plan is, and the moments' p = 0
// weight is the constant 1, so C on positions gives the bits of C on the
// weights [1, delta] built outside.
//
// The moments and their transpose have a bf16 case each, the model's
// compute_dtype="bfloat16" (`_flex_moments` of dh3d_tpu/ops/flex.py on bf16
// features; the TPU kernel reads its feature window as bf16,
// banded_pallas.py:565, and its backward a single bf16 plane, :534-537).
// The kernels are the f32 ones templated on the feature type, with the
// rounding points of the JAX function:
//   C (dh3d_flex_moments_bf16): features [b, m, c] bf16, read VEC at a time
//      as one load of 2, 4 or 8 bytes; positions f32; delta = __fsub_rn in
//      f32, then rounded to bf16 (__float2bfloat16_rn); products and sums
//      in f32 (a product of two bf16 values is exact in f32); the p = 0
//      moment, a plain sum of the features (jnp.sum of bf16: an f32 sum
//      rounded once), rounded to bf16 before it is stored; the moments
//      written as f32.
//   E (dh3d_flex_moments_bwd_bf16): weights [1, bf16(delta)]; dM read as
//      f32 with its p = 0 slice rounded to bf16 (the cotangent of m0, which
//      JAX rounds when it casts m0 up); the same f32 accumulation in the
//      same fixed order; dfeat written as bf16, rounded once.  (The JAX
//      gather path rounds the feature cotangent to bf16 at each add of its
//      scatter; this rounds once.)
// The bf16 cases halve the bytes of the gathered rows (C) and of dfeat (E).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// Threads a key row of E or F gets: the vector count rounded up to a power
// of two, capped at one warp.
int threads_per_row(int c) {
  int t = 1;
  while (t < c && t < 32) t <<= 1;
  return t;
}

// VEC adjacent floats or int8s of a row, as one load or store (the
// address is a multiple of VEC elements: the entry points check the bases).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// VEC adjacent bf16 values of a row as one load of 2 * VEC bytes, widened
// to f32 (exact: a bf16 is the upper half of an f32).
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (VEC == 2) {
    const unsigned int t = *reinterpret_cast<const unsigned int*>(p);
    v[0] = __uint_as_float(t << 16), v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// x rounded to the nearest bf16 (ties to even), as an f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const char2 t = *reinterpret_cast<const char2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// VEC f32 values rounded to bf16 (ties to even), stored as one store of
// 2 * VEC bytes.
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                   bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned int*>(p) = bf16_bits(v[0]) | bf16_bits(v[1]) << 16;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <typename T>
constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;

// The same as a streaming store (evict-first), for C's output: it is read
// once, by a matrix product, and should not displace what the gathers hit
// in L2.
template <int VEC>
__device__ __forceinline__ void store_vec_streaming(float* p,
                                                    const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

constexpr unsigned kFullMask = 0xffffffffu;

struct RowPlan {
  int vec, lanes, passes;
};

// C: one row group of `lanes` threads per query row; K at compile time and
// lanes >= K.  `w` is the weights [rows, K, P] or, for the moments, the
// positions [b, m, P - 1].  Rows past the end are clamped and not stored,
// so that whole warps reach the shuffles.  T: the features' type (bf16 only
// for the moments: the header's rounding points).
template <int P, int VEC, int K, bool MOMENTS, typename T>
__global__ void __launch_bounds__(kThreads)
    weighted_sum_unrolled_kernel(const T* __restrict__ feat,
                                 const int64_t* __restrict__ nbh,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, long long rows,
                                 int n, int m, int c, RowPlan plan) {
  const int lanes = plan.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  long long row =
      (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  if (!live) row = rows - 1;
  const size_t cloud = (size_t)(row / n);
  // lane kk < K: neighbour kk's id and its P weights
  int j = 0;
  float wk[P];
#pragma unroll
  for (int p = 0; p < P; ++p) wk[p] = 0.0f;
  if (lane < K) {
    j = (int)nbh[(size_t)row * K + lane];
    if constexpr (MOMENTS) {
      const float* pr = w + (cloud * m + j) * (P - 1);
#pragma unroll
      for (int p = 1; p < P; ++p) wk[p] = pr[p - 1];
    } else {
      const float* wr = w + ((size_t)row * K + lane) * P;
#pragma unroll
      for (int p = 0; p < P; ++p) wk[p] = wr[p];
    }
  }
  if constexpr (MOMENTS) {  // delta = pos[nbh[kk]] - pos[nbh[0]]
#pragma unroll
    for (int p = 1; p < P; ++p) {
      wk[p] = __fsub_rn(wk[p], __shfl_sync(kFullMask, wk[p], 0, lanes));
      if constexpr (kBf16<T>) wk[p] = round_bf16(wk[p]);
    }
  }
  int jj[K];
  float ww[K][P];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    jj[kk] = __shfl_sync(kFullMask, j, kk, lanes);
#pragma unroll
    for (int p = 0; p < P; ++p)
      ww[kk][p] = (MOMENTS && p == 0)
                      ? 1.0f
                      : __shfl_sync(kFullMask, wk[p], kk, lanes);
  }
  const T* fb = feat + cloud * m * c;
  float* o = out + (size_t)row * P * c;
  for (int pass = 0; pass < plan.passes; ++pass) {
    const int ch = (pass * lanes + lane) * VEC;
    if (ch >= c) break;
    float f[K][VEC];  // all K gathers in flight before the first fmaf
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      load_vec<VEC>(fb + (size_t)jj[kk] * c + ch, f[kk]);
    float acc[P][VEC];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[p][v] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[p][v] = fmaf(ww[kk][p], f[kk][v], acc[p][v]);
      }
    }
    if constexpr (kBf16<T>) {  // m0 = jnp.sum of bf16: rounded once
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[0][v] = round_bf16(acc[0][v]);
    }
    if (live) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        store_vec_streaming<VEC>(o + (size_t)p * c + ch, acc[p]);
    }
  }
}

// C for any K <= 64 and any group size: a loop over k, every thread reading
// the ids and weights itself.
template <int P, int VEC, bool MOMENTS, typename T>
__global__ void __launch_bounds__(kThreads)
    weighted_sum_loop_kernel(const T* __restrict__ feat,
                             const int64_t* __restrict__ nbh,
                             const float* __restrict__ w,
                             float* __restrict__ out, long long rows, int n,
                             int m, int c, int k, RowPlan plan) {
  const int lanes = plan.lanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;
  const int lane = threadIdx.x & (lanes - 1);
  const size_t cloud = (size_t)(row / n);
  const T* fb = feat + cloud * m * c;
  const int64_t* nb = nbh + (size_t)row * k;
  const float* wr = MOMENTS ? w + cloud * m * (P - 1) : w + (size_t)row * k * P;
  float* o = out + (size_t)row * P * c;
  float centre[P];
  if constexpr (MOMENTS) {
#pragma unroll
    for (int p = 1; p < P; ++p) centre[p] = wr[(size_t)nb[0] * (P - 1) + p - 1];
  }
  for (int pass = 0; pass < plan.passes; ++pass) {
    const int ch = (pass * lanes + lane) * VEC;
    if (ch >= c) break;
    float acc[P][VEC];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[p][v] = 0.0f;
    }
    for (int kk = 0; kk < k; ++kk) {
      const size_t j = (size_t)nb[kk];
      float wv[P], f[VEC];
      if constexpr (MOMENTS) {
        wv[0] = 1.0f;
#pragma unroll
        for (int p = 1; p < P; ++p) {
          wv[p] = __fsub_rn(wr[j * (P - 1) + p - 1], centre[p]);
          if constexpr (kBf16<T>) wv[p] = round_bf16(wv[p]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) wv[p] = wr[kk * P + p];
      }
      load_vec<VEC>(fb + j * c + ch, f);
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[p][v] = fmaf(wv[p], f[v], acc[p][v]);
      }
    }
    if constexpr (kBf16<T>) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[0][v] = round_bf16(acc[0][v]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      store_vec_streaming<VEC>(o + (size_t)p * c + ch, acc[p]);
  }
}

// D's rule for the winner (the header comment): greater, or the first NaN.
__device__ __forceinline__ bool beats(float v, float best) {
  return v > best || (v != v && best == best);
}

// What D writes for VEC channels of a row: the values, the winning slots
// (unless slot is null) and the ids nb[slot] (unless arg is null), each as
// one store but the ids at VEC = 4, which are two of 16 bytes.
template <int VEC>
__device__ __forceinline__ void store_max(float* val, int64_t* arg,
                                          int8_t* slot, const int64_t* nb,
                                          size_t at, const float (&best)[VEC],
                                          const int (&bk)[VEC]) {
  store_vec<VEC>(val + at, best);
  if (slot != nullptr) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<char4*>(slot + at) =
          make_char4((signed char)bk[0], (signed char)bk[1],
                     (signed char)bk[2], (signed char)bk[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<char2*>(slot + at) =
          make_char2((signed char)bk[0], (signed char)bk[1]);
    } else {
      slot[at] = (int8_t)bk[0];
    }
  }
  if (arg != nullptr) {
    if constexpr (VEC == 1) {
      arg[at] = nb[bk[0]];
    } else {
#pragma unroll
      for (int v = 0; v < VEC; v += 2)
        *reinterpret_cast<longlong2*>(arg + at + v) =
            make_longlong2(nb[bk[v]], nb[bk[v + 1]]);
    }
  }
}

// D: the row groups of C; K at compile time and lanes >= K.
template <int VEC, int K>
__global__ void __launch_bounds__(kThreads)
    neighbor_max_unrolled_kernel(const float* __restrict__ feat,
                                 const int64_t* __restrict__ nbh,
                                 float* __restrict__ val,
                                 int64_t* __restrict__ arg,
                                 int8_t* __restrict__ slot, long long rows,
                                 int n, int m, int c, RowPlan plan) {
  const int lanes = plan.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  long long row =
      (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  if (!live) row = rows - 1;
  const int64_t* nb = nbh + (size_t)row * K;
  const int j = lane < K ? (int)nb[lane] : 0;
  int jj[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) jj[kk] = __shfl_sync(kFullMask, j, kk, lanes);
  const float* fb = feat + (size_t)(row / n) * m * c;
  for (int pass = 0; pass < plan.passes; ++pass) {
    const int ch = (pass * lanes + lane) * VEC;
    if (ch >= c) break;
    float f[K][VEC];  // all K gathers in flight before the first compare
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      load_vec<VEC>(fb + (size_t)jj[kk] * c + ch, f[kk]);
    float best[VEC];
    int bk[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) best[v] = f[0][v], bk[v] = 0;
#pragma unroll
    for (int kk = 1; kk < K; ++kk) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (beats(f[kk][v], best[v])) best[v] = f[kk][v], bk[v] = kk;
      }
    }
    if (live) store_max<VEC>(val, arg, slot, nb, (size_t)row * c + ch, best, bk);
  }
}

// D for any K <= 64 and any group size.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    neighbor_max_loop_kernel(const float* __restrict__ feat,
                             const int64_t* __restrict__ nbh,
                             float* __restrict__ val,
                             int64_t* __restrict__ arg,
                             int8_t* __restrict__ slot, long long rows, int n,
                             int m, int c, int k, RowPlan plan) {
  const int lanes = plan.lanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;
  const int lane = threadIdx.x & (lanes - 1);
  const float* fb = feat + (size_t)(row / n) * m * c;
  const int64_t* nb = nbh + (size_t)row * k;
  for (int pass = 0; pass < plan.passes; ++pass) {
    const int ch = (pass * lanes + lane) * VEC;
    if (ch >= c) break;
    float best[VEC], f[VEC];
    int bk[VEC];
    load_vec<VEC>(fb + (size_t)nb[0] * c + ch, best);
#pragma unroll
    for (int v = 0; v < VEC; ++v) bk[v] = 0;
    for (int kk = 1; kk < k; ++kk) {
      load_vec<VEC>(fb + (size_t)nb[kk] * c + ch, f);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (beats(f[v], best[v])) best[v] = f[v], bk[v] = kk;
      }
    }
    store_max<VEC>(val, arg, slot, nb, (size_t)row * c + ch, best, bk);
  }
}

constexpr int kEntryShift = 6;  // ent = (n << 6) | k, k < 64
constexpr int kEntryMask = (1 << kEntryShift) - 1;

// E: one row group per key row (b, j); each thread VEC channels of it.
// MOMENTS: `w` is the positions [b, m, P - 1] and the weights of the entry
// (n, k) of key j are [1, pos[j] - pos[nbh[n, 0]]], as C builds them.
// T: dfeat's type, the features' (bf16 only for the moments: the header's
// rounding points).
template <int P, int VEC, bool MOMENTS, typename T>
__global__ void __launch_bounds__(kThreads)
    weighted_sum_bwd_kernel(const float* __restrict__ dm,
                            const float* __restrict__ w,
                            const int64_t* __restrict__ nbh,
                            const int32_t* __restrict__ rowptr,
                            const int32_t* __restrict__ ent,
                            T* __restrict__ dfeat, int rows, int n, int m,
                            int c, int k, int tpr) {
  const int row = blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const int b = row / m;
  const int32_t* rp = rowptr + (size_t)b * (m + 1) + (row - b * m);
  const int begin = rp[0];
  const int end = rp[1];
  const int32_t* eb = ent + (size_t)b * n * k;
  const float* db = dm + (size_t)b * n * P * c;
  const float* wb =
      MOMENTS ? w + (size_t)b * m * (P - 1) : w + (size_t)b * n * k * P;
  const int64_t* nbb = MOMENTS ? nbh + (size_t)b * n * k : nullptr;
  float own[P];  // MOMENTS: this key's position
  if constexpr (MOMENTS) {
#pragma unroll
    for (int p = 1; p < P; ++p)
      own[p] = wb[(size_t)(row - b * m) * (P - 1) + p - 1];
  }
  for (int ch = lane * VEC; ch < c; ch += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    // entry e's weights and rows (cur), and entry e + 1's (nxt), loaded
    // before e's terms are added
    float wc[P], dc[P][VEC], wn[P], dn[P][VEC];
    auto fetch = [&](int id, float (&wv)[P], float (&dv)[P][VEC]) {
      const int nn = id >> kEntryShift;
      const float* d = db + (size_t)nn * P * c + ch;
      if constexpr (MOMENTS) {
        const float* centre = wb + (size_t)nbb[(size_t)nn * k] * (P - 1);
        wv[0] = 1.0f;
#pragma unroll
        for (int p = 1; p < P; ++p) {
          wv[p] = __fsub_rn(own[p], centre[p - 1]);
          if constexpr (kBf16<T>) wv[p] = round_bf16(wv[p]);
        }
      } else {
        const float* wr = wb + ((size_t)nn * k + (id & kEntryMask)) * P;
#pragma unroll
        for (int p = 0; p < P; ++p) wv[p] = wr[p];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) load_vec<VEC>(d + (size_t)p * c, dv[p]);
      if constexpr (kBf16<T>) {  // the cotangent of the bf16 m0
#pragma unroll
        for (int v = 0; v < VEC; ++v) dv[0][v] = round_bf16(dv[0][v]);
      }
    };
    if (begin < end) fetch(eb[begin], wc, dc);
    int id_next = begin + 1 < end ? eb[begin + 1] : 0;
    for (int e = begin; e < end; ++e) {
      const bool more = e + 1 < end;
      if (more) {
        fetch(id_next, wn, dn);
        if (e + 2 < end) id_next = eb[e + 2];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wc[p], dc[p][v], acc[v]);
      }
      if (more) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          wc[p] = wn[p];
#pragma unroll
          for (int v = 0; v < VEC; ++v) dc[p][v] = dn[p][v];
        }
      }
    }
    store_vec<VEC>(dfeat + (size_t)row * c + ch, acc);
  }
}

// F: the same traversal; an entry (n, kk) passes dval[n, c] on when kk is
// the slot that won channel c of row n.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    neighbor_max_bwd_kernel(const float* __restrict__ dval,
                            const int8_t* __restrict__ slot,
                            const int32_t* __restrict__ rowptr,
                            const int32_t* __restrict__ ent,
                            float* __restrict__ dfeat, int rows, int n, int m,
                            int c, int k, int tpr) {
  const int row = blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const int b = row / m;
  const int32_t* rp = rowptr + (size_t)b * (m + 1) + (row - b * m);
  const int begin = rp[0];
  const int end = rp[1];
  const int32_t* eb = ent + (size_t)b * n * k;
  const float* db = dval + (size_t)b * n * c;
  const int8_t* sb = slot + (size_t)b * n * c;
  for (int ch = lane * VEC; ch < c; ch += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int kc = 0, kn = 0, sc[VEC], sn[VEC];
    float dc[VEC], dn[VEC];
    auto fetch = [&](int id, int& kk, int (&sv)[VEC], float (&dv)[VEC]) {
      const size_t at = (size_t)(id >> kEntryShift) * c + ch;
      kk = id & kEntryMask;
      load_vec<VEC>(sb + at, sv);
      load_vec<VEC>(db + at, dv);
    };
    if (begin < end) fetch(eb[begin], kc, sc, dc);
    int id_next = begin + 1 < end ? eb[begin + 1] : 0;
    for (int e = begin; e < end; ++e) {
      const bool more = e + 1 < end;
      if (more) {
        fetch(id_next, kn, sn, dn);
        if (e + 2 < end) id_next = eb[e + 2];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (sc[v] == kc) acc[v] += dc[v];
      }
      if (more) {
        kc = kn;
#pragma unroll
        for (int v = 0; v < VEC; ++v) sc[v] = sn[v], dc[v] = dn[v];
      }
    }
    store_vec<VEC>(dfeat + (size_t)row * c + ch, acc);
  }
}

unsigned int blocks_for(long long rows, int tpr) {
  const long long per_block = kThreads / tpr;
  return (unsigned int)((rows + per_block - 1) / per_block);
}

// Whether C or D takes a plan: VEC of 4, 2 or 1 that divides C, with every
// float base a multiple of VEC floats, every bf16 base of VEC bf16s, every
// slot base of VEC bytes and every id base of 16 bytes when VEC > 1; a
// power of two of at most 32 lanes; as many passes as cover C and no more.
bool plan_ok(int c, RowPlan plan, uintptr_t float_bases, uintptr_t byte_bases,
             uintptr_t id_bases, uintptr_t bf16_bases = 0) {
  const int vec = plan.vec, lanes = plan.lanes;
  if (vec != 1 && vec != 2 && vec != 4) return false;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  if (c % vec != 0 || plan.passes != (c + vec * lanes - 1) / (vec * lanes))
    return false;
  return float_bases % (4 * vec) == 0 && byte_bases % vec == 0 &&
         bf16_bases % (2 * vec) == 0 && (vec == 1 || id_bases % 16 == 0);
}

template <typename T>
struct WeightedSumArgs {
  const T* feat;
  const int64_t* nbh;
  const float* w;  // weights, or positions for the moments
  float* out;
  long long rows;
  int n, m, c, k;
  RowPlan plan;
  cudaStream_t stream;
};

template <int P, int VEC, bool MOMENTS, typename T>
void launch_weighted_sum_vec(const WeightedSumArgs<T>& a) {
  const unsigned int grid = blocks_for(a.rows, a.plan.lanes);
  const bool unrolled = a.plan.lanes >= a.k;
  if constexpr (P == 4) {
    if (a.k == 8 && unrolled) {
      weighted_sum_unrolled_kernel<P, VEC, 8, MOMENTS, T>
          <<<grid, kThreads, 0, a.stream>>>(a.feat, a.nbh, a.w, a.out, a.rows,
                                            a.n, a.m, a.c, a.plan);
      return;
    }
  }
  if constexpr (P == 1 && !MOMENTS) {
    if (a.k == 3 && unrolled) {
      weighted_sum_unrolled_kernel<P, VEC, 3, false, T>
          <<<grid, kThreads, 0, a.stream>>>(a.feat, a.nbh, a.w, a.out, a.rows,
                                            a.n, a.m, a.c, a.plan);
      return;
    }
  }
  weighted_sum_loop_kernel<P, VEC, MOMENTS, T><<<grid, kThreads, 0, a.stream>>>(
      a.feat, a.nbh, a.w, a.out, a.rows, a.n, a.m, a.c, a.k, a.plan);
}

template <int P, bool MOMENTS, typename T>
void launch_weighted_sum(const WeightedSumArgs<T>& a) {
  if (a.plan.vec == 4)
    launch_weighted_sum_vec<P, 4, MOMENTS>(a);
  else if (a.plan.vec == 2)
    launch_weighted_sum_vec<P, 2, MOMENTS>(a);
  else
    launch_weighted_sum_vec<P, 1, MOMENTS>(a);
}

template <int VEC>
void launch_neighbor_max(const float* f, const int64_t* nb, float* val,
                         int64_t* arg, int8_t* slot, long long rows, int n,
                         int m, int c, int k, RowPlan plan, cudaStream_t s) {
  const unsigned int grid = blocks_for(rows, plan.lanes);
  if (k == 8 && plan.lanes >= k)
    neighbor_max_unrolled_kernel<VEC, 8><<<grid, kThreads, 0, s>>>(
        f, nb, val, arg, slot, rows, n, m, c, plan);
  else
    neighbor_max_loop_kernel<VEC><<<grid, kThreads, 0, s>>>(
        f, nb, val, arg, slot, rows, n, m, c, k, plan);
}

// The channels a thread of E or F takes: 4 or 2 where C divides into at
// least a warp's worth of such vectors and every row base is aligned for
// them, else 1.
int vec_width(int c, uintptr_t float_bases, uintptr_t byte_bases,
              uintptr_t bf16_bases = 0) {
  for (int v = 4; v > 1; v /= 2) {
    if (c % v == 0 && c / v >= 32 && float_bases % (4 * v) == 0 &&
        byte_bases % v == 0 && bf16_bases % (2 * v) == 0)
      return v;
  }
  return 1;
}

// The sizes E and F take: k <= 64 and n < 2^25 for the packed entries,
// b * m rows and n * k entries a cloud within int.
bool bwd_sizes_ok(int b, int n, int m, int c, int k) {
  return b >= 1 && n >= 1 && m >= 1 && c >= 1 && k >= 1 && k <= 64 &&
         n < (1 << 25) && (long long)b * m <= 0x7fffffff &&
         (long long)n * k <= 0x7fffffff;
}

template <int P, bool MOMENTS, typename T>
void launch_weighted_sum_bwd(int vec, unsigned int grid, cudaStream_t s,
                             const float* d, const float* wp,
                             const int64_t* nb, const int32_t* rp,
                             const int32_t* e, T* o, int rows, int n,
                             int m, int c, int k, int tpr) {
  if (vec == 4)
    weighted_sum_bwd_kernel<P, 4, MOMENTS, T><<<grid, kThreads, 0, s>>>(
        d, wp, nb, rp, e, o, rows, n, m, c, k, tpr);
  else if (vec == 2)
    weighted_sum_bwd_kernel<P, 2, MOMENTS, T><<<grid, kThreads, 0, s>>>(
        d, wp, nb, rp, e, o, rows, n, m, c, k, tpr);
  else
    weighted_sum_bwd_kernel<P, 1, MOMENTS, T><<<grid, kThreads, 0, s>>>(
        d, wp, nb, rp, e, o, rows, n, m, c, k, tpr);
}

// E's launch for weights (MOMENTS false, nbh unused) or positions; T is
// dfeat's type.
template <bool MOMENTS, typename T>
int weighted_sum_bwd(const void* dm, const void* w, const void* nbh,
                     const void* rowptr, const void* ent, void* dfeat, int b,
                     int n, int m, int c, int k, int p, void* stream) {
  if (!bwd_sizes_ok(b, n, m, c, k) || p < (MOMENTS ? 2 : 1) || p > 4)
    return (int)cudaErrorInvalidValue;
  const int rows = b * m;
  const int vec =
      kBf16<T> ? vec_width(c, (uintptr_t)dm, 0, (uintptr_t)dfeat)
               : vec_width(c, (uintptr_t)dm | (uintptr_t)dfeat, 0);
  const int tpr = threads_per_row(c / vec);
  const unsigned int grid = blocks_for(rows, tpr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dm);
  const float* wp = static_cast<const float*>(w);
  const int64_t* nb = static_cast<const int64_t*>(nbh);
  const int32_t* rp = static_cast<const int32_t*>(rowptr);
  const int32_t* e = static_cast<const int32_t*>(ent);
  T* o = static_cast<T*>(dfeat);
  switch (p) {
    case 1:
      if constexpr (!MOMENTS)
        launch_weighted_sum_bwd<1, false>(vec, grid, s, d, wp, nb, rp, e, o,
                                          rows, n, m, c, k, tpr);
      break;
    case 2:
      launch_weighted_sum_bwd<2, MOMENTS>(vec, grid, s, d, wp, nb, rp, e, o,
                                          rows, n, m, c, k, tpr);
      break;
    case 3:
      launch_weighted_sum_bwd<3, MOMENTS>(vec, grid, s, d, wp, nb, rp, e, o,
                                          rows, n, m, c, k, tpr);
      break;
    default:
      launch_weighted_sum_bwd<4, MOMENTS>(vec, grid, s, d, wp, nb, rp, e, o,
                                          rows, n, m, c, k, tpr);
      break;
  }
  return (int)cudaGetLastError();
}

// C's launch for weights (MOMENTS false) or positions; T is the features'
// type.
template <bool MOMENTS, typename T>
int weighted_sum(const void* feat, const void* nbh, const void* w, void* out,
                 int b, int n, int m, int c, int k, int p, int vec, int lanes,
                 int passes, void* stream) {
  const RowPlan plan{vec, lanes, passes};
  const bool fits =
      kBf16<T> ? plan_ok(c, plan, (uintptr_t)out, 0, 0, (uintptr_t)feat)
               : plan_ok(c, plan, (uintptr_t)feat | (uintptr_t)out, 0, 0);
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64 ||
      p < (MOMENTS ? 2 : 1) || p > 4 || !fits)
    return (int)cudaErrorInvalidValue;
  const WeightedSumArgs<T> a{static_cast<const T*>(feat),
                          static_cast<const int64_t*>(nbh),
                          static_cast<const float*>(w),
                          static_cast<float*>(out),
                          (long long)b * n,
                          n,
                          m,
                          c,
                          k,
                          plan,
                          static_cast<cudaStream_t>(stream)};
  switch (p) {
    case 1:
      if constexpr (!MOMENTS) launch_weighted_sum<1, false>(a);
      break;
    case 2:
      launch_weighted_sum<2, MOMENTS>(a);
      break;
    case 3:
      launch_weighted_sum<3, MOMENTS>(a);
      break;
    default:
      launch_weighted_sum<4, MOMENTS>(a);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feat [b, m, c] f32, nbh [b, n, k] int64 in [0, m), w [b, n, k, p] f32
// -> out [b, n, p * c] f32, with the plan (vec, lanes, passes) of
// `row_plan`.  Requires 1 <= p <= 4, 1 <= k <= 64 and a plan that fits c
// and the bases.
extern "C" int dh3d_weighted_sum(const void* feat, const void* nbh,
                                 const void* w, void* out, int b, int n,
                                 int m, int c, int k, int p, int vec,
                                 int lanes, int passes, void* stream) {
  return weighted_sum<false, float>(feat, nbh, w, out, b, n, m, c, k, p, vec,
                                    lanes, passes, stream);
}

// The same with the weights [1, pos[nbh[., k]] - pos[nbh[., 0]]] built from
// pos [b, m, p - 1] f32 (n = m rows or not: the ids index pos as they do
// feat).  Requires 2 <= p <= 4.
extern "C" int dh3d_flex_moments(const void* feat, const void* nbh,
                                 const void* pos, void* out, int b, int n,
                                 int m, int c, int k, int p, int vec,
                                 int lanes, int passes, void* stream) {
  return weighted_sum<true, float>(feat, nbh, pos, out, b, n, m, c, k, p, vec,
                                   lanes, passes, stream);
}

// The bf16 case: feat [b, m, c] bf16, pos f32 -> out [b, n, p * c] f32
// with the deltas and the p = 0 moment rounded to bf16 (the header).  A
// plan whose VEC bf16s do not fit feat's base is refused.
extern "C" int dh3d_flex_moments_bf16(const void* feat, const void* nbh,
                                      const void* pos, void* out, int b,
                                      int n, int m, int c, int k, int p,
                                      int vec, int lanes, int passes,
                                      void* stream) {
  return weighted_sum<true, __nv_bfloat16>(feat, nbh, pos, out, b, n, m, c, k,
                                           p, vec, lanes, passes, stream);
}

// feat [b, m, c] f32, nbh [b, n, k] int64 in [0, m) -> val [b, n, c] f32
// and, unless null, arg [b, n, c] int64 and slot [b, n, c] int8, with the
// plan (vec, lanes, passes) of `row_plan`.  Requires 1 <= k <= 64 and a
// plan that fits c and the bases.
extern "C" int dh3d_neighbor_max(const void* feat, const void* nbh, void* val,
                                 void* arg, void* slot, int b, int n, int m,
                                 int c, int k, int vec, int lanes, int passes,
                                 void* stream) {
  const RowPlan plan{vec, lanes, passes};
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64 ||
      !plan_ok(c, plan, (uintptr_t)feat | (uintptr_t)val, (uintptr_t)slot,
               (uintptr_t)arg))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const int64_t* nb = static_cast<const int64_t*>(nbh);
  float* v = static_cast<float*>(val);
  int64_t* a = static_cast<int64_t*>(arg);
  int8_t* sl = static_cast<int8_t*>(slot);
  if (vec == 4)
    launch_neighbor_max<4>(f, nb, v, a, sl, rows, n, m, c, k, plan, s);
  else if (vec == 2)
    launch_neighbor_max<2>(f, nb, v, a, sl, rows, n, m, c, k, plan, s);
  else
    launch_neighbor_max<1>(f, nb, v, a, sl, rows, n, m, c, k, plan, s);
  return (int)cudaGetLastError();
}

// dm [b, n, p * c] f32, w [b, n, k, p] f32, rowptr [b, m + 1] int32,
// ent [b, n * k] int32 (the CSR inverse of nbh) -> dfeat [b, m, c] f32.
// Requires 1 <= p <= 4, 1 <= k <= 64 and n < 2^25.
extern "C" int dh3d_weighted_sum_bwd(const void* dm, const void* w,
                                     const void* rowptr, const void* ent,
                                     void* dfeat, int b, int n, int m, int c,
                                     int k, int p, void* stream) {
  return weighted_sum_bwd<false, float>(dm, w, nullptr, rowptr, ent, dfeat, b,
                                        n, m, c, k, p, stream);
}

// The transpose of dh3d_flex_moments with respect to feat: the same with
// the weights built from pos [b, m, p - 1] f32 and nbh [b, n, k] int64.
// Requires 2 <= p <= 4.
extern "C" int dh3d_flex_moments_bwd(const void* dm, const void* pos,
                                     const void* nbh, const void* rowptr,
                                     const void* ent, void* dfeat, int b,
                                     int n, int m, int c, int k, int p,
                                     void* stream) {
  return weighted_sum_bwd<true, float>(dm, pos, nbh, rowptr, ent, dfeat, b, n,
                                       m, c, k, p, stream);
}

// The bf16 case: dm f32 with its p = 0 slice rounded to bf16, the weights
// [1, bf16(delta)] -> dfeat [b, m, c] bf16, rounded once (the header).
extern "C" int dh3d_flex_moments_bwd_bf16(const void* dm, const void* pos,
                                          const void* nbh, const void* rowptr,
                                          const void* ent, void* dfeat, int b,
                                          int n, int m, int c, int k, int p,
                                          void* stream) {
  return weighted_sum_bwd<true, __nv_bfloat16>(dm, pos, nbh, rowptr, ent,
                                               dfeat, b, n, m, c, k, p,
                                               stream);
}

// dval [b, n, c] f32, slot [b, n, c] int8, rowptr [b, m + 1] int32,
// ent [b, n * k] int32 (the CSR inverse of nbh) -> dfeat [b, m, c] f32.
// Requires 1 <= k <= 64 and n < 2^25.
extern "C" int dh3d_neighbor_max_bwd(const void* dval, const void* slot,
                                     const void* rowptr, const void* ent,
                                     void* dfeat, int b, int n, int m, int c,
                                     int k, void* stream) {
  if (!bwd_sizes_ok(b, n, m, c, k)) return (int)cudaErrorInvalidValue;
  const int rows = b * m;
  const int vec =
      vec_width(c, (uintptr_t)dval | (uintptr_t)dfeat, (uintptr_t)slot);
  const int tpr = threads_per_row(c / vec);
  const unsigned int grid = blocks_for(rows, tpr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dval);
  const int8_t* sl = static_cast<const int8_t*>(slot);
  const int32_t* rp = static_cast<const int32_t*>(rowptr);
  const int32_t* e = static_cast<const int32_t*>(ent);
  float* o = static_cast<float*>(dfeat);
  if (vec == 4)
    neighbor_max_bwd_kernel<4><<<grid, kThreads, 0, s>>>(d, sl, rp, e, o, rows,
                                                         n, m, c, k, tpr);
  else if (vec == 2)
    neighbor_max_bwd_kernel<2><<<grid, kThreads, 0, s>>>(d, sl, rp, e, o, rows,
                                                         n, m, c, k, tpr);
  else
    neighbor_max_bwd_kernel<1><<<grid, kThreads, 0, s>>>(d, sl, rp, e, o, rows,
                                                         n, m, c, k, tpr);
  return (int)cudaGetLastError();
}
