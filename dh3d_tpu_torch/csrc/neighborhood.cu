// Kernels C, D, E and F: reductions over a gathered neighbourhood and
// their transposes.
//
//   C  weighted_sum:  out[b, n, p*C + c] = sum_k w[b, n, k, p] * f[b, nbh[b, n, k], c]
//   D  neighbor_max:  val[b, n, c] = max_k f[b, nbh[b, n, k], c]
//                     arg[b, n, c] = nbh[b, n, k*], k* the lowest k attaining it
//                     slot[b, n, c] = k* (int8, optional: written only when
//                     the caller will need the backward)
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
//   E: _moments_bwd_kernel (P = 4: the moments are C with explicit weights
//      [1, delta], so their transpose is E with the same weights; the
//      centred-position trick of the TPU kernel has no counterpart),
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
// inverse of the neighbourhood, built by the caller with integer sorts
// (`inverse_neighbors` in ops/neighborhood.py): row pointers rowptr[b, j]
// and entries ent[b, e] = n*K + k, grouped by key j, ascending within it.
// Each output row dfeat[b, j, :] is owned by one row group of threads, which
// walks its key's entries in that order and sums in f32.  No atomics: every
// output element is written once, by one thread, with a fixed summation
// order, so the gradients are the same from run to run (the JAX package has
// no atomics either).
//
// What bounds them on an H100: device memory.  Per query row kernel C reads
// K indices (8 B each), K*P weights (4 B), K gathered feature rows of C
// floats and writes P*C floats: at P = 4, C = 64, K = 8 that is 64 + 128 +
// 2048 + 1024 bytes for 2*K*P*C = 4096 flops, about 1.3 flop/byte, far
// below the card's balance point.  The gathered rows are the bulk; a
// cloud's feature table (8192 x 64 x 4 B = 2 MB) sits in the 50 MB L2, so
// most of them are L2 hits.  The design makes every gathered row one
// coalesced read: the threads of a row group walk its channels, with
// neighbouring threads on neighbouring addresses.  Kernel D moves the same
// rows and writes a value and an int64 id a channel (and a byte of slot).
// E and F move the same bytes as C and D the other way round: for every
// entry of its key a row group reads one entry id (8 B, broadcast to the
// group), P weights (broadcast) and one cotangent row of P*C floats (F: C
// floats and C slot bytes), coalesced across the group's channels.
//
// Accumulation: over k (C, D) or over the key's CSR entries (E, F) in
// ascending order, one fmaf or add a term, in f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Threads a query row gets: the channel count rounded up to a power of two,
// capped at one warp, so that C = 3 packs 64 rows into a block while
// C >= 32 gives each row a full warp.
int threads_per_row(int c) {
  int t = 1;
  while (t < c && t < 32) t <<= 1;
  return t;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    weighted_sum_kernel(const float* __restrict__ feat,
                        const int64_t* __restrict__ nbh,
                        const float* __restrict__ w, float* __restrict__ out,
                        long long rows, int n, int m, int c, int k, int tpr) {
  const long long row =
      (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const float* fb = feat + (size_t)(row / n) * m * c;
  const int64_t* nb = nbh + (size_t)row * k;
  const float* wr = w + (size_t)row * k * P;
  float* o = out + (size_t)row * P * c;
  for (int ch = lane; ch < c; ch += tpr) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      const float v = fb[(size_t)nb[kk] * c + ch];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = fmaf(wr[kk * P + p], v, acc[p]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) o[(size_t)p * c + ch] = acc[p];
  }
}

__global__ void __launch_bounds__(kThreads)
    neighbor_max_kernel(const float* __restrict__ feat,
                        const int64_t* __restrict__ nbh,
                        float* __restrict__ val, int64_t* __restrict__ arg,
                        int8_t* __restrict__ slot, long long rows, int n,
                        int m, int c, int k, int tpr) {
  const long long row =
      (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const float* fb = feat + (size_t)(row / n) * m * c;
  const int64_t* nb = nbh + (size_t)row * k;
  for (int ch = lane; ch < c; ch += tpr) {
    int64_t best_j = nb[0];
    int best_k = 0;
    float best = fb[(size_t)best_j * c + ch];
    for (int kk = 1; kk < k; ++kk) {
      const int64_t j = nb[kk];
      const float v = fb[(size_t)j * c + ch];
      if (v > best) {  // strict: ties keep the lowest k
        best = v;
        best_j = j;
        best_k = kk;
      }
    }
    val[(size_t)row * c + ch] = best;
    arg[(size_t)row * c + ch] = best_j;
    if (slot != nullptr) slot[(size_t)row * c + ch] = (int8_t)best_k;
  }
}

// E: one row group per key row (b, j), threads over its channels.
template <int P>
__global__ void __launch_bounds__(kThreads)
    weighted_sum_bwd_kernel(const float* __restrict__ dm,
                            const float* __restrict__ w,
                            const int64_t* __restrict__ rowptr,
                            const int64_t* __restrict__ ent,
                            float* __restrict__ dfeat, long long rows, int n,
                            int m, int c, int k, int tpr) {
  const long long row =
      (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const long long b = row / m;
  const long long j = row - b * m;
  const int64_t begin = rowptr[b * (m + 1) + j];
  const int64_t end = rowptr[b * (m + 1) + j + 1];
  const int64_t* eb = ent + (size_t)b * n * k;
  const float* db = dm + (size_t)b * n * P * c;
  const float* wb = w + (size_t)b * n * k * P;
  for (int ch = lane; ch < c; ch += tpr) {
    float acc = 0.0f;
    for (int64_t e = begin; e < end; ++e) {
      const int64_t flat = eb[e];  // n * k + kk
      const float* wr = wb + (size_t)flat * P;
      const float* d = db + (size_t)(flat / k) * P * c + ch;
#pragma unroll
      for (int p = 0; p < P; ++p) acc = fmaf(wr[p], d[(size_t)p * c], acc);
    }
    dfeat[(size_t)row * c + ch] = acc;
  }
}

// F: the same traversal; an entry (n, kk) passes dval[n, c] on when kk is
// the slot that won channel c of row n.
__global__ void __launch_bounds__(kThreads)
    neighbor_max_bwd_kernel(const float* __restrict__ dval,
                            const int8_t* __restrict__ slot,
                            const int64_t* __restrict__ rowptr,
                            const int64_t* __restrict__ ent,
                            float* __restrict__ dfeat, long long rows, int n,
                            int m, int c, int k, int tpr) {
  const long long row =
      (long long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= rows) return;
  const int lane = threadIdx.x % tpr;
  const long long b = row / m;
  const long long j = row - b * m;
  const int64_t begin = rowptr[b * (m + 1) + j];
  const int64_t end = rowptr[b * (m + 1) + j + 1];
  const int64_t* eb = ent + (size_t)b * n * k;
  const float* db = dval + (size_t)b * n * c;
  const int8_t* sb = slot + (size_t)b * n * c;
  for (int ch = lane; ch < c; ch += tpr) {
    float acc = 0.0f;
    for (int64_t e = begin; e < end; ++e) {
      const int64_t flat = eb[e];
      const int64_t nn = flat / k;
      const int kk = (int)(flat - nn * k);
      const size_t at = (size_t)nn * c + ch;
      if (sb[at] == kk) acc += db[at];
    }
    dfeat[(size_t)row * c + ch] = acc;
  }
}

unsigned int blocks_for(long long rows, int tpr) {
  const long long per_block = kThreads / tpr;
  return (unsigned int)((rows + per_block - 1) / per_block);
}

}  // namespace

// feat [b, m, c] f32, nbh [b, n, k] int64 in [0, m), w [b, n, k, p] f32
// -> out [b, n, p * c] f32.  Requires 1 <= p <= 4 and 1 <= k <= 64.
extern "C" int dh3d_weighted_sum(const void* feat, const void* nbh,
                                 const void* w, void* out, int b, int n,
                                 int m, int c, int k, int p, void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64 || p < 1 || p > 4)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  const int tpr = threads_per_row(c);
  const unsigned int grid = blocks_for(rows, tpr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const int64_t* nb = static_cast<const int64_t*>(nbh);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  switch (p) {
    case 1:
      weighted_sum_kernel<1><<<grid, kThreads, 0, s>>>(f, nb, wp, o, rows, n,
                                                       m, c, k, tpr);
      break;
    case 2:
      weighted_sum_kernel<2><<<grid, kThreads, 0, s>>>(f, nb, wp, o, rows, n,
                                                       m, c, k, tpr);
      break;
    case 3:
      weighted_sum_kernel<3><<<grid, kThreads, 0, s>>>(f, nb, wp, o, rows, n,
                                                       m, c, k, tpr);
      break;
    default:
      weighted_sum_kernel<4><<<grid, kThreads, 0, s>>>(f, nb, wp, o, rows, n,
                                                       m, c, k, tpr);
      break;
  }
  return (int)cudaGetLastError();
}

// feat [b, m, c] f32, nbh [b, n, k] int64 in [0, m) -> val [b, n, c] f32,
// arg [b, n, c] int64 and, unless slot is null, slot [b, n, c] int8.
// Requires 1 <= k <= 64.
extern "C" int dh3d_neighbor_max(const void* feat, const void* nbh, void* val,
                                 void* arg, void* slot, int b, int n, int m,
                                 int c, int k, void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * n;
  const int tpr = threads_per_row(c);
  neighbor_max_kernel<<<blocks_for(rows, tpr), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int64_t*>(nbh),
      static_cast<float*>(val), static_cast<int64_t*>(arg),
      static_cast<int8_t*>(slot), rows, n, m, c, k, tpr);
  return (int)cudaGetLastError();
}

// dm [b, n, p * c] f32, w [b, n, k, p] f32, rowptr [b, m + 1] int64,
// ent [b, n * k] int64 (the CSR inverse of nbh) -> dfeat [b, m, c] f32.
// Requires 1 <= p <= 4 and 1 <= k <= 64.
extern "C" int dh3d_weighted_sum_bwd(const void* dm, const void* w,
                                     const void* rowptr, const void* ent,
                                     void* dfeat, int b, int n, int m, int c,
                                     int k, int p, void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64 || p < 1 || p > 4)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * m;
  const int tpr = threads_per_row(c);
  const unsigned int grid = blocks_for(rows, tpr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dm);
  const float* wp = static_cast<const float*>(w);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int64_t* e = static_cast<const int64_t*>(ent);
  float* o = static_cast<float*>(dfeat);
  switch (p) {
    case 1:
      weighted_sum_bwd_kernel<1><<<grid, kThreads, 0, s>>>(d, wp, rp, e, o,
                                                           rows, n, m, c, k,
                                                           tpr);
      break;
    case 2:
      weighted_sum_bwd_kernel<2><<<grid, kThreads, 0, s>>>(d, wp, rp, e, o,
                                                           rows, n, m, c, k,
                                                           tpr);
      break;
    case 3:
      weighted_sum_bwd_kernel<3><<<grid, kThreads, 0, s>>>(d, wp, rp, e, o,
                                                           rows, n, m, c, k,
                                                           tpr);
      break;
    default:
      weighted_sum_bwd_kernel<4><<<grid, kThreads, 0, s>>>(d, wp, rp, e, o,
                                                           rows, n, m, c, k,
                                                           tpr);
      break;
  }
  return (int)cudaGetLastError();
}

// dval [b, n, c] f32, slot [b, n, c] int8, rowptr [b, m + 1] int64,
// ent [b, n * k] int64 (the CSR inverse of nbh) -> dfeat [b, m, c] f32.
// Requires 1 <= k <= 64.
extern "C" int dh3d_neighbor_max_bwd(const void* dval, const void* slot,
                                     const void* rowptr, const void* ent,
                                     void* dfeat, int b, int n, int m, int c,
                                     int k, void* stream) {
  if (b < 1 || n < 1 || m < 1 || c < 1 || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * m;
  const int tpr = threads_per_row(c);
  neighbor_max_bwd_kernel<<<blocks_for(rows, tpr), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dval), static_cast<const int8_t*>(slot),
      static_cast<const int64_t*>(rowptr), static_cast<const int64_t*>(ent),
      static_cast<float*>(dfeat), rows, n, m, c, k, tpr);
  return (int)cudaGetLastError();
}
