// Kernel H: the k nearest keys of every query within its query tile's
// Morton band, the kNN of the legacy approximate mode (morton_exact=False):
// the self kNN at full resolution (k = knn_num, W = 512) and, at a level
// wider than 2048 points, its self kNN (W = 512) and its 3-NN upsample
// (W = 256).
//
// Replaces (dh3d_tpu/ops/pallas/knn_pallas.py):
//   _knn_kernel_banded with a window of W < M key rows (its whole-table
//   case is kernel A's 3-NN).  The TPU kernel builds a [256, W] distance
//   tile in VMEM from the band at `_win_start` and runs k min-extraction
//   passes over it; the model calls it packed (distance and lane index in
//   one int32, distances truncated).  This kernel computes the unpacked
//   case, `knn_banded(..., packed=False)`: exact d2 and the (d2, index)
//   order, as the port's exact kNN kernels do.
//
// What it computes: query tile i is rows [256 i, 256 i + 256); its band
// starts at s_i = floor(clip(c - W/2, 0, M - W) / 128) * 128 with
// c = ((2i + 1) * 256 * M) // (2N), computed here in 64 bits.  (The JAX
// kernel computes (2i + 1) * 256 * M in int32, which wraps for a self
// query above N = 32768: there its starts differ from these.)  Each query
// gets the k nearest of keys [s_i, s_i + W), as ids into the whole key
// table (s_i + lane) with their d2.
//
// Design (a simple kernel, not yet tuned): one block for each (tile,
// cloud), one thread for each of the tile's 256 queries.  The block
// stages its band in shared memory as float4 {x, y, z, 0}, 1024 keys a
// pass (a band of 512 is one pass of 8 KB), so every key is one broadcast
// 16-byte load.  A thread keeps a sorted list of its KMAX best candidates
// in registers, KMAX in {4, 8, 16, 32} the least that holds k.  Each
// candidate is one 64-bit key, (d2's bits << 32) | id: d2 >= 0 (a sum of
// squares, never -0) orders as its unsigned bits, and a NaN is given the
// one canonical NaN's bits, which order above +inf, so one unsigned
// compare gives the (d2, index) order with NaN last, as a stable sort
// gives it.  The band is scanned in ascending id and a key enters the
// list only on a strict `<`, so among equal distances the lowest id comes
// first.
//
// What bounds it on an H100: issued instructions.  At [20, 8192], W = 512
// the 8.4e7 query-key pairs each issue a broadcast LDS.128, 3 FADD (the
// differences), 3 FMUL, 2 FADD, the NaN select and a 64-bit compare; the
// insertions are rare once the list has filled.  The bytes (queries,
// keys, outputs) are a few MB.
//
// Contract, shared with the plain version in ops/knn.py (`knn_window`):
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA contraction), so the plain PyTorch
//   version reproduces d2, and the ids, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 256;  // queries a tile: one thread each
constexpr int kAlign = 128;  // a band starts on a multiple of it
constexpr int kStage = 1024; // band keys staged in shared memory a pass
constexpr int kMaxK = 32;

// Insert `key` into the ascending list l of length KMAX, after every entry
// below it.  The caller has checked key < l[KMAX - 1].  Fully unrolled so
// the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert_sorted(uint64_t (&l)[KMAX],
                                              uint64_t key) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (l[s - 1] > key) {  // the entry above is worse: shift it down
      l[s] = l[s - 1];
    } else if (l[s] > key) {  // l[s-1] < key < l[s]: the slot is s
      l[s] = key;
    }
  }
  if (l[0] > key) l[0] = key;
}

// The candidate's 64-bit key: d2's bits (NaN as the canonical NaN) above
// its id.
__device__ __forceinline__ uint64_t candidate(float qx, float qy, float qz,
                                              float4 k, uint32_t id) {
  const float dx = __fsub_rn(qx, k.x);
  const float dy = __fsub_rn(qy, k.y);
  const float dz = __fsub_rn(qz, k.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const uint32_t bits = d2 != d2 ? 0x7fc00000u : __float_as_uint(d2);
  return (static_cast<uint64_t>(bits) << 32) | id;
}

// Grid (nq / kTileQ, B), kTileQ threads.  Block (i, b) searches the band
// of tile i for its queries and writes the first k entries of each list.
template <int KMAX>
__global__ void __launch_bounds__(kTileQ)
    knn_window_kernel(const float* __restrict__ query,
                      const float* __restrict__ keys,
                      int64_t* __restrict__ idx_out,
                      float* __restrict__ d2_out, int nq, int nk, int k,
                      int window) {
  __shared__ float4 band[kStage];
  const int b = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t centre = (2 * tile + 1) * kTileQ * (int64_t)nk / (2 * (int64_t)nq);
  int64_t start = centre - window / 2;
  start = start < 0 ? 0 : start;
  start = start > nk - window ? nk - window : start;
  start = start / kAlign * kAlign;

  const int q = (int)tile * kTileQ + threadIdx.x;  // nq % kTileQ == 0
  const float* qp = query + ((size_t)b * nq + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* kb = keys + ((size_t)b * nk + start) * 3;

  uint64_t list[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) list[r] = ~0ull;

  for (int t0 = 0; t0 < window; t0 += kStage) {
    const int tn = min(kStage, window - t0);
    __syncthreads();  // the previous pass has been consumed
    for (int j = threadIdx.x; j < tn; j += kTileQ) {
      const float* kp = kb + (size_t)(t0 + j) * 3;
      band[j] = make_float4(kp[0], kp[1], kp[2], 0.0f);
    }
    __syncthreads();
    const uint32_t id0 = (uint32_t)(start + t0);
#pragma unroll 8
    for (int j = 0; j < tn; ++j) {  // ascending ids
      const uint64_t c = candidate(qx, qy, qz, band[j], id0 + j);
      if (c < list[KMAX - 1]) insert_sorted<KMAX>(list, c);
    }
  }

  const size_t row = (size_t)b * nq + q;
  int64_t* io = idx_out + row * k;
  float* dout = d2_out + row * k;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      io[r] = (int64_t)(uint32_t)list[r];
      dout[r] = __uint_as_float((uint32_t)(list[r] >> 32));
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* q, const float* keys, int64_t* idx, float* d2,
                   int b, int nq, int nk, int k, int window,
                   cudaStream_t stream) {
  const dim3 grid(nq / kTileQ, b);
  knn_window_kernel<KMAX><<<grid, kTileQ, 0, stream>>>(q, keys, idx, d2, nq,
                                                       nk, k, window);
  return cudaGetLastError();
}

}  // namespace

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64 (into
// the whole key table), d2 [b, nq, k] f32, ascending by (d2, index), each
// query among the `window` keys of its tile's band.  Requires nq % 256 ==
// 0, window % 128 == 0, 0 < window <= nk and 1 <= k <= min(window, 32);
// returns cudaErrorInvalidValue otherwise.  Launches on `stream` and does
// not synchronise.
extern "C" int dh3d_knn_window(const void* query, const void* keys,
                               void* idx, void* d2, int b, int nq, int nk,
                               int k, int window, void* stream) {
  if (b < 1 || b > 65535 || nq < kTileQ || nq % kTileQ != 0 ||
      window < kAlign || window % kAlign != 0 || window > nk || k < 1 ||
      k > kMaxK || k > window)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the list length is a compile-time constant so that it lives in
  // registers; the first k of the sorted top-KMAX are the top k
  if (k <= 4) return (int)launch<4>(qp, kp, io, dp, b, nq, nk, k, window, st);
  if (k <= 8) return (int)launch<8>(qp, kp, io, dp, b, nq, nk, k, window, st);
  if (k <= 16)
    return (int)launch<16>(qp, kp, io, dp, b, nq, nk, k, window, st);
  return (int)launch<32>(qp, kp, io, dp, b, nq, nk, k, window, st);
}
