// Kernel G: exact k nearest neighbours for large k (33 <= k <= 128 on the
// port's path; the entry point takes any 1 <= k <= 128) of every query among
// the keys of the same batch entry.
//
// Replaces (dh3d_tpu/ops/pallas/knn_pallas.py):
//   _knn_kernel_slab  (+ the stable XLA merge of _knn_slabbed_call): every
//                     k >= 32; on the path, keypoint NMS asks for the exact
//                     50 nearest neighbours of every point of a 16384-point
//                     cloud (dh3d_tpu/eval/nms.py:59-60).
// The TPU kernel puts key slabs on the grid, extracts each slab's top k by
// k unrolled min/argmin/mask passes over a [TQ, slab] distance tile in
// VMEM, and merges the S * k candidates with a stable sort in XLA.  Here
// one warp owns one query and scans every key once; the query's sorted
// list of its best (d2, index) pairs is spread over the warp's registers
// (list position s lives in lane s % 32, register s / 32), so a list of
// 128 pairs costs each lane 4 + 4 registers and never spills, and no
// candidate array is ever stored.
//
// What bounds it on an H100: instruction throughput.  Per query, Nk / 32 warp
// steps of (distance, compare with the k-th best, ballot), plus one
// insertion per candidate that beats the k-th best: on keys in random
// order about k * ln(Nk / k) of them (~290 at k = 50, Nk = 16384), each a
// ballot, a popcount and two shuffles per register of the list.  One warp
// per query gives 16384 warps at B = 1, N = 16384: two waves over 132 SMs,
// where a thread per query (kernel A) would fill 64 blocks.  Key tiles are
// staged in shared memory once per block of 8 queries and read as
// conflict-free consecutive words.
//
// Contract, shared with the plain version in ops/knn.py and with kernel A:
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA contraction);
//   keys are offered in ascending index order, a candidate enters only on a
//   strict `<` against the k-th best, and it is inserted after every entry
//   with an equal distance, so among equal distances the lowest index comes
//   first and a self query lands at slot 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // queries per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;  // keys staged in shared memory per pass
constexpr unsigned kFull = 0xffffffffu;

// Insert (d, j) into the warp-distributed ascending list (bd, bi): position
// s = 32 * r + lane.  Every lane passes the same (d, j).  The new pair goes
// after every entry whose distance is <= d; the entries from there on move
// down one position and the last one drops out.
template <int R>
__device__ __forceinline__ void warp_insert(float (&bd)[R], int (&bi)[R],
                                            float d, int j, int lane) {
  int p = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) p += __popc(__ballot_sync(kFull, bd[r] <= d));
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {  // descending: bd[r - 1] is still old
    float pd = __shfl_up_sync(kFull, bd[r], 1);
    int pi = __shfl_up_sync(kFull, bi[r], 1);
    if (r > 0) {  // lane 0's predecessor is lane 31 of the register before
      const float cd = __shfl_sync(kFull, bd[r - 1], 31);
      const int ci = __shfl_sync(kFull, bi[r - 1], 31);
      if (lane == 0) {
        pd = cd;
        pi = ci;
      }
    }
    const int s = 32 * r + lane;
    if (s == p) {
      bd[r] = d;
      bi[r] = j;
    } else if (s > p) {
      bd[r] = pd;
      bi[r] = pi;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ query,
                    const float* __restrict__ keys,
                    int64_t* __restrict__ idx_out, float* __restrict__ d2_out,
                    int nq, int nk, int k) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = q < nq;  // uniform across the warp
  const float* qp = query + ((size_t)b * nq + (active ? q : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* kb = keys + (size_t)b * nk * 3;
  const int kr = (k - 1) >> 5, kl = (k - 1) & 31;  // where the k-th best is

  float bd[R];
  int bi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bd[r] = INFINITY;
    bi[r] = 0;
  }
  float thresh = INFINITY;

  for (int t0 = 0; t0 < nk; t0 += kTile) {
    const int tn = min(kTile, nk - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      const float* kp = kb + (size_t)(t0 + j) * 3;
      sx[j] = kp[0];
      sy[j] = kp[1];
      sz[j] = kp[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < tn; c += 32) {
      const int j = c + lane;
      float d = INFINITY;
      if (j < tn) {
        const float dx = __fsub_rn(qx, sx[j]);
        const float dy = __fsub_rn(qy, sy[j]);
        const float dz = __fsub_rn(qz, sz[j]);
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
      }
      unsigned mask = __ballot_sync(kFull, d < thresh);
      while (mask) {  // candidates in ascending key index
        const int src = __ffs(mask) - 1;
        const float dc = __shfl_sync(kFull, d, src);
        warp_insert<R>(bd, bi, dc, t0 + c + src, lane);
        // the k-th best after the insertion, for every lane
        float kth = bd[0];
#pragma unroll
        for (int r = 1; r < R; ++r)
          if (r == kr) kth = bd[r];
        thresh = __shfl_sync(kFull, kth, kl);
        mask &= mask - 1;
        mask &= __ballot_sync(kFull, d < thresh);
      }
    }
  }

  if (active) {
    int64_t* io = idx_out + ((size_t)b * nq + q) * k;
    float* dout = d2_out + ((size_t)b * nq + q) * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = 32 * r + lane;
      if (s < k) {
        io[s] = bi[r];
        dout[s] = bd[r];
      }
    }
  }
}

template <int R>
cudaError_t launch(const float* q, const float* keys, int64_t* idx, float* d2,
                   int b, int nq, int nk, int k, cudaStream_t stream) {
  const dim3 grid((nq + kWarps - 1) / kWarps, b);
  knn_topk_kernel<R><<<grid, kThreads, 0, stream>>>(q, keys, idx, d2, nq, nk,
                                                    k);
  return cudaGetLastError();
}

}  // namespace

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64,
// d2 [b, nq, k] f32, both ascending by distance.  Requires 1 <= k <= 128 and
// k <= nk.  Launches on `stream` and does not synchronise.
extern "C" int dh3d_knn_topk(const void* query, const void* keys, void* idx,
                             void* d2, int b, int nq, int nk, int k,
                             void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || k < 1 || k > 128 || k > nk || b > 65535)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the list holds 32 * R pairs; the first k of it are the answer
  if (k <= 64) return (int)launch<2>(q, kp, io, dp, b, nq, nk, k, s);
  return (int)launch<4>(q, kp, io, dp, b, nq, nk, k, s);
}
