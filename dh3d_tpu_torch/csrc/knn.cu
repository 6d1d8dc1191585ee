// Kernel A: exact k nearest neighbours (k <= 32) of every query among the
// keys of the same batch entry.
//
// Replaces (dh3d_tpu/ops/pallas/knn_pallas.py):
//   _knn_kernel_packed  (self-kNN, k=8, at N=8192 and N=1024)
//   _knn_kernel_banded  (3-NN from 8192 queries to 1024 keys; on the main
//                        path its window is the whole key table, so it is
//                        exact 3-NN)
//   _knn_kernel         (exact cross kNN: the detection loss's k=16 queries)
// The TPU kernels build a [TQ, N] distance tile in VMEM and run k
// min-extraction passes over it (packed: distance and lane index in one
// int32, so distances come back truncated); `_knn_kernel_slab` puts key
// slabs on the grid and merges the slabs' top k stably.  Here each thread
// keeps a sorted list of its query's k best (d2, index) pairs in registers,
// so no distance tile is ever stored and distances are exact.
//
// What bounds it on an H100: issued instructions.  Self-kNN at [20, 8192]
// is 1.3e9 query-key pairs with no FMA allowed (see the contract): each
// pair issues at least a key load, 2 sub, 2 mul, 1 add and 1 compare (the
// x-y test below), those that pass it 1 sub, 1 mul, 1 add and 1 compare
// more, and a warp runs a register insertion (~50 instructions) whenever
// one of its lanes' candidates passes.  The design:
//   - a key tile is staged in shared memory as float4 {x, y, z, 0}, so a key
//     is one broadcast 16-byte load; a thread owns one query, with its list
//     in registers; a warp's lanes own neighbouring queries, Morton
//     neighbours on the main path;
//   - U = 8 keys a step: their distances are independent, so loads and
//     arithmetic overlap.  A step first sums dx*dx + dy*dy;
//     adding dz*dz >= 0 in round-to-nearest cannot lower that sum, so when
//     every partial sum of the warp's step already reaches its threshold
//     (most steps on Morton-ordered clouds) the step ends there, before
//     the z terms; else one more branch decides whether any key may enter
//     a list;
//   - a bound: before the scan each query's list is filled from a window of
//     32 keys (64 at k = 32) around its proportional position in the keys;
//     the KMAX-th distance there bounds its KMAX-th nearest from above (any
//     KMAX keys give such a bound), and the list is reset.  The scan then
//     lets a key in only below both the list's last distance and the bound:
//     a key beyond the bound cannot be among the KMAX nearest, so the list
//     ends as it would without it, but on Morton-ordered clouds the bound is
//     tight and few steps branch (on an H100, insertions took half of
//     self k=8 [20, 8192] without it).
//   - where B * ceil(Nq / 256) blocks cannot fill the card, the keys
//     are split into S contiguous ascending slabs on grid.z (the TPU's own
//     slab design).  Each (query tile, slab) block writes its slab's sorted
//     top k into scratch [S, B, Nq, k], and a second kernel merges the S
//     lists of each query, taking from the lower slab on equal distances.
//   S is chosen by `knn_plan` in ops/knn.py from a sweep of every S
//   (`chip_smoke.py --sweep`).  Tried and slower (PERF.md): Q = 2 or 4
//   queries a thread, so that one key load feeds Q distances (more
//   registers, fewer warps, no fewer instructions a pair); scanning from the
//   query's own tile and wrapping around, with a (d2, index) order.
//
// Contract, shared with the plain version in ops/knn.py:
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA contraction), so the plain PyTorch
//   version reproduces d2 bit for bit;
//   within a slab keys are scanned in ascending index order and a candidate
//   enters the list only on a strict `<`, so among equal distances the
//   lowest index comes first; the slabs ascend and the merge takes the lower
//   slab on ties, which keeps that order across slabs.  A self query's own
//   distance is exactly 0, so it lands at slot 0 (an exact duplicate with a
//   lower index would come before it).  Every list starts as k copies of
//   (+inf, 0), so a slab shorter than k keeps such pads; the merge takes one
//   only where fewer than k keys have a finite distance, which is then the
//   one-pass kernel's output too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kTile = 1024;    // keys staged in shared memory per pass
constexpr int kMaxSlabs = 64;  // the most slabs the merge takes
constexpr int kMergeThreads = 128;

// Insert (d, j) into the ascending list (bd, bi) of length KMAX, after
// every entry whose distance is <= d.  The caller has checked
// d < bd[KMAX - 1].  Fully unrolled so the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert_sorted(float (&bd)[KMAX],
                                              int (&bi)[KMAX], float d,
                                              int j) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {
    if (bd[s - 1] > d) {  // entry above is worse: shift it down
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (bd[s] > d) {  // bd[s-1] <= d < bd[s]: the slot is s
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (bd[0] > d) {
    bd[0] = d;
    bi[0] = j;
  }
}

// (qx - k.x)^2 + (qy - k.y)^2 + (qz - k.z)^2, each operation rounded on its
// own, summed left to right.
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float4 k) {
  const float dx = __fsub_rn(qx, k.x);
  const float dy = __fsub_rn(qy, k.y);
  const float dz = __fsub_rn(qz, k.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Grid (ceil(nq / kThreads), B, S).  Block (x, b, s) scans keys
// [s * slab_len, min(nk, (s + 1) * slab_len)) for queries x * kThreads +
// threadIdx.x.  With S == 1 (slab_d2 == nullptr) it writes the first k
// entries of each list to idx_out / d2_out; else its slab's k entries to
// slab_d2 / slab_idx [S, B, nq, k].
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ keys,
               int64_t* __restrict__ idx_out, float* __restrict__ d2_out,
               float* __restrict__ slab_d2, int* __restrict__ slab_idx,
               int nq, int nk, int k, int slab_len) {
  constexpr int U = 8;  // keys a step
  constexpr int kWindow = KMAX <= 16 ? 32 : 64;
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int lo = s * slab_len;
  const int hi = min(nk, lo + slab_len);
  const float* kb = keys + (size_t)b * nk * 3;

  const int q = min(qi, nq - 1);
  const float* qp = query + ((size_t)b * nq + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    bd[r] = INFINITY;
    bi[r] = 0;
  }
  // the bound: the KMAX-th distance in the window (the list as scratch)
  {
    const int w = min(nk, kWindow);
    const int p = min(nk - 1, (int)((float)q * ((float)nk / (float)nq)));
    const int w0 = max(0, min(p - w / 2, nk - w));
    for (int a = 0; a < w; ++a) {
      const float* kp = kb + (size_t)(w0 + a) * 3;
      const float d =
          dist2(qx, qy, qz, make_float4(kp[0], kp[1], kp[2], 0.0f));
      if (d < bd[KMAX - 1]) insert_sorted<KMAX>(bd, bi, d, 0);
    }
  }
  const float tau = nextafterf(bd[KMAX - 1], INFINITY);  // enter below it
  float thr = tau;  // min(the list's last distance, tau)
#pragma unroll
  for (int r = 0; r < KMAX; ++r) bd[r] = INFINITY;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int tn = min(kTile, hi - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      const float* kp = kb + (size_t)(t0 + j) * 3;
      tile[j] = make_float4(kp[0], kp[1], kp[2], 0.0f);
    }
    __syncthreads();
    if (qi < nq) {  // a thread past the last query idles
      int j = 0;
      for (; j + U <= tn; j += U) {
        float4 kv[U];
        float d[U];
        bool near = false;
#pragma unroll
        for (int a = 0; a < U; ++a) kv[a] = tile[j + a];
#pragma unroll
        for (int a = 0; a < U; ++a) {
          const float dx = __fsub_rn(qx, kv[a].x);
          const float dy = __fsub_rn(qy, kv[a].y);
          d[a] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          near |= d[a] < thr;
        }
        if (!near) continue;  // d2 >= dx*dx + dy*dy >= thr for all of them
        bool any = false;
#pragma unroll
        for (int a = 0; a < U; ++a) {
          const float dz = __fsub_rn(qz, kv[a].z);
          d[a] = __fadd_rn(d[a], __fmul_rn(dz, dz));
          any |= d[a] < thr;
        }
        if (any) {
#pragma unroll
          for (int a = 0; a < U; ++a)  // ascending keys
            if (d[a] < thr) {
              insert_sorted<KMAX>(bd, bi, d[a], t0 + j + a);
              thr = fminf(bd[KMAX - 1], tau);
            }
        }
      }
      for (; j < tn; ++j) {
        const float d = dist2(qx, qy, qz, tile[j]);
        if (d < thr) {
          insert_sorted<KMAX>(bd, bi, d, t0 + j);
          thr = fminf(bd[KMAX - 1], tau);
        }
      }
    }
  }

  if (qi >= nq) return;
  const size_t row = (size_t)b * nq + qi;
  if (slab_d2 == nullptr) {
    int64_t* io = idx_out + row * k;
    float* dout = d2_out + row * k;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < k) {
        io[r] = bi[r];
        dout[r] = bd[r];
      }
    }
  } else {
    const size_t at = ((size_t)s * gridDim.y * nq + row) * k;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < k) {
        slab_idx[at + r] = bi[r];
        slab_d2[at + r] = bd[r];
      }
    }
  }
}

// Grid (ceil(nq / kMergeThreads), B): one thread a query merges its S
// ascending slab lists of k entries into the first k, taking the lower slab
// on equal distances (a strict `<` over ascending s).  Only the slab that
// gives the k-th entry can run out, so a spent slab is never read again.
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ slab_d2,
                     const int* __restrict__ slab_idx,
                     int64_t* __restrict__ idx_out,
                     float* __restrict__ d2_out, int nq, int k, int nslabs) {
  const int q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= nq) return;
  const size_t row = ((size_t)blockIdx.y * nq + q) * k;
  const size_t stride = (size_t)gridDim.y * nq * k;  // one slab
  float head[kMaxSlabs];
  int pos[kMaxSlabs];
  for (int s = 0; s < nslabs; ++s) {
    pos[s] = 0;
    head[s] = slab_d2[s * stride + row];
  }
  for (int r = 0; r < k; ++r) {
    int best = 0;
    for (int s = 1; s < nslabs; ++s)
      if (head[s] < head[best]) best = s;
    const size_t at = best * stride + row + pos[best];
    d2_out[row + r] = head[best];
    idx_out[row + r] = slab_idx[at];
    ++pos[best];
    head[best] = pos[best] < k ? slab_d2[at + 1] : INFINITY;
  }
}

template <int KMAX>
cudaError_t launch(const float* q, const float* keys, int64_t* idx, float* d2,
                   float* sd2, int* sidx, int b, int nq, int nk, int k, int s,
                   cudaStream_t stream) {
  const int slab_len = (nk + s - 1) / s;
  const dim3 grid((nq + kThreads - 1) / kThreads, b, s);
  knn_kernel<KMAX><<<grid, kThreads, 0, stream>>>(
      q, keys, idx, d2, s > 1 ? sd2 : nullptr, sidx, nq, nk, k, slab_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || s == 1) return err;
  const dim3 mgrid((nq + kMergeThreads - 1) / kMergeThreads, b);
  knn_merge_kernel<<<mgrid, kMergeThreads, 0, stream>>>(sd2, sidx, idx, d2,
                                                        nq, k, s);
  return cudaGetLastError();
}

}  // namespace

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64,
// d2 [b, nq, k] f32, both ascending by distance, with s key slabs (1 <= s
// <= min(64, nk); slab i is keys [i * L, min(nk, (i + 1) * L)), L =
// ceil(nk / s)).  For
// s > 1, slab_d2 (f32) and slab_idx (int32) are scratch of s * b * nq * k
// elements each; for s == 1 they are not read.  Requires 1 <= k <= 32 and
// k <= nk; returns cudaErrorInvalidValue otherwise.  Launches on `stream`
// and does not synchronise.
extern "C" int dh3d_knn(const void* query, const void* keys, void* idx,
                        void* d2, void* slab_d2, void* slab_idx, int b, int nq,
                        int nk, int k, int s, void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || k < 1 || k > 32 || k > nk || b > 65535 ||
      s < 1 || s > kMaxSlabs || s > nk ||
      (s > 1 && (slab_d2 == nullptr || slab_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  float* sd = static_cast<float*>(slab_d2);
  int* si = static_cast<int*>(slab_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the list length is a compile-time constant so that it lives in
  // registers; the first k of the sorted top-KMAX are the top k
  if (k == 1) return (int)launch<1>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  if (k == 2) return (int)launch<2>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  if (k == 3) return (int)launch<3>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  if (k == 4) return (int)launch<4>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  if (k <= 8) return (int)launch<8>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  if (k <= 16) return (int)launch<16>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
  return (int)launch<32>(qp, kp, io, dp, sd, si, b, nq, nk, k, s, st);
}

extern "C" const char* dh3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
