// Kernel A: exact k nearest neighbours (k <= 7; on the port's path the
// 3-NN of feature propagation) of every query among the keys of the same
// batch entry.  From k = 8 up, `knn` takes kernel G (csrc/knn_topk.cu),
// which prunes keys by box and was faster at every such shape of the path
// (PERF.md); below it, G's list of 32 costs more than A's list of k.
//
// Replaces (dh3d_tpu/ops/pallas/knn_pallas.py):
//   _knn_kernel_banded  (3-NN from 8192 queries to 1024 keys; on the main
//                        path its window is the whole key table, so it is
//                        exact 3-NN)
//   and _knn_kernel_packed / _knn_kernel below k = 8.
// The TPU kernels build a [TQ, N] distance tile in VMEM and run k
// min-extraction passes over it (packed: distance and lane index in one
// int32, so distances come back truncated).  Here each thread keeps a
// sorted list of its query's k best (d2, index) pairs in registers, so no
// distance tile is ever stored and distances are exact.
//
// What bounds it on an H100: issued instructions.  The 3-NN at [20, 8192]
// -> [20, 1024] is 1.7e8 query-key pairs with no FMA allowed (see the
// contract): each pair issues at least a key load, 2 sub, 2 mul, 1 add and
// 1 compare (the x-y test below), those that pass it 1 sub, 1 mul, 1 add
// and 1 compare more, and a thread runs a register insertion whenever one
// of its candidates passes.  The design:
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
//     32 keys around its proportional position in the keys; the KMAX-th
//     distance there bounds its KMAX-th nearest from above (any KMAX keys
//     give such a bound), and the list is reset.  The scan then lets a key
//     in only below both the list's last distance and the bound: a key
//     beyond the bound cannot be among the KMAX nearest, so the list ends
//     as it would without it, but on Morton-ordered clouds the bound is
//     tight and few steps branch.
//   Tried and slower (PERF.md): Q = 2 or 4 queries a thread, so that one
//   key load feeds Q distances (more registers, fewer warps, no fewer
//   instructions a pair); scanning from the query's own tile and wrapping
//   around, with a (d2, index) order; splitting the keys into slabs on the
//   grid with a merge kernel (its plan took one slab at every 3-NN shape
//   of the path: too few keys to split).
//
// Contract, shared with the plain version in ops/knn.py:
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA contraction), so the plain PyTorch
//   version reproduces d2 bit for bit;
//   keys are scanned in ascending index order and a candidate enters the
//   list only on a strict `<`, so among equal distances the lowest index
//   comes first.  A self query's own distance is exactly 0, so it lands at
//   slot 0 (an exact duplicate with a lower index would come before it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kTile = 1024;    // keys staged in shared memory per pass
constexpr int kMaxK = 7;       // from k = 8 up, `knn` takes kernel G

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

// Grid (ceil(nq / kThreads), B).  Block (x, b) scans every key for
// queries x * kThreads + threadIdx.x and writes the first k entries of
// each list to idx_out / d2_out.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ keys,
               int64_t* __restrict__ idx_out, float* __restrict__ d2_out,
               int nq, int nk, int k) {
  constexpr int U = 8;  // keys a step
  constexpr int kWindow = 32;
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
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

  for (int t0 = 0; t0 < nk; t0 += kTile) {
    const int tn = min(kTile, nk - t0);
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
  int64_t* io = idx_out + row * k;
  float* dout = d2_out + row * k;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      io[r] = bi[r];
      dout[r] = bd[r];
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* q, const float* keys, int64_t* idx, float* d2,
                   int b, int nq, int nk, int k, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  knn_kernel<KMAX><<<grid, kThreads, 0, stream>>>(q, keys, idx, d2, nq, nk,
                                                  k);
  return cudaGetLastError();
}

}  // namespace

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64,
// d2 [b, nq, k] f32, both ascending by distance.  Requires 1 <= k <= 7 and
// k <= nk; returns cudaErrorInvalidValue otherwise.  Launches on `stream`
// and does not synchronise.
extern "C" int dh3d_knn(const void* query, const void* keys, void* idx,
                        void* d2, int b, int nq, int nk, int k, void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || k < 1 || k > kMaxK || k > nk ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the list length is a compile-time constant so that it lives in
  // registers; the first k of the sorted top-KMAX are the top k
  if (k == 1) return (int)launch<1>(qp, kp, io, dp, b, nq, nk, k, st);
  if (k == 2) return (int)launch<2>(qp, kp, io, dp, b, nq, nk, k, st);
  if (k == 3) return (int)launch<3>(qp, kp, io, dp, b, nq, nk, k, st);
  if (k == 4) return (int)launch<4>(qp, kp, io, dp, b, nq, nk, k, st);
  return (int)launch<8>(qp, kp, io, dp, b, nq, nk, k, st);
}

extern "C" const char* dh3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
