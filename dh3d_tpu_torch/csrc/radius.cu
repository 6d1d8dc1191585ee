// Kernel I: radius count.  For every point of a cloud, the points of the
// same cloud within a radius of it, itself included: the count behind the
// loader's radius outlier removal (data/io.py:remove_radius_outlier, open3d's
// remove_radius_outlier at nb_points=4, r=1 m).
//
// Replaces no TPU kernel: the JAX package, as the reference, counts these
// neighbours on the host with scipy's cKDTree (dh3d_tpu/data/io.py:58-70).
// Added for ROADMAP R4: that host count took three quarters of a raw scan's
// load and of its whole extraction while the card sat idle (PERF.md §5).
//
// What bounds it on an H100: float64 operations.  A cloud of M points is M^2
// pairs (7.7e8 at the raw scan's M ~ 27,800), each 3 subtractions, 3
// multiplications and 2 additions in float64 on the CUDA cores' FP64 units
// (64 a clock an SM, ~17e12 a second); the compare is an integer one, off
// that pipe.  Exactness asks for float64 throughout, and at ~0.4 ms a cloud
// the kernel is far below what the rest of the load costs, so there is no
// float32 pre-filter.  The design:
//   - one thread a query point, its coordinates in registers as doubles;
//   - key tiles of kTile points staged in shared memory as doubles (24 KB),
//     so each key is converted once and read by the whole block as a
//     broadcast;
//   - the keys are split over blockIdx.y (the plan, ops/radius.py:
//     radius_plan), so that the ~110 query blocks of a raw scan become
//     several hundred over the 132 SMs; each block adds its partial count
//     to the output with one integer atomicAdd, which is exact and does not
//     depend on the order the blocks run in.  The caller zeroes the output.
//
// Contract, shared with the plain version in ops/radius.py and with
// cKDTree.query_ball_point (p = 2, eps = 0):
//   dx, dy, dz in float64 from the float32 coordinates; d2 = (dx*dx + dy*dy)
//   + dz*dz with every operation rounded on its own (__dadd_rn / __dmul_rn:
//   no FMA contraction); counted when d2 <= r2, r2 = radius * radius in
//   float64 (so a point at exactly the radius counts).  d2 is +0 or more,
//   or NaN, so the compare is made on its bits as an unsigned integer, which
//   orders the non-negative doubles as their values and puts every NaN
//   above r2 (not counted, as `<=` would have it).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;  // queries a block (ops/radius.py)
constexpr int kTile = 1024;    // keys a shared-memory tile (ops/radius.py)

__global__ void __launch_bounds__(kThreads)
    radius_count_kernel(const float* __restrict__ pts, int m, int per_split,
                        unsigned long long r2_bits, int* __restrict__ counts) {
  __shared__ double sx[kTile], sy[kTile], sz[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < m;
  double qx = 0.0, qy = 0.0, qz = 0.0;
  if (live) {
    qx = (double)pts[3 * (int64_t)i];
    qy = (double)pts[3 * (int64_t)i + 1];
    qz = (double)pts[3 * (int64_t)i + 2];
  }
  const int k0 = blockIdx.y * per_split;
  const int k1 = min(m, k0 + per_split);
  int n = 0;
  for (int t0 = k0; t0 < k1; t0 += kTile) {
    const int len = min(kTile, k1 - t0);
    __syncthreads();  // the previous tile is read by every thread
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const int64_t at = 3 * (int64_t)(t0 + j);
      sx[j] = (double)pts[at];
      sy[j] = (double)pts[at + 1];
      sz[j] = (double)pts[at + 2];
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        const double dx = __dsub_rn(qx, sx[j]);
        const double dy = __dsub_rn(qy, sy[j]);
        const double dz = __dsub_rn(qz, sz[j]);
        const double d2 = __dadd_rn(__dadd_rn(__dmul_rn(dx, dx),
                                              __dmul_rn(dy, dy)),
                                    __dmul_rn(dz, dz));
        n += (unsigned long long)__double_as_longlong(d2) <= r2_bits;
      }
    }
  }
  if (live && n) atomicAdd(counts + i, n);
}

}  // namespace

// points [m, 3] f32 -> counts [m] int32, added to (the caller zeroes it).
// `splits`: the blocks a query block's keys are split over (1..65535).
// Requires m >= 1 and radius >= 0; returns cudaErrorInvalidValue
// otherwise.  Launches on `stream` and does not synchronise.
extern "C" int dh3d_radius_count(const void* points, void* counts, int m,
                                 double radius, int splits, void* stream) {
  if (m < 1 || !(radius >= 0.0) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const double r2 = radius * radius;  // one product: nothing to contract
  unsigned long long r2_bits;
  memcpy(&r2_bits, &r2, sizeof r2_bits);
  const int per_split = (int)(((int64_t)m + splits - 1) / splits);
  const dim3 grid((m + kThreads - 1) / kThreads, splits);
  radius_count_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), m, per_split, r2_bits,
      static_cast<int*>(counts));
  return (int)cudaGetLastError();
}
