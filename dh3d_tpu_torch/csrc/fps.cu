// Kernel B: farthest point sampling, seeded at index 0.
//
// Replaces dh3d_tpu/ops/pallas/fps_pallas.py:_fps_kernel (8192 -> 1024 on
// the forward and train paths; 16384 -> 2048 and 9000 -> 1125 on the local
// eval path).  The TPU kernel runs every cloud in one instance with the
// running min-distance in VMEM, which holds clouds far beyond 16384 points,
// and picks each iteration's point by a masked reduction.
//
// Here a cloud lives in shared memory, 4 floats a point (coordinates and
// running min-distance), and every iteration is one argmax.  Two tiers:
//   - one block a cloud (fps_kernel) while 16 * N bytes fit one block's
//     opt-in shared memory (N <= ~14,500 on an H100): 128 KB at N = 8192;
//   - beyond that a thread-block cluster of C = 2..8 blocks a cloud
//     (fps_cluster_kernel), each block on its own SM holding ceil(N / C)
//     points, so N reaches 8 x ~14,500 = ~116,000.  Each iteration every
//     block reduces its own share to one (value, index) candidate, puts it
//     in its shared memory, and after one cluster barrier every thread reads
//     the C candidates through distributed shared memory and merges them in
//     rank order, so every block picks the same point with no second
//     barrier.  The candidates are double-buffered by iteration parity: a
//     block that runs ahead overwrites only the buffer no one still reads.
//     The picked point's coordinates come from device memory (L1-resident
//     after the first read).
// Clusters were chosen over a single block reading coordinates from device
// memory (or from L2) because they keep the whole loop on chip at every N
// the port meets, reuse the single-block kernel's inner loop unchanged, and
// give one cloud C SMs instead of one; the cost is a cluster barrier (a few
// hundred cycles) per iteration on top of the block barrier.
//
// What bounds it on an H100: the dependence chain.  Each of the m - 1
// iterations needs the previous pick, so a cloud is m - 1 rounds of
// (distance update over N / (C * 1024) points a thread, warp-shuffle argmax,
// block barrier(s), and in the cluster tier one cluster barrier).  One block
// (or one cluster) a cloud leaves most SMs idle at small B.
//
// Contract, shared with the plain version in ops/sampling.py:
//   d = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own;
//   mind = min(mind, d); the pick is the largest mind, lowest index on ties
//   (the first occurrence, as jnp.argmax / torch.argmax).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size limit

// (v, i) beats (bv, bi) when larger, or equal with a lower index.
__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float v,
                                             int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    argmax_merge(bv, bi, v, i);
  }
}

// The cluster kernel's distance update over this thread's points [lo + i
// for i = tid, tid + kThreads, ...] of its block's share; returns the
// thread's best (value, global index).  A thread's points ascend, so the
// strict `>` keeps its lowest index.  fps_kernel writes the same loop out:
// called through this helper, nvcc unrolled it four times there and the
// kernel took 1.58 ms instead of 1.38 ms at [20, 8192] -> 1024 (H100 80GB
// HBM3, 700 W).
__device__ __forceinline__ void update_share(const float* sx, const float* sy,
                                             const float* sz, float* mind,
                                             int cnt, int lo, float lx,
                                             float ly, float lz, float& bv,
                                             int& bi) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const float dx = __fsub_rn(sx[i], lx);
    const float dy = __fsub_rn(sy[i], ly);
    const float dz = __fsub_rn(sz[i], lz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    const float v = fminf(mind[i], d);
    mind[i] = v;
    if (v > bv) {
      bv = v;
      bi = lo + i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ points, int64_t* __restrict__ out,
               int n, int m) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* mind = sz + n;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int picked;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = points + (size_t)blockIdx.x * n * 3;
  int64_t* o = out + (size_t)blockIdx.x * m;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    mind[i] = INFINITY;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < m; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -INFINITY;
    int bi = n;
    // a thread's points ascend, so the strict `>` keeps its lowest index
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float dx = __fsub_rn(sx[i], lx);
      const float dy = __fsub_rn(sy[i], ly);
      const float dz = __fsub_rn(sz[i], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float v = fminf(mind[i], d);
      mind[i] = v;
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];  // kWarps == 32: one entry a lane
      bi = warp_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        if (bi >= n) bi = 0;  // only when every distance is NaN
        picked = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    last = picked;
  }
}

// Grid (C, B) with cluster (C, 1, 1): block `rank` of cloud blockIdx.y holds
// points [rank * per, min(n, (rank + 1) * per)).
__global__ void __launch_bounds__(kThreads)
    fps_cluster_kernel(const float* __restrict__ points,
                       int64_t* __restrict__ out, int n, int m, int per) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + per;
  float* sz = sy + per;
  float* mind = sz + per;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float cand_v[2];  // this block's candidate, by iteration parity
  __shared__ int cand_i[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = points + (size_t)blockIdx.y * n * 3;
  int64_t* o = out + (size_t)blockIdx.y * m;
  const int lo = rank * per;
  const int cnt = max(0, min(per, n - lo));

  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    sx[i] = p[3 * (lo + i)];
    sy[i] = p[3 * (lo + i) + 1];
    sz[i] = p[3 * (lo + i) + 2];
    mind[i] = INFINITY;
  }
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < m; ++j) {
    const float lx = __ldg(p + 3 * last);
    const float ly = __ldg(p + 3 * last + 1);
    const float lz = __ldg(p + 3 * last + 2);
    float bv = -INFINITY;
    int bi = n;
    update_share(sx, sy, sz, mind, cnt, lo, lx, ly, lz, bv, bi);
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    const int buf = j & 1;
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        cand_v[buf] = bv;
        cand_i[buf] = bi;
      }
    }
    // release this block's candidate, acquire every other block's; also
    // keeps warp_v from being rewritten before warp 0 has read it
    cluster.sync();
    bv = -INFINITY;
    bi = n;
    for (int r = 0; r < csize; ++r)  // rank order: the same merge everywhere
      argmax_merge(bv, bi, *cluster.map_shared_rank(&cand_v[buf], r),
                   *cluster.map_shared_rank(&cand_i[buf], r));
    if (bi >= n) bi = 0;  // only when every distance is NaN
    if (rank == 0 && threadIdx.x == 0) o[j] = bi;
    last = bi;
  }
  cluster.sync();  // no block exits while another may still read its smem
}

int smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Dynamic shared memory `kernel` may use on `device`, in bytes; 0 on error.
template <typename Kernel>
int smem_limit(Kernel kernel, int device) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  return smem_optin(device) - (int)attr.sharedSizeBytes;
}

// Points one block of the tier holds (16 bytes a point).
int block_points(int cluster, int device) {
  return cluster == 1 ? smem_limit(fps_kernel, device) / 16
                      : smem_limit(fps_cluster_kernel, device) / 16;
}

}  // namespace

// The largest n dh3d_fps samples on `device` with `cluster` blocks a cloud
// (1: the single-block kernel; 2..8: the cluster kernel); 0 on error.
extern "C" int dh3d_fps_max_points(int device, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return 0;
  return block_points(cluster, device) * cluster;
}

// points [b, n, 3] f32 -> out [b, m] int64.  Requires 1 <= m <= n and
// n <= dh3d_fps_max_points(device, 8); returns cudaErrorInvalidValue
// otherwise.  Takes the single-block kernel where the cloud fits one block,
// else the smallest cluster whose blocks hold it.
extern "C" int dh3d_fps(const void* points, void* out, int b, int n, int m,
                        void* stream) {
  if (b < 1 || n < 1 || m < 1 || m > n || b > 65535)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const float* pts = static_cast<const float*>(points);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= block_points(1, device)) {
    const int bytes = n * 4 * (int)sizeof(float);
    err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    fps_kernel<<<b, kThreads, bytes, s>>>(pts, o, n, m);
    return (int)cudaGetLastError();
  }
  const int cap = block_points(2, device);
  int c = 2;
  while (c < kMaxCluster && (n + c - 1) / c > cap) ++c;
  const int per = (n + c - 1) / c;
  if (per > cap) return (int)cudaErrorInvalidValue;
  const int bytes = per * 4 * (int)sizeof(float);
  err = cudaFuncSetAttribute(fps_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, b, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, pts, o, n, m, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
