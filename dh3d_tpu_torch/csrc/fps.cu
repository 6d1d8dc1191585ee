// Kernel B: farthest point sampling, seeded at index 0.
//
// Replaces dh3d_tpu/ops/pallas/fps_pallas.py:_fps_kernel (8192 -> 1024 on
// the forward and train paths; 16384 -> 2048 and 9000 -> 1125 on the local
// eval path).  The TPU kernel runs every cloud in one instance with the
// running min-distance in VMEM and picks each iteration's point by a masked
// reduction.
//
// What bounds it on an H100: the dependence chain.  Each of the m - 1
// iterations needs the previous pick, so a cloud is m - 1 rounds of
// (distance update, argmax, exchange of the pick), and one block a cloud
// leaves most SMs idle at small B.  The design:
//   - a cloud is split over C blocks (C = 1..8, grid (C, B); a thread-block
//     cluster when C > 1); block `rank` holds points [rank * per, (rank + 1)
//     * per), per = ceil(N / C), and thread t of it the points t + r * T,
//     r = 0, 1, ... (T threads a block).  The first PPT of a thread's points
//     and their running min-distances live in registers (PPT is a template
//     parameter; up to 8192 points a block), so the distance update is pure
//     ALU; the rest, where a block holds more, in shared memory;
//   - a candidate is (the bits of its min-distance, its index, x, y, z): the
//     pick carries its coordinates, so the next centre needs no lookup.  A
//     warp's best comes from two redux.sync (the largest distance bits, then
//     the lowest index among the lanes that hold them);
//   - one block (C = 1): the warp's lane puts it in a shared slot double-
//     buffered by iteration parity, and after the one block barrier of the
//     iteration every warp reduces the slots itself (no second barrier, no
//     broadcast);
//   - a cluster (C > 1, C * T / 32 <= 32): the warp's lane stores it straight
//     into slot [parity][rank * T / 32 + warp] of every block of the cluster
//     with st.async, which completes C * T / 32 * 20 bytes of transactions
//     on that block's mbarrier [parity]; each block waits on its own
//     barrier's phase and every warp reduces the C * T / 32 slots.  No block
//     barrier at all.  Parity buffers are enough: no warp reaches iteration
//     j + 2 before every warp of the cluster has sent its j + 1 candidate,
//     which each sends only after it has read the j candidates.
//   The plan (C, T) is chosen by `fps_plan` in ops/sampling.py from a sweep
//   (`chip_smoke.py --sweep`).  Tried and slower at [20, 8192] -> 1024 and
//   [1, 16384] -> 2048 (PERF.md): a remote store plus a release-arrive on
//   the mbarrier in place of st.async, one candidate a block through warp 0
//   in place of one a warp, test_wait spinning in place of try_wait, a tree
//   argmax over a thread's points, and shuffles in place of redux.sync.
//
// Contract, shared with the plain version in ops/sampling.py:
//   d = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own;
//   mind = fminf(mind, d); the pick is the largest mind, lowest index on ties
//   (the first occurrence, as jnp.argmax / torch.argmax).  mind >= +0, so
//   its bits order as the floats.  NaN: fminf returns the other operand, so
//   a NaN distance leaves mind as it was and mind is never NaN; a point with
//   a NaN coordinate keeps mind = +inf and is picked (again and again, as its
//   own distance is NaN) while it has the largest mind, and a NaN centre
//   changes no mind.  (The plain version's torch.minimum keeps a NaN, so
//   the two differ on such clouds.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size limit
constexpr int kSlots = 32;      // candidates a warp reduces at once
constexpr int kCandBytes = 20;  // what st.async moves for one candidate
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // minus the lane: no point

// The most threads a block of the PPT instance runs: 4 registers a point
// (x, y, z, mind) and about 25 more, within 65,536 registers an SM.
__host__ __device__ constexpr int max_threads(int ppt) {
  return ppt <= 8 ? 1024 : (ppt <= 16 ? 512 : 256);
}

struct __align__(16) Cand {
  unsigned v;  // bits of its min-distance
  unsigned i;  // its index; kNone - lane where a lane has no point
  float x, y, z, pad[3];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The lane holding the warp's best (v, i): the largest v, then the lowest i
// (every lane's i differs); the best in (bv, bi) on every lane.
__device__ __forceinline__ int warp_best(unsigned v, unsigned i, unsigned& bv,
                                         unsigned& bi) {
  bv = __reduce_max_sync(kFull, v);
  bi = __reduce_min_sync(kFull, v == bv ? i : kNone);
  return __ffs(__ballot_sync(kFull, v == bv && i == bi)) - 1;
}

// The best of `count` <= 32 candidates in shared memory, on every lane.
__device__ __forceinline__ Cand best_of(const Cand* slots, int count,
                                        int lane) {
  unsigned v = 0, i = kNone - lane;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (lane < count) {
    const Cand c = slots[lane];
    v = c.v;
    i = c.i;
    x = c.x;
    y = c.y;
    z = c.z;
  }
  Cand best;
  const int src = warp_best(v, i, best.v, best.i);
  best.x = __shfl_sync(kFull, x, src);
  best.y = __shfl_sync(kFull, y, src);
  best.z = __shfl_sync(kFull, z, src);
  return best;
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local,
                                                 unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// Store `c` into the slot at cluster address `slot` with st.async, which
// completes its kCandBytes on the mbarrier at cluster address `bar`.
__device__ __forceinline__ void send(unsigned slot, unsigned bar,
                                     const Cand& c) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(slot),
      "r"(c.v), "r"(c.i), "r"(__float_as_uint(c.x)),
      "r"(__float_as_uint(c.y)), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(slot + 16),
      "r"(__float_as_uint(c.z)), "r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of the local mbarrier `bar` has
// completed; acquire at cluster scope.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT;\n\t"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Grid (C, B), cluster (C, 1, 1) when CLUSTER.  `per`: points a block;
// `tail`: points a thread beyond its PPT register points, in dynamic shared
// memory as float4 {x, y, z, mind} [tail][T].
template <int PPT, bool CLUSTER>
__global__ void __launch_bounds__(max_threads(PPT), 1)
    fps_kernel(const float* __restrict__ points, int64_t* __restrict__ out,
               int n, int m, int per, int tail) {
  extern __shared__ float4 tail_pts[];
  __shared__ Cand slot[2][kSlots];  // candidates, by iteration parity
  __shared__ uint64_t bar[2];       // a cluster's slots are full, by parity

  const int T = blockDim.x;
  const int W = T >> 5;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int rank = 0, csize = 1;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    csize = (int)cluster.num_blocks();
  }
  const int lo = rank * per;
  const int cnt = max(0, min(per, n - lo));
  const float* p = points + (size_t)blockIdx.y * n * 3;
  int64_t* o = out + (size_t)blockIdx.y * m;

  // a slot without a point has mind -1: it never beats a real one (>= +0)
  float px[PPT], py[PPT], pz[PPT], pm[PPT];
#pragma unroll
  for (int r = 0; r < PPT; ++r) {
    const int l = t + r * T;
    const bool on = l < cnt;
    const float* q = p + 3 * (size_t)(on ? lo + l : 0);
    px[r] = on ? q[0] : 0.0f;
    py[r] = on ? q[1] : 0.0f;
    pz[r] = on ? q[2] : 0.0f;
    pm[r] = on ? INFINITY : -1.0f;
  }
  for (int r = 0; r < tail; ++r) {
    const int l = t + (PPT + r) * T;
    const float* q = p + 3 * (size_t)(lo + l);
    tail_pts[r * T + t] = l < cnt ? make_float4(q[0], q[1], q[2], INFINITY)
                                  : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
  }
  if constexpr (CLUSTER) {
    if (t == 0) {
      for (int h = 0; h < 2; ++h)  // one local arrival a phase, + the bytes
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_u32(&bar[h]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();  // every barrier is set before any store
  }
  if (rank == 0 && t == 0) o[0] = 0;

  float cx = p[0], cy = p[1], cz = p[2];  // the centre: the seed, point 0
  for (int j = 1; j < m; ++j) {
    const int par = j & 1;
    if (CLUSTER && t == 0)  // this phase: C * W candidates' bytes
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_u32(&bar[par])),
          "r"(csize * W * kCandBytes)
          : "memory");
    // a thread's points ascend, so the strict `>` keeps its lowest index
    float bv = -1.0f;
    int bs = -1;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      const float dx = __fsub_rn(px[r], cx);
      const float dy = __fsub_rn(py[r], cy);
      const float dz = __fsub_rn(pz[r], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float v = fminf(pm[r], d);
      pm[r] = v;
      if (v > bv) {
        bv = v;
        bs = r;
      }
    }
    for (int r = 0; r < tail; ++r) {
      const float4 q = tail_pts[r * T + t];
      const float dx = __fsub_rn(q.x, cx);
      const float dy = __fsub_rn(q.y, cy);
      const float dz = __fsub_rn(q.z, cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float v = fminf(q.w, d);
      tail_pts[r * T + t].w = v;
      if (v > bv) {
        bv = v;
        bs = PPT + r;
      }
    }
    const unsigned vb = __float_as_uint(fmaxf(bv, 0.0f));  // no point: +0
    const unsigned gi = bs >= 0 ? (unsigned)(lo + t + bs * T) : kNone - lane;
    unsigned wv, wi;
    if (warp_best(vb, gi, wv, wi) == lane) {
      Cand c;
      c.v = wv;
      c.i = wi;
      c.x = c.y = c.z = 0.0f;
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        if (bs == r) {
          c.x = px[r];
          c.y = py[r];
          c.z = pz[r];
        }
      }
      if (bs >= PPT) {
        const float4 q = tail_pts[(bs - PPT) * T + t];
        c.x = q.x;
        c.y = q.y;
        c.z = q.z;
      }
      if constexpr (CLUSTER) {
        for (int r = 0; r < csize; ++r)
          send(cluster_addr(smem_u32(&slot[par][rank * W + warp]), r),
               cluster_addr(smem_u32(&bar[par]), r), c);
      } else {
        slot[par][warp] = c;
      }
    }
    if constexpr (CLUSTER) {
      // the barrier [par] completes once a use: phase (j - 1) / 2
      wait_phase(smem_u32(&bar[par]), ((j - 1) >> 1) & 1);
    } else {
      __syncthreads();  // the one block barrier of the iteration
    }
    const Cand pick = best_of(slot[par], csize * W, lane);
    if (rank == 0 && t == 0) o[j] = pick.i;
    cx = pick.x;
    cy = pick.y;
    cz = pick.z;
  }
  if constexpr (CLUSTER)
    cg::this_cluster().sync();  // no block exits while another may store
}

int smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Points of a thread's tail that fit the dynamic shared memory of a block
// of `threads` on `device`, beside the kernel's static shared memory.
int tail_limit(int device, int threads) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fps_kernel<1, true>) != cudaSuccess)
    return -1;
  return (smem_optin(device) - (int)attr.sharedSizeBytes) / (16 * threads);
}

template <int PPT>
cudaError_t launch(const float* pts, int64_t* o, int b, int n, int m, int c,
                   int threads, int per, int tail, cudaStream_t s) {
  const int bytes = tail * threads * 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, b, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  if (c == 1) {
    err = cudaFuncSetAttribute(fps_kernel<PPT, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT, false>, pts, o, n, m, per,
                             tail);
  } else {
    err = cudaFuncSetAttribute(fps_kernel<PPT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT, true>, pts, o, n, m, per,
                             tail);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The register points a thread takes (an instance: 1, 2, 3, 4, 6, 8, 12,
// 16, 24, 32) for `need` points a thread at `threads` a block: the smallest
// instance that holds them, else the largest that runs `threads`.
int pick_ppt(int need, int threads) {
  constexpr int kPPT[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};
  int best = 0;
  for (int ppt : kPPT) {
    if (max_threads(ppt) < threads) break;
    best = ppt;
    if (ppt >= need) break;
  }
  return best;
}

}  // namespace

// The largest n dh3d_fps samples on `device` with `cluster` blocks a cloud
// of `threads` threads; 0 on error.
extern "C" int dh3d_fps_max_points(int device, int cluster, int threads) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || (cluster > 1 && cluster * threads / 32 > kSlots))
    return 0;
  const int tail = tail_limit(device, threads);
  if (tail < 0) return 0;
  return cluster * (pick_ppt(1 << 30, threads) + tail) * threads;
}

// points [b, n, 3] f32 -> out [b, m] int64 with `c` blocks (a cluster when
// c > 1) of `threads` threads a cloud.  Requires 1 <= m <= n, 1 <= c <= 8,
// threads a multiple of 32 in [32, 1024], c * threads / 32 <= 32 when
// c > 1, and n <= dh3d_fps_max_points(device, c, threads); returns
// cudaErrorInvalidValue otherwise.
extern "C" int dh3d_fps(const void* points, void* out, int b, int n, int m,
                        int c, int threads, void* stream) {
  if (b < 1 || n < 1 || m < 1 || m > n || b > 65535 || c < 1 ||
      c > kMaxCluster || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (c > 1 && c * threads / 32 > kSlots))
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int per = (n + c - 1) / c;
  const int need = (per + threads - 1) / threads;
  const int ppt = pick_ppt(need, threads);
  const int tail = max(0, need - ppt);
  if (tail > 0 && tail > tail_limit(device, threads))
    return (int)cudaErrorInvalidValue;
  const float* pts = static_cast<const float*>(points);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 1: return (int)launch<1>(pts, o, b, n, m, c, threads, per, tail, s);
    case 2: return (int)launch<2>(pts, o, b, n, m, c, threads, per, tail, s);
    case 3: return (int)launch<3>(pts, o, b, n, m, c, threads, per, tail, s);
    case 4: return (int)launch<4>(pts, o, b, n, m, c, threads, per, tail, s);
    case 6: return (int)launch<6>(pts, o, b, n, m, c, threads, per, tail, s);
    case 8: return (int)launch<8>(pts, o, b, n, m, c, threads, per, tail, s);
    case 12: return (int)launch<12>(pts, o, b, n, m, c, threads, per, tail, s);
    case 16: return (int)launch<16>(pts, o, b, n, m, c, threads, per, tail, s);
    case 24: return (int)launch<24>(pts, o, b, n, m, c, threads, per, tail, s);
    case 32: return (int)launch<32>(pts, o, b, n, m, c, threads, per, tail, s);
  }
  return (int)cudaErrorInvalidValue;
}
