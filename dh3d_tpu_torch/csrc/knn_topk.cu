// Kernel G: exact k nearest neighbours (1 <= k <= 128; on the port's path
// every k >= 8: the self kNN k = 8 of the forward and the extraction, the
// detection loss's k = 16 and keypoint NMS's k = 50) of every query among
// the keys of the same batch entry, by a search that prunes the key table
// with bounding boxes.
//
// Replaces (dh3d_tpu/ops/pallas/knn_pallas.py):
//   _knn_kernel_slab  (+ the stable XLA merge of _knn_slabbed_call): every
//                     k >= 32; on the path, keypoint NMS asks for the exact
//                     50 nearest neighbours of every point of a 16384-point
//                     cloud (dh3d_tpu/eval/nms.py:59-60).
//   and, from k = 8 up, the shapes of _knn_kernel_packed and _knn_kernel
//   that kernel A (csrc/knn.cu) took before G was faster there.
// The TPU kernel puts key slabs on the grid, extracts each slab's top k by
// k unrolled min/argmin/mask passes over a [TQ, slab] distance tile in
// VMEM, and merges the S * k candidates with a stable sort in XLA: it
// visits every pair.  Here a query visits the keys of a few chunks only.
//
// What bounds it on an H100: issued instructions, and most of them in the
// selection.  A full scan costs Nk / 32 warp steps a query plus ~k ln(Nk /
// k) serial insertions on keys in random order.  The design:
//   1. a pre-pass (`topk_prep`, one block of 1024 threads a cloud, each
//      thread with 8 loads in flight) sorts the keys by a 15-bit Z-order
//      cell code with a counting sort in shared memory, and stores them
//      once as float4 {x, y, z, original index}; then `topk_boxes` (a block
//      a group, a warp a chunk) stores, for each chunk of 32 consecutive
//      sorted keys and each group of 32 chunks, the axis-aligned box of
//      their keys and their lowest original index.  The cells are those of
//      an occupied-bin frame: each axis of the keys' bounding box is cut
//      into 4096 bins, and a coordinate's 5-bit cell is its rank among the
//      occupied bins (plus its place within its bin) over their count.  An
//      empty stretch of an axis gets no cells, so rows far from the cloud
//      (the eval loader pads an undersized cloud with points at 1e5) do
//      not squeeze the cloud into one cell, where no box would prune.
//      Cross queries get their cell in the keys' frame, the middle of that
//      cell's run of sorted keys as their position, and their own counting
//      sort, which is the order warps visit them in.  A self query (query
//      == keys) is the key at its sorted position.  Any order is exact
//      (below); this one makes chunks compact (on the N=16384 eval cloud a
//      query's exact 50-NN radius meets ~11 of 512 chunk boxes).
//   2. a warp a query (`topk_search`), 4 warps a block.  Its sorted list of
//      32 * R (d2, index) pairs lives in registers, position s in lane s %
//      32, register s / 32 (R = 1, 2, 4 for k <= 32, 64, 128).  The list is
//      first filled from the R chunks around the query's position (its own
//      and its neighbours), sorted by a warp-wide bitonic network: any k
//      keys bound the k-th nearest from above, so the k-th entry is a bound
//      from the start.
//   3. then group boxes, one a lane, nearest first (a redux.sync min over
//      the bounds' bits), and inside a group its chunk boxes the same way.
//      A box's bound clamps the query to the box and builds d2 with the
//      same rounded operations as a key's; round-to-nearest is monotone, so
//      the bound is <= the rounded d2 of every key in the box.  Every key
//      of a box comes at or after (bound, lowest index), so a box is
//      visited only when that pair comes before the list's k-th pair: the
//      pruning is exact, and it skips the boxes of exact duplicates (the
//      loader's pads) whose indices are all above the k-th.  The nearest
//      box first tightens the k-th early, and the walk over a level ends at
//      the first bound above it.
//   4. a visited chunk is one float4 load a lane: the x-y partial sum first
//      (fl(a + b) >= a for b >= 0, so a chunk whose partial sums all exceed
//      the k-th ends before the z terms), then a ballot of the keys that
//      come before the k-th pair.  They enter the list either one at a
//      time (MERGE = 0: a ballot and a popcount a register give the slot,
//      shuffles shift the tail) or all at once (MERGE = 1: the lanes'
//      candidates are sorted by a 32-wide bitonic network, the reversed
//      candidates replace the list's last 32 where smaller, and one bitonic
//      merge sorts the list again).  `topk_plan` in ops/knn.py picks MERGE
//      by k.
//   No shared memory and no barrier in the search: a warp reads its own
//   chunks, and the sorted table (16 bytes a key) and the boxes stay in L1
//   and L2.
//
// Contract, shared with the plain version in ops/knn.py:
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fsub_rn / __fmul_rn / __fadd_rn: no FMA contraction);
//   neighbours ascend by d2, and among equal d2 the lowest original index
//   comes first, so a self query lands at slot 0 (unless an exact duplicate
//   with a lower index comes first).  Every comparison here (the fill's
//   sort, an insertion, the k-th threshold, a box test, a merge) is on the
//   pair (d2, original index), lexicographically: a total order over the
//   keys, so the result does not depend on the order in which keys are
//   visited, nor on the order the pre-pass's atomics leave within a cell.
//   Pads (fewer than 32 * R keys in the table or the fill window) are
//   (+inf, 0x7fffffff) and come after every key.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 1024;  // 32 warps: the scans below assume it
constexpr int kAxisBits = 5;
constexpr int kCells = 1 << (3 * kAxisBits);  // 32768 counters: 128 KB
constexpr int kBins = 4096;  // a frame axis's bins: 3 * 4096 ranks, 48 KB
constexpr int kChunk = 32;   // keys a chunk (a box of the pruned search)
constexpr int kWarps = 4;    // warps (queries) a search block
constexpr int kPad = 0x7fffffff;         // the index of a pad entry
constexpr unsigned kNone = 0xffffffffu;  // no box to visit

// (ad, ai) comes before (bd, bi)
__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float4 k) {
  const float dx = __fsub_rn(qx, k.x);
  const float dy = __fsub_rn(qy, k.y);
  const float dz = __fsub_rn(qz, k.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The least d2 from the query to any point of the box [lo, hi]: the query
// clamped to the box, then d2's own rounded operations.  |q - clamp(q)| <=
// |q - p| for every p in the box, and each rounded step is monotone in it.
__device__ __forceinline__ float box_bound(float qx, float qy, float qz,
                                           float4 lo, float4 hi) {
  return dist2(qx, qy, qz,
               make_float4(fminf(fmaxf(qx, lo.x), hi.x),
                           fminf(fmaxf(qy, lo.y), hi.y),
                           fminf(fmaxf(qz, lo.z), hi.z), 0.0f));
}

// f32 <-> an int with the same order (an involution), for redux.sync min
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int spread5(int v) {  // bit b -> bit 3b
  int r = 0;
#pragma unroll
  for (int b = 0; b < kAxisBits; ++b) r |= ((v >> b) & 1) << (3 * b);
  return r;
}

// The keys' occupied-bin frame: axis a's bins of the bounding box from
// lo[a] (scale[a] bins a unit); rank[a * kBins + bin] - base[a] the
// occupied bins of the axis below `bin` (rank: shared memory, the ranks
// running on across the axes, with the total at 3 * kBins); cells[a] = 32
// over the axis's occupied bins.
struct Frame {
  float lo[3], scale[3], cells[3];
  int base[3];
  const int* rank;
  __device__ __forceinline__ int bin(float v, int a, float& t) const {
    t = fminf(fmaxf(__fmul_rn(__fsub_rn(v, lo[a]), scale[a]), 0.0f),
              (float)kBins);
    return min((int)t, kBins - 1);
  }
  // a coordinate's 5-bit cell: (its bin's rank + its place in the bin) *
  // 32 / occupied bins; monotone in v over the keys' own bins
  __device__ __forceinline__ int axis(float v, int a) const {
    float t;
    const int b = bin(v, a, t);
    const int* r = rank + a * kBins;
    const int below = r[b] - base[a];
    const bool occupied = r[b + 1] > r[b];  // rank[] has one entry more
    const float within = occupied ? fminf(t - (float)b, 1.0f) : 0.0f;
    const float c = __fmul_rn(__fadd_rn((float)below, within), cells[a]);
    return min((int)c, (1 << kAxisBits) - 1);
  }
  __device__ __forceinline__ int cell(float x, float y, float z) const {
    return spread5(axis(x, 0)) | (spread5(axis(y, 1)) << 1) |
           (spread5(axis(z, 2)) << 2);
  }
};

// Where the pre-pass's outputs live in the workspace (16-byte aligned).
struct Layout {
  float4* table;   // [b, nk]: sorted keys {x, y, z, index bits}
  float4* boxes;   // [b, nchunks, 2]: {lo, lowest index bits}, {hi, 0}
  float4* groups;  // [b, ngroups, 2]: the same for each 32 chunks
  int* qord;       // [b, nq]: cross queries in visiting order
  int* qpos;       // [b, nq]: a cross query's position in the sorted keys
  size_t bytes;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ inline int chunks_of(int nk) {
  return (nk + kChunk - 1) / kChunk;
}

__host__ __device__ inline Layout layout(void* base, int b, int nq, int nk) {
  const size_t nchunks = chunks_of(nk);
  const size_t ngroups = (nchunks + 31) / 32;
  char* p = static_cast<char*>(base);
  Layout l;
  size_t at = 0;
  l.table = reinterpret_cast<float4*>(p + at);
  at += align16(sizeof(float4) * b * (size_t)nk);
  l.boxes = reinterpret_cast<float4*>(p + at);
  at += align16(sizeof(float4) * 2 * b * nchunks);
  l.groups = reinterpret_cast<float4*>(p + at);
  at += align16(sizeof(float4) * 2 * b * ngroups);
  l.qord = reinterpret_cast<int*>(p + at);
  at += align16(sizeof(int) * b * (size_t)nq);
  l.qpos = reinterpret_cast<int*>(p + at);
  at += align16(sizeof(int) * b * (size_t)nq);
  l.bytes = at;
  return l;
}

// In-place exclusive scan of N counters by the block's 32 warps, each over
// its own N / 32 consecutive counters, then the warps' totals; the grand
// total lands in warp_total[32].
template <int N>
__device__ void exclusive_scan(int* hist, int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kSeg = N / 32;
  int* seg = hist + warp * kSeg;
  int carry = 0;
  for (int i = 0; i < kSeg; i += 32) {
    const int v = seg[i + lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    seg[i + lane] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_total[lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    warp_total[lane] = x - v;
    if (lane == 31) warp_total[32] = x;
  }
  __syncthreads();
  const int off = warp_total[warp];
  for (int i = 0; i < kSeg; i += 32) seg[i + lane] += off;
  __syncthreads();
}

// The box of up to 32 boxes or points, one a lane (m: ordered mins of x,
// y, z, -x, -y, -z, then the lowest index), written by lane 0 as {lo,
// index bits}, {hi, 0}.
__device__ __forceinline__ void write_box(int (&m)[7], float4* out) {
#pragma unroll
  for (int a = 0; a < 7; ++a) m[a] = __reduce_min_sync(kFull, m[a]);
  if ((threadIdx.x & 31) == 0) {
    out[0] = make_float4(unordered(m[0]), unordered(m[1]), unordered(m[2]),
                         __int_as_float(m[6]));
    out[1] = make_float4(-unordered(m[3]), -unordered(m[4]), -unordered(m[5]),
                         0.0f);
  }
}

__device__ __forceinline__ void widen(int (&m)[7], float4 lo, float4 hi) {
  m[0] = min(m[0], ordered(lo.x));
  m[1] = min(m[1], ordered(lo.y));
  m[2] = min(m[2], ordered(lo.z));
  m[3] = min(m[3], ordered(-hi.x));
  m[4] = min(m[4], ordered(-hi.y));
  m[5] = min(m[5], ordered(-hi.z));
  m[6] = min(m[6], __float_as_int(lo.w));
}

// Calls fn(j, x, y, z) for the points j = threadIdx.x + kPrepThreads * i
// < n of the [n, 3] array p, loading kBatch points before using any, so
// that a thread has kBatch loads in flight instead of one (a block a cloud
// is bound by the latency of these passes).
template <class Fn>
__device__ __forceinline__ void for_points(const float* p, int n, Fn fn) {
  constexpr int kBatch = 8;
  for (int j0 = threadIdx.x; j0 < n; j0 += kPrepThreads * kBatch) {
    float x[kBatch], y[kBatch], z[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kPrepThreads;
      x[u] = y[u] = z[u] = 0.0f;
      if (j < n) {
        x[u] = p[3 * j];
        y[u] = p[3 * j + 1];
        z[u] = p[3 * j + 2];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kPrepThreads;
      if (j < n) fn(j, x[u], y[u], z[u]);
    }
  }
}

// Grid (b), kPrepThreads threads, kCells + 3 * kBins + 1 ints of dynamic
// shared memory: the keys' frame, the sorted table and, for cross queries,
// their positions and order.
__global__ void __launch_bounds__(kPrepThreads)
    topk_prep(const float* __restrict__ query, const float* __restrict__ keys,
              Layout l, int nq, int nk, int self) {
  extern __shared__ int hist[];
  int* rank = hist + kCells;  // 3 * kBins + 1
  __shared__ int bounds[6];
  __shared__ int warp_total[33];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* kb = keys + (size_t)b * nk * 3;
  float4* tb = l.table + (size_t)b * nk;

  if (tid < 6) bounds[tid] = 0x7fffffff;
  for (int i = tid; i < kCells; i += kPrepThreads) hist[i] = 0;
  for (int i = tid; i <= 3 * kBins; i += kPrepThreads) rank[i] = 0;
  int m[7];
#pragma unroll
  for (int a = 0; a < 7; ++a) m[a] = 0x7fffffff;
  for_points(kb, nk, [&](int, float x, float y, float z) {
    widen(m, make_float4(x, y, z, 0.0f), make_float4(x, y, z, 0.0f));
  });
  __syncthreads();  // bounds[], hist[] and rank[] initialised
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const int w = __reduce_min_sync(kFull, m[a]);
    if ((tid & 31) == 0) atomicMin(&bounds[a], w);
  }
  __syncthreads();
  Frame f;
  f.rank = rank;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.lo[a] = unordered(bounds[a]);
    const float extent = __fsub_rn(-unordered(bounds[3 + a]), f.lo[a]);
    f.scale[a] = (float)kBins / fmaxf(extent, 1e-30f);
  }

  // the occupied bins of each axis, then their ranks
  for_points(kb, nk, [&](int, float x, float y, float z) {
    float t;
    rank[f.bin(x, 0, t)] = 1;
    rank[kBins + f.bin(y, 1, t)] = 1;
    rank[2 * kBins + f.bin(z, 2, t)] = 1;
  });
  __syncthreads();
  exclusive_scan<3 * kBins>(rank, warp_total);
  if (tid == 0) rank[3 * kBins] = warp_total[32];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // the ranks run on across the axes
    f.base[a] = rank[a * kBins];
    f.cells[a] = (float)(1 << kAxisBits) /
                 (float)(rank[(a + 1) * kBins] - f.base[a]);
  }

  // the keys: count each cell, scan, scatter (any order within a cell)
  for_points(kb, nk, [&](int, float x, float y, float z) {
    atomicAdd(&hist[f.cell(x, y, z)], 1);
  });
  __syncthreads();
  exclusive_scan<kCells>(hist, warp_total);
  for_points(kb, nk, [&](int j, float x, float y, float z) {
    tb[atomicAdd(&hist[f.cell(x, y, z)], 1)] =
        make_float4(x, y, z, __int_as_float(j));
  });
  __syncthreads();  // hist[c] is now the end of cell c's run
  if (self) return;

  // cross queries: a position in the keys, then their own order
  const float* qb = query + (size_t)b * nq * 3;
  int* qpos = l.qpos + (size_t)b * nq;
  for_points(qb, nq, [&](int j, float x, float y, float z) {
    const int c = f.cell(x, y, z);
    const int start = c > 0 ? hist[c - 1] : 0;
    qpos[j] = min((start + hist[c]) / 2, nk - 1);
  });
  __syncthreads();
  for (int i = tid; i < kCells; i += kPrepThreads) hist[i] = 0;
  __syncthreads();
  for_points(qb, nq, [&](int, float x, float y, float z) {
    atomicAdd(&hist[f.cell(x, y, z)], 1);
  });
  __syncthreads();
  exclusive_scan<kCells>(hist, warp_total);
  int* qord = l.qord + (size_t)b * nq;
  for_points(qb, nq, [&](int j, float x, float y, float z) {
    qord[atomicAdd(&hist[f.cell(x, y, z)], 1)] = j;
  });
}

// Grid (ngroups, b), kPrepThreads threads: warp w of block g takes chunk
// 32 g + w of the sorted table, its box by redux.sync; the group's box is
// the min / max of its chunks' through shared memory.
__global__ void __launch_bounds__(kPrepThreads)
    topk_boxes(Layout l, int nk) {
  __shared__ int group[7];
  const int b = blockIdx.y, g = blockIdx.x, warp = threadIdx.x >> 5;
  const int nchunks = chunks_of(nk);
  const float4* tb = l.table + (size_t)b * nk;
  if (threadIdx.x < 7) group[threadIdx.x] = 0x7fffffff;
  __syncthreads();
  const int c = g * 32 + warp;
  if (c < nchunks) {  // the whole warp
    int m[7];
#pragma unroll
    for (int a = 0; a < 7; ++a) m[a] = 0x7fffffff;
    const int s = c * kChunk + (threadIdx.x & 31);
    if (s < nk) {
      const float4 v = tb[s];
      widen(m, v, v);
    }
    write_box(m, l.boxes + 2 * ((size_t)b * nchunks + c));
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int a = 0; a < 7; ++a) atomicMin(&group[a], m[a]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4* out = l.groups + 2 * ((size_t)b * gridDim.x + g);
    out[0] = make_float4(unordered(group[0]), unordered(group[1]),
                         unordered(group[2]), __int_as_float(group[6]));
    out[1] = make_float4(-unordered(group[3]), -unordered(group[4]),
                         -unordered(group[5]), 0.0f);
  }
}

// One compare-exchange across lanes (stride < 32): keep the smaller pair
// of (own, partner's) when keep_min, else the larger.
__device__ __forceinline__ void exchange_lanes(float& d, int& j, int stride,
                                               bool keep_min) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oj = __shfl_xor_sync(kFull, j, stride);
  if (before(od, oj, d, j) == keep_min) {
    d = od;
    j = oj;
  }
}

// Stage (size, stride) of a bitonic sort of the 32 * R pairs at positions
// p = 32 r + lane: blocks of `size` ascend where p & size == 0.
template <int R>
__device__ __forceinline__ void sort_stage(float (&bd)[R], int (&bi)[R],
                                           int lane, int size, int stride) {
  if (stride >= 32) {  // both pairs in this lane's registers
    const int rs = stride >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & rs) continue;
      const int r2 = r | rs;
      const bool up = ((32 * r + lane) & size) == 0;
      if (up ? before(bd[r2], bi[r2], bd[r], bi[r])
             : before(bd[r], bi[r], bd[r2], bi[r2])) {
        const float td = bd[r];
        const int ti = bi[r];
        bd[r] = bd[r2];
        bi[r] = bi[r2];
        bd[r2] = td;
        bi[r2] = ti;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = 32 * r + lane;
      const bool up = (p & size) == 0;
      exchange_lanes(bd[r], bi[r], stride, ((p & stride) == 0) == up);
    }
  }
}

template <int R>
__device__ __forceinline__ void bitonic_sort(float (&bd)[R], int (&bi)[R],
                                             int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      sort_stage<R>(bd, bi, lane, size, stride);
}

// Sorts a bitonic sequence of the 32 * R pairs ascending (size = 2 * 32R:
// every position ascends).
template <int R>
__device__ __forceinline__ void bitonic_merge(float (&bd)[R], int (&bi)[R],
                                              int lane) {
#pragma unroll
  for (int stride = 16 * R; stride > 0; stride >>= 1)
    sort_stage<R>(bd, bi, lane, 64 * R, stride);
}

// The list's k-th pair (position k - 1), in every lane.
template <int R>
__device__ __forceinline__ void kth(const float (&bd)[R], const int (&bi)[R],
                                    int k, float& kd, int& kj) {
  const int kr = (k - 1) >> 5, kl = (k - 1) & 31;
  float d = bd[0];
  int j = bi[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == kr) {
      d = bd[r];
      j = bi[r];
    }
  kd = __shfl_sync(kFull, d, kl);
  kj = __shfl_sync(kFull, j, kl);
}

// Insert the pair (d, j), the same in every lane, after every entry that
// comes before it; the tail moves down one position and the last drops.
template <int R>
__device__ __forceinline__ void insert(float (&bd)[R], int (&bi)[R], float d,
                                       int j, int lane) {
  int p = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    p += __popc(__ballot_sync(kFull, before(bd[r], bi[r], d, j)));
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

// Merge one candidate a lane ((+inf, kPad) where a lane has none) into
// the sorted list: sort the 32 candidates, put the reversed candidates
// against the list's last register (min: the 32 smallest of both, a
// bitonic run), sort that run descending, and merge the whole list (its
// first registers ascending, the last descending: bitonic) ascending.
template <int R>
__device__ __forceinline__ void merge(float (&bd)[R], int (&bi)[R], float d,
                                      int j, int lane) {
  float cd[1] = {d};
  int cj[1] = {j};
  bitonic_sort<1>(cd, cj, lane);
  const float rd = __shfl_xor_sync(kFull, cd[0], 31);
  const int rj = __shfl_xor_sync(kFull, cj[0], 31);
  if (before(rd, rj, bd[R - 1], bi[R - 1])) {
    bd[R - 1] = rd;
    bi[R - 1] = rj;
  }
  if (R > 1) {
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      exchange_lanes(bd[R - 1], bi[R - 1], stride, (lane & stride) != 0);
  }
  bitonic_merge<R>(bd, bi, lane);
}

// The box of lane `lane` among `n` boxes at `box` (2 float4 each): its
// bound's bits where it may hold a key that comes before (kd, kj), else
// kNone; its lowest index in `low`.
__device__ __forceinline__ unsigned box_key(const float4* box, int n,
                                            int lane, float qx, float qy,
                                            float qz, float kd, int kj,
                                            int& low) {
  low = kPad;
  if (lane >= n) return kNone;
  const float4 lo = box[2 * lane], hi = box[2 * lane + 1];
  const float lb = box_bound(qx, qy, qz, lo, hi);
  low = __float_as_int(lo.w);
  return before(lb, low, kd, kj) ? __float_as_uint(lb) : kNone;
}

// The nearest of the warp's boxes (keys, one a lane) that may still hold
// a key before (kd, kj), taken out of `key`: its lane, or -1 when none is
// left (every other box is at least as far).
__device__ __forceinline__ int next_box(unsigned& key, int low, float kd,
                                        int kj) {
  for (;;) {
    const unsigned m = __reduce_min_sync(kFull, key);
    if (m == kNone || __uint_as_float(m) > kd) return -1;
    const int w = __ffs(__ballot_sync(kFull, key == m)) - 1;
    if ((threadIdx.x & 31) == w) key = kNone;
    if (before(__uint_as_float(m), __shfl_sync(kFull, low, w), kd, kj))
      return w;
  }
}

// Grid (ceil(nq / kWarps), b), kWarps * 32 threads: warp i of the grid's
// row b takes the i-th query in visiting order.
template <int R, int MERGE>
__global__ void __launch_bounds__(kWarps * 32)
    topk_search(const float* __restrict__ query, Layout l,
                int64_t* __restrict__ idx_out, float* __restrict__ d2_out,
                int nq, int nk, int k, int self) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= nq) return;  // the whole warp
  const int b = blockIdx.y;
  const int nchunks = chunks_of(nk);
  const int ngroups = (nchunks + 31) / 32;
  const float4* __restrict__ tb = l.table + (size_t)b * nk;
  const float4* __restrict__ bx = l.boxes + (size_t)b * nchunks * 2;
  const float4* __restrict__ gb = l.groups + (size_t)b * ngroups * 2;

  int j, pos;
  float qx, qy, qz;
  if (self) {
    const float4 v = tb[i];
    j = __float_as_int(v.w);
    pos = i;
    qx = v.x;
    qy = v.y;
    qz = v.z;
  } else {
    j = l.qord[(size_t)b * nq + i];
    pos = l.qpos[(size_t)b * nq + j];
    const float* qp = query + ((size_t)b * nq + j) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }

  // fill: the R chunks around the query's position, sorted
  const int c0 = min(max(0, pos - 16 * R + 16) / kChunk, max(0, nchunks - R));
  float bd[R];
  int bi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = (c0 + r) * kChunk + lane;
    if (s < nk) {
      const float4 v = tb[s];
      bd[r] = dist2(qx, qy, qz, v);
      bi[r] = __float_as_int(v.w);
    } else {
      bd[r] = INFINITY;
      bi[r] = kPad;
    }
  }
  bitonic_sort<R>(bd, bi, lane);
  float kd;
  int kj;
  kth<R>(bd, bi, k, kd, kj);

  // groups, then their chunks, nearest box first; skip what cannot hold a
  // key that comes before the k-th pair
  for (int g0 = 0; g0 < ngroups; g0 += 32) {
    int glow;
    unsigned gkey = box_key(gb + 2 * g0, ngroups - g0, lane, qx, qy, qz, kd,
                            kj, glow);
    for (int gw; (gw = next_box(gkey, glow, kd, kj)) >= 0;) {
      const int cbase = (g0 + gw) * 32;
      int clow;
      unsigned ckey = box_key(bx + 2 * cbase, nchunks - cbase, lane, qx, qy,
                              qz, kd, kj, clow);
      if (cbase + lane >= c0 && cbase + lane < c0 + R) ckey = kNone;  // fill
      for (int cw; (cw = next_box(ckey, clow, kd, kj)) >= 0;) {
        const int s = (cbase + cw) * kChunk + lane;
        const bool valid = s < nk;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (valid) v = tb[s];
        const float dx = __fsub_rn(qx, v.x);
        const float dy = __fsub_rn(qy, v.y);
        const float xy = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (!__any_sync(kFull, valid && xy <= kd)) continue;
        const float dz = __fsub_rn(qz, v.z);
        const float d = __fadd_rn(xy, __fmul_rn(dz, dz));
        const int jj = __float_as_int(v.w);
        const bool cand = valid && before(d, jj, kd, kj);
        if (MERGE) {
          if (__any_sync(kFull, cand)) {
            merge<R>(bd, bi, cand ? d : INFINITY, cand ? jj : kPad, lane);
            kth<R>(bd, bi, k, kd, kj);
          }
        } else {
          unsigned mask = __ballot_sync(kFull, cand);
          while (mask) {  // any order: the pairs are totally ordered
            const int src = __ffs(mask) - 1;
            insert<R>(bd, bi, __shfl_sync(kFull, d, src),
                      __shfl_sync(kFull, jj, src), lane);
            kth<R>(bd, bi, k, kd, kj);
            mask &= mask - 1;
            mask &= __ballot_sync(kFull, valid && before(d, jj, kd, kj));
          }
        }
      }
    }
  }

  int64_t* io = idx_out + ((size_t)b * nq + j) * k;
  float* dout = d2_out + ((size_t)b * nq + j) * k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = 32 * r + lane;
    if (s < k) {
      io[s] = bi[r];
      dout[s] = bd[r];
    }
  }
}

cudaError_t prep(const float* q, const float* keys, const Layout& l, int b,
                 int nq, int nk, int self, cudaStream_t stream) {
  const int smem = (kCells + 3 * kBins + 1) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      topk_prep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  topk_prep<<<b, kPrepThreads, smem, stream>>>(q, keys, l, nq, nk, self);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ngroups = (chunks_of(nk) + 31) / 32;
  topk_boxes<<<dim3(ngroups, b), kPrepThreads, 0, stream>>>(l, nk);
  return cudaGetLastError();
}

template <int R>
cudaError_t search(const float* q, const Layout& l, int64_t* idx, float* d2,
                   int b, int nq, int nk, int k, int merge, int self,
                   cudaStream_t stream) {
  const dim3 grid((nq + kWarps - 1) / kWarps, b);
  if (merge)
    topk_search<R, 1><<<grid, kWarps * 32, 0, stream>>>(q, l, idx, d2, nq,
                                                        nk, k, self);
  else
    topk_search<R, 0><<<grid, kWarps * 32, 0, stream>>>(q, l, idx, d2, nq,
                                                        nk, k, self);
  return cudaGetLastError();
}

bool sizes_ok(int b, int nq, int nk) {
  return b >= 1 && nq >= 1 && nk >= 1 && b <= 65535;
}

}  // namespace

// Bytes of workspace `dh3d_knn_topk` needs for these sizes.
extern "C" size_t dh3d_knn_topk_workspace(int b, int nq, int nk) {
  if (!sizes_ok(b, nq, nk)) return 0;
  return layout(nullptr, b, nq, nk).bytes;
}

// The pre-pass alone (for timing it): the sorted key table and the boxes
// in `workspace`.
extern "C" int dh3d_knn_topk_prepass(const void* query, const void* keys,
                                     void* workspace, int b, int nq, int nk,
                                     void* stream) {
  if (!sizes_ok(b, nq, nk) || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const int self = query == keys && nq == nk;
  return (int)prep(static_cast<const float*>(query),
                   static_cast<const float*>(keys),
                   layout(workspace, b, nq, nk), b, nq, nk, self,
                   static_cast<cudaStream_t>(stream));
}

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64,
// d2 [b, nq, k] f32, both ascending by (d2, index).  `workspace` holds
// dh3d_knn_topk_workspace(b, nq, nk) bytes.  merge: 0 inserts a chunk's
// candidates one at a time, 1 merges them into the list at once.  The
// query is the key table itself when query == keys and nq == nk.  Requires
// 1 <= k <= 128 and k <= nk; returns cudaErrorInvalidValue otherwise.
// Launches the pre-pass and the search on `stream`; does not synchronise.
extern "C" int dh3d_knn_topk(const void* query, const void* keys, void* idx,
                             void* d2, void* workspace, int b, int nq, int nk,
                             int k, int merge, void* stream) {
  if (!sizes_ok(b, nq, nk) || k < 1 || k > 128 || k > nk ||
      workspace == nullptr || (merge != 0 && merge != 1))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int self = query == keys && nq == nk;
  const Layout l = layout(workspace, b, nq, nk);
  cudaError_t err = prep(q, kp, l, b, nq, nk, self, s);
  if (err != cudaSuccess) return (int)err;
  if (k <= 32) return (int)search<1>(q, l, io, dp, b, nq, nk, k, merge, self, s);
  if (k <= 64) return (int)search<2>(q, l, io, dp, b, nq, nk, k, merge, self, s);
  return (int)search<4>(q, l, io, dp, b, nq, nk, k, merge, self, s);
}
