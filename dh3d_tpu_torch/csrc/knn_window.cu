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
// table (s_i + row) with their d2.
//
// The order: every comparison is on the pair (d2, index) as one 64-bit
// key, (d2's bits << 32) | id.  d2 >= 0 (a sum of squares, never -0)
// orders as its unsigned bits, and a NaN is given the one canonical NaN's
// bits, which order above +inf, so one unsigned compare gives the (d2,
// index) order with NaN last, as a stable sort gives it.  This is a total
// order over the band's keys, so the result does not depend on the order
// in which keys are visited, which the design below is free to choose.
//
// What bounds it on an H100: issued instructions, many of them on the
// integer pipe (half the f32 rate): the 64-bit pair compares, selects and
// insertions.  At [20, 8192], W = 512, 8.4e7 query-key pairs each issue
// at least a key load, the x-y terms and a compare (7 instructions: the
// floor `chip_smoke.py` reports); the bytes (queries, keys, outputs) are a
// few MB.  The design, against the limits of one thread scanning a query's
// band in order (a dependent insertion a key once it got nearer, and a
// grid of 16 blocks at [1, 4096]):
//   - parallelism: a group of L lanes a query (L = 1, 2, 4, 8, 16 or 32,
//     the plan `window_plan` in ops/knn.py picks it), 256 / L queries a
//     block of 256 threads, so a tile of 256 queries is L blocks and small
//     clouds still fill the card.  Lane l visits band rows l, l + L, ...
//     in steps of U = 8 rows a lane (4 where a pass's rows a lane are not
//     a multiple of 8) and keeps its own sorted list of KMAX pairs in
//     registers (KMAX in {4, 8, 16, 32}, the least that holds k).  Each
//     block stages its band once in shared memory as float4 {x, y, z, 0},
//     1024 keys a pass (a band of 512 is one pass of 8 KB); at a step the
//     lanes of a warp read L consecutive float4, each lane's group reading
//     the same ones, so there are no bank conflicts;
//   - a fill, then a threshold before every key: the first step is the
//     one that holds the query's proportional position p = q * M / N (its
//     own row for a self query, clamped into the band), whose U L rows are
//     its nearest in the Morton order; their pairs, sorted by a network,
//     fill each lane's list, and the steps then go on from there and wrap
//     around.  Before each step the group's threshold is the least of the
//     lanes' last entries and the largest of their entries
//     ceil(KMAX / L) - 1 (the lists hold KMAX pairs at or before either),
//     so a pair enters only below it: any KMAX keys of the band bound its
//     KMAX-th nearest from above.  An insertion is branch-free (entry s
//     becomes max(l[s - 1], min(l[s], key)));
//   - fewer instructions a pair: a step first sums dx*dx + dy*dy; adding
//     dz*dz >= 0 in round-to-nearest cannot lower it, so when every partial
//     sum of the step exceeds the threshold's d2 the step ends before the z
//     terms.  Then d2's 32 bits are compared with the threshold's, and the
//     64-bit pair only for the keys that pass;
//   - the merge: the group's top k are k rounds of a 64-bit minimum of the
//     lanes' list heads by butterfly shuffles; the lane whose head it was
//     pops it, and lane r % L writes entry r.  Every one of the k nearest
//     is in its lane's list when the scan ends (it is below every
//     threshold), unless that list holds KMAX pairs before it.
//   Measured on an H100 at [20, 8192] in one-off builds not kept here:
//   most of the time is the selection (the z terms, the pair compares and
//   the insertions, where one lane's insertion holds up its warp), not the
//   scan of x-y sums.  Tried there and not kept: a bound from k rows a lane
//   before an in-order scan (slower: twice the insertions); a loop over a
//   step's admitted keys (slower); a box a step of rows that skips the step
//   whole, a plain d2 filter in place of the x-y exit, and 64 registers a
//   thread (no faster); queues of admitted rows that the whole warp inserts
//   at once (faster at [20, 8192] only); the group's list spread over its
//   lanes, a pair a lane, with shuffle insertions (slower).
//
// Contract, shared with the plain version in ops/knn.py (`knn_window`):
//   d2 = (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA contraction), so the plain PyTorch
//   version reproduces d2, and the ids, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTileQ = 256;    // queries a tile share its band
constexpr int kAlign = 128;    // a band starts on a multiple of it
constexpr int kThreads = 256;  // threads a block
constexpr int kStage = 1024;   // band keys staged in shared memory a pass
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kEmpty = ~0ull;  // an empty list entry: after every pair

// d2's bits in the pair order: NaN as the canonical NaN, above +inf
__device__ __forceinline__ uint32_t order_bits(float d2) {
  return d2 != d2 ? 0x7fc00000u : __float_as_uint(d2);
}

__device__ __forceinline__ u64 pair_key(float d2, uint32_t id) {
  return (static_cast<u64>(order_bits(d2)) << 32) | id;
}

__device__ __forceinline__ float xy_sum(float qx, float qy, float4 k) {
  const float dx = __fsub_rn(qx, k.x);
  const float dy = __fsub_rn(qy, k.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float plus_z(float xy, float qz, float4 k) {
  const float dz = __fsub_rn(qz, k.z);
  return __fadd_rn(xy, __fmul_rn(dz, dz));
}

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a < b ? a : b; }

// The least of the group's L values (every lane gets it).
template <int L>
__device__ __forceinline__ u64 group_min(u64 v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = min64(v, __shfl_xor_sync(kFull, v, o, L));
  return v;
}

// Insert `key` into the ascending list l of length KMAX: entry s becomes
// max(l[s - 1], min(l[s], key)), with no branch.  The caller has checked
// key < l[KMAX - 1].  Fully unrolled so the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert_sorted(u64 (&l)[KMAX], u64 key) {
#pragma unroll
  for (int s = KMAX - 1; s > 0; --s) {  // from the old l[s - 1] and l[s]
    const u64 m = min64(l[s], key);
    l[s] = l[s - 1] > m ? l[s - 1] : m;
  }
  l[0] = min64(l[0], key);
}

// Sort U pairs ascending (odd-even transposition), in registers.
template <int U>
__device__ __forceinline__ void sort_pairs(u64 (&c)[U]) {
#pragma unroll
  for (int r = 0; r < U; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < U; i += 2) {
      const u64 lo = min64(c[i], c[i + 1]);
      c[i + 1] = c[i] ^ c[i + 1] ^ lo;
      c[i] = lo;
    }
  }
}

// The group's threshold: no pair at or after it is among the group's k
// nearest.  The least of the lanes' last entries (each list's KMAX pairs
// bound it), and the largest of their entries ceil(KMAX / L) - 1: the L
// lists hold at least L * ceil(KMAX / L) >= KMAX pairs at or before it.
// A threshold is a listed pair, and each key is visited once, so a pair
// enters only strictly below it.
template <int KMAX, int L>
__device__ __forceinline__ u64 group_threshold(const u64 (&list)[KMAX]) {
  u64 lo = list[KMAX - 1];
  if (L == 1) return lo;
  u64 hi = list[(KMAX + L - 1) / L - 1];
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    lo = min64(lo, __shfl_xor_sync(kFull, lo, o, L));
    const u64 h = __shfl_xor_sync(kFull, hi, o, L);
    hi = h > hi ? h : hi;
  }
  return min64(lo, hi);
}

// A lane's first step, the U rows nearest the query's position: every
// pair, sorted, fills the empty list.
template <int KMAX, int U>
__device__ __forceinline__ void fill_step(const float4* band, int j, int L,
                                          uint32_t id0, float qx, float qy,
                                          float qz, u64 (&list)[KMAX]) {
  u64 c[U];
#pragma unroll
  for (int a = 0; a < U; ++a) {
    const float4 kv = band[j + a * L];
    c[a] = pair_key(plus_z(xy_sum(qx, qy, kv), qz, kv), id0 + j + a * L);
  }
  sort_pairs<U>(c);
#pragma unroll
  for (int r = 0; r < KMAX; ++r) list[r] = r < U ? c[r < U ? r : 0] : kEmpty;
}

// One step of a lane: its U band rows j, j + L, ..., j + (U - 1) L of the
// staged pass (ids id0 + row).  A pair enters the list only below `thr`.
template <int KMAX, int L, int U>
__device__ __forceinline__ void scan_step(const float4* band, int j,
                                          uint32_t id0, float qx, float qy,
                                          float qz, u64 (&list)[KMAX],
                                          u64 thr) {
  float4 kv[U];
  float d[U];
#pragma unroll
  for (int a = 0; a < U; ++a) kv[a] = band[j + a * L];
  const uint32_t th = static_cast<uint32_t>(thr >> 32);
  const float tf = __uint_as_float(th);
  bool near = false;
#pragma unroll
  for (int a = 0; a < U; ++a) {
    d[a] = xy_sum(qx, qy, kv[a]);
    near |= !(d[a] > tf);  // a NaN on either side goes on
  }
  if (!near) return;  // d2 >= its x-y sum > thr's d2 for every key
  bool any = false;
#pragma unroll
  for (int a = 0; a < U; ++a) {
    d[a] = plus_z(d[a], qz, kv[a]);
    any |= order_bits(d[a]) <= th;
  }
  if (!any) return;
#pragma unroll
  for (int a = 0; a < U; ++a) {
    const u64 c = pair_key(d[a], id0 + j + a * L);
    if (c < thr) {
      insert_sorted<KMAX>(list, c);
      thr = min64(thr, list[KMAX - 1]);
    }
  }
}

// A staged pass of tn rows, tn / (L U) steps a lane.  The first pass
// starts at the step s0 that holds the query's position and fills the
// list there; the steps then go on from it and wrap around.
template <int KMAX, int L, int U>
__device__ __forceinline__ void scan_pass(const float4* band, int tn,
                                          uint32_t id0, bool first, int s0,
                                          float qx, float qy, float qz,
                                          u64 (&list)[KMAX]) {
  const int lane = threadIdx.x & (L - 1);
  const int steps = tn / (L * U);
  int s = 0;
  if (first) {
    fill_step<KMAX, U>(band, lane + s0 * U * L, L, id0, qx, qy, qz, list);
    s = 1;
  }
  for (; s < steps; ++s) {
    int step = s0 + s;
    step = step < steps ? step : step - steps;
    scan_step<KMAX, L, U>(band, lane + step * U * L, id0, qx, qy, qz, list,
                          group_threshold<KMAX, L>(list));
  }
}

// Grid (nq * L / kThreads, B), kThreads threads: 256 / L queries a block,
// L blocks a query tile.  Writes the first k pairs of each query.
template <int KMAX, int L>
__global__ void __launch_bounds__(kThreads)
    knn_window_kernel(const float* __restrict__ query,
                      const float* __restrict__ keys,
                      int64_t* __restrict__ idx_out,
                      float* __restrict__ d2_out, int nq, int nk, int k,
                      int window) {
  constexpr int kGroups = kThreads / L;  // queries a block
  __shared__ float4 band[kStage];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & (L - 1);
  const int q = blockIdx.x * kGroups + threadIdx.x / L;  // nq % 256 == 0
  const int64_t tile = blockIdx.x / L;
  const int64_t centre =
      (2 * tile + 1) * kTileQ * (int64_t)nk / (2 * (int64_t)nq);
  int64_t start = centre - window / 2;
  start = start < 0 ? 0 : start;
  start = start > nk - window ? nk - window : start;
  start = start / kAlign * kAlign;

  const float* qp = query + ((size_t)b * nq + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* kb = keys + ((size_t)b * nk + start) * 3;

  // the query's proportional position in the band, and the pass that
  // holds the tile's centre: the block stages it first
  int64_t pos = (int64_t)q * nk / nq - start;
  pos = pos < 0 ? 0 : pos;
  pos = pos > window - 1 ? window - 1 : pos;
  const int passes = (window + kStage - 1) / kStage;
  int64_t first = (centre - start) / kStage;
  first = first < 0 ? 0 : first;
  first = first > passes - 1 ? passes - 1 : first;

  u64 list[KMAX];
  for (int pi = 0; pi < passes; ++pi) {
    const int t0 = (int)((first + pi) % passes) * kStage;
    const int tn = min(kStage, window - t0);  // a multiple of 128
    __syncthreads();  // the previous pass has been consumed
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      const float* kp = kb + (size_t)(t0 + j) * 3;
      band[j] = make_float4(kp[0], kp[1], kp[2], 0.0f);
    }
    __syncthreads();
    const uint32_t id0 = (uint32_t)(start + t0);
    // tn / L rows a lane: a multiple of 4, and of 8 where it can
    const int u = (tn / L) % 8 == 0 ? 8 : 4;
    int s0 = 0;
    if (pi == 0) {
      const int64_t at = (pos - t0) / L / u;
      s0 = at < 0 ? 0 : at >= tn / (L * u) ? tn / (L * u) - 1 : (int)at;
    }
    if (u == 8)
      scan_pass<KMAX, L, 8>(band, tn, id0, pi == 0, s0, qx, qy, qz, list);
    else
      scan_pass<KMAX, L, 4>(band, tn, id0, pi == 0, s0, qx, qy, qz, list);
  }

  const size_t row = (size_t)b * nq + q;
  int64_t* io = idx_out + row * k;
  float* dout = d2_out + row * k;
  if (L == 1) {
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < k) {
        io[r] = (int64_t)(uint32_t)list[r];
        dout[r] = __uint_as_float((uint32_t)(list[r] >> 32));
      }
    }
    return;
  }
  for (int r = 0; r < k; ++r) {
    const u64 m = group_min<L>(list[0]);
    if (list[0] == m) {  // pop the head (pairs differ in their ids)
#pragma unroll
      for (int s = 0; s + 1 < KMAX; ++s) list[s] = list[s + 1];
      list[KMAX - 1] = kEmpty;
    }
    if ((r & (L - 1)) == lane) {
      io[r] = (int64_t)(uint32_t)m;
      dout[r] = __uint_as_float((uint32_t)(m >> 32));
    }
  }
}

template <int KMAX, int L>
cudaError_t launch(const float* q, const float* keys, int64_t* idx, float* d2,
                   int b, int nq, int nk, int k, int window,
                   cudaStream_t stream) {
  const dim3 grid(nq / (kThreads / L), b);
  knn_window_kernel<KMAX, L><<<grid, kThreads, 0, stream>>>(
      q, keys, idx, d2, nq, nk, k, window);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_lanes(int lanes, const float* q, const float* keys,
                         int64_t* idx, float* d2, int b, int nq, int nk,
                         int k, int window, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch<KMAX, 1>(q, keys, idx, d2, b, nq, nk, k, window, st);
    case 2: return launch<KMAX, 2>(q, keys, idx, d2, b, nq, nk, k, window, st);
    case 4: return launch<KMAX, 4>(q, keys, idx, d2, b, nq, nk, k, window, st);
    case 8: return launch<KMAX, 8>(q, keys, idx, d2, b, nq, nk, k, window, st);
    case 16:
      return launch<KMAX, 16>(q, keys, idx, d2, b, nq, nk, k, window, st);
    default:
      return launch<KMAX, 32>(q, keys, idx, d2, b, nq, nk, k, window, st);
  }
}

}  // namespace

// query [b, nq, 3] f32, keys [b, nk, 3] f32 -> idx [b, nq, k] int64 (into
// the whole key table), d2 [b, nq, k] f32, ascending by (d2, index), each
// query among the `window` keys of its tile's band, searched by `lanes`
// lanes a query.  Requires nq % 256 == 0, window % 128 == 0, 0 < window
// <= nk, 1 <= k <= min(window, 32) and lanes in {1, 2, 4, 8, 16, 32};
// returns cudaErrorInvalidValue otherwise.  Launches on `stream` and does
// not synchronise.
extern "C" int dh3d_knn_window(const void* query, const void* keys,
                               void* idx, void* d2, int b, int nq, int nk,
                               int k, int window, int lanes, void* stream) {
  if (b < 1 || b > 65535 || nq < kTileQ || nq % kTileQ != 0 ||
      window < kAlign || window % kAlign != 0 || window > nk || k < 1 ||
      k > kMaxK || k > window || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(query);
  const float* kp = static_cast<const float*>(keys);
  int64_t* io = static_cast<int64_t*>(idx);
  float* dp = static_cast<float*>(d2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the list length is a compile-time constant so that it lives in
  // registers; the first k of the sorted top-KMAX are the top k
  if (k <= 4)
    return (int)launch_lanes<4>(lanes, qp, kp, io, dp, b, nq, nk, k, window,
                                st);
  if (k <= 8)
    return (int)launch_lanes<8>(lanes, qp, kp, io, dp, b, nq, nk, k, window,
                                st);
  if (k <= 16)
    return (int)launch_lanes<16>(lanes, qp, kp, io, dp, b, nq, nk, k,
                                 window, st);
  return (int)launch_lanes<32>(lanes, qp, kp, io, dp, b, nq, nk, k, window,
                               st);
}
