"""Exact k nearest neighbours: kernels A (`csrc/knn.cu`, k <= 7) and G
(`csrc/knn_topk.cu`, 8 <= k <= 128) and their plain version; the windowed
kNN of the legacy Morton-band mode: kernel H (`csrc/knn_window.cu`), its
launch plan `window_plan` and its plain version.

Counterpart of `dh3d_tpu/ops/knn.py` and of the Pallas kernels
`knn_pallas._knn_kernel_banded` (3-NN over the whole key table; a window
of W < M key rows is `knn_window`),
`knn_pallas._knn_kernel_packed` (self-kNN), `knn_pallas._knn_kernel`
(exact cross kNN: the detection loss's k=16 queries,
`knn_bruteforce_pairwise`) and `knn_pallas._knn_kernel_slab` (every k >=
32: keypoint NMS's k=50).  Kernel G's launch plan, `topk_plan` (how a
chunk's candidates enter its list), is pure Python, so it is tested on the
CPU.  Semantics of the reference CPU
kernel (`user_ops/kernels/knn_bruteforce_kernel.cc:25-72`): neighbours
ascending by distance, the lowest index first among equal distances, so a
self query finds itself at slot 0 (distance exactly 0).

All versions build d2 = (dx*dx + dy*dy) + dz*dz with each operation
rounded on its own, so they agree bit for bit on d2 and therefore on the
indices.  The JAX CPU path builds d2 with the matmul identity instead and
pins self at -1 (`dh3d_tpu/ops/knn.py:38-52`): indices agree with it except
where two distances are within its rounding error.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import kernels

# Kernel A's largest k; kernel G takes every k above it.  In one call on an
# H100 (PERF.md section 6, rows 1-4) G took 47-57% less
# time than A at the path's k >= 8 shapes (the self kNN k=8 at [20,8192]
# and [1,16384], padded or not, the detection loss's k=16 [10,512] x
# [10,8192]) and 3% less at k=8 [20,1024]; at the 3-NN [20,8192] ->
# [20,1024] it took twice A's time: A's list of 3 costs less than G's fill
# of 32.  The line is drawn by k, so that each k has one kernel.
MAX_K = 7
TOPK_MAX_K = 128  # kernel G's largest k (`dh3d_knn_topk`)
TOPK_CHUNK = 32  # keys a chunk of kernel G's sorted table
_CHUNK_ELEMS = 1 << 23  # bounds the plain version's [B, chunk, Nk] d2 block
TILE_Q = 256  # queries a band shares (`knn_banded`'s tile_q)
WINDOW_ALIGN = 128  # a band starts on a multiple of it (`_win_start`)
WINDOW_MAX_K = 32  # kernel H's largest k (`dh3d_knn_window`)
WINDOW_LANES = (1, 2, 4, 8, 16, 32)  # kernel H's plans: lanes a query


def topk_plan(k: int) -> int:
    """Kernel G's plan at k: merge 1, a chunk's candidates merged into the
    list at once, above k = 32 (a list of 64 or 128); merge 0, inserted one
    at a time, at or below it (a list of 32).  A sweep of both at the
    path's shapes on an H100 (`chip_smoke.py --sweep`; PERF.md §6) chose
    it: merging won by 11-46% above k = 32 and lost by 5-29% below."""
    return 1 if k > 32 else 0


def knn_plain(query: torch.Tensor, keys: torch.Tensor, k: int):
    """Plain PyTorch kNN: chunked direct distances and a stable sort.

    query [B, Nq, 3], keys [B, Nk, 3] -> (idx [B, Nq, k] int64,
    d2 [B, Nq, k] float32), ascending."""
    B, Nq, _ = query.shape
    Nk = keys.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(1, B * Nk))
    idx, dist = [], []
    kx, ky, kz = (keys[:, None, :, d] for d in range(3))
    for s in range(0, Nq, chunk):
        q = query[:, s:s + chunk, None, :]
        dx = q[..., 0] - kx
        dy = q[..., 1] - ky
        dz = q[..., 2] - kz
        d2 = (dx * dx + dy * dy) + dz * dz
        vals, order = torch.sort(d2, dim=-1, stable=True)
        idx.append(order[..., :k])
        dist.append(vals[..., :k])
    return torch.cat(idx, dim=1), torch.cat(dist, dim=1)


def knn(query: torch.Tensor, keys: torch.Tensor, k: int, plan=None):
    """k nearest keys of every query, exact.

    query [B, Nq, 3] and keys [B, Nk, 3] float32, contiguous, 1 <= k <=
    Nk.  Returns (idx [B, Nq, k] int64 into keys, d2 [B, Nq, k] float32
    squared distances), ascending by (d2, index): the lowest index wins
    ties, so a self query is at slot 0 but behind an exact duplicate with
    a lower index.  CPU tensors take the plain version, for any k.  CUDA
    tensors launch kernel A for k <= 7 and kernel G for 8 <= k <= 128, or
    G at any k with `plan` (its merge: 0 or 1) given; G's own plan is
    `topk_plan`'s.  Kernel G sorts the keys into spatial chunks, prunes
    them by their boxes and selects by (d2, index), so its output is the
    same whatever order it visits keys in.  Raises ValueError for k > 128
    and for a plan the kernel does not take."""
    B, Nq = query.shape[:2]
    kernels.check(query, "query", torch.float32, (None, None, 3))
    kernels.check(keys, "keys", torch.float32, (B, None, 3))
    Nk = keys.shape[1]
    if not 1 <= k <= Nk:
        raise ValueError(f"k={k} outside [1, Nk={Nk}]")
    if not kernels.on_cuda(query, keys):
        return knn_plain(query, keys, k)
    if k > TOPK_MAX_K:
        raise ValueError(f"knn on CUDA: k={k} above kernel G's limit "
                         f"k <= {TOPK_MAX_K}")
    dev = query.device
    idx = torch.empty(B, Nq, k, dtype=torch.int64, device=dev)
    d2 = torch.empty(B, Nq, k, dtype=torch.float32, device=dev)
    if plan is None and k <= MAX_K:
        kernels.KNN.launch(dev, query.data_ptr(), keys.data_ptr(),
                           idx.data_ptr(), d2.data_ptr(), B, Nq, Nk, k)
        return idx, d2
    ws = torch.empty(kernels.topk_workspace_bytes(B, Nq, Nk),
                     dtype=torch.uint8, device=dev)
    kernels.KNN_TOPK.launch(dev, query.data_ptr(), keys.data_ptr(),
                            idx.data_ptr(), d2.data_ptr(), ws.data_ptr(),
                            B, Nq, Nk, k,
                            topk_plan(k) if plan is None else plan)
    return idx, d2


def topk_prepass(query: torch.Tensor, keys: torch.Tensor):
    """Kernel G's pre-pass alone, on CUDA tensors (for timing it and for
    the card tests): returns (table [B, Nk, 4] float32, the keys sorted
    into chunks of 32 with their original index's bits in column 3; boxes
    [B, ceil(Nk / 32), 2, 4], each chunk's lo (columns 0-2) with its lowest
    original index's bits (column 3), then its hi).  The order within a
    cell is left by atomics: it may differ between runs."""
    B, Nq, Nk = query.shape[0], query.shape[1], keys.shape[1]
    dev = query.device
    ws = torch.empty(kernels.topk_workspace_bytes(B, Nq, Nk),
                     dtype=torch.uint8, device=dev)
    kernels.KNN_TOPK_PREPASS.launch(dev, query.data_ptr(), keys.data_ptr(),
                                    ws.data_ptr(), B, Nq, Nk)
    nchunks = -(-Nk // TOPK_CHUNK)
    at = 16 * B * Nk  # the table's bytes, then the boxes'
    table = ws[:at].view(torch.float32).view(B, Nk, 4)
    boxes = ws[at:at + 32 * B * nchunks].view(torch.float32).view(
        B, nchunks, 2, 4)
    return table, boxes


def knn_bruteforce(positions: torch.Tensor, k: int,
                   window: int | None = None):
    """k nearest neighbours of every point within its own cloud
    (`dh3d_tpu/ops/knn.py:61`): positions [B, N, 3] -> (idx [B, N, k]
    int64, dist [B, N, k] Euclidean), ascending, self at slot 0.

    `window` (the legacy Morton-band mode) routes as the JAX op does
    (`dh3d_tpu/ops/knn.py:90-102`): with N % 256 == 0 and window < N, the
    k nearest within each query tile's band of `window` rows
    (`knn_window`); else the exact kNN.  A window of the whole table is
    the exact kNN, which `knn` computes."""
    N = positions.shape[1]
    if window is not None and N % TILE_Q == 0 and window < N:
        idx, d2 = knn_window(positions, positions, k, window)
    else:
        idx, d2 = knn(positions, positions, k)
    return idx, torch.sqrt(d2)


def knn_bruteforce_pairwise(query: torch.Tensor, reference: torch.Tensor,
                            k: int):
    """k nearest points of `reference` for each point of `query`, across
    clouds (`dh3d_tpu/ops/knn.py:134`): query [B, M, 3], reference
    [B, N, 3] -> (idx [B, M, k] int64, dist [B, M, k] Euclidean),
    ascending, the lowest index first among equal distances."""
    idx, d2 = knn(query, reference, k)
    return idx, torch.sqrt(d2)


# ------------------------- the Morton-band kNN (H) -------------------------

def win_start(n_queries: int, n_keys: int, window: int,
              device=None) -> torch.Tensor:
    """The first key row of each query tile's band: [n_queries // 256]
    int64, s_i = floor(clip(c_i - window / 2, 0, n_keys - window) / 128) *
    128 with c_i = ((2i + 1) * 256 * n_keys) // (2 * n_queries), the tile's
    centre mapped proportionally onto the keys (`knn_pallas._win_start`).
    Computed in 64 bits: the JAX kernel computes (2i + 1) * 256 * n_keys
    in int32, which wraps for a self query above N = 32768 (there its
    starts differ from these)."""
    i = torch.arange(n_queries // TILE_Q, dtype=torch.int64, device=device)
    centre = (2 * i + 1) * TILE_Q * n_keys // (2 * n_queries)
    start = torch.clamp(centre - window // 2, 0, n_keys - window)
    return start // WINDOW_ALIGN * WINDOW_ALIGN


def knn_window_plain(query: torch.Tensor, keys: torch.Tensor, k: int,
                     window: int):
    """Plain PyTorch `knn_window`: each tile's queries against its band's
    keys, direct distances and a stable sort, a few tiles at a time."""
    B, N, _ = query.shape
    T = N // TILE_Q
    rows = win_start(N, keys.shape[1], window, query.device)[:, None] \
        + torch.arange(window, device=query.device)  # [T, window]
    q = query.reshape(B, T, TILE_Q, 3)
    chunk = max(1, _CHUNK_ELEMS // max(1, B * TILE_Q * window))
    idx, dist = [], []
    for t0 in range(0, T, chunk):
        r = rows[t0:t0 + chunk]
        kw = keys[:, r]  # [B, t, window, 3]
        qt = q[:, t0:t0 + chunk, :, None, :]  # [B, t, 256, 1, 3]
        d = qt - kw[:, :, None]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]  # [B, t, 256, window]
        vals, order = torch.sort(d2, dim=-1, stable=True)
        idx.append(r[None, :, None, :].expand(B, -1, TILE_Q, -1).gather(
            -1, order[..., :k]))
        dist.append(vals[..., :k])
    return (torch.cat(idx, 1).reshape(B, N, k),
            torch.cat(dist, 1).reshape(B, N, k))


def window_plan(k: int, window: int, queries: int) -> int:
    """Kernel H's plan: the lanes that search one query's band together
    (each a strided share of it, merged at the end), for `queries` = B * N
    queries, k neighbours and a band of `window` keys.  4 lanes, and more
    while the queries times the lanes stay under 2^16 threads and each lane
    keeps 16 keys or more.  A sweep of every plan at the path's shapes on
    an H100 (`chip_smoke.py --sweep`; PERF.md §6) chose it: 4 lanes were the
    fastest at [20,8192] and [1,16384] (k=8, W=512) and at the 3-NN W=256
    [1,32768]->[1,4096], 16 at [1,4096]; k did not change the order at the
    path's k of 3 and 8."""
    lanes = 4
    while lanes < 32 and queries * lanes < (1 << 16) \
            and window // (2 * lanes) >= 16:
        lanes *= 2
    return lanes


def knn_window(query: torch.Tensor, keys: torch.Tensor, k: int,
               window: int, plan: int | None = None):
    """The k nearest keys of every query within its tile's Morton band:
    the W < M case of `knn_pallas._knn_kernel_banded`, unpacked (exact d2,
    as `knn_banded(..., packed=False)`).

    query [B, N, 3] and keys [B, M, 3] float32, contiguous, both sorted
    along the same Z-order curve; N % 256 == 0, window % 128 == 0, window
    <= M and 1 <= k <= min(window, 32), else ValueError.  Query tile i
    (rows [256 i, 256 i + 256)) searches keys [s_i, s_i + window),
    s_i = `win_start`.  Returns (idx [B, N, k] int64 into the whole key
    table, d2 [B, N, k] float32), ascending by (d2, index): d2 as `knn`
    builds it, the lowest index first among equal distances.

    CPU tensors take the plain version; CUDA tensors launch kernel H with
    `plan` lanes a query (one of `WINDOW_LANES`; `window_plan`'s when
    None).  The plan changes the search, never the result."""
    kernels.check(query, "query", torch.float32, (None, None, 3))
    B, N = query.shape[:2]
    kernels.check(keys, "keys", torch.float32, (B, None, 3))
    M = keys.shape[1]
    if not (N > 0 and N % TILE_Q == 0 and window % WINDOW_ALIGN == 0
            and 0 < window <= M and 1 <= k <= min(window, WINDOW_MAX_K)):
        raise ValueError(
            f"knn_window: N={N} (a positive multiple of {TILE_Q}), "
            f"window={window} "
            f"(a multiple of {WINDOW_ALIGN}, <= M={M}), k={k} (1 <= k <= "
            f"min(window, {WINDOW_MAX_K}))")
    if not kernels.on_cuda(query, keys):
        return knn_window_plain(query, keys, k, window)
    dev = query.device
    idx = torch.empty(B, N, k, dtype=torch.int64, device=dev)
    d2 = torch.empty(B, N, k, dtype=torch.float32, device=dev)
    lanes = window_plan(k, window, B * N) if plan is None else plan
    kernels.KNN_WINDOW.launch(dev, query.data_ptr(), keys.data_ptr(),
                              idx.data_ptr(), d2.data_ptr(), B, N, M, k,
                              window, lanes)
    return idx, d2
