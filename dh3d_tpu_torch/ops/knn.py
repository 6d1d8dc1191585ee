"""Exact k nearest neighbours: kernels A (`csrc/knn.cu`, k <= 32) and G
(`csrc/knn_topk.cu`, 32 < k <= 128) and their plain version.

Counterpart of `dh3d_tpu/ops/knn.py` and of the Pallas kernels
`knn_pallas._knn_kernel_packed` (self-kNN), `knn_pallas._knn_kernel_banded`
(3-NN over the whole key table), `knn_pallas._knn_kernel` (exact cross
kNN: the detection loss's k=16 queries, `knn_bruteforce_pairwise`) and
`knn_pallas._knn_kernel_slab` (every k >= 32: keypoint NMS's k=50).
Kernel A's launch plan, `knn_plan` (its count of key slabs), is pure
Python, so it is tested on the CPU.  Semantics of the reference CPU
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

MAX_K = 32  # kernel A's largest k; kernel G takes the k above it
TOPK_MAX_K = 128  # kernel G's largest k (`dh3d_knn_topk`)
_CHUNK_ELEMS = 1 << 23  # bounds the plain version's [B, chunk, Nk] d2 block

# Kernel A's launch plan (`csrc/knn.cu`): 256 threads a block, a query a
# thread, and S key slabs on the grid, merged by a second kernel when S > 1.
KNN_THREADS = 256
KNN_MAX_SLABS = 64  # the most slabs the merge takes
KNN_MIN_SLAB = 2048  # keys: the plan cuts no shorter slab
KNN_BLOCKS_PER_SM = 4  # the plan splits keys until the blocks make these


def knn_slabs(nk: int, s: int) -> list:
    """Kernel A's S slabs of `nk` keys: [(lo, hi)], contiguous and
    ascending, each ceil(nk / s) keys long but the last (which may be
    shorter, or empty)."""
    size = -(-nk // s)
    return [(min(nk, i * size), min(nk, (i + 1) * size)) for i in range(s)]


def knn_plan(B: int, Nq: int, Nk: int, k: int, sm_count: int) -> int:
    """Kernel A's count of key slabs S for B clouds of Nq queries over Nk
    keys: 1 where B * ceil(Nq / 256) blocks give the card's `sm_count` SMs
    KNN_BLOCKS_PER_SM blocks each; else enough slabs for that, but none
    shorter than KNN_MIN_SLAB keys and at most KNN_MAX_SLABS.  A sweep of
    every S at the path's shapes on an H100 (`chip_smoke.py --sweep`;
    PERF.md) chose these: shorter slabs cost more in the merge and the
    per-block set-up than they win."""
    blocks = B * -(-Nq // KNN_THREADS)
    want = KNN_BLOCKS_PER_SM * sm_count
    if blocks >= want:
        return 1
    return max(1, min(-(-want // blocks), Nk // KNN_MIN_SLAB, KNN_MAX_SLABS))


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


def knn(query: torch.Tensor, keys: torch.Tensor, k: int, slabs=None):
    """k nearest keys of every query, exact.

    query [B, Nq, 3] and keys [B, Nk, 3] float32, contiguous, 1 <= k <=
    Nk.  Returns (idx [B, Nq, k] int64 into keys, d2 [B, Nq, k] float32
    squared distances), ascending; the lowest index wins ties.  CPU tensors
    take the plain version, for any k; CUDA tensors launch kernel A for
    k <= 32, with `slabs` key slabs or `knn_plan`'s, and kernel G for
    32 < k <= 128, and raise ValueError above or for a count of slabs
    kernel A does not take."""
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
    if k > MAX_K:
        if slabs is not None:
            raise ValueError(f"knn: kernel G (k={k}) takes no slabs")
        kernels.KNN_TOPK.launch(dev, query.data_ptr(), keys.data_ptr(),
                                idx.data_ptr(), d2.data_ptr(), B, Nq, Nk, k)
        return idx, d2
    s = slabs if slabs is not None else knn_plan(
        B, Nq, Nk, k, kernels.sm_count(dev.index or 0))
    slab_d2 = slab_idx = None
    if s > 1:  # each slab's top k, merged into idx / d2
        slab_d2 = torch.empty(s, B, Nq, k, dtype=torch.float32, device=dev)
        slab_idx = torch.empty(s, B, Nq, k, dtype=torch.int32, device=dev)
    kernels.KNN.launch(dev, query.data_ptr(), keys.data_ptr(), idx.data_ptr(),
                       d2.data_ptr(),
                       None if slab_d2 is None else slab_d2.data_ptr(),
                       None if slab_idx is None else slab_idx.data_ptr(),
                       B, Nq, Nk, k, s)
    return idx, d2


def knn_bruteforce(positions: torch.Tensor, k: int):
    """k nearest neighbours of every point within its own cloud
    (`dh3d_tpu/ops/knn.py:61`): positions [B, N, 3] -> (idx [B, N, k]
    int64, dist [B, N, k] Euclidean), ascending, self at slot 0."""
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
