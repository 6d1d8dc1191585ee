"""Exact k nearest neighbours: kernel A (`csrc/knn.cu`) and its plain version.

Counterpart of `dh3d_tpu/ops/knn.py` and of the Pallas kernels
`knn_pallas._knn_kernel_packed` (self-kNN), `knn_pallas._knn_kernel_banded`
(3-NN over the whole key table) and `knn_pallas._knn_kernel` (exact cross
kNN: the detection loss's k=16 queries, `knn_bruteforce_pairwise`).  Semantics of the reference CPU kernel
(`user_ops/kernels/knn_bruteforce_kernel.cc:25-72`): neighbours ascending by
distance, the lowest index first among equal distances, so a self query
finds itself at slot 0 (distance exactly 0).

Both versions build d2 = (dx*dx + dy*dy) + dz*dz with each operation
rounded on its own, so they agree bit for bit on d2 and therefore on the
indices.  The JAX CPU path builds d2 with the matmul identity instead and
pins self at -1 (`dh3d_tpu/ops/knn.py:38-52`): indices agree with it except
where two distances are within its rounding error.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import kernels

MAX_K = 32
_CHUNK_ELEMS = 1 << 23  # bounds the plain version's [B, chunk, Nk] d2 block


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


def knn(query: torch.Tensor, keys: torch.Tensor, k: int):
    """k nearest keys of every query, exact.

    query [B, Nq, 3] and keys [B, Nk, 3] float32, contiguous, 1 <= k <=
    min(32, Nk).  Returns (idx [B, Nq, k] int64 into keys, d2 [B, Nq, k]
    float32 squared distances), ascending; the lowest index wins ties.
    CPU tensors take the plain version; CUDA tensors launch kernel A."""
    B, Nq = query.shape[:2]
    kernels.check(query, "query", torch.float32, (None, None, 3))
    kernels.check(keys, "keys", torch.float32, (B, None, 3))
    Nk = keys.shape[1]
    if not 1 <= k <= min(MAX_K, Nk):
        raise ValueError(f"k={k} outside [1, min({MAX_K}, Nk={Nk})]")
    if not kernels.on_cuda(query, keys):
        return knn_plain(query, keys, k)
    idx = torch.empty(B, Nq, k, dtype=torch.int64, device=query.device)
    d2 = torch.empty(B, Nq, k, dtype=torch.float32, device=query.device)
    kernels.KNN.launch(query.device, query.data_ptr(), keys.data_ptr(),
                       idx.data_ptr(), d2.data_ptr(), B, Nq, Nk, k)
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
