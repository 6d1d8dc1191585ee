"""Point-axis-sharded kNN: the counterpart of
`dh3d_tpu/parallel/sharded_knn.py:24-54`.

For clouds too large for one device, the point axis shards over a group:
each rank holds a contiguous block of N/n query rows, all-gathers the
(small, 3-D) coordinates of every block, and runs the exact kNN of its
queries against all of them (`ops.knn`: kernel A or G on CUDA), so the
neighbour ids are global.  The rows equal `ops.knn_bruteforce`'s rows of
that block bit for bit: the kNN of one query does not depend on the other
queries, and self is at slot 0 by the (d2, index) order.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import ops
from dh3d_tpu_torch.parallel.collectives import all_gather, position, size


def point_block(positions: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of rows of positions [B, N, 3] (all
    ranks holding the whole cloud): [B, N/n, 3].  Raises ValueError unless
    N divides across the group, as the JAX function does."""
    n, N = size(group), positions.shape[1]
    if N % n:
        raise ValueError(f"N={N} must divide across {n} devices")
    rows = N // n
    at = position(group) * rows
    return positions[:, at:at + rows].contiguous()


def knn_sharded(positions: torch.Tensor, k: int, group):
    """kNN with the point axis sharded over `group` (a process group or a
    `parallel.Mesh`).

    positions: this rank's block of query rows [B, N/n, 3] (`point_block`),
    every rank's block of one size.  Returns (idx [B, N/n, k] int64 global
    ids into the whole cloud, dist [B, N/n, k] Euclidean), the rows
    `ops.knn_bruteforce` gives this block."""
    with torch.no_grad():
        keys = all_gather(positions.contiguous(), group, dim=1).contiguous()
    idx, d2 = ops.knn(positions.contiguous(), keys, k)
    return idx, torch.sqrt(d2)
