"""Three-nearest-neighbour interpolation.

Counterpart of `dh3d_tpu/ops/interpolate.py:18-98` (semantics of
`tf_ops/interpolation/tf_interpolate.cpp`): `three_nn` is kernel A with
k = 3 (squared distances), or kernel H in a Morton band of the keys;
`three_interpolate` is kernel C with P = 1.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch.ops.knn import TILE_Q, knn, knn_window
from dh3d_tpu_torch.ops.neighborhood import NeighborInverse, weighted_sum


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor,
             window: int | None = None):
    """3 nearest points of xyz2 [B, M, 3] for every point of xyz1
    [B, N, 3].  Returns (dist [B, N, 3] SQUARED distances, idx [B, N, 3]
    int64), ascending (`tf_interpolate.cpp:72`).

    `window` (the legacy Morton-band mode, both clouds sorted along the
    same curve) routes as the JAX op does (`dh3d_tpu/ops/interpolate.py:
    35-39`): with N % 256 == 0 and window < M, the 3 nearest within each
    query tile's band of `window` key rows (`knn_window`); else the exact
    3-NN, which a window of the whole table is."""
    if window is not None and xyz1.shape[1] % TILE_Q == 0 \
            and window < xyz2.shape[1]:
        idx, d2 = knn_window(xyz1, xyz2, 3, window)
    else:
        idx, d2 = knn(xyz1, xyz2, 3)
    return d2, idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor,
                      inverse: NeighborInverse | None = None) -> torch.Tensor:
    """points [B, M, C], idx/weight [B, N, 3] -> [B, N, C]:
    out[n] = sum_j weight[n, j] * points[idx[n, j]].  `inverse`, the
    `NeighborInverse(idx, M)`, is what the backward reads."""
    return weighted_sum(points, idx, weight[..., None].contiguous(), inverse)


def inverse_distance_weights(dist: torch.Tensor,
                             eps: float = 1e-10) -> torch.Tensor:
    """w_j = (1/d_j) / sum_j (1/d_j), d clamped below at eps
    (`core/backbones.py:91-95`)."""
    inv = torch.reciprocal(torch.clamp_min(dist, eps))
    return inv / inv.sum(dim=-1, keepdim=True)
