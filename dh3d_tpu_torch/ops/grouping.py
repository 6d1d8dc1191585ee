"""Grouping ops (counterpart of `dh3d_tpu/ops/grouping.py`).

Only `group_point` is ported so far: the detection loss gathers its
candidate neighbourhoods with it.  The ball queries and `knn_point` are
still to come (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch.ops.neighborhood import gather_neighbors


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M, S] int64 -> [B, M, S, C]
    (`tf_grouping_g.cu:94-111`): a batched gather, differentiable in
    `points`."""
    return gather_neighbors(points, idx)
