"""Grouping ops (counterpart of `dh3d_tpu/ops/grouping.py`; semantics of
`tf_ops/grouping/tf_grouping_g.cu`).

`group_point` is a batched gather (the detection loss gathers its
candidate neighbourhoods with it); `knn_point` is `knn` (kernels A and G on
CUDA).  The ball queries and `select_top_k` are plain PyTorch: the JAX
package has no Pallas kernel for them.  "The first nsample points inside
the ball, in index order" is a stable sort of the inside flags, which puts
the inside points first in their index order.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch.ops.knn import knn
from dh3d_tpu_torch.ops.neighborhood import gather_neighbors


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M, S] int64 -> [B, M, S, C]
    (`tf_grouping_g.cu:94-111`): a batched gather, differentiable in
    `points`."""
    return gather_neighbors(points, idx)


def _distances(xyz2, xyz1):
    """d[b, m, n] = |xyz2[m] - xyz1[n]|, clamped below at 1e-20 as the
    CUDA kernels clamp it (`tf_grouping_g.cu:26`); d2 built as `knn`
    builds it."""
    d = xyz2[:, :, None, :] - xyz1[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return torch.clamp_min(torch.sqrt(d2), 1e-20)


def _first_inside(inside, nsample, fallback):
    """The first `nsample` True entries of each row of inside [B, M, N], in
    index order -> (idx [B, M, nsample] int64, cnt [B, M] int64, the
    entries taken).  The rules of `tf_grouping_g.cu:29-48`: the slots past
    cnt hold the first hit; a row with none holds fallback [B, M] in
    every slot; cnt stops at nsample (the JAX function counts every True
    entry)."""
    N = inside.shape[-1]
    order = torch.sort((~inside).to(torch.uint8), dim=-1, stable=True)[1]
    first = order[..., :nsample]
    cnt = torch.clamp_max(inside.sum(dim=-1), nsample)
    if nsample > N:  # more slots than points: pad with the first hit
        first = torch.cat([first, first[..., :1].expand(
            *first.shape[:-1], nsample - N)], dim=-1)
    slot = torch.arange(nsample, device=inside.device)
    out = torch.where(slot < cnt[..., None], first, first[..., :1])
    return torch.where(cnt[..., None] == 0, fallback[..., None], out), cnt


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor,
                     xyz2: torch.Tensor):
    """The first `nsample` points of xyz1 [B, N, 3] within `radius` of
    each query of xyz2 [B, M, 3], in index order (`tf_grouping_g.cu:3-52`)
    -> (idx [B, M, nsample] int64, pts_cnt [B, M] int64).  A query with no
    point inside takes its nearest point (the first on a tie) in every
    slot."""
    d = _distances(xyz2, xyz1)
    return _first_inside(d < radius, nsample, torch.argmin(d, dim=-1))


def query_ball_point2(nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                      radii: torch.Tensor):
    """`query_ball_point` with a radius a query, radii [B, M]
    (`tf_grouping_g.cu:56-90`); a query with no point inside gets 0 in
    every slot (the CUDA kernel leaves those slots unwritten; the JAX
    function writes 0)."""
    d = _distances(xyz2, xyz1)
    zeros = torch.zeros(d.shape[:2], dtype=torch.int64, device=d.device)
    return _first_inside(d < radii[..., None], nsample, zeros)


def select_top_k(k: int, dist: torch.Tensor):
    """The k smallest entries of each row of dist [B, M, N], ascending, the
    lowest index first among equal values (`tf_grouping_g.cu:137-177`,
    `lax.top_k`'s order) -> (dists [B, M, k], idx [B, M, k] int64)."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_point(k: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The k nearest points of xyz1 [B, N, 3] for each query of xyz2
    [B, M, 3] by squared distance (`tf_grouping.py:78-88`) -> (d2
    [B, M, k], idx [B, M, k] int64), ascending, the lowest index first
    among equal distances: `knn` (kernels A and G on CUDA, k <= 128
    there).  The JAX function builds d2 with the matmul identity; the ids
    agree but where two distances are within its rounding."""
    idx, d2 = knn(xyz2, xyz1, k)
    return d2, idx
