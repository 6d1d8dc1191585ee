"""Radius count: the radius-outlier removal's neighbour count, kernel I
(`csrc/radius.cu`) and its plain version.

No counterpart in `dh3d_tpu/ops/`: the JAX package, as the reference,
counts these neighbours on the host with scipy's `cKDTree`
(`dh3d_tpu/data/io.py:58-70`); the port's loader takes this op on a
CUDA device (`data.io.remove_radius_outlier`).  Both versions decide each
pair as `cKDTree.query_ball_point` does: dx, dy and dz in float64 from the
float32 coordinates, d2 = (dx*dx + dy*dy) + dz*dz with every operation
rounded on its own, counted when d2 <= radius * radius (in float64), so
they agree with it and with each other bit for bit.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import kernels

RADIUS_THREADS = 256  # queries a block (csrc/radius.cu's kThreads)
RADIUS_TILE = 1024  # keys a shared-memory tile (its kTile)
RADIUS_BLOCKS_PER_SM = 16  # blocks the key split aims at, over the SMs
PLAIN_CHUNK_PAIRS = 1 << 22  # pairs a step of the plain version holds


def radius_count_plain(points: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain PyTorch radius count: float64 broadcasting over row chunks.
    points [M, 3] float32 -> [M] int32."""
    p = points.double()
    m = p.shape[0]
    r2 = float(radius) * float(radius)
    out = torch.empty(m, dtype=torch.int32, device=points.device)
    step = max(1, PLAIN_CHUNK_PAIRS // max(m, 1))
    for s in range(0, m, step):
        q = p[s:s + step, None, :]
        dx = q[..., 0] - p[None, :, 0]
        dy = q[..., 1] - p[None, :, 1]
        dz = q[..., 2] - p[None, :, 2]
        d2 = dx * dx + dy * dy
        d2 = d2 + dz * dz
        out[s:s + step] = (d2 <= r2).sum(1, dtype=torch.int32)
    return out


def radius_plan(m: int, sm_count: int) -> int:
    """Kernel I's plan: the blocks a query block's keys are split over, so
    that about RADIUS_BLOCKS_PER_SM blocks an SM run (two waves of 8), each
    with at least one tile of keys.  On an H100 at the raw scan's M ~
    27,700, 6 to 24 splits took 0.48-0.52 ms and 1 to 5 0.59-0.79
    (PERF.md §6)."""
    query_blocks = -(-m // RADIUS_THREADS)
    want = -(-RADIUS_BLOCKS_PER_SM * sm_count // query_blocks)
    return max(1, min(want, -(-m // RADIUS_TILE)))


def radius_count(points: torch.Tensor, radius: float,
                 plan=None) -> torch.Tensor:
    """For every point, the points within `radius` of it, itself included.

    points [M, 3] float32, contiguous; radius >= 0.  Returns [M] int32.
    CPU tensors take the plain version; CUDA tensors launch kernel I with
    `plan` (the key split) or `radius_plan`'s, on the current stream."""
    kernels.check(points, "points", torch.float32, (None, 3))
    radius = float(radius)
    if not radius >= 0:
        raise ValueError(f"radius={radius}: must be >= 0")
    if not kernels.on_cuda(points):
        return radius_count_plain(points, radius)
    m = points.shape[0]
    dev = points.device
    counts = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0:
        return counts
    if plan is None:
        plan = radius_plan(m, kernels.sm_count(dev.index or 0))
    kernels.RADIUS_COUNT.launch(dev, points.data_ptr(), counts.data_ptr(),
                                m, radius, plan)
    return counts
