"""Farthest point sampling: kernel B (`csrc/fps.cu`) and its plain version,
plus the gathers around it.

Counterpart of `dh3d_tpu/ops/sampling.py:22-100` and of the Pallas kernel
`fps_pallas._fps_kernel`.  Semantics of the reference CUDA kernel
(`tf_ops/sampling/tf_sampling_g.cu:105-170`): seeded at index 0, each next
sample is the point with the largest distance to the chosen set, the
first (lowest) index on ties.  Both versions build the squared distance as
(dx*dx + dy*dy) + dz*dz with each operation rounded on its own, so they
agree bit for bit.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import kernels


def fps_plain(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS: one [B, N] distance update and argmax a sample.
    points [B, N, 3] -> [B, npoint] int64."""
    B, N, _ = points.shape
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    mind = torch.full((B, N), float("inf"), dtype=points.dtype,
                      device=points.device)
    out = torch.zeros(B, npoint, dtype=torch.int64, device=points.device)
    last = torch.zeros(B, 1, dtype=torch.int64, device=points.device)
    for j in range(1, npoint):
        dx = px - torch.gather(px, 1, last)
        dy = py - torch.gather(py, 1, last)
        dz = pz - torch.gather(pz, 1, last)
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mind, dim=1, keepdim=True)  # first occurrence
        out[:, j] = last[:, 0]
    return out


# Kernel B's launch plan (`csrc/fps.cu`): C blocks (a thread-block
# cluster when C > 1) of T threads a cloud.
FPS_MAX_CLUSTER = 8  # the portable cluster size
FPS_GPC_SMS = 16  # SMs a cluster can take in one GPC (132 = 8 GPCs of ~16)
FPS_CLUSTER_THREADS = 128  # T in a cluster: C * T / 32 <= 32 slots
FPS_BLOCK_THREADS = 256  # T for one block a cloud
FPS_REGISTER_POINTS = 32  # points a thread of 128 or 256 keeps in registers


def fps_plan(B: int, N: int, sm_count: int) -> tuple:
    """Kernel B's plan (C, T) for B clouds of N points.

    C: the most blocks a cloud, 8, 4 or 2, for which all B clusters run at
    once (a cluster takes C SMs of one GPC: FPS_GPC_SMS // C clusters a
    GPC, sm_count // FPS_GPC_SMS GPCs), else 1; then doubled (to at most 8)
    while the cloud does not fit the registers of C blocks.  T: 128 threads
    in a cluster, 256 for one block.  The sweep of every (C, T) at the
    path's shapes on an H100 (`chip_smoke.py --sweep`; PERF.md §6) chose
    these."""
    gpcs = max(1, sm_count // FPS_GPC_SMS)
    c = next((c for c in (8, 4, 2) if B <= gpcs * (FPS_GPC_SMS // c)), 1)
    t = FPS_CLUSTER_THREADS if c > 1 else FPS_BLOCK_THREADS
    while c < FPS_MAX_CLUSTER and N > c * t * FPS_REGISTER_POINTS:
        c, t = 2 * c, FPS_CLUSTER_THREADS
    return c, t


def farthest_point_sample(points: torch.Tensor, npoint: int,
                          plan=None) -> torch.Tensor:
    """Iterative farthest point sampling seeded at index 0.

    points [B, N, 3] float32, contiguous; 1 <= npoint <= N.  Returns
    [B, npoint] int64.  CPU tensors take the plain version; CUDA tensors
    launch kernel B with `plan` (C, T) or `fps_plan`'s.  It holds a cloud
    in the registers and shared memory of C <= 8 blocks; its entry point
    refuses, and this raises ValueError for, an N beyond that
    (`kernels.fps_max_points`, ~147,000 with 8 blocks of 128 threads on an
    H100) or a plan it does not take."""
    kernels.check(points, "points", torch.float32, (None, None, 3))
    B, N, _ = points.shape
    if not 1 <= npoint <= N:
        raise ValueError(f"npoint={npoint} outside [1, N={N}]")
    if not kernels.on_cuda(points):
        return fps_plain(points, npoint)
    dev = points.device
    c, t = plan if plan is not None else fps_plan(
        B, N, kernels.sm_count(dev.index or 0))
    out = torch.empty(B, npoint, dtype=torch.int64, device=dev)
    kernels.FPS.launch(dev, points.data_ptr(), out.data_ptr(), B, N, npoint,
                       c, t)
    return out


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M] int64 -> [B, M, C]
    (`tf_sampling_g.cu:172-180`)."""
    return torch.gather(
        points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def prob_sample(inp: torch.Tensor, inp_r: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical sampling (`tf_sampling_g.cu:7-104`,
    `dh3d_tpu/ops/sampling.py:70-78`): inp [B, N] an unnormalised
    distribution, inp_r [B, M] uniforms in [0, sum) -> [B, M] int64, the
    first index whose running sum reaches each uniform (a left
    `searchsorted` of the cumulative sum), clipped to [0, N - 1]."""
    cdf = torch.cumsum(inp, dim=-1)
    idx = torch.searchsorted(cdf, inp_r.contiguous(), side="left")
    return torch.clamp(idx, 0, inp.shape[-1] - 1)


def subsample(points, feat, targetnum, kp_idx=None, sorted_order=False):
    """FPS (or the given indices) and the gather of xyz and features
    (`core/tf_utils.py:86-96`).  `sorted_order=True` returns the FPS
    selection in ascending index order, which keeps the parent's Morton
    order; the selected set is the same.  Returns (xyz [B, M, 3],
    feat [B, M, C], kp_idx [B, M] int64)."""
    if kp_idx is None:
        kp_idx = farthest_point_sample(points, targetnum)
        if sorted_order:
            kp_idx = torch.sort(kp_idx, dim=-1).values
    else:
        kp_idx = kp_idx.reshape(kp_idx.shape[0], -1)
    return gather_point(points, kp_idx), gather_point(feat, kp_idx), kp_idx
