"""On-device local-pair generation (counterpart of
`dh3d_tpu/data/pairgen.py:28-81`).

The host loader supplies two unrotated, augmented copies of each cloud;
the train step builds the rest of a self-pair batch on the device
(`core/datasets.py:126-151` builds it on the host):
  rotation   `core/datasets.py:134-140`  angle ~ U(-rot_maxv, rot_maxv)
  subset     `core/datasets.py:145`      N/2 points without replacement
  anchors    `core/datasets.py:146-147`  FPS over the subset (kernel B),
                                         seeded at its first entry
  positives  `core/datasets.py:148-150`  1-NN of each anchor in the
                                         UNROTATED pc2 (kernel A, k=1; the
                                         lowest index wins a tie)
The draws (`draw_local_pairs`) are kept apart from the function that
builds the pairs from them (`local_pairs`), so the same draws can be fed
to another device or to the JAX package's function.  `rotation_z` lives
in `data.augment`, beside the rotation it shares with `torch_rotate_z`.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import ops
from dh3d_tpu_torch.data.augment import matmul3, rotation_z


def draw_local_pairs(B: int, N: int, rot_maxv: float,
                     generator: torch.Generator):
    """The pair generation's draws, on the generator's device: angles [B]
    f32 ~ U(-rot_maxv, rot_maxv) and subsets [B, N // 2] int64, the head
    of a random permutation of each cloud's N points."""
    dev = generator.device
    angles = (torch.rand(B, generator=generator, device=dev) * 2 - 1) \
        * rot_maxv
    subsets = torch.stack([
        torch.randperm(N, generator=generator, device=dev)[: N // 2]
        for _ in range(B)])
    return angles, subsets


def local_pairs(pc1: torch.Tensor, pc2: torch.Tensor, sample_nodes: int,
                angles: torch.Tensor, subsets: torch.Tensor) -> dict:
    """The local-training batch fields from the draws.

    pc1, pc2 [B, N, 3] f32, both unrotated; angles [B]; subsets [B, S]
    int64 point ids of pc1 (S >= sample_nodes).  Returns the trainer's
    batch contract: points [2B, N, 3] (pc1 | pc2 rotated by R), sample_inds
    [2B, M] int64 (anchor ids | their 1-NN ids in pc2), R [B, 3, 3]."""
    rot = rotation_z(angles.to(pc1.dtype))
    sub_pts = ops.gather_point(pc1, subsets).contiguous()
    fps_idx = ops.farthest_point_sample(sub_pts, sample_nodes)  # [B, M]
    anc_inds = torch.gather(subsets, 1, fps_idx)
    anc_xyz = ops.gather_point(pc1, anc_inds).contiguous()
    pos_inds, _ = ops.knn_bruteforce_pairwise(anc_xyz, pc2.contiguous(), 1)
    return {
        "points": torch.cat([pc1, matmul3(pc2, rot)], dim=0),
        "sample_inds": torch.cat([anc_inds, pos_inds[..., 0]], dim=0),
        "R": rot,
    }


def device_local_pairs(pc1: torch.Tensor, pc2: torch.Tensor,
                       sample_nodes: int, rot_maxv: float,
                       generator: torch.Generator) -> dict:
    """`local_pairs` on draws from `generator` (on pc1's device): the
    counterpart of `dh3d_tpu.data.pairgen.device_local_pairs`."""
    B, N, _ = pc1.shape
    angles, subsets = draw_local_pairs(B, N, rot_maxv, generator)
    return local_pairs(pc1, pc2, sample_nodes, angles, subsets)
