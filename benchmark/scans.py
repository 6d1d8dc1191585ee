"""Seeded lidar-like scans, made on the device.

A translation to batched torch of `lidar_like_scan` in
`dh3d_tpu_torch/data/synthetic.py` (the same scene and the same
distributions, other random numbers): a ground plane of 2/3 of the points,
6 box "buildings" (walls and roofs) with the rest, 0.5% of the points in
the air, 2 cm sensor jitter, in metres.  At 30,000 points over a 60 m
square, ~6 points a square metre give each surface point ~20 neighbours
within 1 m, so the eval loader's outlier removal keeps ~90% of them and
drops the points in the air.
"""

from __future__ import annotations

import torch


def scans(count: int, n_points: int, gen: torch.Generator,
          extent: float = 30.0) -> torch.Tensor:
    """`count` scans of distinct scenes, [count, n_points, 3] f32 on the
    generator's device, each in a random order."""
    dev = gen.device

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    lo = torch.tensor([4.0, 4.0, 3.0], device=dev)
    hi = torch.tensor([10.0, 10.0, 12.0], device=dev)
    sizes = lo + (hi - lo) * u(count, 6, 3)  # 6 boxes: w, d, h
    centres = (u(count, 6, 2) * 2 - 1) * (0.7 * extent)
    P = count
    n_air = n_points // 200
    n_ground = (n_points - n_air) * 2 // 3
    n_box = n_points - n_air - n_ground
    ground = torch.stack([
        (u(P, n_ground) * 2 - 1) * extent, (u(P, n_ground) * 2 - 1) * extent,
        torch.randn(P, n_ground, generator=gen, device=dev) * 0.03], dim=-1)

    w, d, h = sizes.unbind(-1)  # [P, 6]
    areas = 2 * (w + d) * h + w * d
    box = torch.multinomial(areas, n_box, replacement=True, generator=gen)
    w, d, h = (torch.gather(v, 1, box) for v in (w, d, h))
    cx, cy = (torch.gather(centres[..., i], 1, box) for i in range(2))
    roof = u(P, n_box) < w * d / (2 * (w + d) * h + w * d)
    t = u(P, n_box) * 2 * (w + d)
    zero = torch.zeros_like(t)
    x = torch.where(t < w, t, torch.where(
        t < w + d, w, torch.where(t < 2 * w + d, 2 * w + d - t, zero)))
    y = torch.where(t < w, zero, torch.where(
        t < w + d, t - w, torch.where(t < 2 * w + d, d, 2 * (w + d) - t)))
    z = u(P, n_box) * h
    x = torch.where(roof, u(P, n_box) * w, x)
    y = torch.where(roof, u(P, n_box) * d, y)
    z = torch.where(roof, h, z)
    boxes = torch.stack([x + cx - w / 2, y + cy - d / 2, z], dim=-1)

    air = torch.stack([(u(P, n_air) * 2 - 1) * extent,
                       (u(P, n_air) * 2 - 1) * extent,
                       15 + 25 * u(P, n_air)], dim=-1)
    cloud = torch.cat([ground, boxes, air], dim=1)
    cloud = cloud + torch.randn(cloud.shape, generator=gen, device=dev) * 0.02
    order = torch.argsort(u(P, n_points), dim=1)
    return torch.gather(cloud, 1, order[..., None].expand(-1, -1, 3))
