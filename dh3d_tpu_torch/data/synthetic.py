"""Seeded synthetic lidar-like scans for driving the extraction path without
the Oxford data: a dense ground plane plus box "buildings" (their walls and
roofs) with jitter, and a few isolated points in the air.

The densities are chosen so that the eval normalisation
(`data.io.get_fixednum_pcd`: voxel 0.2 m, then radius-outlier removal at
4 neighbours within 1 m) keeps about 90% of the surface points and drops
the isolated ones: ~6 surface points per m^2 give each surface point ~20
neighbours within 1 m.  (Clouds of `randn * 30` points would be emptied by
the outlier removal and padded with 1e5 sentinels.)
"""

from __future__ import annotations

import numpy as np


def lidar_like_scan(seed: int, n_points: int = 30000,
                    extent: float = 30.0) -> np.ndarray:
    """[n_points, 3] float32: 2/3 of the points on the ground plane
    [-extent, extent]^2, the rest on 6 boxes' walls and roofs, 0.5% in the
    air.  Coordinates in metres; the scale of `extent` keeps ~6 points a
    square metre at the defaults."""
    rng = np.random.RandomState(seed)
    n_air = n_points // 200
    n_ground = (n_points - n_air) * 2 // 3
    n_box = n_points - n_air - n_ground
    ground = np.stack([rng.uniform(-extent, extent, n_ground),
                       rng.uniform(-extent, extent, n_ground),
                       rng.randn(n_ground) * 0.03], axis=1)

    boxes = []
    sizes = rng.uniform([4, 4, 3], [10, 10, 12], (6, 3))  # w, d, h
    centres = rng.uniform(-0.7 * extent, 0.7 * extent, (6, 2))
    areas = 2 * (sizes[:, 0] + sizes[:, 1]) * sizes[:, 2] + \
        sizes[:, 0] * sizes[:, 1]
    counts = rng.multinomial(n_box, areas / areas.sum())
    for (w, d, h), (cx, cy), n in zip(sizes, centres, counts):
        # a point on the walls (unrolled perimeter) or on the roof
        roof = rng.rand(n) < w * d / (2 * (w + d) * h + w * d)
        t = rng.uniform(0, 2 * (w + d), n)
        x = np.where(t < w, t, np.where(t < w + d, w,
                                        np.where(t < 2 * w + d,
                                                 2 * w + d - t, 0.0)))
        y = np.where(t < w, 0.0, np.where(t < w + d, t - w,
                                          np.where(t < 2 * w + d, d,
                                                   2 * (w + d) - t)))
        z = rng.uniform(0, h, n)
        x = np.where(roof, rng.uniform(0, w, n), x)
        y = np.where(roof, rng.uniform(0, d, n), y)
        z = np.where(roof, h, z)
        boxes.append(np.stack([x + cx - w / 2, y + cy - d / 2, z], axis=1))

    air = rng.uniform([-extent, -extent, 15], [extent, extent, 40],
                      (n_air, 3))
    cloud = np.concatenate([ground, *boxes, air])
    cloud += rng.randn(*cloud.shape) * 0.02  # sensor jitter
    return cloud[rng.permutation(len(cloud))].astype(np.float32)



def radius_boundary_cloud(seed: int = 0, radius: float = 1.0,
                          pairs: int = 60) -> np.ndarray:
    """[2 * (3 + pairs), 3] float32: pairs of points at the boundary of the
    radius count (`ops.radius_count`, the loader's outlier removal), each
    pair about its own origin 5 radii from the next, so that every count is
    1 or 2.

    First three pairs along x: exactly `radius` apart, one float32 step
    beyond it and one short of it.  Then `pairs` pairs at `radius` in
    random directions, rounded to float32; the first half are drawn among
    those whose squared distance in float32 arithmetic falls on the other
    side of radius**2 than in float64 (where the count decides it), the
    rest among those where both agree."""
    rng = np.random.RandomState(seed)
    r = np.float32(radius)
    k = np.arange(3 + pairs)
    grid = (5 * radius * np.stack([k % 8, (k // 8) % 8, k // 64], axis=1)
            ).astype(np.float32)
    first, second = grid.copy(), grid.copy()
    second[:3, 0] += r
    second[1, 0] = np.nextafter(second[1, 0], np.float32(np.inf))
    second[2, 0] = np.nextafter(second[2, 0], np.float32(-np.inf))

    tries = 500
    p = (grid[3:, None] + rng.uniform(-radius / 2, radius / 2,
                                      (pairs, tries, 3))).astype(np.float32)
    u = rng.randn(pairs, tries, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q = (p.astype(np.float64) + radius * u).astype(np.float32)
    d = q.astype(np.float64) - p.astype(np.float64)
    d64 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    e = q - p
    d32 = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]
    split = (d32 <= r * r) != (d64 <= float(radius) ** 2)
    want = np.arange(pairs)[:, None] < pairs // 2
    hit = split == want
    if not hit.any(axis=1).all():
        raise ValueError(f"no boundary pair of the kind wanted in {tries} "
                         f"draws")
    pick = np.argmax(hit, axis=1)
    first[3:] = p[np.arange(pairs), pick]
    second[3:] = q[np.arange(pairs), pick]
    return np.concatenate([first, second])
