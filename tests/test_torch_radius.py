"""The radius count (`ops.radius_count`, kernel I's plain version on CPU
tensors) against scipy's `cKDTree`, and the loader's outlier removal
(`data.io.remove_radius_outlier`, `get_fixednum_pcd`) on its CPU path.

The count is the one `cKDTree.query_ball_point(..., return_length=True)`
gives: equal, point for point, on voxelised lidar-like scans, on pairs at
the radius's rounding boundary (exactly at it, a float32 step either side,
and where float32 and float64 squared distances disagree), on duplicated
points, and at sizes around kernel I's block and tile (M = 1, below a
tile, not a multiple of either).  The same cases run on the card in
`tests/test_torch_cuda.py`.  Kernel I's launches are recorded here, not
made.
"""

import ctypes

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.data import io
from dh3d_tpu_torch.data.synthetic import (lidar_like_scan,
                                           radius_boundary_cloud)
from dh3d_tpu_torch.ops import radius as radius_ops


def radius_case(name):
    """(cloud [M, 3] float32, radius) of a named case."""
    rng = np.random.RandomState(7)
    if name == "lidar_voxel":
        return io.voxel_downsample(lidar_like_scan(1, 6000, 12.0)), 1.0
    if name == "lidar_voxel_dense":
        return io.voxel_downsample(lidar_like_scan(2, 9000, 9.0)), 1.0
    if name == "boundary":
        return radius_boundary_cloud(0), 1.0
    if name == "boundary_r0.375":  # another radius float32 holds exactly
        return radius_boundary_cloud(1, radius=0.375), 0.375
    if name == "duplicates":
        base = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
        return base[rng.randint(0, 300, 1500)], 1.0
    if name == "m1":
        return np.array([[0.5, -2.0, 3.25]], np.float32), 1.0
    if name == "below_tile":
        return rng.uniform(-4, 4, (700, 3)).astype(np.float32), 1.0
    if name == "ragged":  # neither a multiple of a block nor of a tile
        return rng.uniform(-6, 6, (2500, 3)).astype(np.float32), 1.0
    raise KeyError(name)


RADIUS_CASES = ("lidar_voxel", "lidar_voxel_dense", "boundary",
                "boundary_r0.375", "duplicates", "m1", "below_tile", "ragged")


@pytest.mark.parametrize("case", RADIUS_CASES)
def test_radius_count_plain_matches_ckdtree(case):
    cloud, radius = radius_case(case)
    want = cKDTree(cloud).query_ball_point(cloud, r=radius,
                                           return_length=True)
    got = T.radius_count(torch.from_numpy(cloud), radius)
    assert got.dtype == torch.int32 and got.shape == (len(cloud),)
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("boundary"):  # both sides of the boundary occur
        assert got[0] == 2 and got[1] == 1 and got[2] == 2
        assert set(np.unique(got.numpy())) == {1, 2}


def test_boundary_cloud_splits_float32_from_float64():
    """Half its random pairs are decided otherwise in float32 arithmetic:
    a count in float32 would get them wrong."""
    cloud = radius_boundary_cloud(0)
    n = len(cloud) // 2
    a, b = cloud[3:n], cloud[n + 3:]
    e = b - a
    d32 = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    d = b.astype(np.float64) - a.astype(np.float64)
    d64 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    split = (d32 <= np.float32(1)) != (d64 <= 1.0)
    assert split[:len(split) // 2].all() and not split[len(split) // 2:].any()


@pytest.mark.parametrize("m,sms,plan", [(1, 132, 1), (700, 132, 1),
                                        (16384, 132, 16), (27800, 132, 20),
                                        (27800, 8, 2), (200000, 132, 3)])
def test_radius_plan(m, sms, plan):
    """About RADIUS_BLOCKS_PER_SM blocks an SM, at least a tile of keys a
    block."""
    assert T.radius_plan(m, sms) == plan


@pytest.fixture
def launches(monkeypatch):
    """`radius_count` with its CPU tensors taken for CUDA ones and kernel
    I's launches recorded, not made: [(M, radius, plan)]."""
    made = []

    def launch(device, *args):
        kinds = kernels.RADIUS_COUNT.argtypes[:-1]
        assert len(args) == len(kinds)
        made.append(tuple(a for t, a in zip(kinds, args)
                          if t is not ctypes.c_void_p))

    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "sm_count", lambda index: 132)
    monkeypatch.setattr(kernels.RADIUS_COUNT, "launch", launch)
    return made


def test_radius_count_launches_once_with_the_plan(launches):
    """One launch a cloud, on a zeroed output, with `radius_plan`'s split or
    the plan given; an empty cloud launches nothing."""
    pts = torch.zeros(27800, 3)
    out = T.radius_count(pts, 1.0)
    assert out.dtype == torch.int32 and not out.any()
    T.radius_count(pts, 0.5, plan=3)
    assert T.radius_count(torch.zeros(0, 3), 1.0).shape == (0,)
    assert launches == [(27800, 1.0, 20), (27800, 0.5, 3)]


def test_radius_count_refuses_bad_input(launches):
    with pytest.raises(ValueError, match="dtype"):
        T.radius_count(torch.zeros(10, 3, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="shape"):
        T.radius_count(torch.zeros(1, 10, 3), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        T.radius_count(torch.zeros(3, 10).t(), 1.0)
    for r in (-1.0, float("nan")):
        with pytest.raises(ValueError, match="radius"):
            T.radius_count(torch.zeros(10, 3), r)
    assert launches == []


def test_plain_version_chunks_rows():
    """The plain version's row chunks give the counts of one chunk."""
    cloud, radius = radius_case("ragged")
    want = T.radius_count(torch.from_numpy(cloud), radius)
    old = radius_ops.PLAIN_CHUNK_PAIRS
    try:
        radius_ops.PLAIN_CHUNK_PAIRS = 7 * len(cloud)  # 7 rows a chunk
        got = T.radius_count(torch.from_numpy(cloud), radius)
    finally:
        radius_ops.PLAIN_CHUNK_PAIRS = old
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["lidar_voxel", "boundary", "duplicates"])
def test_remove_radius_outlier_cpu_path_as_before(case):
    """On a host without CUDA the loader counts with `cKDTree`, as before;
    the indices are those of the count's plain version too."""
    cloud, radius = radius_case(case)
    counts = cKDTree(cloud).query_ball_point(cloud, r=radius,
                                             return_length=True)
    for nb in (1, 4):
        want = np.where(counts - 1 >= nb)[0]
        np.testing.assert_array_equal(
            io.remove_radius_outlier(cloud, nb, radius), want)
        plain = T.radius_count(torch.from_numpy(cloud), radius).numpy()
        np.testing.assert_array_equal(np.where(plain - 1 >= nb)[0], want)


@pytest.mark.parametrize("randsample,need_downsample,sortby_dis",
                         [(False, True, True), (True, False, False),
                          (True, True, True)])
def test_get_fixednum_pcd_same_with_either_count(monkeypatch, randsample,
                                                 need_downsample, sortby_dis):
    """`get_fixednum_pcd` gives the same cloud, count of real points and
    random draws whether its neighbours are counted by `cKDTree` (the CPU
    path) or by the count kernel I computes (its plain version)."""
    cloud = lidar_like_scan(3, 6000, 12.0)
    target = 2048 if need_downsample else 8192

    def run():
        rng = np.random.RandomState(11)
        out, n = io.get_fixednum_pcd(cloud, target, randsample=randsample,
                                     need_downsample=need_downsample,
                                     sortby_dis=sortby_dis, rng=rng)
        return out, n, rng.randint(1 << 30)

    want = run()
    monkeypatch.setattr(io, "radius_counts", lambda pts, r: T.radius_count(
        torch.from_numpy(np.ascontiguousarray(pts)), r).numpy())
    got = run()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
