"""Point-cloud IO and host-side normalisation (copy of the numpy/scipy paths
of `dh3d_tpu/data/io.py:16-168`).

Voxel downsampling and radius-outlier removal are the numpy / `cKDTree`
versions of open3d's, with the reference's parameters (`core/utils.py:165-177`:
voxel 0.2 m; outlier nb_points=4, r=1.0).  Where a CUDA device is present
the outlier removal counts the neighbours there instead, with kernel I
(`ops.radius_count`), which gives `cKDTree`'s counts bit for bit.  The JAX
package's optional C++ helper (`dh3d_tpu/native.py`) is not ported: its
voxel order differs from numpy's.
"""

from __future__ import annotations

import pickle
import threading

import numpy as np
import torch

from dh3d_tpu_torch import trace
from dh3d_tpu_torch.ops.radius import radius_count

_streams = threading.local()


def load_single_pcfile(filename, dim=3, dtype=np.float32):
    """Flat float32 .bin -> [N, 3] (`core/utils.py:145-148`); span
    `load.read`."""
    with trace.span("load.read"):
        pc = np.fromfile(filename, dtype=dtype)
    pc = np.reshape(pc, (pc.shape[0] // dim, dim))
    return pc[:, 0:3]


def load_descriptor_bin(filename, dim=131, dtype=np.float32):
    """[N, dim] descriptor rows (`core/utils.py:139-142`)."""
    desc = np.fromfile(filename, dtype=dtype)
    return np.reshape(desc, (-1, dim))


def write_to_bin(points, filename):
    with open(filename, "wb") as f:
        np.ascontiguousarray(points).tofile(f)


def get_sets_dict(filename):
    """Pickle GT dicts (`core/utils.py:46-50`)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def voxel_downsample(points, voxel_size=0.2):
    """Average points per voxel, voxels in dictionary order: open3d's
    `voxel_down_sample` (`core/utils.py:165-170`)."""
    points = np.asarray(points, np.float64)
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((counts.shape[0], points.shape[1]))
    np.add.at(sums, inverse.reshape(-1), points)
    return (sums / counts[:, None]).astype(np.float32)


def loader_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on `device`, made at first use: the
    loader's copies and kernels run there, so that waiting for them does
    not wait for the work other threads queue on the default stream (the
    train step's, while the prefetch thread loads)."""
    streams = vars(_streams).setdefault("by_device", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def radius_counts(points, radius):
    """For every point of `points` [M, 3], the points within `radius` of it,
    itself included: `cKDTree.query_ball_point(..., return_length=True)`.
    A float32 cloud, where a CUDA device is present, is counted there by
    kernel I on the thread's `loader_stream` of the current device, and
    only the counts come back; otherwise on the host by `cKDTree`.  Both
    give the same counts."""
    if points.dtype == np.float32 and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.stream(loader_stream(device)):
            pts = torch.from_numpy(np.ascontiguousarray(points)).to(device)
            return radius_count(pts, radius).cpu().numpy()
    from scipy.spatial import cKDTree

    return cKDTree(points).query_ball_point(points, r=radius,
                                            return_length=True)


def remove_radius_outlier(points, nb_points=4, radius=1.0):
    """Indices of points with >= nb_points neighbours (self excluded) within
    `radius`: open3d's `remove_radius_outlier` (`core/utils.py:173-177`),
    the neighbours counted by `radius_counts`."""
    return np.where(radius_counts(points, radius) - 1 >= nb_points)[0]


def get_fixednum_pcd(cloud, targetnum, randsample=True, need_downsample=False,
                     sortby_dis=True, rng=None):
    """Fixed-size cloud normalisation (`core/utils.py:87-110`): optional
    voxel downsample, outlier removal, then the `targetnum` points nearest
    the centroid in a random order (oversized), or padding by resampling or
    with 1e5 sentinel points (undersized).  Returns (cloud, ori_num).
    Spans: `load.voxel_grid`, `load.outlier_removal`, `load.select`."""
    rng = rng or np.random
    if need_downsample:
        with trace.span("load.voxel_grid"):
            cloud = voxel_downsample(cloud)
    with trace.span("load.outlier_removal"):
        cloud = cloud[remove_radius_outlier(cloud), :]
    with trace.span("load.select"):
        ori_num = cloud.shape[0]
        if cloud.shape[0] > targetnum:
            if sortby_dis:
                centroid = np.mean(cloud, axis=0)
                dis = np.sum(np.square(cloud - centroid), axis=1)
                order = np.argsort(dis)
                cloud = cloud[order[:targetnum], :3]
            choice = rng.choice(cloud.shape[0], targetnum, replace=False)
            cloud = cloud[choice, :]
            ori_num = targetnum
        else:
            pad = targetnum - cloud.shape[0]
            if randsample:
                extra = cloud[rng.choice(cloud.shape[0], size=pad,
                                         replace=True)]
            else:
                extra = np.ones([pad, 3], np.float32) * 100000
            cloud = np.concatenate((cloud, extra), axis=0)
        return cloud.astype(np.float32), ori_num


def center_crop(pc, rad=20, shift=(0, 0, 0)):
    """The points within `rad` of the shifted centroid
    (`core/utils.py:113-118`)."""
    centroid = np.mean(pc, axis=0) + np.asarray(shift)
    mask = np.sum(np.square(pc - centroid), axis=1) <= rad * rad
    return pc[mask, :]


class FarthestSampler:
    """Host numpy FPS from a random seed point (`core/utils.py:121-136`)."""

    def sample(self, pts, k, rng=None):
        rng = rng or np.random
        idx = np.empty(k, np.int64)
        idx[0] = rng.randint(len(pts))
        dist = np.sum((pts - pts[idx[0]]) ** 2, axis=1)
        for i in range(1, k):
            idx[i] = np.argmax(dist)
            dist = np.minimum(dist, np.sum((pts - pts[idx[i]]) ** 2, axis=1))
        return idx


def restore_scale_pcd(pcd, knn=3):
    """Rescale a cloud so that its mean k-NN spacing is 0.2 m, the DSO eval
    normalisation (`core/utils.py:156-162`)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(pcd, np.float32)
    d, _ = cKDTree(pts[:, :3]).query(pts[:, :3], k=knn)
    scale = 0.2 / np.mean(d)
    return pts * scale


def morton_sort_np(points, bits=10):
    """Sort each cloud along the Z-order curve on the host (copy of
    `dh3d_tpu/data/io.py:137-168`): per cloud, 10-bit quantisation of the
    box, interleaved codes, a stable argsort.

    points [N, 3] or [B, N, 3] -> sorted copy.  The training loader calls
    it under `cfg.morton_presorted` (in the prefetch thread), and the
    model then skips its own sort.  Rotations applied afterwards keep the
    pairwise distances, so the order stays a good one."""
    pts = np.asarray(points, np.float32)
    single = pts.ndim == 2
    if single:
        pts = pts[None]
    lo = pts.min(axis=1, keepdims=True)
    hi = pts.max(axis=1, keepdims=True)
    scale = (2 ** bits - 1) / np.maximum(hi - lo, 1e-9)
    q = np.clip((pts - lo) * scale, 0, 2 ** bits - 1).astype(np.uint32)

    def spread(x):
        x = x & np.uint32(0x3FF)
        x = (x | (x << 16)) & np.uint32(0x30000FF)
        x = (x | (x << 8)) & np.uint32(0x300F00F)
        x = (x | (x << 4)) & np.uint32(0x30C30C3)
        x = (x | (x << 2)) & np.uint32(0x9249249)
        return x

    code = (spread(q[..., 0]) | (spread(q[..., 1]) << np.uint32(1))
            | (spread(q[..., 2]) << np.uint32(2)))
    perm = np.argsort(code, axis=1, kind="stable")
    out = np.take_along_axis(pts, perm[..., None], axis=1)
    return out[0] if single else out
