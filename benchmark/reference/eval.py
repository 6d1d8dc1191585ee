"""Evaluation steps, plain: keypoint NMS, retrieval, mutual matching,
RANSAC, and the eval loader's fixed-size normalisation.

NMS (reference `core/utils.py:15-43`): the 50 nearest neighbours of every
point; a point whose 8th neighbour lies farther than 2 m gets attention 0
(noise); a point is a keypoint when no neighbour within the radius has
more attention (the first of equal maxima wins, itself at slot 0) and its
attention exceeds min_ratio times the largest; keypoints by descending
attention, ties by descending index, at most max_kp.

Registration (`eval_align.m`): mutual nearest neighbours of descriptors by
Euclidean distance (the first index wins a tie); RANSAC over the matches
with the hypotheses `np.random.RandomState(seed).choice(M, 3,
replace=False)` draws one an iteration, each a Kabsch fit in float64
(R = V diag(1, 1, sign det(V U^T)) U^T, t = ca - R cb) mapping the second
set onto the first; the first hypothesis with the most inliers (residual
under the threshold) wins, then a refit on its inliers.

Normalisation (reference `core/utils.py:87-110,165-177`): a 0.2 m voxel
grid averaged per voxel in dictionary order, radius outlier removal (at
least 4 neighbours within 1 m), then the targetnum points nearest the
centroid in a random order (`rng.choice(n, targetnum, replace=False)`), or
padding with 1e5 points when too few are left.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.geometry import knn

NMS_K = 50


def nms(xyz: torch.Tensor, att: torch.Tensor, radius: float,
        min_ratio: float, max_kp: int) -> list:
    """xyz [N, 3], att [N] -> keypoint indices (list of int)."""
    n = xyz.shape[0]
    k = min(NMS_K, n)
    idx, d2 = knn(xyz[None], xyz[None], k)
    idx, dist = idx[0], torch.sqrt(d2[0])
    att = torch.where(dist[:, min(7, k - 1)] > 2.0, torch.zeros_like(att),
                      att)
    nb = torch.where(dist > radius, torch.zeros_like(dist), att[idx])
    is_max = torch.argmax(nb, dim=1) == 0
    keep = is_max & (att > torch.max(att) * min_ratio)
    a = att.cpu().numpy()
    cand = sorted(((a[m], m) for m in np.nonzero(keep.cpu().numpy())[0]),
                  reverse=True)
    return [int(m) for _, m in cand[:max_kp]]


def retrieve_top1(db: np.ndarray, q: np.ndarray, dtype=np.float64) -> int:
    """The index of the database descriptor nearest q (the lowest on a
    tie)."""
    d = np.linalg.norm(db.astype(dtype) - q.astype(dtype), axis=1)
    return int(np.argmin(d))


def mutual_matches(d1: np.ndarray, d2: np.ndarray,
                   dtype=np.float64) -> np.ndarray:
    """[M, 2] index pairs (i into d1, j into d2), in d1 order."""
    a, b = d1.astype(dtype), d2.astype(dtype)
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    nn12, nn21 = d.argmin(1), d.argmin(0)
    i = np.arange(len(a))
    mutual = nn21[nn12] == i
    return np.stack([i[mutual], nn12[mutual]], axis=1)


def kabsch(A: np.ndarray, B: np.ndarray):
    """A, B [n, m, 3] -> R [n, 3, 3], t [n, 3] mapping B onto A."""
    ca, cb = A.mean(1), B.mean(1)
    H = np.swapaxes(B - cb[:, None], 1, 2) @ (A - ca[:, None])
    U, _, Vt = np.linalg.svd(H)
    V = np.swapaxes(Vt, 1, 2)
    d = np.sign(np.linalg.det(V @ np.swapaxes(U, 1, 2)))
    D = np.zeros_like(H)
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = d
    R = V @ D @ np.swapaxes(U, 1, 2)
    t = ca - (R @ cb[..., None])[..., 0]
    return R, t


def ransac(p1: np.ndarray, p2: np.ndarray, thresh: float, iters: int,
           seed: int, min_inliers: int = 3, dtype=np.float64):
    """(R, t) mapping p2 [M, 3] onto p1, or None."""
    M = len(p1)
    if M < 3:
        return None
    rng = np.random.RandomState(seed)
    sel = np.stack([rng.choice(M, 3, replace=False) for _ in range(iters)])
    p1, p2 = p1.astype(dtype), p2.astype(dtype)
    R, t = kabsch(p1[sel], p2[sel])

    def inliers(R, t):
        pred = p2[None] @ np.swapaxes(R, 1, 2) + t[:, None, :]
        return np.linalg.norm(pred - p1[None], axis=2) < thresh

    ins = inliers(R, t)
    ok = np.isfinite(R).all((1, 2)) & np.isfinite(t).all(1)
    counts = np.where(ok, ins.sum(1), -1)
    best = int(np.argmax(counts))
    if counts[best] < max(0, min_inliers):
        return None
    keep = ins[best]
    R, t = kabsch(p1[keep][None], p2[keep][None])
    return R[0], t[0]


def voxel_downsample(points, voxel=0.2, acc=np.float64):
    """Per-voxel means, summed in `acc` (float64, as open3d)."""
    points = np.asarray(points, np.float64)
    keys = np.floor(points / voxel).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((counts.shape[0], 3), acc)
    np.add.at(sums, inverse.reshape(-1), points.astype(acc))
    return (sums / counts[:, None].astype(acc)).astype(np.float32)


def inlier_rows(points, nb_points=4, radius=1.0):
    from scipy.spatial import cKDTree

    counts = cKDTree(points).query_ball_point(points, r=radius,
                                              return_length=True)
    return np.where(counts - 1 >= nb_points)[0]


def normalise(cloud, targetnum, rng, acc=np.float64):
    """(cloud [targetnum, 3] f32, the count of real points)."""
    cloud = voxel_downsample(cloud, acc=acc)
    cloud = cloud[inlier_rows(cloud)]
    n = len(cloud)
    if n > targetnum:
        centroid = np.mean(cloud, axis=0)
        order = np.argsort(np.sum(np.square(cloud - centroid), axis=1))
        cloud = cloud[order[:targetnum]]
        cloud = cloud[rng.choice(targetnum, targetnum, replace=False)]
        n = targetnum
    else:
        pad = np.ones([targetnum - n, 3], np.float32) * 100000
        cloud = np.concatenate([cloud, pad])
    return cloud.astype(np.float32), n
