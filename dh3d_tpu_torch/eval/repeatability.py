"""Keypoint relative repeatability (counterpart of
`dh3d_tpu/eval/repeatability.py`), the metric behind BASELINE.md rows 1-5
and the paper's Fig. 4.

Detect the top-K keypoints in two overlapping clouds of known relative
pose; a keypoint of cloud 1 is repeatable if, warped into cloud 2's frame,
some cloud-2 keypoint lies within `radius`.  Relative repeatability is the
repeatable fraction of K.

The keypoints come from the NMS rules of `device_nms` (kernel G for the
50-NN on the card), the distances are float64 tensors on the device.  The
JAX package runs the host NMS (`single_nms`, float64 attention) and the
distances in numpy: both NMS apply the same rules to the same float32
values, so they agree but where a distance lies within its rounding of
the radius or an attention within its rounding of the response threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from dh3d_tpu_torch.eval.nms import device_nms


def _device_of(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if torch.is_tensor(x) else torch.device("cuda")


def keypoint_repeatability(kp1, kp2, R=None, t=None, radius=0.5,
                           device=None):
    """Fraction of kp1 with a kp2 within `radius` after warping.

    kp1 [K1, 3], kp2 [K2, 3] (arrays or tensors); (R, t) maps cloud-1
    coordinates into cloud 2's frame (x2 = x1 @ R.T + t), the identity if
    R is None.  Float64 on `device` (default: kp1's if a tensor, else the
    card)."""
    device = _device_of(kp1, device)
    kp1 = torch.as_tensor(kp1).to(device=device, dtype=torch.float64)
    kp2 = torch.as_tensor(kp2).to(device=device, dtype=torch.float64)
    if len(kp1) == 0 or len(kp2) == 0:
        return 0.0
    if R is not None:
        R = torch.as_tensor(np.asarray(R, np.float64), device=device)
        t = torch.as_tensor(np.asarray(t, np.float64), device=device)
        kp1 = kp1 @ R.T + t
    d = torch.cdist(kp1, kp2, compute_mode="donot_use_mm_for_euclid_dist")
    return float((d.min(dim=1).values < radius).double().mean())


def top_k_keypoints(xyz, attention, k, nms_radius=0.5,
                    min_response_ratio=0.01, device=None):
    """The extraction's keypoint rule (`core/utils.py:15-43`: NMS, then
    the top k by attention) on `device` (default: xyz's if a tensor, else
    the card); returns the [<=k, 3] keypoints as a tensor there, by
    descending attention."""
    device = _device_of(xyz, device)
    xyz = torch.as_tensor(xyz, device=device)
    n, order = device_nms(xyz, attention, nms_radius, min_response_ratio, k,
                          device=device)
    return xyz[torch.as_tensor(order[:n], device=device)]


def _curve_from(extracted, poses, ks, radius, device):
    """{k: mean repeatability} over pairs of extractions: one NMS a cloud
    at the largest k, whose list by descending attention holds the list at
    every smaller k as its prefix."""
    kmax = max(ks)
    results = {k: [] for k in ks}
    for ((xyz1, att1), (xyz2, att2)), (R, t) in zip(extracted, poses):
        kp1 = top_k_keypoints(xyz1, att1, kmax, device=device)
        kp2 = top_k_keypoints(xyz2, att2, kmax, device=device)
        for k in ks:
            results[k].append(keypoint_repeatability(kp1[:k], kp2[:k], R, t,
                                                     radius))
    return {k: float(np.mean(v)) for k, v in results.items()}


def repeatability_curve_pairs(extract_fn, pairs, ks=(32, 64, 128, 256, 512),
                              radius=0.5, device=None):
    """The GT-pose pair protocol: `pairs` yields (cloud1 [N, 3], cloud2
    [M, 3], R, t) with the ground-truth relative pose x2 = x1 @ R.T + t.

    extract_fn(cloud [N, 3] float32 array) -> (xyz [N, 3], attention [N]),
    arrays or tensors.  Returns {k: mean relative repeatability}."""
    extracted, poses = [], []
    for c1, c2, R, t in pairs:
        extracted.append((extract_fn(np.asarray(c1, np.float32)),
                          extract_fn(np.asarray(c2, np.float32))))
        poses.append((R, t))
    return _curve_from(extracted, poses, ks, radius, device)


def make_partial_overlap_pairs(clouds, numpts=8192, keep=0.85,
                               jitter=0.01, seed=0):
    """Evaluation pairs from single clouds: two partial-overlap half-space
    crops (the lower and the upper `keep` fraction along a random
    direction), each resampled to `numpts`, the second moved by a known
    (R, t).  Returns a list of (cloud1, cloud2, R, t) for
    `repeatability_curve_pairs`.  Numpy, on the draws of the JAX
    function."""
    rng = np.random.RandomState(seed)
    pairs = []
    for cloud in clouds:
        cloud = np.asarray(cloud, np.float64)
        u = rng.randn(3)
        u /= np.linalg.norm(u)
        proj = cloud @ u
        lo, hi = np.quantile(proj, [1.0 - keep, keep])
        part1 = cloud[proj <= hi]
        part2 = cloud[proj >= lo]
        if len(part1) < numpts // 4 or len(part2) < numpts // 4:
            continue

        def resample(pts):
            idx = rng.choice(len(pts), numpts, replace=len(pts) < numpts)
            return pts[idx] + rng.randn(numpts, 3) * jitter

        c1 = resample(part1)
        c2 = resample(part2)
        ang = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t = rng.uniform(-5, 5, 3)
        c2 = c2 @ R.T + t
        pairs.append((c1.astype(np.float32), c2.astype(np.float32), R, t))
    return pairs


def repeatability_curve(extract_fn, clouds, ks=(32, 64, 128, 256, 512),
                        radius=0.5, seed=0, device=None):
    """The self-pair protocol: each cloud against a copy moved by a random
    z-rotation and translation and jittered (the JAX function's draws),
    averaged over `clouds` at each K.

    extract_fn(cloud [N, 3]) -> (xyz [N, 3], attention [N])."""
    rng = np.random.RandomState(seed)
    extracted, poses = [], []
    for cloud in clouds:
        ang = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t = rng.uniform(-2, 2, 3)
        cloud2 = (cloud @ R.T + t + rng.randn(*cloud.shape) * 0.02
                  ).astype(np.float32)
        extracted.append((extract_fn(cloud), extract_fn(cloud2)))
        poses.append((R, t))
    return _curve_from(extracted, poses, ks, radius, device)
