"""6DoF registration: descriptor matching and RANSAC rigid fit on a device
(counterpart of `dh3d_tpu/eval/registration.py`).

The reference's MATLAB pipeline (`eval_align.m:116-165`,
`local_align_demo.m:67-99`): mutual-nearest-neighbour matching, RANSAC with
a 1.0 m inlier threshold, a refit on the inlier set, and success iff the
translation error is <= 2 m and the rotation error <= 5 degrees.

The JAX package runs these in numpy, one hypothesis at a time.  Here the
distances, the fits and the residuals are float64 tensors on `device` (the
card unless the caller names the CPU): RANSAC draws the same hypotheses on
the host, from the same `np.random.RandomState(seed)` calls in the same
order, fits them all at once (`rigid_transform_3d_batched`) and scores
them in one [iters, M] pass, so it picks the hypothesis the JAX loop picks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dh3d_tpu_torch.utils.transforms import (
    rigid_transform_3d_batched,
    rotation_error_deg,
    translation_error,
)


def _f64(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def match_descriptors_mutual(desc1, desc2, device="cuda"):
    """Mutual nearest neighbours in descriptor space (`eval_align.m`:
    pdist2 'smallest' 1 both ways).  desc1 [N1, D], desc2 [N2, D] (arrays or
    tensors).  Returns [M, 2] int64 index pairs on `device`, in desc1
    order; the first index wins a tie, as `np.argmin`."""
    d1, d2 = _f64(desc1, device), _f64(desc2, device)
    d = torch.cdist(d1, d2, compute_mode="donot_use_mm_for_euclid_dist")
    nn12 = torch.argmin(d, dim=1)
    nn21 = torch.argmin(d, dim=0)
    idx1 = torch.arange(len(d1), device=d.device)
    mutual = nn21[nn12] == idx1
    return torch.stack([idx1[mutual], nn12[mutual]], dim=1)


@dataclass
class RansacResult:
    R: np.ndarray
    t: np.ndarray
    inliers: np.ndarray
    num_inliers: int
    num_matches: int


def ransac_draws(M, iters, seed):
    """[iters, 3] int64: the triplets the JAX loop draws, one
    `rng.choice(M, 3, replace=False)` an iteration."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(M, 3, replace=False) for _ in range(iters)])


def _residuals(xyz1, xyz2, R, t):
    """[n, M] float64: |xyz2 @ R_i^T + t_i - xyz1| for each fit i."""
    pred = xyz2[None] @ R.transpose(1, 2) + t[:, None, :]
    return torch.linalg.vector_norm(pred - xyz1[None], dim=2)


def ransac_rigid(xyz1, xyz2, inlier_thresh=1.0, iters=1000, seed=0,
                 min_inliers=3, device="cuda") -> Optional[RansacResult]:
    """RANSAC rigid fit mapping xyz2 onto xyz1 over given correspondences
    (`dh3d_tpu/eval/registration.py:47-79`).

    xyz1, xyz2: [M, 3] matched points (arrays or tensors).  A fit that is
    not finite counts -1, as the JAX loop skips an SVD that raises; the
    first hypothesis with the most inliers wins.  None when M < 3, when
    every fit is skipped, or when the best count is below `min_inliers`.
    Then the refit on that hypothesis's inliers and their recount, as the
    JAX function does; R, t and the inlier mask come back as host arrays.
    (An H with an infinite entry, but no NaN, makes numpy's SVD return NaN
    rather than raise, so the JAX loop counts that fit 0 inliers, not -1;
    the two differ only when no hypothesis has an inlier.)"""
    M = xyz1.shape[0]
    if M < 3:
        return None
    p1, p2 = _f64(xyz1, device), _f64(xyz2, device)
    sel = torch.from_numpy(ransac_draws(M, iters, seed)).to(p1.device)
    R, t, ok = rigid_transform_3d_batched(p1[sel], p2[sel])
    inliers = _residuals(p1, p2, R, t) < inlier_thresh
    counts = torch.where(ok, inliers.sum(1), -1)
    best = torch.argmax(counts)  # the first of the largest
    best_count = int(counts[best])
    if best_count < 0 or best_count < min_inliers:
        return None
    keep = inliers[best]
    R, t, _ = rigid_transform_3d_batched(p1[keep][None], p2[keep][None])
    inliers = _residuals(p1, p2, R, t)[0] < inlier_thresh
    inliers = inliers.cpu().numpy()
    return RansacResult(R[0].cpu().numpy(), t[0].cpu().numpy(), inliers,
                        int(inliers.sum()), M)


def register_clouds(kp1, desc1, kp2, desc2, inlier_thresh=1.0, iters=1000,
                    seed=0, device="cuda") -> Optional[RansacResult]:
    """Mutual matching, then RANSAC: the transform mapping cloud-2
    keypoints onto cloud 1.  None with fewer than 3 matches."""
    matches = match_descriptors_mutual(desc1, desc2, device=device)
    if len(matches) < 3:
        return None
    kp1, kp2 = _f64(kp1, device), _f64(kp2, device)
    return ransac_rigid(kp1[matches[:, 0]], kp2[matches[:, 1]],
                        inlier_thresh=inlier_thresh, iters=iters, seed=seed,
                        device=device)


def registration_success(R_est, t_est, R_gt, t_gt, rte_thresh=2.0,
                         rre_thresh=5.0):
    """Success protocol of `eval_align.m:143` / `local_align_demo.m:86`:
    RTE <= 2 m and RRE <= 5 degrees.  Returns (success, rte, rre)."""
    rte = translation_error(t_est, t_gt)
    rre = rotation_error_deg(np.asarray(R_est), np.asarray(R_gt))
    return bool(rte <= rte_thresh and rre <= rre_thresh), rte, rre
