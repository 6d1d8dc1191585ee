"""Python ports of the remaining MATLAB evaluation helpers (copy of
`dh3d_tpu/eval/matlab_extras.py`, the kNN on `scipy.spatial.cKDTree`
instead of sklearn).

Completes the `evaluate/local_eval/matlab_code/external/` surface
(SURVEY.md §2.2 "Registration eval"): `estimateRigidTransform`/`ransacfitRt`
live in `eval/registration.py`; this module adds

  find_point_normals  `findPointNormals.m`  kNN-plane-fit normals+curvature
  prec_rec            `prec_rec.m`          precision/recall + ROC points

Neither is used by the headline success protocol (registration success is
a threshold test, not a PR curve), but they are part of the reference's
evaluation toolbox.
"""

from __future__ import annotations

import numpy as np


def find_point_normals(points, num_neighbours=9, view_point=(0.0, 0.0, 0.0),
                       dir_largest=True):
    """Estimate per-point normals by PCA plane fit over kNN neighborhoods
    (`findPointNormals.m`; the PCL normal-estimation recipe).

    points: [N, 3].  Returns (normals [N, 3] unit vectors oriented toward
    `view_point`, curvature [N] = lambda_min / trace).
    """
    points = np.asarray(points, np.float64)
    n = len(points)
    k = min(num_neighbours, n - 1)

    # kNN (excluding self, the first neighbour of a point of a cloud
    # without duplicates) on the host
    from scipy.spatial import cKDTree

    _, idx = cKDTree(points).query(points, k=k + 1)
    neigh = points[np.asarray(idx).reshape(n, k + 1)[:, 1:]]  # [N, k, 3]

    mean = neigh.mean(axis=1, keepdims=True)
    centered = neigh - mean
    cov = np.einsum("nki,nkj->nij", centered, centered) / k  # [N, 3, 3]
    evals, evecs = np.linalg.eigh(cov)  # ascending eigenvalues
    normals = evecs[:, :, 0]  # smallest-eigenvalue direction
    curvature = evals[:, 0] / np.maximum(evals.sum(axis=1), 1e-12)

    # orient toward the view point (`findPointNormals.m`: flip where the
    # normal points away; dirLargest uses only the largest |component|)
    to_view = np.asarray(view_point, np.float64)[None, :] - points
    if dir_largest:
        largest = np.argmax(np.abs(normals), axis=1)
        sign = np.sign(
            normals[np.arange(n), largest] * to_view[np.arange(n), largest]
        )
    else:
        sign = np.sign(np.einsum("nd,nd->n", normals, to_view))
    sign = np.where(sign == 0, 1.0, sign)
    return normals * sign[:, None], curvature


def prec_rec(score, target, instance_count=None, num_thresh=None):
    """Precision/recall and ROC operating points (`prec_rec.m`, plotting
    options dropped).

    score: [N] classifier scores; target: [N] binary labels (or, with
    `instance_count`, the number of positives among `instance_count[i]`
    instances sharing score[i]).  Thresholds are score quantiles with
    roughly equal sample counts per interval, like the MATLAB version.

    Returns (precision [T], tpr [T], fpr [T], thresholds [T]).
    """
    score = np.asarray(score, np.float64).ravel()
    target = np.asarray(target, np.float64).ravel()
    if instance_count is None:
        if not np.all((target == 0) | (target == 1)):
            raise ValueError("target must be binary without instance_count")
        instance_count = np.ones_like(target)
    else:
        instance_count = np.asarray(instance_count, np.float64).ravel()

    order = np.argsort(-score, kind="stable")
    score, target, counts = score[order], target[order], instance_count[order]

    if num_thresh is None:
        num_thresh = min(len(np.unique(score)), 100)
    qvals = np.linspace(0, 1, num_thresh)
    thresh = np.unique(np.quantile(score, qvals))[::-1]

    total_pos = target.sum()
    total_neg = counts.sum() - total_pos

    prec, tpr, fpr = [], [], []
    for t in thresh:
        sel = score >= t
        tp = target[sel].sum()
        n_sel = counts[sel].sum()
        fp = n_sel - tp
        prec.append(tp / n_sel if n_sel > 0 else 1.0)
        tpr.append(tp / total_pos if total_pos > 0 else 0.0)
        fpr.append(fp / total_neg if total_neg > 0 else 0.0)
    return (np.asarray(prec), np.asarray(tpr), np.asarray(fpr),
            np.asarray(thresh))
