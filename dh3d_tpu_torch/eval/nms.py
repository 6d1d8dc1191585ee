"""Keypoint non-maximum suppression (counterpart of `dh3d_tpu/eval/nms.py`).

`single_nms` is the reference host NMS (`core/utils.py:15-43`) on
`scipy.spatial.cKDTree` instead of sklearn's ball tree: 50-NN
neighbourhoods, noise removal (8th neighbour farther than 2 m -> zero
attention), radius suppression, response-ratio threshold, keypoints by
descending attention.  The two trees may order neighbours at exactly equal
distances differently, which can move a suppression decision; on clouds
without such ties they agree.  `device_nms` applies the same rules with the
port's exact kNN (`ops.knn_bruteforce`, kernel G on the card for k = 50)
and one host transfer per cloud.
"""

from __future__ import annotations

import numpy as np
import torch

from dh3d_tpu_torch import ops

NMS_K = 50  # neighbours a point is compared with (`core/utils.py:20`)


def single_nms(xyz, attention, nms_radius, min_response_ratio, max_keypoints,
               remove_noise=True):
    """Host NMS.  xyz [N, 3], attention [N] arrays.  Returns
    (num_keypoints, list of indices by descending attention; ties in
    attention by descending index, as `sorted(..., reverse=True)`)."""
    from scipy.spatial import cKDTree

    attention = np.array(attention, copy=True)
    k = min(NMS_K, len(xyz))
    distances, indices = cKDTree(xyz).query(xyz, k=k)
    distances = np.asarray(distances).reshape(len(xyz), k)
    indices = np.asarray(indices).reshape(len(xyz), k)
    if remove_noise:
        invalid = distances[:, min(7, k - 1)] > 2.0
        attention[invalid] = 0.0

    knn_attention = attention[indices]
    knn_attention[distances > nms_radius] = 0.0
    is_max = np.where(np.argmax(knn_attention, axis=1) == 0)[0]

    thresh = np.max(attention) * min_response_ratio
    is_max_attention = sorted(
        [(attention[m], m) for m in is_max if attention[m] > thresh],
        reverse=True,
    )
    max_indices = [m[1] for m in is_max_attention][:max_keypoints]
    return len(max_indices), max_indices


def device_nms(xyz, attention, nms_radius, min_response_ratio, max_keypoints,
               remove_noise=True, device="cuda"):
    """The rules of `single_nms` on `device` (`dh3d_tpu/eval/nms.py:46-82`),
    the card unless the caller names the CPU.

    xyz [N, 3], attention [N] (arrays or tensors).  Returns (num_keypoints,
    indices [min(max_keypoints, N)] int64 numpy, by descending attention,
    ties by descending index, padded with -1)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    att = torch.as_tensor(attention, dtype=torch.float32,
                          device=device).reshape(-1)
    n = xyz.shape[0]
    k = min(NMS_K, n)
    idx, dist = ops.knn_bruteforce(xyz[None].contiguous(), k)
    idx, dist = idx[0], dist[0]

    if remove_noise:
        att = torch.where(dist[:, min(7, k - 1)] > 2.0,
                          torch.zeros_like(att), att)

    knn_att = torch.where(dist > nms_radius, torch.zeros_like(dist), att[idx])
    is_max = torch.argmax(knn_att, dim=1) == 0  # first occurrence

    thresh = torch.max(att) * min_response_ratio
    keep = is_max & (att > thresh)
    score = torch.where(keep, att, torch.full_like(att, -float("inf")))
    # descending score, ties by descending index: a stable descending sort
    # of the reversed scores keeps reversed (= descending) index order
    rev = torch.sort(score.flip(0), descending=True, stable=True).indices
    order = (n - 1 - rev)[:max_keypoints]
    valid = score[order] > -float("inf")
    order = torch.where(valid, order, torch.full_like(order, -1))
    order = order.cpu().numpy()  # the one transfer to the host
    return int((order >= 0).sum()), order


def nms_keypoint_indices(xyz, attention, nms_radius, min_response_ratio,
                         max_keypoints, remove_noise=True, backend="device",
                         parity_check=False, device="cuda"):
    """NMS entry point of `extract_local`.

    backend='device' runs `device_nms` on `device`; 'host' runs
    `single_nms`.  `parity_check=True` also runs the host NMS and raises
    AssertionError unless both select the same keypoints in the same order.
    Returns a list of keypoint indices, descending attention."""
    if backend == "device":
        _, order = device_nms(xyz, attention, nms_radius, min_response_ratio,
                              max_keypoints, remove_noise=remove_noise,
                              device=device)
        idx = [int(i) for i in order if i >= 0]
    elif backend == "host":
        _, idx = single_nms(xyz, attention, nms_radius, min_response_ratio,
                            max_keypoints, remove_noise=remove_noise)
    else:
        raise ValueError(f"unknown NMS backend '{backend}'")
    if parity_check:
        _, host_idx = single_nms(np.asarray(xyz, np.float64),
                                 np.asarray(attention), nms_radius,
                                 min_response_ratio, max_keypoints,
                                 remove_noise=remove_noise)
        if list(idx) != list(host_idx):
            raise AssertionError(
                f"device/host NMS mismatch: {idx[:8]}... vs {host_idx[:8]}...")
    return idx
