"""Rigid-transform math for registration evaluation (copy of
`dh3d_tpu/utils/transforms.py`, with one torch function added).

The numpy functions are the JAX package's, line for line: quaternion and
euler helpers, the Kabsch rigid fit and the pose-error metrics of
`core/utils.py:222-581`.  `rigid_transform_3d_batched` is the same Kabsch
fit on tensors, one fit a row of a batch, for RANSAC's hypotheses.
"""

from __future__ import annotations

import numpy as np
import torch


def rigid_transform_3d(A, B):
    """Least-squares rigid transform mapping B -> A (Kabsch).

    A, B: [N, 3].  Returns (R [3,3], t [3]) with A ~= B @ R.T + t —
    the same contract as the reference (`core/utils.py:259-301`:
    "rotation matrix such that A = R * B + t").
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    ca, cb = A.mean(0), B.mean(0)
    H = (B - cb).T @ (A - ca)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = ca - R @ cb
    return R, t


def rigid_transform_3d_batched(A, B):
    """`rigid_transform_3d` on a batch: A, B [n, m, 3] tensors (m >= 1),
    one fit a row, in float64 on their device.  Returns (R [n, 3, 3], t
    [n, 3], ok [n] bool): the same Kabsch formula (centroids, H = (B - cb)^T
    (A - ca), d = sign(det(V U^T)), R = V diag(1, 1, d) U^T, t = ca - R cb);
    `ok` is False where H, R or t is not finite: numpy's SVD raises
    LinAlgError on a NaN in H, where a batched SVD returns NaN or fails."""
    A = torch.as_tensor(A).to(torch.float64)
    B = torch.as_tensor(B).to(torch.float64)
    ca, cb = A.mean(1), B.mean(1)
    H = (B - cb[:, None]).transpose(1, 2) @ (A - ca[:, None])
    finite = torch.isfinite(H).flatten(1).all(1)
    # the SVD of a non-finite H may fail outright; fit a zero H there
    H = torch.where(finite[:, None, None], H, torch.zeros_like(H))
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], 1))
    R = V @ D @ U.transpose(1, 2)
    t = ca - (R @ cb[:, None, :].transpose(1, 2))[..., 0]
    ok = (finite & torch.isfinite(R).flatten(1).all(1)
          & torch.isfinite(t).all(1))
    return R, t, ok


def apply_transform(pcd, transform):
    """Homogeneous 4x4 transform applied to [N, 3]
    (`core/utils.py:212-219`)."""
    pcd = np.asarray(pcd)
    homo = np.concatenate([pcd, np.ones((pcd.shape[0], 1))], axis=1)
    return (homo @ np.asarray(transform).T)[:, :3]


def to_homogeneous(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).flatten()
    return T


def rotation_error_deg(R1, R2):
    """Geodesic angle between two rotations in degrees
    (`core/utils.py:223-225`)."""
    cos = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_error(t1, t2):
    return float(np.linalg.norm(np.asarray(t1).flatten()
                                - np.asarray(t2).flatten()))


def quaternion_from_matrix(R):
    """Unit quaternion (w, x, y, z) from a rotation matrix — eigenvector
    formulation as in `core/utils.py:304-379`."""
    R = np.asarray(R, np.float64)[:3, :3]
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    K = np.array([
        [m00 - m11 - m22, 0.0, 0.0, 0.0],
        [m01 + m10, m11 - m00 - m22, 0.0, 0.0],
        [m02 + m20, m12 + m21, m22 - m00 - m11, 0.0],
        [m21 - m12, m02 - m20, m10 - m01, m00 + m11 + m22],
    ]) / 3.0
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    if q[0] < 0.0:
        q = -q
    return q


def quaternion_matrix(q):
    """Rotation matrix from unit quaternion (w, x, y, z)
    (`core/utils.py:449-473`)."""
    q = np.asarray(q, np.float64)
    n = q @ q
    if n < np.finfo(float).eps * 4.0:
        return np.eye(3)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array([
        [1 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0]],
        [q[1, 2] + q[3, 0], 1 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0]],
        [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1 - q[1, 1] - q[2, 2]],
    ])


# --------------------------------------------------------------------------
# Euler-angle / random-rotation toolbox (transformations.py subset shipped
# inside the reference, `core/utils.py:303-569`).  24 axis conventions:
# 4-char strings like 'sxyz' — (s)tatic or (r)otating frame + axis order.

_EPS4 = np.finfo(np.float64).eps * 4.0
_NEXT_AXIS = [1, 2, 0, 1]
_AXES2TUPLE = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
    "rzyx": (0, 0, 0, 1), "rxyx": (0, 0, 1, 1), "ryzx": (0, 1, 0, 1),
    "rxzx": (0, 1, 1, 1), "rxzy": (1, 0, 0, 1), "ryzy": (1, 0, 1, 1),
    "rzxy": (1, 1, 0, 1), "ryxy": (1, 1, 1, 1), "ryxz": (2, 0, 0, 1),
    "rzxz": (2, 0, 1, 1), "rxyz": (2, 1, 0, 1), "rzyz": (2, 1, 1, 1),
}
_TUPLE2AXES = {v: k for k, v in _AXES2TUPLE.items()}


def _axes_tuple(axes):
    try:
        return _AXES2TUPLE[axes.lower()]
    except (AttributeError, KeyError):
        _TUPLE2AXES[tuple(axes)]  # validation, KeyError on bad tuple
        return tuple(axes)


def euler_matrix(ai, aj, ak, axes="sxyz"):
    """Homogeneous rotation matrix from Euler angles for any of the 24
    axis conventions.  The reference's docstrings round-trip through this
    (`core/utils.py:491-547` doctest); included so ported eval scripts
    that build matrices from Euler triples work out of the box."""
    firstaxis, parity, repetition, frame = _axes_tuple(axes)
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]

    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak

    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    M = np.eye(4)
    if repetition:
        M[i, i] = cj
        M[i, j] = sj * si
        M[i, k] = sj * ci
        M[j, i] = sj * sk
        M[j, j] = -cj * ss + cc
        M[j, k] = -cj * cs - sc
        M[k, i] = -sj * ck
        M[k, j] = cj * sc + cs
        M[k, k] = cj * cc - ss
    else:
        M[i, i] = cj * ck
        M[i, j] = sj * sc - cs
        M[i, k] = sj * cc + ss
        M[j, i] = cj * sk
        M[j, j] = sj * ss + cc
        M[j, k] = sj * cs - sc
        M[k, i] = -sj
        M[k, j] = cj * si
        M[k, k] = cj * ci
    return M


def euler_from_matrix(matrix, axes="sxyz"):
    """Euler angles from a rotation matrix for any of the 24 axis
    conventions — exact port of `core/utils.py:491-547` (gimbal-lock
    branches included)."""
    firstaxis, parity, repetition, frame = _axes_tuple(axes)
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]

    M = np.asarray(matrix, dtype=np.float64)[:3, :3]
    if repetition:
        sy = np.sqrt(M[i, j] * M[i, j] + M[i, k] * M[i, k])
        if sy > _EPS4:
            ax = np.arctan2(M[i, j], M[i, k])
            ay = np.arctan2(sy, M[i, i])
            az = np.arctan2(M[j, i], -M[k, i])
        else:
            ax = np.arctan2(-M[j, k], M[j, j])
            ay = np.arctan2(sy, M[i, i])
            az = 0.0
    else:
        cy = np.sqrt(M[i, i] * M[i, i] + M[j, i] * M[j, i])
        if cy > _EPS4:
            ax = np.arctan2(M[k, j], M[k, k])
            ay = np.arctan2(-M[k, i], cy)
            az = np.arctan2(M[j, i], M[i, i])
        else:
            ax = np.arctan2(-M[j, k], M[j, j])
            ay = np.arctan2(-M[k, i], cy)
            az = 0.0

    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return ax, ay, az


def angle_error1(R1, R2):
    """Geodesic rotation error in degrees (`core/utils.py:223-225`)."""
    cos = (np.trace(np.linalg.inv(np.asarray(R1, np.float64))
                    @ np.asarray(R2, np.float64)) - 1.0) / 2.0
    return np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))


def angle_error2(R1, R2):
    """Sum of absolute Euler angles of the relative rotation (radians),
    exact port of `core/utils.py:228-231`."""
    euler = euler_from_matrix(
        np.linalg.inv(np.asarray(R1, np.float64))
        @ np.asarray(R2, np.float64))
    return float(np.sum(np.abs(euler)))


def vector_norm(data, axis=None, out=None):
    """Euclidean norm along axis (`core/utils.py:382-419`)."""
    data = np.array(data, dtype=np.float64, copy=True)
    if out is None:
        if data.ndim == 1:
            return float(np.sqrt(np.dot(data, data)))
        data *= data
        out = np.atleast_1d(np.sum(data, axis=axis))
        np.sqrt(out, out)
        return out
    data *= data
    np.sum(data, axis=axis, out=out)
    np.sqrt(out, out)


def random_quaternion(rand=None, rng=None):
    """Uniform random unit quaternion (w, x, y, z)
    (`core/utils.py:421-446`).  `rand`: three uniform [0,1) variates;
    `rng`: numpy Generator/RandomState used when rand is None."""
    if rand is None:
        rand = rng.random(3) if rng is not None else np.random.rand(3)
    rand = np.asarray(rand, np.float64)
    assert rand.shape == (3,)
    r1 = np.sqrt(1.0 - rand[0])
    r2 = np.sqrt(rand[0])
    t1 = 2.0 * np.pi * rand[1]
    t2 = 2.0 * np.pi * rand[2]
    return np.array([np.cos(t2) * r2, np.sin(t1) * r1,
                     np.cos(t1) * r1, np.sin(t2) * r2])


def random_rotation_matrix(rand=None, rng=None):
    """Uniform random rotation as a homogeneous 4x4 matrix
    (`core/utils.py:476-488`)."""
    R = np.eye(4)
    R[:3, :3] = quaternion_matrix(random_quaternion(rand, rng))
    return R


def quaternion_from_matrix_precise(matrix):
    """Branch-based (Shepperd) quaternion extraction — the
    `isprecise=True` variant of `core/utils.py:304-379`; requires an
    exactly orthonormal input.

    Parity note: the reference's copy of this branch is broken dead code
    (it shifted transformations.py's 0-based component indices to
    1-based without the compensating final `q[[3,0,1,2]]` permutation,
    so the else branch reads the wrong matrix entries and puts w in a
    different slot than the sign-fix expects; upstream never calls it —
    `isprecise` defaults to False).  This is the correct original."""
    M = np.asarray(matrix, np.float64)
    M4 = np.eye(4)
    M4[:3, :3] = M[:3, :3]
    q = np.empty(4)
    t = np.trace(M4)
    if t > M4[3, 3]:
        q[0] = t
        q[3] = M4[1, 0] - M4[0, 1]
        q[2] = M4[0, 2] - M4[2, 0]
        q[1] = M4[2, 1] - M4[1, 2]
    else:
        i, j, k = 0, 1, 2
        if M4[1, 1] > M4[0, 0]:
            i, j, k = 1, 2, 0
        if M4[2, 2] > M4[i, i]:
            i, j, k = 2, 0, 1
        t = M4[i, i] - (M4[j, j] + M4[k, k]) + M4[3, 3]
        q[i] = t
        q[j] = M4[i, j] + M4[j, i]
        q[k] = M4[k, i] + M4[i, k]
        q[3] = M4[k, j] - M4[j, k]
        q = q[[3, 0, 1, 2]]
    q *= 0.5 / np.sqrt(t * M4[3, 3])
    if q[0] < 0.0:
        q = -q
    return q


def evaluate_R_t(R_gt, t_gt, R, t):
    """Quaternion / normalized-translation angular errors (radians),
    matching `core/utils.py:234-257`."""
    eps = 1e-15
    q = quaternion_from_matrix(R)
    q_gt = quaternion_from_matrix(R_gt)
    q = q / (np.linalg.norm(q) + eps)
    q_gt = q_gt / (np.linalg.norm(q_gt) + eps)
    loss_q = np.maximum(eps, 1.0 - np.sum(q * q_gt) ** 2)
    err_q = np.arccos(1 - 2 * loss_q)

    t = np.asarray(t, np.float64).flatten()
    t_gt = np.asarray(t_gt, np.float64).flatten()
    t = t / (np.linalg.norm(t) + eps)
    t_gt = t_gt / (np.linalg.norm(t_gt) + eps)
    loss_t = np.maximum(eps, 1.0 - np.sum(t * t_gt) ** 2)
    err_t = np.arccos(np.sqrt(1 - loss_t))
    return err_q, err_t
