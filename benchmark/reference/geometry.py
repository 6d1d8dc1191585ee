"""Neighbour search, farthest point sampling and the Z-order sort, plain.

Semantics (reference `user_ops`, `tf_ops`): the k nearest keys ascend by
squared distance, the lowest index first among equal distances, so a self
query finds itself at slot 0; FPS starts at index 0 and takes the first
farthest point on a tie.  Squared distances are built term by term,
(dx*dx + dy*dy) + dz*dz, each operation rounded on its own: no matrix
identity, so TF32 and reassociation cannot move a neighbour set.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ELEMS = 1 << 26  # bounds one [B, chunk, Nk] block of distances


def sqdist(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [..., Nq, 3], k [..., Nk, 3] -> [..., Nq, Nk] squared distances."""
    dx = q[..., :, None, 0] - k[..., None, :, 0]
    dy = q[..., :, None, 1] - k[..., None, :, 1]
    dz = q[..., :, None, 2] - k[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def knn(query: torch.Tensor, keys: torch.Tensor, k: int):
    """query [B, Nq, 3], keys [B, Nk, 3] -> (idx [B, Nq, k] int64,
    d2 [B, Nq, k]), ascending by (d2, index)."""
    B, Nq, _ = query.shape
    chunk = max(1, CHUNK_ELEMS // max(1, B * keys.shape[1]))
    idx, dist = [], []
    for s in range(0, Nq, chunk):
        d2 = sqdist(query[:, s:s + chunk], keys)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        idx.append(order[..., :k])
        dist.append(vals[..., :k])
    return torch.cat(idx, dim=1), torch.cat(dist, dim=1)


def fps(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """points [B, N, 3] -> [B, npoint] int64, seeded at index 0."""
    B, N, _ = points.shape
    mind = torch.full((B, N), float("inf"), dtype=points.dtype,
                      device=points.device)
    out = torch.zeros(B, npoint, dtype=torch.int64, device=points.device)
    last = torch.zeros(B, 1, dtype=torch.int64, device=points.device)
    for j in range(1, npoint):
        c = torch.gather(points, 1, last[..., None].expand(-1, -1, 3))
        d = points - c
        mind = torch.minimum(
            mind, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2])
        last = torch.argmax(mind, dim=1, keepdim=True)  # first occurrence
        out[:, j] = last[:, 0]
    return out


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, C], idx [B, ...] -> x[b, idx[b]] [B, ..., C]."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def _spread(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_perm(points: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] f32 -> [B, N] int64 stable sort along the 30-bit Z-order
    code of each cloud's box, quantised to 10 bits an axis as
    1023 / max(hi - lo, 1e-9) (a true division), clipped, truncated."""
    lo = points.amin(dim=1, keepdim=True)
    hi = points.amax(dim=1, keepdim=True)
    scale = points.new_tensor(1023.0) / torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((points - lo) * scale, 0, 1023).to(torch.int64)
    code = _spread(q[..., 0]) | (_spread(q[..., 1]) << 1) \
        | (_spread(q[..., 2]) << 2)
    return torch.argsort(code, dim=1, stable=True)


def morton_sort_np(points: np.ndarray) -> np.ndarray:
    """The host loader's sort, [B, N, 3] f32 -> sorted copy: the box
    quantised in f32 numpy arithmetic, as the training loader does
    (reference `core/utils.py` has no sort; the TPU port added it)."""
    pts = np.asarray(points, np.float32)
    lo = pts.min(axis=1, keepdims=True)
    hi = pts.max(axis=1, keepdims=True)
    scale = np.float32(1023) / np.maximum(hi - lo, np.float32(1e-9))
    q = np.clip((pts - lo) * scale, 0, 1023).astype(np.uint32)
    code = _spread(q[..., 0]) | (_spread(q[..., 1]) << np.uint32(1)) \
        | (_spread(q[..., 2]) << np.uint32(2))
    perm = np.argsort(code, axis=1, kind="stable")
    return np.take_along_axis(pts, perm[..., None], axis=1)


def rotate_rows(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Row vectors x [B, N, 3] times R [B, 3, 3], the three products added
    in order (x R[0] + y R[1]) + z R[2]: no matrix unit, no TF32."""
    return (x[..., 0, None] * R[:, None, 0, :]
            + x[..., 1, None] * R[:, None, 1, :]) \
        + x[..., 2, None] * R[:, None, 2, :]


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 3, 3] [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    (`core/datasets.py:136-139`, row-vector layout)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1),
                        torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)
