"""Point-cloud augmentations (counterpart of `dh3d_tpu/data/augment.py`).

The host versions (numpy classes, `get_augmentations_from_list`) are a copy
of `dh3d_tpu/data/augment.py:19-126`, themselves `core/augment.py` of
3DFeatNet: the same draws from the same `RandomState` in the same order,
so the same bits.

The device versions are the counterparts of its `jax_*` functions
(`:129-184`).  Each takes its draws as an argument, so the draws (jitter
noise, shift, angle, scale) can come from anywhere; `draw_augment` makes
them from a `torch.Generator` on the clouds' device, one set for each cloud
of a batch (the JAX trainer's `vmap` over split keys,
`dh3d_tpu/train/trainer.py:163-166,188-191`), and `torch_augment` applies
them.  The draws:
  Jitter       standard normals, the cloud's shape
  Shift        3 offsets, U(-shift_range, shift_range)
  Rotate1D     u ~ U(0, 1); the angle is u * 2 pi
  RotateSmall  3 standard normals
  Scale        the factor, U(lo, hi)
Rotations multiply in f32 with every product and sum its own operation
(`matmul3`), so no TF32 or other reduced-precision matmul path can apply:
JAX's `precision="highest"`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# -------------------------- host (numpy) versions --------------------------

class Augmentation:
    def apply(self, data, rng=None):
        raise NotImplementedError


class Jitter(Augmentation):
    """Gaussian position jitter, sigma 0.05 clipped at 0.1
    (`core/augment.py:41-55`)."""

    def __init__(self, sigma=0.05, clip=0.1):
        self.sigma, self.clip = sigma, clip

    def apply(self, data, rng=None):
        rng = rng or np.random
        noise = np.clip(self.sigma * rng.randn(*data.shape),
                        -self.clip, self.clip)
        return data + noise


class Shift(Augmentation):
    """Uniform global shift +-0.1 (`core/augment.py:58-67`)."""

    def __init__(self, shift_range=0.1):
        self.shift_range = shift_range

    def apply(self, data, rng=None):
        rng = rng or np.random
        return data + rng.uniform(-self.shift_range, self.shift_range, 3)


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class RotateZ(Augmentation):
    """Full-revolution rotation about z (`core/augment.py:70-84`)."""

    def apply(self, data, rng=None):
        rng = rng or np.random
        return np.dot(data, _rot_z(rng.uniform() * 2 * np.pi))


class RotateY(Augmentation):
    """Full-revolution rotation about y (`core/augment.py:87-101`)."""

    def apply(self, data, rng=None):
        rng = rng or np.random
        return np.dot(data, _rot_y(rng.uniform() * 2 * np.pi))


class RotateSmall(Augmentation):
    """Small all-axis rotation, sigma 0.06 clip 0.18
    (`core/augment.py:104-128`)."""

    def __init__(self, angle_sigma=0.06, angle_clip=0.18):
        self.angle_sigma, self.angle_clip = angle_sigma, angle_clip

    def apply(self, data, rng=None):
        rng = rng or np.random
        a = np.clip(self.angle_sigma * rng.randn(3),
                    -self.angle_clip, self.angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        return np.dot(data, Rz @ Ry @ Rx)


class Scale(Augmentation):
    """Uniform scale in [0.8, 1.25] (`core/augment.py:131-141`)."""

    def __init__(self, scale_low=0.8, scale_high=1.25):
        self.scale_low, self.scale_high = scale_low, scale_high

    def apply(self, data, rng=None):
        rng = rng or np.random
        return data * rng.uniform(self.scale_low, self.scale_high)


def get_augmentations_from_list(str_list, upright_axis=2):
    """String-list selection (`core/augment.py:7-32`)."""
    if str_list is None:
        return []
    augs = []
    if "Rotate1D" in str_list:
        augs.append(RotateY() if upright_axis == 1 else RotateZ())
    if "Jitter" in str_list:
        augs.append(Jitter())
    if "Scale" in str_list:
        augs.append(Scale())
    if "RotateSmall" in str_list:
        augs.append(RotateSmall())
    if "Shift" in str_list:
        augs.append(Shift())
    return augs


# ------------------------ on-device (torch) versions ------------------------

def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., I, K] @ b [..., K, J] as f32 products and sums, the k terms
    added in order: no TF32, the same rounding on every device.  A cloud
    [B, N, 3] times rotations [B, 3, 3] rotates row vectors."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., None, k, :]
    return out


def _per_cloud(draw: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A [B] or [B, 3] draw broadcast over data [B, N, 3]."""
    return draw.reshape(draw.shape[0], *([1] * (data.dim() - draw.dim())),
                        *draw.shape[1:])


def torch_jitter(data, noise, sigma=0.05, clip=0.1):
    """`jax_jitter`: data + clip(sigma * noise); noise standard normal of
    data's shape."""
    return data + torch.clamp(sigma * noise, -clip, clip)


def torch_shift(data, offset):
    """`jax_shift`: data + offset, one [3] offset a cloud ([B, 3])."""
    return data + _per_cloud(offset, data)


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    """[...] angles -> [..., 3, 3] z-rotations in the reference's row-vector
    layout, [[c, s, 0], [-s, c, 0], [0, 0, 1]] (`jax_rotate_z`;
    `dh3d_tpu/data/pairgen.py:28-38`, `core/datasets.py:136-139`)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1),
                        torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def torch_rotate_z(data, u):
    """`jax_rotate_z`: a full-revolution rotation about z by u * 2 pi."""
    return matmul3(data, rotation_z(u * 2 * math.pi))


def rotation_small_of(normal, angle_sigma=0.06, angle_clip=0.18):
    """[B, 3] standard normals -> [B, 3, 3] = Rz @ Ry @ Rx of the clipped
    angles, as `jax_rotate_small` builds it."""
    a = torch.clamp(angle_sigma * normal, -angle_clip, angle_clip)
    cx, sx = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    cy, sy = torch.cos(a[:, 1]), torch.sin(a[:, 1])
    cz, sz = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    z, o = torch.zeros_like(cx), torch.ones_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([[o, z, z], [z, cx, -sx], [z, sx, cx]])
    Ry = mat([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    Rz = mat([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    return matmul3(matmul3(Rz, Ry), Rx)


def torch_rotate_small(data, normal, angle_sigma=0.06, angle_clip=0.18):
    """`jax_rotate_small`: a small rotation about all three axes."""
    return matmul3(data, rotation_small_of(normal, angle_sigma, angle_clip))


def torch_scale(data, factor):
    """`jax_scale`: data * factor, one factor a cloud ([B])."""
    return data * _per_cloud(factor, data)


_TORCH_AUGS = {
    "Jitter": torch_jitter,
    "Shift": torch_shift,
    "Rotate1D": torch_rotate_z,
    "RotateSmall": torch_rotate_small,
    "Scale": torch_scale,
}


def draw_augment(names, shape, generator: torch.Generator) -> list:
    """The draws of `names` for a batch of `shape` [B, N, 3], from
    `generator` on its device: [(name, draw), ...] in order (module
    docstring; `jax_augment`'s defaults: shift 0.1, scale [0.8, 1.25])."""
    B = shape[0]
    kw = {"generator": generator, "device": generator.device}
    draws = []
    for name in names:
        if name == "Jitter":
            d = torch.randn(*shape, **kw)
        elif name == "Shift":
            d = torch.rand(B, 3, **kw) * 0.2 - 0.1
        elif name == "Rotate1D":
            d = torch.rand(B, **kw)
        elif name == "RotateSmall":
            d = torch.randn(B, 3, **kw)
        elif name == "Scale":
            d = torch.rand(B, **kw) * (1.25 - 0.8) + 0.8
        else:
            raise KeyError(f"unknown augmentation {name}")
        draws.append((name, d))
    return draws


def torch_augment(data: torch.Tensor, draws) -> torch.Tensor:
    """Apply `draw_augment`'s draws to data [B, N, 3] in their order
    (`jax_augment`)."""
    for name, d in draws:
        data = _TORCH_AUGS[name](data, d)
    return data
