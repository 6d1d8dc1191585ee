"""Synthetic training batches: a copy of `train.py:25-53` (numpy, seeded,
the same draws in the same order), so that the port and the JAX trainer
see the same batches from the same seed.  A copy, not an import: the JAX
repository root's `train.py` imports nothing of jax at module level, but
the port must not depend on files outside its package."""

from __future__ import annotations

import numpy as np


def synthetic_local_batches(cfg, seed=0):
    """Endless synthetic self-pair batches (rotated jittered copies)."""
    rng = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.num_points, cfg.sampled_kpnum
    while True:
        pc1 = rng.randn(B, N, 3).astype(np.float32) * 20
        ang = rng.uniform(-np.pi, np.pi, B)
        R = np.stack([
            np.array([[np.cos(a), np.sin(a), 0],
                      [-np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
            for a in ang
        ])
        pc2 = np.einsum(
            "bnd,bde->bne", pc1 + rng.randn(B, N, 3) * 0.02, R
        ).astype(np.float32)
        anc = np.stack([rng.choice(N, M, replace=False) for _ in range(B)])
        yield {
            "points": np.concatenate([pc1, pc2]),
            "sample_inds": np.concatenate([anc, anc]).astype(np.int32),
            "R": R.astype(np.float32),
        }


def synthetic_global_batches(cfg, seed=0):
    """Endless synthetic tuple batches of
    batch_size * (1 + num_pos + num_neg + other_neg) clouds."""
    rng = np.random.RandomState(seed)
    B, N = cfg.batch_size, cfg.num_points
    total = B * (1 + cfg.num_pos + cfg.num_neg + (1 if cfg.other_neg else 0))
    while True:
        yield {"points": rng.randn(total, N, 3).astype(np.float32) * 20}


def synthetic_batches(cfg, seed=0):
    """The local or the global stream, as the config trains."""
    if cfg.training_local:
        return synthetic_local_batches(cfg, seed)
    return synthetic_global_batches(cfg, seed)
