"""Training batches from clouds on disk: the counterpart of the repository's
`train.py:56-107` (`real_batches`).

Under `cfg.data_basedir` the loaders read `.bin` clouds and one GT pickle:
`oxford_train_local_gt.pickle` ({i: {"query": path}}) for local training,
`oxford_train_global_gt.pickle` ({i: {"query", "positives",
"nonnegtives"}}) for global training.  The streams are endless: each epoch
starts a new pass of the sampler, whose RNG runs on.
"""

from __future__ import annotations

import os
from typing import Iterator

from dh3d_tpu_torch.data.datasets import GlobalTrainTriplet, LocalTrainSelfPair
from dh3d_tpu_torch.data.io import morton_sort_np


def _presort(gen) -> Iterator[dict]:
    """Host Morton sort of every cloud of a batch (`cfg.morton_presorted`),
    in the loader (the prefetch thread), so the model skips its own."""
    for batch in gen:
        yield {k: (morton_sort_np(v) if k in ("points", "pc1", "pc2") else v)
               for k, v in batch.items()}


def real_batches(cfg, seed: int = 0) -> Iterator[dict]:
    """Endless numpy batches from `cfg.data_basedir`, seeded by `seed`:
      - local training with `device_pairgen`: {pc1, pc2} [B, N, 3], two
        normalised copies of each cloud, unrotated (the step makes the
        pairs); the host augments them with `cfg.data_aug` unless the step
        does (`augment_on_device`);
      - local training without it: the host's self pairs {points, sample_inds,
        R} (`collate_local`); refused under `morton_presorted`, whose sort
        would leave the host's ids in load order;
      - global training: tuples {points} (`collate_global`), augmented on
        the host with `cfg.data_aug` whatever `augment_on_device` says, as
        `train.py:93-103` does.
    With `morton_presorted` the clouds arrive sorted (`morton_sort_np`)."""
    if cfg.training_local:
        if not cfg.device_pairgen and cfg.morton_presorted:
            raise ValueError(
                "morton_presorted requires device_pairgen for local training "
                "(host sample_inds are in load order)")
        ds = LocalTrainSelfPair(
            seed=seed,
            basedir=cfg.data_basedir,
            train_file=os.path.join(cfg.data_basedir,
                                    "oxford_train_local_gt.pickle"),
            numpts=cfg.num_points,
            sample_nodes=cfg.sampled_kpnum,
            aug=() if (cfg.device_pairgen and cfg.augment_on_device)
            else cfg.data_aug,
        )
        while True:
            if cfg.device_pairgen:
                gen = ds.raw_batches(cfg.batch_size)
                yield from (_presort(gen) if cfg.morton_presorted else gen)
            else:
                yield from ds.batches(cfg.batch_size)
    else:
        ds = GlobalTrainTriplet(
            seed=seed,
            basedir=cfg.data_basedir,
            train_file=os.path.join(cfg.data_basedir,
                                    "oxford_train_global_gt.pickle"),
            posnum=cfg.num_pos,
            negnum=cfg.num_neg,
            numpts=cfg.num_points,
            other_neg=cfg.other_neg,
            aug=cfg.data_aug,
        )
        while True:
            gen = ds.batches(cfg.batch_size)
            yield from (_presort(gen) if cfg.morton_presorted else gen)
