"""Host-side data: point-cloud IO, normalisation, the training and eval
samplers, augmentation, the prefetcher (counterpart of the numpy parts of
`dh3d_tpu.data`), and the on-device pair generation (`data.pairgen`)."""

from dh3d_tpu_torch.data import io
from dh3d_tpu_torch.data.datasets import (
    GlobalTestDataset,
    GlobalTrainTriplet,
    LocalTestDataset,
    LocalTrainSelfPair,
    collate_global,
    collate_local,
)
from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher

__all__ = ["GlobalTestDataset", "GlobalTrainTriplet", "LocalTestDataset",
           "LocalTrainSelfPair", "ThreadedPrefetcher", "collate_global",
           "collate_local", "io"]
