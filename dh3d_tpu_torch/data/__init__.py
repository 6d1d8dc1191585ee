"""Host-side data: point-cloud IO, normalisation and the eval loaders
(counterpart of the numpy parts of `dh3d_tpu.data`)."""

from dh3d_tpu_torch.data import io
from dh3d_tpu_torch.data.datasets import GlobalTestDataset, LocalTestDataset

__all__ = ["GlobalTestDataset", "LocalTestDataset", "io"]
