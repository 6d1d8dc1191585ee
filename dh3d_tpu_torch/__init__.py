"""DH3D in PyTorch for NVIDIA Hopper (H100).

The JAX package `dh3d_tpu` is the reference this port is held to; it is
never imported here.  Layout mirrors `dh3d_tpu`: `ops` (kNN, FPS, Morton
order, the flex-conv family and interpolation, each kernelled op with its
plain PyTorch version beside the CUDA kernel's wrapper), `nn` (layers,
backbones, the DH3D eval forward, the Flax-checkpoint converter), `eval`
(the extraction forward), `parallel` (data parallelism over
`torch.distributed`) and `entry` (the main-path model and inputs, and the
multi-process dry run).

Tensors are channel-last `[B, N, C]`, float32, with int64 indices.  A
kernelled op takes its plain version only for CPU tensors; on CUDA tensors
it launches its kernel (built from `csrc/` at first use, see `kernels.py`)
or raises.
"""

from dh3d_tpu_torch import config
from dh3d_tpu_torch.config import dotdict, get_config, load_config

__all__ = ["config", "dotdict", "get_config", "load_config"]
