from dh3d_tpu_torch.nn.convert import load_flax, load_npz, smart_init
from dh3d_tpu_torch.nn.model import DH3D

__all__ = ["DH3D", "load_flax", "load_npz", "smart_init"]
