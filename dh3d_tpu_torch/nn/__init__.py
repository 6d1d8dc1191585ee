from dh3d_tpu_torch.nn.convert import (flax_from_state_dict, load_flax,
                                       load_npz, smart_init)
from dh3d_tpu_torch.nn.model import DH3D, concat_tuple_clouds

__all__ = ["DH3D", "concat_tuple_clouds", "flax_from_state_dict",
           "load_flax", "load_npz", "smart_init"]
