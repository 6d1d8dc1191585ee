"""Point-cloud ops of the DH3D forward (counterpart of `dh3d_tpu.ops`).

Kernelled ops (CUDA kernel for CUDA tensors, plain PyTorch for CPU
tensors): `knn` (and `knn_bruteforce`, `knn_bruteforce_pairwise`,
`three_nn` on it), `farthest_point_sample`, `weighted_sum` (and
`flex_conv`, `conv_pointset`, `three_interpolate` on it) with its backward
`weighted_sum_backward`, `neighbor_max` (and `flex_pool`) with its backward
`neighbor_max_backward`.
"""

from dh3d_tpu_torch.ops.flex import (
    conv_pointset,
    flex_conv,
    flex_pool,
    flex_weights,
    gather_neighbors,
)
from dh3d_tpu_torch.ops.interpolate import (
    inverse_distance_weights,
    three_interpolate,
    three_nn,
)
from dh3d_tpu_torch.ops.grouping import group_point
from dh3d_tpu_torch.ops.knn import (
    knn,
    knn_bruteforce,
    knn_bruteforce_pairwise,
    knn_plain,
)
from dh3d_tpu_torch.ops.morton import morton_codes, morton_perm
from dh3d_tpu_torch.ops.neighborhood import (
    inverse_neighbors,
    neighbor_max,
    neighbor_max_backward,
    neighbor_max_backward_plain,
    neighbor_max_plain,
    neighbor_max_with_slot,
    weighted_sum,
    weighted_sum_backward,
    weighted_sum_backward_plain,
    weighted_sum_plain,
)
from dh3d_tpu_torch.ops.sampling import (
    farthest_point_sample,
    fps_plain,
    gather_point,
    subsample,
)

__all__ = [
    "conv_pointset", "farthest_point_sample", "flex_conv", "flex_pool",
    "flex_weights", "fps_plain", "gather_neighbors", "gather_point",
    "group_point", "inverse_distance_weights", "inverse_neighbors", "knn",
    "knn_bruteforce", "knn_bruteforce_pairwise", "knn_plain",
    "morton_codes", "morton_perm", "neighbor_max", "neighbor_max_backward",
    "neighbor_max_backward_plain", "neighbor_max_plain",
    "neighbor_max_with_slot", "subsample",
    "three_interpolate", "three_nn", "weighted_sum", "weighted_sum_backward",
    "weighted_sum_backward_plain", "weighted_sum_plain",
]
