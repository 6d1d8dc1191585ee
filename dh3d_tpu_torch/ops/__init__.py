"""Point-cloud ops of the DH3D forward (counterpart of `dh3d_tpu.ops`).

Kernelled ops (CUDA kernel for CUDA tensors, plain PyTorch for CPU
tensors): `knn` (and `knn_bruteforce`, `knn_bruteforce_pairwise`,
`three_nn` on it; kernel G's launch plan `topk_plan` and its pre-pass
alone, `topk_prepass`), `farthest_point_sample` (launch
plan `fps_plan`), `weighted_sum` (and
`conv_pointset`, `three_interpolate` on it) with its backward
`weighted_sum_backward`, `flex_moments` (and `flex_conv` on it) with its
backward `flex_moments_backward`, `neighbor_max` (and `flex_pool`) with its
backward `neighbor_max_backward` (launch plan of the three forwards:
`row_plan`); `NeighborInverse` shares the CSR inverse those
backwards read among the ops over one neighbourhood.
"""

from dh3d_tpu_torch.ops.flex import (
    conv_pointset,
    flex_conv,
    flex_pool,
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
    topk_plan,
    topk_prepass,
)
from dh3d_tpu_torch.ops.morton import morton_codes, morton_perm
from dh3d_tpu_torch.ops.neighborhood import (
    NeighborInverse,
    flex_moments,
    flex_moments_backward,
    flex_moments_plain,
    flex_weights,
    inverse_neighbors,
    neighbor_max,
    neighbor_max_backward,
    neighbor_max_backward_plain,
    neighbor_max_plain,
    neighbor_max_with_slot,
    row_plan,
    weighted_sum,
    weighted_sum_backward,
    weighted_sum_backward_plain,
    weighted_sum_plain,
)
from dh3d_tpu_torch.ops.sampling import (
    farthest_point_sample,
    fps_plain,
    fps_plan,
    gather_point,
    subsample,
)

__all__ = [
    "NeighborInverse", "conv_pointset", "farthest_point_sample", "flex_conv",
    "flex_moments", "flex_moments_backward", "flex_moments_plain", "flex_pool",
    "flex_weights", "fps_plain", "fps_plan", "gather_neighbors", "gather_point",
    "group_point", "inverse_distance_weights", "inverse_neighbors", "knn",
    "knn_bruteforce", "knn_bruteforce_pairwise", "knn_plain", "topk_plan",
    "topk_prepass",
    "morton_codes", "morton_perm", "neighbor_max", "neighbor_max_backward",
    "neighbor_max_backward_plain", "neighbor_max_plain",
    "neighbor_max_with_slot", "row_plan", "subsample",
    "three_interpolate", "three_nn", "weighted_sum", "weighted_sum_backward",
    "weighted_sum_backward_plain", "weighted_sum_plain",
]
