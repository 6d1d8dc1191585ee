"""Point-cloud ops of the DH3D forward (counterpart of `dh3d_tpu.ops`).

Kernelled ops (CUDA kernel for CUDA tensors, plain PyTorch for CPU
tensors): `knn` (and `knn_bruteforce`, `knn_bruteforce_pairwise`,
`three_nn`, `knn_point` on it; kernel G's launch plan `topk_plan` and its
pre-pass alone, `topk_prepass`), `knn_window` (the legacy Morton-band
kNN, kernel H: `knn_bruteforce` and `three_nn` take it when given a
window; its band starts `win_start`, its launch plan `window_plan`),
`farthest_point_sample` (launch plan `fps_plan`), `weighted_sum` (and
`conv_pointset`, `flex_avg`, `three_interpolate` on it) with its backward
`weighted_sum_backward`,
`flex_moments` (and `flex_conv` on it) with its backward
`flex_moments_backward` (and `flex_deconv` on it), `neighbor_max` (and
`flex_pool`) with its backward `neighbor_max_backward` (launch plan of
the three forwards: `row_plan`), `radius_count` (the loader's outlier
removal, kernel I; launch plan `radius_plan`), `batch_norm_train`
(train-mode BatchNorm with an optional fused relu, kernel J, forward and
backward; plain `batch_norm_plain`, closed-form backward
`batch_norm_backward_plain`, launch plan `bn_plan`); `NeighborInverse` shares
the CSR inverse those backwards read among the ops over one
neighbourhood.  Plain
PyTorch, as in the JAX package: `group_point`, the ball queries,
`select_top_k`, `prob_sample`, the gathers and the Morton order.
"""

from dh3d_tpu_torch.ops.flex import (
    conv_pointset,
    flex_avg,
    flex_conv,
    flex_deconv,
    flex_pool,
    gather_neighbors,
)
from dh3d_tpu_torch.ops.interpolate import (
    inverse_distance_weights,
    three_interpolate,
    three_nn,
)
from dh3d_tpu_torch.ops.grouping import (
    group_point,
    knn_point,
    query_ball_point,
    query_ball_point2,
    select_top_k,
)
from dh3d_tpu_torch.ops.knn import (
    knn,
    knn_bruteforce,
    knn_bruteforce_pairwise,
    knn_plain,
    knn_window,
    knn_window_plain,
    topk_plan,
    topk_prepass,
    win_start,
    window_plan,
)
from dh3d_tpu_torch.ops.morton import morton_codes, morton_perm
from dh3d_tpu_torch.ops.neighborhood import (
    NeighborInverse,
    flex_moments,
    flex_moments_backward,
    flex_moments_backward_plain,
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
from dh3d_tpu_torch.ops.batchnorm import (
    batch_norm_backward_plain,
    batch_norm_plain,
    batch_norm_train,
    bn_plan,
)
from dh3d_tpu_torch.ops.radius import (
    radius_count,
    radius_count_plain,
    radius_plan,
)
from dh3d_tpu_torch.ops.sampling import (
    farthest_point_sample,
    fps_plain,
    fps_plan,
    gather_point,
    prob_sample,
    subsample,
)

__all__ = [
    "NeighborInverse", "batch_norm_backward_plain", "batch_norm_plain",
    "batch_norm_train", "bn_plan", "conv_pointset", "farthest_point_sample", "flex_avg",
    "flex_conv", "flex_deconv",
    "flex_moments", "flex_moments_backward",
    "flex_moments_backward_plain", "flex_moments_plain", "flex_pool",
    "flex_weights", "fps_plain", "fps_plan", "gather_neighbors", "gather_point",
    "group_point", "inverse_distance_weights", "inverse_neighbors", "knn",
    "knn_bruteforce", "knn_bruteforce_pairwise", "knn_plain", "knn_point",
    "knn_window", "knn_window_plain", "topk_plan", "topk_prepass",
    "morton_codes", "morton_perm", "neighbor_max", "neighbor_max_backward",
    "neighbor_max_backward_plain", "neighbor_max_plain",
    "neighbor_max_with_slot", "prob_sample", "query_ball_point",
    "query_ball_point2", "radius_count", "radius_count_plain", "radius_plan",
    "row_plan", "select_top_k", "subsample",
    "three_interpolate", "three_nn", "weighted_sum", "weighted_sum_backward",
    "weighted_sum_backward_plain", "weighted_sum_plain", "win_start",
    "window_plan",
]
