"""Losses of the DH3D training curriculum (counterpart of
`dh3d_tpu.losses`)."""

from dh3d_tpu_torch.losses.losses import (  # noqa: F401
    BATCH_HARD_UPGRADE,
    DETECTION_LOSSES,
    GLOBAL_LOSSES,
    LOCAL_LOSSES,
    batch_hard_quadruplet_loss,
    batch_hard_triplet_loss,
    best_pos_distance,
    compute_total_loss,
    desc_local_loss,
    detection_ranks,
    lazy_quadruplet_loss,
    lazy_triplet_loss,
    local_detection_loss_nn,
    loss_inputs,
    pairwise_dist,
    pairwise_dist_cosine,
    pairwise_dist_matmul,
)
