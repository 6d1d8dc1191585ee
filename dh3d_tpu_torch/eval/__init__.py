from dh3d_tpu_torch.eval.extract import (
    extract_global,
    extract_local,
    local_result_rows,
    make_forward,
)
from dh3d_tpu_torch.eval.matlab_extras import (
    find_point_normals,
    prec_rec,
)
from dh3d_tpu_torch.eval.nms import (
    device_nms,
    nms_keypoint_indices,
    single_nms,
)
from dh3d_tpu_torch.eval.registration import (
    RansacResult,
    match_descriptors_mutual,
    ransac_rigid,
    register_clouds,
    registration_success,
)
from dh3d_tpu_torch.eval.repeatability import (
    keypoint_repeatability,
    repeatability_curve,
    top_k_keypoints,
)
from dh3d_tpu_torch.eval.retrieval import (
    average_recalls,
    compute_tp_fp,
    evaluate_sequences,
    is_gt_match_2d,
    load_sets_from_dir,
    retrieve,
)

__all__ = [
    "RansacResult", "average_recalls", "compute_tp_fp", "device_nms",
    "evaluate_sequences", "extract_global", "extract_local",
    "find_point_normals", "is_gt_match_2d", "keypoint_repeatability",
    "load_sets_from_dir", "local_result_rows", "make_forward",
    "match_descriptors_mutual", "nms_keypoint_indices", "prec_rec",
    "ransac_rigid", "register_clouds", "registration_success",
    "repeatability_curve", "retrieve", "single_nms", "top_k_keypoints",
]
