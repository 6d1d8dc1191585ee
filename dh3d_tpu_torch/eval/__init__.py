from dh3d_tpu_torch.eval.extract import (
    extract_global,
    extract_local,
    local_result_rows,
    make_forward,
)
from dh3d_tpu_torch.eval.nms import (
    device_nms,
    nms_keypoint_indices,
    single_nms,
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
    "average_recalls", "compute_tp_fp", "device_nms", "evaluate_sequences",
    "extract_global", "extract_local", "is_gt_match_2d", "load_sets_from_dir",
    "local_result_rows", "make_forward", "nms_keypoint_indices", "retrieve",
    "single_nms",
]
