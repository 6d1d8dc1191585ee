"""The port's extraction CLIs, counterparts of the repository's
`evaluate/localdesc_extract.py` and `evaluate/globaldesc_extract.py`:

    python -m dh3d_tpu_torch.evaluate.localdesc_extract --ModelPath ... \
        --pcdpath ... [--perform_nms] [--device cuda|cpu]
    python -m dh3d_tpu_torch.evaluate.globaldesc_extract --ModelPath ... \
        --pcdpath ... --ref_gt_file ... --query_gt_file ... [--eval_recall]
"""

import torch


def eval_device(name: str) -> torch.device:
    """The torch device named by `--device`; exits with an error when it is
    a CUDA device and there is none (the CPU runs only when asked for)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}, but torch.cuda.is_available() is "
                         "False (use --device cpu to run on the CPU)")
    return device
