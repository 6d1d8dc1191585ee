from dh3d_tpu_torch.utils import transforms  # noqa: F401
