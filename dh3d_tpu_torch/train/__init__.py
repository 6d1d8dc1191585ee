"""Training (counterpart of `dh3d_tpu.train`): the trainer, checkpoints,
the synthetic batches and the batches from disk (`train.data`).
`python -m dh3d_tpu_torch.train` runs it."""

from dh3d_tpu_torch.train.synthetic import (  # noqa: F401
    synthetic_batches,
    synthetic_global_batches,
    synthetic_local_batches,
)
from dh3d_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    add_draws,
    apply_gradients,
    check_config,
    forward_loss,
    init_state,
    kernel_l2,
    lr_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
    param_labels,
    prepare_batch,
    require_device,
    resolve_model,
    restore_state,
    save_checkpoint,
    to_device,
)
