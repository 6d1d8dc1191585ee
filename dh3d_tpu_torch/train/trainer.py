"""Training: the train step, curriculum freezing, the optimizer, and
checkpoints.

Counterpart of `dh3d_tpu/train/trainer.py:51-435`.  The reference trains
with Adam and a staircase exponential learning-rate decay, weight decay as
an L2 loss term over the Dense kernels only, and curriculum freezing of
whole module groups (`core/model.py:239-255`, `core/tf_utils.py:144-153`).
Semantics kept from the JAX trainer, which uses optax:
  - the schedule is read at the update count before the increment (step 0
    uses lr(0)); with warmup, the decay sees `step - warmup`
    (`optax.join_schedules`);
  - Adam (b1 0.9, b2 0.999, eps 1e-8) and the optional global-norm clip
    act on the trainable parameters only; frozen groups are outside the
    optimizer (`optax.multi_transform` with `set_to_zero`), so their Adam
    state does not advance and they are not in the clip norm.  Here they
    do not require grad at all;
  - a trainable parameter the loss does not reach gets a zero gradient and
    an Adam step (optax updates every leaf);
  - the clip is optax's: g unchanged when |g| < max, else g / |g| * max.
The step runs eagerly on whatever device the model lives on; on CUDA every
neighbourhood op and its backward is a hand-written kernel
(`ops/neighborhood.py`).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable

import torch
from torch import nn

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch.config import dotdict
from dh3d_tpu_torch.losses import compute_total_loss
from dh3d_tpu_torch.nn.convert import load_flax, load_npz
from dh3d_tpu_torch.nn.model import DH3D, frozen_groups

# config keys of the JAX trainer that this port does not run yet
_UNPORTED = ("device_pairgen", "augment_on_device", "remat",
             "cross_device_mining", "bn_axis_name")


def check_config(cfg) -> None:
    """Raise NotImplementedError for a config that asks for a part of the
    JAX trainer the port does not have."""
    for key in _UNPORTED:
        if cfg.get(key):
            raise NotImplementedError(f"{key}={cfg.get(key)!r} is not ported")
    if (cfg.compute_dtype or "float32") != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port trains in f32")


def lr_schedule(cfg) -> Callable[[int], float]:
    """step -> learning rate: start_lr * decay_rate ** floor(step /
    decay_step) (`optax.exponential_decay(staircase=True)`), after an
    optional linear warmup from 0 over `warmup_steps`."""
    start, steps, rate = cfg.start_lr, cfg.decay_step, cfg.decay_rate
    warmup = int(cfg.get("warmup_steps") or 0)

    def lr(step: int) -> float:
        if step < warmup:
            return (0.0 - start) * (1.0 - step / warmup) + start
        return start * rate ** ((step - warmup) // steps)

    return lr


def param_labels(cfg, model: nn.Module) -> dict:
    """{parameter name: "frozen" | "trainable"} by top-level module group
    (`trainer.py:79-92`)."""
    frozen = frozen_groups(cfg)
    return {name: "frozen" if name.split(".")[0] in frozen else "trainable"
            for name, _ in model.named_parameters()}


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Adam:
    """Adam over the trainable parameters; the frozen ones stop requiring
    grad.  The learning rate is set before every step from `lr_schedule`."""
    labels = param_labels(cfg, model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                            lr=cfg.start_lr, betas=(0.9, 0.999), eps=1e-8)


def kernel_l2(model: nn.Module) -> torch.Tensor:
    """Sum of squares of the Dense kernels (every nn.Linear weight,
    frozen ones included), the reference's '.*/W' regulariser; flex and
    pointset thetas, NetVLAD matrices and BN parameters are excluded
    (`trainer.py:113-122`)."""
    total = 0.0
    for m in model.modules():
        if isinstance(m, nn.Linear):
            total = total + torch.sum(m.weight * m.weight)
    return total


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer and the
    number of updates taken."""

    model: DH3D
    optimizer: torch.optim.Adam
    step: int = 0


def init_state(cfg, seed: int = 0, device="cpu") -> TrainState:
    """A fresh model (Flax initialisers, drawn from `seed`) on `device`
    and its optimizer."""
    check_config(cfg)
    torch.manual_seed(seed)
    model = DH3D(cfg).to(device)
    return TrainState(model, make_optimizer(cfg, model))


def to_device(batch: dict, device) -> dict:
    """A numpy batch (`train.synthetic`) as tensors on `device`: points
    and R f32, sample_inds int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.long() if k == "sample_inds" else t.float()
        out[k] = t.to(device).contiguous()
    return out


def forward_loss(model: DH3D, cfg, batch: dict):
    """The forward and the losses of one batch in the model's current mode
    (`trainer.py:147-211`).  Returns (total loss, metrics, outs)."""
    outs = model(batch["points"], sample_inds=batch.get("sample_inds"))
    if "R" in batch:
        outs["R"] = batch["R"]
    total, metrics = compute_total_loss(outs, cfg, kernel_l2(model))
    return total, metrics, outs


def apply_gradients(state: TrainState, cfg) -> None:
    """Clip (optax form), set the learning rate for this update count, take
    one Adam step, count it."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:  # unreached: a zero gradient, as optax sees it
            p.grad = torch.zeros_like(p)
    max_norm = cfg.get("grad_clip_norm")
    if max_norm:
        max_norm = float(max_norm)
        norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
        for p in params:
            p.grad.copy_(torch.where(norm < max_norm, p.grad,
                                     p.grad / norm * max_norm))
    lr = lr_schedule(cfg)(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def make_train_step(cfg):
    """train_step(state, batch) -> metrics: one forward in train mode, the
    losses, the backward and one optimizer update, in place on `state`.
    The metrics are detached scalar tensors (reading them syncs)."""
    check_config(cfg)
    cfg = dotdict(dict(cfg))

    def train_step(state: TrainState, batch: dict) -> dict:
        state.model.train()
        total, metrics, _ = forward_loss(state.model, cfg, batch)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        apply_gradients(state, cfg)
        return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    return train_step


# ------------------------------ checkpoints ------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: int | None = None) -> str:
    """Model (parameters and BN statistics), optimizer state and step, for
    exact resume, as `<ckpt_dir>/step_<step>.pt`."""
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, state: TrainState) -> TrainState:
    """Load a `save_checkpoint` file into `state` (same config), in place:
    parameters, BN statistics, optimizer state and step."""
    device = next(state.model.parameters()).device
    ck = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return state


def _latest_checkpoint(logdir: str) -> str:
    found = sorted(glob.glob(os.path.join(logdir, "ckpt", "step_*.pt")))
    if not found:
        raise FileNotFoundError(f"no checkpoint under {logdir}/ckpt")
    return found[-1]


def resolve_model(path: str):
    """A trained model from either surface: a training logdir of this port
    (config.json + ckpt/step_*.pt) or a packaged Flax `<stem>.npz` with its
    `<stem>.config.json` (`trainer.py:339-363`).  Returns (cfg, DH3D on the
    CPU, in eval mode)."""
    if path.endswith(".npz") or os.path.isfile(path + ".npz"):
        stem = path[:-4] if path.endswith(".npz") else path
        cfg = cfglib.load_config(stem + ".config.json")
        model = DH3D(cfg)
        load_flax(model, load_npz(stem + ".npz"))
    else:
        cfg = cfglib.load_config(os.path.join(path, "config.json"))
        model = DH3D(cfg)
        ck = torch.load(_latest_checkpoint(path), map_location="cpu",
                        weights_only=True)
        model.load_state_dict(ck["model"])
    return cfg, model.eval()

