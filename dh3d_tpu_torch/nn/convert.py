"""Carry Flax variables across into the port's modules.

A flat dict `{flax_path: np.ndarray}` (the layout of `models/*.npz`, written
by `scripts/package_checkpoint.py`: "params/<module path>/<name>",
"batch_stats/<module path>/<name>" and "step") becomes the state dict of a
`DH3D` module:
  - the collection prefix goes; the inner Flax BatchNorm scope "bn" goes
    (".../norm/bn/scale" -> "...norm.scale", ".../bn/mean" -> "...mean");
  - a Dense "kernel" [in, out] becomes nn.Linear "weight" [out, in];
  - every other array keeps its name and layout;
  - "step" is read and dropped.
`load_flax` is strict: an array the model does not take, a parameter no
array fills, or a shape mismatch raises.  `flax_from_state_dict` is the
inverse: a model's tensors as that flat dict (what the port's exporter,
`scripts/package_checkpoint.py`, writes).

A warm start (`train --load`) reads any of three inputs into a state dict
of the port's names (`warm_start_state_dict`): a Flax `<stem>.npz`, a
checkpoint `step_*.pt` of the port's trainer, or a training logdir of the
port (its newest `ckpt/step_*.pt`, `latest_checkpoint`).  `load_partial`
is its one partial-load rule, which `smart_init` (a Flax dict) and
`warm_start` (a path) share.
"""

from __future__ import annotations

import glob
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from dh3d_tpu_torch.nn.layers import BatchNorm

_IGNORED = ("step",)


def torch_name(flax_path: str) -> tuple[str, bool]:
    """Flax path -> (state-dict key, whether the array is transposed)."""
    parts = [p for p in flax_path.split("/")[1:] if p != "bn"]
    transpose = parts[-1] == "kernel"
    if transpose:
        parts[-1] = "weight"
    return ".".join(parts), transpose


def state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> dict:
    """{flax_path: array} -> {state-dict key: tensor} (no model needed)."""
    out = {}
    for path, arr in flat.items():
        if path in _IGNORED:
            continue
        if not path.startswith(("params/", "batch_stats/")):
            raise KeyError(f"unexpected array {path!r}")
        name, transpose = torch_name(path)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[name] = t.T.contiguous() if transpose else t
    return out


def flax_from_state_dict(model: nn.Module, step: int | None = None) -> dict:
    """The inverse of `state_dict_from_flax`: `model`'s parameters and
    buffers as {flax_path: f32 np.ndarray}, plus "step" as an int32
    scalar when `step` is given (the committed files hold int32).
      - parameters go under "params/", buffers under "batch_stats/";
      - a BatchNorm (found by its class, not its name) gets its Flax "bn"
        scope back: "...norm.scale" -> "params/.../norm/bn/scale",
        "...norm.mean" -> "batch_stats/.../norm/bn/mean";
      - an nn.Linear "weight" [out, in] becomes "kernel" [in, out];
      - every other tensor keeps its name and layout.
    Raises ValueError for a tensor the rule cannot name, one that
    `torch_name` would not map back to where it came from."""
    params = {name for name, _ in model.named_parameters()}
    flat = {}
    for name, t in model.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        collection = "params" if name in params else "batch_stats"
        path = owner.split(".") if owner else []
        if isinstance(module, BatchNorm):
            path.append("bn")
        elif collection == "batch_stats":
            raise ValueError(f"{name}: a buffer outside a BatchNorm")
        transpose = isinstance(module, nn.Linear) and leaf == "weight"
        path.append("kernel" if transpose else leaf)
        key = "/".join([collection, *path])
        if torch_name(key) != (name, transpose):
            raise ValueError(f"{name}: no Flax path maps back to it "
                             f"({key!r} reads as {torch_name(key)})")
        arr = t.detach().to("cpu", torch.float32)
        flat[key] = (arr.T if transpose else arr).contiguous().numpy()
    if step is not None:
        flat["step"] = np.asarray(step, np.int32)
    return flat


def load_flax(model: nn.Module, flat: Mapping[str, np.ndarray]) -> int:
    """Load `flat` into `model` (on whatever device it lives).  Every array
    must be consumed and every parameter and buffer filled; returns the
    number of arrays consumed (including "step")."""
    sd = state_dict_from_flax(flat)
    model.load_state_dict(sd, strict=True)
    return len(flat)


def load_npz(path: str) -> dict:
    """`models/<stem>.npz` -> {flax_path: np.ndarray}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def latest_checkpoint(logdir: str) -> str:
    """The newest `<logdir>/ckpt/step_*.pt` of the port's trainer (the
    step is zero-padded, so the names sort by step)."""
    found = sorted(glob.glob(os.path.join(logdir, "ckpt", "step_*.pt")))
    if not found:
        raise FileNotFoundError(f"no checkpoint under {logdir}/ckpt")
    return found[-1]


def warm_start_state_dict(path: str) -> dict:
    """A warm start's tensors, by the port's state-dict names, on the CPU,
    from a Flax `<stem>.npz` (`state_dict_from_flax`), a checkpoint `.pt`
    of the port's trainer (its "model" entry) or a training logdir of the
    port (its newest checkpoint).  Raises ValueError for anything else."""
    if os.path.isdir(path):
        path = latest_checkpoint(path)
    if path.endswith(".npz") and os.path.isfile(path):
        return state_dict_from_flax(load_npz(path))
    if path.endswith(".pt") and os.path.isfile(path):
        ck = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(ck, dict) and isinstance(ck.get("model"), dict):
            return ck["model"]
    raise ValueError(
        f"cannot warm-start from {path!r}: give a Flax <stem>.npz, a "
        "checkpoint step_*.pt of this port's trainer, or its training "
        "logdir (config.json + ckpt/step_*.pt)")


def load_partial(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
                 ) -> int:
    """Partial load, the SmartInit(ignore_mismatch=True) warm start of the
    curriculum (`trainer.py:281-306`): every tensor whose name the model
    has, with the same shape, is loaded; the others are skipped and the
    model keeps its own values there.  Parameters and BN statistics both
    load, as the reference's SmartInit restores every variable.  Returns
    the number of tensors loaded."""
    own = model.state_dict()
    take = {name: t for name, t in state_dict.items()
            if name in own and own[name].shape == t.shape}
    model.load_state_dict(take, strict=False)
    return len(take)


def smart_init(model: nn.Module, flat: Mapping[str, np.ndarray]) -> int:
    """`load_partial` of a Flax dict {flax_path: array}."""
    return load_partial(model, state_dict_from_flax(flat))


def warm_start(model: nn.Module, path: str) -> int:
    """`load_partial` of `warm_start_state_dict(path)`: the model only,
    never an optimizer state or a step."""
    return load_partial(model, warm_start_state_dict(path))
