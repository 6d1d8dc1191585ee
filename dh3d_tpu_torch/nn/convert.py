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
array fills, or a shape mismatch raises.  `smart_init` is the partial load
of a warm start.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

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


def smart_init(model: nn.Module, flat: Mapping[str, np.ndarray]) -> int:
    """Partial load, the SmartInit(ignore_mismatch=True) warm start of the
    curriculum (`trainer.py:281-306`): every array of `flat` whose name the
    model has, with the same shape, is loaded; the others are skipped and
    the model keeps its own values there.  Parameters and BN statistics
    both load, as the reference's SmartInit restores every variable.
    Returns the number of arrays loaded."""
    own = model.state_dict()
    take = {name: t for name, t in state_dict_from_flax(flat).items()
            if name in own and own[name].shape == t.shape}
    model.load_state_dict(take, strict=False)
    return len(take)
