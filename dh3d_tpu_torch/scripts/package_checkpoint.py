"""Export a checkpoint of the port's trainer as a Flax `<stem>.npz`.

The counterpart of the repository's `scripts/package_checkpoint.py`: the
model's parameters and BN statistics, flattened under their Flax names and
layouts (`nn.convert.flax_from_state_dict`), f32, with the step as int32,
into one compressed npz; for a logdir, its `config.json` beside it as
`<stem>.config.json`.  The JAX package reads the pair with
`dh3d_tpu.train.resolve_model(stem)` (or `load_npz_checkpoint`), the port
with `train.resolve_model(stem)` or `train --load STEM.npz`.

    python -m dh3d_tpu_torch.scripts.package_checkpoint \
        --ckpt /tmp/curriculum/seed0/stage3 --out models/my_stage3

`--ckpt` takes a training logdir of the port (config.json + ckpt/; its
newest `step_*.pt`) or one `step_*.pt`, whose config is the `config.json`
two levels up (`<logdir>/ckpt/step_*.pt`); a `.pt` without one there is
refused.  The model is built on the CPU: export moves tensors and runs
nothing, so it needs no card and takes no `--device`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch.nn.convert import flax_from_state_dict, latest_checkpoint
from dh3d_tpu_torch.nn.model import DH3D


def checkpoint_paths(path: str) -> tuple[str, str, bool]:
    """(the checkpoint `.pt`, its config.json, whether `path` is a
    logdir).  Raises ValueError for anything but a logdir or a
    `step_*.pt` with a config.json two levels up."""
    if os.path.isdir(path):
        return (latest_checkpoint(path), os.path.join(path, "config.json"),
                True)
    if path.endswith(".pt") and os.path.isfile(path):
        cfg_json = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(path))), "config.json")
        if os.path.isfile(cfg_json):
            return path, cfg_json, False
        raise ValueError(f"{path}: no config.json two levels up "
                         f"({cfg_json}) to build its model from")
    raise ValueError(f"cannot export {path!r}: give a training logdir of "
                     "the port (config.json + ckpt/step_*.pt) or one of "
                     "its step_*.pt")


def export(path: str, out: str) -> dict:
    """Write `<out>.npz` (and, for a logdir, `<out>.config.json`) from the
    checkpoint at `path`.  Returns the flat dict written."""
    ckpt, cfg_json, is_logdir = checkpoint_paths(path)
    model = DH3D(cfglib.load_config(cfg_json))
    ck = torch.load(ckpt, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["model"])
    flat = flax_from_state_dict(model, step=int(ck["step"]))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out + ".npz", **flat)
    if is_logdir:
        with open(cfg_json) as f:
            cfg = json.load(f)
        with open(out + ".config.json", "w") as f:
            json.dump(cfg, f, indent=2)
    return flat


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.scripts.package_checkpoint")
    ap.add_argument("--ckpt", required=True,
                    help="training logdir (config.json + ckpt/) or one "
                         "ckpt/step_*.pt of it")
    ap.add_argument("--out", required=True, help="output path stem")
    args = ap.parse_args(argv)
    flat = export(args.ckpt, args.out)
    n_params = sum(v.size for k, v in flat.items()
                   if k.startswith("params/"))
    print(f"{args.out}.npz: {n_params:,} params, "
          f"{os.path.getsize(args.out + '.npz') / 1e6:.1f} MB "
          f"(step {int(flat['step'])})")
    return flat


if __name__ == "__main__":
    main()
