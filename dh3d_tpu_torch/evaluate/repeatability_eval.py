"""Keypoint relative-repeatability CLI of the port: the counterpart of the
repository's `evaluate/repeatability_eval.py`, the metric behind
BASELINE.md rows 1-5 and the paper's Fig. 4.

    python -m dh3d_tpu_torch.evaluate.repeatability_eval --model PATH \
        --pcdpath DIR [--num_points 4096] [--max_clouds 10] \
        [--protocol both|self|overlap] [--device cuda]

Loads a detector model (a logdir of the port's trainer, or a packaged
Flax `<stem>.npz` with its `<stem>.config.json`), runs the forward on the
device over the *.bin clouds under --pcdpath, and prints the relative
repeatability at K in {32, 64, 128, 256, 512} under two protocols:
  self-pair        each cloud against a jittered rigid copy;
  partial-overlap  two half-space crops of each cloud, resampled and
                   rigidly separated, scored with the known pose.
--device defaults to cuda and exits with an error when there is no CUDA
device.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dh3d_tpu_torch.data.io import get_fixednum_pcd, load_single_pcfile
from dh3d_tpu_torch.eval.extract import make_forward
from dh3d_tpu_torch.eval.repeatability import (
    make_partial_overlap_pairs,
    repeatability_curve,
    repeatability_curve_pairs,
)
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.train import resolve_model


def build_extract_fn(model_path, num_points, device):
    """extract_fn(cloud [N, 3]) -> (xyz [N, 3], attention [N]), tensors on
    `device`.  Refuses a model without a detector."""
    cfg, model = resolve_model(model_path)
    cfg.num_points = num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = False
    if not cfg.detection:
        raise SystemExit(
            f"{model_path} has no detector (cfg.detection is falsy): "
            "repeatability needs per-point attention")
    # eval clouds are not presorted: make_forward turns morton_presorted off
    fwd = make_forward(cfg, model.to(device))

    def extract_fn(cloud):
        outs = fwd(np.asarray(cloud, np.float32)[None])
        return outs["xyz"][0], outs["attention"][0].reshape(-1)

    return extract_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.repeatability_eval")
    p.add_argument("--model", required=True,
                   help="detection model: logdir, or Flax <stem>[.npz]")
    p.add_argument("--pcdpath", required=True,
                   help="directory searched recursively for *.bin clouds")
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--max_clouds", type=int, default=10)
    p.add_argument("--protocol", default="both",
                   choices=["both", "self", "overlap"])
    p.add_argument("--radius", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"clouds": n} and, per protocol run,
    {"self-pair" | "partial-overlap": {K: repeatability}}."""
    args = parse_args(argv)
    device = eval_device(args.device)
    files = sorted(
        glob.glob(os.path.join(args.pcdpath, "**", "*.bin"),
                  recursive=True))[: args.max_clouds]
    if not files:
        raise SystemExit(f"no *.bin clouds under {args.pcdpath}")
    extract_fn = build_extract_fn(args.model, args.num_points, device)

    rng = np.random.RandomState(args.seed)
    raw = [load_single_pcfile(f)[:, :3] for f in files]
    clouds = []
    for c in raw:
        pc, _ = get_fixednum_pcd(c, args.num_points, randsample=True,
                                 need_downsample=False, sortby_dis=False,
                                 rng=rng)
        clouds.append(pc.astype(np.float32))

    def show(name, curve):
        ks = sorted(curve)
        print(f"{name}: " + "  ".join(f"K={k}: {curve[k]:.4f}" for k in ks))
        summary[name] = curve

    summary = {"clouds": len(files)}
    if args.protocol in ("both", "self"):
        show("self-pair", repeatability_curve(
            extract_fn, clouds, radius=args.radius, seed=args.seed,
            device=device))
    if args.protocol in ("both", "overlap"):
        pairs = make_partial_overlap_pairs(
            raw, numpts=args.num_points, seed=args.seed)
        show("partial-overlap", repeatability_curve_pairs(
            extract_fn, pairs, radius=args.radius, device=device))
    return summary


if __name__ == "__main__":
    main()
