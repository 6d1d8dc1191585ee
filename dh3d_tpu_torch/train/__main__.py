"""Training entry point of the port: the counterpart of the repository's
`train.py` (`train.py:110-236`).

    python -m dh3d_tpu_torch.train --cfg detection_config --synthetic \
        [--steps N] [--logdir DIR] [--load FLAX.npz] [--resume CKPT.pt] \
        [--seed S] [--set key=value ...] [--num_points N] [--batch_size B] \
        [--device cuda|cpu]

Writes `config.json` and `metrics.jsonl` into the logdir, prints the
metrics every 50 steps and at the last step, and saves a checkpoint every
`savemodel_every_k_steps` steps and at the end (`<logdir>/ckpt/`).  Only
synthetic batches so far (`--synthetic`); data loading is not ported.
`--device` defaults to cuda and raises when there is no CUDA device; the
CPU (the kernels' plain versions) runs only when asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch.nn.convert import load_npz, smart_init
from dh3d_tpu_torch.train import trainer
from dh3d_tpu_torch.train.synthetic import synthetic_batches


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m dh3d_tpu_torch.train")
    p.add_argument("--cfg", required=True,
                   help="basic_config | detection_config | global_config")
    p.add_argument("--logdir", default=None)
    p.add_argument("--load", default=None,
                   help="Flax .npz checkpoint for a warm start (partial "
                        "load by name and shape)")
    p.add_argument("--resume", default=None,
                   help="checkpoint .pt of this trainer for exact resume")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the model init and the synthetic batches")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any config key (JSON-parsed value)")
    return p.parse_args(argv)


def build_config(args):
    cfg = cfglib.get_config(args.cfg)
    for key in ("num_points", "batch_size"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            cfg[key] = json.loads(value)
        except json.JSONDecodeError:
            cfg[key] = value
        print(f"config override: {key} = {cfg[key]!r}")
    return cfg


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic:
        raise NotImplementedError(
            "data loading is not ported yet: run with --synthetic")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False (use --device cpu to train on the CPU)")
    cfg = build_config(args)
    trainer.check_config(cfg)

    logdir = args.logdir or os.path.join(
        "train_log", f"{args.cfg}_{time.strftime('%m%d-%H%M%S')}")
    os.makedirs(logdir, exist_ok=True)
    cfglib.save_config(cfg, os.path.join(logdir, "config.json"))

    state = trainer.init_state(cfg, args.seed, device)
    if args.resume:
        trainer.restore_state(args.resume, state)
        print(f"resumed at step {state.step} from {args.resume}")
    elif args.load:
        n = smart_init(state.model, load_npz(args.load))
        print(f"warm start: restored {n} tensors from {args.load}")
    print(f"device: {device}; logdir: {logdir}")

    batches = synthetic_batches(cfg, args.seed)
    step_fn = trainer.make_train_step(cfg)
    every = int(cfg.savemodel_every_k_steps or 0)
    t0 = time.time()
    start = state.step
    with open(os.path.join(logdir, "metrics.jsonl"), "a") as log:
        for i in range(start, start + args.steps):
            batch = trainer.to_device(next(batches), device)
            metrics = step_fn(state, batch)
            last = i == start + args.steps - 1
            if i % 50 == 0 or last:
                m = {k: round(float(v), 5) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = round(time.time() - t0, 1)
                print(f"step {i}: {json.dumps(m)}", flush=True)
                log.write(json.dumps(m) + "\n")
                log.flush()
            if (every and (i + 1) % every == 0) or last:
                path = trainer.save_checkpoint(
                    os.path.join(logdir, "ckpt"), state, i + 1)
                print(f"saved {path}", flush=True)


if __name__ == "__main__":
    main()
