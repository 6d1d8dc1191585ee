"""The three-stage training curriculum, run by the port's trainer.

The counterpart of the repository's `scripts/train_demo_curriculum.py`:
the reference's curriculum (local -> local + detector -> global with the
backbone frozen) on the `.bin` scans and GT pickles of `--pool`, with
fixed seeds, the Morton order, the presorted clouds and the self pairs
built in the step (stages 1-2), and a linear learning-rate warmup on stage
3.  For each seed:

    stage 1  basic_config      2000 steps  (local descriptor loss)
    stage 2  detection_config  2000 steps  (+ detector loss, warm start
                                            from stage 1)
    stage 3  global_config     1500 steps  (NetVLAD, backbone frozen,
                                            warm start from stage 2,
                                            warmup 300)

Each stage is `python -m dh3d_tpu_torch.train` run in this process
(`train.__main__.main`) with the flags the JAX script gives `train.py`;
`--load` is the previous stage's logdir (its newest `ckpt/step_*.pt`).
Outputs land in `<out>/seed<k>/stage{1,2,3}/` (config.json,
metrics.jsonl, ckpt/step_*.pt); export one with
`python -m dh3d_tpu_torch.scripts.package_checkpoint`.

A stage whose logdir exists is skipped, as in the JAX script; the test is
the directory alone, so a stage that died half-way is skipped too (delete
its logdir to run it again).  The defaults `--pool /tmp/demo_pool` and
`--out /tmp/curriculum` are the JAX script's: fixed paths that every
checkout on a machine shares, so two runs left at the defaults read and
write the same stages, and one skips what the other wrote.  Give each
concurrent run its own `--out`.

    python -m dh3d_tpu_torch.scripts.train_demo_curriculum \
        --pool /tmp/demo_pool --out /tmp/curriculum --seeds 0 1 2

Two flags the JAX script lacks, both passed through to every stage:
`--device` (cuda by default; raises when there is no CUDA device, the CPU
runs only when asked for) and a repeated `--set KEY=VALUE` (e.g. a small
`num_points` and `batch_size` for a run on the CPU).  `main` returns
{"seed<k>/stage<n>": the stage's summary, or None for a skipped stage}.
"""

from __future__ import annotations

import argparse
import os

from dh3d_tpu_torch.nn.convert import latest_checkpoint
from dh3d_tpu_torch.train.trainer import require_device
from dh3d_tpu_torch.train.__main__ import main as train_main

# stages 1-2: local self-pair training; the loader Z-order-sorts the raw
# copies and the step builds the pairs
LOCAL = ["--device_pairgen", "--set", "morton_presorted=true"]
# stage 3: global tuples from the host loader (presorted); the warmup
# softens the fresh NetVLAD head's hinge gradients
GLOBAL = ["--set", "morton_presorted=true", "--set", "warmup_steps=300"]


def stage_argv(cfg, logdir, steps, seed, pool, extra, device, sets):
    """The argv of one stage: the JAX script's `train.py` flags, then
    `--device` and the pass-through `--set`s."""
    argv = ["--cfg", cfg, "--logdir", logdir, "--steps", str(steps),
            "--seed", str(seed), "--data_basedir", pool,
            "--set", "morton_order=true", *extra, "--device", device]
    for kv in sets:
        argv += ["--set", kv]
    return argv


def run_stage(argv):
    print("::", " ".join(["python -m dh3d_tpu_torch.train", *argv]),
          flush=True)
    return train_main(argv)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.scripts.train_demo_curriculum")
    ap.add_argument("--pool", default="/tmp/demo_pool")
    ap.add_argument("--out", default="/tmp/curriculum",
                    help="shared by every run left at the default: give "
                         "concurrent runs their own")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, nargs=3, default=[2000, 2000, 1500],
                    metavar=("S1", "S2", "S3"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override passed to every stage")
    args = ap.parse_args(argv)
    require_device(args.device)

    summaries = {}
    for seed in args.seeds:
        base = os.path.join(args.out, f"seed{seed}")
        stages = (
            ("basic_config", LOCAL, None),
            ("detection_config", LOCAL, 1),
            ("global_config", GLOBAL, 2),
        )
        for n, (cfg, extra, load_from) in enumerate(stages, start=1):
            logdir = os.path.join(base, f"stage{n}")
            key = f"seed{seed}/stage{n}"
            summaries[key] = None
            if os.path.isdir(logdir):
                continue
            if load_from:
                extra = extra + ["--load",
                                 os.path.join(base, f"stage{load_from}")]
            summaries[key] = run_stage(stage_argv(
                cfg, logdir, args.steps[n - 1], seed, args.pool, extra,
                args.device, args.set))
        print(f"seed {seed} done: "
              f"{latest_checkpoint(os.path.join(base, 'stage3'))}",
              flush=True)
    return summaries


if __name__ == "__main__":
    main()
