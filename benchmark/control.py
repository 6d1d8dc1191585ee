"""The readings a cell's limits of `correct` are set from, at the cell's own
size on the card, in one process:

  - the program's, over many seeds: set-up, a short window at the cell's
    own load (long enough to reach every sampled batch, step, query or
    file), the check;
  - the control's: the plain reference computed in TF32 (the precision
    below the configuration's f32 with TF32 off) in the program's place;
  - planted faults a driver offers (`fault_<name>()`: for training,
    `half`, each step on half of its pairs).

    python3 -m benchmark.control --workload NAME --program 1,2,3 \\
        --control 7,8,9 [--fault half --fault-seeds 4,5,6] [--seconds 3] \\
        [--out FILE]

Each reading is one JSON line (seed, kind, {check: value}) on stdout and,
with --out, in FILE.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

from benchmark import harness


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell: dict, seed: int, kind: str, seconds: float,
             device) -> dict:
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    t0 = time.perf_counter()
    run = driver.Run(cell, seed, device)
    if kind == "program":
        run.window(seconds)
    run.release()
    if kind == "program":
        checks = run.check()
    elif kind == "control":
        checks = run.control()
    else:
        checks = getattr(run, f"fault_{kind}")()
    del run
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    return {"workload": cell["name"], "seed": seed, "kind": kind,
            "seconds": time.perf_counter() - t0,
            "checks": {n: v for n, v, _ in checks},
            "limits": {n: lim for n, _, lim in checks}}


def main(argv=None):
    sys.pycache_prefix = os.path.join(harness.ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_devices(cell["entry"]["chips"])
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    plan = ([(s, "program") for s in seeds(args.program)]
            + [(s, "control") for s in seeds(args.control)]
            + [(s, args.fault) for s in seeds(args.fault_seeds)])
    for seed, kind in plan:
        line = json.dumps(readings(cell, seed, kind, args.seconds, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
