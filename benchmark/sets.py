"""Two sets of runs of one cell, each run its own process, and the spread
of every metric: what a cell's bounds are set from.

    python3 -m benchmark.sets --workload NAME --seeds 11,12,13,14,15,16 \\
        [--sets 2] [--trace-seeds 21,22,23] [--out DIR]

Each set runs the cell once a seed, at BENCHMARK.json's run_seconds; the
second set repeats the first's seeds.  Then the traced runs.  A run's
stdout and stderr are kept as DIR/<workload>__<set>__<i>__<seed>.out and
.err.  Printed for each set: every run's correct, failed and metrics, and
each metric's median and spread, (q3 - q1) / median with the quartiles of
`statistics.quantiles(values, n=4)`; `setup_s` leaves out the first run
of the first set, which may build the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from benchmark import harness
from benchmark.timing import spread


def run(workload, seed, seconds, trace, stem) -> dict | None:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
        rc = subprocess.run(cmd, stdout=out, stderr=err,
                            cwd=harness.ROOT).returncode
    lines = open(stem + ".out").read().strip().splitlines()
    if rc != 0 or not lines:
        print(f"{os.path.basename(stem)}: rc {rc}, no result", flush=True)
        return None
    return json.loads(lines[-1])


def summary(name, results, first_set: bool):
    ok = [r for r in results if r]
    print(f"== {name}: {len(ok)} of {len(results)} runs, correct "
          f"{[r['correct'] for r in ok]}, failed {[r['failed'] for r in ok]}")
    for m in ok[0]["metrics"] if ok else []:
        v = [r["metrics"][m]["value"] for r in ok]
        vv = v[1:] if m == "setup_s" and first_set else v
        line = f"   {m}: {v}"
        if len(vv) >= 2:
            line += (f"  median {statistics.median(vv):.6g}"
                     f"  spread {100 * spread(vv):.3f}%")
        print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sets"))
    args = ap.parse_args(argv)
    seconds = harness.load_spec()["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k in range(args.sets):
        results = [run(args.workload, s, seconds, 0, os.path.join(
            args.out, f"{args.workload}__{'AB'[k] if k < 2 else k}__{i}__{s}"))
            for i, s in enumerate(seeds, 1)]
        summary(f"{args.workload} set {k + 1}", results, k == 0)
    trace = [int(s) for s in args.trace_seeds.split(",") if s]
    results = [run(args.workload, s, seconds, 1, os.path.join(
        args.out, f"{args.workload}__T__{i}__{s}"))
        for i, s in enumerate(trace, 1)]
    if results:
        summary(f"{args.workload} traced", results, False)


if __name__ == "__main__":
    main()
