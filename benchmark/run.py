"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up (the kernel library built or reused in
`build/kernels/`, Python's bytecode in `build/pycache/`, the weights and the cell's inputs made on the card from
the seed, every shape of the window warmed up) is `setup_s`, counted from
the start of the process.  Then the closed loop runs for `--seconds` and
the cell's end-to-end metrics are taken (`--trace 0`), or its per-layer
metrics (`--trace 1`: spans over the same loop, then a short window under
the profiler).  Once the window has closed and the peak memory is read,
the program's state is freed and the plain reference checks what the
window produced.  The last line of stdout is one JSON object: correct,
attempted, failed, metrics, device (and with --trace 1 breakdown), and the
compared numbers beside their limits under "checks", which stderr's last
lines repeat.  With no CUDA device, or fewer than the cell asks for, it
exits 2 and prints no result; it exits 3, with no result, when a module of
JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Python's compiled modules (PyTorch's among them) cached in the checkout,
# at a fixed path: on a machine whose installation holds no usable
# bytecode, every run would otherwise compile ~1,900 modules again (~7 s)
sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "pycache")
sys.dont_write_bytecode = False

from benchmark import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    chips = cell["entry"]["chips"]
    harness.require_devices(chips)
    import torch

    harness.stamp("torch imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    torch.cuda.init()
    harness.stamp("CUDA initialised")
    from dh3d_tpu_torch import kernels

    kernels.library()
    harness.stamp("kernel library built or reused")
    run = driver.Run(cell, args.seed, device, trace=bool(args.trace))
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    harness.log(f"set-up {setup_s:.3f} s")

    win = run.window(args.seconds)
    harness.log(f"window: {win['units']} units in {win['seconds']:.3f} s, "
                f"{win['values']}")
    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"]}
    if args.trace:
        from benchmark import trace

        prof = trace.profile(run.unit, run.profile_units)
        peak = torch.cuda.max_memory_allocated(device)
        ctx = {"window": win, "profile": prof, "counts": run.counts(),
               "spans": run.spans(), "peak_bytes": peak}
        metrics = harness.per_layer(cell, ctx)
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}
    else:
        peak = torch.cuda.max_memory_allocated(device)
        metrics = {m["name"]: {"value": win["values"][
            cell["traffic"]["values"][m["name"]]], "unit": m["unit"]}
            for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        extra = {}
    foreign = harness.foreign_modules()
    if foreign:
        harness.log(f"benchmark: modules of JAX or of the JAX package are "
                    f"loaded: {foreign}. No result.")
        return 3
    run.release()
    checks = run.check()
    result["correct"] = all(v <= lim for _, v, lim in checks)
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        "count": chips, "memory_peak_bytes": peak, **extra}
    if args.trace:
        result["breakdown"] = prof["breakdown"]
    if harness.foreign_modules():
        harness.log("benchmark: the check loaded a module of JAX or of the "
                    "JAX package. No result.")
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
