"""What every cell shares: the spec, the cell's files, seeds, the device
line, the look for foreign modules, the per-layer metrics and the result.

A cell is found by name: `BENCHMARK.json` names its configuration
(`configs/<config>.json`: the model's keys under "config") and its traffic
(`traffic/<traffic>.json`: the driver that runs it under "driver" and the
driver's parameters); its correctness limits are `limits/<workload>.json`.
A per-layer metric is `metrics/<name>.json`, which names a reader
(`readers/<reader>.py`, a function `read(ctx, **params)`) and its
parameters.  A later cell, traffic mix or metric is new files of these
kinds and new entries in `BENCHMARK.json`.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
import zlib

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FOREIGN = ("jax", "jaxlib", "flax", "dh3d_tpu")  # top-level names, whole
IMPORTED = time.perf_counter()


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def stamp(what: str):
    """Log `what` with the seconds since this module was imported (the
    start of a run): where set-up spends its time."""
    log(f"[{time.perf_counter() - IMPORTED:8.3f} s] {what}")


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return read_json(root, "BENCHMARK.json")


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, spec: dict | None = None,
              bench_dir: str = BENCH_DIR) -> dict:
    """The cell `name`: its BENCHMARK.json entry, the configuration file's
    model keys (`cfg`), the traffic file (`traffic`), its limits and the
    metrics it reports (`end_to_end`, `per_layer`: BENCHMARK.json's
    entries)."""
    spec = spec or load_spec(os.path.dirname(bench_dir))
    w = find(spec["workloads"], name, "workload")
    conf = find(spec["configs"], w["config"], "config")
    cfg = read_json(os.path.dirname(bench_dir), conf["file"])["config"]
    traffic = read_json(bench_dir, "traffic", w["traffic"] + ".json")
    limits = read_json(bench_dir, "limits", name + ".json")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"name": name, "entry": w, "cfg": cfg, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": layer}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (`tag`) of a run's draws: the same
    `seed` and tag give the same stream, any seed up to 2**64 is taken."""
    ss = np.random.SeedSequence([seed % 2 ** 64, zlib.crc32(tag.encode())])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def require_devices(chips: int):
    """Exit 2, printing no result, unless torch sees `chips` CUDA devices:
    a measuring run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: this cell needs {chips} CUDA device(s); torch sees "
            f"{n} (torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}). No result.")
        sys.exit(2)


def foreign_modules() -> list:
    """Loaded modules whose top-level name is one of FOREIGN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FOREIGN})


def per_layer(cell: dict, ctx: dict, bench_dir: str = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for m in cell["per_layer"]:
        entry = read_json(bench_dir, "metrics", m["name"] + ".json")
        params = {k: v for k, v in entry.items() if k != "reader"}
        reader = importlib.import_module(f"benchmark.readers.{entry['reader']}")
        value = reader.read(ctx, **params)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check_lines(checks: list) -> dict:
    """[(name, value, limit)] -> {name: {"value", "limit"}}."""
    return {n: {"value": v, "limit": lim} for n, v, lim in checks}


def emit(result: dict, checks: list) -> None:
    """Each compared number beside its limit as the last lines of stderr,
    then the result as the last line of stdout, the checks under the last
    key."""
    for n, v, lim in checks:
        log(f"check {n} = {v!r}  limit {lim!r}  "
            f"{'ok' if v <= lim else 'FAILED'}")
    result = {**result, "checks": check_lines(checks)}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
