"""The benchmark's cells shrunk to a size the CPU tests can hold: the same
files, drivers and reference, fewer and smaller clouds."""

from __future__ import annotations

import importlib
import os

import torch

from benchmark import harness

CPU = torch.device("cpu")

# the relocalisation cell, held out of BENCHMARK.json (its runs spread too
# widely, PERF.md section 7) and kept ready: its files are tested as a
# cell's are
SPARE = [{"name": "full_query_b1", "config": "dh3d_full",
          "traffic": "relocalise_map400", "chips": 1,
          "why": "one vehicle relocalising against a 400-submap map"}]


def spec_with_spare() -> dict:
    spec = harness.load_spec()
    spec["workloads"] = spec["workloads"] + SPARE
    return spec


CELLS = [w["name"] for w in spec_with_spare()["workloads"]]

# per driver: the configuration's and the traffic's keys set smaller
SHRINK = {
    "extract": ({"num_points": 512},
                {"batch": 2, "pool": 6, "calibrate": 2, "schedule": 16,
                 "sample_from": 3, "check_batches": 2, "profile_units": 1}),
    "train": ({"num_points": 512, "batch_size": 2, "sampled_kpnum": 32},
              {"pool": 8, "calibrate": 2, "schedule": 16,
               "profile_units": 1}),
    "query": ({"num_points": 512},
              {"map": 6, "places": 3, "map_batch": 3, "calibrate": 2,
               "check_queries": 2, "sample_from": 3, "scan_extent": 8.0,
               "nms": {"radius": 2.0, "min_ratio": 0.01, "max_kp": 32},
               "ransac_iters": 50, "profile_units": 1}),
    "raw_extract": ({}, {"scans": 4, "raw_points": 3000, "points": 1024,
                         "scan_extent": 8.0, "calibrate": 1,
                         "check_clouds": 2, "sample_from": 3,
                         "profile_units": 1}),
}


# limits of the shrunk cells that differ from the full cells' (set from
# the card's readings): at 2 pairs and 32 anchors one detection-loss
# choice (a hardest negative, the rank of a match) that rounding flips
# moves a leaf's gradient by ~1e-3 of its norm, where 10 pairs and 512
# anchors average it away
TINY_LIMITS = {}


def tiny_cell(name: str, spec=None, bench_dir=harness.BENCH_DIR) -> dict:
    cell = harness.load_cell(name, spec or spec_with_spare(), bench_dir)
    driver = cell["traffic"]["driver"]
    cfg_over, traffic_over = SHRINK[driver]
    cell["cfg"].update(cfg_over)
    cell["traffic"].update(traffic_over)
    for k, v in TINY_LIMITS.get(driver, {}).items():
        cell["limits"][k] = {"limit": v}
    return cell


def driver(cell):
    return importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")


def run_cell(cell, seed: int = 7, seconds: float = 0.5, tmp=None):
    """(the window's outcome, the checks) of one run of `cell` on the CPU
    with the reference's check; `tmp` is $TMPDIR for the drivers that
    write files."""
    if tmp is not None:
        os.environ["TMPDIR"] = str(tmp)
    run = driver(cell).Run(cell, seed, CPU)
    win = run.window(seconds)
    run.release()
    return win, run.check()


def correct(checks) -> bool:
    return all(v <= lim for _, v, lim in checks)
