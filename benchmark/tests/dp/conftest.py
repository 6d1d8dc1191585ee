"""Sizes at which the benchmark's CPU tests run the data-parallel cell:
the `train_dp` driver's entry of `benchmark.tests.tiny.SHRINK`, set when
pytest collects this directory and whenever this package is imported
(as a run of every cell's driver in a fresh process imports it)."""

from benchmark.tests import tiny

# the configuration's and the traffic's keys set smaller: the 4 ranks of
# the cell on the CPU, 2 pairs of 512 points a rank
tiny.SHRINK.setdefault("train_dp", (
    {"num_points": 512, "batch_size": 8, "sampled_kpnum": 32},
    {"pool": 10, "calibrate": 2, "schedule": 16, "profile_units": 1}))
