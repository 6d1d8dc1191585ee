"""Sizes at which the benchmark's CPU tests run the stage-3 cell: the
`global_train` driver's entry of `benchmark.tests.tiny.SHRINK`, set when
pytest collects anything under `benchmark/` and whenever this module is
imported."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.tests import tiny  # noqa: E402

# the configuration's and the traffic's keys set smaller
tiny.SHRINK.setdefault("global_train", (
    {"num_points": 256},
    {"places": 24, "calibrate": 2, "profile_units": 1}))
