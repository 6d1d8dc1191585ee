"""The benchmark's own tests: `python -m pytest benchmark/tests -q` on the
CPU; the tests marked `cuda` (the control at the cells' own size) run only
where torch sees a card and skip elsewhere, deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the benchmark's control "
        "at a cell's own size)")
