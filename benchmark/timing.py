"""Device time between CUDA events, and the statistics the harness reports.

The event arithmetic is a frozen copy of `dh3d_tpu_torch/bench.py`'s
`time_calls`: an event recorded before and after each timed call, one
synchronize once the calls have run, `elapsed_time` of each pair.  Its
window value, all the calls' work over all their time, is how every
end-to-end rate here is taken (`drivers.common.window_loop`).
"""

from __future__ import annotations

import contextlib
import statistics

import torch


class Spans:
    """Named spans on the device's timeline, read once all work is done.
    `span(name)` brackets the work enqueued inside it between two CUDA
    events, and names it "span:<name>" for the profiler; it adds no
    synchronisation.  Off (`on=False`), it records nothing."""

    def __init__(self, on: bool = True):
        self.on = on
        self.events = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        try:
            with torch.profiler.record_function(f"span:{name}"):
                yield
        finally:
            ev[1].record()
            self.events.setdefault(name, []).append(ev)

    def ms(self) -> dict:
        """{name: [ms of each span]}; synchronises first."""
        torch.cuda.synchronize()
        return {n: [a.elapsed_time(b) for a, b in evs]
                for n, evs in self.events.items()}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks
    (numpy's default), so a tail is the tail of every request."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles of
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
