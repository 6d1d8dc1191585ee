"""The median over units of work, in ms, of the time the program's span
`span` took a unit: the instances of `span` grouped into the instances
of the unit span `per` that hold them in host time, their `clock`
("device" or "host") durations summed a unit.  Reads
`dh3d_tpu_torch.trace.records()` in this process: the spans the program
recorded while the profiled window ran.  None when the program has no
tracer, no `span` inside a `per`, or no time on `clock` (device time off
CUDA)."""

import bisect
import statistics


def read(ctx, span, per, clock):
    try:
        from dh3d_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    units = sorted((r["start_ns"], r["end_ns"]) for r in recs
                   if r["name"] == per)
    starts = [s for s, _ in units]
    sums, found = [0.0] * len(units), False
    for r in recs:
        ms = r[f"{clock}_ms"]
        if r["name"] != span or ms is None:
            continue
        i = bisect.bisect_right(starts, r["start_ns"]) - 1
        if i >= 0 and r["end_ns"] <= units[i][1]:
            sums[i] += ms
            found = True
    return statistics.median(sums) if found else None
