"""Readers of per-layer metrics: `read(ctx, **params)` -> a number, or
None when the run holds nothing to read.  `ctx` holds the window's
outcome (`window`), the profiled window (`profile`, `trace.profile`'s
dict), the shape counts (`counts`), the benchmark's spans (`spans`:
{name: [ms]}) and the peak memory (`peak_bytes`)."""
