"""A short steady window under torch.profiler, reduced to what the
per-layer readers and the result's `device` and `breakdown` take.

Device operations (kernels, copies, sets) are grouped into classes by
name patterns, the data of `device_classes/*.json` ({"classes": [[class,
[substring, ...]], ...]}, first match wins, files in name order).  Busy
time is the union of the device operations' intervals; the window is the
host's clock from a synchronise before the first unit of work to one
after the last.  Each idle stretch of the device is labelled with the
innermost host operation running when it began.
"""

from __future__ import annotations

import glob
import json
import os
import time

import torch

from benchmark.harness import BENCH_DIR

TOP = 10
NAME_CHARS = 120


def device_classes() -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "device_classes",
                                              "*.json"))):
        with open(path) as f:
            out += json.load(f)["classes"]
    return out


def classify(name: str, classes: list) -> str:
    low = name.lower()
    for cls, keys in classes:
        if any(k in low for k in keys):
            return cls
    return "other"


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host):
    """{label: seconds}: each gap [s, e] (us) under the innermost host
    operation running at its midpoint, leaving out the CUDA runtime's
    calls; host events are (start, end, name), nested, the benchmark's
    own spans among them ("span:<name>").  A gap under none is Python's
    own time between operations."""
    host = sorted(host)
    out, stack, i = {}, [], 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] > mid]
        ops = [h[2] for h in stack if not h[2].startswith("cuda")]
        label = ops[-1] if ops else "(python, between operations)"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def _record(unit, iters, activities):
    """(device events, host events, host seconds) of `iters` units under
    the profiler; events are (start us, end us, name)."""
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            unit()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name[:NAME_CHARS]))
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    return dev, host, window


def profile(unit, iters: int) -> dict:
    """Run `unit()` `iters` times under the profiler tracing the device
    alone (the host's operations recorded too would slow the host and
    widen the idle share), then `iters` times more recording the host's
    operations, which only label the idle stretches.  Returns busy_s,
    window_s, iters, class_s ({class: device seconds}), op_s ({name:
    device seconds}) and breakdown ({"device_ops", "idle_gaps"}: the
    largest ten of each, [name, seconds])."""
    from torch.profiler import ProfilerActivity

    classes = device_classes()
    dev, _, window = _record(unit, iters, [ProfilerActivity.CUDA])
    merged = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    class_s, op_s = {}, {}
    for s, e, name in dev:
        cls = classify(name, classes)
        class_s[cls] = class_s.get(cls, 0.0) + (e - s) / 1e6
        key = name[:NAME_CHARS]
        op_s[key] = op_s.get(key, 0.0) + (e - s) / 1e6
    span = (merged[-1][1] - merged[0][0]) / 1e6
    dev2, host, _ = _record(unit, iters, [ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
    merged2 = _union([(s, e) for s, e, _ in dev2])
    idle = _label_gaps([(a[1], b[0]) for a, b in zip(merged2, merged2[1:])],
                       host)
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": max(window, span), "iters": iters,
            "class_s": class_s, "op_s": op_s,
            "breakdown": {"device_ops": [list(kv) for kv in top],
                          "idle_gaps": [list(kv) for kv in top_idle]}}
