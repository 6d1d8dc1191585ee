"""The port's spans and counters, on the profiler's clock.

`span(name, device)` times a stretch of the program.  It records only
while recording is on: after `enable()`, or while a `torch.profiler`
session is active.  Otherwise it returns a shared null context, having
read no clock, entered no profiler range and recorded no event, so a span
left in the hot path costs one check.

A recorded span holds its name, an id, its parent's id (the span open
below it in the same thread, from a thread-local stack), its thread and
its host start and end (`time.perf_counter_ns`).  It runs inside
`torch.profiler.record_function("dh3d:<name>")`, so a profiler trace
shows it on the device's timeline.  When its work runs on a CUDA device
it also records two timing events on that device's current stream, with
no synchronisation; `records()` resolves them, waiting for the device
once.  A span opened in autograd's device thread (a backward) has no
parent there: tie it to its unit by host-time containment.

`count(name, n)` adds to a counter; `counters()` reports them beside the
kernels' launch counts (`kernels.counts()`, as "launches.<kernel>").
The store is shared by every thread of the process and holds at most
`MAX_RECORDS` spans, dropping the oldest: a long run drains it
(`records(clear=True)`) as it goes.

While a thread captures device work into CUDA graphs (`cutting(cut)`),
its spans record nothing (a timing event recorded inside a capture could
not be timed): each calls `cut(name, device)` where it opens and
`cut(None, None)` where it closes, so the capture can end a graph there
and its replay open the same span around the same work.  A span another
thread opens on a stream being captured (autograd's device thread, in a
captured backward) records nothing either, and cuts nothing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

from dh3d_tpu_torch import kernels

MAX_RECORDS = 1 << 16

_enabled = False
_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> bool:
    """Record spans whether or not a profiler is active (`on`), or only
    under one; returns the previous setting, to restore."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


@contextlib.contextmanager
def enabled():
    """Record while entered (a CLI's run), then restore the setting."""
    was = enable(True)
    try:
        yield
    finally:
        enable(was)


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "events", "device_ms", "_range")

    def __init__(self, name: str, device):
        self.name = name
        dev = getattr(device, "device", device)
        self.events = None
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self.events = (stream, torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.device_ms = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        self._range = torch.profiler.record_function(f"dh3d:{self.name}")
        self._range.__enter__()
        if self.events:
            self.events[1].record(self.events[0])
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events:
            self.events[2].record(self.events[0])
        self._range.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            _store.append(self)
        return False

    def done(self) -> bool:
        return self.events is None or self.events[2].query()

    def as_dict(self) -> dict:
        events = self.events
        if events:
            _, a, b = events
            b.synchronize()
            self.device_ms, self.events = a.elapsed_time(b), None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns,
                "host_ms": (self.end_ns - self.start_ns) / 1e6,
                "device_ms": self.device_ms}


class _Cut:
    __slots__ = ("cut", "name", "device")

    def __init__(self, cut, name: str, device):
        self.cut, self.name = cut, name
        self.device = getattr(device, "device", device)

    def __enter__(self):
        self.cut(self.name, self.device)
        return self

    def __exit__(self, *exc):
        self.cut(None, None)
        return False


def span(name: str, device=None):
    """A context that records the span `name` while recording is on.
    `device`: a tensor or device the span's work runs on; a CUDA one adds
    the span's device time.  Inside `cutting` it records nothing."""
    cut = getattr(_local, "cut", None)
    if cut is not None:
        return _Cut(cut, name, device)
    if not (_enabled or _profiling()):
        return _NULL
    dev = getattr(device, "device", device)
    if dev is not None and torch.device(dev).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        return _NULL
    return _Span(name, device)


@contextlib.contextmanager
def cutting(cut):
    """While entered, the spans this thread opens record nothing and call
    `cut(name, device)` as they open and `cut(None, None)` as they close
    (`device` a device or None); other threads' spans are unaffected."""
    prev, _local.cut = getattr(_local, "cut", None), cut
    try:
        yield
    finally:
        _local.cut = prev


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] += n


def tally() -> dict:
    """{name: count} of this module's counters alone (no launches)."""
    with _lock:
        return dict(_counts)


def add(counts: dict) -> None:
    """Add {name: n} to this module's counters (n may be negative): a CUDA
    graph's replay adds what its capture counted.  A counter back at 0 is
    dropped."""
    with _lock:
        for name, n in counts.items():
            _counts[name] += n
            if not _counts[name]:
                del _counts[name]


def counters() -> dict:
    """{name: count}: this module's counters and, as "launches.<kernel>",
    the kernels' launches."""
    with _lock:
        out = dict(_counts)
    out.update((f"launches.{k}", v) for k, v in kernels.counts().items())
    return out


def records(clear: bool = False, wait: bool = True) -> list:
    """The recorded spans, oldest first, as dicts: name, id, parent,
    thread, start_ns, end_ns, host_ms and device_ms (None off CUDA).
    Waits for the device until the spans' work is done; with
    `wait=False` it takes only spans whose work is done, and waits for
    nothing.  `clear` removes what it returns from the store."""
    with _lock:
        taken, kept = [], []
        for r in _store:
            (taken if wait or r.done() else kept).append(r)
        if clear:
            _store.clear()
            _store.extend(kept)
    return [r.as_dict() for r in taken]


def reset() -> None:
    """Empty the store and this module's counters (not the kernels')."""
    with _lock:
        _store.clear()
        _counts.clear()
