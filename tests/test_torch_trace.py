"""The port's tracer (`dh3d_tpu_torch.trace`) on the CPU: the closed gate
costs nothing but its check, a recorded span's fields, spans under
`torch.profiler`, the spans of a stage-2 train step and of the eval
loader, and the benchmark's reader of them
(`benchmark/readers/program_span_ms.py`)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.readers import program_span_ms
from dh3d_tpu_torch import trace
from dh3d_tpu_torch.config import get_config
from dh3d_tpu_torch.data import LocalTestDataset
from dh3d_tpu_torch.data.io import write_to_bin
from dh3d_tpu_torch.data.synthetic import lidar_like_scan
from dh3d_tpu_torch.ops import neighborhood
from dh3d_tpu_torch.train import init_state, make_train_step

STEP_PARTS = ("step.prepare", "step.forward", "step.loss", "step.backward",
              "step.optimizer")
LOAD_PARTS = ("load.read", "load.voxel_grid", "load.outlier_removal",
              "load.select")


@pytest.fixture(autouse=True)
def fresh_store():
    trace.reset()
    was = trace.enable(False)
    yield
    trace.enable(was)
    trace.reset()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _inside(r, unit):
    return unit["start_ns"] <= r["start_ns"] and r["end_ns"] <= unit["end_ns"]


class _Forbidden:
    def __getattr__(self, name):
        raise AssertionError(f"the closed gate touched {name}")


def test_closed_gate_records_nothing_and_touches_nothing(monkeypatch):
    """No profiler and no `enable()`: `span` is the shared null context;
    it enters no `record_function`, reads no clock, makes no CUDA event."""
    monkeypatch.setattr(trace, "time", _Forbidden())
    monkeypatch.setattr(trace.torch.profiler, "record_function",
                        _Forbidden())
    monkeypatch.setattr(trace.torch.cuda, "Event", _Forbidden())
    ctx = trace.span("step", torch.device("cuda"))
    assert ctx is trace.span("load") is trace._NULL
    with ctx:
        pass
    assert trace.records() == []


def test_enabled_spans_nest_by_thread():
    """Parents from the opening thread's stack, none across threads; host
    durations from the clock, device time None off CUDA; `clear` empties
    the store; counters sit beside the kernels' launches."""
    def other():
        with trace.span("other"):
            pass

    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            time.sleep(0.002)
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    trace.count("clouds", 3)
    trace.count("clouds")
    recs = {r["name"]: r for r in trace.records(clear=True)}
    outer, inner, other = recs["outer"], recs["inner"], recs["other"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert other["parent"] is None and other["thread"] != outer["thread"]
    assert inner["thread"] == outer["thread"] == threading.get_ident()
    assert _inside(inner, outer) and _inside(other, outer)
    assert outer["host_ms"] >= inner["host_ms"] >= 2.0
    assert all(r["device_ms"] is None for r in recs.values())
    assert trace.records() == []
    counts = trace.counters()
    assert counts["clouds"] == 4 and "launches.knn" in counts


def test_a_profiler_opens_the_gate():
    """Under `torch.profiler` (CPU activity) spans record without
    `enable()` and appear in the profiler's events as `dh3d:<name>`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("unit"):
            torch.ones(4).sum()
    with trace.span("after"):
        pass
    assert [r["name"] for r in trace.records()] == ["unit"]
    assert "dh3d:unit" in {e.name for e in prof.events()}


def _build_inverse_too(monkeypatch):
    """The card's backwards read the CSR inverse (`NeighborInverse.get`);
    the plain ones do not need it.  Here they build it as well, so that
    its span shows where the card's would."""
    for name in ("_weighted_sum_backward", "_flex_moments_backward",
                 "_neighbor_max_backward"):
        def built_first(*args, _f=getattr(neighborhood, name)):
            for a in args:
                if isinstance(a, neighborhood.NeighborInverse):
                    a.get()
            return _f(*args)

        monkeypatch.setattr(neighborhood, name, built_first)


def test_stage2_train_step_records_its_parts(monkeypatch):
    """A stage-2 step on the CPU: the five parts once each as children of
    `step`, the model's forward under `step.forward`, and the CSR inverse
    builds inside `step` by host time."""
    _build_inverse_too(monkeypatch)
    cfg = get_config("detection_config")
    cfg.update(num_points=512, batch_size=2, sampled_kpnum=16,
               device_pairgen=True, morton_presorted=True)
    state = init_state(cfg, 0, "cpu")
    step = make_train_step(cfg)
    rng = torch.Generator().manual_seed(0)
    pc = torch.randn(2, 512, 3, generator=rng) * 10
    batch = {"pc1": pc, "pc2": pc + 0.01 * torch.randn(2, 512, 3,
                                                        generator=rng)}
    trace.enable()
    step(state, batch, pairgen=torch.Generator().manual_seed(1))
    recs = _by_name(trace.records())
    (unit,) = recs["step"]
    for part in STEP_PARTS:
        (r,) = recs[part]
        assert r["parent"] == unit["id"] and _inside(r, unit)
    (fwd,) = recs["model.forward"]
    assert fwd["parent"] == recs["step.forward"][0]["id"]
    assert "model.morton" not in recs  # presorted clouds
    assert recs["csr_inverse"]
    assert all(_inside(r, unit) for r in recs["csr_inverse"])


def test_local_test_dataset_records_load_and_its_parts(tmp_path):
    """Each cloud of the eval loader: `load`, and in it the read, the voxel
    grid, the outlier removal and the selection."""
    for s in range(2):
        write_to_bin(lidar_like_scan(s, 3000, 8.0),
                     os.path.join(tmp_path, f"{s}.bin"))
    trace.enable()
    clouds = list(LocalTestDataset(str(tmp_path), numpts=1024,
                                   knn_require=0, dim=3))
    assert len(clouds) == 2
    recs = _by_name(trace.records())
    assert len(recs["load"]) == 2
    ids = {r["id"] for r in recs["load"]}
    for part in LOAD_PARTS:
        assert len(recs[part]) == 2
        assert {r["parent"] for r in recs[part]} == ids


def _rec(name, start, end, device_ms=None):
    return {"name": name, "start_ns": start, "end_ns": end,
            "host_ms": (end - start) / 1e6, "device_ms": device_ms}


STORE = [
    _rec("step", 0, 100, 9.0), _rec("csr_inverse", 10, 20, 1.0),
    _rec("csr_inverse", 30, 40, 2.0),
    _rec("step", 200, 300, 9.0), _rec("csr_inverse", 210, 220, 5.0),
    _rec("step", 400, 500, 9.0), _rec("csr_inverse", 410, 420, 4.0),
    _rec("csr_inverse", 600, 610, 7.0),  # in no unit
]


@pytest.mark.parametrize("span,per,clock,store,want", [
    ("csr_inverse", "step", "device", STORE, 4.0),  # sums 3, 5, 4
    ("csr_inverse", "step", "host", STORE, 1e-5),  # 20, 10, 10 ns
    ("csr_inverse", "step", "device", STORE[1:3], None),  # no unit
    ("csr_inverse", "step", "device",
     [dict(r, device_ms=None) for r in STORE], None),  # the CPU
    ("load", "step", "host", STORE, None),  # no such span
])
def test_program_span_reader(monkeypatch, span, per, clock, store, want):
    monkeypatch.setattr(trace, "records", lambda: list(store))
    got = program_span_ms.read({}, span=span, per=per, clock=clock)
    assert got == pytest.approx(want) if want is not None else got is None


def test_program_span_reader_without_a_tracer(monkeypatch):
    """A program without `dh3d_tpu_torch.trace` (the benchmark laid over
    an older checkout): nothing to read, nothing raised."""
    import dh3d_tpu_torch

    monkeypatch.delattr(dh3d_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "dh3d_tpu_torch.trace", None)
    assert program_span_ms.read({}, span="step.forward", per="step",
                                clock="device") is None


def test_extract_local_fills_timings_from_spans_and_closes_the_gate(
        tmp_path):
    """With a `timings` dict, recording is on for the call and the store is
    drained into the dict; the gate is closed again afterwards."""
    from dh3d_tpu_torch.eval.extract import extract_local
    from dh3d_tpu_torch.nn import DH3D

    for s in range(2):
        write_to_bin(lidar_like_scan(s, 3000, 8.0),
                     os.path.join(tmp_path, f"{s}.bin"))
    cfg = get_config("detection_config")
    cfg.update(num_points=1024, sampled_kpnum=-1, morton_presorted=False)
    torch.manual_seed(0)
    model = DH3D(cfg)
    ds = LocalTestDataset(str(tmp_path), numpts=1024, knn_require=0, dim=3)
    timings = {}
    n = extract_local(cfg, model, ds, str(tmp_path / "out"), batch_size=1,
                      perform_nms=True, timings=timings)
    assert n == 2 and set(timings) == {"load", "forward", "nms", "write"}
    assert all(v > 0 for v in timings.values())
    assert trace.records() == [] and trace.span("x") is trace._NULL
    assert np.isfinite(list(timings.values())).all()
