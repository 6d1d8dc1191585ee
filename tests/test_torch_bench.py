"""The port's bench (`python -m dh3d_tpu_torch.bench`) against the
repository's `bench.py`, on the CPU.

The JSON line: `bench.py`'s own `main()`, its workloads replaced by fixed
values, prints the keys, values and rounding the port's `summary` gives
the same values, which adds exactly `input_class` and `device`.  The
inputs: the forwards' clouds (synthetic and read from `.bin` files) and
the train batch equal `bench.py`'s draws.  Each workload runs at a tiny
size on the CPU and gives a finite value > 0; `--worker` prints
`WORKER_RESULT`; the CUDA default raises where there is no CUDA device.
"""

import glob
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dh3d_tpu_torch import bench
from dh3d_tpu_torch.data.io import write_to_bin
from dh3d_tpu_torch.data.synthetic import lidar_like_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VALUES = {"fwd_fast": 1103.456, "fwd_parity": 871.04999, "train_fast": 366.3,
          "train_pre": 371.25, "train_cps": 298.7449, "knn_ms": 0.28449,
          "flex_ms": 0.305}


def test_json_line_is_bench_pys(jax_bench, monkeypatch, capsys):
    monkeypatch.setattr(jax_bench, "_collect", lambda: dict(VALUES))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    jax_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.summary(dict(VALUES), "synthetic", "cpu")
    assert got.pop("input_class") == "synthetic"
    assert got.pop("device") == "cpu"
    assert got == want


def _no_demo_files(real):
    def fake(pattern, *args, **kwargs):
        if pattern.endswith(os.path.join("demo_data", "*", "*.bin")) or \
                "demo_train" in pattern:
            return []
        return real(pattern, *args, **kwargs)
    return fake


def test_synthetic_clouds_are_bench_pys(jax_bench, monkeypatch):
    monkeypatch.setattr(glob, "glob", _no_demo_files(glob.glob))
    want = jax_bench._bench_clouds(3, 64)
    got, input_class = bench.bench_clouds(3, 64)
    assert input_class == "synthetic" == jax_bench._BENCH_INPUT_CLASS
    np.testing.assert_array_equal(got, want)


def test_file_clouds_are_bench_pys(jax_bench, monkeypatch, tmp_path):
    """Clouds from `<dir>/<seq>/*.bin`, where `bench.py` reads the
    reference's demo set: the same files, the same draws."""
    for i in range(3):
        seq = tmp_path / f"seq{i % 2}"
        seq.mkdir(exist_ok=True)
        write_to_bin(lidar_like_scan(i, n_points=1200, extent=6.0),
                     str(seq / f"{i}.bin"))
    real = glob.glob
    ours = sorted(real(str(tmp_path / "*" / "*.bin")))

    def fake(pattern, *args, **kwargs):
        if pattern.endswith(os.path.join("demo_data", "*", "*.bin")):
            return list(ours)
        return real(pattern, *args, **kwargs)

    monkeypatch.setattr(glob, "glob", fake)
    want = jax_bench._bench_clouds(3, 256)
    assert jax_bench._BENCH_INPUT_CLASS == "oxford_demo"
    got, input_class = bench.bench_clouds(3, 256, str(tmp_path))
    assert input_class == "oxford_demo"
    np.testing.assert_array_equal(got, want)
    assert bench.bench_clouds(4, 256, str(tmp_path))[1] == "synthetic"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("presorted", [False, True])
def test_train_batch_is_bench_pys(jax_bench, monkeypatch, presorted):
    """`bench.py`'s batch, caught where it reaches `init_state`."""
    import dh3d_tpu.train as trainlib

    seen = {}

    def catch(cfg, rng, batch):
        seen.update(batch)
        raise _Stop

    monkeypatch.setattr(trainlib, "init_state", catch)
    with pytest.raises(_Stop):  # 512 anchors a cloud: N >= 512
        jax_bench.bench_train_step(jax, jax.numpy, B=2, N=512,
                                   presorted=presorted)
    got = bench.train_batch(2, 512, presorted=presorted)
    assert set(got) == set(seen)
    for k, v in seen.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


TINY = {
    "fwd_fast": lambda: bench.bench_forward(B=2, N=512, iters=2, morton=True,
                                            device="cpu"),
    "fwd_parity": lambda: bench.bench_forward(B=2, N=512, iters=2,
                                              device="cpu"),
    "train_fast": lambda: bench.bench_train_step(B=1, N=256, iters=2,
                                                 morton=True, device="cpu",
                                                 KP=8),
    "train_pre": lambda: bench.bench_train_step(B=1, N=256, iters=2,
                                                morton=True, presorted=True,
                                                device="cpu", KP=8),
    "train_cps": lambda: bench.bench_train_step(B=1, N=256, iters=2,
                                                device="cpu", KP=8),
    "knn_ms": lambda: bench.bench_knn(B=2, N=256, iters=2, device="cpu"),
    "flex_ms": lambda: bench.bench_flex_conv(B=2, N=256, iters=2,
                                             device="cpu"),
}


@pytest.mark.parametrize("name", sorted(bench.WORKLOADS))
def test_workload_runs_tiny_on_the_cpu(name):
    value = TINY[name]()
    assert np.isfinite(value) and value > 0


def test_window_is_the_work_over_all_the_calls_time():
    """`report["window"]` is the value of the mean call (the whole
    window's rate), beside the median that the workload returns."""
    import statistics

    ms_report, rate_report = {}, {}
    ms = bench.bench_knn(B=1, N=64, iters=3, device="cpu",
                         report=ms_report)
    assert ms == statistics.median(ms_report["ms"])
    assert ms_report["window"] == statistics.fmean(ms_report["ms"])
    rate = bench.bench_train_step(B=1, N=256, iters=3, device="cpu", KP=8,
                                  report=rate_report)
    calls = rate_report["ms"]
    assert len(calls) == 3
    assert rate == 2 / (statistics.median(calls) / 1e3)
    assert rate_report["window"] == 2 / (statistics.fmean(calls) / 1e3)


def test_worker_prints_its_result(monkeypatch, capsys):
    monkeypatch.setitem(bench.WORKLOADS, "knn_ms",
                        (bench.bench_knn, {"B": 1, "N": 64, "iters": 2}))
    bench.main(["--device", "cpu", "--worker", "knn_ms"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    name, value = line.split()
    assert name == "WORKER_RESULT" and float(value) > 0


def test_cuda_is_the_default_and_raises_without_one():
    """Without --device the bench asks for the card; with no CUDA device
    (as here) every way in raises before any work."""
    if torch.cuda.is_available():
        return
    for argv in ([], ["--device", "cuda"], ["--worker", "knn_ms"]):
        with pytest.raises(RuntimeError, match="cuda"):
            bench.main(argv)
    for workload in (bench.bench_forward, bench.bench_train_step,
                     bench.bench_knn, bench.bench_flex_conv):
        with pytest.raises(RuntimeError, match="cuda"):
            workload(B=1, N=64, iters=1)
