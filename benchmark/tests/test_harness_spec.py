"""BENCHMARK.json and the cell files: every file loads, every name keeps the
contract's form, and a cell, a traffic mix and a per-layer metric added as
files alone are found by name."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|expan")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[k]}) == len(SPEC[k])
    for n in names:
        assert NAME.match(n), n
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    assert [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads(name):
    cell = harness.load_cell(name)
    assert cell["entry"]["chips"] == 1
    tiny.driver(cell)  # the traffic's driver imports
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"]:
        if m["name"] != "setup_s":
            assert m["name"] in cell["traffic"]["values"]
    for m in cell["per_layer"]:
        entry = harness.read_json(harness.BENCH_DIR, "metrics",
                                  m["name"] + ".json")
        assert os.path.isfile(os.path.join(
            harness.BENCH_DIR, "readers", entry["reader"] + ".py"))
    conf = harness.find(SPEC["configs"], cell["entry"]["config"], "config")
    doc = harness.read_json(harness.ROOT, conf["file"])
    assert doc["source"] == conf["source"] and doc["reduced"] == \
        conf["reduced"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new traffic mix, its cell's limits and a new per-layer metric:
    new files and new entries, no edit of any file that is there."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    traffic = harness.read_json(bench, "traffic", "batch20_scans.json")
    traffic["batch"] = 8
    (bench / "traffic" / "batch8_scans.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "full_extract_b20.json",
                bench / "limits" / "full_extract_b8.json")
    (bench / "metrics" / "gemm_ms.extract_b8.json").write_text(
        json.dumps({"reader": "device_class_ms", "cls": "gemm"}))
    spec["workloads"].append({"name": "full_extract_b8", "config":
                              "dh3d_full", "traffic": "batch8_scans",
                              "chips": 1, "why": "smaller batches"})
    spec["end_to_end"][0]["workloads"].append("full_extract_b8")
    spec["per_layer"].append({
        "name": "gemm_ms.extract_b8", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "model and ops",
        "moves": "extract_clouds_per_s", "workloads": ["full_extract_b8"]})
    cell = harness.load_cell("full_extract_b8", spec, str(bench))
    assert cell["traffic"]["batch"] == 8
    assert [m["name"] for m in cell["per_layer"]] == ["gemm_ms.extract_b8"]
    ctx = {"profile": {"class_s": {"gemm": 0.004}, "iters": 2}}
    assert harness.per_layer(cell, ctx, str(bench)) == {
        "gemm_ms.extract_b8": {"value": 2.0, "unit": "ms"}}
    small = tiny.tiny_cell("full_extract_b8", spec, str(bench))
    small["traffic"]["batch"] = 3
    run = tiny.driver(small).Run(small, 3, tiny.CPU)
    assert run.B == 3 and run.schedule.shape[1] == 3


def test_seeds_are_streams():
    a = harness.sub_seed(2 ** 31 + 12345, "scans")
    assert a == harness.sub_seed(2 ** 31 + 12345, "scans")
    assert a != harness.sub_seed(2 ** 31 + 12345, "weights")
    assert 0 <= harness.sub_seed(2 ** 63, "x") < 2 ** 63
