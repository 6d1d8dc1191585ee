"""The run's guards: no card, no result; nothing of JAX or of the JAX
package is loaded; the reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

REF_DIR = os.path.join(harness.BENCH_DIR, "reference")


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "full_extract_b20", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_a_run_from_the_benchmark_files_alone_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's
    files has no program to run: no result, whatever the card."""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "full_extract_b20", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF_DIR):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(REF_DIR, name)):
                top = mod.split(".")[0]
                assert top not in ("dh3d_tpu_torch",) + harness.FOREIGN, \
                    (name, mod)
                if top == "benchmark":
                    assert mod.startswith("benchmark.reference"), (name, mod)


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    """Every module of the benchmark imported and every cell's driver run
    (shrunk, on the CPU) in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or dh3d_tpu, compared whole."""
    code = f"""
import json, os, pkgutil, importlib, sys
sys.path.insert(0, {harness.ROOT!r})
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from benchmark.tests import tiny
from benchmark import harness
for name in tiny.CELLS:
    tiny.run_cell(tiny.tiny_cell(name), seconds=0.2, tmp={str(tmp_path)!r})
print(json.dumps(harness.foreign_modules()))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    assert "dh3d_tpu_torch" not in harness.FOREIGN


def test_foreign_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dh3d_tpu_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "dh3d_tpu.ops", sys)
    assert harness.foreign_modules() == ["dh3d_tpu.ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_control_is_not_correct(name):
    """The plain reference in TF32 in the program's place, at the cell's
    own size on the card, fails at least one of the cell's numbers."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32 on the card")
    from benchmark import control

    cell = harness.load_cell(name, tiny.spec_with_spare())
    r = control.readings(cell, 2 ** 31 + 3, "control", 0.0,
                         torch.device("cuda:0"))
    assert any(v > r["limits"][n] or v != v for n, v in r["checks"].items()), r
