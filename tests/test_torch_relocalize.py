"""The port's three evaluation CLIs (`relocalize`, `registration_eval`,
`repeatability_eval`) against the repository's JAX CLIs, on the CPU.

Each JAX CLI runs in this process (`main()` under a patched `sys.argv`,
its output captured) on the same files as the port's `main(argv)` with
`--device cpu`: tiny seeded lidar-like scans at N=256 with
`models/demo_stage2` (local, detector) and `models/demo_stage3` (global).
The printed lines must be equal, and for relocalisation also the top-1,
the NMS keypoints of every registered cloud and the inlier counts.

The two forwards agree within 1e-4 (`tests/test_torch_eval.py`), and
the JAX matching computes float32 descriptor distances, the port float64.
So the fixture is checked to keep every nearest and second-nearest
descriptor distance of a registration apart by more than 1e-4, and every
retrieval's top-1 ahead of the second by as much.
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import dh3d_tpu.eval as jeval
from dh3d_tpu import native
from dh3d_tpu.eval import nms as jnms
from dh3d_tpu_torch.data.io import write_to_bin
from dh3d_tpu_torch.data.synthetic import lidar_like_scan
from dh3d_tpu_torch.evaluate import registration_eval as treg_cli
from dh3d_tpu_torch.evaluate import relocalize as treloc
from dh3d_tpu_torch.evaluate import repeatability_eval as trep_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
MARGIN = 1e-4


@pytest.fixture(autouse=True)
def numpy_loaders(monkeypatch):
    """The JAX loaders' numpy paths (the C++ helper orders voxels
    differently)."""
    monkeypatch.setattr(native, "available", lambda: False)


def _jax_cli(name, argv, monkeypatch, capsys):
    """Run `evaluate/<name>.py`'s main() here; returns its stdout lines."""
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", os.path.join(REPO, "evaluate", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def _port_cli(main, argv, capsys):
    """The port's main(argv) on the CPU: (its summary, its stdout lines)."""
    capsys.readouterr()
    summary = main(argv + ["--device", "cpu"])
    return summary, capsys.readouterr().out.splitlines()


def _scans(dirpath, seeds):
    os.makedirs(dirpath, exist_ok=True)
    for s in seeds:
        write_to_bin(lidar_like_scan(s, n_points=1200, extent=6.0),
                     os.path.join(dirpath, f"scan{s}.bin"))


def _gt(path, seq, seeds, northing):
    with open(path, "wb") as f:
        pickle.dump({seq: [{"query": f"scan{s}", "northing": n,
                            "easting": 0.0}
                           for s, n in zip(seeds, northing)]}, f)


@pytest.fixture
def reloc_data(tmp_path):
    """4 database scans 10 m apart and 2 queries 3 m off two of them."""
    pcd = str(tmp_path / "pcd")
    _scans(pcd, range(6))
    db, q = str(tmp_path / "db.pickle"), str(tmp_path / "q.pickle")
    _gt(db, "db", range(4), [0.0, 10.0, 20.0, 30.0])
    _gt(q, "query", (4, 5), [13.0, 33.0])
    return ["--local_model", os.path.join(MODELS, "demo_stage2"),
            "--global_model", os.path.join(MODELS, "demo_stage3"),
            "--db_gt", db, "--query_gt", q, "--pcdpath", pcd,
            "--num_points", "256"]


def test_relocalize_matches_jax(reloc_data, monkeypatch, capsys):
    """The same printed lines (top-1, distance, inliers/matches, the
    summary), the same NMS keypoints of each query and its top-1, and the
    same inlier counts."""
    kps, regs = [], []
    nms_fn, reg_fn = jnms.nms_keypoint_indices, jeval.register_clouds

    def nms(*a, **kw):
        kps.append(list(nms_fn(*a, **kw)))
        return kps[-1]

    def register(kp1, d1, kp2, d2, **kw):
        d = np.linalg.norm(d1[:, None].astype(np.float64) - d2[None],
                           axis=-1)
        rows, cols = np.sort(d, 1)[:, :2], np.sort(d, 0)[:2]
        regs.append(min((rows[:, 1] - rows[:, 0]).min(),
                        (cols[1] - cols[0]).min()))
        return reg_fn(kp1, d1, kp2, d2, **kw)

    monkeypatch.setattr(jnms, "nms_keypoint_indices", nms)
    monkeypatch.setattr(jeval, "register_clouds", register)
    want = _jax_cli("relocalize", reloc_data, monkeypatch, capsys)
    got, lines = _port_cli(treloc.main, reloc_data, capsys)
    assert lines == want
    assert got["n"] == 2 and got["retrieved"] == 2
    assert min(regs) > MARGIN, regs
    for i, q in enumerate(got["queries"]):
        assert q["kp_query"] == kps[2 * i] and len(q["kp_query"]) > 10
        assert q["kp_db"] == kps[2 * i + 1]
        assert q["matches"] >= 3 and q["inliers"] >= 3
        assert f"inliers {q['inliers']}/{q['matches']}" in want[1 + i]
    assert set(got["timings"]) == set(treloc.TIMING_KEYS)
    assert all(v >= 0 for v in got["timings"].values())


def test_relocalize_host_nms_and_retrieval_margin(reloc_data, capsys):
    """`--nms_backend host` gives the device NMS's keypoints; the top-1
    of each query leads the second by more than the forwards' difference."""
    dev, _ = _port_cli(treloc.main, reloc_data, capsys)
    host, _ = _port_cli(treloc.main, reloc_data + ["--nms_backend", "host"],
                        capsys)
    for a, b in zip(dev["queries"], host["queries"]):
        assert a.pop("ms").keys() == b.pop("ms").keys()  # the host times
        assert a == b
    # the retrieval margin, from the port's own global descriptors
    from dh3d_tpu_torch.data import GlobalTestDataset
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.train import resolve_model

    cfg, model = resolve_model(os.path.join(MODELS, "demo_stage3"))
    cfg.num_points, cfg.sampled_kpnum, cfg.input_R = 256, -1, False
    cfg.extract_global = True
    fwd = make_forward(cfg, model)
    args = dict(zip(reloc_data[::2], reloc_data[1::2]))

    def descs(gt):
        ds = GlobalTestDataset(args["--pcdpath"], gt, numpts=256)
        return np.stack([fwd(c[None])["global_desc"][0].numpy()
                         for c, _ in ds])

    db, q = descs(args["--db_gt"]), descs(args["--query_gt"])
    d = np.sort(np.linalg.norm(db[None] - q[:, None], axis=-1), axis=1)
    assert (d[:, 1] - d[:, 0]).min() > MARGIN


def test_repeatability_eval_matches_jax(tmp_path, monkeypatch, capsys):
    pcd = str(tmp_path / "pcd")
    _scans(pcd, (0, 1))
    argv = ["--model", os.path.join(MODELS, "demo_stage2"), "--pcdpath", pcd,
            "--num_points", "256", "--max_clouds", "2"]
    want = _jax_cli("repeatability_eval", argv, monkeypatch, capsys)
    got, lines = _port_cli(trep_cli.main, argv, capsys)
    assert lines == want and len(lines) == 2
    assert got["clouds"] == 2
    assert set(got["self-pair"]) == set(got["partial-overlap"]) == \
        {32, 64, 128, 256, 512}


def test_repeatability_eval_refuses_a_model_without_detector(tmp_path):
    pcd = str(tmp_path / "pcd")
    _scans(pcd, (0,))
    with pytest.raises(SystemExit, match="no detector"):
        trep_cli.main(["--model", os.path.join(MODELS, "demo_stage3"),
                       "--pcdpath", pcd, "--device", "cpu"])


def _kp_rows(rng, xyz, desc):
    att = rng.rand(len(xyz), 1)
    return np.concatenate([xyz, desc, att], 1).astype(np.float32)


@pytest.fixture
def kp_files(tmp_path):
    """Keypoint files as `localdesc_extract` writes them: A; B, A moved by
    a known pose with its descriptors perturbed and 30% redrawn; C, 2
    rows.  A pairs file with the pose for (A, B), none for (B, A), and
    (A, C), which has too few matches."""
    rng = np.random.RandomState(0)
    xyz = rng.randn(120, 3) * 8
    desc = rng.randn(120, 128)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    t = np.array([2.0, -1.0, 0.3])
    xyz_b = (xyz - t) @ R + rng.randn(120, 3) * 0.02  # A = B @ R.T + t
    desc_b = desc + rng.randn(120, 128) * 0.01
    redraw = rng.rand(120) < 0.3
    desc_b[redraw] = rng.randn(int(redraw.sum()), 128)
    desc_b /= np.linalg.norm(desc_b, axis=1, keepdims=True)
    paths = {k: str(tmp_path / f"{k}_nms_res.bin") for k in "ABC"}
    write_to_bin(_kp_rows(rng, xyz, desc), paths["A"])
    write_to_bin(_kp_rows(rng, xyz_b, desc_b), paths["B"])
    write_to_bin(_kp_rows(rng, xyz[:2], desc[:2]), paths["C"])
    gt = str(tmp_path / "T_gt.txt")
    Tm = np.eye(4)
    Tm[:3, :3], Tm[:3, 3] = R, t
    np.savetxt(gt, Tm)
    pairs = str(tmp_path / "pairs.txt")
    with open(pairs, "w") as f:
        f.write(f"{paths['A']} {paths['B']} {gt}\n\n"
                f"{paths['B']} {paths['A']}\n{paths['A']} {paths['C']}\n")
    return paths, pairs


def test_registration_eval_matches_jax(kp_files, monkeypatch, capsys):
    paths, pairs = kp_files
    for argv in (["--self_test", paths["A"], "--iters", "200"],
                 ["--pairs", pairs, "--iters", "300"]):
        want = _jax_cli("registration_eval", argv, monkeypatch, capsys)
        got, lines = _port_cli(treg_cli.main, argv, capsys)
        assert lines == want
    assert got["pairs"] == 3 and got["scored"] == got["success"] == 1
    first, second, third = got["per_pair"]
    assert first["success"] and first["rte"] < 0.1 and first["rre"] < 1.0
    assert second["inliers"] > 50 and second["success"] is None
    assert third["inliers"] is None
    self_test, _ = _port_cli(treg_cli.main, ["--self_test", paths["A"]],
                             capsys)
    assert self_test["success"] and self_test["rte"] < 1e-6
    assert self_test["inliers"] == self_test["matches"] == 120


def test_clis_run_on_cpu_without_jax_sklearn_or_the_jax_package(
        reloc_data, kp_files):
    """All three CLIs in a fresh interpreter where importing sklearn, jax
    or dh3d_tpu fails, as on the machine with the card."""
    paths, pairs = kp_files
    pcd = reloc_data[reloc_data.index("--pcdpath") + 1]
    rep = ["--model", os.path.join(MODELS, "demo_stage2"), "--pcdpath", pcd,
           "--num_points", "256", "--max_clouds", "1", "--protocol", "self",
           "--device", "cpu"]
    code = (
        "import sys\n"
        "for m in ('sklearn', 'jax', 'dh3d_tpu'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        "from dh3d_tpu_torch.evaluate import registration_eval as g\n"
        "from dh3d_tpu_torch.evaluate import relocalize as r\n"
        "from dh3d_tpu_torch.evaluate import repeatability_eval as p\n"
        f"assert r.main({reloc_data + ['--device', 'cpu']!r})['n'] == 2\n"
        f"assert g.main({['--pairs', pairs, '--device', 'cpu']!r})"
        "['success'] == 1\n"
        f"assert len(p.main({rep!r})['self-pair']) == 5\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "retrieval@1 (<25m): 2/2" in r.stdout
    assert "success rate: 1/1" in r.stdout
    assert "self-pair: K=32" in r.stdout


@pytest.mark.parametrize("cli", ["relocalize", "registration_eval",
                                 "repeatability_eval"])
def test_cli_refuses_a_missing_cuda_device(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"relocalize": ["--local_model", "x", "--global_model", "x",
                           "--db_gt", "x", "--query_gt", "x",
                           "--pcdpath", str(tmp_path)],
            "registration_eval": ["--self_test", "x"],
            "repeatability_eval": ["--model", "x", "--pcdpath",
                                   str(tmp_path)]}[cli]
    main = {"relocalize": treloc.main, "registration_eval": treg_cli.main,
            "repeatability_eval": trep_cli.main}[cli]
    with pytest.raises(SystemExit, match="is_available"):
        main(argv)
