"""The PyTorch port's extraction slice against the JAX package, on the CPU.

Loaders, NMS, retrieval and the two extraction functions get the same inputs
(numpy arrays or the same .bin files in `tmp_path`) on both sides, with
the committed checkpoints converted by `dh3d_tpu_torch.nn.convert`.  The
JAX loaders run their numpy paths (`dh3d_tpu.native.available` patched to
False): the C++ helper orders voxels differently.  Tolerances:
  - loader outputs, NMS keypoint lists, file names and row layouts: exact;
  - descriptors, attention and global descriptors: 1e-4 absolute (unit-
    scale outputs; f32 summation order and the JAX kNN's matmul distance
    identity, as `tests/test_torch_model.py`);
  - recall: equal.
The host NMS of the port runs on `cKDTree`, the JAX one on sklearn's ball
tree; the fixtures have no two neighbours at exactly equal distances,
where the two trees may order them differently.  The JAX device NMS builds
distances with the matmul identity, the port's exactly: the fixtures keep
no distance within its rounding of the 0.5 m radius or the 2 m noise
cut (checked below).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import dh3d_tpu.data as jdata
import dh3d_tpu.eval as jeval
from dh3d_tpu import native
from dh3d_tpu.data import io as jio
from dh3d_tpu.eval import nms as jnms
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.train import resolve_model as jax_resolve_model
from dh3d_tpu_torch import data as tdata
from dh3d_tpu_torch import eval as teval
from dh3d_tpu_torch.data import io as tio
from dh3d_tpu_torch.data.synthetic import lidar_like_scan
from dh3d_tpu_torch.eval import nms as tnms
from dh3d_tpu_torch.train import resolve_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
ATOL = 1e-4
NMS_ARGS = (0.5, 0.01)  # radius, min response ratio: the CLI defaults


@pytest.fixture(autouse=True)
def numpy_loaders(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _tiny_scan(seed):
    """~1,200 points over 12 m x 12 m: ~900 survive the normalisation."""
    return lidar_like_scan(seed, n_points=1200, extent=6.0)


def _write_scans(dirpath, n, dim=3):
    os.makedirs(dirpath, exist_ok=True)
    for s in range(n):
        scan = _tiny_scan(s)
        if dim > 3:
            scan = np.concatenate(
                [scan, np.zeros((len(scan), dim - 3), np.float32)], 1)
        tio.write_to_bin(scan, os.path.join(dirpath, f"scan{s}.bin"))


# ---------------------------------- NMS ----------------------------------

def _nms_fixture(kind, rng):
    """`tests/test_eval.py:115-142`: random attention, or attention on a
    16-level grid so that many survivors tie."""
    n = 200 if kind == "random" else 300
    xyz = rng.randn(n, 3).astype(np.float32) * (3 if kind == "random" else 4)
    if kind == "random":
        att = rng.rand(n).astype(np.float32)
    else:
        att = (np.floor(rng.rand(n) * 16) / 16 + 1 / 16).astype(np.float32)
    d = np.sqrt(((xyz[:, None].astype(np.float64) - xyz[None]) ** 2).sum(-1))
    near = np.sort(d, axis=1)[:, :50]
    assert np.abs(near - NMS_ARGS[0]).min() > 1e-5  # no radius boundary
    assert np.abs(near[:, 7] - 2.0).min() > 1e-5  # no noise boundary
    return xyz, att


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_single_nms_matches_jax(rng, kind):
    xyz, att = _nms_fixture(kind, rng)
    want = jnms.single_nms(xyz.astype(np.float64), att.copy(), *NMS_ARGS, 100)
    got = tnms.single_nms(xyz.astype(np.float64), att.copy(), *NMS_ARGS, 100)
    assert got == want
    if kind == "ties":  # the fixture exercises ties among survivors
        assert len(set(att[want[1]])) < len(want[1])


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_device_nms_matches_jax_and_host(rng, kind):
    xyz, att = _nms_fixture(kind, rng)
    n_j, idx_j = jnms.device_nms(xyz, att, *NMS_ARGS, 100)
    n_t, idx_t = tnms.device_nms(xyz, att, *NMS_ARGS, 100, device="cpu")
    assert n_t == n_j
    np.testing.assert_array_equal(idx_t, np.asarray(idx_j))
    _, host = tnms.single_nms(xyz.astype(np.float64), att.copy(), *NMS_ARGS,
                              100)
    np.testing.assert_array_equal(idx_t[:n_t], host)
    assert (idx_t[n_t:] == -1).all()


def test_nms_noise_removal_and_tensor_inputs():
    """An isolated point with the top attention is removed as noise; the
    device NMS takes tensors as well as arrays."""
    xyz = np.concatenate([np.random.RandomState(0).randn(60, 3) * 0.3,
                          np.array([[50.0, 50, 50]])]).astype(np.float32)
    att = np.full(61, 0.5, np.float32)
    att[60] = 0.99
    for fn in (jnms.single_nms, tnms.single_nms):
        assert 60 not in fn(xyz, att, 0.5, 0.01, 5)[1]
    n, idx = tnms.device_nms(torch.from_numpy(xyz), torch.from_numpy(att),
                             0.5, 0.01, 5, device="cpu")
    assert 60 not in idx[:n]
    assert list(idx[:n]) == jnms.device_nms(xyz, att, 0.5, 0.01, 5)[1][:n].tolist()


@pytest.mark.parametrize("backend", ["device", "host"])
def test_nms_keypoint_indices_matches_jax(rng, backend):
    xyz = rng.randn(150, 3).astype(np.float32) * 4
    att = rng.rand(150).astype(np.float32)
    want = jnms.nms_keypoint_indices(xyz, att, *NMS_ARGS, 40,
                                     backend=backend, parity_check=True)
    got = tnms.nms_keypoint_indices(xyz, att, *NMS_ARGS, 40,
                                    backend=backend, parity_check=True,
                                    device="cpu")
    assert got == want and len(got) > 0
    with pytest.raises(ValueError, match="backend"):
        tnms.nms_keypoint_indices(xyz, att, *NMS_ARGS, 40, backend="tpu",
                                  device="cpu")


# -------------------------------- loaders --------------------------------

@pytest.mark.parametrize("randsample,need_downsample,sortby_dis,target", [
    (False, True, True, 256),     # LocalTestDataset, oversized
    (False, True, True, 4096),    # LocalTestDataset, padded with sentinels
    (True, False, True, 256),     # GlobalTestDataset, oversized
    (True, False, True, 4096),    # GlobalTestDataset, padded by resampling
    (True, False, False, 256),    # the training samplers' call
])
def test_get_fixednum_pcd_matches_jax(randsample, need_downsample,
                                      sortby_dis, target):
    cloud = _tiny_scan(3)
    kw = dict(randsample=randsample, need_downsample=need_downsample,
              sortby_dis=sortby_dis)
    want, n_want = jio.get_fixednum_pcd(cloud, target,
                                        rng=np.random.RandomState(5), **kw)
    got, n_got = tio.get_fixednum_pcd(cloud, target,
                                      rng=np.random.RandomState(5), **kw)
    assert n_got == n_want and 0 < n_got <= target
    np.testing.assert_array_equal(got, want)


def test_center_crop_and_farthest_sampler_match_jax():
    cloud = _tiny_scan(4)
    for rad, shift in ((3.0, (0, 0, 0)), (5.0, (1.0, -2.0, 0.5))):
        np.testing.assert_array_equal(tio.center_crop(cloud, rad, shift),
                                      jio.center_crop(cloud, rad, shift))
    got = tio.FarthestSampler().sample(cloud, 32, np.random.RandomState(2))
    want = jio.FarthestSampler().sample(cloud, 32, np.random.RandomState(2))
    np.testing.assert_array_equal(got, want)
    assert len(set(got)) == 32


def test_restore_scale_pcd_matches_jax():
    """The DSO normalisation: mean 3-NN spacing (self included, as the
    reference) scaled to 0.2."""
    cloud = _tiny_scan(5)
    got = tio.restore_scale_pcd(cloud)
    np.testing.assert_array_equal(got, jio.restore_scale_pcd(cloud))
    assert got.shape == cloud.shape


@pytest.mark.parametrize("numpts,knn", [(256, 0), (256, 8), (1200, 0)])
def test_local_test_dataset_matches_jax(tmp_path, numpts, knn):
    """numpts=1200: every file already has 1200 points, the branch that
    only shuffles them.  The host kNN of cKDTree and of the ball tree agree
    on these tie-free clouds."""
    _write_scans(str(tmp_path), 2, dim=6)
    want = list(jdata.LocalTestDataset(str(tmp_path), numpts=numpts,
                                       knn_require=knn, dim=6))
    got = list(tdata.LocalTestDataset(str(tmp_path), numpts=numpts,
                                      knn_require=knn, dim=6))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) == (4 if knn else 3)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:3] == w[1:3]
        if knn:
            assert g[3].dtype == np.int32
            np.testing.assert_array_equal(g[3], w[3])


def _gt_pickle(path, names):
    """Two sequences of positions 10 m apart, the second 3 m off the
    first: each query's GT match is its twin."""
    half = len(names) // 2
    gt = {f"seq{s}": [{"query": names[s * half + i],
                       "northing": 10.0 * i + 3.0 * s, "easting": 0.0}
                      for i in range(half)] for s in range(2)}
    with open(path, "wb") as f:
        pickle.dump(gt, f)


def test_global_test_dataset_matches_jax(tmp_path):
    _write_scans(str(tmp_path / "pcd"), 4)
    _gt_pickle(str(tmp_path / "gt.pickle"), [f"scan{s}" for s in range(4)])
    args = (str(tmp_path / "pcd"), str(tmp_path / "gt.pickle"))
    want = list(jdata.GlobalTestDataset(*args, numpts=300))
    got = list(tdata.GlobalTestDataset(*args, numpts=300))
    assert [g[1] for g in got] == [w[1] for w in want] == \
        ["scan0.bin", "scan1.bin", "scan2.bin", "scan3.bin"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])


# --------------------------- extract_local/global ---------------------------

def _models(stem, num_points):
    """(JAX cfg, variables, JAX model), (port cfg, port model) of a
    committed checkpoint, with the eval CLIs' overrides."""
    jc, variables = jax_resolve_model(os.path.join(MODELS, stem))
    tc, model = resolve_model(os.path.join(MODELS, stem))
    for c in (jc, tc):
        c.num_points = num_points
        c.sampled_kpnum = -1
        c.input_R = False
    return (jc, variables, JaxDH3D(jc)), (tc, model)


def _rows(path):
    return np.fromfile(path, np.float32).reshape(-1, 132)


def test_extract_local_matches_jax(tmp_path):
    """demo_stage2 over three tiny scans at N=256: the dense rows of one
    (`save_all`) and the NMS keypoints of all three, from the same files
    through both loaders and extraction functions."""
    pcd = str(tmp_path / "pcd")
    _write_scans(pcd, 3)
    (jc, variables, jmodel), (tc, model) = _models("demo_stage2", 256)
    out = {}
    for side in ("jax", "torch"):
        for save_all in (False, True):
            d = str(tmp_path / f"{side}_{save_all}")
            kw = dict(batch_size=2, perform_nms=True, save_all=save_all)
            if side == "jax":
                ds = jdata.LocalTestDataset(pcd, numpts=256, knn_require=0,
                                            dim=3)
                n = jeval.extract_local(jc, variables, ds, d, model=jmodel,
                                        **kw)
            else:
                ds = tdata.LocalTestDataset(pcd, numpts=256, knn_require=0,
                                            dim=3)
                timings = {}
                n = teval.extract_local(tc, model, ds, d, timings=timings,
                                        **kw)
                assert set(timings) == ({"load", "forward", "write"} |
                                        ({"nms"} if not save_all else set()))
            assert n == 3
            out[side, save_all] = d
    for save_all, suffix in ((False, "_nms_res.bin"), (True, "_res.bin")):
        names = sorted(os.listdir(out["jax", save_all]))
        assert names == sorted(os.listdir(out["torch", save_all])) == \
            [f"scan{s}{suffix}" for s in range(3)]
        for name in names:
            want = _rows(os.path.join(out["jax", save_all], name))
            got = _rows(os.path.join(out["torch", save_all], name))
            assert got.shape == want.shape
            assert len(got) == (256 if save_all else len(got)) > 0
            np.testing.assert_array_equal(got[:, :3], want[:, :3])  # same kps
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_extract_global_and_recall_match_jax(tmp_path):
    """demo_stage3 over four tiny scans at N=256, batch 3 (so the last
    batch is padded), then the retrieval evaluation over the written
    files."""
    pcd = str(tmp_path / "pcd")
    _write_scans(pcd, 4)
    gt = str(tmp_path / "gt.pickle")
    _gt_pickle(gt, [f"scan{s}" for s in range(4)])
    (jc, variables, jmodel), (tc, model) = _models("demo_stage3", 256)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jeval.extract_global(jc, variables,
                                jdata.GlobalTestDataset(pcd, gt, numpts=256),
                                jdir, batch_size=3, model=jmodel) == 4
    assert teval.extract_global(tc, model,
                                tdata.GlobalTestDataset(pcd, gt, numpts=256),
                                tdir, batch_size=3) == 4
    for s in range(4):
        want = np.fromfile(os.path.join(jdir, f"scan{s}.bin"), np.float32)
        got = np.fromfile(os.path.join(tdir, f"scan{s}.bin"), np.float32)
        assert got.shape == want.shape == (256,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want = jeval.evaluate_sequences(jeval.load_sets_from_dir(gt, jdir),
                                    jeval.load_sets_from_dir(gt, jdir))
    got = teval.evaluate_sequences(teval.load_sets_from_dir(gt, tdir),
                                   teval.load_sets_from_dir(gt, tdir))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.refseq, g.queryseq) == (w.refseq, w.queryseq)
        np.testing.assert_array_equal(g.recalls, w.recalls)
        assert g.one_percent == w.one_percent
    np.testing.assert_array_equal(teval.average_recalls(got)[0],
                                  jeval.average_recalls(want)[0])


def test_retrieval_matches_jax(rng):
    desc_r, desc_q = rng.randn(30, 8), rng.randn(20, 8)
    pos = {"northing": rng.rand(30) * 100, "easting": rng.rand(30) * 100}
    qpos = {"northing": rng.rand(20) * 100, "easting": rng.rand(20) * 100}
    gt = teval.is_gt_match_2d(qpos, pos)
    np.testing.assert_array_equal(gt, jeval.is_gt_match_2d(qpos, pos))
    for a, b in zip(teval.compute_tp_fp(desc_r, desc_q, gt),
                    jeval.compute_tp_fp(desc_r, desc_q, gt)):
        np.testing.assert_array_equal(a, b)


# --------------------------------- the CLIs ---------------------------------

def test_cli_runs_on_cpu_without_jax_sklearn_or_the_jax_package(tmp_path):
    """The port's two CLIs in a fresh interpreter where importing sklearn,
    jax or dh3d_tpu fails, as on the machine with the card: local with NMS
    at the dso size (N=9000; the tiny scans are padded with sentinels) and
    global with recall at N=256."""
    pcd = str(tmp_path / "pcd")
    _write_scans(pcd, 2)
    gt = str(tmp_path / "gt.pickle")
    _gt_pickle(gt, ["scan0", "scan1"])
    local = ["--ModelPath", os.path.join(MODELS, "demo_stage2"),
             "--pcdpath", pcd, "--dim", "3", "--dataset", "oxford_dso",
             "--perform_nms", "--device", "cpu",
             "--save_dir", str(tmp_path / "local")]
    glob = ["--ModelPath", os.path.join(MODELS, "demo_stage3"),
            "--pcdpath", pcd, "--ref_gt_file", gt, "--query_gt_file", gt,
            "--num_points", "256", "--eval_recall", "--device", "cpu",
            "--save_dir", str(tmp_path / "global")]
    code = (
        "import sys\n"
        "for m in ('sklearn', 'jax', 'dh3d_tpu'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        "from dh3d_tpu_torch.evaluate import globaldesc_extract as g\n"
        "from dh3d_tpu_torch.evaluate import localdesc_extract as l\n"
        f"assert l.main({local!r})['clouds'] == 2\n"
        f"assert g.main({glob!r})['clouds'] == 2\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for s in range(2):
        rows = _rows(str(tmp_path / "local" / f"scan{s}_nms_res.bin"))
        assert 0 < len(rows) <= 512 and np.isfinite(rows).all()
        np.testing.assert_allclose(np.linalg.norm(rows[:, 3:131], axis=1),
                                   1.0, atol=1e-4)
        assert (tmp_path / "global" / f"scan{s}.bin").stat().st_size == 1024
    assert "Avg_one_percent_retrieved" in r.stdout


def test_cli_refuses_a_missing_cuda_device(tmp_path):
    from dh3d_tpu_torch.evaluate import localdesc_extract

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="is_available"):
        localdesc_extract.main(["--ModelPath", "x", "--pcdpath",
                                str(tmp_path)])
