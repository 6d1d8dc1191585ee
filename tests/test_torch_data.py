"""The PyTorch port's training data path against the JAX package, on the CPU.

Held to `dh3d_tpu.data` and `dh3d_tpu.train`:
  - the numpy augmentations and `get_augmentations_from_list`: the same
    bits from the same `RandomState`;
  - the torch augmentations on the draws JAX's keys make: within 1e-6 of
    the cloud's scale (f32 rotations summed in another order; sin and cos
    of another library);
  - `morton_sort_np`: equal;
  - the train samplers on a pool of tiny `.bin` scans and GT pickles: the
    same bits (the JAX samplers on their numpy and sklearn branch,
    `dh3d_tpu.native.available` patched to False; the fixtures have no two
    points at exactly equal distance, where sklearn's and scipy's trees
    may pick differently);
  - `device_local_pairs` on the draws of a JAX key: anchors and positives
    equal, R within 1e-7, points within 1e-6 relative;
  - one detection_config step from a raw {pc1, pc2} batch and one
    global_config step with on-device augmentation, on JAX's draws, within
    `test_torch_train.py`'s step tolerances.
Then the port's own surface: the prefetcher, the CLI from `--data_basedir`
with jax, flax, sklearn and `dh3d_tpu` blocked, the presort refusal, and
a resumed run that draws what an unbroken run draws.
"""

import os
import pickle
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import native
from dh3d_tpu.data import augment as jaug
from dh3d_tpu.data import datasets as jds
from dh3d_tpu.data import io as jio
from dh3d_tpu.data import pairgen as jpg
from dh3d_tpu.nn import init_variables
from dh3d_tpu_torch.data import augment as taug
from dh3d_tpu_torch.data import datasets as tds
from dh3d_tpu_torch.data import io as tio
from dh3d_tpu_torch.data import pairgen as tpg
from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher
from dh3d_tpu_torch.data.synthetic import lidar_like_scan
from dh3d_tpu_torch.nn.convert import load_npz
from dh3d_tpu_torch.train import (
    init_state,
    make_train_step,
    restore_state,
    save_checkpoint,
    to_device,
)
from dh3d_tpu_torch.train.__main__ import main as train_main
from dh3d_tpu_torch.train.__main__ import step_generator
from dh3d_tpu_torch.train.data import real_batches
from test_torch_train import MODELS, REPO, _compare_step, configs

NUMPTS, NODES = 256, 8
PLACES, PER_PLACE = 4, 3  # the global pool: places of 3 scans


@pytest.fixture(autouse=True)
def numpy_loaders(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """12 tiny lidar-like scans (~900 of 1,200 points survive the outlier
    removal, more than NUMPTS, so no point is drawn twice), a local GT
    pickle and a global one: places of 3 scans, the other two of a place
    its positives, the place its non-negatives."""
    d = str(tmp_path_factory.mktemp("pool"))
    names = [f"scan{i}" for i in range(PLACES * PER_PLACE)]
    for i, name in enumerate(names):
        tio.write_to_bin(lidar_like_scan(i, n_points=1200, extent=6.0),
                         os.path.join(d, name + ".bin"))
    with open(os.path.join(d, "oxford_train_local_gt.pickle"), "wb") as f:
        pickle.dump({i: {"query": n} for i, n in enumerate(names)}, f)
    gt = {}
    for p in range(PLACES):
        place = list(range(PER_PLACE * p, PER_PLACE * (p + 1)))
        for i in place:
            gt[i] = {"query": names[i],
                     "positives": [j for j in place if j != i],
                     "nonnegtives": place}
    with open(os.path.join(d, "oxford_train_global_gt.pickle"), "wb") as f:
        pickle.dump(gt, f)
    return d


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------ augmentations ------------------------------

@pytest.mark.parametrize("names", [["Jitter"], ["Rotate1D", "Jitter",
                                               "RotateSmall"],
                                   ["Rotate1D", "Scale", "Shift", "Jitter",
                                    "RotateSmall"]])
def test_host_augmentations_same_bits(names):
    data = np.random.RandomState(5).randn(300, 3).astype(np.float32) * 10
    for upright in (1, 2):
        ja = jaug.get_augmentations_from_list(names, upright)
        ta = taug.get_augmentations_from_list(names, upright)
        assert [type(a).__name__ for a in ja] == \
            [type(a).__name__ for a in ta]
        jr, tr = np.random.RandomState(3), np.random.RandomState(3)
        jd, td = data, data
        for a, b in zip(ja, ta):
            jd, td = a.apply(jd, jr), b.apply(td, tr)
        np.testing.assert_array_equal(jd, td)
    assert taug.get_augmentations_from_list(None) == []


def _jax_aug_draws(key, n, cloud_shape, names):
    """The draws `jax_augment` makes for each of n clouds under the
    trainer's `vmap` over `jax.random.split(key, n)`, stacked per name in
    the port's layout (`dh3d_tpu_torch.data.augment` docstring)."""
    per = {name: [] for name in names}
    for k in jax.random.split(key, n):
        for name in names:
            k, sub = jax.random.split(k)
            per[name].append({
                "Jitter": lambda: jax.random.normal(sub, cloud_shape),
                "Shift": lambda: jax.random.uniform(
                    sub, (3,), minval=-0.1, maxval=0.1),
                "Rotate1D": lambda: jax.random.uniform(sub),
                "RotateSmall": lambda: jax.random.normal(sub, (3,)),
                "Scale": lambda: jax.random.uniform(
                    sub, minval=0.8, maxval=1.25),
            }[name]())
    return [(name, torch.from_numpy(np.stack([np.asarray(d)
                                              for d in per[name]])))
            for name in names]  # np.stack copies: writable


@pytest.mark.parametrize("names", [["Jitter"], ["Shift"], ["Rotate1D"],
                                   ["RotateSmall"], ["Scale"],
                                   ["Rotate1D", "Jitter", "RotateSmall"]])
def test_torch_augmentations_match_jax_on_its_draws(names):
    """Each `torch_*` and `torch_augment` against `jax_augment` under the
    trainer's vmap, on the draws of the same key: 1e-6 of the scale."""
    data = np.random.RandomState(1).randn(3, 200, 3).astype(np.float32) * 20
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 3)
    want = np.asarray(jax.vmap(
        lambda k, pc: jaug.jax_augment(k, pc, tuple(names)))(
            keys, jnp.asarray(data)))
    draws = _jax_aug_draws(key, 3, (200, 3), names)
    got = taug.torch_augment(torch.from_numpy(data), draws).numpy()
    scale = np.abs(data).max()
    assert np.abs(got - want).max() <= 1e-6 * scale


def test_draw_augment_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    draws = dict(taug.draw_augment(
        ("Jitter", "Shift", "Rotate1D", "RotateSmall", "Scale"), (4, 50, 3),
        g))
    assert draws["Jitter"].shape == (4, 50, 3)
    assert draws["Shift"].shape == (4, 3)
    assert draws["Shift"].abs().max() <= 0.1
    assert ((draws["Rotate1D"] >= 0) & (draws["Rotate1D"] < 1)).all()
    assert draws["RotateSmall"].shape == (4, 3)
    assert ((draws["Scale"] >= 0.8) & (draws["Scale"] <= 1.25)).all()
    with pytest.raises(KeyError):
        taug.draw_augment(("Flip",), (1, 5, 3), g)


# ------------------------------ morton, prefetch ------------------------------

@pytest.mark.parametrize("shape", [(500, 3), (3, 400, 3)])
def test_morton_sort_np_equals_jax(shape):
    pts = np.random.RandomState(2).randn(*shape).astype(np.float32) * 30
    pts[..., 0] = np.round(pts[..., 0])  # ties in a coordinate
    np.testing.assert_array_equal(tio.morton_sort_np(pts),
                                  jio.morton_sort_np(pts))


def test_prefetcher_keeps_order_and_raises_the_source_error():
    assert list(ThreadedPrefetcher(iter(range(50)), depth=3)) == \
        list(range(50))

    def failing():
        yield 1
        yield 2
        raise OSError("disk gone")

    it = ThreadedPrefetcher(failing(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)


# --------------------------------- samplers ---------------------------------

def _take(gen, n):
    return [next(gen) for _ in range(n)]


def test_local_self_pair_sampler_same_bits(pool):
    """`batches` (host pairs: FPS, 1-NN) and `raw_batches`, 3 batches each,
    over more than one epoch of the local pool."""
    kw = dict(basedir=pool, numpts=NUMPTS, sample_nodes=NODES, seed=4,
              train_file=os.path.join(pool, "oxford_train_local_gt.pickle"))
    for method in ("batches", "raw_batches"):
        j = getattr(jds.LocalTrainSelfPair(**kw), method)
        t = getattr(tds.LocalTrainSelfPair(**kw), method)
        for a, b in zip(_take(j(4), 3), _take(t(4), 3)):
            _equal_batches(a, b)


@pytest.mark.parametrize("other_neg", [False, True])
def test_global_triplet_sampler_same_bits(pool, other_neg):
    kw = dict(basedir=pool, numpts=NUMPTS, posnum=2, negnum=3, seed=6,
              other_neg=other_neg,
              train_file=os.path.join(pool, "oxford_train_global_gt.pickle"))
    j = jds.GlobalTrainTriplet(**kw).batches(2)
    t = tds.GlobalTrainTriplet(**kw).batches(2)
    for a, b in zip(_take(j, 2), _take(t, 2)):
        _equal_batches(a, b)
        assert a["points"].shape == (2 * (1 + 2 + 3 + other_neg), NUMPTS, 3)


# --------------------------------- pairgen ---------------------------------

def _jax_pair_draws(key, B, N, rot_maxv):
    """The draws inside `dh3d_tpu.data.pairgen.device_local_pairs`."""
    k_ang, k_sub = jax.random.split(key)
    ang = jax.random.uniform(k_ang, (B,), minval=-rot_maxv, maxval=rot_maxv)
    subs = jax.vmap(lambda k: jax.random.permutation(k, N)[: N // 2])(
        jax.random.split(k_sub, B))
    return (torch.from_numpy(np.array(ang)),
            torch.from_numpy(np.asarray(subs).astype(np.int64)))


def _pair_clouds(B=2, N=512):
    """Two independent normalised draws (and jitter) of each of B scans,
    as the loader gives them."""
    rng = np.random.RandomState(0)
    pcs = [[tio.get_fixednum_pcd(lidar_like_scan(10 + b, 3000, 9.0), N,
                                 sortby_dis=False, rng=rng)[0]
            + rng.randn(N, 3).astype(np.float32) * 0.01 for _ in range(2)]
           for b in range(B)]
    return (np.stack([p[0] for p in pcs]).astype(np.float32),
            np.stack([p[1] for p in pcs]).astype(np.float32))


def test_device_local_pairs_matches_jax_on_its_draws():
    pc1, pc2 = _pair_clouds()
    B, N, M, rot_maxv = 2, 512, 16, np.pi
    key = jax.random.PRNGKey(3)
    want = jpg.device_local_pairs(key, jnp.asarray(pc1), jnp.asarray(pc2),
                                  M, rot_maxv=rot_maxv)
    angles, subsets = _jax_pair_draws(key, B, N, rot_maxv)
    got = tpg.local_pairs(torch.from_numpy(pc1), torch.from_numpy(pc2), M,
                          angles, subsets)
    np.testing.assert_array_equal(got["sample_inds"].numpy(),
                                  np.asarray(want["sample_inds"]))
    assert got["sample_inds"].dtype == torch.int64
    assert np.abs(got["R"].numpy() - np.asarray(want["R"])).max() <= 1e-7
    ref = np.asarray(want["points"])
    assert np.abs(got["points"].numpy() - ref).max() <= \
        1e-6 * np.abs(ref).max()
    # a cloud paired with itself: every positive is its anchor
    same = tpg.local_pairs(torch.from_numpy(pc1), torch.from_numpy(pc1), M,
                           angles, subsets)["sample_inds"]
    assert torch.equal(same[:B], same[B:])


def test_device_local_pairs_draws_from_its_generator():
    """Anchors unique and inside the cloud, positives the exact 1-NN in
    the unrotated pc2, pc2 recovered from points[B:] by R; the same
    generator state gives the same pairs."""
    pc1, pc2 = (torch.from_numpy(p) for p in _pair_clouds())
    B, M = 2, 16
    out = tpg.device_local_pairs(pc1, pc2, M, np.pi,
                                 torch.Generator().manual_seed(9))
    again = tpg.device_local_pairs(pc1, pc2, M, np.pi,
                                   torch.Generator().manual_seed(9))
    for k in out:
        assert torch.equal(out[k], again[k]), k
    anc, pos = out["sample_inds"][:B], out["sample_inds"][B:]
    for b in range(B):
        assert len(set(anc[b].tolist())) == M
    assert int(out["sample_inds"].min()) >= 0
    assert int(out["sample_inds"].max()) < pc1.shape[1]
    want = torch.cdist(torch.gather(pc1, 1, anc[..., None].expand(-1, -1, 3)),
                       pc2).argmin(-1)
    assert torch.equal(pos, want)
    back = taug.matmul3(out["points"][B:], out["R"].transpose(1, 2))
    assert (back - pc2).abs().max() <= 1e-5 * pc2.abs().max()


# ------------------------------ the train step ------------------------------

def test_detection_step_from_raw_pairs_matches_jax():
    """detection_config at N=256, 8 keypoints, 2 pairs, from {pc1, pc2}
    with on-device augmentation (Jitter on both copies) and pair
    generation, on the draws of JAX's pairgen_key and aug_key."""
    jc, _ = configs("detection_config")
    rng = np.random.RandomState(1)
    pc1 = (rng.randn(2, 256, 3) * 20).astype(np.float32)
    pc2 = np.stack([p[rng.permutation(256)] for p in pc1]) \
        + (rng.randn(2, 256, 3) * 0.02).astype(np.float32)
    pk, ak = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    batch = {"pc1": pc1, "pc2": pc2, "pairgen_key": pk, "aug_key": ak}
    port = to_device({"pc1": pc1, "pc2": pc2}, "cpu")
    port["pairgen_draws"] = _jax_pair_draws(pk, 2, 256, np.pi)
    port["aug_draws"] = _jax_aug_draws(ak, 4, (256, 3), ["Jitter"])
    variables = init_variables(jc, jax.random.PRNGKey(1))
    assert _compare_step("detection_config", variables, batch, port,
                         augment_on_device=True) == 58


def test_global_step_with_device_augmentation_matches_jax():
    """global_config as `test_global_step_matches_jax` (the local backbone
    of demo_stage3, unit-scale clouds) with `augment_on_device`: Rotate1D,
    Jitter and RotateSmall on every cloud, on JAX's aug_key draws.

    Seed 6.  The lazy quadruplet loss and the head's gradients are
    differences of descriptor distances of ~2 (a random head puts every
    global descriptor about as far from every other), so their f32 error,
    ~1e-6 of those distances, can exceed the 1e-5 loss and 1e-4 gradient
    tolerances where the difference is small.  That is so whatever
    augments the clouds: fed JAX's own augmented clouds on both sides,
    seeds 0-5 and 7 of these clouds fail those tolerances too (and the
    step without augmentation fails them at seed 1, passes at 0)."""
    jc, tc = configs("global_config")
    rng = np.random.RandomState(6)
    n = 1 + tc.num_pos + tc.num_neg + 1
    pts = rng.randn(n, 256, 3).astype(np.float32)
    ak = jax.random.PRNGKey(5)
    variables = flax.core.unfreeze(init_variables(jc, jax.random.PRNGKey(0)))
    for k, v in load_npz(os.path.join(MODELS, "demo_stage3.npz")).items():
        parts = k.split("/")
        if parts[1:2] == ["local_backbone"]:
            node = variables
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = jnp.asarray(v)
    port = to_device({"points": pts}, "cpu")
    port["aug_draws"] = _jax_aug_draws(ak, n, (256, 3), list(tc.data_aug))
    assert _compare_step("global_config", variables,
                         {"points": pts, "aug_key": ak}, port,
                         augment_on_device=True) == 21


# --------------------------------- the CLI ---------------------------------

def _cli_args(pool, logdir, cfg, *more):
    common = ["--data_basedir", pool, "--device", "cpu", "--steps", "2",
              "--num_points", str(NUMPTS), "--logdir", logdir]
    if cfg == "global_config":
        return ["--cfg", cfg, *common, "--batch_size", "1",
                "--set", "num_pos=1", "--set", "num_neg=2", *more]
    return ["--cfg", cfg, *common, "--batch_size", "2",
            "--set", f"sampled_kpnum={NODES}", *more]


def test_cli_trains_from_disk_without_jax_sklearn_or_the_jax_package(
        pool, tmp_path):
    """Three runs of `main` in a fresh interpreter where importing jax,
    flax, sklearn or dh3d_tpu fails, as on the card's machine:
    detection_config with device_pairgen and morton_presorted (the
    demo_stage2 run's keys), the host pair path, and global_config
    (morton_presorted, as demo_stage3) with augment_on_device."""
    runs = {
        "pairgen": _cli_args(pool, str(tmp_path / "a"), "detection_config",
                             "--device_pairgen", "--set",
                             "morton_presorted=true", "--load",
                             os.path.join(MODELS, "demo_stage2.npz")),
        "host": _cli_args(pool, str(tmp_path / "b"), "detection_config"),
        "global": _cli_args(pool, str(tmp_path / "c"), "global_config",
                            "--set", "augment_on_device=true", "--set",
                            "morton_presorted=true"),
    }
    code = (
        "import json, math, sys\n"
        "for m in ('sklearn', 'jax', 'flax', 'dh3d_tpu'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        "from dh3d_tpu_torch.train.__main__ import main\n"
        f"for name, argv in {runs!r}.items():\n"
        "    s = main(argv)\n"
        "    assert s['steps'] == 2 and len(s['wait_s']) == 2, s\n"
        "    assert all(map(math.isfinite, s['metrics'].values())), s\n"
        "    print(name, json.dumps(s['metrics']))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restored 80 tensors" in r.stdout
    for d in "abc":
        assert (tmp_path / d / "ckpt" / "step_00000002.pt").is_file()
    assert [ln.split()[0] for ln in r.stdout.splitlines()
            if ln.split()[:1] and ln.split()[0] in runs] == list(runs)


def test_presorted_local_training_needs_device_pairgen(pool, tmp_path):
    """`train.py:89-91`: the host's sample_inds are in load order."""
    with pytest.raises(ValueError, match="device_pairgen"):
        train_main(_cli_args(pool, str(tmp_path), "detection_config",
                             "--set", "morton_presorted=true"))


def test_resumed_run_draws_what_an_unbroken_run_draws(pool, tmp_path):
    """Three steps of the device-pairgen path with on-device augmentation
    from the disk stream, each step's generators from (1000 + seed, step)
    and (2000 + seed, step); against two steps, a checkpoint, a restore
    into a fresh state and the third step: the same metrics, bit for
    bit."""
    _, tc = configs("detection_config")
    tc.update(data_basedir=pool, device_pairgen=True, augment_on_device=True,
              morton_presorted=True)
    batches = [to_device(b, "cpu") for b in _take(real_batches(tc, 3), 3)]
    step = make_train_step(tc)

    def run(state, i):
        return step(state, batches[i], step_generator(1003, i, "cpu"),
                    step_generator(2003, i, "cpu"))

    state = init_state(tc, 3, "cpu")
    unbroken = [run(state, i) for i in range(3)]
    state = init_state(tc, 3, "cpu")
    for i in range(2):
        run(state, i)
    path = save_checkpoint(str(tmp_path), state)
    fresh = restore_state(path, init_state(tc, 8, "cpu"))
    resumed = run(fresh, fresh.step)
    for k, v in unbroken[2].items():
        assert torch.equal(v, resumed[k]), k
    # another step draws other pairs
    assert not torch.equal(unbroken[1]["total_cost"],
                           unbroken[2]["total_cost"])
