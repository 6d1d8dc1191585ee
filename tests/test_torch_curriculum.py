"""The port's curriculum script against the JAX package's, on the CPU.

`python -m dh3d_tpu_torch.scripts.train_demo_curriculum` gives each stage
the flags `scripts/train_demo_curriculum.py` gives `train.py` (then
`--device` and the pass-through `--set`s), with `--load` the previous
stage's logdir where the JAX script names its newest checkpoint.  Run for
2 steps a stage on 12 seeded lidar-like scans at 1024 points, batch 1
(512 anchors need 1024 points: the pairs' FPS samples half a cloud):
stage 2 restores every tensor stage 1 saved, stage 3 exactly stage 2's
`local_backbone.*` tensors and keeps them bit for bit (frozen), and a
second run skips all three stages.
"""

import importlib.util
import os
import pickle
import sys

import pytest
import torch

from dh3d_tpu_torch.data import io as tio
from dh3d_tpu_torch.data.synthetic import lidar_like_scan
from dh3d_tpu_torch.nn.convert import latest_checkpoint, warm_start_state_dict
from dh3d_tpu_torch.scripts import train_demo_curriculum as curriculum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLACES, PER_PLACE = 4, 3
SMALL = ["--set", "num_points=1024", "--set", "batch_size=1"]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """12 lidar-like scans (~1,200 of 1,600 points survive the outlier
    removal), the local GT pickle and the global one (places of 3 scans:
    the other two of a place its positives, the place its non-negatives)."""
    d = str(tmp_path_factory.mktemp("pool"))
    names = [f"scan{i}" for i in range(PLACES * PER_PLACE)]
    for i, name in enumerate(names):
        tio.write_to_bin(lidar_like_scan(i, n_points=1600, extent=6.0),
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


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_demo_curriculum",
        os.path.join(REPO, "scripts", "train_demo_curriculum.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fake_stage(logdir):
    """What a stage leaves behind: its logdir with one checkpoint."""
    os.makedirs(os.path.join(logdir, "ckpt", "step_00000001.pt"))


def test_stage_flags_are_the_jax_scripts(tmp_path, monkeypatch):
    jax_cmds, port_argvs = [], []
    jax_script = _jax_script()

    def jax_run(cmd, check):
        jax_cmds.append(cmd)
        _fake_stage(cmd[cmd.index("--logdir") + 1])

    def port_train(argv):
        port_argvs.append(argv)
        _fake_stage(argv[argv.index("--logdir") + 1])

    monkeypatch.setattr(jax_script.subprocess, "run", jax_run)
    monkeypatch.setattr(curriculum, "train_main", port_train)
    flags = ["--pool", "POOL", "--seeds", "0", "3", "--steps", "5", "6",
             "7"]
    monkeypatch.setattr(sys, "argv", ["train_demo_curriculum.py", *flags,
                                      "--out", str(tmp_path / "jax")])
    jax_script.main()
    summaries = curriculum.main([*flags, "--out", str(tmp_path / "port"),
                                 "--device", "cpu", *SMALL])
    assert list(summaries) == [f"seed{s}/stage{n}" for s in (0, 3)
                               for n in (1, 2, 3)]
    assert len(jax_cmds) == len(port_argvs) == 6
    for cmd, argv in zip(jax_cmds, port_argvs):
        want = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                for a in cmd[2:]]
        if "--load" in want:  # the JAX script names the newest checkpoint
            i = want.index("--load") + 1
            want[i] = os.path.dirname(os.path.dirname(want[i]))
        assert argv == want + ["--device", "cpu", *SMALL]


def test_curriculum_chains_and_skips(pool, tmp_path):
    out = str(tmp_path / "curriculum")
    argv = ["--pool", pool, "--out", out, "--steps", "2", "2", "2",
            "--device", "cpu", *SMALL]
    summaries = curriculum.main(argv)
    logdirs = [os.path.join(out, "seed0", f"stage{n}") for n in (1, 2, 3)]
    for logdir, (key, s) in zip(logdirs, summaries.items()):
        assert key == "seed0/" + os.path.basename(logdir)
        assert s["steps"] == 2 and len(s["launches"]) == 2
        assert os.path.basename(latest_checkpoint(logdir)) == \
            "step_00000002.pt"
    saved1, saved2, saved3 = map(warm_start_state_dict, logdirs)
    s1, s2, s3 = summaries.values()
    assert s1["restored"] is None
    assert s2["restored"] == len(saved1) > 0
    local = {k for k in saved2 if k.startswith("local_backbone.")}
    common = {k for k, t in saved2.items()
              if k in saved3 and saved3[k].shape == t.shape}
    assert common == local and s3["restored"] == len(local)
    for k in local:  # frozen: params and BN statistics
        assert torch.equal(saved3[k], saved2[k]), k
    before = sorted(os.walk(out))
    again = curriculum.main(argv)
    assert list(again.values()) == [None, None, None]
    assert sorted(os.walk(out)) == before
