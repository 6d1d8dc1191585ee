"""The port's stage-to-stage warm start (`train --load`), on the CPU.

`--load` takes a Flax `<stem>.npz`, a checkpoint `step_*.pt` of the port's
trainer or its training logdir, and loads every tensor whose name and
shape the model has (`nn.convert.load_partial`): the same tensors and the
same count from a `.pt` as from the Flax file it was saved from; the
curriculum basic -> detection -> global chained through the port's own
checkpoints, each stage starting at step 0 from the loaded tensors; and a
refusal of anything else.  Small sizes: 256 points, batch 1.
"""

import os

import numpy as np
import pytest
import torch

from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch.nn import DH3D, load_flax, load_npz, smart_init
from dh3d_tpu_torch.nn.convert import (latest_checkpoint, warm_start,
                                       warm_start_state_dict)
from dh3d_tpu_torch.train import init_state, save_checkpoint, trainer
from dh3d_tpu_torch.train.__main__ import main as train_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")


def test_checkpoint_restores_what_the_flax_file_restores(tmp_path):
    """demo_stage2.npz into a detection model, saved by the trainer; a
    global model warm-started from that `.pt` and from the logdir gets
    the count `smart_init` gets from the npz (the local backbone), and
    every restored tensor equals the npz route's."""
    flat = load_npz(os.path.join(MODELS, "demo_stage2.npz"))
    state = init_state(tcfg.get_config("detection_config"), 0, "cpu")
    load_flax(state.model, flat)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, 7)
    assert latest_checkpoint(str(tmp_path)) == path

    from_npz = DH3D(tcfg.get_config("global_config"))
    n_npz = smart_init(from_npz, flat)
    n_local = sum(k.split("/")[1:2] == ["local_backbone"] for k in flat)
    assert n_npz == n_local
    want = from_npz.state_dict()
    saved = warm_start_state_dict(path)
    for src in (path, str(tmp_path)):
        torch.manual_seed(1)  # other fresh values than from_npz's
        glob = DH3D(tcfg.get_config("global_config"))
        fresh = {k: v.clone() for k, v in glob.state_dict().items()}
        assert warm_start(glob, src) == n_npz
        restored = 0
        for name, t in glob.state_dict().items():
            if name in saved and saved[name].shape == t.shape:
                assert torch.equal(t, want[name]), name
                assert torch.equal(t, saved[name]), name
                restored += 1
            else:  # left at its fresh value
                assert torch.equal(t, fresh[name]), name
        assert restored == n_npz


def _stage(monkeypatch, argv):
    """One in-process run of the train CLI; returns its summary and the
    model's tensors and the step as the first step found them."""
    seen = {}
    make = trainer.make_train_step

    def recording(cfg, group=None):
        step = make(cfg, group)

        def first(state, *args):
            if not seen:
                seen["step"] = state.step
                seen["model"] = {k: v.clone() for k, v in
                                 state.model.state_dict().items()}
            return step(state, *args)
        return first

    monkeypatch.setattr(trainer, "make_train_step", recording)
    summary = train_main(argv)
    monkeypatch.setattr(trainer, "make_train_step", make)
    return summary, seen


def test_curriculum_chains_through_the_ports_checkpoints(
        tmp_path, monkeypatch, capsys):
    """basic_config 2 steps; detection_config 1 step from the stage-1
    logdir; global_config 1 step from the stage-2 `step_*.pt`.  Each run
    prints and returns its count, starts at step 0 with a fresh
    optimizer, and its first step sees the saved tensors."""
    common = ["--synthetic", "--device", "cpu", "--num_points", "256",
              "--batch_size", "1"]
    runs = (("basic_config", ["--steps", "2", "--set", "sampled_kpnum=8"],
             None),
            ("detection_config", ["--steps", "1", "--set",
                                  "sampled_kpnum=8"], "logdir"),
            ("global_config", ["--steps", "1", "--set", "num_pos=1",
                               "--set", "num_neg=2"], "pt"))
    previous = None
    for name, more, source in runs:
        logdir = str(tmp_path / name)
        argv = ["--cfg", name, *common, *more, "--logdir", logdir]
        if source:
            load = (previous if source == "logdir"
                    else latest_checkpoint(previous))
            argv += ["--load", load]
        summary, seen = _stage(monkeypatch, argv)
        out = capsys.readouterr().out
        assert seen["step"] == 0
        assert os.path.basename(latest_checkpoint(logdir)) == \
            f"step_{int(more[1]):08d}.pt"
        if source is None:
            assert summary["restored"] is None
            assert "warm start" not in out
        else:
            saved = warm_start_state_dict(previous)
            own = seen["model"]
            same = [k for k, t in saved.items()
                    if k in own and own[k].shape == t.shape]
            assert summary["restored"] == len(same) > 0
            assert f"warm start: restored {len(same)} tensors from {load}" \
                in out
            for k in same:
                assert torch.equal(own[k], saved[k]), (name, k)
            if name == "detection_config":  # stage 1 is a subset of 2
                assert len(same) == len(saved)
            else:  # the local backbone
                assert set(same) == {k for k in saved
                                     if k.startswith("local_backbone.")}
        assert np.isfinite(summary["metrics"]["total_cost"])
        previous = logdir


@pytest.mark.parametrize("kind", ["text file", "empty logdir",
                                  "not a checkpoint", "missing"])
def test_warm_start_refuses_what_it_does_not_read(tmp_path, kind):
    model = DH3D(tcfg.get_config("basic_config"))
    if kind == "text file":
        path = tmp_path / "weights.txt"
        path.write_text("not weights")
        error = ValueError
    elif kind == "empty logdir":
        path = tmp_path / "run"
        path.mkdir()
        error = FileNotFoundError
    elif kind == "not a checkpoint":  # a .pt without the trainer's "model"
        path = tmp_path / "tensor.pt"
        torch.save(torch.zeros(3), path)
        error = ValueError
    else:
        path = tmp_path / "absent.npz"
        error = ValueError
    with pytest.raises(error) as e:
        warm_start(model, str(path))
    if error is ValueError:
        for word in (".npz", "step_*.pt", "logdir"):
            assert word in str(e.value)
