"""The port's checkpoint exporter against the JAX package, on the CPU.

`nn.convert.flax_from_state_dict` is the inverse of `state_dict_from_flax`:
both committed checkpoints go through `load_flax` and back bit for bit,
and for every preset and the conv1d global backbone the exported keys and
shapes are the JAX `init_variables` tree's.  `python -m
dh3d_tpu_torch.scripts.package_checkpoint` exports a model the port
trained; the JAX `resolve_model` reads the pair, and the JAX forward on it
gives the port's forward within `tests/test_torch_model.py`'s limits
(`xyz` and `knn_indices` equal, floats within 1e-4, `feat` within 1e-5 of
its largest).  Small sizes: 256 points, batch 2.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dh3d_tpu import config as jcfg
from dh3d_tpu.eval.extract import make_forward as jax_make_forward
from dh3d_tpu.nn import init_variables
from dh3d_tpu.train import resolve_model as jax_resolve_model
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch.entry import entry_points
from dh3d_tpu_torch.eval import make_forward
from dh3d_tpu_torch.nn import DH3D, flax_from_state_dict, load_flax, load_npz
from dh3d_tpu_torch.scripts import package_checkpoint
from dh3d_tpu_torch.train import (init_state, make_train_step,
                                  save_checkpoint, synthetic_batches,
                                  to_device)
from test_torch_model import _compare, flatten_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
N, KP = 256, 8


@pytest.mark.parametrize("stem,name,count", [
    ("demo_stage2", "detection_config", 81),
    ("demo_stage3", "global_config", 92)])
def test_committed_checkpoints_round_trip(stem, name, count):
    """load_flax, then export: the same keys, every array bit-equal, the
    step kept as int32."""
    flat = load_npz(os.path.join(MODELS, f"{stem}.npz"))
    assert len(flat) == count
    model = DH3D(tcfg.get_config(name))
    load_flax(model, flat)
    out = flax_from_state_dict(model, step=int(flat["step"]))
    assert set(out) == set(flat)
    for k, v in flat.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert out["step"].dtype == np.int32 and out["step"].shape == ()


def _conv1d_global():
    cfg = jcfg.get_config("global_config")
    cfg.global_backbone = "global_before_assemble_conv1d"
    return cfg


@pytest.mark.parametrize("name", ["basic_config", "detection_config",
                                  "global_config", "conv1d"])
def test_exported_tree_is_the_jax_tree(name):
    """The export of a fresh port model has the keys and shapes of the
    flattened JAX `init_variables(cfg)` (shapes only: `jax.eval_shape`)."""
    jc = _conv1d_global() if name == "conv1d" else jcfg.get_config(name)
    tc = tcfg.get_config("global_config" if name == "conv1d" else name)
    tc.global_backbone = jc.global_backbone
    variables = jax.eval_shape(
        lambda: init_variables(jc, jax.random.PRNGKey(0)))
    want = {k: v.shape for k, v in flatten_variables(
        jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                               variables)).items()}
    got = {k: v.shape for k, v in flax_from_state_dict(DH3D(tc)).items()}
    assert got == want


def test_refuses_what_it_cannot_name():
    model = DH3D(tcfg.get_config("basic_config"))
    model.local_backbone.register_buffer("stray", torch.zeros(3))
    with pytest.raises(ValueError, match="stray"):
        flax_from_state_dict(model)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A detection_config model trained 2 steps on the CPU, saved as the
    trainer saves it: <logdir>/config.json and ckpt/step_*.pt."""
    logdir = str(tmp_path_factory.mktemp("run"))
    cfg = tcfg.get_config("detection_config")
    cfg.num_points, cfg.batch_size, cfg.sampled_kpnum = N, 1, KP
    tcfg.save_config(cfg, os.path.join(logdir, "config.json"))
    state = init_state(cfg, 0, "cpu")
    step = make_train_step(cfg)
    batches = synthetic_batches(cfg, 0)
    for _ in range(2):
        step(state, to_device(next(batches), "cpu"))
    path = save_checkpoint(os.path.join(logdir, "ckpt"), state)
    return logdir, path, state


def test_cli_export_reads_in_jax(trained, tmp_path, capsys):
    """The CLI on the logdir: JAX `resolve_model` reads the pair and its
    forward gives the port's; `load_flax` of the export gives the model's
    state dict back."""
    logdir, _, state = trained
    stem = str(tmp_path / "out" / "stage2")
    flat = package_checkpoint.main(["--ckpt", logdir, "--out", stem])
    assert f"{stem}.npz:" in capsys.readouterr().out
    assert int(flat["step"]) == 2
    assert os.path.isfile(stem + ".config.json")

    cfg = tcfg.load_config(stem + ".config.json")
    back = DH3D(cfg)
    assert load_flax(back, load_npz(stem + ".npz")) == len(flat)
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k

    jc, variables = jax_resolve_model(stem)
    assert jc.num_points == N
    jc.sampled_kpnum = cfg.sampled_kpnum = -1  # no keypoints in eval
    pts = entry_points(2, N, seed=5) / np.float32(3.0)
    _compare(jax_make_forward(jc, variables)(pts),
             make_forward(cfg, back)(pts))


def test_cli_on_a_checkpoint_file(trained, tmp_path):
    """A step_*.pt exports without a .config.json (its config comes from
    two levels up); anything else is refused."""
    logdir, path, _ = trained
    stem = str(tmp_path / "from_pt")
    flat = package_checkpoint.main(["--ckpt", path, "--out", stem])
    assert os.path.isfile(stem + ".npz")
    assert not os.path.exists(stem + ".config.json")
    from_logdir = package_checkpoint.export(logdir, str(tmp_path / "dir"))
    for k, v in from_logdir.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    lone = tmp_path / "lone" / "step_00000001.pt"
    lone.parent.mkdir()
    lone.write_bytes(open(path, "rb").read())
    for bad in (str(lone), os.path.join(MODELS, "demo_stage2.npz"),
                str(tmp_path / "missing")):
        with pytest.raises(ValueError):
            package_checkpoint.main(["--ckpt", bad, "--out",
                                     str(tmp_path / "bad")])
