"""The stage-3 cell, shrunk, on the CPU: the program's step agrees with
the plain reference, the frozen backbone stays bit for bit, and each fault
planted in the program's timed path makes `correct` false."""

import pytest
import torch

from benchmark.tests import tiny

NAME = "stage3_global_train_b24"


def test_the_frozen_backbone_is_unchanged_and_choices_agree():
    _, checks = tiny.run_cell(tiny.tiny_cell(NAME), seed=2 ** 31 + 5)
    got = {n: v for n, v, _ in checks}
    assert got["frozen_changed"] == 0.0
    assert got["choice_gap"] <= tiny.tiny_cell(NAME)["limits"][
        "choice_gap"]["limit"]
    assert tiny.correct(checks), checks


def _backbone_trainable(monkeypatch):
    import dh3d_tpu_torch.train.trainer as trainer

    monkeypatch.setattr(trainer, "param_labels", lambda cfg, model: {
        n: "trainable" for n, _ in model.named_parameters()})


def _second_hinge_dropped(monkeypatch):
    from dh3d_tpu_torch.losses import losses

    def triplet_only(global_descs, batch_size, num_pos, num_neg,
                     global_triplet_margin=0.5, **unused):
        q, pos, neg, _ = losses._split_tuple(global_descs, batch_size,
                                             num_pos, num_neg, other_neg=True)
        trip = losses._lazy_triplet_impl(q, pos, neg, global_triplet_margin)
        return trip, {"triplet_loss": trip}
    monkeypatch.setitem(losses.GLOBAL_LOSSES, "lazy_quadruplet_loss",
                        triplet_only)


def _head_on_running_statistics(monkeypatch):
    from dh3d_tpu_torch.nn import model

    real = model.DH3D.train

    def train(self, mode=True):
        real(self, mode)
        for name in ("global_backbone", "globalatt", "global_assemble"):
            getattr(self, name).train(False)
        return self
    monkeypatch.setattr(model.DH3D, "train", train)


def _head_gemms_in_bf16(monkeypatch):
    from dh3d_tpu_torch.nn import backbones

    for cls in (backbones.GlobalAttBlock, backbones.NetVLAD):
        real = cls.forward

        def forward(self, *args, _real=real):
            with torch.autocast(args[0].device.type, dtype=torch.bfloat16):
                return _real(self, *args)
        monkeypatch.setattr(cls, "forward", forward)


FAULTS = [_backbone_trainable, _second_hinge_dropped,
          _head_on_running_statistics, _head_gemms_in_bf16]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, checks = tiny.run_cell(tiny.tiny_cell(NAME), seed=5)
    assert not tiny.correct(checks), checks
