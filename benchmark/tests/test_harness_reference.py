"""Every cell, shrunk, run on the CPU through its driver: the program (the
port's plain CPU paths) and the plain reference agree within the cell's
limits, and each fault planted in the program's timed path makes
`correct` false."""

import numpy as np
import pytest
import torch

from benchmark.tests import tiny

CELLS = tiny.CELLS


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name, tmp_path):
    cell = tiny.tiny_cell(name)
    win, checks = tiny.run_cell(cell, seed=2 ** 31 + 77, tmp=tmp_path)
    assert win["units"] > 0 and win["failed"] <= win["attempted"]
    assert tiny.correct(checks), checks


def _extract_alter(monkeypatch):
    import dh3d_tpu_torch.train as tr

    real = tr.make_eval_step

    def make(cfg, model):
        step = real(cfg, model)

        def altered(batch):
            outs = step(batch)
            outs["local_desc"] = outs["local_desc"].clone()
            outs["local_desc"][0, 0, 0] += 1e-2
            return outs
        return altered
    monkeypatch.setattr(tr, "make_eval_step", make)


def _extract_half(monkeypatch):
    import dh3d_tpu_torch.train as tr

    real = tr.make_eval_step

    def make(cfg, model):
        step = real(cfg, model)

        def half(batch):
            pts = batch["points"]
            h = pts.shape[0] // 2
            outs = step({"points": pts[:h]})
            return {k: torch.cat([v, v[:pts.shape[0] - h]])
                    for k, v in outs.items()}
        return half
    monkeypatch.setattr(tr, "make_eval_step", make)


def _train_unchanged(monkeypatch):
    import torch.optim

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)


def _train_half(monkeypatch):
    import dh3d_tpu_torch.train.trainer as trainer

    real = trainer.prepare_batch

    def half(batch, cfg):
        out = real(batch, cfg)
        B = out["R"].shape[0]
        h = B // 2
        pts, inds = out["points"], out["sample_inds"]
        return {"points": torch.cat([pts[:h], pts[B:B + h]]),
                "sample_inds": torch.cat([inds[:h], inds[B:B + h]]),
                "R": out["R"][:h]}
    monkeypatch.setattr(trainer, "prepare_batch", half)


def _query_pose(monkeypatch):
    import dh3d_tpu_torch.eval.registration as reg

    real = reg.ransac_rigid

    def moved(*a, **k):
        res = real(*a, **k)
        if res is not None:
            res.t = res.t + np.array([0.5, 0.0, 0.0])
        return res
    monkeypatch.setattr(reg, "ransac_rigid", moved)


def _query_retrieval(monkeypatch):
    import dh3d_tpu_torch.eval.retrieval as retr

    real = retr.retrieve
    monkeypatch.setattr(retr, "retrieve",
                        lambda db, q, k: (real(db, q, k) + 1) % len(db))


def _raw_rows(monkeypatch):
    import dh3d_tpu_torch.eval.extract as ex

    real = ex.write_to_bin

    def altered(rows, path):
        rows = np.array(rows)
        rows[0, 3] += 1e-2
        real(rows, path)
    monkeypatch.setattr(ex, "write_to_bin", altered)


def _raw_cloud(monkeypatch):
    import dh3d_tpu_torch.data.datasets as ds

    real = ds.get_fixednum_pcd

    def moved(*a, **k):
        cloud, n = real(*a, **k)
        return cloud + np.float32(0.01), n
    monkeypatch.setattr(ds, "get_fixednum_pcd", moved)


FAULTS = [("full_extract_b20", _extract_alter),
          ("full_extract_b20", _extract_half),
          ("stage2_train_b10", _train_unchanged),
          ("stage2_train_b10", _train_half),
          ("full_query_b1", _query_pose),
          ("full_query_b1", _query_retrieval),
          ("stage2_extract_raw_n16384", _raw_rows),
          ("stage2_extract_raw_n16384", _raw_cloud)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            tmp_path):
    cell = tiny.tiny_cell(name)
    fault(monkeypatch)
    _, checks = tiny.run_cell(cell, seed=5, tmp=tmp_path)
    assert not tiny.correct(checks), checks
