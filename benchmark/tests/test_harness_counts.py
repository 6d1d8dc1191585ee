"""The model-FLOP count against torch.utils.flop_counter on the plain
reference's forward, and the kernel bounds against hand counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark.reference import model as ref
from benchmark.scans import scans
from benchmark.weights import make_weights


@pytest.mark.parametrize("config", ["dh3d_full", "dh3d_stage2"])
def test_model_flops_match_the_flop_counter(config):
    cfg = harness.read_json(harness.ROOT, "benchmark", "configs",
                            config + ".json")["config"]
    B, N = 2, 256
    cfg = {**cfg, "num_points": N, "morton_presorted": False}
    w = make_weights(cfg, 1, "cpu")
    pts = scans(B, N, torch.Generator().manual_seed(0), 8.0)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(cfg, w, pts)
    assert counts.model_flops(cfg, B, N) == fc.get_total_flops()


def test_model_flops_by_hand():
    # the detection block alone at one cloud of 4 points:
    # 2 * 4 * (128*128 + 128*256 + 256*1024 + 1024*1)
    assert counts.detection_flops(1, 4) == 8 * (16384 + 32768 + 262144
                                                + 1024)
    cfg = {"detection": True, "extract_global": False}
    assert counts.train_flops(cfg, 1, 64) == 3 * counts.model_flops(
        cfg, 2, 64)


def test_kernel_bounds_by_hand():
    # self kNN, 2 clouds of 1000 points, k = 8: the points read once
    # (2*1000*3 f32) and the ids (int32) and squared distances written
    nbytes = 2 * 1000 * 3 * 4 + 2 * 1000 * 8 * (4 + 4)
    assert counts.knn_bound(2, 1000, 1000, 8, True) == pytest.approx(
        nbytes / 3.35e12)
    # FPS of 64 from 1000: 8 operations a point an iteration bound it
    assert counts.fps_bound(1, 1000, 64) == pytest.approx(
        8 * 1000 * 64 / 67e12)
    # a 3-NN interpolation of 128 channels from 100 to 800 points
    nbytes = (100 * 128 * 4 + 800 * 3 * 4 + 800 * 3 * 4 + 800 * 128 * 4)
    assert counts.wsum_bound(1, 800, 100, 3, 128) == pytest.approx(
        nbytes / 3.35e12)
