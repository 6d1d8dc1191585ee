"""The port's data-parallel stage-2 step (`make_train_step(cfg, mesh)`, the
ranks started by `parallel.launch.spawn`) on 2 and on 4 gloo ranks on the
CPU, against the benchmark's plain reference of its semantics
(`benchmark/reference/train_dp.py`: one process's step on the global
batch, the ranks' blocks in rank order), from the same seeded weights and
draws: 4 pairs of 512 points (2 or 1 a rank), 32 keypoints, 2 steps.

Each number is held to the stage-2 cell's limit
(`benchmark/limits/stage2_train_b10.json`): the two sides sum in other
orders in f32 (the ranks' blocks, the gradient all-reduce, other GEMM
blockings), which at that cell's size moved them by at most 3.3e-6 (loss),
2.8e-6 (median first gradient), 4.5e-5 (median change) and 5.9e-4 (worst
BatchNorm statistic) over 75 seeds, while a step on half of the pairs
moves them by 2.8e-4, 1.3e-2, 1.6e-2 and 8.3e-2."""

import numpy as np
import pytest
import torch

from benchmark.harness import ROOT, read_json
from benchmark.reference import train as ref_train
from benchmark.reference import train_dp as ref_dp
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights
from dh3d_tpu_torch.data.io import morton_sort_np
from dh3d_tpu_torch.parallel import jobs
from dh3d_tpu_torch.parallel.launch import spawn

PAIRS, N, KP, STEPS = 4, 512, 32, 2
LIMIT = {k: v["limit"] for k, v in read_json(
    ROOT, "benchmark", "limits", "stage2_train_b10.json").items()}


def _cfg(n: int) -> dict:
    cfg = read_json(ROOT, "benchmark", "configs", "dh3d_stage2.json")["config"]
    return {**cfg, "num_points": N, "sampled_kpnum": KP,
            "batch_size": PAIRS, "num_devices": n}


def _inputs(cfg, seed: int):
    """(weights, the whole batches with their draws, the raw clouds and
    draws the reference presorts and uses)."""
    g = torch.Generator().manual_seed(seed)
    clouds = scans(STEPS * PAIRS, N, g, 30.0).reshape(STEPS, PAIRS, N, 3)
    raw = clouds[None] + torch.clamp(
        0.05 * torch.randn(2, *clouds.shape, generator=g), -0.1, 0.1)
    srt = torch.from_numpy(morton_sort_np(raw.reshape(-1, N, 3).numpy())
                           ).reshape(raw.shape)
    w = calibrate(cfg, make_weights(cfg, seed, "cpu"), srt[0, 0])
    batches, steps = [], []
    for s in range(STEPS):
        angles = (torch.rand(PAIRS, generator=g) * 2 - 1) * cfg["rot_maxv"]
        subsets = torch.argsort(torch.rand(PAIRS, N, generator=g),
                                dim=1)[:, :N // 2]
        batches.append({"pc1": srt[0, s], "pc2": srt[1, s],
                        "pairgen_draws": (angles, subsets)})
        steps.append({"pc1": raw[0, s], "pc2": raw[1, s], "angles": angles,
                      "subsets": subsets})
    return w, batches, steps


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sides(request):
    """(weights, every rank's `steps_job` result, the reference's)."""
    n = request.param
    cfg = _cfg(n)
    w, batches, steps = _inputs(cfg, 23)
    ranks = spawn(jobs.steps_job, n, (cfg, w, batches))
    b = PAIRS // n
    blocks = [[{k: v[r * b:(r + 1) * b] for k, v in s.items()}
               for r in range(n)] for s in steps]
    return w, ranks, ref_dp.train(cfg, w, blocks)


def test_first_loss_matches_the_reference(sides):
    _, ranks, ref = sides
    got = ranks[0]["steps"][0]["metrics"]["total_cost"].item()
    assert abs(got - ref["losses"][0]) / abs(ref["losses"][0]) <= \
        LIMIT["first_loss_gap"], (got, ref["losses"][0])


def test_first_gradient_matches_the_reference(sides):
    _, ranks, ref = sides
    assert set(ranks[0]["grads"]) == set(ref["grad0"])
    assert ref_train.median_gap(ranks[0]["grads"], ref["grad0"]) <= \
        LIMIT["grad_median_gap"]


def _changes(side: dict, w: dict, names) -> dict:
    return {n: side[n] - w[n] for n in names}


def test_change_after_two_steps_matches_the_reference(sides):
    """The moving leaves (reference gradient at least 1e-3 of the median
    leaf's; the biases that feed a BatchNorm are nought to rounding)."""
    w, ranks, ref = sides
    norms = {n: float(torch.linalg.vector_norm(g))
             for n, g in ref["grad0"].items()}
    med = float(np.median(list(norms.values())))
    moving = [n for n, v in norms.items() if v >= 1e-3 * med]
    gap = ref_train.median_gap(_changes(ranks[0]["state"], w, moving),
                               _changes(ref["params"], w, moving))
    assert gap <= LIMIT["change_median_gap"]


def test_batchnorm_statistics_match_the_reference(sides):
    w, ranks, ref = sides
    gap, leaf = ref_train.norm_gaps(
        _changes(ranks[0]["state"], w, ref["stats"]),
        _changes(ref["stats"], w, ref["stats"]))
    assert gap <= LIMIT["bn_stat_gap"], leaf


def test_every_rank_holds_one_state(sides):
    _, ranks, _ = sides
    for r in ranks[1:]:
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k
        for mine, first in zip(r["steps"], ranks[0]["steps"]):
            for k, v in first["metrics"].items():
                assert torch.equal(mine["metrics"][k], v), k
