"""The data-parallel cell, shrunk, on 4 gloo ranks on the CPU: the ranks
agree bit for bit, the window reports the program's counters, and each
planted fault makes `correct` false; its bus bytes by hand; its readers
on given numbers; NCCL's kernels filed under their own class."""

import pytest

from benchmark import counts, dp_counts, harness
from benchmark.drivers import common
from benchmark.readers import collective_roofline, counter_share, mfu
from benchmark.tests import tiny

NAME = "stage2_train_dp4_b128"
SEED = 2 ** 31 + 21


def test_the_ranks_agree_and_the_window_counts_collectives():
    cell = tiny.tiny_cell(NAME)
    assert cell["cfg"]["num_devices"] == 4 == cell["entry"]["chips"]
    win, checks = tiny.run_cell(cell, seed=SEED)
    got = {n: v for n, v, _ in checks}
    assert got["rank_gap"] == 0.0
    assert tiny.correct(checks), checks
    counters = win["counters"]
    assert counters["train.eager_steps"] == win["units"]  # gloo: eager
    # a step: 11 BatchNorms' sums forward and backward and the gradient;
    # 7 gathered loss inputs and 2 gradients sent back
    assert counters["collective.calls.all_reduce"] == 23 * win["units"]
    assert counters["collective.calls.all_gather"] == 9 * win["units"]
    ctx = {"window": win, "counts": {"flops_per_unit": 1.0}}
    assert counter_share.read(ctx, "train.graph_replays") == 0.0


@pytest.mark.parametrize("fault", ["bn", "sum", "swap"])
def test_a_planted_fault_is_not_correct(fault):
    """Sync BatchNorm off, the gradients summed and not averaged, two
    ranks on each other's clouds: each caught."""
    cell = tiny.tiny_cell(NAME)
    run = tiny.driver(cell).Run(cell, SEED, tiny.CPU, fault=fault)
    run.release()
    assert not tiny.correct(run.check())


def test_bus_bytes_by_hand():
    cfg = {"sampled_kpnum": 2, "featdim": 4, "num_points": 8,
           **{k: harness.read_json(harness.ROOT, "benchmark", "configs",
                                   "dh3d_stage2.json")["config"][k]
              for k in ("detection", "extract_global")}}
    # 1 pair (2 clouds of 8 points) over 2 ranks: each gathered tensor
    # half sent; the two with a gradient twice
    gathered = (2 * 8 * 3 * 4 + 2 * 8 * 4 * 4 + 2 * 2 * 8 + 2 * 2 * 3 * 4
                + 2 * (2 * 2 * 4 * 4 + 2 * 2 * 4) + 9 * 4)
    bn = sum(2 * (2 * c + 1) * 8 for c in dp_counts.batchnorm_widths(cfg))
    assert len(dp_counts.batchnorm_widths(cfg)) == 11
    params = 489073  # the stage-2 model's parameters
    want = gathered / 2 + bn + params * 4
    assert dp_counts.stage2_step_bus_bytes(cfg, 1, 8, 2) == \
        pytest.approx(want)
    assert dp_counts.all_reduce(100, 4) == 150
    assert dp_counts.all_gather(100, 4) == 75


def test_readers_on_given_numbers():
    prof = {"iters": 3, "class_s": {"nccl": 0.006}}
    ctx = {"profile": prof, "counts": {"bus_bytes_per_unit": 450e6}}
    # 3 units of 1 ms at the peak, in 6 ms of NCCL kernels: 50%
    assert collective_roofline.read(ctx, "nccl", 450e9) == pytest.approx(50)
    assert collective_roofline.read({"profile": prof, "counts": {}},
                                    "nccl", 450e9) is None
    win = {"units": 4, "seconds": 2.0, "counters": {"train.graph_replays":
                                                    3}}
    assert counter_share.read({"window": win},
                              "train.graph_replays") == 75.0
    del win["counters"]  # a program that reports none
    assert counter_share.read({"window": win}, "train.graph_replays") is None


def test_mfu_reads_a_cards_share_of_the_global_batch():
    """The driver counts each FLOP of the global batch once and gives a
    card its share, so the shared `mfu` reader divides by one card's
    peak."""
    cell = harness.load_cell(NAME)
    run = tiny.driver(cell).Run.__new__(tiny.driver(cell).Run)
    run.cfg = cfg = common.port_cfg(cell["cfg"])
    run.n, run.B, run.N = 4, cfg.batch_size, cfg.num_points
    got = run.counts()
    assert got["flops_per_unit"] * 4 == pytest.approx(
        counts.train_flops(cfg, 128, 8192))
    win = {"units": 2, "seconds": 1.0}
    assert mfu.read({"window": win, "counts": got}) == pytest.approx(
        100.0 * counts.train_flops(cfg, 128, 8192) * 2 / 4
        / counts.PEAK_F32_FLOPS)


def test_nccl_kernels_have_their_own_class():
    from benchmark import trace

    classes = trace.device_classes()
    assert trace.classify("ncclDevKernel_AllReduce_Sum_f32_RING_LL", classes
                          ) == "nccl"
    assert trace.classify("void at::native::reduce_kernel<128, 4>",
                          classes) == "elementwise"
