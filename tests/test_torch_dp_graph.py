"""The data-parallel step's graphs and counters on the CPU: when a step
over a process group may be graphed (stand-in groups of each backend),
the collectives' counters (`collective.calls.<op>`,
`collective.bytes.<op>`) of one eager step on 2 gloo ranks against the
step's shapes, a `Recording` taking back what its capture counted and
adding it on replay (an empty capture's too), the model's mode and BatchNorm group set once a
state, and the prefetch thread on the rank's card.  The card tests
(`tests/test_torch_cuda_paths.py -k graphed_data_parallel`) hold the
graphed NCCL step to the eager one."""

import contextlib
import threading
import warnings

import pytest
import torch
import torch.distributed as dist

from dh3d_tpu_torch import trace
from dh3d_tpu_torch.config import get_config
from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher
from dh3d_tpu_torch.parallel import collectives, jobs
from dh3d_tpu_torch.parallel.launch import spawn
from dh3d_tpu_torch.parallel.mesh import Mesh
from dh3d_tpu_torch.train import add_draws, graphs, init_state, trainer

N, KP, B = 256, 8, 2


def small_cfg(**overrides):
    cfg = get_config("detection_config")
    cfg.update(num_points=N, batch_size=B, sampled_kpnum=KP,
               device_pairgen=True, morton_presorted=True)
    cfg.update(overrides)
    return cfg


def pair_batch(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    pc1 = torch.randn(B, N, 3, generator=g) * 5
    return {"pc1": pc1, "pc2": pc1 + 0.01 * torch.randn(B, N, 3, generator=g)}


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    was = trace.enable(False)
    yield
    trace.enable(was)
    trace.reset()


class StubGroup:
    """A process group as `eager_reason` sees it: a backend by name."""

    def __init__(self, backend: str):
        self.backend = backend


@pytest.fixture
def stub_backends(monkeypatch):
    real = dist.get_backend

    def backend(group=None):
        if isinstance(group, StubGroup):
            return group.backend
        return real(group)
    monkeypatch.setattr(dist, "get_backend", backend)


@pytest.mark.parametrize("groups, reason", [
    (("gloo",), "gloo collectives"),
    (("nccl",), "not on CUDA"),
    (("cuda:nccl,cpu:gloo",), "not on CUDA"),
    (("nccl", "gloo"), "gloo collectives"),
], ids=["gloo", "nccl", "nccl-and-gloo", "mesh-nccl-gloo"])
def test_eager_reason_under_a_group(stub_backends, groups, reason):
    """A gloo group keeps the step eager by its own reason; an NCCL group
    (or a mesh of NCCL groups) does not, so the CPU batch is what keeps
    this one eager; a mesh with a gloo axis is gloo's."""
    cfg = small_cfg()
    state = init_state(cfg, 0, "cpu")
    batch = add_draws(pair_batch(), cfg, torch.Generator().manual_seed(1))
    sig = graphs.signature(batch)
    stubs = tuple(StubGroup(b) for b in groups)
    group = stubs[0] if len(stubs) == 1 else Mesh(
        ("dcn", "data"), {"dcn": 1, "data": 1}, stubs, torch.device("cpu"))
    assert collectives.backends(group) == groups
    assert graphs.eager_reason(state, cfg, group, batch, sig, sig) == reason


def test_backends_of_no_process_group():
    assert collectives.backends(None) == ()
    assert collectives.backends(object()) == (None,)


def _gathered_bytes(pairs: int, feat: int = 128) -> tuple:
    """(forward, backward) bytes the all-gathers of a step of `pairs`
    pairs hand over: xyz, feat, the keypoint ids (int64), their xyz, feat
    and attention, and R; the keypoints' feat and attention sent back."""
    c = 2 * pairs
    fwd = (c * N * 3 * 4 + c * N * feat * 4 + c * KP * 8 + c * KP * 3 * 4
           + c * KP * feat * 4 + c * KP * 4 + pairs * 9 * 4)
    return fwd, c * KP * feat * 4 + c * KP * 4


def test_collective_counters_of_one_eager_step_on_two_ranks():
    """One step on 2 gloo ranks: each rank's counters add, per call, the
    bytes of the whole tensor handed to the backend.  All-reduces: each of
    the 11 BatchNorms' [2C + 1] f32 sums forward and backward (the CPU's
    plain BatchNorm) and the flat gradient; all-gathers: the 7 loss
    inputs and the 2 of them that carry a gradient."""
    cfg = small_cfg(num_devices=2)
    batch = add_draws(pair_batch(3), cfg, torch.Generator().manual_seed(4))
    state = init_state(cfg, 0, "cpu")
    weights = state.model.state_dict()
    widths = [m.scale.numel() for m in state.model.modules()
              if type(m).__name__ == "BatchNorm"]
    params = sum(p.numel() for p in state.model.parameters())
    ranks = spawn(jobs.steps_job, 2, (dict(cfg), weights, [batch]))
    fwd, bwd = _gathered_bytes(B)
    want = {"collective.calls.all_reduce": 2 * len(widths) + 1,
            "collective.bytes.all_reduce":
                2 * 4 * sum(2 * c + 1 for c in widths) + 4 * params,
            "collective.calls.all_gather": 9,
            "collective.bytes.all_gather": fwd + bwd}
    assert len(widths) == 11
    for r in ranks:
        assert r["steps"][0]["collectives"] == want


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph`: never empty."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


def test_recording_adds_on_replay_what_its_capture_counted(monkeypatch):
    """Collectives issued while capturing count there and are taken back;
    each replay adds them again, as launches are."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    group = StubGroup("nccl")
    t = torch.zeros(6)

    def fn():
        with trace.span("step.loss"):
            collectives.reduce_(t, group, "all_gather")
        collectives.reduce_(t[:2], group)

    rec = graphs.Recording(pool=None, stream=_Stream())
    rec.capture(fn)
    assert trace.tally() == {}
    assert [i[1] for i in rec.items if i[0] == "open"] == [
        "step.loss", "collective.all_gather", "collective.all_reduce"]
    for _ in range(2):
        rec.replay()
    assert trace.tally() == {
        "collective.calls.all_gather": 2, "collective.bytes.all_gather": 48,
        "collective.calls.all_reduce": 2, "collective.bytes.all_reduce": 16}


def test_step_sets_mode_and_batchnorm_group_once_a_state(monkeypatch):
    """Not every step: when a state first meets the step function, and
    again after the model was put in eval mode."""
    calls = []
    real = trainer.sync_batchnorm
    monkeypatch.setattr(trainer, "sync_batchnorm", lambda m, g: (
        calls.append(g), real(m, g)))
    cfg = small_cfg()
    state = init_state(cfg, 0, "cpu")
    step = trainer.make_train_step(cfg)
    for s in range(2):
        step(state, pair_batch(s), torch.Generator().manual_seed(s))
    assert calls == [None]
    state.model.eval()
    step(state, pair_batch(2), torch.Generator().manual_seed(2))
    assert calls == [None, None] and state.model.training
    other = init_state(cfg, 1, "cpu")
    step(other, pair_batch(3), torch.Generator().manual_seed(3))
    assert len(calls) == 3


def test_prefetch_thread_loads_on_the_given_card(monkeypatch):
    """The loading thread makes the rank's card its current device before
    the first item: the loaders' kernel I runs on the current device."""
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(
        (torch.device(d), threading.get_ident())))

    def items():
        yield len(seen)
        yield len(seen)

    got = list(ThreadedPrefetcher(items(), depth=1,
                                  device=torch.device("cuda", 2)))
    assert got == [1, 1]
    assert seen[0][0] == torch.device("cuda", 2)
    assert seen[0][1] != threading.get_ident()
    seen.clear()
    assert list(ThreadedPrefetcher(iter([5]), device="cpu")) == [5]
    assert list(ThreadedPrefetcher(iter([6]))) == [6] and seen == []


def test_an_empty_capture_keeps_what_it_counted(monkeypatch):
    """A collective over one rank launches nothing and its graph is empty;
    a replay still adds its counts."""
    class Empty(_Graph):
        def capture_end(self):
            warnings.warn("The CUDA Graph is empty.")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Empty)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    rec = graphs.Recording(pool=None, stream=_Stream())
    rec.capture(lambda: collectives.reduce_(torch.zeros(3), StubGroup(
        "nccl")))
    assert [i[1] for i in rec.items if i[0] == "graph"] == [None]
    rec.replay()
    assert trace.tally() == {"collective.calls.all_reduce": 1,
                             "collective.bytes.all_reduce": 12}


def test_train_cli_reports_the_collectives_under_num_devices(tmp_path):
    """`--num_devices 2 --device cpu`, one step: rank 0's `counters` hold
    the step's eager count and its collectives' calls (23 all-reduces, 9
    all-gathers, as above) and bytes."""
    from dh3d_tpu_torch.train.__main__ import main

    s = main(["--cfg", "detection_config", "--synthetic", "--device", "cpu",
              "--steps", "1", "--num_points", str(N), "--batch_size", "2",
              "--set", f"sampled_kpnum={KP}", "--num_devices", "2",
              "--logdir", str(tmp_path / "run")])
    got = s["counters"]
    assert got["train.eager_steps"] == 1
    assert got["collective.calls.all_reduce"] == 23
    assert got["collective.calls.all_gather"] == 9
    assert got["collective.bytes.all_reduce"] > 0
    assert got["collective.bytes.all_gather"] > 0
