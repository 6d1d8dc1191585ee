"""The train step's CUDA graphs (`dh3d_tpu_torch/train/graphs.py`) on the
CPU: when the step may be graphed and why not, the batch signature, the
capturable optimizer, `restore_state` dropping a state's graphs, the CPU
step unchanged and counted, the spans' cut hook (`trace.cutting`), the
inverse holders a step makes (`collect_inverses`), and a `Recording`'s
cuts, replay and launch counts against a stand-in for `CUDAGraph`.  The
card tests (`tests/test_torch_cuda_paths.py -k graph`) hold the graphed
step to the eager one at full width."""

import contextlib
import threading
import warnings

import pytest
import torch

from dh3d_tpu_torch import kernels, trace
from dh3d_tpu_torch.config import get_config
from dh3d_tpu_torch.ops import neighborhood
from dh3d_tpu_torch.train import (
    add_draws,
    apply_gradients,
    forward_loss,
    graphs,
    init_state,
    make_train_step,
    prepare_batch,
    restore_state,
    save_checkpoint,
)
from dh3d_tpu_torch.train.trainer import set_lr

N, KP, B = 256, 8, 2


def small_cfg(**overrides):
    """detection_config at the CPU tests' size, pairs made in the step."""
    cfg = get_config("detection_config")
    cfg.update(num_points=N, batch_size=B, sampled_kpnum=KP,
               device_pairgen=True, morton_presorted=True)
    cfg.update(overrides)
    return cfg


def pair_batch(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    pc1 = torch.randn(B, N, 3, generator=g) * 5
    return {"pc1": pc1, "pc2": pc1 + 0.01 * torch.randn(B, N, 3, generator=g)}


def with_draws(cfg, seed=0, batch=None):
    return add_draws(batch or pair_batch(seed), cfg,
                     torch.Generator().manual_seed(100 + seed))


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    was = trace.enable(False)
    yield
    trace.enable(was)
    trace.reset()


# ------------------------------ when to graph ------------------------------

@pytest.mark.parametrize("case, reason", [
    ("plain", "not on CUDA"),
    ("group", "data parallel"),
    ("remat", "remat"),
    ("morton", "Morton sort in the step"),
    ("signature", "another batch signature"),
])
def test_eager_reason_names_what_keeps_a_step_eager(case, reason):
    """Each blocker alone, on an otherwise plain CPU step: a process group,
    `remat`, a Morton sort in the step (the model's config decides), a
    batch of another signature than the step function's; with none of
    them, the CPU itself."""
    cfg = small_cfg(remat=case == "remat")
    state = init_state(cfg, 0, "cpu")
    if case == "morton":
        state.model.cfg.morton_presorted = False
    batch = with_draws(cfg)
    sig = graphs.signature(batch)
    first = sig
    if case == "signature":
        first = graphs.signature(with_draws(cfg, batch={
            k: v[:1] for k, v in pair_batch().items()}))
    group = object() if case == "group" else None
    assert graphs.eager_reason(state, cfg, group, batch, sig,
                               first) == reason


def test_signature_sees_keys_shapes_dtypes_and_draws():
    """Equal for another batch of the same form; different for a changed
    shape, dtype or key, or other draws (their sizes, their names)."""
    cfg = small_cfg(augment_on_device=True)
    a = add_draws(pair_batch(0), cfg, torch.Generator().manual_seed(1),
                  torch.Generator().manual_seed(2))
    b = add_draws(pair_batch(1), cfg, torch.Generator().manual_seed(3),
                  torch.Generator().manual_seed(4))
    sig = graphs.signature(a)
    assert graphs.signature(b) == sig
    assert graphs.signature({**a, "pc1": a["pc1"][:1]}) != sig
    assert graphs.signature({**a, "pc1": a["pc1"].double()}) != sig
    assert graphs.signature({k: v for k, v in a.items()
                             if k != "pairgen_draws"}) != sig
    angles, subsets = a["pairgen_draws"]
    assert graphs.signature({**a, "pairgen_draws": (angles, subsets[:, :4])
                             }) != sig
    (name, draw), = a["aug_draws"]
    assert graphs.signature({**a, "aug_draws": [("Shift", draw)]}) != sig


def test_hooked_sees_module_and_global_hooks():
    model = init_state(small_cfg(), 0, "cpu").model
    assert not graphs.hooked(model)
    h = model.local_backbone.register_forward_hook(lambda *a: None)
    assert graphs.hooked(model)
    h.remove()
    assert not graphs.hooked(model)
    h = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *a: None)
    try:
        assert graphs.hooked(model)
    finally:
        h.remove()


# ------------------------------ the optimizer ------------------------------

def test_make_optimizer_is_capturable_only_on_cuda_parameters():
    """CPU parameters: plain Adam, a number for its learning rate, which
    `set_lr` sets; a device-tensor learning rate is filled in place."""
    cfg = small_cfg()
    opt = init_state(cfg, 0, "cpu").optimizer
    for g in opt.param_groups:
        assert g["capturable"] is False and isinstance(g["lr"], float)
    set_lr(opt, 0.25)
    assert all(g["lr"] == 0.25 for g in opt.param_groups)
    lr = torch.tensor(1.0)
    holder = type("Opt", (), {"param_groups": [{"lr": lr}]})()
    set_lr(holder, 0.5)
    assert holder.param_groups[0]["lr"] is lr and float(lr) == 0.5


def test_restore_state_drops_the_graphs_and_keeps_the_optimizer_form(
        tmp_path):
    cfg = small_cfg()
    state = init_state(cfg, 0, "cpu")
    make_train_step(cfg)(state, pair_batch(), torch.Generator().manual_seed(1))
    path = save_checkpoint(str(tmp_path), state)
    fresh = init_state(cfg, 1, "cpu")
    fresh.graph = graphs.StepGraph(owner=None)
    restore_state(path, fresh)
    assert fresh.graph is None and fresh.step == 1
    for g in fresh.optimizer.param_groups:
        assert g["capturable"] is False and isinstance(g["lr"], float)


# ------------------------------ the CPU step ------------------------------

def test_cpu_step_is_the_eager_step_and_counted():
    """Two steps of `make_train_step` on the CPU equal the same steps
    written out (`prepare_batch`, `forward_loss`, backward,
    `apply_gradients`) bit for bit, run eagerly, count as eager steps, and
    leave the state without graphs."""
    cfg = small_cfg()
    ran, by_hand = init_state(cfg, 0, "cpu"), init_state(cfg, 0, "cpu")
    step = make_train_step(cfg)
    for s in range(2):
        got = step(ran, pair_batch(s), torch.Generator().manual_seed(s))
        batch = prepare_batch(add_draws(
            pair_batch(s), cfg, torch.Generator().manual_seed(s)), cfg)
        by_hand.model.train()
        total, want, _ = forward_loss(by_hand.model, cfg, batch)
        by_hand.optimizer.zero_grad(set_to_none=True)
        total.backward()
        apply_gradients(by_hand, cfg)
        for k, v in want.items():
            assert torch.equal(got[k], torch.as_tensor(v)), k
    for (name, a), b in zip(ran.model.state_dict().items(),
                            by_hand.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert ran.graph is None and ran.step == 2
    counts = trace.counters()
    assert counts.get("train.eager_steps") == 2
    assert "train.graph_captures" not in counts
    assert "train.graph_replays" not in counts


def test_train_cli_reports_the_step_counters(tmp_path):
    from dh3d_tpu_torch.train.__main__ import main

    s = main(["--cfg", "detection_config", "--synthetic", "--device", "cpu",
              "--steps", "2", "--num_points", str(N), "--batch_size", "1",
              "--set", f"sampled_kpnum={KP}", "--logdir",
              str(tmp_path / "run")])
    assert s["counters"] == {"train.eager_steps": 2}


# ------------------------- spans, holders, launches -------------------------

def test_cutting_turns_this_threads_spans_into_cuts():
    """Under `cutting`, this thread's spans call the hook with their name
    and device as they open and (None, None) as they close, and record
    nothing though recording is on; another thread's spans record."""
    calls = []
    trace.enable(True)
    with trace.cutting(lambda name, dev: calls.append((name, dev))):
        with trace.span("outer", torch.zeros(1)):
            with trace.span("inner"):
                pass
        other = threading.Thread(target=lambda: trace.span("other")
                                 .__enter__().__exit__(None, None, None))
        other.start()
        other.join()
    cpu = torch.device("cpu")
    assert calls == [("outer", cpu), ("inner", None), (None, None),
                     (None, None)]
    assert [r["name"] for r in trace.records()] == ["other"]
    with trace.span("after"):
        pass
    assert [r["name"] for r in trace.records()] == ["other", "after"]


def test_collect_inverses_lists_the_holders_made_in_order():
    nbh = torch.randint(0, 16, (1, 16, 4))
    outside = neighborhood.NeighborInverse(nbh, 16)
    with neighborhood.collect_inverses() as made:
        a = neighborhood.NeighborInverse(nbh, 16)
        b = neighborhood.NeighborInverse(nbh, 16)
    neighborhood.NeighborInverse(nbh, 16)
    assert made == [a, b] and outside not in made
    assert not a.built
    a.get()
    assert a.built and not b.built


def test_add_counts_adds_and_takes_back():
    before = kernels.counts()
    kernels.add_counts({"knn": 3, "fps": 1})
    kernels.add_counts({"knn": -1})
    after = kernels.counts()
    assert after["knn"] == before["knn"] + 2
    assert after["fps"] == before["fps"] + 1
    kernels.add_counts({"knn": -2, "fps": -1})
    assert kernels.counts() == before


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph` that logs its calls; a
    capture in which no kernel launched is empty, and warns as PyTorch's
    does."""

    log: list = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        self.id = len([e for e in self.log if e[0] == "begin"])
        self.log.append(("begin", self.id))
        self.counts = kernels.counts()

    def capture_end(self):
        if kernels.counts() == self.counts:
            warnings.warn("The CUDA Graph is empty. This usually means ...")
        self.log.append(("end", self.id))

    def replay(self):
        self.log.append(("replay", self.id))


class _Stream:
    def wait_stream(self, other):
        pass


def test_recording_cuts_at_spans_replays_between_them_and_counts(
        monkeypatch):
    """A capture ends a graph and begins the next at every span `fn` opens
    or closes, drops the empty ones, takes back the launches made while
    capturing; a replay runs the graphs in order inside the same spans
    (recorded) and adds each graph's launches."""
    monkeypatch.setattr(_Graph, "log", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())

    def fn():
        kernels.KNN.launches += 1  # a launch before any span
        with trace.span("step.forward"):
            with trace.span("model.forward"):
                kernels.FPS.launches += 2
            kernels.KNN.launches += 1
        return "out"

    before = kernels.counts()
    rec = graphs.Recording(pool=None, stream=_Stream())
    assert rec.capture(fn) == "out"
    assert kernels.counts() == before
    kinds = [(i[0], i[1] if i[0] == "open" else None) for i in rec.items]
    assert kinds == [("graph", None), ("open", "step.forward"),
                     ("open", "model.forward"), ("graph", None),
                     ("close", None), ("graph", None), ("close", None)]
    assert [i[2] for i in rec.items if i[0] == "graph"] == [
        {"knn": 1}, {"fps": 2}, {"knn": 1}]
    _Graph.log.clear()
    trace.enable(True)
    rec.replay()
    assert [e[0] for e in _Graph.log] == ["replay"] * 3
    after = kernels.counts()
    assert after["knn"] == before["knn"] + 2
    assert after["fps"] == before["fps"] + 2
    recs = {r["name"]: r for r in trace.records()}
    assert set(recs) == {"step.forward", "model.forward"}
    assert recs["model.forward"]["parent"] == recs["step.forward"]["id"]
    kernels.add_counts({"knn": -2, "fps": -2})
