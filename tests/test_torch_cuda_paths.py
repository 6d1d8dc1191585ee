"""The PyTorch port's paths on the card, at the sizes they run at.

Marked `cuda`; every test takes the `device` fixture, which skips when
there is no CUDA device (decided when the test runs, never at import).
Run on a card, with the kernel tests, by

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_paths.py \\
        -m cuda -q --noconftest

`tests/test_torch_cuda.py` holds each kernel against its plain version;
this file holds what the kernels compose into: the main-path forward and
the train step at full width (their launches, outputs, gradients and
statistics, and each against the CPU), the extraction, training,
relocalisation, registration, repeatability, error-budget, bench,
curriculum, exporter and bf16 CLIs run in this process on seeded
lidar-like scans written as .bin files, and the parallel path with two
ranks sharing `cuda:0` through gloo.  Weights are the committed demo
checkpoints (`models/demo_stage2`, `models/demo_stage3`).
"""

import math
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from test_torch_cuda import BN_KERNELS, _close

from chip_smoke import eval_cloud
from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.data.synthetic import lidar_like_scan

pytestmark = pytest.mark.cuda

# Card vs CPU, the forward.  Every index (Morton order, kNN, FPS, 3-NN) is
# computed from the coordinates alone with the same rounded operations on
# both sides, so it must be equal.  Features differ only in summation
# order (FMA accumulation in the kernels, other matmul blocking): ~1e-6
# relative, held here to 1e-4 absolute on the unit-scale outputs and 1e-5
# of the largest magnitude on the unnormalised `feat`.
CARD_VS_CPU_ATOL = 1e-4
CARD_VS_CPU_FEAT_REL = 1e-5
# Card vs CPU, the train step.  Indices as in the forward.  Losses: f32
# summation order through ~30 layers and a BatchNorm on batch statistics
# at each, ~1e-6 relative; held to 1e-4.  Gradients: the same rounding,
# amplified by the BatchNorm backward (a difference of large means); each
# held to 1e-3 of its tensor's largest magnitude.  The gradients of biases
# that feed a BatchNorm are 0 exactly (rounding noise on both sides) and
# are held to 1e-3 of the model's largest gradient.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
# The data-parallel step against the one-process step on the card.  The
# two differ only in the order of f32 sums (the gradient all-reduce, a
# GEMM's weight gradient over a rank's rows; kernel J's BatchNorm sums are
# exact to f64 rounding, so its statistics do not depend on how the rows
# are split).  At full width that order alone can move some gradients by
# more than the train step's limits: with PyTorch's f32 BatchNorm sums,
# the one-process step on the same batch with its tuples (pairs) in
# reverse order, the same function, moved the attention block's BN bias
# gradient by 2.0e-3 of its scale (global_config) and a backbone BN bias's
# by 1.2e-3 (detection_config), and the mined loss by 1.7e-5 of itself.
# So each kind of difference is held to the larger of its limit below and
# twice that order noise, measured in the same run (`step_errors` of the
# reversed batch): metrics TRAIN_LOSS_REL of the total, gradients
# TRAIN_GRAD_REL of their scale (the biases that feed a BatchNorm: of a
# tenth of the largest gradient), BN statistics TRAIN_LOSS_REL of their
# scale plus 1e-6 (a mean of about 0 is rounding noise), Adam's moments
# 0.1 g and 0.001 g^2 at twice the gradients' limit; parameters: Adam's
# first step moves each by about lr * sign(g), so they agree to 1e-6 where
# |g| is above 1e-2 of its tensor's scale and within 2 lr elsewhere.
# `tests/test_torch_parallel.py` holds the step to 1e-5 and 1e-4 against
# JAX at the CPU tests' sizes, where that noise is smaller.
DP_METRIC_REL = TRAIN_LOSS_REL
DP_GRAD_REL = TRAIN_GRAD_REL
DP_BN_REL = TRAIN_LOSS_REL
# bf16 card against CPU (PERF.md §2's bf16 limits).  One bf16 step is up
# to 2^-7 of a value, and a value near a rounding boundary lands one step
# apart on the two sides; such flips spread through the layers, so
# unit-scale outputs are held by their largest difference and their root
# mean square, `feat` by shares of its largest magnitude; and each
# descriptor's rms difference must be under half the CPU's bf16-f32 one,
# which a forward that ran f32 would not be.
BF16_CARD_VS_CPU = {"local_desc": (0.2, 1e-3), "attention": (4e-2, 3e-3),
                    "global_desc": (2e-4, 5e-5),
                    "xyz_feat_att": (0.2, 1e-3)}
BF16_FEAT_REL = (1e-2, 5e-5)
BF16_CLOSER = 2.0

# the forward runs A-D and G (A the 3-NN, G the self kNN k=8; C through
# both its entry points: on weights and, for the flex-conv moments, on
# positions); the train step A-G (E likewise) and J's four passes
# (train-mode BatchNorm, which an eval forward never launches); the bf16
# compute_dtype takes the bf16 cases of C and E instead of the f32 ones
FORWARD_KERNELS = ("knn", "knn_topk", "fps", "weighted_sum", "flex_moments",
                   "neighbor_max")
TRAIN_KERNELS = FORWARD_KERNELS + ("weighted_sum_backward",
                                   "flex_moments_backward",
                                   "neighbor_max_backward") + BN_KERNELS
BF16_CASES = {"flex_moments": "flex_moments_bf16",
              "flex_moments_backward": "flex_moments_backward_bf16"}
BF16_TRAIN_KERNELS = tuple(BF16_CASES.get(k, k) for k in TRAIN_KERNELS)
# the CUDA functions of each kernel, as a profiler trace names them
TRACE_KERNELS = {
    "A knn": ("knn_kernel",),
    "B fps": ("fps_kernel",),
    "C weighted_sum / flex_moments": ("weighted_sum_loop_kernel",
                                      "weighted_sum_unrolled_kernel"),
    "D neighbor_max": ("neighbor_max_loop_kernel",
                       "neighbor_max_unrolled_kernel"),
    "E weighted_sum_backward / flex_moments_backward":
        ("weighted_sum_bwd_kernel",),
    "F neighbor_max_backward": ("neighbor_max_bwd_kernel",),
    "G knn_topk": ("topk_search",),
}
NMS = {"k": 50, "radius": 0.5, "ratio": 0.01, "max_kp": 512}  # CLI defaults
# the relocalisation CLI's defaults, its database and queries
RELOC = {"num_points": 4096, "nms_max_kp": 256, "ransac_iters": 500,
         "db": 12, "queries": 4, "source_every": 3}
QUERY_MOTION = (0.2, (1.5, -1.0, 0.0))  # z-rotation (rad), translation (m)
# kernel H's band starts read back at these (queries, keys, window): a
# self query wider than the int32 product of the JAX kernel allows, the
# windowed level's 3-NN and kNN, the forward's and the extraction's self
# kNN, and cross shapes whose tiles share bands
WINDOW_START_SHAPES = ((33024, 33024, 512), (32768, 32768, 512),
                       (32768, 4096, 256), (32768, 4096, 512),
                       (16384, 16384, 512), (8192, 8192, 512),
                       (8192, 1024, 256), (5120, 2560, 256),
                       (2048, 256, 128))
# the error budget's pool: two sequences of 4 scans
BUDGET = {"num_points": 8192, "per_sequence": 4}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 and round once, as the JAX function's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def counted(fn, *args, **kwargs):
    """(fn's result, the kernel launches it made)."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, kernels.counts()


def finite(metrics) -> bool:
    return all(math.isfinite(float(v)) for v in metrics.values())


# ------------------------- the main-path forward -------------------------

def entry_forward(device, batch, **overrides):
    """(forward, points): `entry()`'s model with the config `overrides` on
    `device`, and `batch` clouds of `entry`'s seed there."""
    from dh3d_tpu_torch.entry import entry_config, entry_points, entry_weights
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.nn import DH3D, load_flax

    cfg = entry_config()
    cfg.update(overrides)
    model = DH3D(cfg).to(device)
    load_flax(model, entry_weights())
    return (make_forward(cfg, model),
            torch.from_numpy(entry_points(batch)).to(device))


def check_outputs(outs, points):
    B, N = points.shape[:2]
    want = {"xyz": (B, N, 3), "knn_indices": (B, N, 8), "feat": (B, N, 128),
            "local_desc": (B, N, 128), "xyz_feat": (B, N, 131),
            "attention": (B, N, 1), "xyz_feat_att": (B, N, 132),
            "global_desc": (B, 256)}
    assert set(outs) == set(want), sorted(outs)
    for key, shape in want.items():
        assert tuple(outs[key].shape) == shape, (key, outs[key].shape)
        assert torch.isfinite(outs[key].float()).all(), key
    assert outs["knn_indices"].dtype == torch.int64
    assert torch.equal(outs["xyz"], points), "unpermuted xyz != input"
    self_slot = torch.arange(N, device=points.device).expand(B, N)
    assert torch.equal(outs["knn_indices"][..., 0], self_slot)
    for key in ("local_desc", "global_desc"):
        norm = outs[key].norm(dim=-1)
        assert (norm - 1).abs().max().item() < 1e-4, key
    att = outs["attention"]
    assert ((att >= 0) & (att <= 1)).all()


FORWARD_MODES = {"exact": {}, "legacy": {"morton_exact": False},
                 "bf16": {"compute_dtype": "bfloat16"}}


@pytest.fixture(scope="module")
def forward_launches(device):
    """mode -> the launches of one forward at [20, 8192] in that mode of
    FORWARD_MODES ("exact": `entry()` itself), whose outputs passed
    `check_outputs`; each mode run once."""
    from dh3d_tpu_torch.entry import entry

    runs = {}

    def launches(mode):
        if mode not in runs:
            if mode == "exact":
                fn, (points,) = entry(device, batch=20)
            else:
                fn, points = entry_forward(device, 20, **FORWARD_MODES[mode])
            outs, counts = counted(fn, points)
            check_outputs(outs, points)
            runs[mode] = counts
        return runs[mode]

    return launches


@pytest.mark.parametrize("mode", sorted(FORWARD_MODES))
def test_forward_at_full_width(forward_launches, mode):
    """The main-path forward at [20, 8192]: outputs finite, of the model's
    shapes, unit-norm descriptors, attention in [0, 1] (`check_outputs`).
    Exact (`entry()`): every forward kernel launched, no J.  Legacy
    (`morton_exact=False`): H once, G one time fewer than exact, A-D as
    often.  bf16: the bf16 case of C 5 times in place of the f32 case,
    every other kernel as often as exact."""
    exact, got = forward_launches("exact"), forward_launches(mode)
    if mode == "exact":
        assert all(got[k] > 0 for k in FORWARD_KERNELS), got
        assert all(got[k] == 0 for k in BN_KERNELS), got
    elif mode == "legacy":
        assert got["knn_window"] == 1, got
        assert got["knn_topk"] == exact["knn_topk"] - 1, got
        for k in ("knn", "fps", "weighted_sum", "flex_moments",
                  "neighbor_max"):
            assert got[k] == exact[k], (k, got)
    else:
        want = dict(exact)
        for f32_case, bf16_case in BF16_CASES.items():
            want[bf16_case], want[f32_case] = want[f32_case], 0
        assert got == want, (got, want)
        assert got["flex_moments_bf16"] == 5, got


@pytest.mark.parametrize("mode", ["exact", "legacy"])
def test_forward_on_card_matches_cpu(device, mode):
    """The forward at [2, 8192] on the card and on the CPU (plain
    versions), same weights and clouds: indices equal, descriptors,
    attention and `feat` within CARD_VS_CPU_*."""
    outs = []
    for dev in (device, "cpu"):
        fn, points = entry_forward(dev, 2, **FORWARD_MODES[mode])
        outs.append({k: v.cpu() for k, v in fn(points).items()})
    card, cpu = outs
    for key in ("xyz", "knn_indices"):
        assert torch.equal(card[key], cpu[key]), key
    for key in ("local_desc", "attention", "global_desc", "xyz_feat_att"):
        err = (card[key] - cpu[key]).abs().max().item()
        assert err <= CARD_VS_CPU_ATOL, (key, err)
    err = (card["feat"] - cpu["feat"]).abs().max().item()
    scale = cpu["feat"].abs().max().item()
    assert err <= CARD_VS_CPU_FEAT_REL * scale, (err, scale)


def _rms(t) -> float:
    return t.double().pow(2).mean().sqrt().item()


def test_bf16_forward_on_card_matches_cpu(device):
    """The bf16 forward at [2, 8192] on the card and on the CPU: indices
    equal, outputs f32 and within BF16_CARD_VS_CPU and BF16_FEAT_REL, and
    the descriptors closer to the CPU's bf16 forward than its f32 forward
    is (BF16_CLOSER)."""
    fn_gpu, p_gpu = entry_forward(device, 2, compute_dtype="bfloat16")
    fn_cpu, p_cpu = entry_forward("cpu", 2, compute_dtype="bfloat16")
    fn_f32, _ = entry_forward("cpu", 2)
    o_cpu, o_f32 = fn_cpu(p_cpu), fn_f32(p_cpu)
    o_gpu = {k: v.cpu() for k, v in fn_gpu(p_gpu).items()}
    for key in ("xyz", "knn_indices"):
        assert torch.equal(o_gpu[key], o_cpu[key]), key
    for key, (top, rms) in {**BF16_CARD_VS_CPU, "feat": BF16_FEAT_REL}.items():
        assert o_gpu[key].dtype == torch.float32, key
        err = o_gpu[key] - o_cpu[key]
        scale = o_cpu[key].abs().max().item() if key == "feat" else 1.0
        assert err.abs().max().item() <= top * scale, key
        assert _rms(err) <= rms * scale, key
    for key in ("local_desc", "global_desc"):
        f32_rms = _rms(o_f32[key] - o_cpu[key])
        assert BF16_CLOSER * _rms(o_gpu[key] - o_cpu[key]) <= f32_rms, key


# ---------------------------- the train step ----------------------------

def stage2_config():
    """`detection_config` with the values of models/demo_stage2.config.json
    (batch_size 10 pairs = 20 clouds of 8192 points, 512 keypoints, det_k
    16).  That run generated its pairs on the device from presorted clouds;
    the synthetic batches here are neither, so those two keys go off
    (`test_train_cli_from_disk` trains with them on)."""
    from dh3d_tpu_torch import config as cfglib

    cfg = cfglib.load_config("models/demo_stage2.config.json")
    cfg.device_pairgen = False
    cfg.morton_presorted = False
    return cfg


def stage2_state(cfg, device):
    """A fresh train state on `device` warm-started from demo_stage2."""
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.train import init_state

    state = init_state(cfg, 0, device)
    n = smart_init(state.model, load_npz("models/demo_stage2.npz"))
    assert n == 80, f"demo_stage2 warm start loaded {n} of 80 arrays"
    return state


def check_gradients(state, cfg):
    """Every trainable gradient finite; nonzero but where it is 0 exactly
    (a bias that feeds a BatchNorm)."""
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import param_labels

    zero = bn_fed_biases(state.model)
    labels = param_labels(cfg, state.model)
    for name, p in state.model.named_parameters():
        if labels[name] != "trainable":
            continue
        assert p.grad is not None, f"{name}: no gradient"
        assert torch.isfinite(p.grad).all(), f"{name}: gradient not finite"
        if name not in zero:
            assert p.grad.abs().max().item() > 0, f"{name}: zero gradient"


@pytest.fixture(scope="module")
def step_launches(device):
    """compute_dtype -> the launches of one `stage2_config` step at [20,
    8192] warm-started from demo_stage2 (two steps before it), which
    passed its checks: every kernel of the step launched, each
    neighbourhood's CSR inverse built once, metrics finite, every
    trainable gradient finite and nonzero (`check_gradients`), every BN
    statistic moved, and the next step's metrics finite.  Each dtype run
    once."""
    from dh3d_tpu_torch.ops import neighborhood
    from dh3d_tpu_torch.train import (make_train_step,
                                      synthetic_local_batches, to_device)

    runs = {}

    def launches(dtype):
        if dtype in runs:
            return runs[dtype]
        cfg = stage2_config()
        cfg.compute_dtype = dtype
        state = stage2_state(cfg, device)
        batches = synthetic_local_batches(cfg, seed=0)
        batch = to_device(next(batches), device)
        step = make_train_step(cfg)
        for _ in range(2):
            step(state, batch)
        before = {k: v.clone() for k, v in state.model.named_buffers()}
        batch = to_device(next(batches), device)
        real, built = neighborhood.inverse_neighbors, []
        neighborhood.inverse_neighbors = \
            lambda nbh, m: built.append(nbh) or real(nbh, m)
        try:
            metrics, counts = counted(step, state, batch)
        finally:
            neighborhood.inverse_neighbors = real
        must = BF16_TRAIN_KERNELS if dtype == "bfloat16" else TRAIN_KERNELS
        assert all(counts[k] > 0 for k in must), counts
        assert built and len(built) == len({id(t) for t in built}), \
            "a neighbourhood's CSR inverse was built more than once"
        assert finite(metrics), metrics
        check_gradients(state, cfg)
        still = [k for k, v in state.model.named_buffers()
                 if torch.equal(v, before[k])]
        assert not still, f"BN statistics that did not move: {still}"
        assert finite(step(state, batch))
        runs[dtype] = counts
        return counts

    return launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_at_full_width(step_launches, dtype):
    """The stage-2 step at [20, 8192] passes `step_launches`' checks; in
    bf16 it launches the bf16 cases of C and E as often as the f32 step
    launches the f32 cases, and the f32 cases never."""
    got = step_launches(dtype)
    if dtype == "bfloat16":
        f32 = step_launches("float32")
        for f32_case, bf16_case in BF16_CASES.items():
            assert got[f32_case] == 0, got
            assert got[bf16_case] == f32[f32_case], (got, f32)


def test_train_step_at_full_width_matches_cpu(device):
    """One stage-2 step at [2, 8192] on the card and on the CPU, same
    weights and batch: Morton order, kNN at both levels, FPS, 3-NN and the
    detection loss's kNN equal; losses within TRAIN_LOSS_REL, gradients
    within TRAIN_GRAD_REL."""
    from dh3d_tpu_torch.losses import detection_ranks
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import (forward_loss, synthetic_local_batches,
                                      to_device)

    cfg = stage2_config()
    cfg.batch_size = 1
    batch = next(synthetic_local_batches(cfg, seed=1))
    runs = {}
    for dev in ("cpu", device):
        state = stage2_state(cfg, dev)
        state.model.train()
        caches = []
        hook = state.model.local_backbone.register_forward_hook(
            lambda mod, inp, out: caches.append(out[2]))
        total, metrics, outs = forward_loss(state.model, cfg,
                                            to_device(batch, dev))
        total.backward()
        hook.remove()
        det = {k: v.detach() for k, v in outs.items()}
        _, cand = detection_ranks(det, cfg.det_k, cfg.ar_nn_k, cfg.pos_r)
        runs[str(dev)] = {
            "metrics": {k: torch.as_tensor(v).item()
                        for k, v in metrics.items()},
            "grads": {n: p.grad.cpu()
                      for n, p in state.model.named_parameters()},
            "idx": {"morton xyz": outs["xyz"].detach().cpu(),
                    "knn k=8 [8192]": outs["knn_indices"].cpu(),
                    "fps": caches[0]["kp_idx"].cpu(),
                    "knn k=8 [1024]": caches[0]["knn"].nbh.cpu(),
                    "3-nn": caches[0]["interp"][1].nbh.cpu(),
                    "det-loss knn k=16": cand[..., :cfg.det_k].cpu()}}
        zero = bn_fed_biases(state.model)
    cpu, gpu = runs["cpu"], runs[str(device)]
    for key, ref in cpu["idx"].items():
        assert torch.equal(gpu["idx"][key], ref), f"{key} differs"
    for k, v in cpu["metrics"].items():
        assert abs(gpu["metrics"][k] - v) <= TRAIN_LOSS_REL * max(
            abs(v), 1e-12), (k, v, gpu["metrics"][k])
    top = max(g.abs().max().item() for g in cpu["grads"].values())
    for name, g in cpu["grads"].items():
        scale = top if name in zero else g.abs().max().item()
        err = (gpu["grads"][name] - g).abs().max().item()
        assert err <= TRAIN_GRAD_REL * scale, (name, err, scale)


def graph_case(stage, device):
    """(config, a fresh state warm-started from the stage's demo
    checkpoint, batches(n points) -> a batch) of the benchmark's train
    cells at full width: stage 2, 10 pairs of presorted clouds, pairs made
    in the step; stage 3, 2 tuples of 12 presorted clouds."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.train import init_state

    cfg = cfglib.load_config(f"models/demo_stage{stage}.config.json")
    assert cfg.morton_presorted and not cfg.remat
    state = init_state(cfg, 0, device)
    assert smart_init(state.model, load_npz(f"models/demo_stage{stage}.npz"))
    rng = np.random.RandomState(stage)
    clouds = 2 * cfg.batch_size if stage == 2 else cfg.batch_size * (
        2 + cfg.num_pos + cfg.num_neg)

    def batch(n):
        pts = (rng.randn(clouds, n, 3) * 10).astype(np.float32)
        pts = torch.from_numpy(morton_sort_np(pts)).to(device)
        if stage == 3:
            return {"points": pts}
        return {"pc1": pts[:cfg.batch_size], "pc2": pts[cfg.batch_size:]}

    return cfg, state, batch


@pytest.mark.parametrize("stage", [2, 3])
def test_graphed_train_step_equals_eager(device, stage):
    """The benchmark's train steps at full width, graphed (the first step
    eager, the second captured, the later ones replayed) and eager (a
    no-op forward hook keeps a state eager), on the same batches and
    draws: four steps of one shape, one of half the points (eager on both
    sides), one more of the first shape.  Each step's metrics, launches
    (a replay counts what its capture recorded) and, at the end, every
    parameter, BatchNorm statistic and Adam moment and step: bit for bit,
    with the same capturable Adam on both sides.  The graphed side counts
    1 eager step, 1 capture and 2 replays after four steps, then 2, 1 and
    3; the returned total costs stay each step's own."""
    from dh3d_tpu_torch import trace
    from dh3d_tpu_torch.train import make_train_step

    cfg, graphed, batch = graph_case(stage, device)
    _, eager, _ = graph_case(stage, device)
    eager.model.register_forward_hook(lambda *a: None)
    n = cfg.num_points
    batches = [batch(n) for _ in range(4)] + [batch(n // 2), batch(n)]
    runs, counters = {}, []
    for name, state in (("graphed", graphed), ("eager", eager)):
        step = make_train_step(cfg)
        out = []
        for i, b in enumerate(batches):
            gen = (torch.Generator(device).manual_seed(100 + i)
                   if "pc1" in b else None)
            before = trace.counters()
            m, launches = counted(step, state, b, gen)
            after = trace.counters()
            out.append((m, launches))
            if name == "graphed" and i in (3, 5):
                counters.append({k: after.get(k, 0) - first.get(k, 0)
                                 for k in after if k.startswith("train.")})
            if i == 0:
                first = before
        runs[name] = out
    assert counters == [
        {"train.eager_steps": 1, "train.graph_captures": 1,
         "train.graph_replays": 2},
        {"train.eager_steps": 2, "train.graph_captures": 1,
         "train.graph_replays": 3}], counters
    assert graphed.graph is not None and graphed.graph.body is not None
    costs = [float(m["total_cost"]) for m, _ in runs["graphed"][:4]]
    assert len(set(costs)) == 4, costs
    for i, ((gm, gl), (em, el)) in enumerate(zip(runs["graphed"],
                                                 runs["eager"])):
        assert gm.keys() == em.keys()
        for k in gm:
            assert torch.equal(gm[k], em[k]), (i, k, gm[k], em[k])
        assert gl == el, (i, gl, el)
    assert graphed.step == eager.step == len(batches)
    for (name, a), b in zip(graphed.model.state_dict().items(),
                            eager.model.state_dict().values()):
        assert torch.equal(a, b), name
    params = dict(eager.model.named_parameters())
    for name, p in graphed.model.named_parameters():
        if not p.requires_grad:
            continue
        mine, theirs = (graphed.optimizer.state[p],
                        eager.optimizer.state[params[name]])
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(mine[key], theirs[key]), (name, key)


@pytest.mark.parametrize("mode", ["legacy", "remat"])
def test_legacy_and_remat_train_steps(device, mode):
    """A stage-2 step at [20, 8192] in the legacy mode (H takes the
    full-resolution kNN) and with `remat` (the local backbone recomputed
    in the backward): finite metrics; the legacy step launches H."""
    from dh3d_tpu_torch.train import (make_train_step,
                                      synthetic_local_batches, to_device)

    cfg = stage2_config()
    cfg.update({"legacy": {"morton_exact": False},
                "remat": {"remat": True}}[mode])
    state = stage2_state(cfg, device)
    batch = to_device(next(synthetic_local_batches(cfg, seed=0)), device)
    step = make_train_step(cfg)
    step(state, batch)
    metrics, launches = counted(step, state, batch)
    assert finite(metrics), metrics
    if mode == "legacy":
        assert launches["knn_window"] >= 1, launches


def test_flex_avg_and_flex_deconv_at_forward_shape(device):
    """`flex_avg` (kernel C on weights of 1) and `flex_deconv` (a product,
    then kernel E on positions) at the forward's full-resolution level,
    [20, 8192] k=8 C=64, against their plain versions within 1e-5 of the
    largest magnitude."""
    from dh3d_tpu_torch.entry import entry_points

    raw = torch.from_numpy(entry_points(20, 8192)).to(device)
    perm, _ = T.morton_perm(raw)
    pts = torch.gather(raw, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    nbh = T.knn(pts, pts, 8)[0]
    B, N, K = nbh.shape
    g = torch.Generator(device="cpu").manual_seed(14)
    feat = torch.randn(B, N, 64, generator=g).to(device)
    theta = (0.1 * torch.randn(3, 64, 64, generator=g)).to(device)
    bias = (0.1 * torch.randn(64, 64, generator=g)).to(device)
    ones = torch.ones(B, N, K, 1, device=device)
    _close(T.flex_avg(feat, nbh), T.weighted_sum_plain(feat, nbh, ones))
    f_self = T.gather_neighbors(feat, nbh[:, :, :1])[:, :, 0]
    w = torch.cat([bias[None], theta], 0).permute(1, 0, 2)
    _close(T.flex_deconv(feat, pts, nbh, theta, bias),
           T.weighted_sum_backward_plain(f_self @ w.reshape(64, -1), nbh,
                                         T.flex_weights(pts, nbh), N))


def test_knn_window_band_starts_equal_formula(device):
    """Kernel H's band start of every tile, read back at
    WINDOW_START_SHAPES: keys on a line (x = their index) and every query
    at x = -1000, so that each query's nearest key in its band is the
    band's first; it must be the formula's start."""
    for nq, nk, w in WINDOW_START_SHAPES:
        keys = torch.zeros(1, nk, 3, device=device)
        keys[0, :, 0] = torch.arange(nk, device=device, dtype=torch.float32)
        query = torch.zeros(1, nq, 3, device=device)
        query[0, :, 0] = -1000.0
        first = T.knn_window(query, keys, 1, w)[0][0, :, 0].view(-1, 256)
        assert (first == first[:, :1]).all()
        want = [min(max(((2 * i + 1) * 256 * nk) // (2 * nq) - w // 2, 0),
                    nk - w) // 128 * 128 for i in range(nq // 256)]
        assert first[:, 0].tolist() == want, (nq, nk, w)


# ---------------------------- extraction CLIs ----------------------------

def check_rows(path, max_rows):
    """A descriptor file of 132-float rows: at least one and at most
    `max_rows` rows, finite, unit-norm descriptors.  Returns the rows."""
    size = os.path.getsize(path)
    assert size > 0 and size % (132 * 4) == 0, (path, size)
    rows = np.fromfile(path, np.float32).reshape(-1, 132)
    assert len(rows) <= max_rows, (path, len(rows))
    assert np.isfinite(rows).all(), path
    norm = np.linalg.norm(rows[:, 3:131], axis=1)
    assert np.abs(norm - 1).max() < 1e-4, (path, np.abs(norm - 1).max())
    return rows


def check_global_files(directory, names):
    for name in names:
        d = np.fromfile(os.path.join(directory, name + ".bin"), np.float32)
        assert d.shape == (256,) and np.isfinite(d).all(), name
        assert abs(np.linalg.norm(d) - 1) < 1e-4, name


def local_cli(pcd, out, *flags, model="models/demo_stage2"):
    """The port's local extraction CLI, in this process (its kernel counts
    are this process's), on the card with the CLI's NMS defaults."""
    from dh3d_tpu_torch.evaluate import localdesc_extract

    return localdesc_extract.main([
        "--ModelPath", model, "--pcdpath", pcd, "--dim", "3",
        "--device", "cuda", "--batch_size", "1", "--save_dir", out,
        "--nms_rad", str(NMS["radius"]), "--nms_min_ratio", str(NMS["ratio"]),
        "--nms_max_kp", str(NMS["max_kp"]), *flags])


def write_scans(directory, seeds, prefix="scan"):
    """Seeded lidar-like scans of 30,000 points as `prefix{i}.bin`, i the
    position in `seeds`.  Returns their names."""
    from dh3d_tpu_torch.data.io import write_to_bin

    os.makedirs(directory, exist_ok=True)
    names = [f"{prefix}{i}" for i in range(len(seeds))]
    for name, seed in zip(names, seeds):
        write_to_bin(lidar_like_scan(seed),
                     os.path.join(directory, name + ".bin"))
    return names


@pytest.fixture(scope="module")
def nms_extraction(device, tmp_path_factory):
    """The local extraction CLI with NMS at N=16384 on 8 seeded scans:
    (its directory of `<scan>_nms_res.bin` files, the scans' names and
    directory, its summary, its launches)."""
    work = str(tmp_path_factory.mktemp("extract"))
    scans = os.path.join(work, "scans")
    names = write_scans(scans, range(8))
    out = os.path.join(work, "nms")
    summary, launches = counted(local_cli, scans, out, "--perform_nms")
    return out, names, scans, summary, launches


def test_local_and_global_extraction_clis(nms_extraction, tmp_path):
    """`localdesc_extract` at the reference's eval sizes with
    `models/demo_stage2`: NMS at N=16384 on 8 scans launches A, B, C, D
    and G, and every keypoint file holds <= 512 finite rows of 132 floats
    with unit-norm descriptors; one dense `--save_all` cloud of 16384
    rows; one `oxford_dso` cloud at N=9000 with NMS.  Then
    `globaldesc_extract` with `models/demo_stage3` on the same scans at
    [4, 8192] with recall: 8 finite unit-norm descriptors of 256."""
    from dh3d_tpu_torch.evaluate import globaldesc_extract

    out, names, scans, summary, launches = nms_extraction
    assert all(launches[k] > 0 for k in FORWARD_KERNELS), launches
    assert summary["clouds"] == 8, summary
    for n in names:
        check_rows(os.path.join(out, f"{n}_nms_res.bin"), NMS["max_kp"])
    one = str(tmp_path / "one")
    os.makedirs(one)
    shutil.copy(os.path.join(scans, "scan0.bin"), one)
    dense = local_cli(one, str(tmp_path / "dense"), "--save_all")
    rows = check_rows(str(tmp_path / "dense" / "scan0_res.bin"), 16384)
    assert len(rows) == 16384 and dense["clouds"] == 1
    local_cli(one, str(tmp_path / "dso"), "--perform_nms", "--dataset",
              "oxford_dso")
    check_rows(str(tmp_path / "dso" / "scan0_nms_res.bin"), NMS["max_kp"])

    gt = str(tmp_path / "gt.pickle")
    with open(gt, "wb") as f:  # two sequences of 4, twins 3 m apart
        pickle.dump({f"seq{q}": [{"query": names[4 * q + i],
                                  "northing": 10.0 * i + 3.0 * q,
                                  "easting": 0.0} for i in range(4)]
                     for q in range(2)}, f)
    gsum = globaldesc_extract.main([
        "--ModelPath", "models/demo_stage3", "--pcdpath", scans,
        "--ref_gt_file", gt, "--query_gt_file", gt, "--batch_size", "4",
        "--num_points", "8192", "--eval_recall", "--device", "cuda",
        "--save_dir", str(tmp_path / "global")])
    assert gsum["clouds"] == 8, gsum
    check_global_files(str(tmp_path / "global"), names)
    assert all(map(math.isfinite, gsum["recall@N"]))


def test_extraction_forward_and_nms_on_card_match_cpu(device):
    """One N=16384 scan through the extraction forward (`make_forward` of
    `models/demo_stage2`) on the card and on the CPU: Morton order, kNN at
    both levels, FPS and 3-NN equal, descriptors and attention within
    CARD_VS_CPU_ATOL, `feat` within CARD_VS_CPU_FEAT_REL; then, from the
    card's xyz and attention, the 50-NN (ids and d2) and the NMS
    keypoints equal on both."""
    from dh3d_tpu_torch.eval import device_nms, local_result_rows, make_forward
    from dh3d_tpu_torch.train import resolve_model

    cloud = eval_cloud(0, 16384)[None]
    runs = {}
    for dev in ("cpu", device):
        cfg, model = resolve_model("models/demo_stage2")
        cfg.num_points, cfg.sampled_kpnum, cfg.input_R = 16384, -1, False
        model = model.to(dev)
        seen = []
        hook = model.local_backbone.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0], out[2])))
        outs = make_forward(cfg, model)(cloud)
        hook.remove()
        sorted_xyz, cache = seen[0]
        runs[str(dev)] = {
            "idx": {"morton-sorted xyz": sorted_xyz.cpu(),
                    "knn k=8 [16384]": outs["knn_indices"].cpu(),
                    "fps 16384->2048": cache["kp_idx"].cpu(),
                    "knn k=8 [2048]": cache["knn"].nbh.cpu(),
                    "3-nn": cache["interp"][1].nbh.cpu()},
            "out": {k: outs[k].cpu() for k in ("local_desc", "attention",
                                               "xyz_feat_att", "feat")},
            "rows": local_result_rows(outs, True)[0]}
    cpu, gpu = runs["cpu"], runs[str(device)]
    for key, ref in cpu["idx"].items():
        assert torch.equal(gpu["idx"][key], ref), f"{key} differs"
    for key in ("local_desc", "attention", "xyz_feat_att"):
        err = (gpu["out"][key] - cpu["out"][key]).abs().max().item()
        assert err <= CARD_VS_CPU_ATOL, (key, err)
    err = (gpu["out"]["feat"] - cpu["out"]["feat"]).abs().max().item()
    assert err <= CARD_VS_CPU_FEAT_REL * cpu["out"]["feat"].abs().max().item()

    xyz = np.ascontiguousarray(gpu["rows"][:, :3])
    att = 1 - gpu["rows"][:, -1]
    assert np.array_equal(xyz, cpu["rows"][:, :3])  # the input coordinates
    nn = []
    for dev in ("cpu", device):
        pts = torch.from_numpy(xyz)[None].to(dev)
        nn.append([t.cpu() for t in T.knn(pts, pts, NMS["k"])])
    assert torch.equal(nn[0][0], nn[1][0]), "50-NN ids differ"
    assert torch.equal(nn[0][1], nn[1][1]), "50-NN d2 differ"
    args = (xyz, att, NMS["radius"], NMS["ratio"], NMS["max_kp"])
    n_cpu, kp_cpu = device_nms(*args, device="cpu")
    n_gpu, kp_gpu = device_nms(*args, device=device)
    assert n_cpu == n_gpu and np.array_equal(kp_cpu, kp_gpu), \
        "NMS of the same inputs differs between the card and the CPU"


# ---------------------------- training CLIs ----------------------------

@pytest.fixture(scope="module")
def train_pool(device, tmp_path_factory):
    """12 places of 3 seeded scans (36 .bin files) with the two GT pickles
    `train.py` reads under `--data_basedir`: local {i: {"query"}} over
    every scan, global {i: {"query", "positives", "nonnegtives"}} with the
    other scans of a place as its positives and the place as its
    non-negatives."""
    pool = str(tmp_path_factory.mktemp("pool"))
    places, per_place = 12, 3
    names = write_scans(pool, range(100, 100 + places * per_place))
    with open(os.path.join(pool, "oxford_train_local_gt.pickle"), "wb") as f:
        pickle.dump({i: {"query": n} for i, n in enumerate(names)}, f)
    gt = {}
    for p in range(places):
        place = list(range(per_place * p, per_place * (p + 1)))
        for i in place:
            gt[i] = {"query": names[i],
                     "positives": [j for j in place if j != i],
                     "nonnegtives": place}
    with open(os.path.join(pool, "oxford_train_global_gt.pickle"), "wb") as f:
        pickle.dump(gt, f)
    return pool


def train_cli(argv):
    """`python -m dh3d_tpu_torch.train` in this process; its summary, whose
    metrics must be finite."""
    from dh3d_tpu_torch.train.__main__ import main

    s = main(argv)
    assert finite(s["metrics"]), s["metrics"]
    return s


def check_pairs(T, batch, pairs, B, N, M):
    """A pair batch built on the card: anchors unique a cloud and every id
    in range; points[B:] rotated back by R gives pc2 within 1e-5 of its
    scale; the positives are the 1-NN of the anchors in the unrotated pc2
    by `ops.knn_plain`."""
    from dh3d_tpu_torch.data.augment import matmul3

    pc1, pc2 = batch["pc1"], batch["pc2"]
    ids, R = pairs["sample_inds"], pairs["R"]
    assert pairs["points"].shape == (2 * B, N, 3) and ids.shape == (2 * B, M)
    assert int(ids.min()) >= 0 and int(ids.max()) < N, "ids out of range"
    anc, pos = ids[:B], ids[B:]
    assert all(len(set(a.tolist())) == M for a in anc), "anchors repeat"
    assert torch.equal(pairs["points"][:B], pc1)
    back = matmul3(pairs["points"][B:], R.transpose(1, 2))
    err = (back - pc2).abs().max().item()
    assert err <= 1e-5 * pc2.abs().max().item(), err
    want = T.knn_plain(T.gather_point(pc1, anc).contiguous(), pc2, 1)[0]
    assert torch.equal(pos, want[..., 0]), "positives are not the 1-NN"


def test_train_cli_from_disk(device, train_pool, step_launches, tmp_path):
    """`python -m dh3d_tpu_torch.train --data_basedir` at full width on the
    pool, warm-started from the shipped checkpoints: (a) stage 2 as
    demo_stage2 trained (`device_pairgen` on presorted clouds), 4 steps:
    one step launches B and A each exactly once more than
    `step_launches`' f32 step (the pairs' FPS and 1-NN) and every other
    kernel as often; the pairs of its first batch, rebuilt on the card,
    pass `check_pairs`; (b) the host pair path, 2 steps; (c) stage 3 with
    `augment_on_device`, 2 steps.  Each: finite metrics, and the loader
    counts each copy's neighbours on the card (kernel I) at least once a
    cloud trained on."""
    from dh3d_tpu_torch.train import add_draws, prepare_batch, to_device
    from dh3d_tpu_torch.train.__main__ import (build_config, parse_args,
                                               step_generator)
    from dh3d_tpu_torch.train.data import real_batches

    common = ["--data_basedir", train_pool, "--device", "cuda"]
    stage2 = ["--cfg", "detection_config", *common, "--load",
              "models/demo_stage2.npz"]
    runs = {  # label: (argv, clouds a step)
        "a": (stage2 + ["--device_pairgen", "--set", "morton_presorted=true",
                        "--steps", "4"], 20),
        "b": (stage2 + ["--steps", "2"], 20),
        "c": (["--cfg", "global_config", *common, "--load",
               "models/demo_stage3.npz", "--set", "morton_presorted=true",
               "--set", "warmup_steps=300", "--set",
               "augment_on_device=true", "--steps", "2"], 24),
    }
    for label, (argv, clouds) in runs.items():
        argv = argv + ["--logdir", str(tmp_path / f"run_{label}")]
        if label == "a":  # the run's first batch, from a fresh loader
            cfg = build_config(parse_args(argv))
            first = next(real_batches(cfg, seed=0))
        loads = kernels.RADIUS_COUNT.launches
        s = train_cli(argv)
        assert kernels.RADIUS_COUNT.launches - loads >= clouds * s["steps"]
        if label != "a":
            continue
        launches = s["launches"][-1]
        for name, n in step_launches("float32").items():
            if name != "radius_count":  # the loader's, not the step's
                more = 1 if name in ("fps", "knn") else 0
                assert launches[name] == n + more, (name, launches[name], n)
        batch = to_device(first, "cuda")
        pairs = prepare_batch(add_draws(
            batch, cfg, step_generator(1000, 0, "cuda")), cfg)
        check_pairs(T, batch, pairs, cfg.batch_size, cfg.num_points,
                    cfg.sampled_kpnum)


def test_train_cli_warm_starts_from_a_stage1_logdir(train_pool, tmp_path):
    """The curriculum's warm start from the port's own checkpoints: one
    stage-1 step (`basic_config`) from disk, then one stage-2 step with
    `--load` the stage-1 logdir, which restores every tensor stage 1 saved
    (stage 1's model is stage 2's without the detection block)."""
    from dh3d_tpu_torch.nn.convert import warm_start_state_dict

    flags = ["--data_basedir", train_pool, "--device", "cuda",
             "--device_pairgen", "--set", "morton_presorted=true",
             "--steps", "1"]
    stage1 = str(tmp_path / "run_d1")
    train_cli(["--cfg", "basic_config", *flags, "--logdir", stage1])
    s2 = train_cli(["--cfg", "detection_config", *flags, "--load", stage1,
                    "--logdir", str(tmp_path / "run_d2")])
    saved = len(warm_start_state_dict(stage1))
    assert s2["restored"] == saved > 0, (s2["restored"], saved)


@pytest.fixture(scope="module")
def curriculum(train_pool, tmp_path_factory):
    """The three-stage curriculum script on the pool, one step a stage at
    the presets' widths: (its argv, its summaries, the stages' logdirs)."""
    from dh3d_tpu_torch.scripts.train_demo_curriculum import main as run

    out = str(tmp_path_factory.mktemp("curriculum"))
    argv = ["--pool", train_pool, "--out", out, "--steps", "1", "1", "1"]
    return argv, run(argv), [os.path.join(out, "seed0", f"stage{n}")
                             for n in (1, 2, 3)]


def test_curriculum_script(curriculum):
    """`scripts.train_demo_curriculum`: every stage's metrics finite; stage
    2 restores every tensor stage 1 saved, stage 3 exactly stage 2's
    `local_backbone.*` tensors, which it keeps bit for bit (frozen); a
    second call with the same `--out` runs no stage."""
    from dh3d_tpu_torch.nn.convert import warm_start_state_dict
    from dh3d_tpu_torch.scripts.train_demo_curriculum import main as run

    argv, summaries, logdirs = curriculum
    s1, s2, s3 = (summaries[f"seed0/stage{n}"] for n in (1, 2, 3))
    for s in (s1, s2, s3):
        assert finite(s["metrics"]), s["metrics"]
    saved1, saved2, saved3 = map(warm_start_state_dict, logdirs)
    assert s2["restored"] == len(saved1) > 0, (s2["restored"], len(saved1))
    local = {k for k in saved2 if k.startswith("local_backbone.")}
    common = {k for k, t in saved2.items()
              if k in saved3 and saved3[k].shape == t.shape}
    assert s3["restored"] == len(local) and common == local, \
        (s3["restored"], len(local), sorted(common ^ local))
    for k in local:
        assert torch.equal(saved3[k], saved2[k]), k
    again = run(argv)
    assert all(v is None for v in again.values()), again


def test_exporter_on_curriculum_stages(device, curriculum, tmp_path):
    """`scripts.package_checkpoint` on stage 3's logdir: the keys, shapes
    and dtypes of `models/demo_stage3.npz` and a config file; the export
    and the logdir give the same forward bits at [4, 8192] on the card
    through `train.resolve_model`; stage 2's export holds the same
    `local_backbone` arrays."""
    from dh3d_tpu_torch.entry import entry_points
    from dh3d_tpu_torch.eval.extract import make_forward
    from dh3d_tpu_torch.nn.convert import load_npz
    from dh3d_tpu_torch.scripts.package_checkpoint import main as export
    from dh3d_tpu_torch.train import resolve_model

    _, stage2, stage3 = curriculum[2]
    stem3 = str(tmp_path / "stage3")
    flat3 = export(["--ckpt", stage3, "--out", stem3])
    ref = load_npz("models/demo_stage3.npz")
    assert set(flat3) == set(ref), sorted(set(flat3) ^ set(ref))
    for k, v in ref.items():
        assert flat3[k].shape == v.shape and flat3[k].dtype == v.dtype, k
    assert os.path.isfile(stem3 + ".config.json")
    points = torch.from_numpy(entry_points(4, 8192, seed=3)).to(device)
    outs = []
    for src in (stage3, stem3):
        cfg, model = resolve_model(src)
        outs.append(make_forward(cfg, model.to(device))(points))
    a, b = outs
    assert set(a) == set(b)
    for k in a:
        assert torch.isfinite(a[k].float()).all(), k
        assert torch.equal(a[k], b[k]), k
    flat2 = export(["--ckpt", stage2, "--out", str(tmp_path / "stage2")])
    local3 = {k for k in flat3 if k.split("/")[1:2] == ["local_backbone"]}
    local2 = {k for k in flat2 if k.split("/")[1:2] == ["local_backbone"]}
    assert local2 == local3, sorted(local2 ^ local3)
    for k in local3:
        assert np.array_equal(flat2[k], flat3[k]), k


def test_train_profile_trace_names_kernels_a_to_g(device, tmp_path):
    """`python -m dh3d_tpu_torch.train --profile` over 16 synthetic
    `detection_config` steps at [20, 8192]: the Chrome trace under
    `<logdir>/profile/` names the CUDA kernels of A-G."""
    import json

    logdir = str(tmp_path / "profiled")
    s = train_cli(["--cfg", "detection_config", "--synthetic", "--steps",
                   "16", "--profile", "--logdir", logdir])
    path = s["profile"]
    assert path and os.path.dirname(path) == os.path.join(logdir, "profile")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [k for k, keys in TRACE_KERNELS.items()
               if not any(key in n for n in names for key in keys)]
    assert not missing, (missing, sorted(names)[:50])


def test_bench_collect_launches(device, forward_launches):
    """`dh3d_tpu_torch.bench.collect`, all seven workloads in this
    process: every value and every window finite and > 0; over one call,
    `fwd_fast` launches what `entry()`'s forward launches, `train_fast`
    every train kernel and nothing else, `knn_ms` G alone, `flex_ms` C
    alone (its moments), and `fwd_parity`, `train_pre` and `train_cps`
    every forward kernel."""
    from dh3d_tpu_torch import bench

    vals, reports = bench.collect(device)
    for name, v in vals.items():
        assert math.isfinite(v) and v > 0, (name, v)
    one = {name: r["launches"] for name, r in reports.items()}
    assert one["fwd_fast"] == forward_launches("exact"), one["fwd_fast"]
    only = {"train_fast": TRAIN_KERNELS, "knn_ms": ("knn_topk",),
            "flex_ms": ("flex_moments",)}
    for name, launched in only.items():
        for k, n in one[name].items():
            assert (n > 0) == (k in launched), (name, k, n)
    for name in ("fwd_parity", "train_pre", "train_cps"):
        assert all(one[name][k] > 0 for k in FORWARD_KERNELS), (name, one)
    for name, r in reports.items():
        assert math.isfinite(r["window"]) and r["window"] > 0, (name, r)


def test_bf16_train_export_and_extraction_clis(device, tmp_path):
    """`train --set compute_dtype='"bfloat16"'` (3 synthetic
    `detection_config` steps at [20, 8192]): finite metrics, the bf16
    cases of C and E launched and the f32 ones never; the exporter on its
    logdir keeps the key; the local extraction CLI with NMS from the
    export on 2 scans launches the bf16 case of C, never the f32 one, and
    writes f32 keypoint files; the global extraction CLI from
    demo_stage3's arrays under a bf16 config launches the bf16 case and
    writes finite unit-norm descriptors."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.evaluate import globaldesc_extract
    from dh3d_tpu_torch.scripts.package_checkpoint import main as export

    logdir = str(tmp_path / "train_bf16")
    _, launches = counted(train_cli, [
        "--cfg", "detection_config", "--synthetic", "--steps", "3", "--set",
        'compute_dtype="bfloat16"', "--logdir", logdir, "--device", "cuda"])
    assert all(launches[k] > 0 for k in BF16_TRAIN_KERNELS), launches
    assert all(launches[k] == 0 for k in BF16_CASES), launches
    stem = str(tmp_path / "stage2_bf16")
    export(["--ckpt", logdir, "--out", stem])
    assert cfglib.load_config(stem + ".config.json").compute_dtype \
        == "bfloat16"
    scans = str(tmp_path / "scans")
    names = write_scans(scans, (200, 201), prefix="s")
    out = str(tmp_path / "nms")
    _, launches = counted(local_cli, scans, out, "--perform_nms",
                          model=stem)
    assert launches["flex_moments_bf16"] > 0, launches
    assert launches["flex_moments"] == 0, launches
    for name in names:
        check_rows(os.path.join(out, f"{name}_nms_res.bin"), NMS["max_kp"])
    g_stem = str(tmp_path / "stage3_bf16")
    shutil.copy("models/demo_stage3.npz", g_stem + ".npz")
    g_cfg = cfglib.load_config("models/demo_stage3.config.json")
    g_cfg.compute_dtype = "bfloat16"
    cfglib.save_config(g_cfg, g_stem + ".config.json")
    gt = str(tmp_path / "gt.pickle")
    with open(gt, "wb") as f:
        pickle.dump({"seq0": [{"query": n, "northing": 10.0 * i,
                               "easting": 0.0} for i, n in enumerate(names)]},
                    f)
    _, launches = counted(globaldesc_extract.main, [
        "--ModelPath", g_stem, "--pcdpath", scans, "--ref_gt_file", gt,
        "--query_gt_file", gt, "--batch_size", "2", "--num_points", "8192",
        "--device", "cuda", "--save_dir", str(tmp_path / "global")])
    assert launches["flex_moments_bf16"] > 0, launches
    check_global_files(str(tmp_path / "global"), names)


# --------------- relocalisation, registration, repeatability ---------------

def moved(cloud, motion, seed, jitter=0.02):
    """cloud @ R.T + t (+ jitter) for the z-rotation and translation of
    `motion`."""
    ang, t = motion
    c, s = math.cos(ang), math.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    noise = np.random.RandomState(seed).randn(*cloud.shape) * jitter
    return (cloud @ R.T + np.asarray(t) + noise).astype(np.float32)


def write_gt(path, seq, items):
    """A GT pickle {seq: [{query, northing, easting}]} of (name, northing)."""
    with open(path, "wb") as f:
        pickle.dump({seq: [{"query": q, "northing": n, "easting": 0.0}
                           for q, n in items]}, f)


@pytest.fixture(scope="module")
def reloc_pool(device, tmp_path_factory):
    """`RELOC["db"]` seeded lidar-like scans of 30,000 points over 30 m x
    30 m (`extent` 15: on the open ground of wider scans the demo
    detector's attention saturates and NMS keeps few keypoints) at places
    10 m apart, and `RELOC["queries"]` queries, query j database scan 3j
    moved by QUERY_MOTION with 0.02 m jitter, 2 m from it; GT pickles
    db.pickle and query.pickle over all of them, db4.pickle and
    query2.pickle over the first 4 and 2.  Returns the directory; its
    .bin files are in `pcd/`."""
    from dh3d_tpu_torch.data.io import write_to_bin

    work = str(tmp_path_factory.mktemp("reloc"))
    pcd = os.path.join(work, "pcd")
    os.makedirs(pcd)
    scans = [lidar_like_scan(300 + i, extent=15.0)
             for i in range(RELOC["db"])]
    for i, scan in enumerate(scans):
        write_to_bin(scan, os.path.join(pcd, f"db{i}.bin"))
    for j in range(RELOC["queries"]):
        write_to_bin(moved(scans[RELOC["source_every"] * j], QUERY_MOTION, j),
                     os.path.join(pcd, f"query{j}.bin"))
    db = [(f"db{i}", 10.0 * i) for i in range(RELOC["db"])]
    query = [(f"query{j}", 10.0 * RELOC["source_every"] * j + 2.0)
             for j in range(RELOC["queries"])]
    write_gt(os.path.join(work, "db.pickle"), "database", db)
    write_gt(os.path.join(work, "query.pickle"), "query", query)
    write_gt(os.path.join(work, "db4.pickle"), "database", db[:4])
    write_gt(os.path.join(work, "query2.pickle"), "query", query[:2])
    return work


def reloc_cli(work, db_gt, query_gt, device):
    """The port's relocalisation CLI, in this process, with the CLI's
    defaults (N=4096, 256 keypoints, 500 RANSAC iterations)."""
    from dh3d_tpu_torch.evaluate import relocalize

    return relocalize.main([
        "--local_model", "models/demo_stage2",
        "--global_model", "models/demo_stage3",
        "--db_gt", os.path.join(work, db_gt),
        "--query_gt", os.path.join(work, query_gt),
        "--pcdpath", os.path.join(work, "pcd"),
        "--num_points", str(RELOC["num_points"]),
        "--nms_max_kp", str(RELOC["nms_max_kp"]),
        "--ransac_iters", str(RELOC["ransac_iters"]),
        "--device", str(device)])


def test_relocalize_cli(reloc_pool, monkeypatch):
    """6DoF relocalisation through the CLI (`evaluate.relocalize`) with its
    defaults, `models/demo_stage2` (local) and `models/demo_stage3`
    (global), 4 queries against 12 scans: A, B, C, D and G launched; one
    global descriptor a cloud and one local a query and its match, every
    one finite and of unit norm; >= 3 mutual matches a query."""
    from dh3d_tpu_torch.evaluate import relocalize

    kept = {"global_desc": [], "local_desc": []}
    real = relocalize.make_forward

    def keeping(cfg, model):
        fwd = real(cfg, model)
        key = "global_desc" if cfg.extract_global else "local_desc"

        def call(*args, **kwargs):
            outs = fwd(*args, **kwargs)
            kept[key].append(outs[key])
            return outs

        return call

    monkeypatch.setattr(relocalize, "make_forward", keeping)
    s, launches = counted(reloc_cli, reloc_pool, "db.pickle", "query.pickle",
                          "cuda")
    n_db, n_q = RELOC["db"], RELOC["queries"]
    assert all(launches[k] > 0 for k in FORWARD_KERNELS), launches
    assert s["n"] == n_q and s["database"] == n_db, s
    assert len(kept["global_desc"]) == n_db + n_q
    assert len(kept["local_desc"]) == 2 * n_q
    for key, outs in kept.items():
        for d in outs:
            assert torch.isfinite(d).all(), key
            assert (d.norm(dim=-1) - 1).abs().max().item() < 1e-4, key
    for q in s["queries"]:
        assert q["matches"] is not None and q["matches"] >= 3, q


def test_relocalize_cli_on_card_matches_cpu(reloc_pool):
    """The relocalisation CLI on 2 queries and 4 database clouds on the
    card and with `--device cpu`: the same top-1 and NMS keypoints."""
    cpu = reloc_cli(reloc_pool, "db4.pickle", "query2.pickle", "cpu")
    card = reloc_cli(reloc_pool, "db4.pickle", "query2.pickle", "cuda")
    assert len(card["queries"]) == len(cpu["queries"]) == 2
    for a, b in zip(card["queries"], cpu["queries"]):
        assert a["top1"] == b["top1"], (a["query"], a["top1"], b["top1"])
        assert a["kp_query"] == b["kp_query"], a["query"]
        assert a["kp_db"] == b["kp_db"], a["query"]


def test_registration_self_test_and_repeatability_clis(nms_extraction,
                                                        reloc_pool):
    """`registration_eval --self_test` on a keypoint file of the NMS
    extraction: success, RTE < 1e-6 m, RRE < 1e-4 deg;
    `repeatability_eval --protocol both` on 4 scans with
    `models/demo_stage2`: every value of both curves in [0, 1]."""
    from dh3d_tpu_torch.evaluate import registration_eval, repeatability_eval

    nms_file = os.path.join(nms_extraction[0], "scan0_nms_res.bin")
    st = registration_eval.main(["--self_test", nms_file, "--device", "cuda"])
    assert st["success"] and st["rte"] < 1e-6 and st["rre"] < 1e-4, st
    rep = repeatability_eval.main([
        "--model", "models/demo_stage2", "--pcdpath",
        os.path.join(reloc_pool, "pcd"), "--max_clouds", "4", "--protocol",
        "both", "--device", "cuda"])
    for curve in (rep["self-pair"], rep["partial-overlap"]):
        assert all(0 <= v <= 1 for v in curve.values()), curve


def test_error_budget_cli(device, tmp_path):
    """`evaluate.error_budget` with the demo weights on two sequences of 4
    normalised lidar-like scans at N=8192 (`seq1` the same places' scans
    moved by QUERY_MOTION, 3 m further): all four stages, every number
    finite, 0 < neighbour agreement <= 1."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd, write_to_bin
    from dh3d_tpu_torch.evaluate import error_budget

    n, per = BUDGET["num_points"], BUDGET["per_sequence"]
    gts = {"seq0": [], "seq1": []}
    for i in range(per):
        scan = lidar_like_scan(400 + i)
        for seq, cloud, north in (("seq0", scan, 10.0 * i),
                                  ("seq1", moved(scan, QUERY_MOTION, i),
                                   10.0 * i + 3.0)):
            pts, real = get_fixednum_pcd(cloud, n, randsample=False,
                                         need_downsample=True,
                                         rng=np.random.RandomState(i))
            assert real == n, (seq, i, real)
            os.makedirs(tmp_path / seq, exist_ok=True)
            write_to_bin(pts, str(tmp_path / seq / f"s{i}.bin"))
            gts[seq].append({"query": f"{seq}/s{i}", "northing": north,
                             "easting": 0.0})
    for name in ("global_ref_demo.pickle", "global_query_demo.pickle"):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(gts, f)
    report = error_budget.main([
        "--local_model", "models/demo_stage2",
        "--global_model", "models/demo_stage3", "--pcdpath", str(tmp_path),
        "--num_points", str(n), "--device", "cuda",
        "--json", str(tmp_path / "budget.json")])

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) else []

    assert report["n_clouds"] == 2 * per, report["n_clouds"]
    assert all(map(math.isfinite, numbers(report))), "a non-finite number"
    assert 0 < report["A_knn"]["neighbor_agreement_mean"] <= 1


# ---------------------------- the parallel path ----------------------------

def step_errors(one, other, bn_fed, lr) -> dict:
    """The largest difference of each kind between two steps'
    `step_result`s, each as a share of its `DP_*` limit."""
    worst = {}

    def share(kind, err, limit):
        worst[kind] = max(worst.get(kind, 0.0), err / limit)

    total = abs(one["metrics"]["total_cost"])
    for k, v in one["metrics"].items():
        share("metrics", abs(other["metrics"][k] - v),
              DP_METRIC_REL * max(total, abs(v)))
    top = max(g.abs().max().item() for g in one["grads"].values())
    for name, g in one["grads"].items():
        scale = top * 1e-1 if name in bn_fed else g.abs().max().item()
        share("grads", (other["grads"][name] - g).abs().max().item(),
              DP_GRAD_REL * scale)
        for key, factor in (("exp_avg", 0.1), ("exp_avg_sq", 1e-3 * scale)):
            err = (other["adam"][name][key] - one["adam"][name][key]).abs()
            share("adam", err.max().item(), 2 * DP_GRAD_REL * factor * scale)
        diff = (other["state"][name] - one["state"][name]).abs()
        sure = g.abs() > 1e-2 * scale
        share("params_sure", diff[sure].max().item() if sure.any() else 0.0,
              1e-6)
        share("params", diff.max().item(), 2 * lr + 1e-6)
    for name, v in one["state"].items():
        if name not in one["grads"]:  # BN statistics, frozen parameters
            share("bn", (other["state"][name] - v).abs().max().item(),
                  DP_BN_REL * v.abs().max().item() + 1e-6)
    return worst


def dp_global_case():
    """A `global_config` step with `cross_device_mining` at
    `models/demo_stage3.config.json`'s values (2 tuples of 1 + 2 + 8 + 1
    clouds: 24 clouds of 8192 points; no warmup, whose learning rate is 0
    at step 0), the local backbone of `models/demo_stage3.npz`, the head
    from seed 0, unit-scale clouds presorted: (cfg, weights, batch) on the
    CPU."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.train import init_state

    cfg = cfglib.load_config("models/demo_stage3.config.json")
    cfg.cross_device_mining = True
    cfg.warmup_steps = 0
    state = init_state(cfg, 0, "cpu")
    flat = {k: v for k, v in load_npz("models/demo_stage3.npz").items()
            if k.split("/")[1:2] == ["local_backbone"]}
    assert smart_init(state.model, flat) == len(flat)
    clouds = cfg.batch_size * (1 + cfg.num_pos + cfg.num_neg + 1)
    pts = np.random.RandomState(17).randn(clouds, cfg.num_points, 3)
    pts = morton_sort_np(pts.astype(np.float32))
    return cfg, state.model.state_dict(), {"points": torch.from_numpy(pts)}


def dp_detection_case(device):
    """A `detection_config` step at `models/demo_stage2.config.json`'s
    values (10 pairs of 8192 points, 512 keypoints, `device_pairgen` on
    presorted clouds), `models/demo_stage2.npz`, the pairs' draws made
    once on the card: (cfg, weights, batch with its draws) on the CPU."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.parallel.jobs import to
    from dh3d_tpu_torch.train import add_draws, to_device

    cfg = cfglib.load_config("models/demo_stage2.config.json")
    assert cfg.device_pairgen and cfg.morton_presorted
    state = stage2_state(cfg, "cpu")
    rng = np.random.RandomState(18)
    B, N = cfg.batch_size, cfg.num_points
    pc1 = (rng.randn(B, N, 3) * 20).astype(np.float32)
    pc2 = np.stack([p[rng.permutation(N)] for p in pc1]) \
        + (rng.randn(B, N, 3) * 0.02).astype(np.float32)
    batch = to_device({"pc1": morton_sort_np(pc1),
                       "pc2": morton_sort_np(pc2)}, device)
    pairgen = torch.Generator(device=device).manual_seed(18)
    batch = add_draws(batch, cfg, pairgen)
    return cfg, state.model.state_dict(), to(batch, "cpu")


def reversed_tuples(cfg, batch):
    """`batch` (with its draws) with its tuples, or pairs, in reverse
    order: the same step in exact arithmetic."""
    out = dict(batch)
    if "pc1" in batch:
        out["pc1"], out["pc2"] = batch["pc1"].flip(0), batch["pc2"].flip(0)
        out["pairgen_draws"] = tuple(d.flip(0) for d in batch["pairgen_draws"])
        return out
    B = cfg.batch_size
    parts = batch["points"].split([B, cfg.num_pos * B, cfg.num_neg * B, B])
    out["points"] = torch.cat([p.reshape(B, -1, *p.shape[1:]).flip(0)
                               .reshape(p.shape) for p in parts])
    return out


def one_process_step(device, cfg, weights, batch):
    """The one-process step on the card: its `step_result`, launches and
    `bn_fed_biases`."""
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.parallel.jobs import step_result, to
    from dh3d_tpu_torch.train import init_state, make_train_step

    state = init_state(cfg, 0, device)
    state.model.load_state_dict(weights)
    m, launches = counted(make_train_step(cfg), state, to(batch, device))
    out = step_result(state, m)
    out.update(launches=launches, bn_fed=bn_fed_biases(state.model))
    return out


@pytest.fixture(scope="module")
def two_ranks(device):
    """One launch of two ranks sharing `cuda:0` through gloo (NCCL refuses
    two ranks on one device): a `dp_global_case` and a `dp_detection_case`
    step and `knn_sharded` at [20, 8192] and [1, 16384], k=8.  Returns
    ({case: (cfg, one-process step, reversed-batch step)}, knn cases,
    each rank's results)."""
    from dh3d_tpu_torch.parallel import jobs
    from dh3d_tpu_torch.parallel.launch import spawn

    cases = {"global": dp_global_case(),
             "detection": dp_detection_case(device)}
    g = torch.Generator().manual_seed(19)
    knn_cases = [((torch.randn(B, N, 3, generator=g) * 30), 8)
                 for B, N in ((20, 8192), (1, 16384))]
    steps = {name: (cfg, one_process_step(device, cfg, weights, batch),
                    one_process_step(device, cfg, weights,
                                     reversed_tuples(cfg, batch)))
             for name, (cfg, weights, batch) in cases.items()}
    torch.cuda.empty_cache()
    ranks = spawn(jobs.calls_job, 2, (
        [(jobs.step_job, (dict(cfg), weights, batch))
         for cfg, weights, batch in cases.values()]
        + [(jobs.knn_job, (knn_cases,))],), device="cuda", backend="gloo")
    return steps, knn_cases, ranks


@pytest.mark.parametrize("case", ["global", "detection"])
def test_parallel_two_gloo_ranks_match_one_process(two_ranks, case):
    """Each rank's data-parallel step against the one-process step on the
    card from the same weights and draws: the gradients and the state
    equal on both ranks; metrics, reduced gradients, BN statistics, the
    updated parameters and Adam's moments each within the larger of its
    `DP_*` limit and twice the order noise of the reversed batch
    (`step_errors`); every kernel the one-process step launches launched
    by each rank's step."""
    steps, _, ranks = two_ranks
    i = list(steps).index(case)
    cfg, one, rev = steps[case]
    noise = step_errors(one, rev, one["bn_fed"], cfg.start_lr)
    for rank in ranks:
        res = rank[i]
        for key in ("grads", "state"):
            for k, v in res[key].items():
                assert torch.equal(v, ranks[0][i][key][k]), (key, k)
        worst = step_errors(one, res, one["bn_fed"], cfg.start_lr)
        for kind, err in worst.items():
            assert err <= max(1.0, 2 * noise[kind]), (kind, err, noise[kind])
        for k, n in one["launches"].items():
            assert n == 0 or res["launches"][k] > 0, k


def test_parallel_knn_sharded_on_two_ranks_equals_bruteforce(device,
                                                              two_ranks):
    """`knn_sharded` on the two ranks at [20, 8192] and [1, 16384], k=8:
    each rank's block of ids and distances equal to `knn_bruteforce` bit
    for bit, G launched on each rank."""
    _, knn_cases, ranks = two_ranks
    for r, rank in enumerate(ranks):
        for (pts, k), (idx, dist, counts) in zip(knn_cases, rank[-1]):
            assert counts["knn_topk"] > 0, counts
            want_idx, want_dist = T.knn_bruteforce(pts.to(device), k)
            block = slice(r * pts.shape[1] // 2, (r + 1) * pts.shape[1] // 2)
            assert torch.equal(idx, want_idx[:, block].cpu())
            assert torch.equal(dist, want_dist[:, block].cpu())


@pytest.mark.parametrize("world", [1, 2])
def test_graphed_data_parallel_step_equals_eager(device, world):
    """The data-parallel stage-2 step at full width over `world` NCCL
    ranks, a card each (models/demo_stage2's config and weights, 2 pairs
    of 8192 presorted points a rank, pairs made in the step), graphed (the
    first step eager, the second captured, the later ones replayed) and
    eager (a no-op forward hook), on the same batches and draws, 4 steps:
    each step's metrics, kernel launches and collective counters (a replay
    adds what its capture counted) and, at the end, every parameter,
    statistic and Adam moment and step, bit for bit on every rank; the
    graphed side counts 1 eager step, 1 capture and 2 replays.  Two ranks'
    sums are one addition, the same whichever algorithm NCCL picks for a
    captured collective, so no bit may move.  Skips below `world` cards."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.parallel import jobs
    from dh3d_tpu_torch.parallel.launch import spawn
    from dh3d_tpu_torch.train import add_draws, init_state

    cfg = cfglib.load_config("models/demo_stage2.config.json")
    assert cfg.morton_presorted and cfg.device_pairgen
    P = cfg.batch_size = 2 * world
    cfg.num_devices = world
    state = init_state(cfg, 0, "cpu")
    assert smart_init(state.model, load_npz("models/demo_stage2.npz"))
    rng = np.random.RandomState(25)
    batches = []
    for i in range(4):
        pts = morton_sort_np((rng.randn(2 * P, cfg.num_points, 3) * 10)
                             .astype(np.float32))
        batches.append(add_draws(
            {"pc1": torch.from_numpy(pts[:P]),
             "pc2": torch.from_numpy(pts[P:])}, cfg,
            torch.Generator().manual_seed(100 + i)))
    kernels.library()  # built once, before the ranks start
    ranks = spawn(jobs.graph_job, world, (dict(cfg), state.model.state_dict(),
                                          batches), device="cuda")
    for rank in ranks:
        graphed, eager = rank["graphed"], rank["eager"]
        assert graphed["counters"] == {
            "train.eager_steps": 1, "train.graph_captures": 1,
            "train.graph_replays": 2}, graphed["counters"]
        assert eager["counters"] == {"train.eager_steps": 4}
        for i, (g, e) in enumerate(zip(graphed["steps"], eager["steps"])):
            for k, v in e["metrics"].items():
                assert torch.equal(g["metrics"][k], v), (i, k)
            assert g["launches"] == e["launches"], i
            assert g["collectives"] == e["collectives"], i
            assert e["collectives"]["collective.calls.all_gather"] == 9
        for key in ("state", "grads"):
            for k, v in eager[key].items():
                assert torch.equal(graphed[key][k], v), (key, k)
                assert torch.equal(ranks[0]["graphed"][key][k], v), (key, k)
        for k, moments in eager["adam"].items():
            for m, v in moments.items():
                assert torch.equal(graphed["adam"][k][m], v), (k, m)
        assert graphed["adam_step"] == eager["adam_step"]


def test_parallel_train_cli_on_nccl(device, tmp_path):
    """`python -m dh3d_tpu_torch.train --num_devices 1` on NCCL
    (`detection_config`, synthetic, 3 steps, warm-started): finite
    metrics, one checkpoint, every train kernel launched by the last step;
    `--num_devices` above the card count raises ValueError."""
    argv = ["--cfg", "detection_config", "--synthetic", "--steps", "3",
            "--load", "models/demo_stage2.npz", "--logdir", str(tmp_path)]
    s = train_cli(argv + ["--num_devices", "1"])
    assert os.listdir(tmp_path / "ckpt") == ["step_00000003.pt"]
    assert all(s["launches"][-1][k] > 0 for k in TRAIN_KERNELS), \
        s["launches"][-1]
    with pytest.raises(ValueError):
        train_cli(argv + ["--num_devices",
                          str(torch.cuda.device_count() + 1)])

