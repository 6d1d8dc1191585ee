"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases; any failure raises, so the script exits non-zero and prints no
result line:
  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build the kernels from `dh3d_tpu_torch/csrc` (one nvcc per source, in
     parallel; timed).
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the forward and the train step give it, both timed with CUDA
     events (median of 10 after warm-up).
  4. the main-path forward (`dh3d_tpu_torch.entry.entry`) at [20, 8192]:
     every forward kernel's launch count over that one forward must be > 0;
     the outputs must be finite, of the model's shapes, with unit-norm
     descriptors; clouds/s.
  5. the same forward at [2, 8192] on the card and on the CPU (plain
     versions), same weights and clouds: indices equal, descriptors within
     the tolerances below.
  6. the training slice's main path: `detection_config` train steps at full
     width ([20, 8192], 512 keypoints; the sizes of
     `models/demo_stage2.config.json`), weights from `models/demo_stage2.npz`
     through the port's warm-start loader, seeded synthetic batches.  Over
     one step every kernel (A-F) is launched; loss and metrics are finite;
     every trainable gradient is finite and nonzero (but the biases that
     feed a BatchNorm, whose exact gradient is 0); the BN running
     statistics move.  Step time (CUDA events), clouds/s, peak memory, the
     forward / backward / optimizer split and a `torch.profiler` split.
  7. one train step at [2, 8192] on the card and on the CPU, same weights
     and batch: Morton order, kNN, FPS, 3-NN and the detection loss's kNN
     equal; losses and gradients within the tolerances below.
The last three lines: the card, the kernels JSON, the ok JSON.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# Phase 5 tolerances, card vs CPU.  Every index (Morton order, kNN, FPS,
# 3-NN) is computed from the coordinates alone with the same rounded
# operations on both sides, so it must be equal.  Features differ only in
# summation order (FMA accumulation in the kernels, other matmul blocking):
# ~1e-6 relative, held here to 1e-4 absolute on the unit-scale outputs and
# 1e-5 of the largest magnitude on the unnormalised `feat`.
CARD_VS_CPU_ATOL = 1e-4
CARD_VS_CPU_FEAT_REL = 1e-5
# Phase 3: weighted sums and their backward against their plain versions,
# same reason; the max backward adds the same terms in the same order.
WSUM_REL = 1e-5
# Phase 7 tolerances, card vs CPU train step.  Indices as in phase 5.
# Losses: f32 summation order through ~30 layers and a BatchNorm on batch
# statistics at each, ~1e-6 relative; held to 1e-4.  Gradients: the same
# rounding, amplified by the BatchNorm backward (a difference of large
# means); each held to 1e-3 of its tensor's largest magnitude.  The
# gradients of biases that feed a BatchNorm are 0 exactly (rounding noise
# on both sides) and are held to 1e-3 of the model's largest gradient.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3

BANDED = "dh3d_tpu/ops/pallas/banded_pallas.py"
REPLACES = {
    "knn": ("dh3d_tpu/ops/pallas/knn_pallas.py:34",
            ["dh3d_tpu/ops/pallas/knn_pallas.py:149",
             "dh3d_tpu/ops/pallas/knn_pallas.py:112"]),
    "fps": ("dh3d_tpu/ops/pallas/fps_pallas.py:31", []),
    "weighted_sum": (f"{BANDED}:77", [f"{BANDED}:432", f"{BANDED}:1294"]),
    "neighbor_max": (f"{BANDED}:896", []),
    "weighted_sum_backward": (f"{BANDED}:479", [f"{BANDED}:105",
                                                f"{BANDED}:147",
                                                f"{BANDED}:1294"]),
    "neighbor_max_backward": (f"{BANDED}:187", [f"{BANDED}:1294"]),
}
SOURCES = {
    "knn": "dh3d_tpu_torch/csrc/knn.cu",
    "fps": "dh3d_tpu_torch/csrc/fps.cu",
    "weighted_sum": "dh3d_tpu_torch/csrc/neighborhood.cu",
    "neighbor_max": "dh3d_tpu_torch/csrc/neighborhood.cu",
    "weighted_sum_backward": "dh3d_tpu_torch/csrc/neighborhood.cu",
    "neighbor_max_backward": "dh3d_tpu_torch/csrc/neighborhood.cu",
}
CSR_MS = {}  # phase 3's timings of the CSR inverse, for the report
# the forward (phase 4) runs A-D; the train step (phase 6) all six
FORWARD_KERNELS = ("knn", "fps", "weighted_sum", "neighbor_max")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup=3, reps=10) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(torch, T, device):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns {kernel name: [case dict, ...]}, the main-path case first."""
    from dh3d_tpu_torch.entry import entry_points

    B, N, M, K = 20, 8192, 1024, 8
    g = torch.Generator(device="cpu").manual_seed(0)
    raw = torch.from_numpy(entry_points(B, N)).to(device)
    perm, _ = T.morton_perm(raw)
    pts = torch.gather(raw, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    cases = {name: [] for name in REPLACES}

    def case(name, shape, kernel_fn, plain_fn, compare):
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = compare(out, ref)
        ms = cuda_ms(torch, kernel_fn)
        plain_ms = cuda_ms(torch, plain_fn)
        cases[name].append({"shape": shape, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms})
        log(f"  {name:13s} {shape:42s} kernel {ms:9.3f} ms  plain "
            f"{plain_ms:9.3f} ms  max_abs_err {err:.3g}")

    def same_knn(out, ref):
        assert torch.equal(out[0], ref[0]), "kNN indices differ"
        assert torch.equal(out[1], ref[1]), "kNN d2 differ"
        return 0.0

    def same(out, ref):
        assert torch.equal(out, ref), "indices differ"
        return 0.0

    def wsum_close(out, ref):
        err = (out - ref).abs().max().item()
        assert err <= WSUM_REL * ref.abs().max().item(), err
        return err

    def same_max(out, ref):
        assert torch.equal(out[0], ref[0]), "max values differ"
        assert torch.equal(out[1], ref[1]), "argmax ids differ"
        if len(out) == 3:
            assert torch.equal(out[2], ref[2]), "argmax slots differ"
        return 0.0

    # A: self-kNN at both levels, and the 3-NN upsample lookup
    case("knn", f"self k=8 [{B},{N}]", lambda: T.knn(pts, pts, K),
         lambda: T.knn_plain(pts, pts, K), same_knn)
    sub_idx = torch.sort(T.farthest_point_sample(pts, M), dim=-1).values
    sub = T.gather_point(pts, sub_idx).contiguous()
    case("knn", f"self k=8 [{B},{M}]", lambda: T.knn(sub, sub, K),
         lambda: T.knn_plain(sub, sub, K), same_knn)
    case("knn", f"cross k=3 [{B},{N}]->[{B},{M}]", lambda: T.knn(pts, sub, 3),
         lambda: T.knn_plain(pts, sub, 3), same_knn)

    # B: FPS 8192 -> 1024
    case("fps", f"[{B},{N}]->{M}", lambda: T.farthest_point_sample(pts, M),
         lambda: T.fps_plain(pts, M), same)

    # C: the flex-conv moments, initconv's difference sum, the upsample,
    # and once on random (non-banded) indices
    nbh, _ = T.knn(pts, pts, K)
    f64 = torch.randn(B, N, 64, generator=g).to(device)
    w4 = T.flex_weights(pts, nbh)
    case("weighted_sum", f"P=4 C=64 K=8 [{B},{N}]",
         lambda: T.weighted_sum(f64, nbh, w4),
         lambda: T.weighted_sum_plain(f64, nbh, w4), wsum_close)
    w1 = torch.ones(B, N, K, 1, device=device)
    w1[:, :, 0] = 1 - K
    case("weighted_sum", f"P=1 C=3 K=8 [{B},{N}] (raw xyz)",
         lambda: T.weighted_sum(pts, nbh, w1),
         lambda: T.weighted_sum_plain(pts, nbh, w1), wsum_close)
    d2_3, idx3 = T.three_nn(pts, sub)
    w3 = T.inverse_distance_weights(d2_3)[..., None].contiguous()
    f256 = torch.randn(B, M, 256, generator=g).to(device)
    case("weighted_sum", f"P=1 C=256 K=3 [{B},{N}]<-[{B},{M}]",
         lambda: T.weighted_sum(f256, idx3, w3),
         lambda: T.weighted_sum_plain(f256, idx3, w3), wsum_close)
    rnd = torch.randint(0, N, (B, N, K), generator=g).to(device)
    case("weighted_sum", f"P=4 C=64 K=8 [{B},{N}] random idx",
         lambda: T.weighted_sum(f64, rnd, w4),
         lambda: T.weighted_sum_plain(f64, rnd, w4), wsum_close)

    # D: flex_pool of stage 1, without and with the slot of the backward
    case("neighbor_max", f"C=64 K=8 [{B},{N}]",
         lambda: T.neighbor_max(f64, nbh),
         lambda: T.neighbor_max_plain(f64, nbh)[:2], same_max)
    case("neighbor_max", f"C=64 K=8 [{B},{N}] with slot",
         lambda: T.neighbor_max_with_slot(f64, nbh),
         lambda: T.neighbor_max_plain(f64, nbh), same_max)

    # A at k=16 across clouds: the detection loss's keypoint queries
    P2, KP = B // 2, 512
    kp = pts[:P2, :KP].contiguous() + 0.25
    case("knn", f"cross k=16 [{P2},{KP}]->[{P2},{N}]",
         lambda: T.knn(kp, pts[:P2].contiguous(), 16),
         lambda: T.knn_plain(kp, pts[:P2].contiguous(), 16), same_knn)

    # E: the transposes of C (CSR inverse built inside, as on the path)
    nbh1, _ = T.knn(sub, sub, K)
    w4s = T.flex_weights(sub, nbh1)
    dm64 = torch.randn(B, N, 4 * 64, generator=g).to(device)
    dm128 = torch.randn(B, M, 4 * 128, generator=g).to(device)
    dm3 = torch.randn(B, N, 128, generator=g).to(device)
    for label, dm, idx, w, keys in (
            (f"P=4 C=64 K=8 [{B},{N}]", dm64, nbh, w4, N),
            (f"P=4 C=128 K=8 [{B},{M}]", dm128, nbh1, w4s, M),
            (f"P=1 C=128 K=3 [{B},{N}]->[{B},{M}]", dm3, idx3, w3, M),
            (f"P=4 C=64 K=8 [{B},{N}] random idx", dm64, rnd, w4, N)):
        case("weighted_sum_backward", label,
             lambda: T.weighted_sum_backward(dm, idx, w, keys),
             lambda: T.weighted_sum_backward_plain(dm, idx, w, keys),
             wsum_close)

    # the CSR inverse that E and F build inside their wrappers (integer
    # sorts, not a kernel of this repository): its share of their times
    for label, idx, keys in ((f"K=8 [{B},{N}]", nbh, N),
                             (f"K=8 [{B},{M}]", nbh1, M),
                             (f"K=3 [{B},{N}]->[{B},{M}]", idx3, M)):
        ms = cuda_ms(torch, lambda: T.inverse_neighbors(idx, keys))
        CSR_MS[label] = ms
        log(f"  (CSR inverse   {label:42s}          {ms:9.3f} ms)")

    # F: the max-pool transposes of initconv, stage 1 and stage 2
    f32 = torch.randn(B, N, 32, generator=g).to(device)
    f128 = torch.randn(B, M, 128, generator=g).to(device)
    for label, feat, idx, keys in ((f"C=32 K=8 [{B},{N}]", f32, nbh, N),
                                   (f"C=64 K=8 [{B},{N}]", f64, nbh, N),
                                   (f"C=128 K=8 [{B},{M}]", f128, nbh1, M)):
        slot = T.neighbor_max_with_slot(feat, idx)[2]
        dval = torch.randn(feat.shape[0], idx.shape[1], feat.shape[2],
                           generator=g).to(device)
        case("neighbor_max_backward", label,
             lambda: T.neighbor_max_backward(dval, idx, slot, keys),
             lambda: T.neighbor_max_backward_plain(dval, idx, slot, keys),
             wsum_close)
    return cases


def check_outputs(torch, outs, points, B, N):
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


def stage2_config():
    """`detection_config` with the values of models/demo_stage2.config.json
    (batch_size 10 pairs = 20 clouds of 8192 points, 512 keypoints,
    det_k 16).  That run generated its pairs on the device from presorted
    clouds; the port's batches are the host-side synthetic pairs, neither
    presorted nor generated on the device, so those two keys go off."""
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


def check_gradients(torch, state, cfg):
    """Every trainable gradient finite; nonzero but where it is 0 exactly
    (a bias that feeds a BatchNorm)."""
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import param_labels

    zero = bn_fed_biases(state.model)
    labels = param_labels(cfg, state.model)
    n = 0
    for name, p in state.model.named_parameters():
        if labels[name] != "trainable":
            continue
        assert p.grad is not None, f"{name}: no gradient"
        assert torch.isfinite(p.grad).all(), f"{name}: gradient not finite"
        if name not in zero:
            assert p.grad.abs().max().item() > 0, f"{name}: zero gradient"
        n += 1
    return n


def profile_step(torch, step):
    """Device time of one step by kernel class, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    classes = (
        ("port kernels A-F", ("knn_kernel", "fps_kernel", "weighted_sum",
                              "neighbor_max")),
        ("GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "cublas")),
        ("optimizer", ("adam", "multi_tensor", "foreach")),
        ("sort, scan, gather, scatter", ("sort", "radix", "scan", "index",
                                         "gather", "scatter", "search",
                                         "cub::")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    )
    split = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        cls = next((c for c, keys in classes
                    if any(k in name for k in keys)), "other")
        split[cls] = split.get(cls, 0.0) + e.time_range.elapsed_us() / 1e3
    return split


def train_phase(torch, kernels, device):
    """Phase 6.  Returns (launches over one counted step, report)."""
    from dh3d_tpu_torch.train import (forward_loss, make_train_step,
                                      synthetic_local_batches, to_device)

    cfg = stage2_config()
    B2, N = 2 * cfg.batch_size, cfg.num_points
    state = stage2_state(cfg, device)
    batches = synthetic_local_batches(cfg, seed=0)
    batch = to_device(next(batches), device)
    step_fn = make_train_step(cfg)
    for _ in range(2):  # warm-up
        step_fn(state, batch)
    bn_before = {k: v.clone() for k, v in state.model.named_buffers()}
    batch = to_device(next(batches), device)
    torch.cuda.synchronize()
    kernels.reset_counts()
    metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    launches = kernels.counts()
    log(f"  launches in one train step: {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched by the train step"
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(map(math.isfinite, metrics.values())), metrics
    n_grads = check_gradients(torch, state, cfg)
    moved = [k for k, v in state.model.named_buffers()
             if not torch.equal(v, bn_before[k])]
    assert len(moved) == len(bn_before), \
        f"BN statistics that did not move: {set(bn_before) - set(moved)}"
    log(f"  {n_grads} trainable gradients finite and nonzero; "
        f"{len(moved)} BN statistics moved")

    # timed steps: CUDA events around the forward+loss, the backward and
    # the optimizer update of each
    model, opt = state.model, state.optimizer
    from dh3d_tpu_torch.train import apply_gradients

    def step_parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        model.train()
        total, m, _ = forward_loss(model, cfg, batch)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[2].record()
        apply_gradients(state, cfg)
        ev[3].record()
        return ev, m

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(7):
        ev, m = step_parts()
        ev[3].synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(sum(t) for t in times)
    parts = {k: statistics.median(t[i] for t in times)
             for i, k in enumerate(("forward_loss", "backward",
                                    "optimizer"))}
    try:
        split = profile_step(torch, step_parts)
    except Exception as e:  # the split is a report, not a check
        split = {"not measured": repr(e)}
    last = {k: torch.as_tensor(v).item() for k, v in m.items()}
    assert all(map(math.isfinite, last.values())), last
    report = {"shape": [B2, N, 3], "keypoints": cfg.sampled_kpnum,
              "step_ms": step_ms, "clouds_per_s": B2 / (step_ms / 1e3),
              "parts_ms": parts, "peak_mem_gb": peak_gb,
              "profile_ms": split, "last_metrics": last,
              "launches": launches}
    log(f"  train step: {step_ms:.2f} ms median of 7 (CUDA events), "
        f"{B2 / (step_ms / 1e3):.1f} clouds/s; {parts}; peak {peak_gb:.2f} GB")
    log(f"  profile of one step (device ms): {split}")
    log(f"  last metrics: {last}")
    return launches, report


def card_vs_cpu_train(torch, device):
    """Phase 7: one [2, 8192] step on the card and on the CPU."""
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
        t0 = time.perf_counter()
        total, metrics, outs = forward_loss(state.model, cfg,
                                            to_device(batch, dev))
        total.backward()
        seconds = time.perf_counter() - t0
        hook.remove()
        det = {k: v.detach() for k, v in outs.items()}
        ar, cand = detection_ranks(det, cfg.det_k, cfg.ar_nn_k, cfg.pos_r)
        runs[str(dev)] = {
            "metrics": {k: torch.as_tensor(v).item()
                        for k, v in metrics.items()},
            "grads": {n: p.grad.cpu()
                      for n, p in state.model.named_parameters()},
            "idx": {"morton xyz": outs["xyz"].detach().cpu(),
                    "knn k=8 [8192]": outs["knn_indices"].cpu(),
                    "fps": caches[0]["kp_idx"].cpu(),
                    "knn k=8 [1024]": caches[0]["knn_indices"].cpu(),
                    "3-nn": caches[0]["interp"][1].cpu(),
                    "det-loss knn k=16": cand[..., :cfg.det_k].cpu()},
            "hardest": cand[..., cfg.det_k:].cpu(), "ar": ar.cpu(),
            "s": seconds}
        zero = bn_fed_biases(state.model)
    cpu, gpu = runs["cpu"], runs[str(device)]
    for key, ref in cpu["idx"].items():
        assert torch.equal(gpu["idx"][key], ref), f"{key} differs"
    flips = int((gpu["ar"] != cpu["ar"]).sum())
    neg = int((gpu["hardest"] != cpu["hardest"]).any(-1).sum())
    log(f"  indices equal ({', '.join(cpu['idx'])}); detection ranks "
        f"flipped: {flips} of {cpu['ar'].numel()}; hardest-negative "
        f"neighbourhoods that differ: {neg}")
    errs = {}
    for k, v in cpu["metrics"].items():
        errs[k] = abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
        assert errs[k] <= TRAIN_LOSS_REL, (k, v, gpu["metrics"][k])
    top = max(g.abs().max().item() for g in cpu["grads"].values())
    worst = (0.0, "")
    for name, g in cpu["grads"].items():
        scale = top if name in zero else g.abs().max().item()
        err = (gpu["grads"][name] - g).abs().max().item() / scale
        worst = max(worst, (err, name))
        assert err <= TRAIN_GRAD_REL, (name, err)
    log(f"  worst loss rel err {max(errs.values()):.3g}; worst gradient "
        f"err {worst[0]:.3g} of its scale ({worst[1]}); CPU step "
        f"{cpu['s']:.1f} s, card step {gpu['s']:.2f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from dh3d_tpu_torch import kernels
    from dh3d_tpu_torch import ops as T
    from dh3d_tpu_torch.entry import entry

    log("phase 2: build")
    path, build_s = kernels.build()
    kernels.library()
    log(f"  built {path} in {build_s:.1f} s")

    log("phase 3: kernels vs plain versions")
    cases = kernel_phase(torch, T, device)

    log("phase 4: main-path forward [20, 8192]")
    B, N = 20, 8192
    fn, (points,) = entry(device, batch=B)
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs = fn(points)
    torch.cuda.synchronize()
    fwd_launches = kernels.counts()
    log(f"  launches in one forward: {fwd_launches}")
    for name in FORWARD_KERNELS:
        assert fwd_launches[name] > 0, \
            f"kernel {name} was not launched by the forward"
    check_outputs(torch, outs, points, B, N)
    fwd_ms = cuda_ms(torch, lambda: fn(points), warmup=2, reps=10)
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(points)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / iters
    log(f"  forward: {fwd_ms:.2f} ms median (CUDA events), "
        f"{B / (fwd_ms / 1e3):.1f} clouds/s; host clock {B / host_s:.1f} "
        f"clouds/s over {iters} forwards")
    log(json.dumps({"forward": {
        "shape": [B, N, 3], "ms": fwd_ms, "clouds_per_s": B / (fwd_ms / 1e3),
        "host_clouds_per_s": B / host_s, "peak_mem_gb":
            torch.cuda.max_memory_allocated() / 1e9}}))
    del outs

    log("phase 5: card vs CPU forward [2, 8192]")
    fn_gpu, (p_gpu,) = entry(device, batch=2)
    fn_cpu, (p_cpu,) = entry("cpu", batch=2)
    t0 = time.perf_counter()
    o_cpu = fn_cpu(p_cpu)
    cpu_s = time.perf_counter() - t0
    o_gpu = {k: v.cpu() for k, v in fn_gpu(p_gpu).items()}
    for key in ("xyz", "knn_indices"):
        assert torch.equal(o_gpu[key], o_cpu[key]), key
    errs = {}
    for key in ("local_desc", "attention", "global_desc", "xyz_feat_att"):
        errs[key] = (o_gpu[key] - o_cpu[key]).abs().max().item()
        assert errs[key] <= CARD_VS_CPU_ATOL, (key, errs[key])
    feat_err = (o_gpu["feat"] - o_cpu["feat"]).abs().max().item()
    feat_scale = o_cpu["feat"].abs().max().item()
    assert feat_err <= CARD_VS_CPU_FEAT_REL * feat_scale, (feat_err,
                                                           feat_scale)
    log(f"  indices equal; max abs err {errs}; feat {feat_err:.3g} of "
        f"{feat_scale:.3g}; CPU forward {cpu_s:.1f} s")

    log("phase 6: train step, detection_config [20, 8192]")
    train_launches, train_report = train_phase(torch, kernels, device)

    log("phase 7: card vs CPU train step [2, 8192]")
    card_vs_cpu_train(torch, device)

    kernel_rows = []
    for name, rows in cases.items():
        main_case = rows[0]
        replaces, also = REPLACES[name]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "also_replaces": also,
            "launches": train_launches[name],
            "launches_by_path": {"forward": fwd_launches[name],
                                 "train_step": train_launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "shape": main_case["shape"], "cases": rows})
    train_report["csr_inverse_ms"] = CSR_MS
    log(json.dumps({"train_step": train_report}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
