"""The PyTorch port's trainer against the JAX package's, on the CPU.

Held to `dh3d_tpu.train`: the learning-rate schedule and one Adam update
(optax), the weight-decay term, the freeze labels, Flax's BatchNorm in
train mode and its initialisers, and one whole train step of
`detection_config` and of `global_config` at a small size: the metrics,
the gradient of every trainable parameter and the BN statistics.  Then the
port's own trainer surface: the loss falls, exact resume, the warm start,
and the `python -m dh3d_tpu_torch.train` entry point.

Tolerances (each with its reason at the assertion): losses 1e-5 relative
(f32 sums in another order); gradients 1e-4 of each tensor's largest
magnitude, except the biases that feed a BatchNorm, whose exact gradient
is 0 (both sides give rounding noise, held to 1e-5 of the model's largest
gradient); BN statistics 1e-5 of each tensor's largest magnitude plus
1e-6 (a mean of roughly zero is rounding noise too).
"""

import json
import os
import subprocess
import sys

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dh3d_tpu import config as jcfg
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.nn import init_variables
from dh3d_tpu.train import trainer as jtr
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch.nn import DH3D, load_flax, load_npz, smart_init
from dh3d_tpu_torch.nn.convert import state_dict_from_flax, torch_name
from dh3d_tpu_torch.nn.layers import BatchNorm, bn_fed_biases
from dh3d_tpu_torch.train import (
    apply_gradients,
    forward_loss,
    init_state,
    kernel_l2,
    lr_schedule,
    make_train_step,
    param_labels,
    resolve_model,
    restore_state,
    save_checkpoint,
    synthetic_batches,
    to_device,
)
from dh3d_tpu_torch.train.__main__ import main as train_main
from test_torch_model import flatten_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
N, KP = 256, 8


def small(cfg, name):
    cfg.num_points = N
    if name == "global_config":
        cfg.batch_size, cfg.num_pos, cfg.num_neg = 1, 1, 2
    else:
        cfg.batch_size, cfg.sampled_kpnum = 2, KP
    return cfg


def configs(name):
    return small(jcfg.get_config(name), name), small(tcfg.get_config(name),
                                                     name)


# ------------------------------ schedule, Adam ------------------------------

@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_optax(warmup):
    """Staircase decay after an optional linear warmup; optax evaluates in
    f32, the port in f64: 1e-6 relative."""
    jc, tc = configs("detection_config")
    for c in (jc, tc):
        c.start_lr, c.decay_step, c.decay_rate = 5e-4, 10, 0.5
        c.warmup_steps = warmup
    js, ts = jtr.lr_schedule(jc), lr_schedule(tc)
    for step in list(range(0, 40)) + [99, 100, 101, 250]:
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=0, err_msg=str(step))


def _nested(named):
    """{'a.b.c': x} -> {'a': {'b.c': x}}: the top-level module grouping
    that the JAX freeze labels read."""
    out = {}
    for name, v in named.items():
        top, _, rest = name.partition(".")
        out.setdefault(top, {})[rest] = v
    return out


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adam_steps_match_optax(clip):
    """Three updates on identical gradients, with a frozen group, a
    decaying learning rate and optionally the global-norm clip: the
    parameters within 1e-6 of optax's (Adam's first step moves each by
    about lr)."""
    jc, tc = configs("detection_config")
    for c in (jc, tc):
        c.freezedetection = True
        c.decay_step, c.start_lr, c.grad_clip_norm = 2, 1e-3, clip
    state = init_state(tc, 0)
    names = [n for n, _ in state.model.named_parameters()]
    params = {n: p.detach().numpy().copy()
              for n, p in state.model.named_parameters()}
    tree = _nested(params)
    tx = jtr.make_optimizer(jc, tree)
    opt_state = tx.init(tree)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(0)
    labels = param_labels(tc, state.model)
    for _ in range(3):
        grads = {n: rng.randn(*params[n].shape).astype(np.float32) * 0.01
                 for n in names}
        for n, p in state.model.named_parameters():
            if labels[n] == "trainable":
                p.grad = torch.from_numpy(grads[n].copy())
        apply_gradients(state, tc)
        updates, opt_state = update(_nested(grads), opt_state, tree)
        tree = optax.apply_updates(tree, updates)
    want = {f"{top}.{rest}": v for top, d in tree.items()
            for rest, v in d.items()}
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=0, atol=1e-6, err_msg=n)
        if labels[n] == "frozen":
            np.testing.assert_array_equal(p.detach().numpy(), params[n])


def test_kernel_l2_matches_jax():
    variables = init_variables(jcfg.get_config("detection_config"),
                               jax.random.PRNGKey(0))
    model = DH3D(tcfg.get_config("detection_config"))
    load_flax(model, flatten_variables(variables))
    want = float(jtr.kernel_l2(variables["params"]))
    np.testing.assert_allclose(kernel_l2(model).item(), want, rtol=1e-6)


def test_freeze_labels():
    jc, tc = configs("global_config")
    model = DH3D(tc)
    labels = param_labels(tc, model)
    tree = _nested({n: np.zeros(1) for n in labels})
    jl = jtr.param_labels(jc, tree)
    for n, lab in labels.items():
        top, _, rest = n.partition(".")
        assert jl[top][rest] == lab, n
    assert labels["local_backbone.initconv.conv.theta"] == "frozen"
    assert labels["global_assemble.cluster_weights"] == "trainable"


# ------------------------- BatchNorm, initialisers -------------------------

@pytest.mark.parametrize("momentum", [0.9, 0.999])
def test_batchnorm_train_mode_matches_flax(rng, momentum):
    """Output, gradients and the running update at 1e-5; the batch has a
    large mean (a fast-variance cancellation case)."""
    x = (rng.randn(3, 40, 16) * 2 + 5).astype(np.float32)
    dy = rng.randn(3, 40, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)
    mean0 = rng.randn(16).astype(np.float32)
    var0 = rng.rand(16).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx, p):
        y, upd = bn.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.vdot(y, dy), (y, upd)

    (_, (jy, jupd)), (jgx, jgp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])

    m = BatchNorm(16, momentum=momentum)
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(mean0))
        m.var.copy_(torch.from_numpy(var0))
    m.train()
    tx = torch.from_numpy(x).requires_grad_()
    ty = m(tx)
    ty.backward(torch.from_numpy(dy))
    for got, want in ((ty.detach(), jy), (tx.grad, jgx),
                      (m.scale.grad, jgp["scale"]), (m.bias.grad, jgp["bias"]),
                      (m.mean, jupd["batch_stats"]["mean"]),
                      (m.var, jupd["batch_stats"]["var"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    m.eval()  # running statistics, no update
    before = m.mean.clone()
    m(tx.detach())
    assert torch.equal(m.mean, before)


def test_initialisers_match_flax():
    """Every parameter of the entry model (global head and detection block
    both): the names and shapes of Flax's tree, the constants exactly
    (zero biases, unit BN scales, the detection logit's 1/8), and for each
    random array of 1000 or more values the std within 6% of the Flax
    draw's (he_normal truncated at 2 sigma with its correction,
    glorot_uniform with fan_in = Dp * Din for the flex thetas, the NetVLAD
    and gating normals)."""
    from dh3d_tpu_torch.entry import entry_config

    jc = jcfg.get_config("global_config")
    jc.detection = True
    flat = flatten_variables(init_variables(jc, jax.random.PRNGKey(0)))
    want = state_dict_from_flax(flat)
    torch.manual_seed(0)
    model = DH3D(entry_config())
    own = model.state_dict()
    assert set(own) == set(want)
    for name, t in own.items():
        w = want[name].numpy()
        assert tuple(t.shape) == w.shape, name
        if np.unique(w).size == 1:  # a constant initialiser
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
        elif w.size >= 1000:
            assert abs(t.std().item() / w.std() - 1) < 0.06, name
    assert model.detection_block.detec_conv_fc.bias.item() == 0.125
    assert model.globalatt.detec_conv_fc.bias.item() == 0.0
    w = model.detection_block.detec_conv2.dense.weight  # [1024, 256]
    std = np.sqrt(2 / 256)
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    th = model.local_backbone.stage1.flexconv_1.flexconv.position_theta
    assert th.abs().max().item() <= np.sqrt(6 / (3 * 64 + 64))


# ---------------------------- one step against JAX ----------------------------

def _jax_step(jc, variables, batch):
    (_, (metrics, bs)), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jtr.loss_and_updates(p, s, b, jc, JaxDH3D(jc)),
        has_aux=True))(variables["params"], variables["batch_stats"],
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return metrics, bs, grads


def _compare_step(name, variables, batch):
    jc, tc = configs(name)
    jm, jbs, jg = _jax_step(jc, variables, batch)
    state = init_state(tc, 0)
    load_flax(state.model, flatten_variables(variables))
    state.model.train()
    total, tm, _ = forward_loss(state.model, tc, to_device(batch, "cpu"))
    total.backward()

    for k, v in tm.items():  # every metric, a relative 1e-5 of the total
        scale = max(abs(float(jm["total_cost"])), abs(float(jm[k])))
        assert abs(float(v) - float(jm[k])) <= 1e-5 * scale, k
    params = dict(state.model.named_parameters())
    zero = bn_fed_biases(state.model)
    flat = flatten_variables({"params": jg})
    top = max(np.abs(g).max() for g in flat.values())
    n = 0
    for path, g in flat.items():
        tn, transposed = torch_name(path)
        p = params[tn]
        if not p.requires_grad:  # a frozen group: outside the optimizer
            continue
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        scale = top * 1e-1 if tn in zero else np.abs(g).max()
        assert np.abs(got - g).max() <= 1e-4 * scale, tn
        n += 1
    assert n > 0
    bufs = dict(state.model.named_buffers())
    for path, v in flatten_variables({"batch_stats": jbs}).items():
        tn, _ = torch_name(path)
        err = np.abs(bufs[tn].numpy() - v).max()
        assert err <= 1e-5 * np.abs(v).max() + 1e-6, tn
    return n


def test_detection_step_matches_jax():
    """detection_config at N=256, 8 keypoints, 2 pairs, on JAX
    `init_variables` weights: every gradient of the model.  Seed 1: with
    some other seeds one relu input lands within f32 rounding of 0 and
    falls on the other side in one framework, which moves a Dense
    gradient by ~1e-3 of its scale (f64 agrees with either side)."""
    jc, tc = configs("detection_config")
    batch = next(synthetic_batches(tc, 1))
    variables = init_variables(jc, jax.random.PRNGKey(1))
    assert _compare_step("detection_config", variables, batch) == 58


def test_global_step_matches_jax():
    """global_config (frozen backbone on running statistics, trainable
    global head, lazy quadruplet loss) as the curriculum starts it: the
    local backbone from the trained `models/demo_stage3.npz`, the head
    from `init_variables`; unit-scale clouds (the demo clouds' scale; a
    frozen backbone on raw randn * 20 clouds gives 1e9-scale features).
    Its backward runs kernel E (three_interpolate) only."""
    jc, tc = configs("global_config")
    batch = next(synthetic_batches(tc, 0))
    batch["points"] = batch["points"] / np.float32(20)
    variables = flax.core.unfreeze(init_variables(jc, jax.random.PRNGKey(0)))
    for k, v in load_npz(os.path.join(MODELS, "demo_stage3.npz")).items():
        parts = k.split("/")
        if parts[1:2] == ["local_backbone"]:
            node = variables
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = jnp.asarray(v)
    assert _compare_step("global_config", variables, batch) == 21


# ------------------------------ the trainer itself ------------------------------

def test_loss_falls_over_8_steps():
    _, tc = configs("detection_config")
    tc.start_lr = 1e-3
    state = init_state(tc, 0)
    batch = to_device(next(synthetic_batches(tc, 0)), "cpu")
    step = make_train_step(tc)
    losses = [float(step(state, batch)["total_cost"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert state.step == 8


@pytest.mark.parametrize("name", ["basic_config", "detection_config",
                                  "global_config"])
def test_every_preset_takes_a_step(name):
    _, tc = configs(name)
    state = init_state(tc, 0)
    m = make_train_step(tc)(state, to_device(next(synthetic_batches(tc, 0)),
                                             "cpu"))
    assert np.isfinite(float(m["total_cost"]))


def test_resolve_model_reads_a_flax_checkpoint():
    cfg, model = resolve_model(os.path.join(MODELS, "demo_stage2"))
    flat = load_npz(os.path.join(MODELS, "demo_stage2.npz"))
    assert cfg.detection and not model.training
    np.testing.assert_array_equal(
        model.local_backbone.initconv.conv.theta.detach().numpy(),
        flat["params/local_backbone/initconv/conv/theta"])


def test_frozen_group_unchanged_by_a_step():
    _, tc = configs("global_config")
    state = init_state(tc, 0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    make_train_step(tc)(state, to_device(next(synthetic_batches(tc, 0)),
                                         "cpu"))
    after = state.model.state_dict()
    for k, v in after.items():
        if k.startswith("local_backbone."):  # params and BN statistics
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["global_assemble.cluster_weights"],
                           before["global_assemble.cluster_weights"])
    assert not torch.equal(after["global_assemble.hidden_bn.mean"],
                           before["global_assemble.hidden_bn.mean"])


def test_checkpoint_exact_resume(tmp_path):
    """Save after one step, restore into a fresh state of another seed:
    the next step is bit-identical."""
    _, tc = configs("detection_config")
    batches = synthetic_batches(tc, 0)
    b1, b2 = (to_device(next(batches), "cpu") for _ in range(2))
    step = make_train_step(tc)
    state = init_state(tc, 0)
    step(state, b1)
    path = save_checkpoint(str(tmp_path), state)
    assert path.endswith("step_00000001.pt")
    fresh = restore_state(path, init_state(tc, 5))
    assert fresh.step == 1
    m1, m2 = step(state, b2), step(fresh, b2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_smart_init_partial_load():
    """By name and shape: demo_stage2 fills a detection model (80 arrays
    and the step), fills only the local backbone of a global model, and
    skips an array of another shape, keeping the model's own value."""
    flat = load_npz(os.path.join(MODELS, "demo_stage2.npz"))
    det = DH3D(tcfg.get_config("detection_config"))
    assert smart_init(det, flat) == 80
    np.testing.assert_array_equal(
        det.detection_block.detec_conv1.dense.weight.detach().numpy(),
        flat["params/detection_block/detec_conv1/dense/kernel"].T)
    glob = DH3D(tcfg.get_config("global_config"))
    n_local = sum(k.split("/")[1:2] == ["local_backbone"] for k in flat)
    assert smart_init(glob, flat) == n_local
    bad = dict(flat)
    key = "params/local_backbone/initconv/conv/theta"
    bad[key] = np.zeros((4, 32), np.float32)
    keep = det.local_backbone.initconv.conv.theta.detach().clone()
    assert smart_init(det, bad) == 79
    assert torch.equal(det.local_backbone.initconv.conv.theta, keep)


def test_unported_options_raise():
    from dh3d_tpu_torch.train import check_config

    for key, value in (("device_pairgen", True), ("augment_on_device", True),
                       ("remat", True), ("cross_device_mining", True),
                       ("bn_axis_name", "data"),
                       ("compute_dtype", "bfloat16")):
        cfg = tcfg.get_config("detection_config")
        cfg[key] = value
        with pytest.raises(NotImplementedError):
            check_config(cfg)


def _train_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "dh3d_tpu_torch.train", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_train_entry_point_runs_and_resumes(tmp_path, capsys):
    """`python -m dh3d_tpu_torch.train` on the CPU: metrics.jsonl, a
    checkpoint at the end, the config; then an exact-resume run (in
    process)."""
    logdir = str(tmp_path / "run")
    common = ["--cfg", "detection_config", "--synthetic", "--device", "cpu",
              "--set", "num_points=256", "--set", "sampled_kpnum=8",
              "--batch_size", "1", "--logdir", logdir]
    r = _train_cli(*common, "--steps", "2", "--load",
                   os.path.join(MODELS, "demo_stage2.npz"))
    assert r.returncode == 0, r.stderr
    assert "restored 80 tensors" in r.stdout
    lines = [json.loads(x) for x in open(os.path.join(logdir,
                                                      "metrics.jsonl"))]
    assert [m["step"] for m in lines] == [0, 1]
    assert all(np.isfinite(m["total_cost"]) for m in lines)
    ckpt = os.path.join(logdir, "ckpt", "step_00000002.pt")
    assert os.path.isfile(ckpt)
    assert tcfg.load_config(os.path.join(logdir, "config.json")
                            ).num_points == 256
    train_main(common + ["--steps", "1", "--resume", ckpt])
    assert "resumed at step 2" in capsys.readouterr().out
    last = os.path.join(logdir, "ckpt", "step_00000003.pt")
    assert os.path.isfile(last)
    cfg, model = resolve_model(logdir)  # the newest checkpoint, eval mode
    assert cfg.num_points == 256 and not model.training
    saved = torch.load(last, weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_train_entry_point_refuses_what_it_cannot_do(tmp_path):
    with pytest.raises(NotImplementedError, match="--synthetic"):
        train_main(["--cfg", "detection_config", "--device", "cpu",
                    "--logdir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="device_pairgen"):
        train_main(["--cfg", "detection_config", "--synthetic", "--device",
                    "cpu", "--set", "device_pairgen=true", "--logdir",
                    str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_main(["--cfg", "detection_config", "--synthetic",
                        "--logdir", str(tmp_path)])
