"""The rest of the port's config and op surface against the JAX package, on
the CPU: the `global_before_assemble_conv1d` global backbone, `remat`, the
ops `flex_avg`, `flex_deconv`, the ball queries, `select_top_k`,
`knn_point` and `prob_sample`, the layers `FlexAvg`, `FlexConvTranspose`
and `SEBottleneck`, and the error-budget CLI.

Tolerances, each with its reason at the assertion: indices and counts
exact; f32 sums 1e-5 relative (summation order); the forward and the step
at `test_torch_model.py`'s and `test_torch_train.py`'s.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from dh3d_tpu import config as jcfg
from dh3d_tpu import ops as J
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.nn import init_variables
from dh3d_tpu.nn import layers as jlayers
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.entry import entry_config, entry_points
from dh3d_tpu_torch.eval import make_forward
from dh3d_tpu_torch.nn import DH3D, load_flax
from dh3d_tpu_torch.nn import layers as tlayers
from dh3d_tpu_torch.nn.convert import state_dict_from_flax
from dh3d_tpu_torch.train import (
    check_config,
    forward_loss,
    init_state,
    make_train_step,
    prepare_batch,
    synthetic_batches,
    to_device,
)
from test_torch_model import REPO, _compare, flatten_variables
from test_torch_train import _compare_step, configs

MODELS = os.path.join(REPO, "models")
REL = 1e-5  # f32 sums in another order than the JAX ops


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def level(rng):
    """A small level: features, positions and a kNN neighbourhood (self at
    slot 0)."""
    B, N, K = 2, 64, 8
    pos = rng.randn(B, N, 3).astype(np.float32)
    feat = rng.randn(B, N, 5).astype(np.float32)
    nbh = T.knn_bruteforce(_t(pos), K)[0].numpy()
    return feat, pos, nbh


# ------------------------------ config surface ------------------------------

def test_options_the_port_now_takes():
    """`DH3D`, `check_config` and `make_train_step` take the legacy mode,
    the conv1d global backbone and remat; bf16 and the parallel keys stay
    refused (`test_torch_model.py`, `test_torch_train.py`)."""
    for key, value in (("morton_exact", False), ("remat", True),
                       ("global_backbone", "global_before_assemble_conv1d")):
        cfg = tcfg.get_config("global_config")
        cfg[key] = value
        DH3D(cfg)
        check_config(cfg)
        make_train_step(cfg)
    cfg = entry_config()
    cfg.global_backbone = "netvlad_backbone"
    with pytest.raises(ValueError, match="global_backbone"):
        DH3D(cfg)


def test_conv1d_global_backbone_matches_jax():
    """`global_config` + detection with `global_before_assemble_conv1d`
    (1x1 convs instead of the dilated flex stage, no level sharing), JAX
    `init_variables` weights carried across by name."""
    jc = jcfg.get_config("global_config")
    jc.detection, jc.detection_block = True, "detection_block"
    jc.global_backbone = "global_before_assemble_conv1d"
    jc.gl_dims, jc.concat_xyz = [64, 256], True
    variables = init_variables(jc, jax.random.PRNGKey(3))
    pts = entry_points(2, 512, seed=7) / np.float32(30.0)
    jo = jax.jit(lambda v, p: JaxDH3D(jc).apply(v, p, train=False))(
        variables, jnp.asarray(pts))

    cfg = entry_config()
    cfg.global_backbone = "global_before_assemble_conv1d"
    cfg.gl_dims, cfg.concat_xyz = [64, 256], True
    model = DH3D(cfg)
    flat = flatten_variables(variables)
    assert load_flax(model, flat) == len(flat)
    assert not model.share_level
    _compare(jo, make_forward(cfg, model)(pts))


@pytest.mark.parametrize("name", ["detection_config", "global_config"])
def test_remat_step_equals_the_step_without(name):
    """One step with remat and one without, from the same weights and
    batch: the same losses, gradients and BN statistics bit for bit (the
    recompute repeats the forward's operations; the BatchNorms move their
    statistics once).  global_config with a trainable backbone: the level
    cache (FPS ids, the 3-NN and its `NeighborInverse`) crosses the
    checkpoint to the global stage."""
    _, tc = configs(name)
    tc.freezebackbone = False
    batch = prepare_batch(to_device(next(synthetic_batches(tc, 2)), "cpu"),
                          tc)
    runs = []
    for remat in (False, True):
        cfg = tcfg.dotdict(dict(tc))
        cfg.remat = remat
        state = init_state(cfg, 0, "cpu")
        state.model.train()
        total, metrics, _ = forward_loss(state.model, cfg, batch)
        total.backward()
        runs.append((metrics, state.model))
    (m0, a), (m1, b) = runs
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert (p.grad is None) == (q.grad is None), n
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), n
    for (n, u), (_, v) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(u, v), n


def test_remat_step_matches_jax():
    """The JAX model under `nn.remat` and the port under checkpointing,
    one detection_config step, at `test_torch_train.py`'s tolerances."""
    jc, tc = configs("detection_config")
    batch = next(synthetic_batches(tc, 1))
    variables = init_variables(jc, jax.random.PRNGKey(1))
    assert _compare_step("detection_config", variables, batch,
                         remat=True) == 58


# ---------------------------------- ops ----------------------------------

def test_flex_avg_matches_jax(level):
    feat, _, nbh = level
    got = T.flex_avg(_t(feat), _t(nbh)).numpy()
    _close(got, J.flex_avg(jnp.asarray(feat), jnp.asarray(nbh)))


def test_flex_deconv_and_its_gradients_match_jax(level, rng):
    """Values against `J.flex_deconv` and the reference kernel's oracle;
    the gradients in the features, theta and bias against `jax.grad`."""
    feat, pos, nbh = level
    theta = rng.randn(3, 5, 4).astype(np.float32)
    bias = rng.randn(5, 4).astype(np.float32)
    cot = rng.randn(2, 64, 4).astype(np.float32)
    args = [_t(feat).requires_grad_(), _t(pos), _t(nbh),
            _t(theta).requires_grad_(), _t(bias).requires_grad_()]
    out = T.flex_deconv(*args)
    want = J.flex_deconv(*map(jnp.asarray, (feat, pos, nbh, theta, bias)))
    _close(out.detach().numpy(), want)
    _close(out.detach().numpy(),
           oracles.flex_deconv_oracle(feat, pos, nbh, theta, bias))
    (out * _t(cot)).sum().backward()
    grads = jax.grad(
        lambda f, th, b: jnp.sum(J.flex_deconv(f, jnp.asarray(pos),
                                               jnp.asarray(nbh), th, b)
                                 * cot), argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(theta), jnp.asarray(bias))
    for got, g in zip((args[0], args[3], args[4]), grads):
        _close(got.grad.numpy(), g)


def test_query_ball_point_matches_jax_and_the_reference(rng):
    """Empty balls (the nearest point in every slot), balls with more hits
    than slots and balls with fewer (the first hit repeated).  The ids
    are the JAX function's; the count stops at nsample as the reference's
    (`query_ball_oracle`), where the JAX function counts every hit."""
    xyz1 = rng.rand(2, 96, 3).astype(np.float32)
    xyz2 = np.concatenate([rng.rand(2, 12, 3) * 0.8 + 0.1,  # many hits
                           rng.rand(2, 4, 3) + 3.0],  # none
                          axis=1).astype(np.float32)
    for radius, nsample in ((0.25, 8), (0.18, 3)):
        idx, cnt = T.query_ball_point(radius, nsample, _t(xyz1), _t(xyz2))
        jidx, jcnt = J.query_ball_point(radius, nsample, jnp.asarray(xyz1),
                                        jnp.asarray(xyz2))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(
            cnt.numpy(), np.minimum(np.asarray(jcnt), nsample))
        oidx, ocnt = oracles.query_ball_oracle(radius, nsample, xyz1, xyz2)
        np.testing.assert_array_equal(idx.numpy(), oidx)
        np.testing.assert_array_equal(cnt.numpy(), ocnt)
        c = cnt.numpy()
        assert (c == 0).any() and (c == nsample).any() \
            and ((c > 0) & (c < nsample)).any()


def test_query_ball_point2_matches_jax(rng):
    xyz1 = rng.rand(2, 96, 3).astype(np.float32)
    xyz2 = np.concatenate([rng.rand(2, 12, 3), rng.rand(2, 4, 3) + 3.0],
                          axis=1).astype(np.float32)
    radii = rng.uniform(0.05, 0.4, (2, 16)).astype(np.float32)
    idx, cnt = T.query_ball_point2(8, _t(xyz1), _t(xyz2), _t(radii))
    jidx, jcnt = J.query_ball_point2(8, jnp.asarray(xyz1), jnp.asarray(xyz2),
                                     jnp.asarray(radii))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.minimum(np.asarray(jcnt), 8))
    assert (cnt.numpy() == 0).any() and (idx.numpy()[:, 12:] == 0).all()


def test_select_top_k_matches_jax_with_ties(rng):
    dist = np.round(rng.rand(2, 10, 40), 1).astype(np.float32)  # many ties
    vals, idx = T.select_top_k(6, _t(dist))
    jvals, jidx = J.select_top_k(6, jnp.asarray(dist))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_knn_point_matches_jax(rng):
    """The ids of the JAX function (its matmul-identity d2 differs from
    the direct one by rounding: 1e-4 absolute on unit-scale clouds)."""
    xyz1 = rng.rand(2, 200, 3).astype(np.float32)
    xyz2 = rng.rand(2, 30, 3).astype(np.float32)
    d2, idx = T.knn_point(5, _t(xyz1), _t(xyz2))
    jd2, jidx = J.knn_point(5, jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=0,
                               atol=1e-4)


def test_prob_sample_matches_jax(rng):
    """Integer weights (exact running sums on both sides), uniforms that
    hit the sums exactly (left side: the first index reaching them), the
    total and beyond it (clipped to N - 1)."""
    inp = rng.randint(0, 4, (2, 30)).astype(np.float32)
    cdf = np.cumsum(inp, axis=-1)
    r = np.concatenate([rng.rand(2, 20) * cdf[:, -1:], cdf[:, [3, 10, 29]],
                        cdf[:, -1:] + 1.0], axis=1).astype(np.float32)
    got = T.prob_sample(_t(inp), _t(r))
    want = J.prob_sample(jnp.asarray(inp), jnp.asarray(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------- layers ---------------------------------

def _flax_module(module, *inputs):
    """(Flax variables as the port's state dict, the JAX output)."""
    import flax.linen as fnn

    assert isinstance(module, fnn.Module)
    variables = module.init(jax.random.PRNGKey(4), *inputs)
    out = module.apply(variables, *inputs)
    return state_dict_from_flax(flatten_variables(variables)), out


def test_flex_layers_and_se_bottleneck_match_flax(level, rng):
    feat, pos, nbh = level
    jf, jp, jn = map(jnp.asarray, (feat, pos, nbh))
    _, want = _flax_module(jlayers.FlexAvg(5), jf, jp, jn)
    _close(tlayers.FlexAvg(5)(_t(feat), _t(pos), _t(nbh)).numpy(), want)
    with pytest.raises(ValueError, match="Din == Dout"):
        tlayers.FlexAvg(4)(_t(feat), _t(pos), _t(nbh))

    sd, want = _flax_module(jlayers.FlexConvTranspose(7), jf, jp, jn)
    layer = tlayers.FlexConvTranspose(5, 7)
    layer.load_state_dict(sd)
    _close(layer(_t(feat), _t(pos), _t(nbh)).detach().numpy(), want)

    x = rng.randn(2, 64, 16).astype(np.float32)
    pool = rng.randn(2, 64, 12).astype(np.float32)
    sd, want = _flax_module(jlayers.SEBottleneck(16), jnp.asarray(x),
                            jnp.asarray(pool))
    se = tlayers.SEBottleneck(16, din=12)
    se.load_state_dict(sd)
    _close(se(_t(x), _t(pool)).detach().numpy(), want)


# ------------------------------ error budget ------------------------------

def _budget_pool(d):
    """Two sequences of two scans each, `<seq>/<name>.bin`, with the GT
    pickles the CLI reads."""
    import pickle

    from dh3d_tpu_torch.data.io import write_to_bin
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan

    gts = {}
    for s, seq in enumerate(("seqA", "seqB")):
        os.makedirs(os.path.join(d, seq))
        gts[seq] = []
        for i in range(2):
            write_to_bin(lidar_like_scan(2 * s + i, n_points=1200, extent=6.0),
                         os.path.join(d, seq, f"s{i}.bin"))
            gts[seq].append({"query": f"{seq}/s{i}", "northing": 10.0 * i,
                             "easting": 0.0})
    for name in ("global_ref_demo.pickle", "global_query_demo.pickle"):
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(gts, f)


def test_error_budget_cli_runs_on_cpu_without_jax(tmp_path):
    """`python -m dh3d_tpu_torch.evaluate.error_budget --device cpu` at
    N=1024 on 4 scans, in a fresh interpreter where importing jax,
    sklearn or dh3d_tpu fails: the four sections, every value finite, the
    band's agreement in (0, 1]."""
    import json

    pcd = str(tmp_path / "pcd")
    _budget_pool(pcd)
    out = str(tmp_path / "budget.json")
    argv = ["--local_model", os.path.join(MODELS, "demo_stage2"),
            "--global_model", os.path.join(MODELS, "demo_stage3"),
            "--pcdpath", pcd, "--num_points", "1024", "--device", "cpu",
            "--json", out, "--md", str(tmp_path / "budget.md")]
    code = (
        "import sys\n"
        "for m in ('sklearn', 'jax', 'dh3d_tpu'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        "from dh3d_tpu_torch.evaluate import error_budget\n"
        f"error_budget.main({argv!r})\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        report = json.load(f)
    assert {"A_knn", "B_local", "BC_global", "C_repeatability"} <= set(report)
    assert report["n_clouds"] == 4 and report["backend"] == "cpu"

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) else []

    assert all(np.isfinite(numbers(report)))
    assert 0 < report["A_knn"]["neighbor_agreement_mean"] <= 1
    assert set(report["B_local"]) == {"morton", "approx", "approx_vs_morton"}
    assert report["BC_global"]["n_queries"] == 4
    assert (tmp_path / "budget.md").stat().st_size > 0
