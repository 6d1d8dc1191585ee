"""The PyTorch port's bf16 compute_dtype against the JAX package's, on the CPU.

The JAX function is `compute_dtype="bfloat16"` on the gather path (the one
the JAX package takes on the CPU).  Its rounding points, which the port
copies: `FlexConv` casts the features and its position weights to bf16; the
moments (`_flex_moments`) take delta = pos[nk] - pos[n0] in f32 rounded to
bf16, m0 = an f32 sum of the bf16 features rounded to bf16, m1 = f32 sums of
exact bf16 products, an f32 output, an f32 product with the weights; a
`Dense(dtype=bf16)` rounds its product to bf16 and then adds its bias in
bf16; a BatchNorm takes a bf16 input up to f32.

The JAX programs are compiled with XLA's `xla_allow_excess_precision` off
(`_compiled`).  With it on (the default), XLA's CPU compiler fuses a Dense's
bias add into the BatchNorm that follows it and drops the bf16 rounding
between them, so the jitted JAX forward computes another function than the
one its modules write; off, the jitted programs give the eager (op by op)
results, which is what the port follows.

Tolerances, each with its reason at the assertion.  Single ops and layers
on the same inputs are tight: m0 bit for bit, everything else f32 rounding
or, where a bf16 rounding of an f32 value that differs in its last bits can
land one bf16 step apart (at most 2^-7 relative), that step.  The whole forward and
the train step are not: the f32 parts of the two frameworks differ in
summation order (~1e-6 relative, e.g. initconv on raw xyz), which flips a
few bf16 roundings in the first bf16 layer; each flip is a bf16 step of
one value, and the steps spread and flip more roundings layer by
layer.  Those limits are measured, with headroom, and stated in PERF.md §2;
the check that the port did not run f32 is that it lands closer to the JAX
bf16 function than the JAX f32 function does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import config as jcfg
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.nn import init_variables
from dh3d_tpu.nn import layers as jl
from dh3d_tpu.ops.flex import _flex_moments
from dh3d_tpu.train import trainer as jtr
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.entry import entry_config, entry_points
from dh3d_tpu_torch.eval import make_forward
from dh3d_tpu_torch.nn import DH3D, load_flax
from dh3d_tpu_torch.nn import layers as tl
from dh3d_tpu_torch.nn.convert import state_dict_from_flax, torch_name
from dh3d_tpu_torch.nn.layers import bn_fed_biases
from dh3d_tpu_torch.train import (check_config, forward_loss, init_state,
                                  prepare_batch, synthetic_batches,
                                  to_device)
from test_torch_model import flatten_variables
from test_torch_train import configs

BF16 = torch.bfloat16
# one bf16 step, relative: 8 significant bits put the spacing at x between
# 2^-8 |x| and 2^-7 |x|; a rounding errs by at most half a step
ULP = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _compiled(fn, *args):
    """`fn` jitted with XLA's excess precision off: every bf16 rounding the
    program writes is kept (the module docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _moment_inputs(rng, C, B=2, N=256, K=8):
    f = (rng.randn(B, N, C) * 2).astype(np.float32)
    f = _np(jnp.asarray(f).astype(jnp.bfloat16))  # exact bf16 values
    pos = (rng.randn(B, N, 3) * 10).astype(np.float32)
    nbh = rng.randint(0, N, (B, N, K))
    nbh[:, :, 0] = np.arange(N)
    return f, pos, nbh


# ------------------------------ the moments ------------------------------

@pytest.mark.parametrize("C", [32, 64])
def test_flex_moments_bf16_matches_jax(rng, C):
    """[2, 256], K=8: m0 bit for bit (the f32 sum of 8 bf16 values is exact
    here, whatever the order, so both sides round the same value); m1
    within f32 rounding (sums of exact products in another order); the
    output f32."""
    f, pos, nbh = _moment_inputs(rng, C)
    want = _np(_flex_moments(jnp.asarray(f, jnp.bfloat16), jnp.asarray(pos),
                             jnp.asarray(nbh, jnp.int32)))
    got = T.flex_moments(_t(f).to(BF16), _t(pos), _t(nbh))
    assert got.dtype == torch.float32
    got = got.numpy().reshape(2, 256, 4, C)
    want = want.reshape(2, 256, 4, C)
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    m1 = want[:, :, 1:]
    assert np.abs(got[:, :, 1:] - m1).max() <= 1e-6 * np.abs(m1).max()
    # and not the f32 moments: the deltas and m0 are rounded
    f32 = T.flex_moments(_t(f), _t(pos), _t(nbh)).numpy().reshape(got.shape)
    assert (f32 != got).mean() > 0.5


@pytest.mark.parametrize("C", [32, 64])
def test_flex_moments_bf16_backward_matches_jax_vjp(rng, C):
    """The feature gradient against `jax.vjp` of `_flex_moments`, bf16.
    JAX rounds the cotangent to bf16 where its terms meet and at every add
    of its scatter (up to ~20 adds a row here); the port sums in f32 and
    rounds once.  So each element is held to (adds + 3) bf16 steps of the
    sum of its terms' magnitudes, and the port's own result to one bf16
    rounding of the exact (f64) sum."""
    f, pos, nbh = _moment_inputs(rng, C)
    B, N, K = nbh.shape
    dm = rng.randn(B, N, 4 * C).astype(np.float32)
    _, vjp = jax.vjp(lambda x: _flex_moments(x, jnp.asarray(pos),
                                             jnp.asarray(nbh, jnp.int32)),
                     jnp.asarray(f, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(dm))
    assert want.dtype == jnp.bfloat16
    x = _t(f).to(BF16).requires_grad_()
    T.flex_moments(x, _t(pos), _t(nbh)).backward(_t(dm))
    assert x.grad.dtype == BF16
    got = x.grad.float().numpy()
    # the terms: [bf16(dm0) + sum_p bf16(delta_p) dm_p] for each entry
    p_k = pos[np.arange(B)[:, None, None], nbh]
    delta = _np(jnp.asarray(p_k - p_k[:, :, :1]).astype(jnp.bfloat16))
    d = dm.reshape(B, N, 4, C).astype(np.float64)
    d[:, :, 0] = _np(jnp.asarray(dm.reshape(B, N, 4, C)[:, :, 0]).astype(
        jnp.bfloat16))
    terms = d[:, :, None, 0] + np.einsum("bnkp,bnpc->bnkc", delta, d[:, :, 1:])
    exact, mag = np.zeros((B, N, C)), np.zeros((B, N, C))
    count = np.zeros((B, N))
    for b in range(B):
        np.add.at(exact[b], nbh[b].ravel(), terms[b].reshape(-1, C))
        np.add.at(mag[b], nbh[b].ravel(), np.abs(terms[b]).reshape(-1, C))
        np.add.at(count[b], nbh[b].ravel(), 1)
    assert (np.abs(got - exact) <= ULP / 2 * np.abs(exact) + 1e-30).all()
    err = np.abs(got - _np(want))
    import sys
    print("BWD", (err / (ULP * mag)).max(), (err / (ULP * mag) / count[..., None]).max(), file=sys.stderr)
    assert (err <= (count[..., None] + 3) * ULP * mag).all(), err.max()


def test_flex_moments_refuses_other_dtypes(rng):
    """float16 and float64 features are refused before any kernel or plain
    version sees them; so is a float16 gradient dtype."""
    f, pos, nbh = _moment_inputs(rng, 32)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            T.flex_moments(_t(f).to(dt), _t(pos), _t(nbh))
    dm = torch.zeros(2, 256, 4 * 32)
    with pytest.raises(ValueError, match="dtype"):
        T.flex_moments_backward(dm, _t(pos), _t(nbh), dtype=torch.float16)


def test_model_and_trainer_refuse_float16():
    """compute_dtype float16 (the JAX package would run it) is refused by
    the model and by the trainer's config check; bfloat16 and float32 are
    taken."""
    for refuse in (lambda c: DH3D(c), check_config):
        cfg = entry_config()
        cfg.compute_dtype = "float16"
        with pytest.raises(NotImplementedError, match="compute_dtype"):
            refuse(cfg)
    for name in ("float32", "bfloat16"):
        cfg = entry_config()
        cfg.compute_dtype = name
        check_config(cfg)
        DH3D(cfg)


# ------------------------------ single layers ------------------------------

def _load(module, variables):
    module.load_state_dict(state_dict_from_flax(flatten_variables(
        jax.tree_util.tree_map(np.asarray, variables))))


def _perturbed(variables, rng):
    """Nonzero biases and BN parameters and statistics, so that every term
    of the layer is exercised (the initialisers' are zeros and ones)."""
    def move(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return a + rng.rand(*a.shape).astype(np.float32) + 0.5
        return a + (0.3 * rng.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, variables)


def _layer_case(jmod, tmod, inputs, rng, train):
    """Run the Flax module (bf16, excess precision off) and the port's on
    the same inputs and weights; in train mode also the backward of a
    random cotangent.  Returns (jax (out, grads or None, stats), port's)."""
    j_in = [jnp.asarray(a, jnp.int32 if a.dtype == np.int64 else None)
            for a in inputs]
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), *j_in), rng)
    _load(tmod, variables)
    tmod.train(train)
    x = _t(inputs[0]).requires_grad_(train)
    out = tmod(x, *map(_t, inputs[1:]))
    assert out.dtype == torch.float32
    dy = rng.randn(*out.shape).astype(np.float32)
    if not train:
        jo = _compiled(lambda v, *a: jmod.apply(v, *a), variables, *j_in)
        return (_np(jo), None, None), (out.detach().numpy(), None, None)

    def loss(params, x):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, x,
                            *j_in[1:], mutable=["batch_stats"])
        return jnp.vdot(y, jnp.asarray(dy)), (y, upd)

    (_, (jy, upd)), (gp, gx) = _compiled(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        variables["params"], j_in[0])
    out.backward(_t(dy))
    grads = {"x": x.grad.numpy()}
    for path, g in flatten_variables({"params": gp}).items():
        name, tr = torch_name(path)
        grads[name] = (g.T if tr else g,
                       tmod.get_parameter(name).grad.numpy())
    stats = {torch_name(p)[0]: (v, tmod.get_buffer(torch_name(p)[0]).numpy())
             for p, v in flatten_variables({"batch_stats": upd[
                 "batch_stats"]}).items()}
    return (_np(jy), _np(gx), stats), (out.detach().numpy(), grads, stats)


def _held(got, want, steps, scale):
    """Each element within `steps` bf16 steps of its own magnitude plus f32
    rounding of the tensor's scale."""
    err = np.abs(got - want)
    assert (err <= steps * ULP * np.abs(want) + 1e-5 * scale).all(), \
        (err.max(), scale)


def _near(got, want, steps, scale):
    """Within `steps` bf16 steps of `scale`: for a value that is a sum of
    larger terms rounded to bf16 on the way (a cancellation), whose error
    follows the terms' magnitude, not its own."""
    err = np.abs(got - want).max()
    assert err <= steps * ULP * scale, (err, scale)


def _held_grads(grads, bn_fed, products=()):
    """The parameter gradients: each within one bf16 step of its own
    magnitude (the cast of its parameter to bf16 rounds it, on both
    sides); a bias that feeds a BatchNorm on batch statistics, whose exact
    gradient is 0 and whose computed one is the rounding noise of a bf16
    sum, within one bf16 step of the largest gradient; `products`, the
    gradients that are products with a bf16 cotangent JAX rounds on the
    way (see the callers), within 2 bf16 steps of their largest
    magnitude."""
    top = max(np.abs(w).max() for k, (w, _) in grads.items() if k != "x")
    for name, (want, got) in grads.items():
        if name == "x":
            continue
        if name in bn_fed:
            _near(got, want, 1, top)
        elif name in products:
            _near(got, want, 2, np.abs(want).max())
        else:
            _held(got, want, 1, np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_flex_conv_bn_bf16_matches_flax(rng, train):
    """FlexConvBN(dtype=bf16) against the Flax module at [2, 256], 32 -> 64
    channels, K=8.  Eval: f32 rounding (the moments as above, the product
    in f32).  Train (BN on batch statistics): the output and the running
    statistics within f32 rounding, the parameter gradients as
    `_held_grads`; the input gradient within 4 bf16 steps of its largest
    magnitude: JAX rounds it to bf16 at every add of its scatter (~8 adds
    a row, each term up to that magnitude), the port once (measured: 1.2
    steps)."""
    f, pos, nbh = _moment_inputs(rng, 32)
    jmod = jl.FlexConvBN(64, use_running_average=not train,
                         dtype=jnp.bfloat16)
    tmod = tl.FlexConvBN(32, 64, dtype=BF16)
    (jy, jgx, jstats), (ty, tgrads, _) = _layer_case(
        jmod, tmod, (f, pos, nbh), rng, train)
    _held(ty, jy, 0, np.abs(jy).max())
    if not train:
        return
    _held_grads(tgrads, {"flexconv.feature_bias"})
    _near(tgrads["x"], jgx, 4, np.abs(jgx).max())
    for name, (want, got) in jstats.items():
        _held(got, want, 0, np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_conv1x1_bf16_matches_flax(rng, train):
    """Conv1x1(dtype=bf16) (Dense -> BN -> relu) against the Flax module at
    [2, 300], 64 -> 128: the Dense's two roundings copied, so eval agrees to
    f32 rounding but where an f32 product that differs in its last bits
    rounds to the neighbouring bf16 (one step, through BN); train the same
    for the output and statistics, the parameter gradients as
    `_held_grads`; the input gradient and the kernel's within 2 bf16 steps
    of their largest magnitude: they are products with the Dense output's
    bf16 cotangent, which JAX rounds for each use of that output in the
    BatchNorm before it sums them (`test_batchnorm_on_bf16_matches_flax`)."""
    x = (rng.randn(2, 300, 64) * 2).astype(np.float32)
    jmod = jl.Conv1x1(128, use_running_average=not train, dtype=jnp.bfloat16)
    tmod = tl.Conv1x1(64, 128, dtype=BF16)
    (jy, jgx, jstats), (ty, tgrads, _) = _layer_case(jmod, tmod, (x,), rng,
                                                     train)
    _held(ty, jy, 1, np.abs(jy).max())
    if not train:
        return
    _held_grads(tgrads, {"dense.bias"}, {"dense.weight"})
    _near(tgrads["x"], jgx, 2, np.abs(jgx).max())
    for name, (want, got) in jstats.items():
        _held(got, want, 1, np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_on_bf16_matches_flax(rng, train):
    """BatchNorm on a bf16 input returns f32 with f32 statistics, as Flax's:
    f32 rounding.  The input gradient is bf16 on both sides; JAX rounds the
    cotangent of each use of the input (the mean, the variance, the
    normalisation) to bf16 and sums the three in bf16, where the port
    upcasts once and rounds the sum once: the three terms nearly cancel,
    so the difference follows their magnitude, held to 2 bf16 steps of
    the gradient's largest magnitude (measured: 0.8)."""
    x = (rng.randn(3, 40, 16) * 2 + 5).astype(np.float32)
    x = _np(jnp.asarray(x).astype(jnp.bfloat16))
    jmod = jl.BatchNorm(use_running_average=not train)
    tmod = tl.BatchNorm(16)
    j_in = jnp.asarray(x, jnp.bfloat16)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), j_in), rng)
    _load(tmod, variables)
    tmod.train(train)
    tx = _t(x).to(BF16).requires_grad_(train)
    ty = tmod(tx)
    assert ty.dtype == torch.float32
    dy = rng.randn(*ty.shape).astype(np.float32)

    def loss(params, xx):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xx,
                            mutable=["batch_stats"])
        return jnp.vdot(y, jnp.asarray(dy)), (y, upd)

    (_, (jy, upd)), (gp, gx) = _compiled(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        variables["params"], j_in)
    assert jy.dtype == jnp.float32
    if not train:  # running statistics, which the update leaves alone
        _held(ty.detach().numpy(), _np(jy), 0, np.abs(_np(jy)).max())
        return
    _held(ty.detach().numpy(), _np(jy), 0, np.abs(_np(jy)).max())
    ty.backward(_t(dy))
    assert tx.grad.dtype == BF16
    _near(tx.grad.float().numpy(), _np(gx), 2, np.abs(_np(gx)).max())
    for name in ("scale", "bias"):
        want = np.asarray(gp["bn"][name])
        _held(tmod.get_parameter(name).grad.numpy(), want, 0,
              np.abs(want).max())
    for name in ("mean", "var"):
        want = np.asarray(upd["batch_stats"]["bn"][name])
        _held(tmod.get_buffer(name).numpy(), want, 0, np.abs(want).max())


# ------------------------- the forward, the train step -------------------------

# The whole forward at [2, 512] (`global_config` + detection, JAX
# `init_variables` weights, the clouds of `test_torch_model`): the largest
# difference from the JAX bf16 function a unit-scale output may show, and
# the root mean square.  Measured on three seeds of clouds (the worst:
# local_desc 2.3e-3 / 1.4e-4, attention 1.7e-2 / 1.3e-3, global_desc
# 1.1e-4 / 2.3e-5); the limits about twice that.  What sets them: f32
# summation order flips a few bf16 roundings, which spread (the module
# docstring); one seed of the three showed none of it (local_desc rms
# 8.8e-6).  `feat` is unnormalised and held to a share of its scale.
FORWARD_LIMITS = {"local_desc": (5e-3, 3e-4), "attention": (4e-2, 3e-3),
                  "global_desc": (3e-4, 5e-5), "xyz_feat_att": (4e-2, 3e-3)}
FEAT_LIMITS = (1e-2, 1e-4)  # max and rms, of feat's largest magnitude
# ... and the JAX f32 function is further from the JAX bf16 one than the
# port's bf16 forward: by rms, at least twice (measured: 4x and more)
CLOSER = 2.0


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def test_forward_bf16_matches_jax():
    """`global_config` + detection at [2, 512] in bf16 against the JAX
    package's bf16 forward: indices equal (geometry stays f32), float
    outputs within `FORWARD_LIMITS`, all f32; and closer to the JAX bf16
    forward than the JAX f32 forward is, which a port that ran f32 would
    not be."""
    jc = jcfg.get_config("global_config")
    jc.detection = True
    jc.detection_block = "detection_block"
    variables = init_variables(jc, jax.random.PRNGKey(0))
    pts = entry_points(2, 512, seed=1) / np.float32(30.0)
    jax_outs = {}
    for name in ("float32", "bfloat16"):
        jc.compute_dtype = name
        jax_outs[name] = _compiled(
            lambda v, p: JaxDH3D(jc).apply(v, p, train=False), variables,
            jnp.asarray(pts))
    cfg = entry_config()
    cfg.compute_dtype = "bfloat16"
    model = DH3D(cfg)
    load_flax(model, flatten_variables(variables))
    outs = make_forward(cfg, model)(pts)
    jb, jf = jax_outs["bfloat16"], jax_outs["float32"]
    for key in ("xyz", "knn_indices"):
        np.testing.assert_array_equal(outs[key].numpy(), np.asarray(jb[key]))
    for key, t in outs.items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, key
    for key, (top, rms) in {**FORWARD_LIMITS,
                            "feat": FEAT_LIMITS}.items():
        want = np.asarray(jb[key])
        err = outs[key].numpy() - want
        scale = np.abs(want).max() if key == "feat" else 1.0
        assert np.abs(err).max() <= top * scale, (key, np.abs(err).max())
        assert _rms(err) <= rms * scale, (key, _rms(err))
    for key in ("local_desc", "global_desc"):
        want = np.asarray(jb[key])
        assert (CLOSER * _rms(outs[key].numpy() - want)
                <= _rms(np.asarray(jf[key]) - want)), key


def _jax_step(jc, variables, batch):
    fn = jax.value_and_grad(
        lambda p, s, b: jtr.loss_and_updates(p, s, b, jc, JaxDH3D(jc)),
        has_aux=True)
    (_, (metrics, bs)), grads = _compiled(
        fn, variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    return metrics, bs, grads


def _port_grads(tc, variables, batch):
    state = init_state(tc, 0, "cpu")
    load_flax(state.model, flatten_variables(variables))
    state.model.train()
    total, metrics, _ = forward_loss(state.model, tc,
                                     prepare_batch(to_device(batch, "cpu"),
                                                   tc))
    total.backward()
    return state, metrics


def test_detection_step_bf16_matches_jax():
    """One `detection_config` step in bf16 (N=256, 8 keypoints, 2 pairs,
    JAX `init_variables` weights) against the JAX package's.

    Losses within 5e-4 of the total (measured 6e-5: the forward's flips).
    BN running statistics within 2e-3 of each tensor's largest magnitude
    (measured 5e-4).  The gradients: the detection block's are chaotic in
    bf16 at this size.  Its BatchNorms see a cotangent that is nonzero on
    the 8 keypoints alone, so their input gradient is a difference of
    nearly equal terms, and a bf16 step in the forward moves it by tens of
    percent.  The port against itself on clouds scaled by 1 + 1e-6 moves
    the whole gradient by 3% (relative L2) and single detection tensors by
    up to 40% of their scale, and the JAX function does the same.  So the
    gradient is held as a whole: relative L2 error within 3% (measured
    0.9%), each tensor's within 30% (measured 13%); the biases that feed a
    BatchNorm (exact gradient 0, rounding noise) within 5% of the largest
    gradient (measured 2.4%)."""
    jc, tc = configs("detection_config")
    for c in (jc, tc):
        c.compute_dtype = "bfloat16"
    batch = next(synthetic_batches(tc, 1))
    variables = init_variables(jc, jax.random.PRNGKey(1))
    jm, jbs, jg = _jax_step(jc, variables, batch)
    state, tm = _port_grads(tc, variables, batch)
    for k, v in tm.items():
        scale = max(abs(float(jm["total_cost"])), abs(float(jm[k])))
        assert abs(float(v) - float(jm[k])) <= 5e-4 * scale, k
    params = dict(state.model.named_parameters())
    zero = bn_fed_biases(state.model)
    flat = flatten_variables({"params": jg})
    top = max(np.abs(g).max() for g in flat.values())
    got_all, want_all = [], []
    for path, want in flat.items():
        name, transposed = torch_name(path)
        got = params[name].grad.numpy()
        got = got.T if transposed else got
        if name in zero:
            assert np.abs(got - want).max() <= 5e-2 * top, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 0.3, (name, rel)
        got_all.append(got.ravel())
        want_all.append(want.ravel())
    got_all, want_all = np.concatenate(got_all), np.concatenate(want_all)
    assert (np.linalg.norm(got_all - want_all)
            <= 3e-2 * np.linalg.norm(want_all))
    bufs = dict(state.model.named_buffers())
    for path, want in flatten_variables({"batch_stats": jbs}).items():
        name, _ = torch_name(path)
        err = np.abs(bufs[name].numpy() - want).max()
        assert err <= 2e-3 * np.abs(want).max(), name


def test_remat_and_legacy_run_bf16():
    """bf16 with `remat`: one detection_config step gives the gradients and
    BN statistics of the step without it, bit for bit (the recompute
    repeats every bf16 rounding).  bf16 in the legacy mode
    (morton_exact=False): the forward at [1, 1024] (the windowed kNN at
    full resolution) runs, with finite f32 outputs and the f32 forward's
    neighbours; its descriptors differ from the f32 forward's, by no more
    than bf16 rounding moves them (the JAX bf16 and f32 forwards differ by
    5e-3 in `test_forward_bf16_matches_jax`; held to 2e-2)."""
    _, tc = configs("detection_config")
    tc.compute_dtype = "bfloat16"
    batch = next(synthetic_batches(tc, 0))
    runs = []
    for remat in (False, True):
        tc.remat = remat
        torch.manual_seed(0)
        state = init_state(tc, 0, "cpu")
        state.model.train()
        total, _, _ = forward_loss(state.model, tc,
                                   prepare_batch(to_device(batch, "cpu"), tc))
        total.backward()
        runs.append((total.item(),
                     {n: p.grad for n, p in state.model.named_parameters()},
                     {n: b.clone() for n, b in state.model.named_buffers()}))
    (t0, g0, b0), (t1, g1, b1) = runs
    assert t0 == t1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n

    pts = entry_points(1, 1024, seed=2) / np.float32(30.0)
    outs = []
    for name in ("float32", "bfloat16"):
        cfg = entry_config()
        cfg.compute_dtype = name
        cfg.morton_exact = False
        torch.manual_seed(0)
        outs.append(make_forward(cfg, DH3D(cfg))(pts))
    f32, bf16 = outs
    np.testing.assert_array_equal(bf16["knn_indices"], f32["knn_indices"])
    for key, t in bf16.items():
        if t.is_floating_point():
            assert t.dtype == torch.float32 and torch.isfinite(t).all(), key
    for key in ("local_desc", "global_desc"):
        err = (bf16[key] - f32[key]).abs().max().item()
        assert 0 < err <= 2e-2, (key, err)
