"""The forward neighbourhood ops of the PyTorch port after their row-group
redesign, on the CPU: `flex_moments` (kernel C with the weights built from
the positions), the launch plan `row_plan` of kernels C and D, D's NaN rule
and its optional id output.

On the CPU the ops run their plain versions, so what is held here is the
contract the CUDA kernels are held to on the card
(`tests/test_torch_cuda.py`): `flex_moments` is `weighted_sum` on
`flex_weights` bit for bit; the lane layout of a plan covers every channel
once and, modelled in numpy, gives the plain versions' results; a NaN among
the neighbours wins as in `torch.argmax` and `jnp.argmax`.  The same numpy
inputs go through the JAX package: its gather forms, and its Pallas
moments kernels in interpret mode.  Tolerances at each assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import ops as J
from dh3d_tpu.ops.flex import _flex_moments
from dh3d_tpu.ops.pallas.banded_pallas import (
    flex_moments_banded_fast,
    flex_moments_banded_planned,
    oob_plan,
)
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.ops import neighborhood

B, N, K, C = 2, 512, 8, 32
TILE, WIN, WE = 128, 256, 512
REL = 1e-5  # f32 sums in another order than the JAX gather form


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def _close(a, ref, rel=REL):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = np.abs(a - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture
def cloud(rng):
    return rng.randn(B, N, 3).astype(np.float32)


@pytest.fixture
def knn8(cloud):
    idx, _ = T.knn_bruteforce(_t(cloud), K)
    return idx.numpy()


@pytest.fixture
def banded_nbh(rng):
    """A Morton-like band plus 15% far ids, as tests/test_pallas.py."""
    off = (rng.randn(B, N, K) * 40).astype(np.int64)
    nbh = np.clip(np.arange(N)[None, :, None] + off, 0, N - 1)
    far = rng.rand(B, N, K) < 0.15
    return np.where(far, rng.randint(0, N, nbh.shape), nbh)


# ------------------------------ flex_moments ------------------------------

@pytest.mark.parametrize("dp,rows,keys,k", [(3, N, N, K), (3, 100, 40, 5),
                                            (2, 64, 64, 3), (1, 33, 70, 1)])
def test_flex_moments_is_weighted_sum_on_flex_weights(rng, dp, rows, keys, k):
    """Bit for bit, at Dp = 1, 2, 3 and with other rows than keys: forward,
    and the backward against `weighted_sum`'s with explicit weights."""
    feat = rng.randn(B, keys, 12).astype(np.float32)
    pos = (rng.randn(B, keys, dp) * 30).astype(np.float32)
    nbh = _t(rng.randint(0, keys, (B, rows, k)))
    dm = _t(rng.randn(B, rows, (1 + dp) * 12).astype(np.float32))
    w = T.flex_weights(_t(pos), nbh)
    assert w.shape == (B, rows, k, 1 + dp) and bool((w[..., 0] == 1).all())
    f1, f2 = _t(feat).requires_grad_(), _t(feat).requires_grad_()
    got = T.flex_moments(f1, _t(pos), nbh)
    want = T.weighted_sum(f2, nbh, w)
    assert torch.equal(got, want)
    assert torch.equal(got, T.flex_moments_plain(_t(feat), _t(pos), nbh))
    got.backward(dm)
    want.backward(dm)
    assert torch.equal(f1.grad, f2.grad)
    assert torch.equal(T.flex_moments_backward(dm, _t(pos), nbh), f2.grad)
    assert type(got.grad_fn).__name__ == "FlexMomentsBackward"


def test_flex_moments_match_jax_gather_form(rng, cloud, knn8):
    """Against `_flex_moments`, the JAX CPU gather form behind
    `J.flex_conv`: 1e-5 of the largest moment (f32 sums in another order);
    and the whole op against `J.flex_conv`."""
    feat = rng.randn(B, N, C).astype(np.float32)
    nbh32 = knn8.astype(np.int32)
    ref = _flex_moments(_j(feat), _j(cloud), _j(nbh32))
    _close(T.flex_moments(_t(feat), _t(cloud), _t(knn8)).numpy(), ref)
    theta = (rng.randn(3, C, 24) * 0.1).astype(np.float32)
    bias = (rng.randn(C, 24) * 0.1).astype(np.float32)
    _close(T.flex_conv(_t(feat), _t(cloud), _t(knn8), _t(theta),
                       _t(bias)).numpy(),
           J.flex_conv(_j(feat), _j(cloud), _j(nbh32), _j(theta), _j(bias)))


def test_flex_moments_match_pallas_fast_kernel(rng, cloud, knn8):
    """`flex_moments_banded_fast` in interpret mode, the TPU kernel behind
    every flex_conv of the main path.  It rounds the features to bf16 and
    carries the position-scaled counts in bf16 planes: each moment plane
    within 4e-3 of its largest magnitude, as tests/test_torch_ops.py holds
    `weighted_sum` on explicit weights."""
    feat = rng.randn(B, N, 64).astype(np.float32)
    pos0 = np.take_along_axis(cloud, knn8[..., :1], axis=1)
    ref = np.asarray(flex_moments_banded_fast(
        _j(feat), _j(cloud), _j(pos0), _j(knn8.astype(np.int32)), 256, N,
        True)).reshape(B, N, 4, 64)
    got = T.flex_moments(_t(feat), _t(cloud), _t(knn8)).numpy()
    got = got.reshape(B, N, 4, 64)
    for p in range(4):
        _close(got[:, :, p], ref[:, :, p], rel=4e-3)


def test_flex_moments_match_planned_pallas_kernels(rng, banded_nbh):
    """`flex_moments_banded_planned(fast=False)` in interpret mode:
    `_moments_fwd_kernel` and `_moments_bwd_kernel` with the out-of-band
    delivery, at tests/test_pallas.py's budget for them (bf16 planes):
    forward error under 3e-2 of the mean moment magnitude, VJP error under
    5e-3 of the mean gradient magnitude."""
    cpad = 128  # the kernel's lane-padded channel count
    plan = jax.jit(lambda n: oob_plan(n, N, TILE, WIN, cap=1024, we=WE))(
        _j(banded_nbh.astype(np.int32)))
    assert int(np.asarray(plan.overflow).max()) == 0
    feat = rng.randn(B, N, C).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 0.5 + 10.0).astype(np.float32)
    pos0 = np.take_along_axis(pos, banded_nbh[:, :, :1], axis=1)
    nbh32 = _j(banded_nbh.astype(np.int32))

    def planned(x):
        return flex_moments_banded_planned(x, _j(pos), _j(pos0), nbh32, plan,
                                           TILE, WIN, WE, False, True)

    out = np.asarray(jax.jit(planned)(_j(feat))).reshape(B, N, 4, cpad)
    f = _t(feat).requires_grad_()
    got = T.flex_moments(f, _t(pos), _t(banded_nbh))
    planes = got.detach().numpy().reshape(B, N, 4, C)
    assert np.abs(out[..., :C] - planes).max() / np.abs(planes).mean() < 3e-2

    dm = rng.randn(B, N, 4, C).astype(np.float32)
    dpad = np.zeros((B, N, 4, cpad), np.float32)
    dpad[..., :C] = dm
    gref = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.vdot(planned(x), _j(dpad.reshape(B, N, -1)))))(
            _j(feat)))
    got.backward(_t(dm.reshape(B, N, -1)))
    grad = f.grad.numpy()
    assert np.abs(grad - gref).max() / np.abs(grad).mean() < 5e-3


def test_flex_moments_backward_matches_jax_vjp(rng, cloud, knn8):
    """The transpose (kernel E on positions) against jax.grad of the JAX
    CPU gather form, 1e-5 of the largest gradient."""
    feat = rng.randn(B, N, C).astype(np.float32)
    dm = rng.randn(B, N, 4 * C).astype(np.float32)
    want = jax.grad(lambda f: jnp.vdot(
        _flex_moments(f, _j(cloud), _j(knn8.astype(np.int32))), _j(dm)))(
            _j(feat))
    f = _t(feat).requires_grad_()
    T.flex_moments(f, _t(cloud), _t(knn8)).backward(_t(dm))
    _close(f.grad.numpy(), want)
    _close(T.flex_moments_backward(_t(dm), _t(cloud), _t(knn8)).numpy(), want)


def test_flex_moments_checks_its_inputs(cloud, knn8):
    x, nbh = _t(cloud), _t(knn8)
    with pytest.raises(ValueError, match="shape"):
        T.flex_moments(x, x[:, :100].contiguous(), nbh)
    with pytest.raises(ValueError, match="P="):
        T.flex_moments(x, torch.zeros(B, N, 4), nbh)
    with pytest.raises(ValueError, match="dtype"):
        T.flex_moments(x, x, nbh.int())
    with pytest.raises(ValueError, match="another"):
        T.flex_moments(x, x, nbh, T.NeighborInverse(nbh.clone(), N))
    with pytest.raises(ValueError, match="dm width"):
        T.flex_moments_backward(torch.zeros(B, N, 7), x, nbh)


# -------------------------------- row_plan --------------------------------

def lane_channels(plan, c):
    """The channels each (pass, lane) of a row group owns under `plan`,
    as kernels C and D walk them: (pass * lanes + lane) * vec onward, while
    below c."""
    vec, lanes, passes = plan
    for p in range(passes):
        for lane in range(lanes):
            ch = (p * lanes + lane) * vec
            if ch < c:
                yield p, lane, list(range(ch, ch + vec))


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("c", [3, 32, 64, 67, 128, 256])
def test_row_plan_covers_every_channel_once(rng, c, k):
    """Every plan `row_plan` gives (at each vector width the alignment may
    leave): VEC divides C, the lanes are a power of two of at most a warp,
    every channel has one owner, no pass is empty, the K the kernels
    unroll gets K lanes where C has that many vectors of any width; and a
    numpy model of the lane layout gives `weighted_sum_plain`'s sums
    (1e-6: one row's sum in k order against the einsum's) and
    `neighbor_max_plain`'s values, ids and slots."""
    feat = rng.randn(1, 40, c).astype(np.float32)
    nbh = rng.randint(0, 40, (1, 9, k))
    w = rng.randn(1, 9, k, 2).astype(np.float32)
    want_sum = T.weighted_sum_plain(_t(feat), _t(nbh), _t(w)).numpy()
    want_max = [t.numpy() for t in T.neighbor_max_plain(_t(feat), _t(nbh))]
    for vec_max in (4, 2, 1):
        plan = T.row_plan(c, k, vec_max)
        vec, lanes, passes = plan
        assert vec <= vec_max and c % vec == 0
        assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
        assert passes == -(-c // (vec * lanes))
        owned = [ch for _, _, chs in lane_channels(plan, c) for ch in chs]
        assert sorted(owned) == list(range(c))
        assert {p for p, _, _ in lane_channels(plan, c)} == set(range(passes))
        if k in neighborhood.UNROLLED_K and c >= k:
            assert lanes >= k
        got_sum = np.zeros_like(want_sum)
        val, arg, slot = (np.zeros_like(a) for a in want_max)
        for n in range(9):
            rows = feat[0, nbh[0, n]]  # [k, c]
            for _, _, chs in lane_channels(plan, c):
                for p in range(2):
                    acc = np.zeros(len(chs), np.float32)
                    for kk in range(k):
                        acc = acc + w[0, n, kk, p] * rows[kk, chs]
                    got_sum[0, n, [p * c + ch for ch in chs]] = acc
                best = np.argmax(rows[:, chs], axis=0)
                val[0, n, chs] = rows[best, chs]
                arg[0, n, chs] = nbh[0, n, best]
                slot[0, n, chs] = best
        _close(got_sum, want_sum, rel=1e-6)
        for got, want in zip((val, arg, slot), want_max):
            np.testing.assert_array_equal(got, want)
    assert T.row_plan(c, k) == T.row_plan(c, k, 4)


def test_row_plan_at_the_models_shapes():
    """The forward's launches: 8 lanes a row at K = 8 (four rows a warp,
    C / 32 passes), 16 at K = 3, raw xyz stays scalar; at K = 1 a lane a
    vector."""
    assert T.row_plan(64, 8) == (4, 8, 2)
    assert T.row_plan(32, 8) == (4, 8, 1)
    assert T.row_plan(128, 8) == (4, 8, 4)
    assert T.row_plan(128, 3) == (4, 16, 2)
    assert T.row_plan(256, 3) == (4, 16, 4)
    assert T.row_plan(3, 8) == (1, 4, 1)
    assert T.row_plan(16, 8) == (2, 8, 1)  # 8 lanes for the 8 ids
    assert T.row_plan(16, 8, vec_max=1) == (1, 8, 2)
    assert T.row_plan(256, 1) == (4, 32, 2)
    assert T.row_plan(256, 64) == (4, 8, 8)
    for bad in ((0, 8), (64, 0), (64, 65)):
        with pytest.raises(ValueError, match="row_plan"):
            T.row_plan(*bad)
    with pytest.raises(ValueError, match="row_plan"):
        T.row_plan(64, 8, vec_max=3)


# ------------------------------ D's NaN rule ------------------------------

NAN = float("nan")
INF = float("inf")


@pytest.mark.parametrize("nan_slots", [(0,), (1,), (K - 1,), (2, 5),
                                       (0, K - 1), ()])
def test_neighbor_max_propagates_the_first_nan(rng, nan_slots):
    """A NaN at slot 0, 1, K-1 or at two slots at once, with +inf and -inf
    beside it: the plain version gives the JAX gather form's value and id
    (`jnp.max` + `jnp.argmax`), the slot of the first NaN, and the
    backward sends the cotangent to that row; without a NaN +inf wins."""
    m, c = 24, 5
    feat = rng.randn(1, m, c).astype(np.float32)
    nbh = np.stack([rng.permutation(m)[:K] for _ in range(6)])[None]
    row = 3  # the neighbourhood that gets the special values
    others = [s for s in range(K) if s not in nan_slots]
    feat[0, nbh[0, row, others[0]], :] = INF
    feat[0, nbh[0, row, others[1]], :] = -INF
    for s in nan_slots:
        feat[0, nbh[0, row, s], 1:4] = NAN  # channels 1-3 only
    val, arg, slot = T.neighbor_max_plain(_t(feat), _t(nbh))
    jv, ja = J.flex_pool(_j(feat), _j(nbh.astype(np.int32)))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))  # NaN == NaN
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ja))
    first = nan_slots[0] if nan_slots else others[0]
    want_slot = np.full(c, others[0])
    want_slot[1:4] = first
    np.testing.assert_array_equal(slot[0, row].numpy(), want_slot)
    np.testing.assert_array_equal(arg[0, row].numpy(),
                                  nbh[0, row, want_slot])
    assert bool(val[0, row, 1:4].isnan().all()) == bool(nan_slots)
    assert bool((val[0, row, [0, 4]] == INF).all())
    # the op, and its backward: the cotangent lands on the winner's row
    f = _t(feat).requires_grad_()
    v2, a2 = T.neighbor_max(f, _t(nbh))
    np.testing.assert_array_equal(v2.detach().numpy(), val.numpy())
    assert torch.equal(a2, arg)
    dval = rng.randn(1, 6, c).astype(np.float32)
    v2.backward(_t(dval))
    want = np.zeros((1, m, c), np.float32)
    ids = arg.numpy()
    for n in range(6):
        for ch in range(c):
            want[0, ids[0, n, ch], ch] += dval[0, n, ch]
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    jgrad = jax.grad(lambda x: jnp.vdot(
        J.flex_pool(x, _j(nbh.astype(np.int32)))[0], _j(dval)))(_j(feat))
    if not nan_slots:  # jnp.max's VJP splits a cotangent among NaN "ties"
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------ D's optional id ------------------------------

@pytest.mark.parametrize("needs_grad", [False, True])
def test_neighbor_max_without_arg(rng, knn8, needs_grad):
    """`with_arg=False`: the same value and gradient, None for the ids,
    from `neighbor_max`, `flex_pool` and `neighbor_max_with_slot`."""
    feat = rng.randn(B, N, 6).astype(np.float32)
    dval = _t(rng.randn(B, N, 6).astype(np.float32))
    nbh = _t(knn8)
    f1 = _t(feat).requires_grad_(needs_grad)
    f2 = _t(feat).requires_grad_(needs_grad)
    val, arg = T.neighbor_max(f1, nbh)
    v2, none = T.neighbor_max(f2, nbh, with_arg=False)
    assert none is None and arg.dtype == torch.int64
    assert torch.equal(val, v2)
    assert T.flex_pool(f2, nbh, with_arg=False)[1] is None
    assert torch.equal(T.flex_pool(f2, nbh)[1], arg)
    if needs_grad:
        val.backward(dval)
        v2.backward(dval)
        assert torch.equal(f1.grad, f2.grad)
    v3, none, slot = T.neighbor_max_with_slot(_t(feat), nbh, with_arg=False)
    assert none is None and slot.dtype == torch.int8
    assert torch.equal(v3, val.detach())


def test_model_forward_is_the_same_without_the_ids(monkeypatch):
    """The backbone drops flex_pool's ids and asks for none: its outputs
    are the bits of a forward whose pools compute them."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.nn import backbones
    from dh3d_tpu_torch.nn.model import DH3D

    cfg = cfglib.get_config("global_config")
    cfg.num_points, cfg.sampled_kpnum = 256, -1
    torch.manual_seed(0)
    model = DH3D(cfg).eval()
    pts = _t(np.random.RandomState(1).randn(2, 256, 3).astype(np.float32)
             * 10)
    asked = []
    real = backbones.ops.flex_pool

    def spy(features, nbh, inverse=None, with_arg=True):
        asked.append(with_arg)
        return real(features, nbh, inverse, with_arg)

    monkeypatch.setattr(backbones.ops, "flex_pool", spy)
    with torch.no_grad():
        lean = model(pts)
    assert asked == [False, False, False]

    def with_ids(features, nbh, inverse=None, with_arg=True):
        val, arg = real(features, nbh, inverse, True)
        assert arg is not None
        return val, arg

    monkeypatch.setattr(backbones.ops, "flex_pool", with_ids)
    with torch.no_grad():
        full = model(pts)
    assert set(lean) == set(full)
    for key in lean:
        assert torch.equal(lean[key], full[key]), key
