"""The backwards of the PyTorch port's kernelled ops against the JAX
package's VJPs, on the CPU.

On the CPU the port's `WeightedSum`, `FlexMoments` and `NeighborMax`
Functions run their plain forward and plain backward (`weighted_sum_backward_plain`,
`neighbor_max_backward_plain`): the functions kernels E and F are held to
on the card (`tests/test_torch_cuda.py`; PERF.md §6).  Here the same
numpy inputs and cotangents go through
  - `jax.grad` of the JAX CPU gather forms (`dh3d_tpu.ops`), and
  - the planned Pallas paths the TPU trains with, in interpret mode, at
    `tests/test_pallas.py`'s shapes and tolerances: B=2, N=512, K=8, C=32,
    tile 128, window 256, `oob_plan(cap=1024, we=512)`, 15% of the indices
    far outside the band.
Tolerances at each assertion, with their reasons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu import ops as J
from dh3d_tpu.ops.flex import _flex_moments
from dh3d_tpu.ops.pallas.banded_pallas import (
    banded_max_planned,
    banded_weighted_sum_planned,
    flex_moments_banded_planned,
    oob_plan,
)
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.ops.neighborhood import (NeighborMax, WeightedSum,
                                             unpack_entries)

B, N, K, C = 2, 512, 8, 32
TILE, WIN, WE = 128, 256, 512
REL = 1e-5  # f32 sums in another order than the JAX gather form


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def _close(a, ref, rel=REL):
    """|a - ref| <= rel * max|ref| elementwise."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = np.abs(a - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _port_vjp(fn, dout, *args):
    """Gradient of sum(fn(*args) * dout) w.r.t. each float arg."""
    ts = [_t(a).requires_grad_() if a.dtype == np.float32 else _t(a)
          for a in args]
    out = fn(*ts)
    out = out[0] if isinstance(out, tuple) else out
    (out * _t(dout)).sum().backward()
    return [t.grad for t in ts if t.is_floating_point()]


def _jax_vjp(fn, dout, *args, argnums=0):
    return jax.grad(lambda *a: jnp.vdot(fn(*a), _j(dout)),
                    argnums=argnums)(*map(_j, args))


@pytest.fixture
def cloud(rng):
    return rng.randn(B, N, 3).astype(np.float32)


@pytest.fixture
def knn8(cloud):
    idx, _ = T.knn_bruteforce(_t(cloud), K)
    return idx.numpy()


@pytest.fixture
def banded_nbh(rng):
    """test_pallas.py's index distribution: a Morton-like band plus 15%
    far ids."""
    off = (rng.randn(B, N, K) * 40).astype(np.int64)
    nbh = np.clip(np.arange(N)[None, :, None] + off, 0, N - 1)
    far = rng.rand(B, N, K) < 0.15
    return np.where(far, rng.randint(0, N, nbh.shape), nbh)


@pytest.fixture
def plan(banded_nbh):
    p = jax.jit(lambda n: oob_plan(n, N, TILE, WIN, cap=1024, we=WE))(
        _j(banded_nbh.astype(np.int32)))
    assert int(np.asarray(p.overflow).max()) == 0
    return p


# --------------------------- the JAX gather forms ---------------------------

def test_flex_moments_backward_matches_jax(rng, cloud, knn8):
    """Kernel E at P=4 (the moments transpose) against jax.grad of
    `_flex_moments`, the JAX CPU gather form."""
    feat = rng.randn(B, N, C).astype(np.float32)
    dm = rng.randn(B, N, 4 * C).astype(np.float32)
    want = _jax_vjp(_flex_moments, dm, feat, cloud, knn8.astype(np.int32))
    (got,) = _port_vjp(
        lambda f: T.weighted_sum(f, _t(knn8), T.flex_weights(_t(cloud),
                                                             _t(knn8))),
        dm, feat)
    _close(got.numpy(), want)


def test_flex_conv_backward_matches_jax(rng, cloud, knn8):
    """The whole op: features, theta and bias gradients."""
    feat = rng.randn(B, N, C).astype(np.float32)
    theta = (rng.randn(3, C, 24) * 0.1).astype(np.float32)
    bias = (rng.randn(C, 24) * 0.1).astype(np.float32)
    dout = rng.randn(B, N, 24).astype(np.float32)
    nbh = knn8.astype(np.int32)
    want = _jax_vjp(lambda f, t, b: J.flex_conv(f, _j(cloud), _j(nbh), t, b),
                    dout, feat, theta, bias, argnums=(0, 1, 2))
    got = _port_vjp(lambda f, t, b: T.flex_conv(f, _t(cloud), _t(knn8), t, b),
                    dout, feat, theta, bias)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_flex_pool_backward_matches_jax(rng, knn8):
    """Kernel F against jax.grad of the gather-form max (no ties here:
    continuous random features)."""
    feat = rng.randn(B, N, C).astype(np.float32)
    dval = rng.randn(B, N, C).astype(np.float32)
    want = _jax_vjp(lambda f: J.flex_pool(f, _j(knn8.astype(np.int32)))[0],
                    dval, feat)
    (got,) = _port_vjp(lambda f: T.flex_pool(f, _t(knn8)), dval, feat)
    _close(got.numpy(), want)


def test_conv_pointset_backward_matches_jax(rng, knn8):
    """Kernel E at P=1 with the difference weights [1-K, 1, ..., 1]."""
    feat = rng.randn(B, N, 16).astype(np.float32)
    theta = (rng.randn(16, 24) * 0.3).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    dout = rng.randn(B, N, 24).astype(np.float32)
    nbh = knn8.astype(np.int32)
    want = _jax_vjp(lambda f, t, b: J.conv_pointset(f, _j(nbh), t, b),
                    dout, feat, theta, bias, argnums=(0, 1, 2))
    got = _port_vjp(lambda f, t, b: T.conv_pointset(f, _t(knn8), t, b),
                    dout, feat, theta, bias)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_three_interpolate_backward_matches_jax(rng):
    """Kernel E at P=1, K=3, N != M (the upsample's transpose)."""
    M = 64
    feat = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(0, M, (B, N, 3))
    w = rng.rand(B, N, 3).astype(np.float32)
    dout = rng.randn(B, N, C).astype(np.float32)
    want = _jax_vjp(lambda f: J.three_interpolate(
        f, _j(idx.astype(np.int32)), _j(w)), dout, feat)
    (got,) = _port_vjp(lambda f: T.three_interpolate(f, _t(idx), _t(w)),
                       dout, feat)
    _close(got.numpy(), want)


# ------------------ the planned Pallas paths (interpret mode) ------------------

@pytest.mark.parametrize("P", [1, 4])
def test_weighted_sum_matches_planned_pallas(rng, banded_nbh, plan, P):
    """`banded_weighted_sum_planned(fast=False)`: `_fwd_kernel` (P=1) or
    `_bwd_kernel`-routed transpose (P=4), `_bwd_w1_kernel` (P=1) and the
    out-of-band delivery of `_slot_kernel` both ways (rows 6, 9, 11, 12).
    Forward to 2e-5 and VJP to 2e-4, test_pallas.py's tolerances for the
    same kernels against the dense oracle (f32 one-hot matmuls)."""
    feat = rng.randn(B, N, C).astype(np.float32)
    w = rng.randn(B, N, K, P).astype(np.float32)
    dm = rng.randn(B, N, P * C).astype(np.float32)
    nbh32 = _j(banded_nbh.astype(np.int32))

    def planned(x, ww):
        return banded_weighted_sum_planned(x, nbh32, ww, plan, TILE, WIN, WE,
                                           False, True)

    ref = np.asarray(jax.jit(planned)(_j(feat), _j(w)))
    gref = np.asarray(jax.jit(jax.grad(
        lambda x, ww: jnp.vdot(planned(x, ww), _j(dm))))(_j(feat), _j(w)))
    f = _t(feat).requires_grad_()
    out = T.weighted_sum(f, _t(banded_nbh), _t(w))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5,
                               atol=2e-5)
    out.backward(_t(dm))
    np.testing.assert_allclose(f.grad.numpy(), gref, rtol=2e-4, atol=2e-4)
    _close(T.weighted_sum_backward(_t(dm), _t(banded_nbh), _t(w), N).numpy(),
           gref, rel=2e-5)


def test_neighbor_max_matches_planned_pallas(rng, banded_nbh, plan):
    """`banded_max_planned(fast=False)`: `_max_kernel` with the slot, the
    out-of-band delivery, and `_bwd_slot_kernel` (rows 8, 9, 13): values
    and ids exact, VJP to 2e-5 (test_pallas.py's)."""
    feat = rng.randn(B, N, C).astype(np.float32)
    dval = rng.randn(B, N, C).astype(np.float32)
    nbh32 = _j(banded_nbh.astype(np.int32))

    def planned(x):
        return banded_max_planned(x, nbh32, plan, TILE, WIN, WE, False, True)

    jv, ja = jax.jit(planned)(_j(feat))
    gref = jax.jit(jax.grad(lambda x: jnp.vdot(planned(x)[0], _j(dval))))(
        _j(feat))
    f = _t(feat).requires_grad_()
    tv, ta = T.neighbor_max(f, _t(banded_nbh))
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    tv.backward(_t(dval))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gref), rtol=2e-5,
                               atol=2e-5)


def test_flex_moments_match_planned_pallas(rng, banded_nbh, plan):
    """`flex_moments_banded_planned(fast=False)`: `_moments_fwd_kernel` and
    `_moments_bwd_kernel` with the out-of-band correction (rows 7, 9, 10).
    That kernel carries the position-scaled counts in bf16 planes, so it is
    held to test_pallas.py's budget for it: forward error under 3e-2 of
    the mean moment magnitude, VJP error under 5e-3 of the mean gradient
    magnitude.  The port's f32 moments and their transpose (kernel E with
    weights [1, delta]) are the dense reference of that test."""
    Cpad = 128  # the kernel's lane-padded channel count
    feat = rng.randn(B, N, C).astype(np.float32)
    pos = (rng.randn(B, N, 3) * 0.5 + 10.0).astype(np.float32)
    pos0 = np.take_along_axis(pos, banded_nbh[:, :, :1], axis=1)
    nbh32 = _j(banded_nbh.astype(np.int32))

    def planned(x):
        return flex_moments_banded_planned(x, _j(pos), _j(pos0), nbh32, plan,
                                           TILE, WIN, WE, False, True)

    out = np.asarray(jax.jit(planned)(_j(feat))).reshape(B, N, 4, Cpad)
    w = T.flex_weights(_t(pos), _t(banded_nbh))
    f = _t(feat).requires_grad_()
    got = T.weighted_sum(f, _t(banded_nbh), w)
    planes = got.detach().numpy().reshape(B, N, 4, C)
    scale = np.abs(planes).mean()
    assert np.abs(out[..., :C] - planes).max() / scale < 3e-2
    np.testing.assert_array_equal(out[..., C:], 0.0)

    dm = rng.randn(B, N, 4, C).astype(np.float32)
    dpad = np.zeros((B, N, 4, Cpad), np.float32)
    dpad[..., :C] = dm
    gref = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.vdot(planned(x), _j(dpad.reshape(B, N, -1)))))(
            _j(feat)))
    got.backward(_t(dm.reshape(B, N, -1)))
    gscale = np.abs(f.grad.numpy()).mean()
    assert np.abs(f.grad.numpy() - gref).max() / gscale < 5e-3


# ------------------------- the Functions themselves -------------------------

def _graph_nodes(t):
    """Names of the autograd nodes `t` was computed through."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def test_kernelled_ops_carry_a_graph(rng, cloud, knn8):
    """The repair of the forward-only wrappers: flex_conv, conv_pointset,
    three_interpolate and flex_pool outputs hang off the Functions' nodes."""
    feat = _t(rng.randn(B, N, 8).astype(np.float32)).requires_grad_()
    th = torch.zeros(3, 8, 4, requires_grad=True)
    out = T.flex_conv(feat, _t(cloud), _t(knn8), th, torch.zeros(8, 4))
    assert out.requires_grad
    assert "FlexMomentsBackward" in _graph_nodes(out)
    out = T.conv_pointset(feat, _t(knn8), torch.zeros(8, 4), torch.zeros(4))
    assert "WeightedSumBackward" in _graph_nodes(out)
    val, arg = T.flex_pool(feat, _t(knn8))
    assert type(val.grad_fn).__name__ == "NeighborMaxBackward"
    assert not arg.requires_grad
    up = T.three_interpolate(feat, _t(knn8[..., :3]), torch.rand(B, N, 3))
    assert type(up.grad_fn).__name__ == "WeightedSumBackward"


def test_weights_and_indices_get_no_gradient(rng, knn8):
    """As the JAX VJPs: the weights' cotangent is zero (here: none), the
    indices are integers; with features that need no grad the backward
    does no work (`needs_input_grad`), as for conv_pointset on raw xyz."""
    feat = _t(rng.randn(B, N, 4).astype(np.float32))
    w = _t(rng.randn(B, N, K, 2).astype(np.float32)).requires_grad_()
    out = WeightedSum.apply(feat, _t(knn8), w)
    out.sum().backward()
    assert w.grad is None
    f = feat.clone().requires_grad_()
    w2 = w.detach().clone().requires_grad_()
    WeightedSum.apply(f, _t(knn8), w2).sum().backward()
    assert f.grad is not None and w2.grad is None
    with torch.no_grad():
        val, _ = NeighborMax.apply(f, _t(knn8))
    assert val.grad_fn is None


def test_max_gradient_goes_once_to_the_lowest_k(rng, banded_nbh):
    """A neighbourhood that repeats an id: the winning id gets dval once,
    not once per occurrence (`_max_planned_vjp_bwd`'s first-occurrence
    rule); ties between ids go to the lowest k."""
    feat = rng.randn(1, 16, 3).astype(np.float32)
    feat[0, 5] = 10.0  # id 5 wins every channel it is in
    nbh = np.tile(np.array([[0, 5, 2, 5, 9]]), (16, 1))[None]
    dval = np.ones((1, 16, 3), np.float32)
    (g,) = _port_vjp(lambda f: T.neighbor_max(f, _t(nbh)), dval, feat)
    want = np.zeros_like(feat)
    want[0, 5] = 16.0  # 16 rows, each passes its cotangent on once
    np.testing.assert_array_equal(g.numpy(), want)
    tied = np.zeros((1, 16, 3), np.float32)  # every value ties
    (g,) = _port_vjp(lambda f: T.neighbor_max(f, _t(nbh)), dval, tied)
    want = np.zeros_like(tied)
    want[0, 0] = 16.0  # k = 0 holds id 0
    np.testing.assert_array_equal(g.numpy(), want)

    # and as the planned Pallas VJP routes it, with a repeated id in every
    # neighbourhood of test_pallas.py's layout.  Continuous features: on an
    # exact tie between an in-band and an out-of-band candidate the planned
    # kernels keep the in-band one (`ops/flex.py:256-260`), not the lowest
    # k of the reference rule that the port follows
    nbh = banded_nbh.copy()
    nbh[:, :, 3] = nbh[:, :, 1]
    nbh32 = _j(nbh.astype(np.int32))
    pl = jax.jit(lambda n: oob_plan(n, N, TILE, WIN, cap=1024, we=WE))(nbh32)
    assert int(np.asarray(pl.overflow).max()) == 0
    feat = rng.randn(B, N, C).astype(np.float32)
    dval = rng.randn(B, N, C).astype(np.float32)
    gj = jax.jit(jax.grad(lambda x: jnp.vdot(banded_max_planned(
        x, nbh32, pl, TILE, WIN, WE, False, True)[0], _j(dval))))(_j(feat))
    (g,) = _port_vjp(lambda f: T.neighbor_max(f, _t(nbh)), dval, feat)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=2e-5,
                               atol=2e-5)


def test_inverse_neighbors_lists_every_occurrence(rng):
    nbh = rng.randint(0, 40, (2, 30, 4))
    rowptr, ent = T.inverse_neighbors(_t(nbh), 50)
    assert rowptr.shape == (2, 51) and ent.shape == (2, 120)
    assert rowptr.dtype == ent.dtype == torch.int32
    for b in range(2):
        for j in range(50):
            got = ent[b, rowptr[b, j]:rowptr[b, j + 1]].numpy()
            n, k = unpack_entries(got)
            flat = n * 4 + k
            np.testing.assert_array_equal(
                flat, np.flatnonzero(nbh[b].reshape(-1) == j))
