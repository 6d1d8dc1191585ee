"""Each kernelled op of the PyTorch port against the JAX package, on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions, which are
the functions the CUDA kernels are held to on the card
(`tests/test_torch_cuda.py`; PERF.md §6).  Here the same numpy inputs
go through:
  - the JAX CPU op of `dh3d_tpu.ops` (its plain gather/XLA form), and
  - the Pallas kernel the port replaces, in interpret mode, with window = N
    (every index in band) where the kernel has a Morton window.
Tolerances, each with its reason at the assertion: indices and max values
exact; f32 sums 1e-5 relative (summation order); the bf16-plane moments
kernel looser.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from dh3d_tpu import ops as J
from dh3d_tpu.ops.pallas.banded_pallas import (
    banded_max,
    banded_weighted_sum,
    flex_moments_banded_fast,
)
from dh3d_tpu.ops.pallas.banded_pallas import morton_perm as jax_morton_perm
from dh3d_tpu.ops.pallas.fps_pallas import fps_pallas
from dh3d_tpu.ops.pallas.knn_pallas import knn_banded, knn_pallas
from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T

B, N, K = 2, 512, 8
REL = 1e-5  # f32 sums in another order than the reference


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.ascontiguousarray(x))


def _close(a, ref, rel=REL):
    """|a - ref| <= rel * max|ref| elementwise."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    err = np.abs(a - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _trunc(d2, bits=13):
    """The packed Pallas kNN's distance: low `bits` mantissa bits cleared."""
    return (np.asarray(d2, np.float32).view(np.int32)
            & np.int32(~((1 << bits) - 1))).view(np.float32)


@pytest.fixture
def cloud(rng):
    return rng.randn(B, N, 3).astype(np.float32)


@pytest.fixture
def knn8(cloud):
    idx, _ = T.knn_bruteforce(_t(cloud), K)
    return idx.numpy()


# ------------------------------- kernel A: kNN -------------------------------

def test_knn_bruteforce_matches_jax():
    """The JAX CPU kNN builds d2 with the matmul identity, exact to ~1e-6
    relative here; the clouds (seed 2) are checked to have no near tie
    (relative gap < 1e-4) at the k / k+1 boundary, so the index sets must
    agree."""
    cloud = np.random.RandomState(2).randn(B, N, 3).astype(np.float32)
    d = ((cloud[:, :, None].astype(np.float64) - cloud[:, None]) ** 2).sum(-1)
    ds = np.sort(d, axis=-1)
    gap = (ds[..., K] - ds[..., K - 1]) / ds[..., K]
    assert gap.min() > 1e-4
    ji, jd = J.knn_bruteforce(_j(cloud), K)
    ti, td = T.knn_bruteforce(_t(cloud), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy()[..., 0],
                                  np.broadcast_to(np.arange(N), (B, N)))


def test_knn_matches_oracle(rng):
    pos = rng.randn(2, 64, 3).astype(np.float32) * 5
    oidx, odist = oracles.knn_oracle(pos, 6)
    ti, td = T.knn_bruteforce(_t(pos), 6)
    np.testing.assert_array_equal(ti.numpy(), oidx)
    np.testing.assert_allclose(td.numpy(), odist, atol=1e-4)


def test_knn_matches_pallas_packed_self_query(cloud):
    """`knn_pallas(packed=True, self_query=True)`, the main path's self-kNN
    kernel, orders by (d2 with its low 13 mantissa bits cleared, index).
    Where the port's top k+1 truncated distances are all distinct that is
    the exact order, so the indices must be equal there; everywhere the
    truncated distances must be equal."""
    pi, pd = knn_pallas(_j(cloud), _j(cloud), K, packed=True,
                        self_query=True, interpret=True)
    ti, td = T.knn(_t(cloud), _t(cloud), K + 1)
    tr = _trunc(td.numpy())
    distinct = (np.diff(tr, axis=-1) > 0).all(-1)
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(ti.numpy()[..., :K][distinct],
                                  np.asarray(pi)[distinct])
    np.testing.assert_array_equal(tr[..., :K], np.asarray(pd))


@pytest.mark.parametrize("packed", [False, True])
def test_three_nn_matches_pallas_banded_full_window(cloud, rng, packed):
    """`knn_banded(window=M)`: the main path's 3-NN kernel over the whole
    key table.  Exact mode: indices equal; d2 to 1e-6 relative (the
    interpreter may fuse the d2 build into FMAs, the port does not).
    Packed mode: as in the self-query test."""
    M = 128
    keys = rng.randn(B, M, 3).astype(np.float32)
    bi, bd = knn_banded(_j(cloud), _j(keys), 3, window=M, packed=packed,
                        interpret=True)
    if packed:
        ti, td = T.knn(_t(cloud), _t(keys), 4)
        tr = _trunc(td.numpy())
        distinct = (np.diff(tr, axis=-1) > 0).all(-1)
        assert distinct.mean() > 0.9
        np.testing.assert_array_equal(ti.numpy()[..., :3][distinct],
                                      np.asarray(bi)[distinct])
        np.testing.assert_array_equal(tr[..., :3], np.asarray(bd))
    else:
        td, ti = T.three_nn(_t(cloud), _t(keys))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(bi))
        np.testing.assert_allclose(td.numpy(), np.asarray(bd), rtol=1e-6)


def test_three_nn_matches_jax(cloud, rng):
    """JAX CPU three_nn: matmul-identity d2 (absolute error ~1e-6 here)."""
    keys = rng.randn(B, 64, 3).astype(np.float32)
    jd, ji = J.three_nn(_j(cloud), _j(keys))
    td, ti = T.three_nn(_t(cloud), _t(keys))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def test_knn_duplicate_points_lower_twin_first(rng):
    """Mirror of test_pallas.py::test_knn_packed_self_query_duplicate_points:
    on exact duplicates both twins see (lower twin, higher twin) at slots
    0, 1 with distance 0 — the lowest index wins ties."""
    pos = rng.randn(1, 128, 3).astype(np.float32)
    pos[0, 64:96] = pos[0, 0:32]
    idx, d2 = T.knn(_t(pos), _t(pos), 4)
    idx, d2 = idx.numpy(), d2.numpy()
    r = np.arange(128)
    uniq = np.concatenate([r[32:64], r[96:]])
    np.testing.assert_array_equal(idx[0, uniq, 0], uniq)
    np.testing.assert_array_equal(idx[0, 0:32, 0], r[0:32])
    np.testing.assert_array_equal(idx[0, 0:32, 1], r[64:96])
    np.testing.assert_array_equal(idx[0, 64:96, 0], r[0:32])
    np.testing.assert_array_equal(idx[0, 64:96, 1], r[64:96])
    assert (d2[0, 0:32, :2] == 0).all() and (d2[0, 64:96, :2] == 0).all()
    assert (np.diff(d2, axis=-1) >= 0).all()


# ------------------------------- kernel B: FPS -------------------------------

def test_fps_matches_jax_and_pallas(cloud):
    """Indices exact: both sides build d2 from the same rounded terms and
    take the first maximum."""
    ti = T.farthest_point_sample(_t(cloud), 64).numpy()
    np.testing.assert_array_equal(
        ti, np.asarray(J.farthest_point_sample(_j(cloud), 64)))
    np.testing.assert_array_equal(
        ti, np.asarray(fps_pallas(_j(cloud), 64, interpret=True)))
    assert (ti[:, 0] == 0).all()
    assert all(len(set(row)) == 64 for row in ti)


def test_fps_matches_oracle(rng):
    pts = rng.randn(2, 100, 3).astype(np.float32)
    np.testing.assert_array_equal(
        T.farthest_point_sample(_t(pts), 20).numpy(), oracles.fps_oracle(pts, 20))


def test_subsample_sorted_order_keeps_the_set(cloud):
    feat = np.arange(B * N, dtype=np.float32).reshape(B, N, 1)
    xs, fs, kp = T.subsample(_t(cloud), _t(feat), 64)
    xs2, fs2, kp2 = T.subsample(_t(cloud), _t(feat), 64, sorted_order=True)
    np.testing.assert_array_equal(np.sort(kp.numpy(), -1), kp2.numpy())
    np.testing.assert_array_equal(fs2.numpy()[..., 0],
                                  kp2.numpy() + N * np.arange(B)[:, None])
    jx, jf, jk = J.subsample(_j(cloud), _j(feat), 64, sorted_order=True)
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(xs2.numpy(), np.asarray(jx))


# ------------------------- kernel C: weighted sum -------------------------

@pytest.mark.parametrize("P,C", [(1, 3), (4, 64)])
def test_weighted_sum_matches_pallas(rng, P, C):
    """`banded_weighted_sum(fast=False)` (f32 one-hot matmul) on random,
    non-banded indices, window = N: the work of `_fwd_kernel` and of the
    out-of-band delivery both."""
    feat = rng.randn(B, N, C).astype(np.float32)
    nbh = rng.randint(0, N, (B, N, K))
    w = rng.randn(B, N, K, P).astype(np.float32)
    ref = banded_weighted_sum(_j(feat), _j(nbh.astype(np.int32)), _j(w),
                              None, 256, N, False, True)
    _close(T.weighted_sum(_t(feat), _t(nbh), _t(w)).numpy(), ref)


def test_three_interpolate_matches_pallas_n_ne_m(rng):
    """N != M (8192 <- 1024 on the main path; 512 <- 128 here)."""
    M, C = 128, 32
    feat = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(0, M, (B, N, 3))
    w = rng.rand(B, N, 3).astype(np.float32)
    ref = banded_weighted_sum(_j(feat), _j(idx.astype(np.int32)),
                              _j(w[..., None]), None, 128, M, False, True)
    _close(T.three_interpolate(_t(feat), _t(idx), _t(w)).numpy(), ref)


def test_three_interpolate_matches_jax(rng):
    M, C = 64, 16
    feat = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(0, M, (B, N, 3))
    d = rng.rand(B, N, 3).astype(np.float32) + 0.1
    jw = J.inverse_distance_weights(_j(d))
    tw = T.inverse_distance_weights(_t(d))
    _close(tw.numpy(), jw, rel=1e-6)
    ref = J.three_interpolate(_j(feat), _j(idx.astype(np.int32)), jw)
    _close(T.three_interpolate(_t(feat), _t(idx), tw).numpy(), ref)


def test_flex_moments_match_pallas_fast(rng, cloud, knn8):
    """`flex_moments_banded_fast`, the TPU kernel behind every flex_conv on
    the main path: P = 4 weights [1, delta].  That kernel rounds the
    features to bf16 (8 mantissa bits, 2^-9 relative per term) and carries
    the position-scaled counts in bf16 hi/lo planes, so each moment plane
    is held to 4e-3 of its largest magnitude (measured 2e-3)."""
    C = 64
    feat = rng.randn(B, N, C).astype(np.float32)
    pos0 = np.take_along_axis(cloud, knn8[..., :1], axis=1)
    ref = np.asarray(flex_moments_banded_fast(
        _j(feat), _j(cloud), _j(pos0), _j(knn8.astype(np.int32)), 256, N,
        True)).reshape(B, N, 4, C)
    got = T.weighted_sum(_t(feat), _t(knn8), T.flex_weights(_t(cloud),
                                                            _t(knn8)))
    got = got.numpy().reshape(B, N, 4, C)
    for p in range(4):
        _close(got[:, :, p], ref[:, :, p], rel=4e-3)


def test_flex_conv_matches_jax(rng, cloud, knn8):
    C, D = 64, 48
    feat = rng.randn(B, N, C).astype(np.float32)
    theta = rng.randn(3, C, D).astype(np.float32) * 0.1
    bias = rng.randn(C, D).astype(np.float32) * 0.1
    ref = J.flex_conv(_j(feat), _j(cloud), _j(knn8.astype(np.int32)),
                      _j(theta), _j(bias))
    _close(T.flex_conv(_t(feat), _t(cloud), _t(knn8), _t(theta),
                       _t(bias)).numpy(), ref)
    small = slice(0, 8)
    _close(T.flex_conv(_t(feat[:1, :, :4]), _t(cloud[:1]), _t(knn8[:1]),
                       _t(theta[:, :4, :5]), _t(bias[:4, :5])).numpy()[:, small],
           oracles.flex_conv_oracle(feat[:1, :, :4], cloud[:1], knn8[:1],
                                    theta[:, :4, :5], bias[:4, :5])[:, small])


def test_conv_pointset_raw_xyz_matches_jax(cloud, knn8, rng):
    """initconv's input is raw xyz (~100 m here).  The port forms
    sum_k f_k - K f_0 in one weighted sum, the JAX gather form subtracts
    term by term: the cancellation costs ~1e-5 of the output scale."""
    xyz = cloud * 30.0
    theta = rng.randn(3, 32).astype(np.float32) * 0.3
    bias = rng.randn(32).astype(np.float32)
    ref = J.conv_pointset(_j(xyz), _j(knn8.astype(np.int32)), _j(theta),
                          _j(bias))
    got = T.conv_pointset(_t(xyz), _t(knn8), _t(theta), _t(bias)).numpy()
    _close(got, ref)
    _close(got, oracles.conv_pointset_oracle(xyz, knn8, theta, bias))


# ------------------------- kernel D: neighbour max -------------------------

def test_neighbor_max_matches_pallas(rng):
    """`banded_max(fast=False)` on random, non-banded indices, window = N:
    values and argmax ids exact."""
    C = 64
    feat = rng.randn(B, N, C).astype(np.float32)
    nbh = rng.randint(0, N, (B, N, K))
    jv, ja = banded_max(_j(feat), _j(nbh.astype(np.int32)), 256, N, False,
                        True)
    tv, ta = T.neighbor_max(_t(feat), _t(nbh))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_flex_pool_matches_jax(rng, knn8):
    C = 32
    feat = rng.randn(B, N, C).astype(np.float32)
    jv, ja = J.flex_pool(_j(feat), _j(knn8.astype(np.int32)))
    tv, ta = T.flex_pool(_t(feat), _t(knn8))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    ov, oa = oracles.flex_pool_oracle(feat, knn8)
    np.testing.assert_array_equal(tv.numpy(), ov)
    np.testing.assert_array_equal(ta.numpy(), oa)


def test_neighbor_max_ties_keep_lowest_k(rng):
    """Values from {0, 1, 2}: most maxima are tied; the id must be that of
    the lowest k attaining the max (strict `>`), as the Pallas kernel."""
    C = 16
    feat = rng.randint(0, 3, (B, N, C)).astype(np.float32)
    nbh = rng.randint(0, N, (B, N, K))
    tv, ta = T.neighbor_max(_t(feat), _t(nbh))
    f_k = np.stack([feat[b][nbh[b]] for b in range(B)])  # [B, N, K, C]
    first = np.argmax(f_k, axis=2)  # first occurrence
    want = np.take_along_axis(nbh[..., None], first[:, :, None, :],
                              axis=2)[:, :, 0]
    np.testing.assert_array_equal(ta.numpy(), want)
    np.testing.assert_array_equal(tv.numpy(), f_k.max(axis=2))
    _, ja = banded_max(_j(feat), _j(nbh.astype(np.int32)), 256, N, False,
                       True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


# ------------------------------- Morton order -------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_morton_perm_matches_jax(rng, scale):
    """Bit-exact: the FPS seed is sorted index 0.  scale=1e-3 with rounded
    coordinates puts many points on one code (stable-sort ties)."""
    pts = (rng.randn(B, N, 3) * scale).astype(np.float32)
    pts[:, :200] = np.round(pts[:, :200], 3)
    jp, ji = jax_morton_perm(_j(pts))
    tp, ti = T.morton_perm(_t(pts))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------ the wrappers ------------------------------

def test_wrappers_check_their_inputs(cloud, knn8):
    x = _t(cloud)
    with pytest.raises(ValueError, match="dtype"):
        T.knn(x.double(), x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        T.farthest_point_sample(x.transpose(0, 1).contiguous()
                                .transpose(0, 1), 8)
    with pytest.raises(ValueError, match="k="):
        T.knn(x, x, N + 1)  # more neighbours than keys
    with pytest.raises(ValueError, match="shape"):
        T.weighted_sum(x, _t(knn8), torch.ones(B, N, 4, 1))
    with pytest.raises(ValueError, match="P="):
        T.weighted_sum(x, _t(knn8), torch.ones(B, N, K, 5))
    with pytest.raises(ValueError, match="dtype"):
        T.neighbor_max(x, _t(knn8).int())
    with pytest.raises(ValueError, match="devices"):
        T.neighbor_max(x, _t(knn8).to("meta"))
    with pytest.raises(ValueError, match="device meta"):
        T.farthest_point_sample(x.to("meta"), 8)


def test_cpu_path_never_builds_or_counts(cloud, knn8):
    """CPU tensors take the plain versions: no library is built or loaded
    and no launch is counted."""
    kernels.reset_counts()
    T.knn_bruteforce(_t(cloud), K)
    T.knn_bruteforce(_t(cloud), 50)  # kernel G's plain version
    T.knn_window(_t(cloud[:, :256]), _t(cloud), 8, 128)  # kernel H's
    T.farthest_point_sample(_t(cloud), 16)
    T.flex_pool(_t(cloud), _t(knn8))
    T.conv_pointset(_t(cloud), _t(knn8), torch.ones(3, 2), torch.zeros(2))
    f = _t(cloud).requires_grad_()
    T.flex_pool(f, _t(knn8))[0].sum().backward()  # kernel F's plain version
    T.flex_moments(f, _t(cloud), _t(knn8)).sum().backward()  # C and E on pos
    fb = _t(cloud).to(torch.bfloat16).requires_grad_()
    T.flex_moments(fb, _t(cloud), _t(knn8)).sum().backward()  # bf16 cases
    T.radius_count(_t(cloud[0]), 1.0)  # kernel I's plain version
    T.batch_norm_train(f, torch.ones(3), torch.zeros(3), torch.zeros(3),
                       torch.ones(3), 0.9, 1e-5, relu=True).sum().backward()
    assert kernels.counts() == {"knn": 0, "knn_topk": 0, "knn_window": 0,
                                "fps": 0,
                                "weighted_sum": 0, "flex_moments": 0,
                                "flex_moments_bf16": 0,
                                "neighbor_max": 0,
                                "weighted_sum_backward": 0,
                                "flex_moments_backward": 0,
                                "flex_moments_backward_bf16": 0,
                                "neighbor_max_backward": 0,
                                "radius_count": 0,
                                "batch_norm_stats": 0,
                                "batch_norm_forward": 0,
                                "batch_norm_grad_sums": 0,
                                "batch_norm_grad_dx": 0}
    assert kernels._library is None
    path = kernels.library_path()
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")


# ----------------------- kernel G: kNN at large k -----------------------

def test_knn_k50_self_matches_pallas_slab_and_oracle(rng):
    """k=50 runs (it raised above k=32 before) and equals the slab kernel
    `_knn_kernel_slab`, which `knn_pallas` takes for every k >= 32, and the
    reference oracle.  Indices exact; d2 to 1e-6 relative (the interpreter
    may fuse the d2 build into FMAs, the port does not); the oracle's
    float64 distances to 1e-5 absolute."""
    pos = (rng.randn(2, 300, 3) * 3).astype(np.float32)
    ti, td = T.knn(_t(pos), _t(pos), 50)
    assert ti.shape == (2, 300, 50) and td.shape == (2, 300, 50)
    pi, pd = knn_pallas(_j(pos), _j(pos), 50, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(td.numpy(), np.asarray(pd), rtol=1e-6)
    oi, od = oracles.knn_oracle(pos, 50)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_allclose(np.sqrt(td.numpy()), od, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy()[..., 0],
                                  np.broadcast_to(np.arange(300), (2, 300)))


def test_knn_k50_cross_matches_pallas_slab_three_slabs(rng):
    """128 queries against 4,100 keys: `knn_pallas` pads the keys to 4,224
    and then to three 2,048-key slabs, so its merge across slabs runs.
    Exactness as in the self test."""
    keys = (rng.randn(1, 4100, 3) * 3).astype(np.float32)
    query = (rng.randn(1, 128, 3) * 3).astype(np.float32)
    ti, td = T.knn(_t(query), _t(keys), 50)
    pi, pd = knn_pallas(_j(query), _j(keys), 50, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(td.numpy(), np.asarray(pd), rtol=1e-6)
    bi, bd = T.knn_bruteforce_pairwise(_t(query), _t(keys), 50)
    assert torch.equal(bi, ti) and torch.equal(bd, torch.sqrt(td))
    d = np.sqrt(((query[0, :, None].astype(np.float64) - keys[0, None]) ** 2)
                .sum(-1))
    oi = np.argsort(d, axis=-1, kind="stable")[:, :50]
    np.testing.assert_array_equal(ti.numpy()[0], oi)


def test_fps_n9000_matches_pallas(rng):
    """The dso eval size, N=9000 (no multiple of 128), at a small m:
    indices exact against the Pallas FPS in interpret mode."""
    pts = (rng.randn(1, 9000, 3) * 10).astype(np.float32)
    ti = T.farthest_point_sample(_t(pts), 24).numpy()
    np.testing.assert_array_equal(
        ti, np.asarray(fps_pallas(_j(pts), 24, interpret=True)))
    assert len(set(ti[0])) == 24
