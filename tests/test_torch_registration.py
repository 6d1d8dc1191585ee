"""The PyTorch port's registration slice against the JAX package, on the CPU.

`utils/transforms.py`, `eval/registration.py`, `eval/repeatability.py` and
`eval/matlab_extras.py` get the same numpy inputs, made from a seed, as
the JAX functions.  Tolerances:
  - the copied numpy functions (transforms, normals, prec_rec, the pair
    construction): equal, or 1e-9 where the port's kNN tree differs
    (normals: `cKDTree` against sklearn, on clouds without ties);
  - `rigid_transform_3d_batched` against the JAX fit, hypothesis by
    hypothesis: 1e-12 (float64; LAPACK's SVD on both sides, batched here);
  - matching, inlier sets, counts, keypoints and repeatability: equal;
    R and t: 1e-9.
The port's matching computes float64 distances, the JAX one float32: the
fixtures keep every nearest and second-nearest distance apart by more
than float32 rounding (checked).  The port's NMS is `device_nms` (float32),
the JAX repeatability's the host `single_nms` (float64): the fixtures keep
no neighbour distance within 1e-5 of the 0.5 m radius (checked).
A collinear or repeated triplet has no unique rotation; the fixtures'
random triplets are neither, so every fit is unique.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dh3d_tpu.eval import matlab_extras as jmx
from dh3d_tpu.eval import registration as jreg
from dh3d_tpu.eval import repeatability as jrep
from dh3d_tpu.utils import transforms as J
from dh3d_tpu_torch.eval import matlab_extras as tmx
from dh3d_tpu_torch.eval import registration as treg
from dh3d_tpu_torch.eval import repeatability as trep
from dh3d_tpu_torch.utils import transforms as T

CPU = "cpu"
RT_TOL = 1e-9


# ------------------------------- transforms -------------------------------

@pytest.mark.parametrize("axes", sorted(J._AXES2TUPLE))
def test_euler_matrix_and_back_match_jax(axes):
    """All 24 conventions: the matrix, the angles back, and the round trip
    (`tests/test_eval.py:331-341`)."""
    rng = np.random.RandomState(sorted(J._AXES2TUPLE).index(axes))
    angles = (4 * np.pi) * (rng.rand(3) - 0.5)
    R = T.euler_matrix(*angles, axes=axes)
    np.testing.assert_array_equal(R, J.euler_matrix(*angles, axes=axes))
    back = T.euler_from_matrix(R, axes)
    assert back == J.euler_from_matrix(R, axes)
    np.testing.assert_allclose(T.euler_matrix(*back, axes=axes), R,
                               atol=1e-10)
    # a convention given as its tuple
    tup = J._AXES2TUPLE[axes]
    assert T.euler_from_matrix(R, tup) == J.euler_from_matrix(R, tup)


def test_euler_gimbal_lock_and_bad_axes_match_jax():
    for ang, axes in (((0.3, np.pi / 2, 0.7), "sxyz"),
                      ((0.4, 0.0, -0.2), "sxyx")):
        R = T.euler_matrix(*ang, axes=axes)
        assert T.euler_from_matrix(R, axes) == J.euler_from_matrix(R, axes)
    for fn in (T.euler_matrix, J.euler_matrix):
        with pytest.raises(KeyError):
            fn(0.1, 0.2, 0.3, axes=(3, 0, 0, 0))


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        rand = rng.rand(3)
        np.testing.assert_array_equal(T.random_quaternion(rand),
                                      J.random_quaternion(rand))
        R = T.random_rotation_matrix(rand)
        np.testing.assert_array_equal(R, J.random_rotation_matrix(rand))
        for fn in ("quaternion_from_matrix", "quaternion_from_matrix_precise"):
            np.testing.assert_array_equal(getattr(T, fn)(R),
                                          getattr(J, fn)(R))
        q = T.quaternion_from_matrix(R)
        np.testing.assert_array_equal(T.quaternion_matrix(q),
                                      J.quaternion_matrix(q))
    np.testing.assert_array_equal(T.quaternion_matrix(np.zeros(4)),
                                  J.quaternion_matrix(np.zeros(4)))
    np.testing.assert_array_equal(
        T.random_quaternion(rng=np.random.default_rng(7)),
        J.random_quaternion(rng=np.random.default_rng(7)))
    np.testing.assert_array_equal(
        T.random_rotation_matrix(rng=np.random.RandomState(2)),
        J.random_rotation_matrix(rng=np.random.RandomState(2)))


def test_errors_and_homogeneous_helpers_match_jax():
    rng = np.random.RandomState(4)
    R1 = J.random_rotation_matrix(rng.rand(3))[:3, :3]
    R2 = J.random_rotation_matrix(rng.rand(3))[:3, :3]
    t1, t2 = rng.randn(3), rng.randn(3)
    for fn in ("rotation_error_deg", "angle_error1", "angle_error2"):
        assert getattr(T, fn)(R1, R2) == getattr(J, fn)(R1, R2)
    assert T.translation_error(t1, t2) == J.translation_error(t1, t2)
    assert T.evaluate_R_t(R1, t1, R2, t2) == J.evaluate_R_t(R1, t1, R2, t2)
    H = T.to_homogeneous(R1, t1)
    np.testing.assert_array_equal(H, J.to_homogeneous(R1, t1))
    pts = rng.randn(20, 3)
    np.testing.assert_array_equal(T.apply_transform(pts, H),
                                  J.apply_transform(pts, H))
    v = rng.rand(6, 5, 3)
    for axis in (1, -1):
        np.testing.assert_array_equal(T.vector_norm(v, axis=axis),
                                      J.vector_norm(v, axis=axis))
        got, want = np.empty((6, 3)), np.empty((6, 3))
        T.vector_norm(v, axis=1, out=got)
        J.vector_norm(v, axis=1, out=want)
        np.testing.assert_array_equal(got, want)
    assert T.vector_norm(v[0, 0]) == J.vector_norm(v[0, 0])
    assert T.vector_norm([]) == J.vector_norm([]) == 0.0


def _motion(rng, n, outliers=0.4, noise=0.05):
    """xyz1 = xyz2 @ R.T + t + noise, with `outliers` of xyz1 redrawn."""
    xyz2 = rng.randn(n, 3) * 10
    R = J.random_rotation_matrix(rng.rand(3))[:3, :3]
    t = rng.uniform(-5, 5, 3)
    xyz1 = xyz2 @ R.T + t + rng.randn(n, 3) * noise
    bad = rng.rand(n) < outliers
    xyz1[bad] = rng.randn(int(bad.sum()), 3) * 10
    return xyz1.astype(np.float32), xyz2.astype(np.float32), R, t


def test_rigid_transform_matches_jax():
    rng = np.random.RandomState(5)
    A, B, _, _ = _motion(rng, 40, outliers=0.0)
    for got, want in zip(T.rigid_transform_3d(A, B),
                         J.rigid_transform_3d(A, B)):
        np.testing.assert_array_equal(got, want)


def test_rigid_transform_batched_matches_jax_fit_by_fit():
    """Random triplets (the RANSAC hypotheses), larger sets, a reflection
    case, and a triplet with a NaN, which numpy refuses (LinAlgError) and
    the batched fit flags."""
    rng = np.random.RandomState(6)
    xyz1, xyz2, _, _ = _motion(rng, 50)
    sel = np.stack([rng.choice(50, 3, replace=False) for _ in range(200)])
    A, B = xyz1[sel].astype(np.float64), xyz2[sel].astype(np.float64)
    A[17, 1, 2] = np.nan
    A[18] = -B[18]  # a point reflection: d = -1
    R, t, ok = T.rigid_transform_3d_batched(torch.from_numpy(A),
                                            torch.from_numpy(B))
    assert R.dtype == t.dtype == torch.float64
    assert ok.tolist() == [i != 17 for i in range(200)]
    with pytest.raises(np.linalg.LinAlgError):
        J.rigid_transform_3d(A[17], B[17])
    for i in range(200):
        if i == 17:
            continue
        Rj, tj = J.rigid_transform_3d(A[i], B[i])
        np.testing.assert_allclose(R[i].numpy(), Rj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(t[i].numpy(), tj, rtol=0, atol=1e-12)
    # whole sets, float32 inputs
    R, t, ok = T.rigid_transform_3d_batched(torch.from_numpy(xyz1[None]),
                                            torch.from_numpy(xyz2[None]))
    Rj, tj = J.rigid_transform_3d(xyz1, xyz2)
    assert bool(ok[0])
    np.testing.assert_allclose(R[0].numpy(), Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[0].numpy(), tj, rtol=0, atol=1e-12)


# ------------------------------ registration ------------------------------

def _nn_margin(d):
    """The smallest gap between the nearest and second-nearest distance
    over every row and every column of d."""
    rows = np.sort(d, axis=1)[:, :2]
    cols = np.sort(d, axis=0)[:2]
    return min((rows[:, 1] - rows[:, 0]).min(), (cols[1] - cols[0]).min())


def _descriptors(rng, n, dim=16):
    d = rng.randn(n, dim).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_descriptors_mutual_matches_jax(seed):
    """Two descriptor sets, the second partly a noisy copy of the first
    (so that there are mutual pairs besides chance ones)."""
    rng = np.random.RandomState(seed)
    d1 = _descriptors(rng, 90)
    d2 = np.concatenate([d1[:40] + rng.randn(40, 16).astype(np.float32)
                         * 0.05, _descriptors(rng, 70)])
    d = np.linalg.norm(d1[:, None].astype(np.float64) - d2[None], axis=-1)
    assert _nn_margin(d) > 1e-5  # far above float32 rounding of ~1e-7
    want = jreg.match_descriptors_mutual(d1, d2)
    got = treg.match_descriptors_mutual(d1, d2, device=CPU)
    assert got.dtype == torch.int64 and len(want) >= 30
    np.testing.assert_array_equal(got.numpy(), want)
    # tensors in, and a set matched with itself
    got = treg.match_descriptors_mutual(torch.from_numpy(d1),
                                        torch.from_numpy(d1), device=CPU)
    np.testing.assert_array_equal(got.numpy(),
                                  jreg.match_descriptors_mutual(d1, d1))


def test_match_descriptors_mutual_takes_the_first_of_equal_rows():
    """Exact duplicates tie: the first index wins both ways, as np.argmin."""
    rng = np.random.RandomState(3)
    d1 = _descriptors(rng, 20)
    d1[7] = d1[3]
    d2 = d1[rng.permutation(20)]
    want = jreg.match_descriptors_mutual(d1, d2)
    np.testing.assert_array_equal(
        treg.match_descriptors_mutual(d1, d2, device=CPU).numpy(), want)
    assert 7 not in want[:, 0]


def _same_result(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.num_inliers == want.num_inliers
    assert got.num_matches == want.num_matches
    np.testing.assert_array_equal(got.inliers, want.inliers)
    np.testing.assert_allclose(got.R, want.R, rtol=0, atol=RT_TOL)
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=RT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_rigid_matches_jax(seed):
    """40% outliers: the same hypotheses from the same draws, the same
    winner, inlier set and refit."""
    xyz1, xyz2, _, _ = _motion(np.random.RandomState(10 + seed), 120)
    want = jreg.ransac_rigid(xyz1, xyz2, iters=300, seed=seed)
    got = treg.ransac_rigid(xyz1, xyz2, iters=300, seed=seed, device=CPU)
    assert want is not None and want.num_inliers > 50
    _same_result(got, want)
    # the residuals of the refit stay clear of the threshold
    resid = np.linalg.norm(xyz2 @ want.R.T + want.t - xyz1, axis=1)
    assert np.abs(resid - 1.0).min() > 1e-6


def test_ransac_rigid_draws_are_the_jax_loops():
    rng = np.random.RandomState(9)
    want = np.stack([rng.choice(57, 3, replace=False) for _ in range(40)])
    np.testing.assert_array_equal(treg.ransac_draws(57, 40, 9), want)


def test_ransac_rigid_skips_a_nan_correspondence_as_jax():
    """A NaN point: every hypothesis that draws it is skipped (numpy's SVD
    raises), and it is never an inlier."""
    xyz1, xyz2, _, _ = _motion(np.random.RandomState(20), 30)
    xyz1[4, 0] = np.nan
    for seed in (0, 5):
        want = jreg.ransac_rigid(xyz1, xyz2, iters=200, seed=seed)
        got = treg.ransac_rigid(xyz1, xyz2, iters=200, seed=seed, device=CPU)
        _same_result(got, want)
        assert not got.inliers[4]
    # every hypothesis skipped: None on both sides
    xyz1[:] = np.nan
    assert jreg.ransac_rigid(xyz1, xyz2, iters=20) is None
    assert treg.ransac_rigid(xyz1, xyz2, iters=20, device=CPU) is None


def test_ransac_rigid_returns_none_where_jax_does():
    xyz1, xyz2, _, _ = _motion(np.random.RandomState(21), 30, outliers=0.9)
    for a, b, kw in ((xyz1[:2], xyz2[:2], {}),             # M < 3
                     (xyz1, xyz2, {"min_inliers": 31}),    # too few
                     (xyz1[:3], xyz2[:3], {})):            # M == 3
        want = jreg.ransac_rigid(a, b, iters=50, **kw)
        _same_result(treg.ransac_rigid(a, b, iters=50, device=CPU, **kw),
                     want)
    assert jreg.ransac_rigid(xyz1, xyz2, iters=50, min_inliers=31) is None


def test_register_clouds_and_success_match_jax():
    """Keypoints of a cloud and of a moved copy, with descriptors of the
    copy perturbed and 30% of them redrawn."""
    rng = np.random.RandomState(22)
    kp1, kp2, R, t = _motion(rng, 80, outliers=0.0, noise=0.02)
    d1 = _descriptors(rng, 80)
    d2 = d1 + rng.randn(80, 16).astype(np.float32) * 0.05
    redraw = rng.rand(80) < 0.3
    d2[redraw] = _descriptors(rng, int(redraw.sum()))
    d = np.linalg.norm(d1[:, None].astype(np.float64) - d2[None], axis=-1)
    assert _nn_margin(d) > 1e-5
    for seed in (0, 3):
        want = jreg.register_clouds(kp1, d1, kp2, d2, iters=200, seed=seed)
        got = treg.register_clouds(kp1, d1, kp2, d2, iters=200, seed=seed,
                                   device=CPU)
        _same_result(got, want)
        assert treg.registration_success(want.R, want.t, R, t) == \
            jreg.registration_success(want.R, want.t, R, t)
        ok, rte, rre = treg.registration_success(got.R, got.t, R, t)
        _, rte_j, rre_j = jreg.registration_success(want.R, want.t, R, t)
        assert ok and abs(rte - rte_j) < RT_TOL and abs(rre - rre_j) < 1e-6
    # fewer than 3 matches
    assert treg.register_clouds(kp1[:2], d1[:2], kp2[:2], d2[:2],
                                device=CPU) is None
    assert jreg.register_clouds(kp1[:2], d1[:2], kp2[:2], d2[:2]) is None


# ------------------------------ repeatability ------------------------------

def _density_extract(cloud):
    """A rigid-invariant detector (`tests/test_eval.py:254`): attention is
    the local density, 1 / the 9th neighbour's distance (cKDTree, on both
    sides)."""
    cloud = np.asarray(cloud)
    dist, _ = cKDTree(cloud).query(cloud, k=9)
    att = 1.0 / (1e-3 + dist[:, -1])
    return cloud, (att / att.max()).astype(np.float32)


def _clear_of_radius(cloud):
    d, _ = cKDTree(np.asarray(cloud, np.float64)).query(cloud, k=50)
    return np.abs(d - 0.5).min() > 1e-5 and np.abs(d[:, 7] - 2.0).min() > 1e-5


def _base_clouds(n, seed=30):
    rng = np.random.RandomState(seed)
    return [(rng.randn(1500, 3) * np.array([4, 4, 1])).astype(np.float32)
            for _ in range(n)]


def test_keypoint_repeatability_matches_jax():
    rng = np.random.RandomState(31)
    kp1 = rng.randn(60, 3) * 3
    R = J.random_rotation_matrix(rng.rand(3))[:3, :3]
    t = rng.randn(3)
    kp2 = (kp1 @ R.T + t + rng.randn(60, 3) * 0.3)[rng.permutation(60)[:45]]
    for args in ((kp1, kp2, R, t), (kp1, kp1 + 0.3), (kp1, kp2[:0], R, t)):
        for radius in (0.25, 0.5):
            want = jrep.keypoint_repeatability(*args, radius=radius)
            got = trep.keypoint_repeatability(*args, radius=radius,
                                              device=CPU)
            assert got == want
    assert 0 < trep.keypoint_repeatability(kp1, kp2, R, t, device=CPU) < 1
    got = trep.keypoint_repeatability(torch.from_numpy(kp1),
                                      torch.from_numpy(kp2), R, t)
    assert got == jrep.keypoint_repeatability(kp1, kp2, R, t)


def test_top_k_keypoints_matches_jax():
    cloud = _base_clouds(1)[0]
    assert _clear_of_radius(cloud)
    xyz, att = _density_extract(cloud)
    for k in (8, 64, 1500):
        want = jrep.top_k_keypoints(xyz, att, k)
        got = trep.top_k_keypoints(xyz, att, k, device=CPU)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    assert 64 < len(want) < 1500  # NMS leaves fewer than the largest k


def test_repeatability_curve_matches_jax():
    clouds = _base_clouds(2)
    ks = (8, 32, 64, 512)
    # the moved copies the curve draws, clear of the radius too
    rng = np.random.RandomState(0)
    for c in clouds:
        ang = rng.uniform(-np.pi, np.pi)
        cs, sn = np.cos(ang), np.sin(ang)
        R = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
        t = rng.uniform(-2, 2, 3)
        c2 = (c @ R.T + t + rng.randn(*c.shape) * 0.02).astype(np.float32)
        assert _clear_of_radius(c) and _clear_of_radius(c2)
    want = jrep.repeatability_curve(_density_extract, clouds, ks=ks)
    got = trep.repeatability_curve(_density_extract, clouds, ks=ks,
                                   device=CPU)
    assert got == want and set(got) == set(ks)
    assert got[32] > 0.2


def test_partial_overlap_pairs_and_curve_match_jax():
    base = _base_clouds(2, seed=32) + [np.zeros((10, 3), np.float32)]
    want = jrep.make_partial_overlap_pairs(base, numpts=1024, keep=0.85,
                                           jitter=0.005, seed=1)
    got = trep.make_partial_overlap_pairs(base, numpts=1024, keep=0.85,
                                          jitter=0.005, seed=1)
    assert len(got) == len(want) == 2  # the 10-point cloud is skipped
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for c1, c2, _, _ in got:
        assert _clear_of_radius(c1) and _clear_of_radius(c2)
    ks = (32, 64)
    want_c = jrep.repeatability_curve_pairs(_density_extract, want, ks=ks,
                                            radius=1.0)
    got_c = trep.repeatability_curve_pairs(_density_extract, got, ks=ks,
                                           radius=1.0, device=CPU)
    assert got_c == want_c
    assert got_c[32] > 0.3


# ------------------------------ matlab extras ------------------------------

@pytest.mark.parametrize("dir_largest", [True, False])
def test_find_point_normals_matches_jax(dir_largest):
    """A noisy tilted plane and a random blob, both without equal
    neighbour distances (sklearn and cKDTree may order those apart)."""
    rng = np.random.RandomState(40)
    n_true = np.array([1.0, 2.0, 2.0]) / 3.0
    basis = np.linalg.svd(n_true[None])[2][1:]
    clouds = [rng.randn(300, 2) * 5 @ basis + rng.randn(300, 3) * 1e-3,
              rng.randn(200, 3)]
    for pts in clouds:
        d, _ = cKDTree(pts).query(pts, k=11)
        assert np.diff(d, axis=1).min() > 1e-9  # no ties among neighbours
        for view in ((0, 0, 100), (3, -2, 1)):
            want = jmx.find_point_normals(pts, view_point=view,
                                          dir_largest=dir_largest)
            got = tmx.find_point_normals(pts, view_point=view,
                                         dir_largest=dir_largest)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    # fewer points than neighbours asked for
    small = clouds[1][:5]
    for g, w in zip(tmx.find_point_normals(small, num_neighbours=9),
                    jmx.find_point_normals(small, num_neighbours=9)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_prec_rec_matches_jax():
    rng = np.random.RandomState(41)
    score = np.concatenate([rng.rand(100) + 0.5, rng.rand(100)])
    target = np.concatenate([np.ones(100), np.zeros(100)])
    counts = rng.randint(1, 4, 200)
    cases = [((score, target), {}), ((score, target), {"num_thresh": 7}),
             ((np.round(score, 1), target), {}),
             ((score, target * counts), {"instance_count": counts})]
    for args, kw in cases:
        for g, w in zip(tmx.prec_rec(*args, **kw), jmx.prec_rec(*args, **kw)):
            np.testing.assert_array_equal(g, w)
    for fn in (tmx.prec_rec, jmx.prec_rec):
        with pytest.raises(ValueError, match="binary"):
            fn(score, target * 2)
