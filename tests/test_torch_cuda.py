"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; every test takes the `device` fixture, which skips when
there is no CUDA device (decided when the test runs, never at import, so
that every test worker collects the same tests).  Run on a card with
`python -m pytest tests/test_torch_cuda.py -m cuda -q`.

Shapes are small versions of the main path's (N not a multiple of
anything, to exercise the ragged edges), but for FPS at the path's and the
eval's sizes.  Kernels G and B also run at every launch plan they take
(G's merge, `plan=`, also forced at A's k; B's blocks a cloud and threads
a block, `plan=`), on clouds with exact duplicates and on integer grids,
G also on clouds padded with the eval loader's 1e5 sentinels.
kNN (kernels A and G) and FPS must equal their plain versions exactly
(both build d2 from the same rounded terms), at every plan and on a
second run;
neighbour max, its ids and its slot exactly, NaNs included, at every
launch plan (`plan=`: channels a thread, lanes a row, passes); weighted
sums at every plan and both backwards to 1e-5 relative (FMA accumulation
in the kernels, batched matmuls and atomic scatters in the plain
versions), and every plan of a weighted sum gives the same bits, which
are also `flex_moments`' on the positions.  The backwards also run at the
train step's own shapes, where they must give the same bits with the CSR
inverse shared and built in the call, and on a second run.  The
train step on the card is held to the CPU's at the limits of
`tests/test_torch_cuda_paths.py` (TRAIN_*; see there).  Kernel H (the
Morton band's kNN, `knn_window`) must equal its plain version exactly,
self and cross, at each list length it compiles and at every launch plan
(lanes a query, `plan=`), on random, integer-grid and duplicated clouds,
at the band's edges and with NaN rows; its entry point refuses sizes
itself; the legacy forward launches it once and matches the CPU's.
Kernel I (the loader's radius count) must equal its plain version
exactly on the CPU tests' cases (`test_torch_radius.py`)
and on a raw scan at the extraction's size, at every split, and there
also `cKDTree`; the eval loader on the card launches it once a cloud and
yields the clouds of the `cKDTree` path, and it does not wait for work
queued on the default stream.  Kernel J (train-mode BatchNorm with a
fused relu) is held to the layer's plain code at the train steps' shapes
(both against the plain code in float64), gives the same bits twice,
recomputes the forward's relu mask bit for bit in the backward, leaves
the running statistics alone when told to, and launches once a pass for
each train-mode BatchNorm of a step, never in an eval forward.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch
from test_torch_radius import RADIUS_CASES, radius_case

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T

knn_ops = importlib.import_module("dh3d_tpu_torch.ops.knn")

pytestmark = pytest.mark.cuda

B, N, M, K = 3, 1000, 130, 8


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def cloud(device):
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randn(B, N, 3).astype(np.float32) * 30).to(device)


def _counted(kernel, fn, *args, **kwargs):
    before = kernel.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


def _close(a, ref, rel=1e-5):
    err = (a - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), err


def _knn_kernel(k):
    """The kernel `knn` launches at k: A up to k = 7, G above."""
    return kernels.KNN if k <= knn_ops.MAX_K else kernels.KNN_TOPK


@pytest.mark.parametrize("k", [1, 3, 8, 16, 32])
def test_knn_self_equals_plain(cloud, k):
    idx, d2 = _counted(_knn_kernel(k), T.knn, cloud, cloud, k)
    pidx, pd2 = T.knn_plain(cloud, cloud, k)
    assert torch.equal(idx, pidx)
    assert torch.equal(d2, pd2)
    assert torch.equal(idx[..., 0].cpu(), torch.arange(N).expand(B, N))


def test_knn_cross_equals_plain(cloud):
    keys = cloud[:, :M].contiguous() * 1.01
    d2, idx = _counted(kernels.KNN, T.three_nn, cloud, keys)
    pidx, pd2 = T.knn_plain(cloud, keys, 3)
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2)


def test_knn_duplicates_lower_twin_first(device):
    pos = torch.randn(1, 300, 3)
    pos[0, 200:250] = pos[0, 0:50]
    idx, d2 = T.knn(pos.to(device), pos.to(device), 4)
    pidx, pd2 = T.knn_plain(pos, pos, 4)
    assert torch.equal(idx.cpu(), pidx) and torch.equal(d2.cpu(), pd2)


def test_fps_equals_plain(cloud):
    idx = _counted(kernels.FPS, T.farthest_point_sample, cloud, 125)
    assert torch.equal(idx, T.fps_plain(cloud, 125))


@pytest.mark.parametrize("n", ["one block + 1", 16384, 65536])
def test_fps_beyond_one_block_equals_plain(device, n):
    """Clouds that do not fit one block's registers and shared memory take
    a cluster: the smallest such N, the lidar eval size, and 65,536."""
    if n == "one block + 1":
        n = kernels.fps_max_points(device, 1) + 1
    assert kernels.fps_max_points(device) >= 65536
    g = torch.Generator().manual_seed(n)
    pts = (torch.randn(2, n, 3, generator=g) * 30).to(device)
    m = 2048 if n == 16384 else 200
    idx = _counted(kernels.FPS, T.farthest_point_sample, pts, m)
    assert torch.equal(idx, T.fps_plain(pts, m))


@pytest.mark.parametrize("k", [1, 3, 7, 8, 16, 32])
@pytest.mark.parametrize("cloud_kind", ["normal", "grid", "few keys"])
def test_knn_every_plan_equals_plain(device, k, cloud_kind):
    """`knn`'s own kernel (A to k = 7, G above) and G forced at each merge
    equal the plain version bit for bit: on a normal cloud with exact
    duplicate keys, on an integer grid (many equal distances), and on 100
    keys (Nk < 256); two runs give the same bits."""
    g = torch.Generator().manual_seed(k)
    if cloud_kind == "grid":
        keys = torch.randint(0, 6, (2, 700, 3), generator=g).float()
    else:
        keys = torch.randn(2, 100 if cloud_kind == "few keys" else 700, 3,
                           generator=g) * 5
        keys[:, 60:80] = keys[:, 20:40]  # duplicate keys
    query = torch.cat([keys[:, :90], torch.randn(2, 287, 3, generator=g)],
                      1).contiguous()  # Nq = 377: ragged blocks
    pidx, pd2 = T.knn_plain(query, keys, k)
    qd, kd = query.to(device), keys.to(device)
    for plan, kernel in ((None, _knn_kernel(k)), (0, kernels.KNN_TOPK),
                         (1, kernels.KNN_TOPK)):
        idx, d2 = _counted(kernel, T.knn, qd, kd, k, plan=plan)
        assert torch.equal(idx.cpu(), pidx), plan
        assert torch.equal(d2.cpu(), pd2), plan
        again = T.knn(qd, kd, k, plan=plan)
        assert torch.equal(again[0], idx) and torch.equal(again[1], d2)


def test_knn_refuses_a_plan_it_does_not_take(cloud):
    """A's entry point refuses k above 7 and above Nk, G's a merge other
    than 0 or 1; the launch raises ValueError without counting a launch."""
    before = kernels.counts()
    idx = torch.empty(B, N, 8, dtype=torch.int64, device=cloud.device)
    d2 = torch.empty(B, N, 8, device=cloud.device)
    for k, nk in ((8, N), (3, 2)):
        with pytest.raises(ValueError, match="invalid argument"):
            kernels.KNN.launch(cloud.device, cloud.data_ptr(),
                               cloud.data_ptr(), idx.data_ptr(),
                               d2.data_ptr(), B, N, nk, k)
    for plan in (2, -1):
        with pytest.raises(ValueError, match="invalid argument"):
            T.knn(cloud, cloud, 50, plan=plan)
    assert kernels.counts() == before


# FPS at the shapes of the forward, the lidar and dso eval sizes and a
# large cloud
FPS_SHAPES = [(20, 8192, 1024), (1, 16384, 2048), (1, 9000, 1125),
              (1, 40000, 5000)]


@pytest.mark.parametrize("b,n,m", FPS_SHAPES)
def test_fps_every_cluster_equals_plain(device, b, n, m):
    """Kernel B with C = 1, 2, 4, 8 blocks a cloud of 128, 256 or 1024
    threads equals the plain version, twice; a cluster of more than 32
    warps, or blocks that cannot hold the cloud, raise."""
    g = torch.Generator().manual_seed(n)
    pts = (torch.randn(b, n, 3, generator=g) * 30).to(device)
    ref = T.fps_plain(pts, m)
    for c in (1, 2, 4, 8):
        for t in (128, 256, 1024):
            if c > 1 and c * t // 32 > 32:
                with pytest.raises(ValueError, match="invalid argument"):
                    T.farthest_point_sample(pts, m, plan=(c, t))
                continue
            if n > kernels.fps_max_points(device, c, t):
                with pytest.raises(ValueError, match="invalid argument"):
                    T.farthest_point_sample(pts, m, plan=(c, t))
                continue
            idx = _counted(kernels.FPS, T.farthest_point_sample, pts, m,
                           plan=(c, t))
            assert torch.equal(idx, ref), (c, t)
            assert torch.equal(T.farthest_point_sample(pts, m, plan=(c, t)),
                               idx)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_fps_one_point_and_integer_grid(device, c):
    """N = m = 1 at every C (blocks without points); an integer-grid cloud
    of 3000 points on 512 positions sampled to 600, so that minds of +0
    (duplicates of picked points) tie, at 96 and 128 threads."""
    one = torch.zeros(1, 1, 3, device=device)
    assert T.farthest_point_sample(one, 1, plan=(c, 128)).tolist() == [[0]]
    g = torch.Generator().manual_seed(c)
    grid = torch.randint(0, 8, (2, 3000, 3), generator=g).float().to(device)
    ref = T.fps_plain(grid, 600)
    for t in (96, 128):
        idx = _counted(kernels.FPS, T.farthest_point_sample, grid, 600,
                       plan=(c, t))
        assert torch.equal(idx, ref), t


# Kernel G's inputs: (kind, what it tests)
TOPK_KINDS = {
    "duplicates": "exact duplicates across chunk boundaries",
    "grid": "an integer grid: many equal distances at the k-th slot",
    "padded": "an undersized cloud padded with 1e5 sentinels",
    "mostly padded": "pads above and among the k nearest",
    "outlier": "one far point stretching the keys' box",
    "morton": "keys already in Morton order",
    "ragged": "Nk not a multiple of any chunk",
    "nk == k": "exactly k keys",
}


def _topk_cloud(kind, k, g):
    """[2, N, 3] keys on the CPU for one of TOPK_KINDS."""
    if kind == "grid":
        return torch.randint(0, 8, (2, 1500, 3), generator=g).float()
    n = {"ragged": 1000 + 17, "nk == k": k}.get(kind, 1500)
    pos = torch.randn(2, n, 3, generator=g) * 5
    if kind == "duplicates":
        pos[:, 1000:1100] = pos[:, 0:100]
        pos[:, 31:97:2] = pos[:, 1200:1233]  # twins in other chunks
    elif kind == "padded":
        pos[:, 1200:] = 1e5  # `get_fixednum_pcd`'s sentinel rows
    elif kind == "mostly padded":
        pos[:, 100:] = 1e5
    elif kind == "outlier":
        pos[:, 333] = torch.tensor([-4e4, 3e4, 2e3])
    elif kind == "morton":
        perm, _ = T.morton_perm(pos)
        pos = torch.gather(pos, 1, perm[..., None].expand(-1, -1, 3))
    return pos.contiguous()


def _same_topk_every_plan(query, keys, k, self_query=False):
    """Kernel G at every plan it takes (its own and each merge forced)
    equals the plain version bit for bit, on two runs."""
    pidx, pd2 = T.knn_plain(query.cpu(), keys.cpu(), k)
    if self_query:
        keys = query
    for plan in (None, 0, 1):
        if plan is None and k <= knn_ops.MAX_K:
            continue  # kernel A's k
        idx, d2 = _counted(kernels.KNN_TOPK, T.knn, query, keys, k,
                           plan=plan)
        assert torch.equal(idx.cpu(), pidx), plan
        assert torch.equal(d2.cpu(), pd2), plan
        again = T.knn(query, keys, k, plan=plan)
        assert torch.equal(again[0], idx) and torch.equal(again[1], d2), plan
    return pidx


@pytest.mark.parametrize("kind", sorted(TOPK_KINDS))
@pytest.mark.parametrize("k", [1, 8, 16, 33, 50, 64, 128])
def test_knn_topk_self_equals_plain(device, k, kind):
    """Kernel G, self queries, at every plan: bit for bit equal to the
    plain version on each kind of cloud; a point without a lower twin is
    its own first neighbour."""
    g = torch.Generator().manual_seed(k)
    pos = _topk_cloud(kind, k, g)
    pidx = _same_topk_every_plan(pos.to(device), pos.to(device), k,
                                 self_query=True)
    own = pidx[:, :, 0] == torch.arange(pos.shape[1])
    if kind in ("ragged", "morton", "outlier"):
        assert own.all()
    elif kind == "duplicates":  # 1000 + 2i is the twin of 2i
        assert own[:, :1000].all() and not own[:, 1000:1100:2].any()


@pytest.mark.parametrize("kind", ["duplicates", "grid", "padded", "ragged",
                                  "outlier"])
@pytest.mark.parametrize("k", [16, 33, 50, 128])
def test_knn_topk_cross_equals_plain(device, k, kind):
    """Kernel G, queries apart from the keys (some on duplicated keys,
    some outside the keys' box), B = 2, at every plan."""
    g = torch.Generator().manual_seed(100 + k)
    keys = _topk_cloud(kind, k, g)
    query = torch.randn(2, 333, 3, generator=g) * 6
    query[:, :20] = keys[:, 10:30]  # on (duplicated) keys
    query[:, 20:30] *= 10  # beyond the keys' box
    _same_topk_every_plan(query.contiguous().to(device), keys.to(device), k)


@pytest.mark.parametrize("n_points,k", [(30000, 50), (12000, 50),
                                        (12000, 8)])
def test_knn_topk_eval_cloud_equals_plain(device, n_points, k):
    """G at keypoint NMS's call (self k=50) and the extraction forward's
    (k=8) on a lidar-like scan through the eval loader (loader order,
    N=16384), bit for bit: a full scan, and one the loader pads with 1e5
    sentinels."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan

    cloud, real = get_fixednum_pcd(lidar_like_scan(0, n_points=n_points),
                                   16384, randsample=False,
                                   need_downsample=True,
                                   rng=np.random.RandomState(0))
    assert (real < 16384) == (n_points < 30000)
    pos = torch.from_numpy(cloud)[None]
    idx, d2 = _counted(kernels.KNN_TOPK, T.knn, pos.to(device),
                       pos.to(device), k)
    pidx, pd2 = T.knn_plain(pos, pos, k)
    assert torch.equal(idx.cpu(), pidx) and torch.equal(d2.cpu(), pd2)


def test_nms_launches_kernel_g_once(device):
    """`device_nms` on the card: one launch of G a cloud, and the
    keypoints of the CPU's NMS."""
    from dh3d_tpu_torch.eval import device_nms

    g = np.random.RandomState(3)
    xyz = (g.randn(3000, 3) * 5).astype(np.float32)
    att = g.rand(3000).astype(np.float32)
    before = kernels.KNN_TOPK.launches
    n, kp = device_nms(xyz, att, 0.5, 0.01, 512, device=device)
    torch.cuda.synchronize()
    assert kernels.KNN_TOPK.launches == before + 1
    n_cpu, kp_cpu = device_nms(xyz, att, 0.5, 0.01, 512, device="cpu")
    assert n == n_cpu and np.array_equal(kp, kp_cpu)


@pytest.mark.parametrize("kind", ["normal", "padded"])
def test_topk_prepass_sorts_into_chunks(device, kind):
    """G's pre-pass: the table holds every key once with its index, and
    each chunk's box is the tight box of its keys (the last chunk's of its
    real keys only), with their lowest index."""
    g = torch.Generator().manual_seed(len(kind))
    keys = torch.randn(2, 1000, 3, generator=g) * 5
    if kind == "padded":
        keys[:, 700:] = 1e5
    keys = keys.to(device)
    table, boxes = T.topk_prepass(keys, keys)
    ids = table[..., 3].contiguous().view(torch.int32).long()
    assert torch.equal(ids.sort(-1).values.cpu(),
                       torch.arange(1000).expand(2, -1))
    assert torch.equal(table[..., :3], torch.gather(
        keys, 1, ids[..., None].expand(-1, -1, 3)))
    low = boxes[:, :, 0, 3].contiguous().view(torch.int32).long()
    for c in range(boxes.shape[1]):
        part = table[:, c * 32:(c + 1) * 32, :3]
        assert torch.equal(boxes[:, c, 0, :3], part.amin(1))
        assert torch.equal(boxes[:, c, 1, :3], part.amax(1))
        assert torch.equal(low[:, c], ids[:, c * 32:(c + 1) * 32].amin(1))


def test_knn_above_kernel_g_limit_raises(cloud):
    with pytest.raises(ValueError, match="k <= 128"):
        T.knn(cloud, cloud, 129)


@pytest.mark.parametrize("P,C,rows,keys_n,k", [
    (1, 3, N, N, K),        # conv_pointset on raw xyz
    (4, 64, N, N, K),       # flex-conv moments
    (1, 256, N, M, 3),      # three_interpolate, N != M
    (2, 33, N, N, 16),      # odd widths
])
def test_weighted_sum_equals_plain(device, P, C, rows, keys_n, k):
    g = torch.Generator().manual_seed(P * 1000 + C)
    feat = torch.randn(B, keys_n, C, generator=g).to(device)
    nbh = torch.randint(0, keys_n, (B, rows, k), generator=g).to(device)
    w = torch.randn(B, rows, k, P, generator=g).to(device)
    out = _counted(kernels.WEIGHTED_SUM, T.weighted_sum, feat, nbh, w)
    _close(out, T.weighted_sum_plain(feat, nbh, w))


@pytest.mark.parametrize("C", [3, 64, 130])
def test_neighbor_max_equals_plain(device, C):
    g = torch.Generator().manual_seed(C)
    # integer-valued features: most maxima tie, testing the lowest-k rule
    feat = torch.randint(0, 4, (B, N, C), generator=g).float().to(device)
    nbh = torch.randint(0, N, (B, N, K), generator=g).to(device)
    val, arg = _counted(kernels.NEIGHBOR_MAX, T.neighbor_max, feat, nbh)
    pval, parg, pslot = T.neighbor_max_plain(feat, nbh)
    assert torch.equal(val, pval) and torch.equal(arg, parg)
    val, arg, slot = _counted(kernels.NEIGHBOR_MAX, T.neighbor_max_with_slot,
                              feat, nbh)
    assert torch.equal(val, pval) and torch.equal(arg, parg)
    assert slot.dtype == torch.int8 and torch.equal(slot, pslot)


def row_plans(C, K):
    """`row_plan`'s plan and every other plan the entry points take for C
    channels: each vector width that divides C at every group size."""
    plans = {T.row_plan(C, K)}
    for vec in (1, 2, 4):
        if C % vec == 0:
            plans |= {(vec, lanes, -(-C // (vec * lanes)))
                      for lanes in (1, 2, 4, 8, 16, 32)}
    return sorted(plans)


def same_max(val, ref):
    """Bit for bit, NaN positions compared with isnan."""
    nan = ref.isnan()
    return torch.equal(val.isnan(), nan) and torch.equal(val[~nan], ref[~nan])


# C at the forward's shapes in small, and at odd ones: (P, C, rows, keys, K)
WSUM_SHAPES = [(4, 64, N, N, 8), (4, 32, N, N, 8), (4, 128, M, M, 8),
               (1, 256, N, M, 3), (1, 128, N, M, 3), (1, 3, N, N, 8),
               (2, 33, N, N, 16), (3, 6, 200, M, 5), (4, 16, M, M, 8),
               (4, 8, 50, 50, 64)]


@pytest.mark.parametrize("P,C,rows,keys_n,k", WSUM_SHAPES)
def test_weighted_sum_every_plan(device, P, C, rows, keys_n, k):
    """Kernel C on random (non-banded) ids at every plan: within 1e-5 of
    the plain version, the same bits at every plan and on a second run;
    `flex_moments` on positions gives the bits of `weighted_sum` on
    `flex_weights`, at every plan."""
    g = torch.Generator().manual_seed(P * 1000 + C)
    feat = torch.randn(B, keys_n, C, generator=g).to(device)
    nbh = torch.randint(0, keys_n, (B, rows, k), generator=g).to(device)
    w = torch.randn(B, rows, k, P, generator=g).to(device)
    ref = T.weighted_sum_plain(feat, nbh, w)
    first = T.weighted_sum(feat, nbh, w)
    for plan in row_plans(C, k):
        out = _counted(kernels.WEIGHTED_SUM, T.weighted_sum, feat, nbh, w,
                       plan=plan)
        _close(out, ref)
        assert torch.equal(out, first), plan
    if P == 1:
        return
    pos = (torch.randn(B, keys_n, P - 1, generator=g) * 30).to(device)
    want = T.weighted_sum(feat, nbh, T.flex_weights(pos, nbh))
    _close(want, T.flex_moments_plain(feat, pos, nbh))
    for plan in row_plans(C, k):
        got = _counted(kernels.FLEX_MOMENTS, T.flex_moments, feat, pos, nbh,
                       plan=plan)
        assert torch.equal(got, want), plan


def test_flex_moments_backward_is_weighted_sum_backward(device):
    """Kernel E with the weights built from the positions: the bits of E on
    `flex_weights`, through the op and through autograd."""
    g = torch.Generator().manual_seed(5)
    for P, C, rows, keys_n, k in ((4, 64, N, N, 8), (4, 128, M, M, 8),
                                  (3, 33, 200, M, 5), (2, 6, N, N, 16)):
        pos = (torch.randn(B, keys_n, P - 1, generator=g) * 30).to(device)
        nbh = torch.randint(0, keys_n, (B, rows, k), generator=g).to(device)
        dm = torch.randn(B, rows, P * C, generator=g).to(device)
        want = T.weighted_sum_backward(dm, nbh, T.flex_weights(pos, nbh),
                                       keys_n)
        got = _counted(kernels.FLEX_MOMENTS_BWD, T.flex_moments_backward, dm,
                       pos, nbh)
        assert torch.equal(got, want), (P, C)
        feat = torch.randn(B, keys_n, C, generator=g).to(device)
        feat.requires_grad_()
        T.flex_moments(feat, pos, nbh).backward(dm)
        assert torch.equal(feat.grad, want), (P, C)


def misaligned(t):
    """A contiguous copy of `t` whose base is 4 bytes off a 16-byte line."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 8 == 4 and out.is_contiguous()
    return out


def test_misaligned_features_fall_to_one_channel_a_thread(device):
    """Features whose base is not a multiple of 8 bytes: the default plan
    falls to VEC = 1 and agrees; a forced VEC = 2 or 4 is refused."""
    g = torch.Generator().manual_seed(9)
    feat = torch.randn(B, M, 64, generator=g).to(device)
    nbh = torch.randint(0, M, (B, N, 8), generator=g).to(device)
    w = torch.randn(B, N, 8, 4, generator=g).to(device)
    off = misaligned(feat)
    assert torch.equal(T.weighted_sum(off, nbh, w),
                       T.weighted_sum(feat, nbh, w))
    val, arg, slot = T.neighbor_max_with_slot(off, nbh)
    ref = T.neighbor_max_plain(feat, nbh)
    assert all(torch.equal(a, b) for a, b in zip((val, arg, slot), ref))
    for plan in ((4, 16, 1), (2, 32, 1)):
        with pytest.raises(ValueError, match="invalid argument"):
            T.weighted_sum(off, nbh, w, plan=plan)
        with pytest.raises(ValueError, match="invalid argument"):
            T.neighbor_max(off, nbh, plan=plan)


def test_row_kernels_refuse_a_plan_that_does_not_fit(device):
    """A vector width that does not divide C, a group that is no power of
    two or wider than a warp, a wrong pass count: ValueError, no launch."""
    feat = torch.randn(B, M, 66, device=device)
    nbh = torch.randint(0, M, (B, N, 8), device=device)
    w = torch.randn(B, N, 8, 4, device=device)
    before = kernels.counts()
    for plan in ((4, 32, 1), (3, 32, 1), (2, 12, 3), (2, 64, 1), (2, 32, 1),
                 (2, 32, 3), (1, 0, 1)):
        with pytest.raises(ValueError, match="invalid argument"):
            T.weighted_sum(feat, nbh, w, plan=plan)
        with pytest.raises(ValueError, match="invalid argument"):
            T.flex_moments(feat, feat[..., :3].contiguous(), nbh, plan=plan)
        with pytest.raises(ValueError, match="invalid argument"):
            T.neighbor_max(feat, nbh, plan=plan)
    assert kernels.counts() == before


# D at the forward's shapes in small, and at odd ones: (C, rows, keys, K)
MAX_SHAPES = [(64, N, N, 8), (32, N, N, 8), (128, M, M, 8), (3, N, N, 8),
              (130, N, M, 8), (33, 200, M, 16), (16, M, M, 8), (6, N, N, 1)]


@pytest.mark.parametrize("kind", ["ties", "normal", "nan"])
@pytest.mark.parametrize("C,rows,keys_n,k", MAX_SHAPES)
def test_neighbor_max_every_plan(device, C, rows, keys_n, k, kind):
    """Kernel D on random ids at every plan, with and without the ids and
    the slot: value, ids and slot equal the plain version bit for bit, on
    integer features (most maxima tie), on normal ones, and on features
    with 10% NaN, 5% +inf and 5% -inf (the first NaN wins); twice."""
    g = torch.Generator().manual_seed(C + len(kind))
    if kind == "ties":
        feat = torch.randint(0, 4, (B, keys_n, C), generator=g).float()
    else:
        feat = torch.randn(B, keys_n, C, generator=g)
    if kind == "nan":
        u = torch.rand(B, keys_n, C, generator=g)
        feat[u < 0.10] = float("nan")
        feat[(u >= 0.10) & (u < 0.15)] = float("inf")
        feat[(u >= 0.15) & (u < 0.20)] = float("-inf")
    feat = feat.to(device)
    nbh = torch.randint(0, keys_n, (B, rows, k), generator=g).to(device)
    pval, parg, pslot = T.neighbor_max_plain(feat, nbh)
    assert (kind == "nan") == bool(pval.isnan().any())
    for plan in row_plans(C, k):
        for with_arg in (True, False):
            val, arg = _counted(kernels.NEIGHBOR_MAX, T.neighbor_max, feat,
                                nbh, with_arg=with_arg, plan=plan)
            assert same_max(val, pval), plan
            assert torch.equal(arg, parg) if with_arg else arg is None
            val, arg, slot = _counted(
                kernels.NEIGHBOR_MAX, T.neighbor_max_with_slot, feat, nbh,
                with_arg=with_arg, plan=plan)
            assert same_max(val, pval), plan
            assert torch.equal(arg, parg) if with_arg else arg is None
            assert slot.dtype == torch.int8 and torch.equal(slot, pslot)


@pytest.mark.parametrize("nan_slot", [0, 1, K - 1])
def test_neighbor_max_nan_routes_the_backward(device, nan_slot):
    """One NaN a neighbourhood, at slot 0, 1 or K-1, +inf beside it: D
    returns NaN with that slot's id, and F sends the cotangent there."""
    g = torch.Generator().manual_seed(nan_slot)
    nbh = torch.stack([torch.randperm(N, generator=g)[:K]
                       for _ in range(200)])[None].to(device)
    feat = torch.randn(1, N, 64, generator=g)
    clean = torch.ones(N, dtype=torch.bool)
    for n in range(0, 200, 7):  # rows whose neighbours are still clean
        ids = nbh[0, n].cpu()
        if clean[ids].all():
            feat[0, ids[nan_slot]] = float("nan")
            feat[0, ids[(nan_slot + 1) % K]] = float("inf")
            clean[ids] = False
    feat = feat.to(device).requires_grad_()
    val, arg = T.neighbor_max(feat, nbh)
    pval, parg, pslot = T.neighbor_max_plain(feat.detach(), nbh)
    assert pval.isnan().any() and same_max(val.detach(), pval)
    assert torch.equal(arg, parg)
    dval = torch.randn(1, 200, 64, generator=g).to(device)
    val.backward(dval)
    _close(feat.grad, T.neighbor_max_backward_plain(dval, nbh, pslot, N))


def test_conv_pointset_and_flex_conv_on_card(cloud):
    nbh, _ = T.knn_bruteforce(cloud, K)
    theta = torch.randn(3, 32, device=cloud.device)
    bias = torch.randn(32, device=cloud.device)
    got = T.conv_pointset(cloud, nbh, theta, bias)
    cpu = T.conv_pointset(cloud.cpu(), nbh.cpu(), theta.cpu(), bias.cpu())
    _close(got.cpu(), cpu)
    feat = torch.randn(B, N, 16, device=cloud.device)
    th = torch.randn(3, 16, 24, device=cloud.device) * 0.1
    b = torch.randn(16, 24, device=cloud.device) * 0.1
    _close(T.flex_conv(feat, cloud, nbh, th, b).cpu(),
           T.flex_conv(feat.cpu(), cloud.cpu(), nbh.cpu(), th.cpu(), b.cpu()))


@pytest.mark.parametrize("P,C,rows,keys_n,k", [
    (4, 64, N, N, K),       # flex-conv moments
    (1, 128, N, M, 3),      # three_interpolate, N != M
    (3, 33, N, N, 16),      # odd widths
])
def test_weighted_sum_backward_equals_plain(device, P, C, rows, keys_n, k):
    g = torch.Generator().manual_seed(P * 100 + C)
    dm = torch.randn(B, rows, P * C, generator=g).to(device)
    nbh = torch.randint(0, keys_n, (B, rows, k), generator=g).to(device)
    w = torch.randn(B, rows, k, P, generator=g).to(device)
    out = _counted(kernels.WEIGHTED_SUM_BWD, T.weighted_sum_backward, dm,
                   nbh, w, keys_n)
    _close(out, T.weighted_sum_backward_plain(dm, nbh, w, keys_n))


@pytest.mark.parametrize("C", [3, 64, 130])
def test_neighbor_max_backward_equals_plain(device, C):
    """Ties and repeated ids: the cotangent goes once, to the lowest k."""
    g = torch.Generator().manual_seed(C + 7)
    feat = torch.randint(0, 4, (B, N, C), generator=g).float().to(device)
    nbh = torch.randint(0, N, (B, N, K), generator=g)
    nbh[:, :, 3] = nbh[:, :, 1]  # a repeated id in every neighbourhood
    nbh = nbh.to(device)
    _, _, slot = T.neighbor_max_plain(feat, nbh)
    dval = torch.randn(B, N, C, generator=g).to(device)
    out = _counted(kernels.NEIGHBOR_MAX_BWD, T.neighbor_max_backward, dval,
                   nbh, slot, N)
    # the plain version's scatter_add_ adds with atomics on the card, in
    # an order that varies: 1e-5 relative, as the weighted sums
    _close(out, T.neighbor_max_backward_plain(dval, nbh, slot, N))


def test_knn_cross_k16_equals_plain(cloud):
    """The detection loss's query: keypoints against the whole cloud."""
    query = cloud[:, :50].contiguous() + 0.5
    idx, dist = _counted(_knn_kernel(16),
                         T.knn_bruteforce_pairwise, query, cloud, 16)
    pidx, pd2 = T.knn_plain(query, cloud, 16)
    assert torch.equal(idx, pidx) and torch.equal(dist, torch.sqrt(pd2))


def test_kernelled_ops_carry_gradients_on_card(cloud):
    """flex_conv and flex_pool on CUDA inputs that require grad give
    outputs that require grad, and the CPU path's gradients."""
    nbh, _ = T.knn_bruteforce(cloud, K)
    g = torch.Generator().manual_seed(3)
    feat = torch.randn(B, N, 16, generator=g)
    th = torch.randn(3, 16, 24, generator=g) * 0.1
    b = torch.randn(16, 24, generator=g) * 0.1
    dout = torch.randn(B, N, 24, generator=g)
    grads = {}
    for dev in ("cpu", cloud.device):
        f = feat.to(dev).detach().requires_grad_()
        out = T.flex_conv(f, cloud.to(dev), nbh.to(dev), th.to(dev),
                          b.to(dev))
        val, _ = T.flex_pool(out, nbh.to(dev))
        assert out.requires_grad and val.requires_grad
        (val * dout.to(dev)).sum().backward()
        grads[str(dev)] = f.grad.cpu()
    _close(grads[str(cloud.device)], grads["cpu"])


def test_train_step_on_card_matches_cpu(device):
    """One detection_config step at [2, 512] with the same initial weights
    and batch on the card and on the CPU: the losses within 1e-4 relative,
    every gradient within 1e-3 of its tensor's largest magnitude (the
    gradients of biases that feed a BatchNorm are 0 exactly and compare
    against the model's largest gradient): `test_torch_cuda_paths.py`'s
    TRAIN_LOSS_REL and TRAIN_GRAD_REL, which hold the step at full width
    there."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import (forward_loss, init_state,
                                      synthetic_batches, to_device)

    cfg = cfglib.get_config("detection_config")
    cfg.num_points, cfg.batch_size, cfg.sampled_kpnum = 512, 1, 32
    batch = next(synthetic_batches(cfg, 0))
    results = {}
    for dev in ("cpu", device):
        state = init_state(cfg, 0, dev)
        state.model.train()
        total, metrics, _ = forward_loss(state.model, cfg,
                                         to_device(batch, dev))
        total.backward()
        results[str(dev)] = (
            {k: v.item() for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in state.model.named_parameters()})
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results[str(device)]
    zero = bn_fed_biases(state.model)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, v, m_gpu[k])
    top = max(g.abs().max().item() for g in g_cpu.values())
    for name, g in g_cpu.items():
        scale = top if name in zero else g.abs().max().item()
        err = (g_gpu[name] - g).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)


# E and F at every shape of the detection_config train step ([20, 8192]
# and its [20, 1024] level): (P, C, keys) for E, C for F
TRAIN_E = [(4, 32, "N"), (4, 64, "N"), (4, 64, "M"), (4, 128, "M"),
           (1, 128, "3nn")]
TRAIN_F = [(32, "N"), (64, "N"), (128, "M")]


@pytest.fixture(scope="module")
def train_level(device_module):
    """The three neighbourhoods of a train step on [20, 8192] clouds: kNN
    k=8 at 8192 and at 1024, and the 3-NN map 8192 -> 1024."""
    g = torch.Generator().manual_seed(11)
    pts = (torch.randn(20, 8192, 3, generator=g) * 30).to(device_module)
    sub = pts[:, ::8].contiguous()
    nbh, _ = T.knn(pts, pts, 8)
    nbh1, _ = T.knn(sub, sub, 8)
    d2, idx3 = T.three_nn(pts, sub)
    return {"N": (nbh, T.flex_weights(pts, nbh), 8192),
            "M": (nbh1, T.flex_weights(sub, nbh1), 1024),
            "3nn": (idx3, T.inverse_distance_weights(d2)[..., None]
                    .contiguous(), 1024)}


@pytest.fixture(scope="module")
def device_module():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("P,C,level", TRAIN_E)
def test_weighted_sum_backward_at_train_shapes(train_level, P, C, level):
    """Kernel E with the inverse shared and built in the call: the same
    bits both ways and on a second run; within 1e-5 of the plain version."""
    idx, w, keys = train_level[level]
    g = torch.Generator().manual_seed(P * 1000 + C)
    dm = torch.randn(*idx.shape[:2], P * C, generator=g).to(idx.device)
    inv = T.NeighborInverse(idx, keys)
    shared = _counted(kernels.WEIGHTED_SUM_BWD, T.weighted_sum_backward, dm,
                      idx, w, keys, inv)
    assert torch.equal(shared, T.weighted_sum_backward(dm, idx, w, keys, inv))
    assert torch.equal(shared, T.weighted_sum_backward(dm, idx, w, keys))
    _close(shared, T.weighted_sum_backward_plain(dm, idx, w, keys))


@pytest.mark.parametrize("C,level", TRAIN_F)
def test_neighbor_max_backward_at_train_shapes(train_level, C, level):
    idx, _, keys = train_level[level]
    g = torch.Generator().manual_seed(C)
    feat = torch.randn(idx.shape[0], keys, C, generator=g).to(idx.device)
    slot = T.neighbor_max_with_slot(feat, idx)[2]
    dval = torch.randn(*idx.shape[:2], C, generator=g).to(idx.device)
    inv = T.NeighborInverse(idx, keys)
    shared = _counted(kernels.NEIGHBOR_MAX_BWD, T.neighbor_max_backward, dval,
                      idx, slot, keys, inv)
    assert torch.equal(shared,
                       T.neighbor_max_backward(dval, idx, slot, keys, inv))
    assert torch.equal(shared, T.neighbor_max_backward(dval, idx, slot, keys))
    _close(shared, T.neighbor_max_backward_plain(dval, idx, slot, keys))


def test_inverse_on_card_equals_cpu(train_level):
    """The build is integer bookkeeping: the same on the card and the CPU."""
    for idx, _, keys in train_level.values():
        got = T.inverse_neighbors(idx, keys)
        ref = T.inverse_neighbors(idx.cpu(), keys)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))


def test_train_step_builds_each_inverse_once(device, monkeypatch):
    """One detection_config step at [2, 8192]: kernel E runs 5 times (4 on
    positions, 1 on weights) and F 3 times over 3 neighbourhoods, whose
    inverses are built once each."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.ops import neighborhood
    from dh3d_tpu_torch.train import (forward_loss, init_state,
                                      synthetic_batches, to_device)

    built = []
    real = neighborhood.inverse_neighbors
    monkeypatch.setattr(neighborhood, "inverse_neighbors",
                        lambda nbh, m: built.append(nbh) or real(nbh, m))
    cfg = cfglib.get_config("detection_config")
    cfg.num_points, cfg.batch_size = 8192, 1
    batch = next(synthetic_batches(cfg, 0))
    state = init_state(cfg, 0, device)
    state.model.train()
    kernels.reset_counts()
    total, _, _ = forward_loss(state.model, cfg, to_device(batch, device))
    total.backward()
    torch.cuda.synchronize()
    # E: 4 flex convs on positions, the upsample on weights; C likewise,
    # and initconv on raw xyz (forward only)
    assert kernels.FLEX_MOMENTS_BWD.launches == 4
    assert kernels.WEIGHTED_SUM_BWD.launches == 1
    assert kernels.NEIGHBOR_MAX_BWD.launches == 3
    assert kernels.FLEX_MOMENTS.launches == 4
    assert kernels.WEIGHTED_SUM.launches == 2
    assert kernels.NEIGHBOR_MAX.launches == 3
    assert len(built) == 3 and len({id(t) for t in built}) == 3


def test_pairgen_on_card_equals_cpu_and_launches_b_and_a(device):
    """`data.pairgen.local_pairs` on draws made once on the CPU: the same
    anchors and positives on the card as on the CPU, points within 1e-6 of
    their scale; on the card it launches B (the anchors' FPS) and A (the
    1-NN) once each.  `device_local_pairs` draws from a generator on the
    card."""
    from dh3d_tpu_torch.data.pairgen import (device_local_pairs,
                                             draw_local_pairs, local_pairs)

    rng = np.random.RandomState(2)
    pc1 = rng.randn(2, 3000, 3).astype(np.float32) * 20
    pc2 = (pc1[:, rng.permutation(3000)]
           + rng.randn(2, 3000, 3).astype(np.float32) * 0.05)
    draws = draw_local_pairs(2, 3000, np.pi,
                             torch.Generator().manual_seed(0))
    cpu = local_pairs(torch.from_numpy(pc1), torch.from_numpy(pc2), 64,
                      *draws)
    before = (kernels.FPS.launches, kernels.KNN.launches)
    card = local_pairs(torch.from_numpy(pc1).to(device),
                       torch.from_numpy(pc2).to(device), 64,
                       *(d.to(device) for d in draws))
    torch.cuda.synchronize()
    assert (kernels.FPS.launches, kernels.KNN.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(card["sample_inds"].cpu(), cpu["sample_inds"])
    _close(card["points"].cpu(), cpu["points"], rel=1e-6)
    g = torch.Generator(device=device).manual_seed(1)
    out = device_local_pairs(torch.from_numpy(pc1).to(device),
                             torch.from_numpy(pc2).to(device), 64, np.pi, g)
    assert out["sample_inds"].device.type == "cuda"


def test_device_augment_on_card_equals_cpu(device):
    """`torch_augment` of the global preset's augmentations on draws made
    on the CPU: the card's clouds within 1e-6 of their scale."""
    from dh3d_tpu_torch.data.augment import draw_augment, torch_augment

    pts = torch.from_numpy(
        np.random.RandomState(3).randn(4, 2000, 3).astype(np.float32) * 20)
    draws = draw_augment(("Rotate1D", "Jitter", "RotateSmall", "Scale",
                          "Shift"), pts.shape, torch.Generator().manual_seed(0))
    cpu = torch_augment(pts, draws)
    card = torch_augment(pts.to(device), [(n, d.to(device))
                                          for n, d in draws])
    _close(card.cpu(), cpu, rel=1e-6)


def _correspondences(seed, n=200, outliers=0.4):
    rng = np.random.RandomState(seed)
    xyz2 = rng.randn(n, 3) * 10
    ang = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    xyz1 = xyz2 @ R.T + rng.uniform(-5, 5, 3) + rng.randn(n, 3) * 0.05
    bad = rng.rand(n) < outliers
    xyz1[bad] = rng.randn(int(bad.sum()), 3) * 10
    return xyz1.astype(np.float32), xyz2.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_and_ransac_on_card_equal_cpu(device, seed):
    """Mutual matching and RANSAC (batched fits, cuSOLVER's SVD) on the
    card against the CPU (LAPACK) on the same inputs: the same matches and
    inlier sets, R and t within 1e-9; a NaN correspondence is skipped on
    both."""
    from dh3d_tpu_torch.eval import match_descriptors_mutual, ransac_rigid

    rng = np.random.RandomState(seed)
    d1 = rng.randn(256, 128).astype(np.float32)
    d2 = np.concatenate([d1[:100] + rng.randn(100, 128).astype(np.float32)
                         * 0.05, rng.randn(156, 128).astype(np.float32)])
    m_gpu = match_descriptors_mutual(d1, d2, device=device)
    assert m_gpu.device.type == "cuda"
    assert torch.equal(m_gpu.cpu(),
                       match_descriptors_mutual(d1, d2, device="cpu"))
    xyz1, xyz2 = _correspondences(seed)
    xyz1[5, 2] = np.nan
    for iters in (500, 1000):
        gpu = ransac_rigid(xyz1, xyz2, iters=iters, seed=seed, device=device)
        cpu = ransac_rigid(xyz1, xyz2, iters=iters, seed=seed, device="cpu")
        assert gpu.num_inliers == cpu.num_inliers > 80
        assert np.array_equal(gpu.inliers, cpu.inliers)
        assert not gpu.inliers[5]
        assert np.abs(gpu.R - cpu.R).max() < 1e-9
        assert np.abs(gpu.t - cpu.t).max() < 1e-9


def test_repeatability_on_card_equals_cpu(device):
    """`repeatability_curve` with NMS on the card (kernel G at k = 50)
    against the CPU on the same rigid-invariant detector."""
    from scipy.spatial import cKDTree

    from dh3d_tpu_torch.eval import repeatability_curve

    def extract(cloud):
        dist, _ = cKDTree(cloud).query(cloud, k=9)
        att = 1.0 / (1e-3 + dist[:, -1])
        return cloud, (att / att.max()).astype(np.float32)

    rng = np.random.RandomState(4)
    clouds = [(rng.randn(2000, 3) * np.array([4, 4, 1])).astype(np.float32)
              for _ in range(2)]
    before = kernels.KNN_TOPK.launches
    gpu = repeatability_curve(extract, clouds, ks=(32, 128), device=device)
    torch.cuda.synchronize()
    assert kernels.KNN_TOPK.launches == before + 4  # one NMS a cloud
    assert gpu == repeatability_curve(extract, clouds, ks=(32, 128),
                                      device="cpu")


# ------------------------ kernel H: the Morton band ------------------------

def _band_cloud(kind, n, g):
    """[2, n, 3] Morton-sorted points on the CPU for one kind of cloud."""
    if kind == "grid":  # many equal distances: the lowest id wins
        pos = torch.randint(0, 6, (2, n, 3), generator=g).float()
    else:
        pos = torch.randn(2, n, 3, generator=g) * 30
    if kind == "duplicates":
        pos[:, n // 2:] = pos[:, :n // 2][:, torch.randperm(n // 2,
                                                            generator=g)]
    perm, _ = T.morton_perm(pos)
    return torch.gather(pos, 1, perm[..., None].expand(-1, -1, 3))


def _same_window(out, ref):
    """ids equal and d2 bit for bit, a NaN matching a NaN (the kernel
    writes the canonical NaN, the plain version the CPU's)."""
    assert torch.equal(out[0].cpu(), ref[0])
    torch.testing.assert_close(out[1].cpu(), ref[1], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("kind", ["normal", "grid", "duplicates"])
@pytest.mark.parametrize("n,m,window,k", [
    (1024, 1024, 512, 8), (2048, 2048, 512, 8), (1024, 1024, 128, 1),
    (1024, 1024, 256, 4), (1024, 1024, 512, 16), (768, 768, 256, 32),
    (4096, 512, 256, 3), (2048, 256, 256, 3), (1536, 1000, 384, 5)])
def test_knn_window_equals_plain(device, kind, n, m, window, k):
    """Kernel H, self (n == m) and cross (the 3-NN's queries far more
    than the keys), at each list length it compiles (k <= 4, 8, 16, 32),
    at its own plan (`window_plan`) and at every plan forced (lanes a
    query, `WINDOW_LANES`): ids and d2 bit for bit equal to the plain
    version, each id in its tile's band, and the same on a second run."""
    g = torch.Generator().manual_seed(n + m + window + k)
    keys = _band_cloud(kind, m, g)
    query = keys if n == m else _band_cloud(kind, n, g)
    pidx, pd2 = T.knn_window_plain(query, keys, k, window)
    q, kd = query.contiguous().to(device), keys.contiguous().to(device)
    for plan in (None, *knn_ops.WINDOW_LANES):
        idx, d2 = _counted(kernels.KNN_WINDOW, T.knn_window, q, kd, k,
                           window, plan=plan)
        assert torch.equal(idx.cpu(), pidx) and torch.equal(d2.cpu(), pd2), \
            plan
        again = T.knn_window(q, kd, k, window, plan=plan)
        assert torch.equal(again[0], idx) and torch.equal(again[1], d2)
    start = T.win_start(n, m, window).repeat_interleave(256)[None, :, None]
    assert ((pidx >= start) & (pidx < start + window)).all()


@pytest.mark.parametrize("n,m,window,k", [
    (512, 512, 128, 32), (768, 768, 512, 8), (2048, 640, 128, 3),
    (1024, 256, 256, 8)])
def test_knn_window_band_edges_and_nan_rows(device, n, m, window, k):
    """The band's edges at every plan: the first and the last tile, whose
    starts clamp to 0 and to M - W (all of them where W = M); bound chunks
    that reach past the band (32 lanes of k rows); W = 128 with k = 32.
    A row of each cloud has a NaN coordinate: its d2 are NaN and order
    after +inf, by index."""
    g = torch.Generator().manual_seed(n + m + k)
    keys = _band_cloud("normal", m, g)
    query = keys.clone() if n == m else _band_cloud("normal", n, g)
    keys[:, m // 3, 1] = float("nan")
    query[:, 5, 0] = float("nan")
    pidx, pd2 = T.knn_window_plain(query, keys, k, window)
    assert torch.isnan(pd2).any()
    q, kd = query.contiguous().to(device), keys.contiguous().to(device)
    for plan in (None, *knn_ops.WINDOW_LANES):
        _same_window(_counted(kernels.KNN_WINDOW, T.knn_window, q, kd, k,
                              window, plan=plan), (pidx, pd2))


def test_knn_window_entry_point_refuses_what_it_does_not_take(device):
    """The C entry point checks the sizes itself: each refusal raises
    ValueError and launches nothing."""
    x = torch.zeros(1, 512, 3, device=device)
    out = torch.empty(1, 512, 33, dtype=torch.int64, device=device)
    d2 = torch.empty(1, 512, 33, device=device)
    before = kernels.KNN_WINDOW.launches
    for n, m, k, w in ((300, 512, 8, 128), (512, 512, 8, 192),
                       (512, 256, 8, 384), (512, 512, 33, 512),
                       (512, 512, 0, 128)):
        with pytest.raises(ValueError, match="knn_window"):
            kernels.KNN_WINDOW.launch(device, x.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), d2.data_ptr(), 1, n, m,
                                      k, w)
    assert kernels.KNN_WINDOW.launches == before


def test_legacy_forward_on_card_launches_h_and_matches_cpu(device):
    """The main-path model with morton_exact=False at [2, 2048]: H once
    (the full-resolution kNN), neighbour ids equal to the CPU's, the
    descriptors within `test_torch_cuda_paths.py`'s CARD_VS_CPU_ATOL,
    1e-4."""
    from dh3d_tpu_torch.entry import entry_config, entry_points, entry_weights
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.nn import DH3D, load_flax

    outs = []
    for dev in (device, torch.device("cpu")):
        cfg = entry_config()
        cfg.morton_exact = False
        model = DH3D(cfg).to(dev)
        load_flax(model, entry_weights())
        pts = entry_points(2, 2048, seed=3) / np.float32(30.0)
        kernels.reset_counts()
        outs.append({k: v.cpu() for k, v in make_forward(cfg, model)(
            pts).items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.counts()["knn_window"] == 1
    card, cpu = outs
    assert torch.equal(card["knn_indices"], cpu["knn_indices"])
    for key in ("local_desc", "attention", "global_desc"):
        assert (card[key] - cpu[key]).abs().max().item() <= 1e-4, key


# ------------------ the bf16 cases of kernels C and E ------------------

BF16_STEP = 2.0 ** -7  # one bf16 step, relative, at most


def _bf16_close(a, ref, rel=1e-5):
    """Within one bf16 step of each value plus f32 rounding of the
    tensor's scale: the kernels sum in another order than the plain
    versions, so an f32 sum that differs in its last bits may round to
    the neighbouring bf16."""
    a, ref = a.float(), ref.float()
    err = (a - ref).abs()
    assert (err <= BF16_STEP * ref.abs() + rel * ref.abs().max()).all(), \
        err.max().item()


# row 7's and row 10's shapes of PERF.md §6: (C, level)
BF16_SHAPES = [(64, "N"), (32, "N"), (64, "M"), (128, "M")]


@pytest.mark.parametrize("C,level", BF16_SHAPES)
def test_flex_moments_bf16_at_path_shapes(train_level, C, level):
    """Kernel C's bf16 case at the forward's shapes, every plan: the m0
    slice within one bf16 step of the plain version's (`_bf16_close`), the
    other moments within 1e-5 (f32 sums of exact products); the same bits
    at every plan and on a second run; one launch of the bf16 case a
    call, none of the f32 case."""
    idx, _, keys = train_level[level]
    B, rows, k = idx.shape
    g = torch.Generator().manual_seed(C)
    pos = (torch.randn(B, keys, 3, generator=g) * 30).to(idx.device)
    feat = torch.randn(B, keys, C, generator=g).to(idx.device).to(
        torch.bfloat16)
    ref = T.flex_moments_plain(feat, pos, idx).view(B, rows, 4, C)
    before = kernels.FLEX_MOMENTS.launches
    first = _counted(kernels.FLEX_MOMENTS_BF16, T.flex_moments, feat, pos,
                     idx)
    assert first.dtype == torch.float32
    out = first.view(B, rows, 4, C)
    _bf16_close(out[:, :, 0], ref[:, :, 0])
    _close(out[:, :, 1:], ref[:, :, 1:])
    assert torch.equal(out[:, :, 0], out[:, :, 0].bfloat16().float())
    for plan in row_plans(C, k):
        got = _counted(kernels.FLEX_MOMENTS_BF16, T.flex_moments, feat, pos,
                       idx, plan=plan)
        assert torch.equal(got, first), plan
    assert kernels.FLEX_MOMENTS.launches == before


@pytest.mark.parametrize("C,level", BF16_SHAPES)
def test_flex_moments_backward_bf16_at_path_shapes(train_level, C, level):
    """Kernel E's bf16 case at the train step's shapes: bf16 out, within
    one bf16 step of the plain version's (f32 sums in another order, then
    one rounding); the same bits with the inverse shared and built in the
    call, and through autograd."""
    idx, _, keys = train_level[level]
    B, rows, _ = idx.shape
    g = torch.Generator().manual_seed(100 + C)
    pos = (torch.randn(B, keys, 3, generator=g) * 30).to(idx.device)
    dm = torch.randn(B, rows, 4 * C, generator=g).to(idx.device)
    inv = T.NeighborInverse(idx, keys)
    shared = _counted(kernels.FLEX_MOMENTS_BWD_BF16, T.flex_moments_backward,
                      dm, pos, idx, inv, torch.bfloat16)
    assert shared.dtype == torch.bfloat16
    _bf16_close(shared, T.flex_moments_backward_plain(dm, pos, idx, keys,
                                                      torch.bfloat16))
    assert torch.equal(shared, T.flex_moments_backward(
        dm, pos, idx, dtype=torch.bfloat16))
    feat = torch.zeros(B, keys, C, dtype=torch.bfloat16, device=idx.device,
                       requires_grad=True)
    T.flex_moments(feat, pos, idx, inv).backward(dm)
    assert torch.equal(feat.grad, shared)


def test_flex_moments_bf16_misaligned_and_refused(device):
    """bf16 features whose base is 2 bytes off: the default plan falls to
    one channel a thread and gives the aligned bits; a forced VEC of 2 or
    4 is refused (ValueError, no launch).  f16 features never reach a
    kernel."""
    g = torch.Generator().manual_seed(21)
    feat = torch.randn(B, M, 64, generator=g).to(device).to(torch.bfloat16)
    pos = torch.randn(B, M, 3, generator=g).to(device)
    nbh = torch.randint(0, M, (B, N, 8), generator=g).to(device)
    buf = torch.empty(feat.numel() + 1, dtype=feat.dtype, device=device)
    off = buf[1:].view(feat.shape)
    off.copy_(feat)
    assert off.data_ptr() % 4 == 2
    assert torch.equal(T.flex_moments(off, pos, nbh),
                       T.flex_moments(feat, pos, nbh))
    before = kernels.counts()
    for plan in ((4, 16, 1), (2, 32, 1)):
        with pytest.raises(ValueError, match="invalid argument"):
            T.flex_moments(off, pos, nbh, plan=plan)
    with pytest.raises(ValueError, match="dtype"):
        T.flex_moments(feat.half(), pos, nbh)
    assert kernels.counts() == before


def test_bf16_forward_on_card_launches_the_bf16_cases(device):
    """The main-path model in bf16 at [2, 2048]: the bf16 case of C five
    times (every flex conv) and the f32 case never; card against CPU
    within the bf16 limits of `test_torch_cuda_paths.py`'s
    BF16_CARD_VS_CPU."""
    from dh3d_tpu_torch.entry import entry_config, entry_points, entry_weights
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.nn import DH3D, load_flax

    outs = []
    for dev in (device, torch.device("cpu")):
        cfg = entry_config()
        cfg.compute_dtype = "bfloat16"
        model = DH3D(cfg).to(dev)
        load_flax(model, entry_weights())
        pts = entry_points(2, 2048, seed=3)
        kernels.reset_counts()
        outs.append({k: v.cpu() for k, v in make_forward(cfg, model)(
            pts).items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.counts()
            assert counts["flex_moments_bf16"] == 5, counts
            assert counts["flex_moments"] == 0, counts
    card, cpu = outs
    assert torch.equal(card["knn_indices"], cpu["knn_indices"])
    for key, top in (("local_desc", 0.2), ("global_desc", 2e-4)):
        assert (card[key] - cpu[key]).abs().max().item() <= top, key


# ------------------------------ the parallel path ------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A process group of one on NCCL (this test process, `cuda:0`), with a
    gloo group of the same rank beside it, for the collectives on CUDA
    tensors under both backends."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import torch.distributed as dist

    from dh3d_tpu_torch.parallel import data_parallel_mesh

    store = str(tmp_path_factory.mktemp("nccl") / "store")
    mesh = data_parallel_mesh(1, rank=0, store=store, device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh, dist.new_group([0], backend="gloo")
    dist.destroy_process_group()


def test_sync_batchnorm_on_a_group_of_one(nccl_mesh):
    """BatchNorm with the NCCL group (sum(x), sum(x^2) and the count
    all-reduced with autograd) against the layer without one: y, dx, the
    parameter gradients and the running statistics within 1e-5."""
    from dh3d_tpu_torch.nn.layers import BatchNorm

    mesh, _ = nccl_mesh
    g = torch.Generator().manual_seed(31)
    x = (torch.randn(4, 2048, 64, generator=g) * 2 + 5).cuda()
    dy = torch.randn(4, 2048, 64, generator=g).cuda()
    outs = []
    for group in (None, mesh):
        layer = BatchNorm(64).cuda().train()
        layer.group = group
        xi = x.clone().requires_grad_()
        y = layer(xi)
        y.backward(dy)
        outs.append((y.detach(), xi.grad, layer.scale.grad, layer.bias.grad,
                     layer.mean, layer.var))
    for a, b in zip(*outs):
        _close(b, a)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_autograd_collectives_on_cuda_tensors(nccl_mesh, backend):
    """`all_reduce` and `all_gather` (dims 0 and 1) of a CUDA tensor in a
    group of one, NCCL and gloo: the input's values, and the gradient of
    sum(out * c) is c."""
    from dh3d_tpu_torch.parallel import all_gather, all_reduce

    mesh, gloo = nccl_mesh
    group = mesh if backend == "nccl" else gloo
    g = torch.Generator().manual_seed(32)
    x = torch.randn(5, 7, generator=g).cuda()
    c = torch.randn(5, 7, generator=g).cuda()
    for fn in (lambda v: all_reduce(v, group),
               lambda v: all_gather(v, group, dim=0),
               lambda v: all_gather(v, group, dim=1)):
        v = x.clone().requires_grad_()
        y = fn(v)
        (y * c).sum().backward()
        assert torch.equal(y, x) and torch.equal(v.grad, c)


@pytest.mark.parametrize("B,N,k", [(2, 8192, 8), (1, 16384, 8), (1, 4096, 3)])
def test_knn_sharded_group_of_one_equals_bruteforce(nccl_mesh, B, N, k):
    """`knn_sharded` at world 1 on NCCL: the ids and distances of
    `knn_bruteforce`, bit for bit (kernel G at k=8, A at k=3)."""
    from dh3d_tpu_torch.parallel import knn_sharded, point_block

    mesh, _ = nccl_mesh
    g = torch.Generator().manual_seed(N + k)
    pts = (torch.randn(B, N, 3, generator=g) * 30).cuda()
    idx, dist = knn_sharded(point_block(pts, mesh), k, mesh)
    want_idx, want_dist = T.knn_bruteforce(pts, k)
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_dp_step_on_a_group_of_one_equals_one_process(nccl_mesh):
    """A detection_config step at [4, 4096] through `make_train_step(cfg,
    mesh)` on the NCCL group of one (sync BatchNorm, the gathers, the
    gradient all-reduce) against the plain step from the same weights and
    draws: metrics within 1e-5 of the total, gradients within 1e-4 of
    their scale (1e-5 of the largest for the biases that feed a
    BatchNorm), the kernels launched as often."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import (add_draws, init_state, make_train_step,
                                      synthetic_batches, to_device)

    mesh, _ = nccl_mesh
    cfg = cfglib.get_config("detection_config")
    cfg.num_points, cfg.batch_size, cfg.sampled_kpnum = 4096, 4, 128
    batch = to_device(next(synthetic_batches(cfg, 0)), "cuda")
    batch = add_draws(batch, cfg)
    runs = []
    for group in (None, mesh):
        state = init_state(cfg, 0, "cuda")
        kernels.reset_counts()
        m = make_train_step(cfg, group)(state, dict(batch))
        torch.cuda.synchronize()
        runs.append((m, {n: p.grad.clone() for n, p in
                         state.model.named_parameters()},
                     kernels.counts()))
    (m1, g1, c1), (m2, g2, c2) = runs
    total = abs(m1["total_cost"].item())
    for k in m1:
        assert abs(m1[k].item() - m2[k].item()) <= 1e-5 * max(
            total, abs(m1[k].item())), k
    zero = bn_fed_biases(state.model)
    top = max(v.abs().max().item() for v in g1.values())
    for n, v in g1.items():
        scale = top * 1e-1 if n in zero else v.abs().max().item()
        assert (g2[n] - v).abs().max().item() <= 1e-4 * scale, n
    assert c1 == c2 and c1["knn_topk"] > 0


# ---------------- kernel I: the loader's radius count ----------------

def _raw_scan_cloud(seed):
    """The raw extraction's count input: a 30,000-point lidar-like scan
    through the 0.2 m voxel grid (M ~ 27,800)."""
    from dh3d_tpu_torch.data.io import voxel_downsample
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan

    return voxel_downsample(lidar_like_scan(seed))


@pytest.mark.parametrize("case", RADIUS_CASES + ("raw_scan",))
def test_radius_count_equals_plain(device, case):
    """Kernel I, bit for bit, at `radius_plan`'s split and at forced ones
    (1, and more blocks than tiles), one launch a call; the raw scan also
    against `cKDTree`."""
    if case == "raw_scan":
        cloud, radius = _raw_scan_cloud(5), 1.0
    else:
        cloud, radius = radius_case(case)
    pts = torch.from_numpy(cloud)
    want = T.radius_count_plain(pts.to(device), radius).cpu()
    assert torch.equal(want, T.radius_count(pts, radius))  # CPU plain
    for plan in (None, 1, 7, 64):
        got = _counted(kernels.RADIUS_COUNT, T.radius_count, pts.to(device),
                       radius, plan=plan)
        assert torch.equal(got.cpu(), want), plan
    if case == "raw_scan":
        from scipy.spatial import cKDTree

        np.testing.assert_array_equal(want.numpy(), cKDTree(cloud)
                                      .query_ball_point(cloud, r=radius,
                                                        return_length=True))


def _write_scans(directory, count):
    from dh3d_tpu_torch.data.io import write_to_bin
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan

    for i in range(count):
        write_to_bin(lidar_like_scan(20 + i),
                     os.path.join(directory, f"{i:03d}.bin"))


def test_local_test_dataset_on_card_equals_ckdtree_path(device, tmp_path,
                                                        monkeypatch):
    """`LocalTestDataset` at the extraction CLI's N counts on the card,
    one launch of kernel I a cloud (`launches.radius_count`), and yields
    exactly the clouds of the `cKDTree` path (the same loader with CUDA
    hidden) over 3 files."""
    from dh3d_tpu_torch import trace
    from dh3d_tpu_torch.data import LocalTestDataset

    _write_scans(str(tmp_path), 3)

    def clouds():
        ds = LocalTestDataset(str(tmp_path), numpts=16384, knn_require=0,
                              dim=3)
        return [(item[0], item[2]) for item in ds]

    before = trace.counters()["launches.radius_count"]
    card = clouds()
    assert trace.counters()["launches.radius_count"] == before + 3
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        host = clouds()
    assert trace.counters()["launches.radius_count"] == before + 3
    for (a, na), (b, nb) in zip(card, host):
        assert na == nb and np.array_equal(a, b)


def test_loader_does_not_wait_for_the_default_stream(device, tmp_path):
    """A loader in `ThreadedPrefetcher`'s thread counts on its own stream:
    it hands over a cloud while a long kernel queued on the default stream
    (a train step's place) is still running."""
    from dh3d_tpu_torch.data import LocalTestDataset
    from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher

    _write_scans(str(tmp_path), 2)
    ds = LocalTestDataset(str(tmp_path), numpts=16384, knn_require=0, dim=3)
    next(iter(ds))  # warm: the library loaded, the loader's stream made
    torch.cuda.synchronize()
    busy = torch.cuda.Event()
    torch.cuda._sleep(4_000_000_000)  # ~2 s at the H100's clock
    busy.record()
    launches = kernels.RADIUS_COUNT.launches
    t0 = time.perf_counter()
    items = list(ThreadedPrefetcher(iter(ds), depth=1))
    seconds = time.perf_counter() - t0
    still_busy = not busy.query()
    torch.cuda.synchronize()
    assert len(items) == 2 and kernels.RADIUS_COUNT.launches == launches + 2
    assert still_busy, f"the loader waited for the default stream " \
                       f"({seconds:.2f} s)"


# ------------- kernel J: train-mode BatchNorm with a fused relu -------------

# the main path's shapes: stage 2's nine widths over 163840 points and two
# over 20480, stage 3's head over 196608 and its 24 descriptors; C = 3
# takes one channel a thread
BN_SHAPES = [(163840, 32), (163840, 64), (163840, 128), (163840, 256),
             (163840, 1024), (20480, 128), (196608, 1024), (196608, 64),
             (24, 256), (1000, 3)]
BN_KERNELS = ("batch_norm_stats", "batch_norm_forward",
              "batch_norm_grad_sums", "batch_norm_grad_dx")
BN_OUTPUTS = ("out", "dx", "dscale", "dbias", "running_mean", "running_var")


def _bn_inputs(rows, C, seed, integer_dy=False):
    """x [rows, C] at per-channel means in (-5, 5) and spreads in (0.1,
    3.1); channel 0 the constant 0.75 (its var exactly 0, so the clamp's
    edge; its bias 0.5), channel 1 below 0 after the normalisation
    everywhere (bias -100: no relu passes); dy (integers 1..4 with
    `integer_dy`), scale, bias, running statistics; float32 on the card.
    Every other x whose normalised value y lies within 1e-3 of 0 is moved
    away from it by 2e-3 / mul, so that rounding cannot flip the relu's
    gradient between versions (which would move one element's dx by its
    whole dy * mul)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, C, generator=g)
         * (torch.rand(C, generator=g) * 3 + 0.1)
         + (torch.rand(C, generator=g) * 10 - 5))
    x[:, 0] = 0.75
    dy = (torch.randint(1, 5, (rows, C), generator=g).float() if integer_dy
          else torch.randn(rows, C, generator=g))
    scale = torch.rand(C, generator=g) + 0.5
    bias = torch.randn(C, generator=g)
    bias[0], bias[1] = 0.5, -100.0
    mean0 = torch.randn(C, generator=g)
    var0 = torch.rand(C, generator=g) + 0.5
    xd = x.double()
    mean = xd.mean(0)
    mul = torch.rsqrt(torch.clamp_min((xd * xd).mean(0) - mean * mean, 0.0)
                      + 1e-5) * scale.double()
    y = (xd - mean) * mul + bias.double()
    push = torch.where(y >= 0, 2e-3, -2e-3) / mul
    push[:, 0] = 0.0
    x = torch.where(y.abs() < 1e-3, xd + push, xd).float()
    return [t.cuda() for t in (x, dy, scale, bias, mean0, var0)]


def _bn_run(fn, x, dy, scale, bias, mean0, var0, relu, update=True):
    """fn's output, dx, dscale, dbias and running statistics, on copies."""
    xi = x.clone().requires_grad_()
    s, b = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    m, v = mean0.clone(), var0.clone()
    y = fn(xi, s, b, m, v, 0.9, 1e-5, relu, update)
    y.backward(dy)
    return [y.detach(), xi.grad, s.grad, b.grad, m, v]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("rows,C", BN_SHAPES)
def test_batchnorm_equals_plain(device, rows, C, relu):
    """Kernel J (`ops.batch_norm_train`: each of its four entry points once)
    against the layer's plain code in f32 (`ops.batch_norm_plain`), both
    held to the plain code in float64: the output, the running mean and
    var and the gradients of x, scale and bias, J's largest error at most
    twice the plain f32 version's plus 1e-6 of the quantity's largest
    value (J sums in f64, PyTorch's reductions in f32).  A second run of J
    gives the same bits.  The constant channel's output is its bias
    exactly; with the relu the channel below 0 outputs 0 and passes no
    gradient."""
    inputs = _bn_inputs(rows, C, rows + C)
    before = kernels.counts()
    got = _bn_run(T.batch_norm_train, *inputs, relu)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert all(after[k] == before[k] + 1 for k in BN_KERNELS), after
    for a, b in zip(got, _bn_run(T.batch_norm_train, *inputs, relu)):
        assert torch.equal(a, b)
    plain = _bn_run(T.batch_norm_plain, *inputs, relu)
    ref = _bn_run(T.batch_norm_plain, *(t.double() for t in inputs), relu)
    for name, a, p, r in zip(BN_OUTPUTS, got, plain, ref):
        top = r.abs().max().item()
        err = (a.double() - r).abs().max().item()
        err_plain = (p.double() - r).abs().max().item()
        assert err <= 2 * err_plain + 1e-6 * top, (name, err, err_plain, top)
    out, dx, dscale, dbias = got[:4]
    bias = inputs[3]
    assert torch.all(out[:, 0] == (torch.relu(bias[0]) if relu else bias[0]))
    if relu:
        assert torch.all(out[:, 1] == 0) and torch.all(dx[:, 1] == 0)
        assert dscale[1] == 0 and dbias[1] == 0


@pytest.mark.parametrize("rows,C", [(163840, 64), (196608, 1024), (1000, 3)])
@pytest.mark.parametrize("dy_aligned", [True, False])
def test_batchnorm_relu_masks_agree(device, rows, C, dy_aligned):
    """The backward's relu mask, recomputed from x, is the forward's bit for
    bit, also when a misaligned dy takes the backward to one channel a
    thread: with integer dy, dbias is exactly the sum of dy where the
    forward's output is above 0, and dx is the closed form on the
    forward's mask (float64 statistics) within a quarter of the smallest
    |mul|, below any one element's dy * mul."""
    x, dy, scale, bias, mean0, var0 = _bn_inputs(rows, C, 7 * C,
                                                  integer_dy=True)
    if not dy_aligned:
        dy = torch.empty(rows * C + 1, device=device)[1:].view(rows, C
                                                              ).copy_(dy)
    out, dx, _, dbias, _, _ = _bn_run(T.batch_norm_train, x, dy, scale,
                                      bias, mean0, var0, True)
    g = (dy * (out > 0)).double()
    assert torch.equal(dbias.double(), g.sum(0))
    xd = x.double()
    mean, meansq = xd.mean(0), (xd * xd).mean(0)
    raw = meansq - mean * mean
    rstd = torch.rsqrt(torch.clamp_min(raw, 0.0) + 1e-5)
    mul = rstd * scale.double()
    xc = xd - mean
    sg, sgc = g.sum(0), (g * xc).sum(0)
    dvar = torch.where(raw >= 0, -0.5 * sgc * scale.double() * rstd ** 3,
                       0.0)
    want = g * mul - mul * sg / rows + 2 * dvar / rows * xc
    assert (dx.double() - want).abs().max() < 0.25 * mul.abs().min()


def test_batchnorm_update_false_leaves_running_statistics(device):
    """`update=False` (a remat recompute): the running statistics keep
    their bits, the output and gradients are those of an updating run."""
    inputs = _bn_inputs(163840, 64, 5)
    kept = _bn_run(T.batch_norm_train, *inputs, True, update=False)
    moved = _bn_run(T.batch_norm_train, *inputs, True)
    assert torch.equal(kept[4], inputs[4]) and torch.equal(kept[5], inputs[5])
    assert not torch.equal(moved[4], inputs[4])
    for a, b in zip(kept[:4], moved[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,C", [(163840, 64), (196608, 1024), (20480, 128),
                                    (1000, 3)])
@pytest.mark.parametrize("row_blocks", [1, 7])
def test_batchnorm_does_not_depend_on_its_plan(device, monkeypatch, rows, C,
                                               row_blocks):
    """J's sums are exact to f64 rounding, so the row slices of its plan do
    not change a bit of what it returns (as a rank of sync BatchNorm, with
    its share of the rows, or a card with another SM count, rounds as the
    one-process step does): the output, the running statistics and the
    gradients with `row_blocks` slices equal those with the plan's."""
    from dh3d_tpu_torch.ops import batchnorm

    inputs = _bn_inputs(rows, C, 3 * C + row_blocks)
    want = _bn_run(T.batch_norm_train, *inputs, True)
    plan = batchnorm._device_plan
    monkeypatch.setattr(batchnorm, "_device_plan",
                        lambda *a: (plan(*a)[0], row_blocks))
    got = _bn_run(T.batch_norm_train, *inputs, True)
    for name, a, b in zip(BN_OUTPUTS, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("stage", [2, 3])
def test_train_step_launches_j_once_a_pass_for_each_batchnorm(device, stage):
    """A stage-2 step (`detection_config`, 4 clouds of 4096 points) launches
    each of J's four entry points 11 times, once for each BatchNorm in
    train mode; a stage-3 step (`models/demo_stage3.config.json`, 12
    clouds of 4096 points; the backbone frozen in eval mode) 5 times, the
    head's; a forward in eval mode not at all."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.nn.layers import BatchNorm
    from dh3d_tpu_torch.train import (add_draws, init_state, make_train_step,
                                      synthetic_batches, to_device)

    if stage == 2:
        cfg = cfglib.get_config("detection_config")
        cfg.num_points, cfg.batch_size, cfg.sampled_kpnum = 4096, 4, 128
    else:
        cfg = cfglib.load_config("models/demo_stage3.config.json")
        cfg.num_points, cfg.batch_size = 4096, 1
    state = init_state(cfg, 0, "cuda")
    batch = add_draws(to_device(next(synthetic_batches(cfg, 0)), "cuda"), cfg)
    step = make_train_step(cfg)
    kernels.reset_counts()
    step(state, dict(batch))
    torch.cuda.synchronize()
    counts = kernels.counts()
    norms = [m for m in state.model.modules()
             if isinstance(m, BatchNorm) and m.training]
    assert len(norms) == {2: 11, 3: 5}[stage]
    assert all(counts[k] == len(norms) for k in BN_KERNELS), counts
    state.model.eval()
    kernels.reset_counts()
    kp = cfg.sampled_kpnum if (cfg.sampled_kpnum or 0) > 0 else None
    with torch.no_grad():
        state.model(torch.randn(2, 4096, 3, device=device) * 20,
                    sample_inds=None if kp is None else torch.arange(
                        kp, device=device).repeat(2, 1))
    torch.cuda.synchronize()
    assert all(kernels.counts()[k] == 0 for k in BN_KERNELS)
