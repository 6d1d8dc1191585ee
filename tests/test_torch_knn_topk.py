"""Kernel G's pruned search (`csrc/knn_topk.cu`), its launch plan and the
rule that routes `knn` between kernels A and G, on the CPU.

The CUDA kernel runs only on the card (`tests/test_torch_cuda.py` holds
it to the plain version there; PERF.md §6 times it); here:
  - a model of its search, kept in this file: plain PyTorch that follows
    the kernel's rule (keys sorted by a 15-bit Z-order cell of the keys'
    occupied-bin frame, any order within a cell; a box and a lowest index
    per chunk of 32 keys and per 32 chunks; a list filled from the chunks
    around the query's position; groups, then chunks, nearest box first, a
    box visited only when (its bound, its lowest index) comes before the
    k-th pair; selection by the pair (d2, index)).  It tests the rule, not
    the kernel: it must equal `ops.knn_plain` and the Pallas slab kNN in
    interpret mode, and give the same result for two orders within the
    cells;
  - the frame: monotone in each coordinate, and blind to empty stretches,
    so a cloud padded with the eval loader's 1e5 sentinels still spreads
    over the cells and its boxes still prune;
  - the box bound: in float32 with separately rounded operations it is <=
    the rounded d2 of every key in the box, bit for bit;
  - `topk_plan`, and which kernel `knn` launches for which k (with the
    launches recorded instead of made).
Inputs come from numpy seeds; every comparison is exact.
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu.ops.pallas.knn_pallas import knn_pallas
from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T

knn_ops = importlib.import_module("dh3d_tpu_torch.ops.knn")

AXIS_BITS = 5  # the kernel's cell code: 5 bits an axis
BINS = 4096  # bins an axis of the occupied-bin frame
CHUNK = knn_ops.TOPK_CHUNK
PAD = 0x7FFFFFFF  # the index of a pad entry


def _list(k):
    """Entries of G's per-query list at k: 32 * R."""
    return 32 if k <= 32 else 64 if k <= 64 else 128


def _d2(q, pts):
    """d2 from q [3] to pts [n, 3], each operation rounded on its own."""
    d = q - pts
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _box_bound(q, lo, hi):
    """The kernel's bound from q [3] to boxes [n, 3]: q clamped to the box,
    then d2's rounded operations."""
    return _d2(q, torch.minimum(torch.maximum(q, lo), hi))


def _frame(keys):
    """The kernel's occupied-bin frame of keys [n, 3]: a function from
    points [m, 3] to their 5-bit cell [m, 3] on each axis.  Each axis of
    the keys' box is cut into BINS bins; a coordinate's cell is (the
    occupied bins below its own + its place in its bin, if occupied) * 32
    over the occupied bins, in float32 as the kernel rounds it."""
    lo = keys.amin(0)
    scale = torch.tensor(float(BINS)) / torch.clamp_min(keys.amax(0) - lo,
                                                        1e-30)

    def bins(points):
        t = torch.clamp((points - lo) * scale, 0, BINS)
        return torch.clamp_max(t.long(), BINS - 1), t

    occupied = torch.zeros(3, BINS, dtype=torch.bool)
    for a, b in enumerate(bins(keys)[0].T):
        occupied[a, b] = True
    rank = torch.cumsum(occupied, 1) - occupied.long()  # occupied below
    cells = torch.tensor(float(1 << AXIS_BITS)) / occupied.sum(1).float()

    def cell(points):
        b, t = bins(points)
        axes = torch.arange(3)
        occ = occupied[axes, b]
        within = torch.where(occ, torch.clamp_max(t - b.float(), 1.0), 0.0)
        c = (rank[axes, b].float() + within) * cells
        return torch.clamp_max(c.long(), (1 << AXIS_BITS) - 1)

    return cell


def _code(cells):
    """Z-order code of [m, 3] axis cells: bit b of axis a at 3b + a."""
    code = torch.zeros(cells.shape[0], dtype=torch.int64)
    for b in range(AXIS_BITS):
        for a in range(3):
            code |= ((cells[:, a] >> b) & 1) << (3 * b + a)
    return code


def _boxes(pts, size):
    """(lo, hi) [ceil(n / size), 3] of consecutive runs of `size` rows."""
    n = -(-pts.shape[0] // size)
    lo = torch.stack([pts[i * size:(i + 1) * size].amin(0) for i in range(n)])
    hi = torch.stack([pts[i * size:(i + 1) * size].amax(0) for i in range(n)])
    return lo, hi


def _select(ld, li, d, j, keep):
    """The `keep` first pairs of the list and (d, j), by (d2, index)."""
    d, j = torch.cat([ld, d]), torch.cat([li, j])
    order = np.lexsort((j.numpy(), d.numpy()))[:keep]
    return d[order], j[order]


def _before(ad, ai, bd, bi):
    return bool(ad < bd or (ad == bd and ai < bi))


def _pruned_search(query, keys, k, self_query, tie_seed, rows=None):
    """The model of kernel G on one cloud: query [Nq, 3], keys [Nk, 3]
    float32 -> (idx [Nq, k] int64, d2 [Nq, k], chunks visited beyond the
    fill [Nq]).  `tie_seed` orders the keys within a cell (the kernel's
    atomics leave any order); `rows`, where given, the only queries
    searched (the others' rows are left at 0)."""
    nk = keys.shape[0]
    F = _list(k)  # the list, and the fill window's keys
    R = F // CHUNK
    cell = _frame(keys)
    kc = _code(cell(keys))
    tie = np.random.RandomState(tie_seed).permutation(nk)
    order = torch.from_numpy(np.lexsort((tie, kc.numpy())))
    table, ids = keys[order], order
    ends = torch.cumsum(torch.bincount(kc, minlength=1 << 3 * AXIS_BITS), 0)
    nchunks = -(-nk // CHUNK)
    clo, chi = _boxes(table, CHUNK)
    clow = torch.stack([ids[c * CHUNK:(c + 1) * CHUNK].min()
                        for c in range(nchunks)])
    glo, ghi = _boxes(clo, 32)[0], _boxes(chi, 32)[1]
    glow = torch.stack([clow[g * 32:(g + 1) * 32].min()
                        for g in range(-(-nchunks // 32))])
    if self_query:
        qids, qpts, pos = ids, table, torch.arange(nk)
    else:
        qids, qpts = torch.arange(query.shape[0]), query
        qc = _code(cell(query))
        start = torch.where(qc > 0, ends[(qc - 1).clamp_min(0)], 0)
        pos = torch.clamp_max((start + ends[qc]) // 2, nk - 1)
    out_i = torch.zeros(qpts.shape[0], k, dtype=torch.int64)
    out_d = torch.zeros(qpts.shape[0], k)
    visits = torch.zeros(qpts.shape[0], dtype=torch.int64)
    for q, qid, p in zip(qpts, qids, pos.tolist()):
        if rows is not None and int(qid) not in rows:
            continue
        c0 = min(max(0, p - 16 * R + 16) // CHUNK, max(0, nchunks - R))
        s = torch.arange(c0 * CHUNK, c0 * CHUNK + F)
        real = s < nk
        ld = torch.full((F,), float("inf"))
        li = torch.full((F,), PAD, dtype=torch.int64)
        ld[real] = _d2(q, table[s[real]])
        li[real] = ids[s[real]]
        ld, li = _select(ld, li, ld[:0], li[:0], F)
        glb = _box_bound(q, glo, ghi)
        for g in np.lexsort((np.arange(len(glb)), glb.numpy())):
            if glb[g] > ld[k - 1]:
                break  # every box after it is as far
            if not _before(glb[g], glow[g], ld[k - 1], li[k - 1]):
                continue
            cs = torch.arange(32 * g, min(nchunks, 32 * (g + 1)))
            cs = cs[(cs < c0) | (cs >= c0 + R)]  # the fill's are in
            clb = _box_bound(q, clo[cs], chi[cs])
            for i in np.lexsort((cs.numpy(), clb.numpy())):
                c = int(cs[i])
                if clb[i] > ld[k - 1]:
                    break
                if not _before(clb[i], clow[c], ld[k - 1], li[k - 1]):
                    continue
                visits[qid] += 1
                d = _d2(q, table[c * CHUNK:(c + 1) * CHUNK])
                j = ids[c * CHUNK:(c + 1) * CHUNK]
                kd, kj = ld[k - 1], li[k - 1]
                cand = (d < kd) | ((d == kd) & (j < kj))
                ld, li = _select(ld, li, d[cand], j[cand], F)
        out_i[qid], out_d[qid] = li[:k], ld[:k]
    return out_i, out_d, visits


def _model(query, keys, k, tie_seed=0):
    """The model over a batch [B, N, 3]; self queries when query is keys."""
    outs = [_pruned_search(q, kk, k, query is keys, tie_seed)
            for q, kk in zip(query, keys)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _cloud(kind, k, seed):
    """(query, keys) [B, N, 3] float32 for one kind of input; query is keys
    for self queries."""
    rng = np.random.RandomState(seed)
    if kind == "grid":  # many equal distances at the k-th slot
        keys = rng.randint(0, 8, (1, 300, 3)).astype(np.float32)
    elif kind == "nk == k":
        keys = (rng.randn(1, k, 3) * 3).astype(np.float32)
    else:
        n = 301 if kind == "ragged" else 256
        keys = (rng.randn(1 if kind != "batch" else 2, n, 3) * 3).astype(
            np.float32)
    if kind == "duplicates":  # twins in other chunks, lower and higher
        keys[:, 200:240] = keys[:, 0:40]
        keys[:, 70:130:3] = keys[:, 150:170]
    elif kind == "padded":  # `get_fixednum_pcd`'s undersized cloud
        keys[:, 190:] = 1e5
    elif kind == "mostly padded":  # pads above and among the k nearest
        keys[:, 90:] = 1e5
    elif kind == "outlier":  # one far point stretches the keys' box
        keys[:, 17] = (-4e4, 3e4, 2e3)
    keys = torch.from_numpy(keys)
    if kind == "morton":
        perm, _ = T.morton_perm(keys)
        keys = torch.gather(keys, 1, perm[..., None].expand(-1, -1, 3))
        keys = keys.contiguous()
    if kind != "batch":
        return keys, keys
    query = torch.from_numpy((rng.randn(2, 150, 3) * 4).astype(np.float32))
    query[:, :10] = keys[:, 5:15]  # on keys
    query[:, 10:20] *= 10  # beyond the keys' box
    return query.contiguous(), keys


_PALLAS = {}


def _pallas(kind, k, query, keys):
    """`knn_pallas` in interpret mode (its slab kernel at k >= 32), once per
    input and k."""
    if (kind, k) not in _PALLAS:
        pi, pd = knn_pallas(jnp.asarray(query.numpy()),
                            jnp.asarray(keys.numpy()), k, interpret=True)
        _PALLAS[kind, k] = (np.asarray(pi), np.asarray(pd))
    return _PALLAS[kind, k]


KINDS = ["grid", "duplicates", "padded", "mostly padded", "outlier",
         "random", "morton", "ragged", "nk == k", "batch"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [33, 50, 64, 128])
def test_pruned_search_equals_plain(k, kind):
    """The model of G equals the plain version (ids and d2, bit for bit)
    and gives the same for another order within the cells; on the grid,
    the duplicates and the padded clouds also the Pallas slab kNN in
    interpret mode (ids; d2 exact on the grid, to 1e-6 relative elsewhere:
    the interpreter may fuse the d2 build into FMAs)."""
    query, keys = _cloud(kind, k, k)
    mi, md = _model(query, keys, k)
    pi, pd = T.knn_plain(query, keys, k)
    assert torch.equal(mi, pi) and torch.equal(md, pd)
    oi, od = _model(query, keys, k, tie_seed=1)
    assert torch.equal(oi, mi) and torch.equal(od, md)
    if kind in ("grid", "duplicates", "padded", "mostly padded"):
        ji, jd = _pallas(kind, k, query, keys)
        np.testing.assert_array_equal(mi.numpy(), ji)
        np.testing.assert_allclose(md.numpy(), jd, rtol=1e-6)


@pytest.mark.parametrize("kind", ["grid", "duplicates", "mostly padded",
                                  "batch"])
@pytest.mark.parametrize("k", [1, 8, 16, 32])
def test_pruned_search_small_k(k, kind):
    """k <= 32 (a list of 32, one chunk of fill), which the path sends to
    G from k = 8 up: the model equals the plain version, self and cross."""
    query, keys = _cloud(kind, k, 40 + k)
    mi, md = _model(query, keys, k)
    pi, pd = T.knn_plain(query, keys, k)
    assert torch.equal(mi, pi) and torch.equal(md, pd)


@pytest.mark.parametrize("seed", range(4))
def test_box_bound_never_exceeds_a_members_d2(seed):
    """On random boxes of random points, the bound from queries inside,
    outside, on a face, an edge and a corner is <= the rounded d2 of each
    point in the box, and 0 inside; equal where the nearest point is a
    corner of the box on the query's side."""
    rng = np.random.RandomState(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    pts = torch.from_numpy((rng.randn(64, 3) * scale).astype(np.float32))
    lo, hi = pts.amin(0), pts.amax(0)
    q = torch.from_numpy((rng.randn(400, 3) * 2 * scale).astype(np.float32))
    q[:50] = pts[:50]  # inside
    q[50:100, 0] = lo[0]  # on a face
    q[100:150, :2] = hi[:2]  # on an edge
    q[150:160] = lo  # on a corner
    q[160:200] = lo + (pts[:40] - lo) * 0.5  # inside
    for qq in q:
        lb = _box_bound(qq, lo[None], hi[None])[0]
        assert (lb <= _d2(qq, pts)).all()
        if ((qq >= lo) & (qq <= hi)).all():
            assert lb == 0
    corner = torch.stack([lo, hi]).gather(0, torch.tensor([[0, 1, 0]]))[0]
    pts2 = torch.cat([pts, corner[None]])
    lo2, hi2 = pts2.amin(0), pts2.amax(0)
    far = corner + torch.tensor([-3.0, 3.0, -3.0]) * scale
    assert _box_bound(far, lo2[None], hi2[None])[0] == _d2(far, pts2).min()


def _eval_cloud(numpts, n_points, seed=0):
    """A synthetic scan through the eval loader's normalisation ([numpts,
    3], the real points first, then the 1e5 sentinels where the scan keeps
    fewer than numpts) and its count of real points."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan

    cloud, real = get_fixednum_pcd(
        lidar_like_scan(seed, n_points=n_points, extent=12.0), numpts,
        randsample=False, need_downsample=True,
        rng=np.random.RandomState(seed))
    return torch.from_numpy(cloud), real


@pytest.mark.parametrize("kind", ["gaussian", "padded", "outlier"])
def test_frame_is_monotone_and_blind_to_empty_stretches(kind):
    """Each axis's cell never decreases with the coordinate; the real
    points of a padded eval cloud (and of a cloud with one far point) take
    at least 16 of the 32 cells of x and y (32 over the occupied bins: the
    cloud's and the pads' at the least), where the keys' plain box would
    squeeze them into one."""
    rng = np.random.RandomState(5)
    if kind == "padded":
        keys, real = _eval_cloud(4096, 3000)
        assert real < 4096 and (keys[real:] == 1e5).all()
    else:
        keys = torch.from_numpy((rng.randn(2000, 3) * 10).astype(np.float32))
        real = 2000
        if kind == "outlier":
            keys[7] = torch.tensor([5e4, -5e4, 5e4])
    cells = _frame(keys)(keys)
    for a in range(3):
        order = torch.argsort(keys[:, a], stable=True)
        assert (torch.diff(cells[order, a]) >= 0).all(), a
    ours = cells[:real] if kind == "padded" else torch.cat(
        [cells[:7], cells[8:]])
    for a in range(2):
        assert len(torch.unique(ours[:, a])) >= 16, (a, ours[:, a].unique())


@pytest.mark.parametrize("k", [8, 50])
def test_boxes_prune_a_padded_eval_cloud(k):
    """On an undersized scan padded with 1e5 sentinels (the eval loader's
    rows), the model equals the plain version on every 16th query, and a
    real query visits at most 10% of the chunks beyond its fill (the
    boxes prune; ~10% of chunks on an unpadded cloud); a pad query, whose
    k nearest are pads at d2 = 0, visits each pad chunk at most once, and
    at k = 8 the lowest-index test skips more than half of them."""
    keys, real = _eval_cloud(4096, 3000, seed=1)
    rows = set(range(0, 4096, 16))
    mi, md, visits = _pruned_search(keys, keys, k, True, 0, rows=rows)
    pi, pd = T.knn_plain(keys[None], keys[None], k)
    sel = torch.tensor(sorted(rows))
    assert torch.equal(mi[sel], pi[0, sel]) and torch.equal(md[sel],
                                                            pd[0, sel])
    nchunks = -(-4096 // CHUNK)
    real_rows = sel[sel < real]
    assert visits[real_rows].float().mean() <= 0.1 * nchunks, \
        visits[real_rows].float().mean()
    pad_chunks = nchunks - real // CHUNK
    pads = visits[sel[sel >= real]]
    assert (pads <= pad_chunks).all()
    if k == 8:
        assert pads.float().mean() < 0.5 * pad_chunks, pads.float().mean()


def test_topk_plan_is_a_rule_of_k():
    """Merge (1) above k = 32, where G's list holds 64 or 128 pairs, insert
    (0) at or below it; at the path's k: 8 and 16 insert, 50 merges."""
    for k in range(1, 129):
        assert knn_ops.topk_plan(k) == (1 if k > 32 else 0), k
    assert [T.topk_plan(k) for k in (8, 16, 50)] == [0, 0, 1]


@pytest.fixture
def launches(monkeypatch):
    """`knn` with its CPU tensors taken for CUDA ones and the launches
    recorded, not made: [(kernel name, k, plan)]."""
    made = []

    def record(kernel):
        def launch(device, *args):
            ints = [a for t, a in zip(kernel.argtypes, args)
                    if t is ctypes.c_int]
            made.append((kernel.name, ints[3],
                         ints[4] if len(ints) > 4 else None))
        return launch

    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "topk_workspace_bytes", lambda *a: 16)
    for kernel in (kernels.KNN, kernels.KNN_TOPK):
        monkeypatch.setattr(kernel, "launch", record(kernel))
    return made


@pytest.mark.parametrize("k", [1, 3, 7, 8, 16, 32, 33, 50, 128])
def test_knn_launches_a_below_k8_and_g_from_it(launches, k):
    """Kernel A for k <= 7 (the 3-NN), kernel G for 8 <= k <= 128 with
    `topk_plan`'s merge; a plan given sends any k to G."""
    pts = torch.zeros(2, 200, 3)
    T.knn(pts, pts, k)
    T.knn(pts, pts, k, plan=1 - T.topk_plan(k))
    own = ("knn", k, None) if k <= 7 else ("knn_topk", k, T.topk_plan(k))
    assert launches == [own, ("knn_topk", k, 1 - T.topk_plan(k))]


def test_knn_above_kernel_g_limit_raises_before_a_launch(launches):
    pts = torch.zeros(1, 200, 3)
    with pytest.raises(ValueError, match="k <= 128"):
        T.knn(pts, pts, 129)
    assert launches == []
