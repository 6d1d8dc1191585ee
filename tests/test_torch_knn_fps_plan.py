"""Launch plans of kernels A (kNN) and B (FPS), and the rules that decide
their output, on the CPU.

The CUDA kernels run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`, which hold them against their plain versions); here:
  - `knn_plan` and `fps_plan`, pure functions of the shapes and the SM
    count, at the path's shapes and in their ranges, and `knn_slabs`, the
    key ranges of kernel A's slabs;
  - a model of kernel A's slab split and merge, kept in this file: plain
    PyTorch that follows `csrc/knn.cu` (each slab's ascending scan with a
    strict `<`, lists padded with (+inf, 0), a merge that takes the lower
    slab on equal distances).  It tests the rule, not the kernel: it must
    equal `ops.knn_plain` and the Pallas kNN in interpret mode on
    integer-grid clouds whose equal distances are exact;
  - kernel B's candidate order: the packed key (distance bits << 32 |
    ~index) and the two-step redux (the largest bits, then the lowest index
    among them) against numpy's first-occurrence argmax.
Inputs come from numpy seeds; every comparison is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu.ops.pallas.knn_pallas import knn_pallas
from dh3d_tpu_torch import ops as T

# the modules (`ops.knn` is also the name of the function)
knn_ops = importlib.import_module("dh3d_tpu_torch.ops.knn")
sampling = importlib.import_module("dh3d_tpu_torch.ops.sampling")

H100_SMS = 132

# (B, Nq, Nk, k): the main path's kNN shapes (self at N and N/8, the 3-NN,
# the detection loss's cross query, the extraction's self kNN) and small ones
KNN_SHAPES = [(20, 8192, 8192, 8), (20, 1024, 1024, 8), (20, 8192, 1024, 3),
              (10, 512, 8192, 16), (1, 16384, 16384, 8), (1, 2048, 2048, 8),
              (2, 300, 40, 32), (3, 1000, 130, 3), (40, 8192, 8192, 8)]


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("B,Nq,Nk,k", KNN_SHAPES)
def test_knn_plan_is_one_kernel_a_takes(B, Nq, Nk, k, sms):
    """S in [1, min(64, Nk)], so its slabs cover [0, Nk) in ascending
    contiguous ranges; more clouds never take more slabs."""
    s = knn_ops.knn_plan(B, Nq, Nk, k, sms)
    assert 1 <= s <= min(64, Nk)
    slabs = knn_ops.knn_slabs(Nk, s)
    assert len(slabs) == s and slabs[0][0] == 0 and slabs[-1][1] == Nk
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert knn_ops.knn_plan(2 * B, Nq, Nk, k, sms) <= s


def test_knn_plan_at_the_paths_shapes():
    """S = 1 where B * Nq fills the card (the train step's and forward's
    self kNN and 3-NN); S > 1 for the detection loss's [10, 512] x
    [10, 8192] (20 blocks of queries) and the extraction's [1, 16384]."""
    for shape in ((20, 8192, 8192, 8), (20, 1024, 1024, 8),
                  (20, 8192, 1024, 3)):
        assert knn_ops.knn_plan(*shape, H100_SMS) == 1
    assert knn_ops.knn_plan(10, 512, 8192, 16, H100_SMS) == 4
    assert knn_ops.knn_plan(1, 16384, 16384, 8, H100_SMS) == 8


@pytest.mark.parametrize("nk,s", [(10, 4), (10, 6), (40, 7), (8192, 3),
                                  (5, 5)])
def test_knn_slabs_cover_the_keys(nk, s):
    """Every split the entry point takes (S <= Nk), empty last slabs
    included: contiguous, ascending, covering [0, Nk)."""
    slabs = knn_ops.knn_slabs(nk, s)
    assert len(slabs) == s
    assert [j for lo, hi in slabs for j in range(lo, hi)] == list(range(nk))
    assert all(lo <= hi for lo, hi in slabs)


def _slab_merge_model(query, keys, k, s):
    """A model of kernel A with S slabs, in plain PyTorch (not the kernel,
    which only the card runs): each slab's list starts as
    k copies of (+inf, 0) and takes its keys in ascending order on a strict
    `<` (a stable sort of the slab's d2: the same list); the merge takes,
    k times, the smallest head, the lowest slab on equal distances."""
    B, Nq, _ = query.shape
    lists_d, lists_i = [], []
    for lo, hi in knn_ops.knn_slabs(keys.shape[1], s):
        d = torch.full((B, Nq, k), float("inf"))
        i = torch.zeros(B, Nq, k, dtype=torch.int64)
        n = min(k, hi - lo)
        if n:
            si, sd = T.knn_plain(query, keys[:, lo:hi].contiguous(), n)
            d[..., :n], i[..., :n] = sd, si + lo
        lists_d.append(d)
        lists_i.append(i)
    heads = torch.stack(lists_d, -2)  # [B, Nq, S, k]
    ids = torch.stack(lists_i, -2)
    pos = torch.zeros(B, Nq, s, dtype=torch.int64)
    out_d = torch.empty(B, Nq, k)
    out_i = torch.empty(B, Nq, k, dtype=torch.int64)
    for r in range(k):
        head = torch.gather(heads, 3, pos.clamp(max=k - 1)[..., None])[..., 0]
        head = torch.where(pos < k, head, torch.full_like(head, float("inf")))
        best = torch.argmin(head, dim=-1, keepdim=True)  # first: lower slab
        at = torch.gather(pos, 2, best)
        out_d[..., r] = torch.gather(head, 2, best)[..., 0]
        out_i[..., r] = torch.gather(
            torch.gather(ids, 2, best[..., None].expand(-1, -1, 1, k))[:, :, 0],
            2, at)[..., 0]
        pos.scatter_add_(2, best, torch.ones_like(best))
    return out_i, out_d


def _grid_cloud(seed, b, n, side=4):
    """Integer-grid points with many duplicates: d2 is exact in f32, so
    equal distances are real ties."""
    return np.random.RandomState(seed).randint(0, side, (b, n, 3)).astype(
        np.float32)


_PALLAS = {}


def _pallas_knn(query, keys, k):
    """`knn_pallas` in interpret mode (the exact kernel below k = 32, the
    slab kernel at 32), once per k."""
    if k not in _PALLAS:
        pi, pd = knn_pallas(jnp.asarray(query), jnp.asarray(keys), k,
                            interpret=True)
        _PALLAS[k] = (np.asarray(pi), np.asarray(pd))
    return _PALLAS[k]


@pytest.mark.parametrize("s", [1, 2, 3, 7])
@pytest.mark.parametrize("k", [3, 8, 16, 32])
def test_slab_merge_equals_plain_and_pallas(k, s):
    """On 48 keys (slabs of 7 at S = 7: shorter than k from k = 8) the
    merged slab lists equal the plain version (ids and d2) and the Pallas
    kNN (ids; d2 exact on the grid)."""
    keys = _grid_cloud(1, 1, 48)
    query = np.concatenate([keys[:, :20], _grid_cloud(2, 1, 13)], axis=1)
    tq, tk = torch.from_numpy(query), torch.from_numpy(keys)
    mi, md = _slab_merge_model(tq, tk, k, s)
    pi, pd = T.knn_plain(tq, tk, k)
    assert torch.equal(mi, pi) and torch.equal(md, pd)
    ji, jd = _pallas_knn(query, keys, k)
    np.testing.assert_array_equal(mi.numpy(), ji)
    np.testing.assert_array_equal(md.numpy(), jd)


@pytest.mark.parametrize("s", [2, 7])
def test_slab_merge_self_query_with_duplicates(s):
    """Self kNN over a cloud with exact duplicates: a point's lower twin
    comes first, then the point itself, across slab boundaries."""
    pts = _grid_cloud(3, 2, 200, side=5)
    pts[:, 150:170] = pts[:, 10:30]
    t = torch.from_numpy(pts)
    mi, md = _slab_merge_model(t, t, 16, s)
    pi, pd = T.knn_plain(t, t, 16)
    assert torch.equal(mi, pi) and torch.equal(md, pd)
    assert (md[..., 0] == 0).all()


def _packed(v, i):
    """Kernel B's packed key: the f32 bits of v >= +0 above ~index."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (~np.asarray(i, np.uint32)).astype(
        np.uint64)


ARGMAX_CASES = {
    "ties": np.array([1.0, 3.0, 2.0, 3.0, 3.0, 0.5]),
    "zeros": np.array([0.0, 0.0, 0.0, 0.0]),
    "zero after positive": np.array([0.0, 1e-45, 0.0, 1e-45]),
    "large": np.array([3.0e38, 1.0, 3.4028235e38, 3.4028235e38, 2.0]),
    "inf": np.array([5.0, np.inf, 7.0, np.inf, np.inf]),
    "random": np.random.RandomState(4).rand(1000) * 100,
}


@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_packed_argmax_key_gives_the_first_occurrence(case):
    """The largest packed key and the two-step redux both give argmax's
    first occurrence of the largest distance."""
    v = ARGMAX_CASES[case].astype(np.float32)
    i = np.arange(len(v))
    key = _packed(v, i).max()
    assert (~np.uint32(key & np.uint64(0xffffffff))) == np.argmax(v)
    assert np.uint32(key >> np.uint64(32)).view(np.float32) == v.max()
    bits = v.view(np.uint32)
    top = bits.max()
    assert i[bits == top].min() == np.argmax(v)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("B,N", [(20, 8192), (1, 16384), (1, 9000),
                                 (1, 40000), (20, 1024), (1, 140000),
                                 (2, 3000), (60, 8192), (100, 16384)])
def test_fps_plan_is_one_kernel_b_takes(B, N, sms):
    """C in [1, 8]; T = 128 in a cluster, whose C * T / 32 warps fit the
    kernel's 32 candidate slots, 256 for one block; a larger cloud never
    takes fewer blocks, more clouds never more."""
    c, t = sampling.fps_plan(B, N, sms)
    assert 1 <= c <= 8
    assert t == (128 if c > 1 else 256) and (c == 1 or c * t // 32 <= 32)
    assert sampling.fps_plan(B, 2 * N, sms)[0] >= c
    assert sampling.fps_plan(2 * B, N, sms)[0] <= c


def test_fps_plan_at_the_paths_shapes():
    """The sweep's choices: 4 blocks of 128 threads a cloud at B = 20 (5
    clusters of 8 would not all fit the 8 GPCs at once), 8 at B = 1."""
    assert sampling.fps_plan(20, 8192, H100_SMS) == (4, 128)
    for n in (16384, 9000, 40000):
        assert sampling.fps_plan(1, n, H100_SMS) == (8, 128)
