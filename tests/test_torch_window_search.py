"""Kernel H's search (`csrc/knn_window.cu`) and its launch plan, on the
CPU.

The CUDA kernel runs only on the card (`tests/test_torch_cuda.py -k
window` and `tests/test_torch_cuda_paths.py -k window` hold it to the
plain version and its band starts to the formula there; PERF.md §6 times
it); here a model of its search, kept in this file: plain PyTorch that
follows the kernel's rule:
  - a group of L lanes a query; lane l visits the band rows l, l + L, ...
    of each staged pass of 1024 keys (the pass that holds the tile's
    centre first), in steps of 8 rows a lane (4 where the pass's rows a
    lane are not a multiple of 8), and keeps its own sorted list of KMAX
    (d2, index) pairs;
  - the fill: the first step is the one that holds the query's
    proportional position (clamped into the band); its pairs, sorted,
    fill the list, and the steps go on from there and wrap around;
  - the group's threshold before each step: the least of the lanes' last
    entries and the largest of their entries ceil(KMAX / L) - 1; a pair
    enters only below it;
  - the x-y exit: a step whose x-y partial sums all exceed the threshold's
    d2 ends before the z terms (the model asserts that such a step holds
    no pair the list would take);
  - the merge: k rounds of the least head over the group, popped by its
    lane.
It admits a step's pairs against the threshold at the step's start (the
kernel also tightens it inside a step), which changes what enters a list
but not the list a lane ends with.  It tests the rule, not the kernel: it
must equal `ops.knn_window_plain` bit for bit (NaN as NaN), and once the
Pallas banded kernel in interpret mode, on seeded clouds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dh3d_tpu.ops.pallas.knn_pallas import knn_banded
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.ops.knn import TILE_Q, WINDOW_LANES

STAGE = 1024  # band keys a staged pass
EMPTY = torch.iinfo(torch.int64).max  # an empty list entry
NAN_BITS = 0x7FC00000  # the canonical NaN: after +inf


def _kmax(k):
    return 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else 32


def _d2(q, kv):
    d = q - kv
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _pairs(d2, ids):
    """(d2's bits, NaN as the canonical NaN) << 32 | id, as int64."""
    bits = d2.view(torch.int32).to(torch.int64)
    bits = torch.where(torch.isnan(d2), NAN_BITS, bits)
    return (bits << 32) | ids


def _as_float(bits):
    return bits.to(torch.int32).view(torch.float32)


def _search(query, keys, k, window, lanes):
    """The model: (idx [B, N, k] int64, d2 [B, N, k] float32)."""
    B, N, _ = query.shape
    M = keys.shape[1]
    L, kmax, share = lanes, _kmax(k), -(-_kmax(k) // lanes) - 1
    s = T.win_start(N, M, window)  # [tiles]
    centre = (2 * torch.arange(N // TILE_Q) + 1) * TILE_Q * M // (2 * N)
    passes = -(-window // STAGE)
    first = ((centre - s) // STAGE).clamp(0, passes - 1)  # [tiles]
    s, first = (t.repeat_interleave(TILE_Q) for t in (s, first))  # [N]
    pos = (torch.arange(N) * M // N - s).clamp(0, window - 1)
    lane = torch.arange(L)
    qv = query[:, :, None, None, :]
    take = torch.arange(B)[:, None, None, None]

    def step_pairs(t0, step, u):
        """Each lane's u pairs of a step: ([B, N, u, L] x-y sums, pairs)."""
        rows = t0[:, None, None] + (step[:, None, None] * u + torch.arange(
            u)[:, None]) * L + lane  # [N, u, L]
        ids = s[:, None, None] + rows
        d = qv - keys[take, ids]
        xy = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        return xy, _pairs(xy + d[..., 2] * d[..., 2], ids)

    lists = None
    for pi in range(passes):
        t0 = (first + pi) % passes * STAGE  # [N]
        tn = (window - t0).clamp(max=STAGE)  # the same for a tile
        u = 8 if int(tn[0]) // L % 8 == 0 else 4
        assert (tn // L % u == 0).all()  # one step size for every tile
        steps = tn // (L * u)
        s0 = ((pos - t0) // L // u).clamp(min=0)
        s0 = torch.minimum(s0, steps - 1) if pi == 0 else torch.zeros_like(s0)
        for n in range(int(steps.max())):
            step = (s0 + n) % steps
            xy, pairs = step_pairs(t0, step, u)
            pairs = pairs.transpose(2, 3)  # [B, N, L, u]
            done = (n >= steps)[None, :, None, None]  # a narrower pass
            pairs = pairs.masked_fill(done, EMPTY)
            if lists is None:  # the first step fills the lists, sorted
                lists = torch.sort(pairs, -1).values[..., :kmax]
                lists = torch.cat([lists, torch.full(
                    (B, N, L, kmax - lists.shape[-1]), EMPTY)], -1)
                continue
            # the group's threshold: the least last entry and the largest
            # entry `share` of the lanes' lists
            thr = torch.minimum(lists[..., -1].amin(-1, keepdim=True),
                                lists[..., share].amax(-1, keepdim=True))
            near = (~(xy.transpose(2, 3) > _as_float(thr >> 32)[
                ..., None])).any(-1, keepdim=True)
            # the exit is exact: a step it ends holds no pair below thr
            assert ((pairs >= thr[..., None]) | near).all()
            cand = torch.where(near & (pairs < thr[..., None]), pairs, EMPTY)
            lists = torch.sort(torch.cat([lists, cand], -1),
                               -1).values[..., :kmax]

    out = []
    for _ in range(k):
        head = lists[..., 0]
        least = head.amin(-1)
        pop = (head == least[..., None])[..., None]
        lists = torch.where(pop, torch.cat(
            [lists[..., 1:], torch.full_like(lists[..., :1], EMPTY)], -1),
            lists)
        out.append(least)
    out = torch.stack(out, -1)
    assert (out != EMPTY).all()  # the lists held k pairs between them
    return out & 0xFFFFFFFF, _as_float(out >> 32)


def _cloud(kind, B, n, seed):
    """[B, n, 3] Morton-sorted float32 points of one kind."""
    g = torch.Generator().manual_seed(seed)
    if kind == "grid":  # integer coordinates: many equal distances
        pos = torch.randint(0, 5, (B, n, 3), generator=g).float()
    else:
        pos = torch.randn(B, n, 3, generator=g) * 30
    if kind == "duplicates":  # every point twice, at other rows
        pos[:, n // 2:] = pos[:, :n // 2][:, torch.randperm(n // 2,
                                                            generator=g)]
    perm, _ = T.morton_perm(pos)
    pos = torch.gather(pos, 1, perm[..., None].expand(-1, -1, 3))
    if kind == "nan":  # rows with a NaN coordinate, after the sort
        rows = torch.randperm(n, generator=g)[:n // 16]
        pos[:, rows, torch.randint(0, 3, (n // 16,), generator=g)] = \
            float("nan")
    return pos.contiguous()


def _assert_same(got, want):
    assert torch.equal(got[0], want[0]), "ids differ"
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0,
                               equal_nan=True)


KINDS = ["normal", "grid", "duplicates", "nan"]


@pytest.mark.parametrize("k", [1, 3, 8, 32])
@pytest.mark.parametrize("lanes", WINDOW_LANES)
def test_search_equals_plain(lanes, k):
    """Every plan at every k, self and cross, on each kind of cloud: the
    model's ids and d2 are the plain version's."""
    window = 256 if k <= 8 else 128
    for i, kind in enumerate(KINDS):
        keys = _cloud(kind, 1, 512, seed=100 * lanes + 10 * k + i)
        for query in (keys, _cloud(kind, 1, 1024, seed=7 + i)):
            _assert_same(_search(query, keys, k, window, lanes),
                         T.knn_window_plain(query, keys, k, window))


@pytest.mark.parametrize("lanes", [1, 8])
def test_search_over_two_passes(lanes):
    """A band wider than one staged pass (1024 + 256 rows)."""
    keys = _cloud("normal", 2, 2048, seed=3)
    _assert_same(_search(keys, keys, 8, 1280, lanes),
                 T.knn_window_plain(keys, keys, 8, 1280))


def test_search_equals_pallas_banded_kernel():
    """The model against the TPU kernel it stands for, unpacked, in
    interpret mode: ids equal, d2 within 1e-6 relative (the interpreter
    may fuse the squares into FMAs), at the plan of the path's shape."""
    keys = _cloud("normal", 2, 1024, seed=11)
    lanes = T.window_plan(8, 512, 2 * 1024)
    idx, d2 = _search(keys, keys, 8, 512, lanes)
    want_idx, want_d2 = knn_banded(jnp.asarray(keys.numpy()),
                                   jnp.asarray(keys.numpy()), 8, window=512,
                                   packed=False, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), rtol=1e-6,
                               atol=0)


def test_window_plan():
    """A plan of `WINDOW_LANES`, at least 16 keys a lane, fewer lanes for
    more queries; the path's four shapes (the legacy forward's and
    extraction's self kNN, a windowed level's kNN and 3-NN)."""
    for window in (128, 256, 512, 1024):
        for k in (1, 3, 8, 32):
            last = 32
            for queries in (256, 1024, 4096, 16384, 32768, 163840, 1 << 20):
                lanes = T.window_plan(k, window, queries)
                assert lanes in WINDOW_LANES
                assert window // lanes >= 16 and lanes <= last
                last = lanes
    assert [T.window_plan(k, w, q) for k, w, q in (
        (8, 512, 20 * 8192), (8, 512, 16384), (8, 512, 4096),
        (3, 256, 32768))] == [4, 4, 16, 4]
