"""The CSR inverse that kernels E and F read, and its sharing, on the CPU.

`inverse_neighbors` builds (rowptr [B, M + 1] int32, entries [B, N*K]
int32, each (n << 6) | k, ascending within a key) with PyTorch ops, so it
runs here as on the card; it is held to a numpy reference.  A test-only
walk over that structure in CSR order, written in PyTorch, is held to the
plain backwards (`weighted_sum_backward_plain`,
`neighbor_max_backward_plain`): it sums what kernels E and F sum, in the
order they sum it.  `NeighborInverse` builds once however often it is
asked, and the model hands one to every op over a neighbourhood.
"""

import numpy as np
import pytest
import torch

from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.ops import neighborhood

REL = 1e-5  # f32 sums in CSR order against index_add_ / scatter_add_


def _inverse_reference(nbh, M):
    """numpy: for each (b, j), the flat positions n*K + k where nbh = j."""
    B, N, K = nbh.shape
    return [[np.flatnonzero(nbh[b].reshape(-1) == j) for j in range(M)]
            for b in range(B)]


def _nbh(seed, B, N, M, K):
    """Ids in [0, M) with a repeated id in every neighbourhood and keys
    that no neighbourhood names (the last quarter of [0, M))."""
    rng = np.random.RandomState(seed)
    nbh = rng.randint(0, max(1, (3 * M) // 4), (B, N, K))
    nbh[:, :, K // 2] = nbh[:, :, 0]
    return nbh


@pytest.mark.parametrize("K", [3, 8, 16, 64])
@pytest.mark.parametrize("N,M", [(37, 37), (50, 23), (20, 90)])
def test_inverse_matches_numpy(K, N, M):
    nbh = _nbh(K * 1000 + N, 2, N, M, K)
    rowptr, ent = T.inverse_neighbors(torch.from_numpy(nbh), M)
    assert rowptr.dtype == ent.dtype == torch.int32
    assert rowptr.shape == (2, M + 1) and ent.shape == (2, N * K)
    ref = _inverse_reference(nbh, M)
    assert any(len(r) == 0 for r in ref[0])  # keys with no entries
    for b in range(2):
        assert rowptr[b, 0] == 0 and rowptr[b, M] == N * K
        for j in range(M):
            got = ent[b, rowptr[b, j]:rowptr[b, j + 1]].numpy()
            n, k = neighborhood.unpack_entries(got)
            np.testing.assert_array_equal(n * K + k, ref[b][j])


def test_entry_packing_and_order():
    """(n << 6) | k unpacks to the occurrence's n and k, and a key's
    entries ascend (the order E and F sum them)."""
    B, N, M, K = 2, 300, 40, 64
    nbh = torch.from_numpy(_nbh(7, B, N, M, K))
    rowptr, ent = T.inverse_neighbors(nbh, M)
    e = ent.long()
    n, k = neighborhood.unpack_entries(e)
    assert torch.equal(e, n << neighborhood.ENTRY_SHIFT | k)
    keys = torch.gather(nbh.reshape(B, -1), 1, n * K + k)
    owner = torch.repeat_interleave(
        torch.arange(M).repeat(B), (rowptr[:, 1:] - rowptr[:, :-1]).reshape(-1)
    ).reshape(B, -1)
    assert torch.equal(keys, owner)  # every entry names its own key
    same_key = owner[:, 1:] == owner[:, :-1]
    assert bool((e[:, 1:] > e[:, :-1])[same_key].all())
    assert int(n.max()) == N - 1 and int(k.max()) == K - 1


def test_inverse_refuses_what_int32_cannot_hold():
    nbh = torch.zeros(1, 2, 65, dtype=torch.int64)
    with pytest.raises(ValueError, match="K <= 64"):
        T.inverse_neighbors(nbh, 4)


def _csr_walk(rowptr, entries, term):
    """Sum term(b, n, k) -> [L, C] over each key's entries in CSR order:
    entry slot s of every key at step s, as kernels E and F walk them."""
    B, M = rowptr.shape[0], rowptr.shape[1] - 1
    rp, ent = rowptr.long(), entries.long()
    count = rp[:, 1:] - rp[:, :-1]
    batch = torch.arange(B)[:, None].expand(B, M)
    out = None
    for s in range(int(count.max())):
        live = count > s
        e = ent[batch[live], rp[:, :-1][live] + s]
        t = term(batch[live], *neighborhood.unpack_entries(e))
        if out is None:
            out = t.new_zeros(B, M, t.shape[-1])
        out[live] = out[live] + t
    return out


@pytest.mark.parametrize("P,C,N,M,K", [(4, 16, 60, 60, 8), (1, 24, 80, 30, 3),
                                       (2, 5, 40, 40, 16)])
def test_csr_walk_equals_weighted_sum_backward_plain(P, C, N, M, K):
    rng = np.random.RandomState(P * 100 + C)
    nbh = torch.from_numpy(_nbh(C, 2, N, M, K))
    dm = torch.from_numpy(rng.randn(2, N, P * C).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, N, K, P).astype(np.float32))
    d = dm.reshape(2, N, P, C)
    got = _csr_walk(*T.inverse_neighbors(nbh, M),
                    lambda b, n, k: torch.einsum("lp,lpc->lc", w[b, n, k],
                                                 d[b, n]))
    ref = T.weighted_sum_backward_plain(dm, nbh, w, M)
    assert (got - ref).abs().max() <= REL * ref.abs().max()


@pytest.mark.parametrize("C,N,M,K", [(8, 60, 60, 8), (3, 50, 20, 16)])
def test_csr_walk_equals_neighbor_max_backward_plain(C, N, M, K):
    rng = np.random.RandomState(C)
    nbh = torch.from_numpy(_nbh(C + 1, 2, N, M, K))
    feat = torch.from_numpy(rng.randint(0, 3, (2, M, C)).astype(np.float32))
    _, _, slot = T.neighbor_max_plain(feat, nbh)  # many ties: lowest k
    dval = torch.from_numpy(rng.randn(2, N, C).astype(np.float32))
    got = _csr_walk(*T.inverse_neighbors(nbh, M),
                    lambda b, n, k: torch.where(slot[b, n] == k[:, None],
                                                dval[b, n], 0.0))
    ref = T.neighbor_max_backward_plain(dval, nbh, slot, M)
    assert (got - ref).abs().max() <= REL * ref.abs().max()


@pytest.fixture
def count_builds(monkeypatch):
    """Every inverse built from here on, as the nbh tensor it was built
    from."""
    built = []
    real = neighborhood.inverse_neighbors

    def counted(nbh, M):
        built.append(nbh)
        return real(nbh, M)

    monkeypatch.setattr(neighborhood, "inverse_neighbors", counted)
    return built


def test_holder_builds_once(count_builds):
    nbh = torch.from_numpy(_nbh(3, 2, 30, 30, 8))
    inv = T.NeighborInverse(nbh, 30)
    assert count_builds == []  # nothing until asked
    first = inv.get()
    for _ in range(3):
        again = inv.get()
        assert again[0] is first[0] and again[1] is first[1]
    assert len(count_builds) == 1 and count_builds[0] is nbh


def test_backward_with_and_without_inverse():
    """`inverse=None` builds its own (on the card; the CPU takes the plain
    version either way); a holder of another neighbourhood is refused."""
    rng = np.random.RandomState(5)
    nbh = torch.from_numpy(_nbh(5, 2, 40, 40, 8))
    dm = torch.from_numpy(rng.randn(2, 40, 4 * 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 40, 8, 4).astype(np.float32))
    inv = T.NeighborInverse(nbh, 40)
    a = T.weighted_sum_backward(dm, nbh, w, 40, inv)
    b = T.weighted_sum_backward(dm, nbh, w, 40)
    assert torch.equal(a, b)
    assert torch.equal(a, T.weighted_sum_backward_plain(dm, nbh, w, 40))
    feat = torch.from_numpy(rng.randn(2, 40, 6).astype(np.float32))
    with pytest.raises(ValueError, match="another neighbourhood"):
        T.weighted_sum(feat, nbh.clone(), w, inv)
    with pytest.raises(ValueError, match="another neighbourhood"):
        T.neighbor_max(feat[:, :30].contiguous(), nbh[:, :, :3].clone() % 30,
                       inv)
    f = feat.clone().requires_grad_()
    val, _ = T.flex_pool(f, nbh, inv)
    val.sum().backward()
    g = feat.clone().requires_grad_()
    T.flex_pool(g, nbh)[0].sum().backward()
    assert torch.equal(f.grad, g.grad)


@pytest.mark.parametrize("cfg_name", ["detection_config", "global_config"])
def test_model_shares_one_inverse_per_neighbourhood(count_builds, cfg_name):
    """Every WeightedSum, FlexMoments and NeighborMax node of a train-mode
    forward holds the inverse of its own neighbourhood, one object for each of the
    three neighbourhoods (kNN at N, kNN at N/8, the 3-NN map); asking every
    node for its inverse, as the card's backward does, builds three."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.nn.model import DH3D

    cfg = cfglib.get_config(cfg_name)
    cfg.num_points, cfg.sampled_kpnum = 256, -1
    torch.manual_seed(0)
    model = DH3D(cfg).train()
    pts = torch.from_numpy(
        np.random.RandomState(1).randn(2, 256, 3).astype(np.float32) * 10)
    outs = model(pts)
    loss = sum(v.float().sum() for v in outs.values() if v.requires_grad)
    nodes, todo, seen = [], [loss.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ in ("WeightedSumBackward", "FlexMomentsBackward",
                                 "NeighborMaxBackward"):
            nodes.append(fn)
        todo.extend(f for f, _ in fn.next_functions)
    names = sorted(type(fn).__name__ for fn in nodes)
    # detection: 4 flex convs + upsample, 3 pools; global adds its stage's
    # flex conv and upsample over stage 2's neighbourhoods
    more = 0 if cfg_name == "detection_config" else 1
    assert names == (["FlexMomentsBackward"] * (4 + more)
                     + ["NeighborMaxBackward"] * 3
                     + ["WeightedSumBackward"] * (1 + more))
    inverses = {id(fn.inverse): fn.inverse for fn in nodes}
    assert len(inverses) == 3
    for fn in nodes:
        nbh = fn.saved_tensors[0]
        assert torch.equal(fn.inverse.nbh, nbh)
        fn.inverse.get()
    assert len(count_builds) == 3
    assert sorted(inv.m for inv in inverses.values()) == [32, 32, 256]


def test_backward_with_inverse_under_saved_tensor_hooks():
    """Saved-tensor hooks (offloading, recomputation) hand the backward a
    new nbh object: the inverse checked in the forward still serves."""
    rng = np.random.RandomState(9)
    nbh = torch.from_numpy(_nbh(9, 2, 40, 40, 8))
    feat = torch.from_numpy(rng.randn(2, 40, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 40, 8, 4).astype(np.float32))
    inv = T.NeighborInverse(nbh, 40)
    grads = []
    for hooks in (True, False):
        f = feat.clone().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: t.clone() if hooks else t, lambda t: t):
            out = T.weighted_sum(f, nbh, w, inv).sum() + T.flex_pool(
                f, nbh, inv)[0].sum()
        out.backward()
        grads.append(f.grad)
    assert torch.equal(grads[0], grads[1])
