"""The legacy Morton-band mode (`morton_exact=False`) of the PyTorch port
against the JAX package's, on the CPU.

Kernel H's plain version, `knn_window_plain`, is held to the Pallas kernel
it ports, `knn_banded(..., packed=False)` in interpret mode: ids equal, d2
within 1e-6 relative (the interpreter may fuse the squares into FMAs;
both build them from the same rounded differences).  `win_start` equals
the Pallas `_win_start` for every tile at every shape the path gives it.

Then the legacy forward and one legacy train step against the JAX model.
JAX on the CPU ignores `window` (its kNN takes the exact XLA route there),
so the `jax_bands` fixture routes every windowed `dh3d_tpu.ops.knn_bruteforce`
and `three_nn` call as the TPU does, to `knn_banded(packed=False,
interpret=True)`; nothing in `dh3d_tpu` changes.  Tolerances are
`test_torch_model.py`'s (forward) and `test_torch_train.py`'s (step).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dh3d_tpu.ops as jops
from dh3d_tpu import config as jcfg
from dh3d_tpu.nn import DH3D as JaxDH3D
from dh3d_tpu.nn import init_variables
from dh3d_tpu.ops.pallas.knn_pallas import _win_start, knn_banded
from dh3d_tpu_torch import config as tcfg
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.entry import entry_config, entry_points
from dh3d_tpu_torch.eval import make_forward
from dh3d_tpu_torch.nn import DH3D, load_flax
from dh3d_tpu_torch.train import synthetic_batches
from test_torch_model import _compare, flatten_variables
from test_torch_train import _compare_step

knn_ops = importlib.import_module("dh3d_tpu_torch.ops.knn")
interp_ops = importlib.import_module("dh3d_tpu_torch.ops.interpolate")

D2_REL = 1e-6


def _sorted_cloud(rng, B, N, scale=30.0, duplicates=False):
    """B Morton-sorted clouds of N points, [B, N, 3] float32 numpy."""
    pts = rng.randn(B, N, 3).astype(np.float32) * np.float32(scale)
    if duplicates:  # every point twice, at other rows
        pts[:, N // 2:] = pts[:, :N // 2][:, rng.permutation(N // 2)]
    t = torch.from_numpy(pts)
    perm, _ = T.morton_perm(t)
    return torch.gather(t, 1, perm[..., None].expand(-1, -1, 3)).numpy()


def _pallas(query, keys, k, window):
    idx, d2 = knn_banded(jnp.asarray(query), jnp.asarray(keys), k,
                         window=window, packed=False, interpret=True)
    return np.asarray(idx), np.asarray(d2)


@pytest.mark.parametrize("nq,nk,window", [
    (256, 128, 128), (1024, 1024, 512), (2048, 2048, 512), (2048, 256, 256),
    (5120, 2560, 256), (8192, 8192, 512), (16384, 16384, 512),
    (32768, 32768, 512), (32768, 4096, 256), (32768, 4096, 512)])
def test_win_start_matches_pallas(nq, nk, window):
    """Every tile's band start, self and cross, at the path's shapes
    (level 0, a windowed level's kNN and 3-NN, extraction, N <= 32768)."""
    tiles = jnp.arange(nq // 256, dtype=jnp.int32)
    want = np.asarray(_win_start(tiles, 256, window, nq, nk))
    got = T.win_start(nq, nk, window).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= nk - window
    assert (got % 128 == 0).all()


def test_win_start_in_64_bits_where_pallas_wraps():
    """Above N = 32768 the Pallas start's int32 product wraps; the port's
    does not (no caller reaches that size: the eval clouds are at most
    16384 points)."""
    nq = 33024
    got = T.win_start(nq, nq, 512).numpy()
    assert got[-1] == nq - 512  # the last tile's band is the table's end
    pallas = np.asarray(_win_start(jnp.arange(nq // 256, dtype=jnp.int32),
                                   256, 512, nq, nq))
    assert pallas[-1] == 0


@pytest.mark.parametrize("nq,nk,window,k,kind", [
    (512, 512, 128, 8, "self"),
    (1024, 1024, 256, 8, "self"),
    (2048, 2048, 512, 8, "self"),
    (1024, 1024, 512, 16, "duplicates"),
    (512, 512, 128, 32, "self"),
    (2048, 256, 256, 3, "cross"),
    (1536, 512, 128, 3, "cross"),
])
def test_knn_window_plain_matches_pallas(nq, nk, window, k, kind):
    rng = np.random.RandomState(nq + window + k)
    keys = _sorted_cloud(rng, 2, nk, duplicates=kind == "duplicates")
    if kind == "cross":  # the 3-NN: full-resolution queries, a subset keys
        query = _sorted_cloud(rng, 2, nq)
    else:
        query = keys
    want_idx, want_d2 = _pallas(query, keys, k, window)
    idx, d2 = T.knn_window(torch.from_numpy(query), torch.from_numpy(keys),
                           k, window)
    assert idx.dtype == torch.int64 and idx.shape == (2, nq, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=D2_REL, atol=0)
    starts = T.win_start(nq, nk, window).repeat_interleave(256)[None, :, None]
    assert ((idx >= starts) & (idx < starts + window)).all()
    slot0 = idx[..., 0] == torch.arange(nq)
    if kind == "self" and window >= 256:  # a band of 256 covers its tile
        assert slot0.all()
    elif kind == "duplicates":  # the lower twin first
        assert 0.4 < slot0.float().mean() < 0.6


def test_knn_window_refuses_what_the_band_does_not_take():
    x = torch.zeros(1, 512, 3)
    for args in ((x[:, :300].contiguous(), x, 8, 128),  # N % 256
                 (x, x, 8, 192),  # window % 128
                 (x, x[:, :256].contiguous(), 8, 384),  # window > M
                 (x, x, 33, 512),  # k > 32
                 (x, x, 0, 128)):
        with pytest.raises(ValueError, match="knn_window"):
            T.knn_window(*args)


def test_knn_bruteforce_and_three_nn_route_windows():
    """As the JAX ops route them: a band when N % 256 == 0 and the window
    is less than the key table; else the exact search."""
    rng = np.random.RandomState(5)
    full = torch.from_numpy(_sorted_cloud(rng, 1, 1024))
    sub = full[:, ::4].contiguous()
    band = T.knn_window(full, full, 8, 512)
    idx, dist = T.knn_bruteforce(full, 8, window=512)
    assert torch.equal(idx, band[0])
    torch.testing.assert_close(dist, torch.sqrt(band[1]), rtol=0, atol=0)
    exact = T.knn(full, full, 8)[0]
    assert not torch.equal(band[0], exact)
    for window, pts in ((1024, full), (512, full[:, :1000].contiguous())):
        want = T.knn(pts, pts, 8)[0]  # the whole table, or N % 256 != 0
        assert torch.equal(T.knn_bruteforce(pts, 8, window=window)[0], want)
    d2, idx = T.three_nn(full, sub, window=128)
    assert torch.equal(idx, T.knn_window(full, sub, 3, 128)[0])
    assert torch.equal(T.three_nn(full, sub, window=256)[1],
                       T.knn(full, sub, 3)[0])


# ------------------------- the model against JAX -------------------------

@pytest.fixture
def jax_bands(monkeypatch):
    """The TPU's routing of windowed kNN calls, on the CPU: a window goes
    to the Pallas banded kernel in interpret mode, unpacked."""
    knn0, three0 = jops.knn_bruteforce, jops.three_nn

    def knn_bruteforce(positions, k, chunk=None, impl="auto", mode="exact",
                       window=None):
        n = positions.shape[1]
        if window is not None and n % 256 == 0 and window <= n:
            idx, d2 = knn_banded(positions, positions, k, window=window,
                                 packed=False, interpret=True)
            return idx, jnp.sqrt(d2)
        return knn0(positions, k, chunk=chunk, impl=impl, mode=mode)

    def three_nn(xyz1, xyz2, impl="auto", window=None):
        if window is not None and xyz1.shape[1] % 256 == 0 \
                and window <= xyz2.shape[1]:
            idx, d2 = knn_banded(xyz1, xyz2, 3, window=window,
                                 packed=False, interpret=True)
            return d2, idx
        return three0(xyz1, xyz2, impl=impl)

    monkeypatch.setattr(jops, "knn_bruteforce", knn_bruteforce)
    monkeypatch.setattr(jops, "three_nn", three_nn)


@pytest.mark.parametrize("B,N,dilate,bands", [(2, 2048, 8, 1),
                                               (1, 5120, 2, 3)])
def test_legacy_forward_matches_jax(jax_bands, monkeypatch, B, N, dilate,
                                    bands):
    """`global_config` + detection with morton_exact=False: at [2, 2048]
    only the full-resolution kNN takes a band; with dilate = gl_dilate = 2
    at [1, 5120] the subsampled level (2560 points > 2048) takes its kNN
    and its 3-NN in bands too (shared by stage 2 and the global stage)."""
    jc = jcfg.get_config("global_config")
    jc.detection, jc.detection_block = True, "detection_block"
    jc.morton_exact, jc.dilate, jc.gl_dilate = False, dilate, dilate
    variables = init_variables(jc, jax.random.PRNGKey(2))
    pts = entry_points(B, N, seed=6) / np.float32(30.0)
    jo = jax.jit(lambda v, p: JaxDH3D(jc).apply(v, p, train=False))(
        variables, jnp.asarray(pts))

    cfg = entry_config()
    cfg.morton_exact, cfg.dilate, cfg.gl_dilate = False, dilate, dilate
    model = DH3D(cfg)
    load_flax(model, flatten_variables(variables))
    calls = []

    def spy(query, keys, k, window):
        calls.append((query.shape[1], keys.shape[1], k, window))
        return T.knn_window_plain(query, keys, k, window)

    monkeypatch.setattr(knn_ops, "knn_window", spy)
    monkeypatch.setattr(interp_ops, "knn_window", spy)
    to = make_forward(cfg, model)(pts)
    _compare(jo, to)
    assert len(calls) == bands, calls  # stage 2's band shared by the global
    assert calls[0] == (N, N, 8, 512)
    if bands > 1:
        assert calls[1:] == [(N // 2, N // 2, 8, 512), (N, N // 2, 3, 256)]
    # the band replaced some of the exact neighbours
    p = torch.from_numpy(pts)
    perm, _ = T.morton_perm(p)
    srt = torch.gather(p, 1, perm[..., None].expand(-1, -1, 3))
    assert not torch.equal(to["knn_indices"], T.knn_bruteforce(srt, 8)[0])


def test_legacy_detection_step_matches_jax(jax_bands):
    """One `detection_config` step with morton_exact=False at N=1024 (the
    smallest cloud whose full-resolution kNN takes a band): metrics, every
    gradient and the BN statistics, at `test_torch_train.py`'s
    tolerances."""
    over = dict(num_points=1024, morton_exact=False)
    tc = tcfg.get_config("detection_config")
    tc.update(over)
    tc.batch_size, tc.sampled_kpnum = 2, 8
    batch = next(synthetic_batches(tc, 1))
    jc = jcfg.get_config("detection_config")
    jc.update(over)
    variables = init_variables(jc, jax.random.PRNGKey(1))
    assert _compare_step("detection_config", variables, batch, **over) == 58
