"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; every test takes the `device` fixture, which skips when
there is no CUDA device (decided when the test runs, never at import, so
that every test worker collects the same tests).  Run on a card with
`python -m pytest tests/test_torch_cuda.py -m cuda -q`.

Shapes are small versions of the main path's (N not a multiple of
anything, to exercise the ragged edges).  kNN and FPS must equal their
plain versions exactly (both build d2 from the same rounded terms);
neighbour max and its slot exactly; weighted sums and both backwards to
1e-5 relative (FMA accumulation in the kernels, batched matmuls and
atomic scatters in the plain versions).  The
train step on the card is held to the CPU's as `chip_smoke.py` phase 7
holds it (see there).
"""

import numpy as np
import pytest
import torch

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T

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


def _counted(kernel, fn, *args):
    before = kernel.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


def _close(a, ref, rel=1e-5):
    err = (a - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), err


@pytest.mark.parametrize("k", [1, 3, 8, 16, 32])
def test_knn_self_equals_plain(cloud, k):
    idx, d2 = _counted(kernels.KNN, T.knn, cloud, cloud, k)
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


def test_fps_rejects_a_cloud_too_large_for_shared_memory(device):
    limit = kernels.fps_smem_limit(device)
    pts = torch.zeros(1, limit // 16 + 1, 3, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        T.farthest_point_sample(pts, 4)


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
    idx, dist = _counted(kernels.KNN, T.knn_bruteforce_pairwise, query,
                         cloud, 16)
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
    against the model's largest gradient), as chip_smoke.py phase 7."""
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
