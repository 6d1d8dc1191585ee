"""Train-mode BatchNorm on the CPU: the closed form of kernel J's backward,
the fused relu and J's launch plan.

`ops.batch_norm_backward_plain` writes out the backward kernel J computes
on a card; here it is held to autograd of the layer's plain code
(`ops.batch_norm_plain`) in float64, on channels whose var clamps at 0
(constant ones, one with mean(x^2) - mean^2 below 0 and one at exactly 0)
and one whose relu input is negative everywhere.  `BatchNorm(relu=True)`
must equal relu(BatchNorm) bit for bit on the CPU, in train and eval
mode, with the same gradients and running statistics.  J itself runs only
on a card (`tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch import ops as T
from dh3d_tpu_torch.nn.layers import BatchNorm, Conv1x1
from dh3d_tpu_torch.ops.batchnorm import (BN_BLOCKS_PER_SM, BN_ROWS_A_THREAD,
                                          BN_THREADS)

EPS = 1e-5


def _clamped_constant(n):
    """A constant whose float64 mean(x^2) - mean(x)^2 over n copies is
    below 0, so that clamp_min takes the var (and its gradient) to 0."""
    for c in np.arange(0.1, 10.0, 0.1):
        x = torch.full((n,), float(c), dtype=torch.float64)
        if (x * x).mean() - x.mean() ** 2 < 0:
            return float(c)
    raise AssertionError("no constant with a negative raw var")


def _case(relu, n=300, C=6, seed=0):
    """x [3, n // 3, C] float64 with channel 0 a clamped constant, channel
    1 exactly 0.5 (raw var 0), channel 2 negative after the normalisation
    everywhere (bias -100), the rest at a large mean (a cancellation)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, n // 3, C, generator=g, dtype=torch.float64) * 2 + 5
    x[..., 0] = _clamped_constant(n)
    x[..., 1] = 0.5
    dy = torch.randn(3, n // 3, C, generator=g, dtype=torch.float64)
    scale = torch.rand(C, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(C, generator=g, dtype=torch.float64)
    bias[2] = -100.0
    return x, dy, scale, bias


@pytest.mark.parametrize("relu", [False, True])
def test_closed_form_backward_equals_autograd(relu):
    """dx, dscale and dbias of the closed form J computes against autograd
    of the plain layer, float64, to 1e-12 of each gradient's scale; the
    clamped channel's raw var is below 0, the next one's exactly 0, and
    with the relu nothing of channel 2's gradient passes."""
    x, dy, scale, bias = _case(relu)
    xa, sa, ba = (t.clone().requires_grad_() for t in (x, scale, bias))
    C = x.shape[-1]
    y = T.batch_norm_plain(xa, sa, ba, torch.zeros(C, dtype=x.dtype),
                           torch.ones(C, dtype=x.dtype), 0.9, EPS, relu=relu)
    y.backward(dy)
    dims = (0, 1)
    mean, meansq = x.mean(dims), (x * x).mean(dims)
    raw = meansq - mean * mean
    assert raw[0] < 0 and raw[1] == 0
    dx, dscale, dbias = T.batch_norm_backward_plain(
        dy, x, scale, bias, mean, meansq, EPS, relu=relu)
    for got, want in ((dx, xa.grad), (dscale, sa.grad), (dbias, ba.grad)):
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    if relu:
        assert torch.all(y[..., 2] == 0)
        assert dbias[2] == 0 and dscale[2] == 0
        assert torch.all(dx[..., 2] == 0)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("momentum", [0.9, 0.999])
def test_fused_relu_equals_relu_after(train, momentum):
    """`BatchNorm(relu=True)` on the CPU: relu(BatchNorm(x)) bit for bit,
    output, dx, dscale, dbias and the running statistics; no kernel
    launched."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 50, 12, generator=g) * 3 + 1
    dy = torch.randn(4, 50, 12, generator=g)
    before = kernels.counts()
    runs = []
    for fused in (True, False):
        torch.manual_seed(0)
        m = BatchNorm(12, momentum=momentum, relu=fused)
        with torch.no_grad():
            m.scale.uniform_(0.5, 1.5)
            m.bias.normal_()
            m.mean.normal_()
            m.var.uniform_(0.5, 1.5)
        m.train(train)
        xi = x.clone().requires_grad_()
        y = m(xi) if fused else torch.relu(m(xi))
        y.backward(dy)
        runs.append((y.detach(), xi.grad, m.scale.grad, m.bias.grad, m.mean,
                     m.var))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert kernels.counts() == before


def test_conv1x1_fuses_only_a_relu():
    """Conv1x1 asks its BatchNorm for the relu only when its activation is
    the relu; another activation follows the BatchNorm; the parameter and
    buffer names stay those of the unfused layer."""
    relu, sig = Conv1x1(5, 8), Conv1x1(5, 8, act=torch.sigmoid)
    assert relu.norm.relu and not sig.norm.relu
    assert list(relu.state_dict()) == list(sig.state_dict()) == [
        "dense.weight", "dense.bias", "norm.scale", "norm.bias", "norm.mean",
        "norm.var"]
    x = torch.randn(7, 5)
    with torch.no_grad():
        sig.norm.bias.fill_(-3.0)
    out = sig.train()(x)
    assert torch.equal(out, torch.sigmoid(sig.norm(sig.dense(x))))
    assert out.min() > 0


# the main path's shapes (stage 2's and stage 3's) and the edges
PLAN_SHAPES = [(163840, 32), (163840, 64), (163840, 128), (163840, 256),
               (163840, 1024), (20480, 128), (196608, 1024), (196608, 64),
               (24, 256), (24, 3), (1, 1), (100, 2000)]


@pytest.mark.parametrize("rows,C", PLAN_SHAPES)
def test_plan_fills_one_wave(rows, C):
    """A float4 a row when C % 4 == 0 and aligned, else one float; the row
    slices make at most one wave of BN_BLOCKS_PER_SM blocks an SM of 132,
    give each thread at least BN_ROWS_A_THREAD rows on average when there
    is more than one slice, and never outnumber the rows."""
    sms = 132
    for aligned in (True, False):
        vec, blocks = T.bn_plan(rows, C, sms, aligned)
        assert vec == (4 if C % 4 == 0 and aligned else 1)
        tile = min(C // vec, BN_THREADS)
        col_blocks = -(-(C // vec) // tile)
        lanes = BN_THREADS // tile
        assert 1 <= blocks <= rows
        assert blocks <= -(-BN_BLOCKS_PER_SM * sms // col_blocks)
        if blocks > 1:
            assert rows / (blocks * lanes) >= BN_ROWS_A_THREAD
