"""Layers of the DH3D model, f32.

Counterpart of `dh3d_tpu/nn/layers.py` (reference: `core/layers.py`,
`core/tf_utils.py`).  Parameter names and layouts follow the Flax tree so
that `nn/convert.py` maps a checkpoint across by name:
  position_theta [3, Din, Dout], position_bias [Din, Dout],
  feature_bias [Dout]; ConvPointset theta [Din, Dout], bias [Dout];
  Dense -> nn.Linear (weight [out, in], the transpose of Flax's kernel);
  BatchNorm scale/bias parameters and mean/var buffers.
Flax infers input widths at first call; here every layer is given its
input width.  Parameters start as Flax's initialisers draw them (other
random numbers, the same distributions): `he_normal` Dense kernels and zero
Dense biases (`layers.py:185-188`), `glorot_uniform` flex and pointset
thetas (`layers.py:76-83,139-141`), zero position and feature biases.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from dh3d_tpu_torch import ops


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 epsilon: float = 1e-8) -> torch.Tensor:
    """tf.nn.l2_normalize: x / sqrt(max(sum(x^2), eps))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.reciprocal(torch.sqrt(torch.clamp_min(sq, epsilon)))


# stddev of a standard normal truncated to (-2, 2): Flax's correction
TRUNC_STD = 0.87962566103423978


def normal_param(*shape: int, std: float) -> nn.Parameter:
    """nn.initializers.normal(stddev=std)."""
    return nn.Parameter(torch.randn(*shape) * std)


def glorot_uniform_param(*shape: int, fan_in: int,
                         fan_out: int) -> nn.Parameter:
    """nn.initializers.glorot_uniform: U(-l, l), l = sqrt(6 / (fan_in +
    fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(torch.empty(*shape).uniform_(-limit, limit))


def dense(din: int, features: int, bias: float = 0.0) -> nn.Linear:
    """Flax nn.Dense(kernel_init=he_normal()) as an nn.Linear: the kernel
    from N(0, 2/din) truncated at two standard deviations (Flax's
    `variance_scaling(2, "fan_in", "truncated_normal")`), the bias
    constant (zero unless given)."""
    layer = nn.Linear(din, features)
    std = math.sqrt(2.0 / din) / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std)
        layer.bias.fill_(bias)
    return layer


class BatchNorm(nn.Module):
    """Channel BatchNorm over the last axis (Flax nn.BatchNorm):
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Eval mode (`self.training` False) uses the running statistics.  Train
    mode uses the batch's, over every axis but the channel, as Flax
    computes them: mean(x) and var = max(0, mean(x^2) - mean(x)^2), the
    gradient flowing through both; the running statistics then move as
    m * old + (1 - m) * new, with the biased var (Flax's momentum m is
    the weight of the old value: 0.9 by default, 0.999 in NetVLAD)."""

    epsilon = 1e-5

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class FlexConv(nn.Module):
    """Flex convolution layer (`core/layers.py:178-339`) on 3-D positions."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.position_theta = glorot_uniform_param(
            3, din, features, fan_in=3 * din, fan_out=features)
        self.position_bias = nn.Parameter(torch.zeros(din, features))
        self.feature_bias = nn.Parameter(torch.zeros(features))

    def forward(self, feat, pos, nbh):
        return ops.flex_conv(feat, pos, nbh, self.position_theta,
                             self.position_bias) + self.feature_bias


class FlexConvBN(nn.Module):
    """flexconv_withBatchnorm (`core/tf_utils.py:48-64`):
    flexconv -> BN -> relu."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.flexconv = FlexConv(din, features)
        self.norm = BatchNorm(features)

    def forward(self, feat, pos, nbh):
        return torch.relu(self.norm(self.flexconv(feat, pos, nbh)))


class ConvPointset(nn.Module):
    """convolution_pointset layer (`core/layers.py:564-`)."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.theta = glorot_uniform_param(din, features, fan_in=din,
                                          fan_out=features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, feat, nbh):
        return ops.conv_pointset(feat, nbh, self.theta, self.bias)


class ConvPointsetBN(nn.Module):
    """convolution_pointset_withBatchnorm (`core/tf_utils.py:67-83`)."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.conv = ConvPointset(din, features)
        self.norm = BatchNorm(features)

    def forward(self, feat, nbh):
        return torch.relu(self.norm(self.conv(feat, nbh)))


class Conv1x1(nn.Module):
    """feature_conv1d_1 (`core/tf_utils.py:99-109`): pointwise Dense, then
    BN and the activation (BNReLU by default)."""

    def __init__(self, din: int, features: int, bn: bool = True,
                 act: Callable = torch.relu):
        super().__init__()
        self.dense = dense(din, features)
        self.norm = BatchNorm(features) if bn else None
        self.act = act

    def forward(self, x):
        x = self.dense(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class SEResBottleneck(nn.Module):
    """se_res_bottleneck (`core/backbones.py:45-55`): per-point
    squeeze-excite on the neighbourhood-pooled features, residual, relu.
    The squeeze convs carry no BatchNorm."""

    def __init__(self, ch_out: int):
        super().__init__()
        self.f1 = Conv1x1(ch_out, ch_out // 4, bn=False, act=torch.relu)
        self.f2 = Conv1x1(ch_out // 4, ch_out, bn=False, act=torch.sigmoid)

    def forward(self, x, pool_x):
        return torch.relu(x + x * self.f2(self.f1(pool_x)))


def bn_fed_biases(model: nn.Module) -> set:
    """Names of the parameters whose exact gradient is zero in train mode:
    a bias added right before a BatchNorm on batch statistics, which
    subtracts the batch mean again (Conv1x1's dense bias, the flex-conv
    feature bias, initconv's bias).  Their computed gradients are rounding
    noise, to be compared against the model's gradient scale, not their
    own."""
    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, Conv1x1) and m.norm is not None:
            names.add(f"{prefix}.dense.bias")
        elif isinstance(m, FlexConvBN):
            names.add(f"{prefix}.flexconv.feature_bias")
        elif isinstance(m, ConvPointsetBN):
            names.add(f"{prefix}.conv.bias")
    return names
