"""Layers of the DH3D model.

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

Mixed precision (`dtype=torch.bfloat16`, the model's bf16 compute_dtype)
follows the Flax modules: parameters stay f32 and are cast at use.
`FlexConv` casts its input and its position weights to bf16 and returns
f32 (`ops.flex_conv`); `Conv1x1` is Flax's `Dense(dtype=bf16)`, whose
product is rounded to bf16 and whose bias is then added in bf16 (a second
rounding), so the output is bf16; `BatchNorm` takes it up to f32 first, as
Flax's does (f32 statistics, f32 output).
"""

from __future__ import annotations

import contextlib
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
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, then relu(y) when
    built with `relu` (the BN -> relu of the layers below, fused).

    Eval mode (`self.training` False) uses the running statistics.  Train
    mode uses the batch's, over every axis but the channel, as Flax
    computes them: mean(x) and var = max(0, mean(x^2) - mean(x)^2), the
    gradient flowing through both; the running statistics then move as
    m * old + (1 - m) * new, with the biased var (Flax's momentum m is
    the weight of the old value: 0.9 by default, 0.999 in NetVLAD).  On a
    card train mode runs kernel J (`ops.batch_norm_train`); on the CPU
    its plain version, this computation in PyTorch ops.

    `group` (None, a process group or a `parallel.Mesh`) is Flax's
    `axis_name`: sync BatchNorm.  In train mode the layer then all-reduces
    sum(x), sum(x * x) and the element count over the group, with
    gradient, and applies the same formula to the group's batch, so every
    rank's running statistics move alike.  Eval mode runs no collective.
    `sync_batchnorm` sets it on every BatchNorm of a model."""

    epsilon = 1e-5

    def __init__(self, features: int, momentum: float = 0.9,
                 relu: bool = False):
        super().__init__()
        self.momentum = momentum
        self.relu = relu
        self.update_statistics = True  # off in a remat recompute
        self.group = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        x = x.float()  # a bf16 input normalises in f32, as in Flax
        if self.training:
            return ops.batch_norm_train(
                x, self.scale, self.bias, self.mean, self.var, self.momentum,
                self.epsilon, self.relu, self.update_statistics, self.group)
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        y = (x - self.mean) * mul + self.bias
        return torch.relu(y) if self.relu else y


def sync_batchnorm(module: nn.Module, group) -> None:
    """Set `group` (None: each process on its own batch) on every
    BatchNorm of `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """While entered, the BatchNorms of `module` normalise with the batch's
    statistics but leave their running statistics alone: the recompute of
    a checkpointed forward (`remat`), whose first run has moved them (in
    JAX the recompute's state updates are dropped)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m in norms:
            m.update_statistics = True


class FlexConv(nn.Module):
    """Flex convolution layer (`core/layers.py:178-339`) on 3-D positions.
    `dtype` (None or bf16): the compute dtype of the features and the
    position weights (`dh3d_tpu/nn/layers.py:84-95`); positions stay f32,
    the output is f32 and `feature_bias` is added in f32."""

    def __init__(self, din: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.position_theta = glorot_uniform_param(
            3, din, features, fan_in=3 * din, fan_out=features)
        self.position_bias = nn.Parameter(torch.zeros(din, features))
        self.feature_bias = nn.Parameter(torch.zeros(features))

    def forward(self, feat, pos, nbh, inverse=None):
        theta, bias = self.position_theta, self.position_bias
        if self.dtype is not None:
            feat, theta, bias = (t.to(self.dtype) for t in (feat, theta, bias))
        return ops.flex_conv(feat, pos, nbh, theta, bias,
                             inverse) + self.feature_bias


class FlexConvBN(nn.Module):
    """flexconv_withBatchnorm (`core/tf_utils.py:48-64`):
    flexconv -> BN -> relu (the relu fused into the BN); `dtype` is the
    flex conv's."""

    def __init__(self, din: int, features: int, dtype=None):
        super().__init__()
        self.flexconv = FlexConv(din, features, dtype)
        self.norm = BatchNorm(features, relu=True)

    def forward(self, feat, pos, nbh, inverse=None):
        return self.norm(self.flexconv(feat, pos, nbh, inverse))


class ConvPointset(nn.Module):
    """convolution_pointset layer (`core/layers.py:564-`)."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.theta = glorot_uniform_param(din, features, fan_in=din,
                                          fan_out=features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, feat, nbh, inverse=None):
        return ops.conv_pointset(feat, nbh, self.theta, self.bias, inverse)


class ConvPointsetBN(nn.Module):
    """convolution_pointset_withBatchnorm (`core/tf_utils.py:67-83`):
    pointset conv -> BN -> relu (the relu fused into the BN)."""

    def __init__(self, din: int, features: int):
        super().__init__()
        self.conv = ConvPointset(din, features)
        self.norm = BatchNorm(features, relu=True)

    def forward(self, feat, nbh, inverse=None):
        return self.norm(self.conv(feat, nbh, inverse))


class Conv1x1(nn.Module):
    """feature_conv1d_1 (`core/tf_utils.py:99-109`): pointwise Dense, then
    BN and the activation (BNReLU by default; a relu after the BN is fused
    into it).  `dtype` (None or bf16): the
    Dense's compute dtype, Flax's `Dense(dtype=...)`: input, kernel and
    bias cast to it, the product rounded to it, then the bias added in it
    (`dh3d_tpu/nn/layers.py:172-197`)."""

    def __init__(self, din: int, features: int, bn: bool = True,
                 act: Callable = torch.relu, dtype=None):
        super().__init__()
        self.dense = dense(din, features)
        self.norm = BatchNorm(features, relu=act is torch.relu) if bn else None
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            x = self.dense(x)
        else:  # two roundings, as Flax's: no fused addmm
            dt = self.dtype
            x = (nn.functional.linear(x.to(dt), self.dense.weight.to(dt))
                 + self.dense.bias.to(dt))
        if self.norm is None:
            return self.act(x)
        x = self.norm(x)
        return x if self.norm.relu else self.act(x)


class FlexAvg(nn.Module):
    """Flex_Avg layer (`core/layers.py:342-436`): a frozen flex conv with
    zero theta and identity bias, the neighbourhood sum `ops.flex_avg`;
    the caller scales by 1/knn (`core/backbones.py:82`).  No parameters."""

    def __init__(self, filters: int):
        super().__init__()
        self.filters = filters

    def forward(self, feat, pos, nbh, inverse=None):
        if feat.shape[-1] != self.filters:
            raise ValueError("Flex_Avg's identity bias needs Din == Dout: "
                             f"{feat.shape[-1]} != {self.filters}")
        return ops.flex_avg(feat, nbh, inverse)


class FlexConvTranspose(nn.Module):
    """FlexConvolutionTranspose layer (`core/layers.py:483-561`), on the
    op `ops.flex_deconv`; not used by the DH3D graph.  Its parameters
    start as Flax's: a glorot_uniform theta (fan in Dp * Din), zero
    biases."""

    def __init__(self, din: int, features: int, use_feature_bias: bool = True,
                 dp: int = 3):
        super().__init__()
        self.position_theta = glorot_uniform_param(
            dp, din, features, fan_in=dp * din, fan_out=features)
        self.position_bias = nn.Parameter(torch.zeros(din, features))
        if use_feature_bias:
            self.feature_bias = nn.Parameter(torch.zeros(features))

    def forward(self, feat, pos, nbh, inverse=None):
        y = ops.flex_deconv(feat, pos, nbh, self.position_theta,
                            self.position_bias, inverse)
        if hasattr(self, "feature_bias"):
            y = y + self.feature_bias
        return y


class SEBottleneck(nn.Module):
    """se_bottleneck (`core/backbones.py:33-42`): the non-residual
    squeeze-excite, x * sigmoid(f2(relu(f1(pool_x)))), the squeeze convs
    without BatchNorm.  `din`: pool_x's width (ch_out unless given)."""

    def __init__(self, ch_out: int, din: int | None = None):
        super().__init__()
        self.f1 = Conv1x1(din or ch_out, ch_out // 4, bn=False,
                          act=torch.relu)
        self.f2 = Conv1x1(ch_out // 4, ch_out, bn=False, act=torch.sigmoid)

    def forward(self, x, pool_x):
        return x * self.f2(self.f1(pool_x))


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
