"""Train-mode BatchNorm over the last axis with an optional fused ReLU:
kernel J (`csrc/batchnorm.cu`) and its plain version.

No counterpart in `dh3d_tpu/ops/`: the JAX package leaves BatchNorm to
Flax and XLA.  `nn.layers.BatchNorm` takes `batch_norm_train` in train
mode.  CPU tensors take `batch_norm_plain`, the layer's PyTorch code,
with autograd's backward.  CUDA tensors launch J, a
`torch.autograd.Function` of four passes: the column sums of x, the
normalisation (statistics, running update, output), the backward's
column sums of g and g * (x - mean), and dx with dscale and dbias.  Under
sync BatchNorm (`group`) each direction all-reduces its sums between its
two passes.

Both compute Flax's function: mean(x), var = max(0, mean(x^2) - mean^2),
the gradient flowing through both means.  `batch_norm_backward_plain`
writes out the closed-form backward J computes; the CPU tests hold it to
autograd of `batch_norm_plain` in float64.
"""

from __future__ import annotations

import functools

import torch

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch.parallel.collectives import all_reduce, reduce_

BN_THREADS = 256  # threads a block (csrc/batchnorm.cu's kThreads)
BN_BLOCKS_PER_SM = 4  # blocks an SM the row slices aim at (its kMinBlocks)
BN_ROWS_A_THREAD = 8  # rows a thread at least, on average


def batch_norm_plain(x, scale, bias, running_mean, running_var,
                     momentum: float, eps: float, relu: bool = False,
                     update: bool = True, group=None) -> torch.Tensor:
    """Train-mode BatchNorm over the last axis of `x` in plain PyTorch
    (autograd's backward): Flax's statistics over every other axis (with
    `group`, all-reduced sum(x), sum(x * x) and count), the running
    statistics moved in place as m * old + (1 - m) * new when `update`,
    then relu((x - mean) * (rsqrt(var + eps) * scale) + bias) (the relu
    when asked)."""
    dims = tuple(range(x.dim() - 1))
    if group is None:
        mean, meansq = x.mean(dims), (x * x).mean(dims)
    else:
        c = x.shape[-1]
        sums = all_reduce(torch.cat([
            x.sum(dims), (x * x).sum(dims),
            x.new_full((1,), x.numel() // c)]), group)
        mean, meansq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp_min(meansq - mean * mean, 0.0)
    if update:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    mul = torch.rsqrt(var + eps) * scale
    y = (x - mean) * mul + bias
    return torch.relu(y) if relu else y


def batch_norm_backward_plain(dy, x, scale, bias, mean, meansq,
                              eps: float, relu: bool = False):
    """The closed-form backward of `batch_norm_plain` (no group) that J
    computes, from the forward's mean and meansq.  Returns (dx, dscale,
    dbias).

    With xc = x - mean, var = max(0, meansq - mean^2), rstd = rsqrt(var +
    eps), mul = rstd * scale, and g = dy where the relu passed (y = xc *
    mul + bias not <= 0; all of dy without the relu):
      dbias = sum(g), dscale = sum(g * xc) * rstd;
      dvar = -0.5 * sum(g * xc) * scale * rstd^3 where meansq - mean^2 >= 0
      (clamp_min's gradient), else 0;
      dx = g * mul - mul * sum(g) / n + 2 * dvar / n * xc
    (the terms through mean and through meansq, with dmean = -mul * sum(g)
    - 2 * mean * dvar and dmeansq = dvar).  Sums over every axis but the
    last, n rows."""
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    raw = meansq - mean * mean
    rstd = torch.rsqrt(torch.clamp_min(raw, 0.0) + eps)
    mul = rstd * scale
    xc = x - mean
    g = torch.where(xc * mul + bias <= 0, 0.0, dy) if relu else dy
    sg, sgc = g.sum(dims), (g * xc).sum(dims)
    dvar = torch.where(raw >= 0, -0.5 * sgc * scale * rstd ** 3, 0.0)
    dx = g * mul - mul * sg / n + 2 * dvar / n * xc
    return dx, sgc * rstd, sg


def bn_plan(rows: int, C: int, sm_count: int,
            aligned: bool = True) -> tuple[int, int]:
    """J's plan: (channels a thread, row slices).  Four channels a thread
    (a float4 a row) when C % 4 == 0 and every [rows, C] pointer is 16-byte
    aligned (`aligned`), else one.  Row slices: enough blocks for
    BN_BLOCKS_PER_SM a multiprocessor over the channel tiles of
    BN_THREADS threads, but at least BN_ROWS_A_THREAD rows a thread on
    average, so that a narrow or short tensor is not spread thinner."""
    vec = 4 if C % 4 == 0 and aligned else 1
    tile = min(C // vec, BN_THREADS)  # channel groups a block
    col_blocks = -(-(C // vec) // tile)
    lanes = BN_THREADS // tile  # rows a block walks side by side
    want = -(-BN_BLOCKS_PER_SM * sm_count // col_blocks)
    most = rows // (lanes * BN_ROWS_A_THREAD)
    return vec, max(1, min(want, most, 65535))


@functools.lru_cache(maxsize=None)
def _device_plan(rows: int, C: int, index: int, aligned: bool):
    return bn_plan(rows, C, kernels.sm_count(index), aligned)


def _plan(rows, C, dev, *tensors):
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return _device_plan(rows, C, dev.index or 0, aligned)


class _BatchNormTrain(torch.autograd.Function):
    """Kernel J: x [rows, C] f32 contiguous on a card.  Each direction
    takes its scratch in one f64 allocation: the forward's sums [2C + 1]
    and stats [4C] f32 (kept for the backward), then the row slices'
    partial sums [blocks, 2C]; the backward's sums [2C + 1], then its
    partial sums."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, momentum,
                eps, relu, update, group):
        rows, C = x.shape
        dev = x.device
        vec, blocks = _plan(rows, C, dev, x)
        work = torch.empty(4 * C + 1 + blocks * 2 * C, dtype=torch.float64,
                           device=dev)
        sums = work[:2 * C + 1]
        stats = work[2 * C + 1:4 * C + 1].view(torch.float32)
        kernels.BN_STATS.launch(dev, x.data_ptr(),
                                work[4 * C + 1:].data_ptr(),
                                sums.data_ptr(), rows, C, vec, blocks)
        if group is not None:
            reduce_(sums, group)
        out = torch.empty_like(x)
        kernels.BN_FORWARD.launch(
            dev, x.data_ptr(), sums.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            stats.data_ptr(), out.data_ptr(), rows, C, eps, momentum,
            1 - momentum, int(update), int(relu), vec, blocks)
        ctx.save_for_backward(x, scale, bias, sums, stats)
        ctx.relu, ctx.group = relu, group
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, sums, stats = ctx.saved_tensors
        rows, C = x.shape
        dev = x.device
        dy = dy.contiguous()
        dx = torch.empty_like(x)
        vec, blocks = _plan(rows, C, dev, x, dy, dx)
        work = torch.empty(2 * C + 1 + blocks * 2 * C, dtype=torch.float64,
                           device=dev)
        local = work[:2 * C + 1]
        kernels.BN_GRAD_SUMS.launch(
            dev, dy.data_ptr(), x.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), work[2 * C + 1:].data_ptr(), local.data_ptr(),
            rows, C, int(ctx.relu), vec, blocks)
        glob = local if ctx.group is None else reduce_(local.clone(),
                                                        ctx.group)
        dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
        kernels.BN_GRAD_DX.launch(
            dev, dy.data_ptr(), x.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), scale.data_ptr(), sums.data_ptr(),
            local.data_ptr(), glob.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), dx.data_ptr(), rows, C, int(ctx.relu), vec,
            blocks)
        return dx, dscale, dbias, None, None, None, None, None, None, None


def batch_norm_train(x, scale, bias, running_mean, running_var,
                     momentum: float, eps: float, relu: bool = False,
                     update: bool = True, group=None) -> torch.Tensor:
    """Train-mode BatchNorm over the last axis of f32 `x`, the relu fused
    when asked: `batch_norm_plain`'s function and running update.  CPU
    tensors take `batch_norm_plain`; CUDA tensors launch kernel J (scale,
    bias and the running statistics f32 [C], contiguous, on the card)."""
    if not kernels.on_cuda(x, scale, bias, running_mean, running_var):
        return batch_norm_plain(x, scale, bias, running_mean, running_var,
                                momentum, eps, relu, update, group)
    C = x.shape[-1]
    flat = x.contiguous().view(-1, C)
    kernels.check(flat, "x", torch.float32, (None, C))
    for name, t in (("scale", scale), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        kernels.check(t, name, torch.float32, (C,))
    out = _BatchNormTrain.apply(flat, scale, bias, running_mean,
                                running_var, float(momentum), float(eps),
                                bool(relu), bool(update), group)
    return out.view(x.shape)
