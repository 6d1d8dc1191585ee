"""The FlexConv op family on the neighbourhood kernels.

Counterpart of `dh3d_tpu/ops/flex.py:33,150-382`.  Each op is one
neighbourhood reduction (kernel C or D, `ops/neighborhood.py`) followed,
where the op has weights, by one plain matrix product; `flex_deconv`, the
transpose of `flex_conv`, is one matrix product followed by kernel E.

flex_conv uses the moment identity of the JAX package: with neighbourhood
N(n) (k = 0 is the centre n0) and delta_k = pos[nk] - pos[n0],
    out[n] = M[n] @ W,  M[n] = sum_k [1, delta_k] (outer) feat[nk],
    W = concat([bias[None], theta]).reshape((1 + Dp) * Din, Dout),
so M is kernel C with P = 1 + Dp weights [1, delta] and a p-major output;
`flex_moments` builds those weights inside the kernel from the positions.

Every op takes an optional `inverse`, the `NeighborInverse` of its nbh,
which its backward reads (`ops/neighborhood.py`).
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch.ops.neighborhood import (
    _flex_moments_forward,
    flex_moments,
    flex_moments_backward,
    flex_weights,
    gather_neighbors,
    neighbor_max,
    weighted_sum,
)

__all__ = ["gather_neighbors", "flex_weights", "flex_conv", "flex_avg",
           "flex_deconv", "flex_pool", "conv_pointset"]


def flex_conv(features, positions, nbh, theta, bias, inverse=None):
    """Flex convolution (`flex_conv_kernel.cc:25-167`).

    features [B, N, Din], positions [B, N, Dp], nbh [B, N, K] int64 with
    the centre at k = 0, theta [Dp, Din, Dout], bias [Din, Dout]
    -> [B, N, Dout] f32.  Mixed precision as in the JAX function: bf16
    features take the bf16 moments (f32, `flex_moments`), and the product
    with the weights (bf16-rounded by the caller) runs in f32."""
    Dp, Din, Dout = theta.shape
    m = flex_moments(features, positions, nbh, inverse)
    w = torch.cat([bias[None], theta], dim=0).reshape((1 + Dp) * Din, Dout)
    return m @ w.to(m.dtype)


def flex_avg(features, nbh, inverse=None):
    """Neighbourhood sum, the `Flex_Avg` layer (`core/layers.py:342-436`,
    `dh3d_tpu/ops/flex.py:220`): a flex conv with zero theta and identity
    bias, out[n] = sum_k feat[nk]; the caller scales by 1/K.  Kernel C on
    weights of 1: features [B, M, C], nbh [B, N, K] -> [B, N, C]."""
    ones = torch.ones(*nbh.shape, 1, dtype=features.dtype,
                      device=features.device)
    return weighted_sum(features, nbh, ones, inverse)


class FlexDeconvScatter(torch.autograd.Function):
    """The scatter of `flex_deconv`: kernel E on positions forward
    (`flex_moments_backward`), kernel C on positions backward
    (`flex_moments`, its transpose)."""

    @staticmethod
    def forward(ctx, g, positions, nbh, inverse):
        ctx.save_for_backward(positions, nbh)
        return flex_moments_backward(g, positions, nbh, inverse)

    @staticmethod
    def backward(ctx, dout):
        positions, nbh = ctx.saved_tensors
        return (_flex_moments_forward(dout.contiguous(), positions, nbh),
                None, None, None)


def flex_deconv(features, positions, nbh, theta, bias, inverse=None):
    """Transpose flex convolution (`flex_deconv_kernel.cc:49-69`,
    `dh3d_tpu/ops/flex.py:284-311`): each point n scatters
    (bias + delta_k . theta) . feat[n0] into its neighbours nk, delta_k =
    pos[nk] - pos[n0], n0 = nbh[n, 0].

    features [B, N, Din], positions [B, N, Dp] (Dp <= 3), nbh [B, N, K]
    int64 in [0, N), theta [Dp, Din, Dout], bias [Din, Dout] -> [B, N,
    Dout].  Written as g[n] = feat[n0] @ [bias; theta] (one matrix
    product, [B*N, Din] x [Din, (1 + Dp)*Dout]), then
    out[j] = sum over (n, k) with nbh[n, k] = j of [1, delta_k] . g[n]:
    kernel E on positions, which sums each row in a fixed order (no
    atomics).  Differentiable in features, theta and bias (the backward
    of the scatter is kernel C); the positions get no gradient, as in the
    other ops."""
    Dp, Din, Dout = theta.shape
    f_self = gather_neighbors(features, nbh[:, :, :1])[:, :, 0]  # [B, N, Din]
    w = torch.cat([bias[None], theta], dim=0)  # [1 + Dp, Din, Dout]
    g = f_self @ w.permute(1, 0, 2).reshape(Din, (1 + Dp) * Dout)
    return FlexDeconvScatter.apply(g.contiguous(), positions, nbh, inverse)


def flex_pool(features, nbh, inverse=None, with_arg=True):
    """Max-pool over each neighbourhood (`flex_pool_kernel.cc:23-97`):
    features [B, M, C], nbh [B, N, K] -> (out [B, N, C], argmax [B, N, C]
    int64 global point ids, the lowest k on ties, the first NaN's when
    there is one; None when `with_arg` is False, for callers that drop
    it)."""
    return neighbor_max(features, nbh, inverse, with_arg)


def conv_pointset(features, nbh, theta, bias, inverse=None):
    """1x1 conv on neighbourhood differences (`conv_pointset_kernel.cc:49-64`):
    out[n] = sum_k (feat[nk] - feat[n0]) @ theta + bias, the bias once.

    The difference sum is kernel C with weight 1 - K on k = 0 and 1
    elsewhere, i.e. sum_k f_k - K * f_0.  On raw xyz (~100 m) that
    cancellation costs about 1e-5 relative in f32, where the JAX gather form
    subtracts term by term."""
    K = nbh.shape[-1]
    w = torch.ones(*nbh.shape, 1, dtype=features.dtype,
                   device=features.device)
    w[:, :, 0] = 1 - K
    return weighted_sum(features, nbh, w, inverse) @ theta + bias
