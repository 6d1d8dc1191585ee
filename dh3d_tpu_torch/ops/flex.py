"""The FlexConv op family on the neighbourhood kernels.

Counterpart of `dh3d_tpu/ops/flex.py:33,150-217,251-281,314-382`.  Each op
is one neighbourhood reduction (kernel C or D, `ops/neighborhood.py`)
followed, where the op has weights, by one plain matrix product.

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
    flex_moments,
    flex_weights,
    gather_neighbors,
    neighbor_max,
    weighted_sum,
)

__all__ = ["gather_neighbors", "flex_weights", "flex_conv", "flex_pool",
           "conv_pointset"]


def flex_conv(features, positions, nbh, theta, bias, inverse=None):
    """Flex convolution (`flex_conv_kernel.cc:25-167`).

    features [B, N, Din], positions [B, N, Dp], nbh [B, N, K] int64 with
    the centre at k = 0, theta [Dp, Din, Dout], bias [Din, Dout]
    -> [B, N, Dout]."""
    Dp, Din, Dout = theta.shape
    m = flex_moments(features, positions, nbh, inverse)
    w = torch.cat([bias[None], theta], dim=0).reshape((1 + Dp) * Din, Dout)
    return m @ w


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
