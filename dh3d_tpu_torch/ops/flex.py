"""The FlexConv op family on the neighbourhood kernels.

Counterpart of `dh3d_tpu/ops/flex.py:33,150-217,251-281,314-382`.  Each op
is one neighbourhood reduction (kernel C or D, `ops/neighborhood.py`)
followed, where the op has weights, by one plain matrix product.

flex_conv uses the moment identity of the JAX package: with neighbourhood
N(n) (k = 0 is the centre n0) and delta_k = pos[nk] - pos[n0],
    out[n] = M[n] @ W,  M[n] = sum_k [1, delta_k] (outer) feat[nk],
    W = concat([bias[None], theta]).reshape((1 + Dp) * Din, Dout),
so M is kernel C with P = 1 + Dp weights [1, delta] and a p-major output.

Every op takes an optional `inverse`, the `NeighborInverse` of its nbh,
which its backward reads (`ops/neighborhood.py`).
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch.ops.neighborhood import (
    gather_neighbors,
    neighbor_max,
    weighted_sum,
)

__all__ = ["gather_neighbors", "flex_weights", "flex_conv", "flex_pool",
           "conv_pointset"]


def flex_weights(positions: torch.Tensor, nbh: torch.Tensor) -> torch.Tensor:
    """[B, N, K, 1 + Dp] weights [1, pos[nk] - pos[n0]] of the moments."""
    p_k = gather_neighbors(positions, nbh)  # [B, N, K, Dp]
    delta = p_k - p_k[:, :, :1]
    return torch.cat([torch.ones_like(delta[..., :1]), delta], dim=-1)


def flex_conv(features, positions, nbh, theta, bias, inverse=None):
    """Flex convolution (`flex_conv_kernel.cc:25-167`).

    features [B, N, Din], positions [B, N, Dp], nbh [B, N, K] int64 with
    the centre at k = 0, theta [Dp, Din, Dout], bias [Din, Dout]
    -> [B, N, Dout]."""
    Dp, Din, Dout = theta.shape
    m = weighted_sum(features, nbh, flex_weights(positions, nbh), inverse)
    w = torch.cat([bias[None], theta], dim=0).reshape((1 + Dp) * Din, Dout)
    return m @ w


def flex_pool(features, nbh, inverse=None):
    """Max-pool over each neighbourhood (`flex_pool_kernel.cc:23-97`):
    features [B, M, C], nbh [B, N, K] -> (out [B, N, C], argmax [B, N, C]
    int64 global point ids, the lowest k on ties)."""
    return neighbor_max(features, nbh, inverse)


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
