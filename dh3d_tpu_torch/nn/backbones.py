"""Network blocks of the DH3D model.

Counterpart of `dh3d_tpu/nn/backbones.py:27-485` (reference
`core/backbones.py`).  Module and parameter names follow the Flax tree.
The out-of-band plan of the JAX blocks is TPU kernel routing and has no
counterpart: the ops here take any index.  What Morton order still
changes is the order of the FPS selection (`sorted_order`), which the JAX
package keeps ascending under Morton order, and, in the legacy
approximate mode (`exact=False`, the config's `morton_exact=False`), the
neighbour sets: the kNN and the 3-NN of a level wider than 2048 points
search a band of the Morton order (`ops.knn_window`), as the JAX blocks
route them.

`dtype` (None or bf16, the model's compute dtype) reaches exactly the
modules the JAX blocks give it (`dh3d_tpu/nn/backbones.py:140,211,256-281,
299-361`): every FlexConvBN of stages 1 and 2 and of the global stage, the
Conv1x1s `before_stage2_conv1d`, `local_stage1_shortcut` and stage 2's
`concat_conv1d`, and the `detec_conv*` of the detection and attention
blocks.  initconv, the SE squeeze convs, `final_fc`, the logit heads, the
conv1d global backbone, NetVLAD and context gating stay f32, as do the
pools, the interpolation and every neighbour search.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from dh3d_tpu_torch import ops
from dh3d_tpu_torch.nn.layers import (
    BatchNorm,
    Conv1x1,
    ConvPointsetBN,
    FlexConvBN,
    SEResBottleneck,
    dense,
    l2_normalize,
    normal_param,
)


class FlexConvDilate(nn.Module):
    """flex_conv_dilate (`core/backbones.py:58-101`): [FPS subsample by
    `dilate`] -> kNN -> stacked FlexConv+BN -> [SE] -> [3-NN inverse-distance
    upsample when dilate > 1] -> [concat + 1x1].

    Returns (xyz, feat, cache).  The cache holds what this call computed of
    the level's geometry — the FPS selection `kp_idx`, the subsampled kNN
    `knn`, the 3-NN `interp` = (d2, idx) — which are functions of xyz
    alone, so another stage at the same level passes it back in as
    `level_cache` and reuses them (`backbones.py:50-63` of the JAX
    package).  Each neighbourhood (`knn`, `interp`'s idx) is held as an
    `ops.NeighborInverse` whose `nbh` is the indices, and every op over it
    gets that holder as `inverse=`, so that the backward builds each CSR
    inverse once.  `knn`, when given, is such a holder of the level's kNN.

    `add_se`: "max_pool" (the SE block on the neighbourhood max),
    "avg_pool" (on the neighbourhood mean, `ops.flex_avg` / knn) or "".
    `exact=False` is the legacy Morton-band routing of
    `dh3d_tpu/nn/backbones.py:66-131,164-196`: under Morton order, a level
    with N % 256 == 0, npoint % 256 == 0 and 512 <= npoint (`use_banded`)
    that is wider than 2048 points takes its kNN in a band of 512 rows and
    its 3-NN in a band of 256; a level of at most 2048 points is searched
    whole (the JAX full-table window), which is the exact search."""

    def __init__(self, din: int, dilate: int, knn: int,
                 outdims: Sequence[int], concat: bool, add_se: str,
                 sorted_order: bool = False, exact: bool = True,
                 dtype=None):
        super().__init__()
        if add_se not in ("max_pool", "avg_pool", ""):
            raise ValueError(f"add_se={add_se!r}")
        self.dilate, self.knn, self.add_se = dilate, knn, add_se
        self.concat, self.sorted_order = concat, sorted_order
        self.exact = exact
        dims = [din, *outdims]
        self.n_convs = len(outdims)
        for i in range(self.n_convs):
            self.add_module(f"flexconv_{i}",
                            FlexConvBN(dims[i], dims[i + 1], dtype))
        self.se = SEResBottleneck(outdims[-1]) if add_se else None
        if concat:
            self.concat_conv1d = Conv1x1(outdims[-1] + din, outdims[-1],
                                         dtype=dtype)

    def forward(self, xyz, feat, knn=None, level_cache=None):
        lc = level_cache or {}
        cache = {}
        if self.dilate > 1:
            points_s, feat_s, kp_idx = ops.subsample(
                xyz, feat, xyz.shape[1] // self.dilate,
                kp_idx=lc.get("kp_idx"), sorted_order=self.sorted_order)
            cache["kp_idx"] = kp_idx
        else:
            points_s, feat_s = xyz, feat

        m = points_s.shape[1]
        use_banded = (self.sorted_order and xyz.shape[1] % 256 == 0
                      and m % 256 == 0 and m >= 512)
        windowed = use_banded and m > 2048 and not self.exact
        if knn is None:
            knn = lc.get("knn")
        if knn is None:
            knn = ops.NeighborInverse(ops.knn_bruteforce(
                points_s, self.knn, window=512 if windowed else None)[0], m)
            cache["knn"] = knn

        x = feat_s
        for i in range(self.n_convs):
            x = getattr(self, f"flexconv_{i}")(x, points_s, knn.nbh, knn)
        if self.add_se == "max_pool":
            x_pool, _ = ops.flex_pool(x, knn.nbh, knn, with_arg=False)
            x = self.se(x, x_pool)
        elif self.add_se == "avg_pool":  # `core/backbones.py:81-83`
            x = self.se(x, ops.flex_avg(x, knn.nbh, knn) * (1.0 / self.knn))

        if self.dilate > 1:
            interp = lc.get("interp")
            if interp is None:
                dist, idx = ops.three_nn(xyz, points_s,
                                         window=256 if windowed else None)
                interp = (dist, ops.NeighborInverse(idx, m))
                cache["interp"] = interp
            dist, idx = interp
            x = ops.three_interpolate(x, idx.nbh,
                                      ops.inverse_distance_weights(dist),
                                      inverse=idx)

        if self.concat:
            x = self.concat_conv1d(torch.cat([x, feat], dim=-1))
        return xyz, x, cache


class BackboneLocalDilate(nn.Module):
    """backbone_local_dilate (`core/backbones.py:104-127`).  Returns
    (points, feat, stage 2's level cache)."""

    def __init__(self, featdim: int = 128, dilate2: int = 8,
                 sorted_order: bool = False, exact: bool = True,
                 dtype=None):
        super().__init__()
        self.initconv = ConvPointsetBN(3, 32)
        self.stage1 = FlexConvDilate(32, dilate=1, knn=8, outdims=(64, 64),
                                     concat=False, add_se="max_pool",
                                     dtype=dtype)
        self.before_stage2_conv1d = Conv1x1(64, 64, dtype=dtype)
        self.stage2 = FlexConvDilate(64, dilate=dilate2, knn=8,
                                     outdims=(128, 128), concat=True,
                                     add_se="max_pool",
                                     sorted_order=sorted_order, exact=exact,
                                     dtype=dtype)
        self.local_stage1_shortcut = Conv1x1(64, 128, dtype=dtype)
        self.final_fc = Conv1x1(128, featdim) if featdim < 128 else None

    def forward(self, points, knn_ind):
        nn_8 = knn_ind[..., :8].contiguous()
        inv_8 = ops.NeighborInverse(nn_8, points.shape[1])
        init_f = self.initconv(points, nn_8, inv_8)
        init_f, _ = ops.flex_pool(init_f, nn_8, inv_8, with_arg=False)
        _, x1, _ = self.stage1(points, init_f, knn=inv_8)
        _, x2, cache = self.stage2(points, self.before_stage2_conv1d(x1))
        feat = self.local_stage1_shortcut(x1) + x2
        if self.final_fc is not None:
            feat = self.final_fc(feat)
        return points, feat, cache


class DetectionBlock(nn.Module):
    """detection_block (`core/backbones.py:132-151`): 1x1 convs 128, 256,
    1024 -> one logit (bias initialised to 1/8, `backbones.py:308-312`)
    -> sigmoid (or softplus) keypoint score."""

    def __init__(self, din: int, use_softplus: bool = False, dtype=None):
        super().__init__()
        self.use_softplus = use_softplus
        dims = [din, 128, 256, 1024]
        for i in range(3):
            self.add_module(f"detec_conv{i}",
                            Conv1x1(dims[i], dims[i + 1], dtype=dtype))
        self.detec_conv_fc = dense(1024, 1, bias=1.0 / 8)

    def forward(self, features):
        x = features
        for i in range(3):
            x = getattr(self, f"detec_conv{i}")(x)
        logits = self.detec_conv_fc(x)
        if self.use_softplus:
            return nn.functional.softplus(logits)
        return torch.sigmoid(logits)


class GlobalAttBlock(nn.Module):
    """globalatt_block (`core/backbones.py:156-173`)."""

    def __init__(self, din: int, dtype=None):
        super().__init__()
        dims = [din, 256, 1024] if din > 256 else [din, 1024]
        self.n_convs = len(dims) - 1
        for i in range(self.n_convs):
            self.add_module(f"detec_conv{i}",
                            Conv1x1(dims[i], dims[i + 1], dtype=dtype))
        self.detec_conv_fc = dense(1024, 1)

    def forward(self, features):
        x = features
        for i in range(self.n_convs):
            x = getattr(self, f"detec_conv{i}")(x)
        return torch.sigmoid(self.detec_conv_fc(x))


class GlobalBeforeAssemble(nn.Module):
    """global_before_assemble (`core/backbones.py:178-186`): one dilated
    flexconv stage (no SE) and the upsample."""

    def __init__(self, din: int, gl_dilate: int, knn_num: int,
                 gl_dims: Sequence[int], concat_xyz: bool,
                 sorted_order: bool, exact: bool = True, dtype=None):
        super().__init__()
        self.concat_xyz = concat_xyz
        self.global_before_assemble = FlexConvDilate(
            din + 3 if concat_xyz else din, dilate=gl_dilate, knn=knn_num,
            outdims=gl_dims, concat=False, add_se="",
            sorted_order=sorted_order, exact=exact, dtype=dtype)

    def forward(self, points, localdesc, level_cache=None):
        if self.concat_xyz:
            localdesc = torch.cat([points, localdesc], dim=-1)
        gpoints, feat, _ = self.global_before_assemble(
            points, localdesc, level_cache=level_cache)
        return gpoints, feat


class GlobalBeforeAssembleConv1d(nn.Module):
    """global_before_assemble_conv1d (`core/backbones.py:189-196`,
    `dh3d_tpu/nn/backbones.py:369-386`): pointwise 1x1 convs (Dense, BN,
    relu) `global_before_assemble_conv1{i}`, no neighbourhood."""

    def __init__(self, din: int, gl_dims: Sequence[int], concat_xyz: bool):
        super().__init__()
        self.concat_xyz = concat_xyz
        dims = [din + 3 if concat_xyz else din, *gl_dims]
        self.n_convs = len(gl_dims)
        for i in range(self.n_convs):
            self.add_module(f"global_before_assemble_conv1{i}",
                            Conv1x1(dims[i], dims[i + 1]))

    def forward(self, points, localdesc):
        x = localdesc
        if self.concat_xyz:
            x = torch.cat([points, x], dim=-1)
        for i in range(self.n_convs):
            x = getattr(self, f"global_before_assemble_conv1{i}")(x)
        return points, x


class ContextGating(nn.Module):
    """context_gating (`core/backbones.py:282-320`); its BN at momentum
    0.999 (`backbones.py:407`)."""

    def __init__(self, dim: int, add_batch_norm: bool):
        super().__init__()
        std = 1.0 / math.sqrt(dim)
        self.gating_weights = normal_param(dim, dim, std=std)
        if add_batch_norm:
            self.gating_bn = BatchNorm(dim, momentum=0.999)
        else:
            self.gating_biases = normal_param(dim, std=std)

    def forward(self, x):
        gates = x @ self.gating_weights
        if hasattr(self, "gating_bn"):
            gates = self.gating_bn(gates)
        else:
            gates = gates + self.gating_biases
        return x * torch.sigmoid(gates)


class NetVLAD(nn.Module):
    """global_netvald_block (`core/backbones.py:202-279`): attention-
    reweighted NetVLAD over 64 clusters, FC to 256, BN and context gating.
    All products in f32 (the JAX package runs them at
    precision="highest"); both BNs at momentum 0.999 (`backbones.py:
    444-446,478`)."""

    cluster_size = 64
    output_dim = 256

    def __init__(self, dim: int, add_batch_norm: bool):
        super().__init__()
        D, K = dim, self.cluster_size
        std = 1.0 / math.sqrt(D)
        self.cluster_weights = normal_param(D, K, std=std)
        if add_batch_norm:
            self.cluster_bn = BatchNorm(K, momentum=0.999)
        else:
            self.cluster_biases = normal_param(K, std=std)
        self.cluster_weights2 = normal_param(1, D, K, std=std)
        self.hidden1_weights = normal_param(D * K, self.output_dim,
                                            std=1.0 / math.sqrt(K))
        self.hidden_bn = BatchNorm(self.output_dim, momentum=0.999)
        self.gating = ContextGating(self.output_dim, add_batch_norm)

    def forward(self, features, att):
        B = features.shape[0]
        x = l2_normalize(features, dim=-1)
        act = x @ self.cluster_weights  # [B, N, K]
        if hasattr(self, "cluster_bn"):
            act = self.cluster_bn(act)
        else:
            act = act + self.cluster_biases
        act = torch.softmax(act, dim=-1) * att  # att [B, N, 1]
        a = act.sum(dim=1, keepdim=True) * self.cluster_weights2  # [B, D, K]
        vlad = x.transpose(1, 2) @ act - a  # [B, D, K]
        vlad = l2_normalize(vlad, dim=1)  # intra-normalise over D
        vlad = l2_normalize(vlad.reshape(B, -1), dim=-1)
        return self.gating(self.hidden_bn(vlad @ self.hidden1_weights))
