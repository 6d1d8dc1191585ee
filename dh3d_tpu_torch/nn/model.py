"""The DH3D model: dense local descriptors, keypoint attention and the
attention-weighted NetVLAD global descriptor.

Counterpart of `dh3d_tpu/nn/model.py:24-276` (reference
`core/model.py:33-255`), f32 only, exact neighbour sets (`morton_exact`).
The `outs` dict carries the same keys as the JAX model.  `self.training`
is the JAX `train` flag: BatchNorm on batch statistics, except in the
groups a config freezes (`FREEZE_GROUPS`), which stay on their running
statistics as `use_running_average=ura or cfg.freeze*` keeps them
(`dh3d_tpu/nn/model.py:168,198,226`); and the outputs stay in Morton
order, which the losses read (`dh3d_tpu/nn/model.py:126-131`).
"""

from __future__ import annotations

import torch
from torch import nn

from dh3d_tpu_torch import ops
from dh3d_tpu_torch.config import dotdict
from dh3d_tpu_torch.nn import backbones
from dh3d_tpu_torch.nn.layers import l2_normalize


# frozen module groups per config flag (`dh3d_tpu/train/trainer.py:72-76`)
FREEZE_GROUPS = {
    "freezebackbone": ("local_backbone",),
    "freezedetection": ("detection_block",),
    "freezeglobal": ("global_backbone", "globalatt", "global_assemble"),
}


def frozen_groups(cfg) -> set:
    """Names of the top-level modules `cfg` freezes."""
    return {name for flag, names in FREEZE_GROUPS.items() if cfg.get(flag)
            for name in names}


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] -> x[b, idx[b]]  [B, M, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


class DH3D(nn.Module):
    """Forward graph of `DH3D.build_graph` (`core/model.py:135-206`).

    `cfg` is kept by reference and read at every call, as the JAX module
    does, so `eval.extract.make_forward` can reset `morton_presorted`."""

    def __init__(self, cfg: dotdict):
        super().__init__()
        self.cfg = cfg
        if (cfg.compute_dtype or "float32") != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port runs f32 only")
        if cfg.morton_exact is False:
            raise NotImplementedError(
                "morton_exact=False (banded approximate kNN) is not ported")
        gb = cfg.global_backbone or "global_before_assemble"
        if cfg.extract_global and gb != "global_before_assemble":
            raise NotImplementedError(f"global_backbone={gb!r} is not ported")
        featdim = cfg.featdim or 128
        local_dim = featdim if featdim < 128 else 128
        sorted_order = bool(cfg.morton_order)
        self.share_level = bool(
            cfg.extract_global
            and (cfg.gl_dilate or 8) == (cfg.dilate or 8) > 1
            and cfg.share_level_cache is not False)
        self.local_backbone = backbones.BackboneLocalDilate(
            featdim=featdim, dilate2=cfg.dilate or 8,
            sorted_order=sorted_order)
        if cfg.detection:
            self.detection_block = backbones.DetectionBlock(
                local_dim, use_softplus=bool(cfg.use_softplus))
        if cfg.extract_global:
            gl_dims = tuple(cfg.gl_dims or (256,))
            self.global_backbone = backbones.GlobalBeforeAssemble(
                local_dim, gl_dilate=cfg.gl_dilate or 8,
                knn_num=cfg.knn_num, gl_dims=gl_dims,
                concat_xyz=bool(cfg.concat_xyz), sorted_order=sorted_order)
            self.globalatt = backbones.GlobalAttBlock(gl_dims[-1])
            self.global_assemble = backbones.NetVLAD(
                gl_dims[-1], add_batch_norm=bool(cfg.add_batch_norm))

    def train(self, mode: bool = True):
        """Train mode everywhere but in the frozen groups (BN on running
        statistics there)."""
        super().train(mode)
        if mode:
            for name in frozen_groups(self.cfg):
                if hasattr(self, name):
                    getattr(self, name).train(False)
        return self

    def forward(self, points, knn_inds=None, sample_inds=None):
        """points [B, N, 3] f32; knn_inds optional [B, N, knn_num] int64
        neighbour ids in the input order; sample_inds optional
        [B, sampled_kpnum] keypoint ids.  Returns the `outs` dict."""
        cfg = self.cfg
        inv_perm = None
        if cfg.morton_order and not cfg.morton_presorted:
            # Z-order sort; every per-point computation runs in sorted
            # space and dense outputs are un-permuted on exit in eval mode
            # (training keeps the sorted order: the losses read it)
            perm, inv_perm = ops.morton_perm(points)
            points = _take_rows(points, perm)
            if sample_inds is not None:
                sample_inds = torch.gather(
                    inv_perm, 1, sample_inds.reshape(points.shape[0], -1))
            if knn_inds is not None:
                rows = _take_rows(knn_inds, perm)
                knn_inds = torch.gather(
                    inv_perm, 1, rows.reshape(rows.shape[0], -1)
                ).reshape(rows.shape)

        if knn_inds is None:
            knn_inds, _ = ops.knn_bruteforce(points, cfg.knn_num)

        def unpermute(x):
            if inv_perm is None or self.training:
                return x
            return _take_rows(x, inv_perm)

        outs = {"xyz": unpermute(points), "knn_indices": knn_inds}

        newpoints, localdesc, level_cache = self.local_backbone(points,
                                                                knn_inds)
        if not self.share_level:
            level_cache = None
        elif (cfg.knn_num or 8) != 8:  # stage 2's kNN is knn8
            level_cache = {k: v for k, v in level_cache.items()
                           if k in ("kp_idx", "interp")}
        localdesc_l2 = l2_normalize(localdesc, dim=-1, epsilon=1e-8)
        outs["feat"] = unpermute(localdesc)
        outs["local_desc"] = unpermute(localdesc_l2)
        outs["xyz_feat"] = unpermute(
            torch.cat([newpoints, localdesc_l2], dim=-1))

        if cfg.detection:
            det_att = self.detection_block(localdesc)
            outs["attention"] = unpermute(det_att)
            outs["xyz_feat_att"] = unpermute(
                torch.cat([newpoints, localdesc_l2, det_att], dim=-1))

        if cfg.sampled_kpnum and cfg.sampled_kpnum > 0:
            if sample_inds is None:
                raise ValueError(
                    "sampled_kpnum > 0 requires sample_inds "
                    "(concat of sample_ind_anchor & sample_ind_pos)")
            xyz_s, feat_s, kp_idx = ops.subsample(
                points, localdesc_l2, cfg.sampled_kpnum, kp_idx=sample_inds)
            outs["sample_nodes_concat"] = sample_inds
            outs["xyz_sampled"] = xyz_s
            outs["feat_sampled"] = feat_s
            if cfg.detection:
                outs["att_sampled"] = ops.gather_point(det_att, kp_idx)[..., 0]

        if cfg.extract_global:
            gpoints, forglobal = self.global_backbone(
                newpoints, localdesc, level_cache=level_cache)
            if cfg.global_subsample and cfg.global_subsample > 0:
                gpoints, forglobal, _ = ops.subsample(
                    gpoints, forglobal, cfg.global_subsample)
            global_att = self.globalatt(forglobal)
            globaldesc = self.global_assemble(forglobal, global_att)
            outs["global_desc"] = l2_normalize(globaldesc, dim=-1,
                                               epsilon=1e-8)
        return outs
