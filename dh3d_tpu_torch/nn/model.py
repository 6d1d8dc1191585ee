"""The DH3D model: dense local descriptors, keypoint attention and the
attention-weighted NetVLAD global descriptor.

Counterpart of `dh3d_tpu/nn/model.py:24-276` (reference
`core/model.py:33-255`).  `compute_dtype` is "float32" or "bfloat16"
(`compute_dtype`; the modules it reaches are listed in `nn/backbones.py`;
parameters, positions and every output stay f32).  Neighbour sets are exact
(`morton_exact`, the default) or, with `morton_exact=False`, the legacy
approximate mode's Morton bands (`ops.knn_window`): the full-resolution
kNN of a Morton-ordered cloud of N >= 1024, N % 256 == 0, in a band of 512
rows, and the wide levels' as `backbones.FlexConvDilate` routes them.
`remat` recomputes the local backbone in the backward (train mode).
The `outs` dict carries the same keys as the JAX model.  `self.training`
is the JAX `train` flag: BatchNorm on batch statistics, except in the
groups a config freezes (`FREEZE_GROUPS`), which stay on their running
statistics as `use_running_average=ura or cfg.freeze*` keeps them
(`dh3d_tpu/nn/model.py:168,198,226`); and the outputs stay in Morton
order, which the losses read (`dh3d_tpu/nn/model.py:126-131`).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dh3d_tpu_torch import ops, trace
from dh3d_tpu_torch.config import dotdict
from dh3d_tpu_torch.nn import backbones
from dh3d_tpu_torch.nn.layers import frozen_statistics, l2_normalize


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


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(cfg):
    """The compute dtype `cfg.compute_dtype` names for the layers that
    take one: None for "float32" (or unset), torch.bfloat16 for
    "bfloat16"; NotImplementedError for any other (the JAX package would
    run float16 throughout, which the port does not)."""
    name = cfg.compute_dtype or "float32"
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port runs float32 and bfloat16")
    return COMPUTE_DTYPES[name]


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
        dt = compute_dtype(cfg)
        gb = cfg.global_backbone or "global_before_assemble"
        if gb not in ("global_before_assemble",
                      "global_before_assemble_conv1d"):
            raise ValueError(f"global_backbone={gb!r}")
        featdim = cfg.featdim or 128
        local_dim = featdim if featdim < 128 else 128
        sorted_order = bool(cfg.morton_order)
        self.exact = cfg.morton_exact is not False
        self.share_level = bool(
            cfg.extract_global and gb == "global_before_assemble"
            and (cfg.gl_dilate or 8) == (cfg.dilate or 8) > 1
            and cfg.share_level_cache is not False)
        self.local_backbone = backbones.BackboneLocalDilate(
            featdim=featdim, dilate2=cfg.dilate or 8,
            sorted_order=sorted_order, exact=self.exact, dtype=dt)
        if cfg.detection:
            self.detection_block = backbones.DetectionBlock(
                local_dim, use_softplus=bool(cfg.use_softplus), dtype=dt)
        if cfg.extract_global:
            gl_dims = tuple(cfg.gl_dims or (256,))
            if gb == "global_before_assemble":
                self.global_backbone = backbones.GlobalBeforeAssemble(
                    local_dim, gl_dilate=cfg.gl_dilate or 8,
                    knn_num=cfg.knn_num, gl_dims=gl_dims,
                    concat_xyz=bool(cfg.concat_xyz),
                    sorted_order=sorted_order, exact=self.exact, dtype=dt)
            else:
                self.global_backbone = backbones.GlobalBeforeAssembleConv1d(
                    local_dim, gl_dims=gl_dims,
                    concat_xyz=bool(cfg.concat_xyz))
            self.globalatt = backbones.GlobalAttBlock(gl_dims[-1], dtype=dt)
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
        [B, sampled_kpnum] keypoint ids.  Returns the `outs` dict.  Spans
        (`trace`): `model.forward`, and in it `model.morton` (the Z-order
        sort and the row gathers it feeds), `model.backbone` (the local
        backbone and the level cache it hands on) and, with
        `extract_global`, `model.global` (`global_backbone`, `globalatt`
        and `global_assemble`)."""
        with trace.span("model.forward", points):
            return self._forward(points, knn_inds, sample_inds)

    def _forward(self, points, knn_inds, sample_inds):
        cfg = self.cfg
        inv_perm = None
        if cfg.morton_order and not cfg.morton_presorted:
            # Z-order sort; every per-point computation runs in sorted
            # space and dense outputs are un-permuted on exit in eval mode
            # (training keeps the sorted order: the losses read it)
            with trace.span("model.morton", points):
                perm, inv_perm = ops.morton_perm(points)
                points = _take_rows(points, perm)
                if sample_inds is not None:
                    sample_inds = torch.gather(
                        inv_perm, 1,
                        sample_inds.reshape(points.shape[0], -1))
                if knn_inds is not None:
                    rows = _take_rows(knn_inds, perm)
                    knn_inds = torch.gather(
                        inv_perm, 1, rows.reshape(rows.shape[0], -1)
                    ).reshape(rows.shape)

        if knn_inds is None:
            # the legacy mode's full-resolution band (`dh3d_tpu/nn/
            # model.py:104-115`)
            N = points.shape[1]
            banded_l0 = cfg.morton_order and N % 256 == 0 and N >= 1024
            knn_inds, _ = ops.knn_bruteforce(
                points, cfg.knn_num,
                window=512 if banded_l0 and not self.exact else None)

        def unpermute(x):
            if inv_perm is None or self.training:
                return x
            return _take_rows(x, inv_perm)

        outs = {"xyz": unpermute(points), "knn_indices": knn_inds}

        with trace.span("model.backbone", points):
            if cfg.remat and self.training and torch.is_grad_enabled():
                # recompute the backbone in the backward (`nn.remat`), its
                # BatchNorms then leaving their running statistics alone
                newpoints, localdesc, level_cache = checkpoint(
                    self.local_backbone, points, knn_inds,
                    use_reentrant=False,
                    context_fn=lambda: (
                        contextlib.nullcontext(),
                        frozen_statistics(self.local_backbone)))
            else:
                newpoints, localdesc, level_cache = self.local_backbone(
                    points, knn_inds)
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
            with trace.span("model.global", points):
                if self.share_level:
                    gpoints, forglobal = self.global_backbone(
                        newpoints, localdesc, level_cache=level_cache)
                else:
                    gpoints, forglobal = self.global_backbone(newpoints,
                                                              localdesc)
                if cfg.global_subsample and cfg.global_subsample > 0:
                    gpoints, forglobal, _ = ops.subsample(
                        gpoints, forglobal, cfg.global_subsample)
                global_att = self.globalatt(forglobal)
                globaldesc = self.global_assemble(forglobal, global_att)
                outs["global_desc"] = l2_normalize(globaldesc, dim=-1,
                                                   epsilon=1e-8)
        return outs


def concat_tuple_clouds(cfg, anchor, pos=None, neg=None, otherneg=None):
    """Flatten the Siamese tuple along the batch axis
    (`dh3d_tpu/nn/model.py:306-319`, reference `core/model.py:139-146`):
    [anchor | pos | neg | otherneg], pos and neg each reshaped to
    [-1, num_points, 3]; a part is left out when it is None or the config
    has none of it (num_pos, num_neg, other_neg)."""
    n = cfg.num_points
    parts = [anchor]
    if pos is not None and cfg.num_pos > 0:
        parts.append(pos.reshape(-1, n, 3))
    if neg is not None and cfg.num_neg > 0:
        parts.append(neg.reshape(-1, n, 3))
    if otherneg is not None and cfg.other_neg:
        parts.append(otherneg)
    return torch.cat(parts, dim=0)
