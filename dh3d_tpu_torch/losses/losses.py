"""Loss functions: counterpart of `dh3d_tpu/losses/losses.py:22-394`
(reference `core/losses.py`), channel-last, f32.

  desc_local_loss          N-tuple contrastive loss on keypoint descriptors
  local_detection_loss_nn  unsupervised keypoint detector loss
  lazy_triplet_loss        PointNetVLAD lazy triplet
  lazy_quadruplet_loss     lazy quadruplet
  batch_hard_*             the batch-hard twins (one process; with an
                           `axis_name` they raise: parallel is not ported)

Every formula follows the JAX function term by term, so that discrete
choices (thresholds, argmin, argmax, the top-k ranking) fall the same way:
descriptor distances by the matmul identity, geometric ones by explicit
differences; `jax.lax.top_k(-d)` is a stable ascending sort (ties keep the
lower index first); `torch.argmin` / `torch.argmax` take the first
occurrence as `jnp`'s do; `jnp.maximum(x, 0)` is `torch.maximum` against
zero and `jnp.max` / `jnp.min` over an axis are `torch.amax` / `torch.amin`
(ties share the gradient, as in JAX).
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import ops


def _max0(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def pairwise_dist(a, b):
    """Squared-L2 pairwise distances by explicit differences (geometry):
    a [B, M, D], b [B, N, D] -> [B, M, N]."""
    diff = a[:, :, None, :] - b[:, None, :, :]
    return torch.sum(diff * diff, dim=-1)


def pairwise_dist_matmul(a, b):
    """Squared-L2 by the matmul identity a^2 - 2ab + b^2, clamped at 0
    (descriptors; `core/tf_utils.py:125-136`)."""
    ab = torch.bmm(a, b.transpose(1, 2))
    a2 = torch.sum(a * a, dim=-1)[:, :, None]
    b2 = torch.sum(b * b, dim=-1)[:, None, :]
    return _max0(a2 - 2.0 * ab + b2)


def pairwise_dist_cosine(a, b, isl2norm=True):
    """Cosine similarity matrix clipped to [-1, 1]; `isl2norm` is ignored,
    as upstream (`core/tf_utils.py:112-123`)."""
    del isl2norm
    return torch.clamp(torch.bmm(a, b.transpose(1, 2)), -1.0, 1.0)


def desc_local_loss(outs, pos_r=0.5, search_r=20.0, margin=0.8,
                    neg_weight=5.0, **unused):
    """N-tuple contrastive loss over sampled correspondences
    (`core/losses.py:29-62`).  Returns (loss, aux)."""
    xyz0, xyz1 = torch.chunk(outs["xyz_sampled"], 2, dim=0)
    feat0, feat1 = torch.chunk(outs["feat_sampled"], 2, dim=0)
    xyz0_warp = torch.bmm(xyz0, outs["R"])
    xyzdist = torch.sqrt(pairwise_dist(xyz0_warp, xyz1) + 1e-10)
    is_neg = ((xyzdist > pos_r * 2) & (xyzdist < search_r)).float()
    is_pos = (xyzdist < pos_r).float()

    feat_dist = torch.sqrt(pairwise_dist_matmul(feat0, feat1) + 1e-10)
    num_pos = torch.sum(is_pos)
    num_neg = torch.sum(is_neg)
    pos_loss = torch.sum(is_pos * feat_dist) / (num_pos + 1e-10)
    neg_loss = neg_weight * (
        torch.sum(is_neg * torch.relu(margin - feat_dist)) / (num_neg + 1e-10))
    loss = pos_loss + neg_loss
    return loss, {"pos_loss": pos_loss, "neg_loss": neg_loss,
                  "num_pos": num_pos, "num_neg": num_neg}


def _take_rows(x, idx):
    """x [B, N, C], idx [B, M] -> x[b, idx[b]] [B, M, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def detection_ranks(outs, det_k=16, ar_nn_k=5, pos_r=0.3,
                    use_hardest_neg=True, reproduce_ref_detloss_bug=False):
    """The discrete half of `local_detection_loss_nn`: for each anchor
    keypoint, the normalised rank AR of the first true match among its
    candidates, and the candidates.  Returns (ar [B, M] f32, candidate ids
    [B, M, det_k or 2*det_k] int64 into the positive cloud)."""
    _, xyz1 = torch.chunk(outs["xyz"], 2, dim=0)
    _, feat1 = torch.chunk(outs["feat"], 2, dim=0)
    s_ind = outs["sample_nodes_concat"]
    _, sample_ind1 = torch.chunk(s_ind.reshape(s_ind.shape[0], -1), 2, dim=0)
    xyz_s0, xyz_s1 = torch.chunk(outs["xyz_sampled"], 2, dim=0)
    feat_s0, feat_s1 = torch.chunk(outs["feat_sampled"], 2, dim=0)
    xyz0_warp = torch.bmm(xyz_s0, outs["R"])
    xyz1c = xyz1.contiguous()

    # neighbourhoods of the positive correspondents: kernel A, k=det_k
    knn_sampled1, _ = ops.knn_bruteforce_pairwise(xyz_s1.contiguous(), xyz1c,
                                                  det_k)
    if use_hardest_neg:
        xyz_dist_all = torch.sqrt(pairwise_dist(xyz0_warp, xyz_s1) + 1e-10)
        is_neg = (xyz_dist_all > 1.0).float()
        feat_dist_all = torch.sqrt(pairwise_dist_matmul(feat_s0, feat_s1)
                                   + 1e-10)
        neg_dist = feat_dist_all + (1.0 - is_neg) * 100.0
        hardest = torch.argmin(neg_dist, dim=2)  # [B, M]
        if reproduce_ref_detloss_bug:
            hardest_kp = hardest  # the keypoint slot used as a point id
        else:
            hardest_kp = torch.gather(sample_ind1.long(), 1, hardest)
        xyz_neg1 = _take_rows(xyz1, hardest_kp)
        knn_neg1, _ = ops.knn_bruteforce_pairwise(xyz_neg1.contiguous(),
                                                  xyz1c, det_k)
        knn_sampled1 = torch.cat([knn_sampled1, knn_neg1], dim=-1)

    sampled_xyz1 = ops.group_point(xyz1, knn_sampled1)  # [B, M, K2, 3]
    sampled_feat1 = ops.group_point(feat1, knn_sampled1)  # [B, M, K2, D]
    matching_xyz_dist = torch.sqrt(torch.sum(
        (xyz0_warp[:, :, None, :] - sampled_xyz1) ** 2, dim=-1))
    matching_feat_dist = torch.sum(
        (feat_s0[:, :, None, :] - sampled_feat1) ** 2, dim=-1)

    # top-ar_nn_k best matches: top_k(-d) keeps the lower index on ties
    idx_k = torch.sort(matching_feat_dist, dim=-1,
                       stable=True).indices[..., :ar_nn_k]
    xyzdist_sel = torch.gather(matching_xyz_dist, -1, idx_k)
    is_good = (xyzdist_sel <= pos_r).float()
    pad = torch.ones_like(is_good[..., :1])
    is_good = torch.cat([is_good, pad], dim=-1)
    first = torch.argmax(is_good, dim=-1).float()
    return (first + 1e-8) / ar_nn_k, knn_sampled1


def local_detection_loss_nn(outs, ar_th=0.3, det_k=16, ar_nn_k=5, pos_r=0.3,
                            use_hardest_neg=True,
                            reproduce_ref_detloss_bug=False, **unused):
    """Unsupervised keypoint detector loss (`core/losses.py:65-133`), with
    the JAX package's exact keypoint-row kNN and its corrected
    hardest-negative gather (`reproduce_ref_detloss_bug=True` keeps the
    reference's slot-index gather instead).  Candidate features come from
    the un-normalised `feat`, the query descriptor from `feat_sampled`.
    The score is driven toward the rank: 1 - (AR*s + ar_th*(1-s)).
    Returns (loss, aux)."""
    ar, _ = detection_ranks(outs, det_k, ar_nn_k, pos_r, use_hardest_neg,
                            reproduce_ref_detloss_bug)
    score0, _ = torch.chunk(outs["att_sampled"], 2, dim=0)  # [B, M]
    matchingloss = 1.0 - (ar * score0 + ar_th * (1.0 - score0))
    det_loss = torch.mean(matchingloss)
    return det_loss, {"det_loss": det_loss, "mean_ar": torch.mean(ar)}


def best_pos_distance(query, pos_vecs):
    """Min squared distance to the positives: query [B, 1, D], pos_vecs
    [B, P, D] -> [B]."""
    return torch.amin(torch.sum((pos_vecs - query) ** 2, dim=2), dim=1)


def _lazy_triplet_impl(q_vec, pos_vecs, neg_vecs, margin):
    best_pos = best_pos_distance(q_vec, pos_vecs)
    neg_d = torch.sum((neg_vecs - q_vec) ** 2, dim=2)
    hinge = torch.relu(margin + best_pos[:, None] - neg_d)
    return torch.mean(torch.amax(hinge, dim=1))


def _split_tuple(global_descs, batch_size, num_pos, num_neg, other_neg):
    d = global_descs.shape[-1]
    sizes = [batch_size, num_pos * batch_size, num_neg * batch_size]
    if other_neg:
        sizes.append(batch_size)
    splits = torch.split(global_descs, sizes, 0)
    q = splits[0].reshape(batch_size, 1, d)
    pos = splits[1].reshape(batch_size, num_pos, d)
    neg = splits[2].reshape(batch_size, num_neg, d)
    oneg = splits[3].reshape(batch_size, 1, d) if other_neg else None
    return q, pos, neg, oneg


def lazy_triplet_loss(global_descs, batch_size, num_pos, num_neg,
                      global_triplet_margin=0.5, **unused):
    """`core/losses.py:163-170`."""
    q, pos, neg, _ = _split_tuple(global_descs, batch_size, num_pos, num_neg,
                                  other_neg=False)
    loss = _lazy_triplet_impl(q, pos, neg, global_triplet_margin)
    return loss, {"triplet_loss": loss}


def lazy_quadruplet_loss(global_descs, batch_size, num_pos, num_neg,
                         global_triplet_margin=0.5,
                         global_quadruplet_margin=0.2, **unused):
    """`core/losses.py:173-200`: the triplet plus a second hinge of the
    negatives against the 'other negative' cloud."""
    q, pos, neg, oneg = _split_tuple(global_descs, batch_size, num_pos,
                                     num_neg, other_neg=True)
    trip = _lazy_triplet_impl(q, pos, neg, global_triplet_margin)
    best_pos = best_pos_distance(q, pos)
    neg_to_othneg = torch.sum((neg - oneg) ** 2, dim=2)
    hinge2 = torch.relu(global_quadruplet_margin + best_pos[:, None]
                        - neg_to_othneg)
    second = torch.mean(torch.amax(hinge2, dim=1))
    return trip + second, {"triplet_loss": trip, "second_loss": second}


def _global_neg_pool(neg, axis_name=None):
    """All negative clouds of the batch as one pool [B*Nn, D].  Pooling
    across processes (`axis_name`) is not ported."""
    if axis_name is not None:
        raise NotImplementedError(
            "batch-hard mining across processes (axis_name) is not ported")
    return neg.reshape(-1, neg.shape[-1])


def batch_hard_triplet_loss(global_descs, batch_size, num_pos, num_neg,
                            global_triplet_margin=0.5, axis_name=None,
                            **unused):
    """Batch-hard twin of `lazy_triplet_loss`: every query mines the
    negatives of the whole batch."""
    q, pos, neg, _ = _split_tuple(global_descs, batch_size, num_pos, num_neg,
                                  other_neg=False)
    pool = _global_neg_pool(neg, axis_name)
    best_pos = best_pos_distance(q, pos)
    neg_d = torch.sum((pool[None, :, :] - q) ** 2, dim=2)
    hinge = torch.relu(global_triplet_margin + best_pos[:, None] - neg_d)
    loss = torch.mean(torch.amax(hinge, dim=1))
    return loss, {"triplet_loss": loss,
                  "hardest_neg_dist": torch.mean(torch.amin(neg_d, dim=1))}


def batch_hard_quadruplet_loss(global_descs, batch_size, num_pos, num_neg,
                               global_triplet_margin=0.5,
                               global_quadruplet_margin=0.2, axis_name=None,
                               **unused):
    """Batch-hard twin of `lazy_quadruplet_loss`."""
    q, pos, neg, oneg = _split_tuple(global_descs, batch_size, num_pos,
                                     num_neg, other_neg=True)
    pool = _global_neg_pool(neg, axis_name)
    best_pos = best_pos_distance(q, pos)
    neg_d = torch.sum((pool[None, :, :] - q) ** 2, dim=2)
    hinge = torch.relu(global_triplet_margin + best_pos[:, None] - neg_d)
    trip = torch.mean(torch.amax(hinge, dim=1))
    neg_to_othneg = torch.sum((pool[None, :, :] - oneg) ** 2, dim=2)
    hinge2 = torch.relu(global_quadruplet_margin + best_pos[:, None]
                        - neg_to_othneg)
    second = torch.mean(torch.amax(hinge2, dim=1))
    return trip + second, {
        "triplet_loss": trip, "second_loss": second,
        "hardest_neg_dist": torch.mean(torch.amin(neg_d, dim=1))}


LOCAL_LOSSES = {"desc_local_loss": desc_local_loss}
DETECTION_LOSSES = {"local_detection_loss_nn": local_detection_loss_nn}
GLOBAL_LOSSES = {
    "lazy_triplet_loss": lazy_triplet_loss,
    "lazy_quadruplet_loss": lazy_quadruplet_loss,
    "batch_hard_triplet_loss": batch_hard_triplet_loss,
    "batch_hard_quadruplet_loss": batch_hard_quadruplet_loss,
}
BATCH_HARD_UPGRADE = {
    "lazy_triplet_loss": "batch_hard_triplet_loss",
    "lazy_quadruplet_loss": "batch_hard_quadruplet_loss",
}


def compute_total_loss(outs, cfg, params_l2=0.0):
    """Loss dispatch of `DH3D.compute_loss` (`core/model.py:212-246`).
    `params_l2` is the sum of squares of the Dense kernels
    (`train.trainer.kernel_l2`).  Returns (total, metrics)."""
    total = 0.0
    metrics = {}

    def _default(v, d):
        # an explicit 0.0 stays 0.0; only a missing key takes the default
        return d if v is None else v

    if cfg.extract_global:
        loss_name = cfg.global_loss
        if cfg.cross_device_mining:
            loss_name = BATCH_HARD_UPGRADE.get(loss_name, loss_name)
        gl, aux = GLOBAL_LOSSES[loss_name](
            outs["global_desc"], cfg.batch_size, cfg.num_pos, cfg.num_neg,
            global_triplet_margin=_default(cfg.global_triplet_margin, 0.5),
            global_quadruplet_margin=_default(
                cfg.global_quadruplet_margin, 0.2),
            axis_name=cfg.bn_axis_name)
        gl = gl * _default(cfg.global_loss_weight, 1.0)
        metrics["globaldesc_loss"] = gl
        metrics.update(aux)
        total += gl

    if cfg.add_local_loss:
        ll, aux = LOCAL_LOSSES[cfg.local_loss](
            outs, pos_r=cfg.pos_r, search_r=cfg.search_r, margin=cfg.margin,
            neg_weight=cfg.neg_weight)
        ll = ll * _default(cfg.local_loss_weight, 1.0)
        metrics["localdesc_loss"] = ll
        metrics.update(aux)
        total += ll

    if cfg.detection and cfg.add_det_loss:
        dl, aux = DETECTION_LOSSES[cfg.detection_loss](
            outs, ar_th=cfg.ar_th, det_k=cfg.det_k, ar_nn_k=cfg.ar_nn_k,
            pos_r=cfg.pos_r,
            reproduce_ref_detloss_bug=bool(cfg.reproduce_ref_detloss_bug))
        dl = dl * _default(cfg.det_loss_weight, 1.0)
        metrics["det_loss_weighted"] = dl
        metrics.update(aux)
        total += dl

    metrics["gl_loc_loss"] = total
    if cfg.add_weight_decay:
        wd = cfg.train_weight_decay * params_l2
        metrics["wd_cost"] = wd
        total = total + wd
    metrics["total_cost"] = total
    return total, metrics
