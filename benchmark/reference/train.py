"""A stage-2 training step in plain PyTorch: the self pairs, the losses,
autograd, Adam.

Pairs (reference `core/datasets.py:126-151`, built on the device from the
draws the benchmark hands both sides): the anchors are FPS over a random
half of the first copy, seeded at the subset's first entry; their
positives are the nearest point of the second copy, unrotated; the second
copy enters the network rotated about z by the drawn angle.

Losses (reference `core/losses.py:29-133`):
  desc_local_loss          positives within pos_r, negatives in
                           (2 pos_r, search_r), sqrt distances, margin
                           hinge on the negatives weighted neg_weight
  local_detection_loss_nn  for each anchor, the rank (of ar_nn_k) of the
                           first true match among the det_k nearest points
                           of its correspondent and of its hardest
                           negative keypoint's correspondent;
                           1 - (AR s + ar_th (1 - s)) on the anchor's score
plus weight decay on every Dense kernel.  Adam (b1 0.9, b2 0.999, eps
1e-8) with a staircase exponential learning rate.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.geometry import (fps, knn, morton_sort_np,
                                          rotate_rows, rotation_z, take)


def presort(clouds: torch.Tensor) -> torch.Tensor:
    """The loader's Z-order sort of every cloud, on the host."""
    return torch.from_numpy(morton_sort_np(clouds.cpu().numpy())).to(
        clouds.device)


def pairs(pc1, pc2, kpnum, angles, subsets) -> dict:
    """points [2B, N, 3], sample_inds [2B, kpnum], R [B, 3, 3]."""
    R = rotation_z(angles)
    sub = take(pc1, subsets)
    anchors = torch.gather(subsets, 1, fps(sub, kpnum))
    pos, _ = knn(take(pc1, anchors), pc2, 1)
    return {"points": torch.cat([pc1, rotate_rows(pc2, R)]),
            "sample_inds": torch.cat([anchors, pos[..., 0]]), "R": R}


def _pdist(a, b):
    d = a[:, :, None, :] - b[:, None, :, :]
    return torch.sum(d * d, dim=-1)


def _pdist_matmul(a, b):
    ab = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp_min(torch.sum(a * a, -1)[:, :, None] - 2.0 * ab
                           + torch.sum(b * b, -1)[:, None, :], 0.0)


def desc_local_loss(outs, R, pos_r, search_r, margin, neg_weight):
    xyz0, xyz1 = torch.chunk(outs["xyz_sampled"], 2)
    f0, f1 = torch.chunk(outs["feat_sampled"], 2)
    d = torch.sqrt(_pdist(torch.bmm(xyz0, R), xyz1) + 1e-10)
    is_neg = ((d > 2 * pos_r) & (d < search_r)).float()
    is_pos = (d < pos_r).float()
    fd = torch.sqrt(_pdist_matmul(f0, f1) + 1e-10)
    pos = torch.sum(is_pos * fd) / (torch.sum(is_pos) + 1e-10)
    neg = neg_weight * torch.sum(is_neg * torch.relu(margin - fd)) \
        / (torch.sum(is_neg) + 1e-10)
    return pos + neg


def detection_loss(outs, R, ar_th, det_k, ar_nn_k, pos_r):
    _, xyz1 = torch.chunk(outs["xyz"], 2)
    _, feat1 = torch.chunk(outs["feat"], 2)
    _, ind1 = torch.chunk(outs["sample_nodes_concat"], 2)
    xs0, xs1 = torch.chunk(outs["xyz_sampled"], 2)
    fs0, fs1 = torch.chunk(outs["feat_sampled"], 2)
    warp = torch.bmm(xs0, R)
    cand, _ = knn(xs1, xyz1, det_k)
    is_neg = (torch.sqrt(_pdist(warp, xs1) + 1e-10) > 1.0).float()
    fd = torch.sqrt(_pdist_matmul(fs0, fs1) + 1e-10)
    hardest = torch.argmin(fd + (1.0 - is_neg) * 100.0, dim=2)
    neg_pts = take(xyz1, torch.gather(ind1, 1, hardest))
    cand = torch.cat([cand, knn(neg_pts, xyz1, det_k)[0]], dim=-1)
    xyz_dist = torch.sqrt(torch.sum((warp[:, :, None] - take(xyz1, cand))
                                    ** 2, dim=-1))
    feat_dist = torch.sum((fs0[:, :, None] - take(feat1, cand)) ** 2, dim=-1)
    best = torch.sort(feat_dist, dim=-1, stable=True).indices[..., :ar_nn_k]
    good = (torch.gather(xyz_dist, -1, best) <= pos_r).float()
    good = torch.cat([good, torch.ones_like(good[..., :1])], dim=-1)
    ar = (torch.argmax(good, dim=-1).float() + 1e-8) / ar_nn_k
    score, _ = torch.chunk(outs["att_sampled"], 2)
    return torch.mean(1.0 - (ar * score + ar_th * (1.0 - score)))


def loss(cfg, params, outs, R):
    total = cfg["local_loss_weight"] * desc_local_loss(
        outs, R, cfg["pos_r"], cfg["search_r"], cfg["margin"],
        cfg["neg_weight"])
    total = total + cfg["det_loss_weight"] * detection_loss(
        outs, R, cfg["ar_th"], cfg["det_k"], cfg["ar_nn_k"], cfg["pos_r"])
    wd = sum(torch.sum(p * p) for n, p in params.items()
             if M.is_dense_kernel(n))
    return total + cfg["train_weight_decay"] * wd


class Adam:
    """Adam on a dict of leaves, with the staircase learning rate read at
    the update count before the increment."""

    def __init__(self, cfg, leaves: dict):
        self.cfg, self.t = cfg, 0
        self.m = {n: torch.zeros_like(p) for n, p in leaves.items()}
        self.v = {n: torch.zeros_like(p) for n, p in leaves.items()}

    def step(self, leaves: dict, grads: dict):
        c = self.cfg
        lr = c["start_lr"] * c["decay_rate"] ** (self.t // c["decay_step"])
        self.t += 1
        b1, b2 = 0.9, 0.999
        with torch.no_grad():
            for n, p in leaves.items():
                g = grads[n]
                self.m[n] = b1 * self.m[n] + (1 - b1) * g
                self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
                mh = self.m[n] / (1 - b1 ** self.t)
                vh = self.v[n] / (1 - b2 ** self.t)
                p -= lr * mh / (torch.sqrt(vh) + 1e-8)


def train(cfg, weights: dict, steps: list) -> dict:
    """Run `steps` ([{pc1, pc2, angles, subsets}], clouds unsorted) from
    `weights`.  Returns losses [float], grad0 {leaf: first gradient},
    params and stats {leaf: tensor} after the last step."""
    leaves = {n: w.detach().clone().requires_grad_(True)
              for n, w in weights.items() if not M.is_statistic(n)}
    stats = {n: w.detach().clone() for n, w in weights.items()
             if M.is_statistic(n)}
    opt = Adam(cfg, leaves)
    losses, grad0 = [], None
    for s in steps:
        b = pairs(presort(s["pc1"]), presort(s["pc2"]), cfg["sampled_kpnum"],
                  s["angles"], s["subsets"])
        outs, moved = M.forward(cfg, {**leaves, **stats}, b["points"],
                                train=True, sample_inds=b["sample_inds"])
        total = loss(cfg, leaves, outs, b["R"])
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            total, [leaves[n] for n in names])))
        losses.append(float(total.detach()))
        if grad0 is None:
            grad0 = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(leaves, grads)
        stats.update(moved)
        del outs, total, grads
    return {"losses": losses, "grad0": grad0,
            "params": {n: p.detach() for n, p in leaves.items()},
            "stats": stats}


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), the median leaf's
    norm(ref))}."""
    names = [n for n in ref if leaves is None or n in leaves]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    out = {}
    for n in names:
        pn = float(torch.linalg.vector_norm(prog[n].double()))
        scale = max(rn[n], med)
        out[n] = abs(pn - rn[n]) / scale if scale > 0 \
            else (0.0 if pn == 0 else math.inf)
    return out


def norm_gaps(prog: dict, ref: dict, leaves=None) -> tuple:
    """The worst leaf's gap (`leaf_gaps`) and that leaf."""
    worst, leaf = 0.0, None
    for n, gap in leaf_gaps(prog, ref, leaves).items():
        if not gap <= worst:  # a NaN is the worst
            worst, leaf = gap, n
    return worst, leaf


def median_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The median leaf's gap (`leaf_gaps`); NaN when any leaf's is."""
    gaps = list(leaf_gaps(prog, ref, leaves).values())
    return math.nan if any(g != g for g in gaps) else float(np.median(gaps))
