"""A stage-3 training step in plain PyTorch: the global descriptor trained
on Siamese tuples with the local backbone frozen, the lazy quadruplet
loss, autograd, Adam.

The network is `reference/model.py`'s, run by `GroupNet`: the frozen
groups' BatchNorms normalise with their running statistics and leave them
alone; the trained groups' use the batch's statistics and move their
running statistics (at 0.9, NetVLAD's at 0.999), as `Net` does in train
mode.  Only the trained groups' leaves take part in autograd, so nothing
is recorded through the frozen backbone.

A step's clouds come in the tuple order of the reference's
`concat_tuple_clouds` (`core/model.py:139-146`): the batch's anchors, then
each anchor's positives, each anchor's negatives and each anchor's other
negative; the loader sorts every cloud along the Z-order curve first
(`geometry.morton_sort_np`).

Losses (reference `core/losses.py:173-200`, `core/model.py:239-255`):
  lazy_quadruplet_loss  best positive: the least squared distance of the
                        anchor's descriptor to its positives'; the triplet
                        hinge max over the negatives of
                        relu(m1 + best - |neg - anchor|^2), the second
                        hinge max over the negatives of
                        relu(m2 + best - |neg - other negative|^2); each
                        maximum averaged over the batch, the two added
plus weight decay on every Dense kernel, frozen ones included (a constant
for them).  Adam (`reference/train.py`) over the trained leaves only.

Departures from the published description, all the configuration's:
  - the learning rate rises linearly from 0 over `warmup_steps` updates,
    then the staircase decay reads the updates since (the published
    schedule has no warmup; the configuration's `warmup_steps` asks for
    one, so step 1 takes no update);
  - clouds arrive Z-order sorted (`morton_presorted`), which the published
    loader does not do; the network's outputs do not depend on the order
    but for rounding and the FPS seed.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M
from benchmark.reference import train as ref_train
from benchmark.reference.geometry import morton_sort_np

# module groups each freeze flag holds still (`core/model.py:239-255`)
FREEZE = {"freezebackbone": ("local_backbone",),
          "freezedetection": ("detection_block",),
          "freezeglobal": ("global_backbone", "globalatt", "global_assemble")}


def frozen_groups(cfg) -> set:
    return {g for flag, groups in FREEZE.items() if cfg.get(flag)
            for g in groups}


def is_frozen(name: str, frozen: set) -> bool:
    return name.split(".")[0] in frozen


class GroupNet(M.Net):
    """`Net` in train mode, but with the frozen groups' BatchNorms on their
    running statistics (moving nothing)."""

    def __init__(self, params: dict, frozen: set):
        super().__init__(params, train=True)
        self.frozen = frozen

    def bn(self, x, name, momentum=0.9):
        if not is_frozen(name, self.frozen):
            return super().bn(x, name, momentum)
        p = self.p
        return (x - p[f"{name}.mean"]) * (
            torch.rsqrt(p[f"{name}.var"] + M.BN_EPS) * p[f"{name}.scale"]) \
            + p[f"{name}.bias"]


def tuple_rows(batch: int, num_pos: int, num_neg: int, tuples) -> list:
    """The rows, in the tuple order, of the clouds of `tuples` (tuple ids
    of a batch of `batch`)."""
    pos0, neg0 = batch, batch + batch * num_pos
    oth0 = neg0 + batch * num_neg
    return ([t for t in tuples]
            + [pos0 + t * num_pos + j for t in tuples for j in range(num_pos)]
            + [neg0 + t * num_neg + j for t in tuples for j in range(num_neg)]
            + [oth0 + t for t in tuples])


def quadruplet_terms(desc, batch: int, num_pos: int, num_neg: int,
                     m1: float, m2: float) -> dict:
    """desc [batch * (2 + num_pos + num_neg), D] in the tuple order ->
    pos_d [batch, num_pos] (squared distances to the positives), hinge1
    and hinge2 [batch, num_neg], and the loss."""
    D = desc.shape[-1]
    q = desc[:batch].reshape(batch, 1, D)
    pos = desc[batch:batch * (1 + num_pos)].reshape(batch, num_pos, D)
    neg = desc[batch * (1 + num_pos):batch * (1 + num_pos + num_neg)] \
        .reshape(batch, num_neg, D)
    other = desc[batch * (1 + num_pos + num_neg):].reshape(batch, 1, D)
    pos_d = torch.sum((pos - q) ** 2, dim=2)
    best = torch.amin(pos_d, dim=1, keepdim=True)
    hinge1 = torch.relu(m1 + best - torch.sum((neg - q) ** 2, dim=2))
    hinge2 = torch.relu(m2 + best - torch.sum((neg - other) ** 2, dim=2))
    loss = torch.mean(torch.amax(hinge1, dim=1)) \
        + torch.mean(torch.amax(hinge2, dim=1))
    return {"pos_d": pos_d, "hinge1": hinge1, "hinge2": hinge2,
            "loss": loss}


def terms(cfg, desc, batch=None) -> dict:
    """`quadruplet_terms` with the configuration's tuple and margins."""
    return quadruplet_terms(desc, batch or cfg["batch_size"], cfg["num_pos"],
                            cfg["num_neg"], cfg["global_triplet_margin"],
                            cfg["global_quadruplet_margin"])


def loss(cfg, params: dict, desc, batch=None):
    """(total, terms): the quadruplet loss, weighted, plus weight decay."""
    t = terms(cfg, desc, batch)
    total = cfg.get("global_loss_weight", 1.0) * t["loss"]
    if cfg["add_weight_decay"]:
        wd = sum(torch.sum(p * p) for n, p in params.items()
                 if M.is_dense_kernel(n))
        total = total + cfg["train_weight_decay"] * wd
    return total, t


class Adam(ref_train.Adam):
    """`reference/train.py`'s Adam with the configuration's warmup: at
    update t the rate is start_lr * t / warmup_steps while t is below
    warmup_steps, then start_lr * decay_rate ** ((t - warmup_steps) //
    decay_step)."""

    def __init__(self, cfg, leaves: dict):
        super().__init__(cfg, leaves)
        self.schedule = cfg

    def step(self, leaves: dict, grads: dict):
        c, t = self.schedule, self.t
        warm = int(c.get("warmup_steps") or 0)
        lr = c["start_lr"] * t / warm if t < warm else \
            c["start_lr"] * c["decay_rate"] ** ((t - warm) // c["decay_step"])
        self.cfg = {"start_lr": lr, "decay_rate": 1.0, "decay_step": 1}
        super().step(leaves, grads)


def train(cfg, weights: dict, steps: list, batch=None) -> dict:
    """Run `steps` (clouds [batch * 12, N, 3] each in the tuple order,
    unsorted) from `weights`; `batch` tuples a step (the configuration's
    batch_size by default).  Returns losses [float], descs [the global
    descriptors of each step], terms [each step's `quadruplet_terms`],
    grad0 {trained leaf: first gradient}, params and stats {leaf: tensor}
    after the last step (the frozen ones as they came)."""
    frozen = frozen_groups(cfg)
    leaves = {n: w.detach().clone().requires_grad_(True)
              for n, w in weights.items()
              if not M.is_statistic(n) and not is_frozen(n, frozen)}
    fixed = {n: w.detach().clone() for n, w in weights.items()
             if n not in leaves}
    opt = Adam(cfg, leaves)
    losses, descs, step_terms, grad0 = [], [], [], None
    for clouds in steps:
        pts = torch.from_numpy(morton_sort_np(clouds.cpu().numpy())).to(
            clouds.device)
        net = GroupNet({**fixed, **leaves}, frozen)
        outs, moved = M.forward(cfg, net.p, pts, train=True, net=net)
        total, t = loss(cfg, {**fixed, **leaves}, outs["global_desc"], batch)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            total, [leaves[n] for n in names], allow_unused=True)))
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in grads.items()}
        losses.append(float(total.detach()))
        descs.append(outs["global_desc"].detach())
        step_terms.append({k: v.detach() for k, v in t.items()})
        if grad0 is None:
            grad0 = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(leaves, grads)
        fixed.update(moved)
        del outs, total, grads
    return {"losses": losses, "descs": descs, "terms": step_terms,
            "grad0": grad0,
            "params": {n: p.detach() for n, p in leaves.items()},
            "stats": {n: v for n, v in fixed.items() if M.is_statistic(n)},
            "frozen": {n: v for n, v in fixed.items()
                       if not M.is_statistic(n)}}
