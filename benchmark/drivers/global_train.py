"""Training steps: the stage-3 step on Siamese tuples of places, closed
loop.

Traffic parameters: places (scenes made in set-up), views (measurements
of each place), view_noise, view_yaw_deg and view_shift (a view's sensor
noise in metres, its largest yaw in degrees and its largest shift in
metres against its place), calibrate, ref_steps (the first steps, which
the reference follows), profile_units (steps in the traced window).  The
tuples a step takes are the configuration's batch_size, each of 1 anchor,
num_pos positives, num_neg negatives and one other negative.

Set-up makes the places on the card (`benchmark.scans`) and `views`
measurements of each: the place's points with fresh sensor noise, turned
by a yaw and shifted (a vehicle passing again, inside a positive's 10 m).
Each view then gets the configuration's loader augmentation once on the
host (`data.augment.get_augmentations_from_list`, the training loader's
numpy draws: Rotate1D, Jitter, RotateSmall) and is sorted along the
Z-order curve with the program's loader function
(`data.io.morton_sort_np`), as the training loader does under
`morton_presorted`.  Each step draws, on the card, batch_size anchors
from distinct places, num_pos positives for each among the other views
of its place, and the negatives and other negatives from places that
are none of the step's others: the clouds of a step all differ.  The
program's step (`train.make_train_step` on a `TrainState` from the
program's `make_optimizer`) gets {"points"} in the tuple order of
`nn.model.concat_tuple_clouds`.

The program's state is built once; its first `ref_steps` steps are the
reference's (`reference/global_train.py`, full size on the card, after
the program's state is freed).  Compared: the first step's loss
(relative); the first step's 24 global descriptors (max abs); the first
gradient as Adam holds it (its first moment after one step over
1 - b1), by the median trained leaf; the change of the trained
parameters after the last step, by the median leaf, leaving out the
leaves whose reference gradient is under a thousandth of the median
leaf's (the biases feeding a BatchNorm on batch statistics); the change
of the trained groups' BatchNorm statistics, by the worst leaf
(`reference/train.py`'s gaps of norms); every frozen parameter and
statistic against the weights it started from (exact); and the loss's
discrete choices (best positive, hardest negative of each hinge) over
every reference step: where the program's descriptors choose otherwise
than the reference's, how far the reference's own term at the program's
choice lies from its best.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.drivers.query import _turn
from benchmark.harness import stamp, sub_seed
from benchmark.reference import global_train as ref_gt
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights

B1 = 0.9  # Adam's first-moment decay, to read the first gradient back


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        from dh3d_tpu_torch.data.augment import get_augmentations_from_list
        from dh3d_tpu_torch.data.io import morton_sort_np
        from dh3d_tpu_torch.train import (TrainState, make_optimizer,
                                          make_train_step)

        t = cell["traffic"]
        self.limits = cell["limits"]
        self.cfg = cfg = common.port_cfg(cell["cfg"])
        self.device = device
        self.B, self.N = cfg.batch_size, cfg.num_points
        self.P, self.Nn = cfg.num_pos, cfg.num_neg
        self.places, self.views = t["places"], t["views"]
        if not cfg.other_neg or self.P + 1 > self.views \
                or self.B * (2 + self.Nn) > self.places:
            raise ValueError(
                f"a step needs other_neg, {self.P + 1} views a place and "
                f"{self.B * (2 + self.Nn)} places: {t['views']} views, "
                f"{t['places']} places")
        self.clouds = self.B * (2 + self.P + self.Nn)
        self.profile_units = t["profile_units"]

        gen = common.generator(device, seed, "scans")
        place = scans(self.places, self.N, gen)
        n = self.places * self.views
        again = place.repeat_interleave(self.views, 0) + t["view_noise"] \
            * torch.randn(n, self.N, 3, generator=gen, device=device)
        yaw = (torch.rand(n, generator=gen, device=device) * 2 - 1) \
            * np.radians(t["view_yaw_deg"])
        shift = (torch.rand(n, 3, generator=gen, device=device) * 2 - 1) \
            * t["view_shift"]
        shift[:, 2] = 0
        views = _turn(again, yaw, shift).cpu().numpy()
        rng = np.random.RandomState(sub_seed(seed, "augment") % 2 ** 32)
        augs = get_augmentations_from_list(list(cfg.data_aug))
        for i in range(n):
            v = views[i]
            for a in augs:
                v = a.apply(v, rng)
            views[i] = v.astype(np.float32)
        shape = (self.places, self.views, self.N, 3)
        self.raw = torch.from_numpy(views).to(device).reshape(shape)
        self.sorted = torch.from_numpy(morton_sort_np(views)).to(
            device).reshape(shape)
        stamp("places, views and their augmentation made and sorted")

        w = make_weights(cfg, sub_seed(seed, "weights"), device)
        self.weights = calibrate(cfg, w, self.sorted[:t["calibrate"], 0])
        stamp("weights made and calibrated")
        model = common.port_model(cfg, self.weights, device)
        self.state = TrainState(model, make_optimizer(cfg, model))
        self.step_fn = make_train_step(cfg)
        self.draws = common.generator(device, seed, "draws")

        # the first steps, which the reference follows (and which warm up
        # every shape of the window); their descriptors read by a hook
        self.ref_inputs, self.descs, losses = [], [], []
        trained = [n for n, p in model.named_parameters() if p.requires_grad]
        hook = model.register_forward_hook(
            lambda m, a, outs: self.descs.append(
                outs["global_desc"].detach().clone()))
        for s in range(t["ref_steps"]):
            place_ids, view_ids = self.draw()
            self.ref_inputs.append(self.raw[place_ids, view_ids])
            losses.append(self.step_fn(
                self.state, {"points": self.sorted[place_ids, view_ids]}
            )["total_cost"])
            if s == 0:
                opt = self.state.optimizer
                params = dict(model.named_parameters())
                self.grad0 = {n: opt.state[params[n]].get(
                    "exp_avg", torch.zeros_like(params[n])) / (1 - B1)
                    for n in trained}
        hook.remove()
        self.losses = [float(v) for v in losses]
        stamp("the reference's steps run (warmed up)")
        self.after = {n: v.detach().clone()
                      for n, v in model.state_dict().items()}
        common.sync(device)

    def draw(self) -> tuple:
        """(place ids, view ids) [clouds] of one step, in the tuple
        order, drawn on the card."""
        g, dev, B, P, Nn = self.draws, self.device, self.B, self.P, self.Nn
        order = torch.argsort(torch.rand(self.places, generator=g,
                                         device=dev))[:B * (2 + Nn)]
        anchors = order[:B]
        vs = torch.argsort(torch.rand(B, self.views, generator=g,
                                      device=dev), dim=1)
        others = torch.randint(self.views, (B * (1 + Nn),), generator=g,
                               device=dev)
        place_ids = torch.cat([anchors, anchors.repeat_interleave(P),
                               order[B:]])
        view_ids = torch.cat([vs[:, 0], vs[:, 1:1 + P].reshape(-1), others])
        return place_ids, view_ids

    def unit(self):
        place_ids, view_ids = self.draw()
        self.step_fn(self.state, {"points": self.sorted[place_ids, view_ids]})

    def window(self, seconds: float) -> dict:
        n, s = common.window_loop(seconds, lambda _: self.unit(), self.device)
        c = n * self.clouds
        return {"attempted": c, "failed": 0, "units": n, "seconds": s,
                "values": {"clouds_per_s": c / s}}

    def counts(self) -> dict:
        return {}  # no metric of this cell reads counts

    def spans(self) -> dict:
        return {}

    def release(self):
        del self.state, self.step_fn
        common.free(self.device)

    def reference_side(self, half: bool = False) -> dict:
        """The plain reference's first steps: losses, descs, grad0, the
        state after them ({leaf: tensor}) and the tuples it ran.  `half`
        plants a fault: each step on the first half of its tuples."""
        tuples = list(range(self.B // 2 if half else self.B))
        rows = ref_gt.tuple_rows(self.B, self.P, self.Nn, tuples)
        steps = [clouds[rows] for clouds in self.ref_inputs]
        r = ref_gt.train(self.cfg, self.weights, steps, batch=len(tuples))
        return {"losses": r["losses"], "descs": r["descs"],
                "grad0": r["grad0"], "tuples": tuples,
                "after": {**r["params"], **r["stats"], **r["frozen"]}}

    def choice_gap(self, side: dict, ref: dict) -> float:
        """Over every step: where `side`'s descriptors choose another best
        positive or hardest negative (either hinge) than the reference's,
        the reference's best term less its term at `side`'s choice."""
        rows = ref_gt.tuple_rows(self.B, self.P, self.Nn, side["tuples"])
        b = len(side["tuples"])
        gap = 0.0
        for mine, theirs in zip(side["descs"], ref["descs"]):
            p = ref_gt.terms(self.cfg, mine, b)
            r = ref_gt.terms(self.cfg, theirs[rows], b)
            at = torch.gather(r["pos_d"], 1,
                              torch.argmin(p["pos_d"], 1, keepdim=True))
            gaps = [at[:, 0] - r["pos_d"].amin(1)]
            for h in ("hinge1", "hinge2"):
                at = torch.gather(r[h], 1, torch.argmax(p[h], 1, keepdim=True))
                gaps.append(r[h].amax(1) - at[:, 0])
            g = float(torch.cat(gaps).max())
            gap = common.worst(gap, g)
        return gap

    def compare(self, prog: dict) -> list:
        r = self.reference_side()
        lim = {k: v["limit"] for k, v in self.limits.items()}
        rows = ref_gt.tuple_rows(self.B, self.P, self.Nn, prog["tuples"])
        loss_gap = abs(prog["losses"][0] - r["losses"][0]) \
            / abs(r["losses"][0])
        desc_gap = common.max_gap(prog["descs"][0], r["descs"][0][rows])
        grad_gap = ref_train.median_gap(prog["grad0"], r["grad0"])
        gnorm = {n: float(torch.linalg.vector_norm(g))
                 for n, g in r["grad0"].items()}
        med = float(np.median(list(gnorm.values())))
        moving = {n for n, v in gnorm.items() if v >= 1e-3 * med}
        frozen = ref_gt.frozen_groups(self.cfg)
        stats = [n for n in r["after"] if ref_model.is_statistic(n)
                 and not ref_gt.is_frozen(n, frozen)]
        w = self.weights

        def change(side, names):
            return {n: side["after"][n] - w[n] for n in names}

        change_gap = ref_train.median_gap(change(prog, moving),
                                          change(r, moving))
        stat_gap, _ = ref_train.norm_gaps(change(prog, stats),
                                          change(r, stats))
        frozen_changed = 0.0
        for n in w:
            if ref_gt.is_frozen(n, frozen):
                frozen_changed = common.worst(
                    frozen_changed, common.max_gap(prog["after"][n], w[n]))
        return [("first_loss_gap", loss_gap, lim["first_loss_gap"]),
                ("global_desc_gap", desc_gap, lim["global_desc_gap"]),
                ("grad_median_gap", grad_gap, lim["grad_median_gap"]),
                ("change_median_gap", change_gap, lim["change_median_gap"]),
                ("bn_stat_gap", stat_gap, lim["bn_stat_gap"]),
                ("frozen_changed", frozen_changed, lim["frozen_changed"]),
                ("choice_gap", self.choice_gap(prog, r), lim["choice_gap"])]

    def check(self) -> list:
        return self.compare({"losses": self.losses, "descs": self.descs,
                             "grad0": self.grad0, "after": self.after,
                             "tuples": list(range(self.B))})

    def control(self) -> list:
        """The reference in TF32 in the program's place."""
        with common.tf32():
            ctrl = self.reference_side()
        return self.compare(ctrl)

    def fault_half(self) -> list:
        """A planted fault: the reference, in the program's place, takes
        each step on the first half of its tuples (the loss's mean and
        the head's batch statistics over those alone)."""
        return self.compare(self.reference_side(half=True))
