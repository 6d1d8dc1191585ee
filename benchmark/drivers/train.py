"""Training steps: the stage-2 step on fresh pairs of scans, closed loop.

Traffic parameters: pool (scans made in set-up), scan_extent, calibrate,
schedule, ref_steps (the first steps, which the reference follows),
profile_units (steps in the traced window).  The pairs a step takes
are the configuration's batch_size.

Set-up makes the pool on the card, two jittered copies of each scan (the
loader's Jitter: N(0, 0.05) clipped at 0.1), and sorts every copy along
the Z-order curve on the host with the program's loader function
(`data.io.morton_sort_np`), as its training loader does under
`morton_presorted`.  Each step then takes batch_size distinct pairs and
hands the step the draws of its pair generation (the angles, the random
half of each cloud the anchors are sampled from), made by the benchmark on
the card, so that the reference gets the same; the step builds the pairs,
runs the forward, the losses, the backward and Adam.

The program's state is built once; its first `ref_steps` steps, on pairs
that all differ, are the reference's.  Compared: the first step's loss
(relative); then gaps of norms, leaf by leaf, over the reference's norm
or the median leaf's, the larger: the first gradient as Adam holds it
(its first moment after one step over 1 - b1), by the median leaf; the
change of every parameter after the last step, by the median leaf,
leaving out the leaves whose reference gradient is under a thousandth of
the median leaf's (the biases feeding a BatchNorm on batch statistics,
whose gradient is nought to rounding); the change of every BatchNorm
statistic, by the worst leaf.  The later steps' losses and the worst
leaf's gradient and change are not compared: f32 rounding alone moves
them on some seeds (a detection-loss choice flipped, an ill-conditioned
leaf such as the squeeze-excite's first Dense; PERF.md section 2).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts
from benchmark.drivers import common
from benchmark.harness import stamp, sub_seed
from benchmark.reference import train as ref_train
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights

B1 = 0.9  # Adam's first-moment decay, to read the first gradient back


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        from dh3d_tpu_torch.data.io import morton_sort_np
        from dh3d_tpu_torch.train import (TrainState, make_optimizer,
                                          make_train_step)

        t = cell["traffic"]
        self.limits = cell["limits"]
        self.cfg = cfg = common.port_cfg(cell["cfg"])
        self.device = device
        self.B, self.N = cfg.batch_size, cfg.num_points
        self.profile_units = t["profile_units"]
        gen = common.generator(device, seed, "scans")
        clouds = scans(t["pool"], self.N, gen, t["scan_extent"])
        noise = torch.randn(2, *clouds.shape, generator=gen, device=device)
        self.raw = clouds[None] + torch.clamp(0.05 * noise, -0.1, 0.1)
        self.sorted = torch.from_numpy(morton_sort_np(
            self.raw.reshape(-1, self.N, 3).cpu().numpy())).to(
                device).reshape(self.raw.shape)
        stamp("scans made and sorted")
        w = make_weights(cfg, sub_seed(seed, "weights"), device)
        self.weights = calibrate(cfg, w, self.sorted[0, :t["calibrate"]])
        stamp("weights made and calibrated")
        model = common.port_model(cfg, self.weights, device)
        self.state = TrainState(model, make_optimizer(cfg, model))
        self.step_fn = make_train_step(cfg)
        self.draws = common.generator(device, seed, "draws")
        first = torch.randperm(t["pool"], generator=gen, device=device)
        n_ref = t["ref_steps"]
        self.schedule = torch.argsort(torch.rand(
            t["schedule"], t["pool"], generator=gen, device=device),
            dim=1)[:, :self.B]
        self.schedule[:n_ref] = first[:n_ref * self.B].reshape(n_ref, -1)

        # the first steps, which the reference follows (and which warm up
        # every shape of the window)
        self.ref_inputs, losses = [], []
        names = [n for n, _ in model.named_parameters()]
        for s in range(n_ref):
            batch = self.batch(s)
            self.ref_inputs.append({
                "pc1": self.raw[0, self.schedule[s]],
                "pc2": self.raw[1, self.schedule[s]],
                "angles": batch["pairgen_draws"][0],
                "subsets": batch["pairgen_draws"][1]})
            losses.append(self.step_fn(self.state, batch)["total_cost"])
            if s == 0:
                opt = self.state.optimizer
                params = dict(model.named_parameters())
                self.grad0 = {  # none when the step took no update
                    n: opt.state[params[n]].get(
                        "exp_avg", torch.zeros_like(params[n])) / (1 - B1)
                    for n in names}
        self.losses = [float(v) for v in losses]
        stamp("the reference's steps run (warmed up)")
        self.i = n_ref
        self.after = {n: v.detach().clone()
                      for n, v in model.state_dict().items()}
        common.sync(device)

    def batch(self, i: int) -> dict:
        idx = self.schedule[i % len(self.schedule)]
        g, dev = self.draws, self.device
        angles = (torch.rand(self.B, generator=g, device=dev) * 2 - 1) \
            * self.cfg.rot_maxv
        subsets = torch.argsort(torch.rand(self.B, self.N, generator=g,
                                           device=dev), dim=1)[:, :self.N // 2]
        return {"pc1": self.sorted[0, idx], "pc2": self.sorted[1, idx],
                "pairgen_draws": (angles, subsets)}

    def unit(self):
        self.step_fn(self.state, self.batch(self.i))
        self.i += 1

    def window(self, seconds: float) -> dict:
        n, s = common.window_loop(seconds, lambda _: self.unit(), self.device)
        return {"attempted": n * 2 * self.B, "failed": 0, "units": n,
                "seconds": s, "values": {"clouds_per_s": n * 2 * self.B / s}}

    def counts(self) -> dict:
        return {"flops_per_unit": counts.train_flops(self.cfg, self.B,
                                                     self.N),
                "bound_s_per_unit": counts.train_bound_s(self.cfg, self.B,
                                                         self.N)}

    def spans(self) -> dict:
        return {}

    def release(self):
        del self.state, self.step_fn
        common.free(self.device)

    def reference_side(self, half: bool = False) -> dict:
        """The plain reference's first steps: losses, grad0 and the state
        after them ({leaf: tensor}, parameters and statistics).  `half`
        plants a fault: each step on the first half of its pairs."""
        steps = self.ref_inputs
        if half:
            h = self.B // 2
            steps = [{k: v[:h] for k, v in s.items()} for s in steps]
        r = ref_train.train(self.cfg, self.weights, steps)
        return {"losses": r["losses"], "grad0": r["grad0"],
                "after": {**r["params"], **r["stats"]}}

    def compare(self, prog: dict) -> list:
        r = self.reference_side()
        lim = {k: v["limit"] for k, v in self.limits.items()}
        loss_gap = abs(prog["losses"][0] - r["losses"][0]) \
            / abs(r["losses"][0])
        grad_gap = ref_train.median_gap(prog["grad0"], r["grad0"])
        gnorm = {n: float(torch.linalg.vector_norm(g))
                 for n, g in r["grad0"].items()}
        med = float(np.median(list(gnorm.values())))
        moving = {n for n, v in gnorm.items() if v >= 1e-3 * med}
        stats = [n for n in r["after"] if n not in r["grad0"]]
        w = self.weights

        def change(side, names):
            return {n: side["after"][n] - w[n] for n in names}

        change_gap = ref_train.median_gap(change(prog, moving),
                                          change(r, moving))
        stat_gap, _ = ref_train.norm_gaps(change(prog, stats),
                                          change(r, stats))
        return [("first_loss_gap", loss_gap, lim["first_loss_gap"]),
                ("grad_median_gap", grad_gap, lim["grad_median_gap"]),
                ("change_median_gap", change_gap, lim["change_median_gap"]),
                ("bn_stat_gap", stat_gap, lim["bn_stat_gap"])]

    def check(self) -> list:
        return self.compare({"losses": self.losses, "grad0": self.grad0,
                             "after": self.after})

    def control(self) -> list:
        """The reference in TF32 in the program's place."""
        with common.tf32():
            ctrl = self.reference_side()
        return self.compare(ctrl)

    def fault_half(self) -> list:
        """A planted fault: the reference, in the program's place, takes
        each step on the first half of its pairs (the loss's mean over
        the rest)."""
        return self.compare(self.reference_side(half=True))

