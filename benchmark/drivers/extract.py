"""Batched extraction: the eval forward over batches of distinct scans,
closed loop, back to back (map building, offline extraction).

Traffic parameters: batch (clouds a batch), pool (scans made in set-up,
of the configuration's num_points), scan_extent (metres), calibrate (scans
the BatchNorm statistics are taken on), schedule (batches drawn ahead),
check_batches and sample_from (how many of the window's batches the
reference checks, drawn from the seed among the first sample_from),
profile_units (batches in the traced window).

The program: `train.make_eval_step` of the configuration's model, the
Z-order sort in the step.  Checked: the local descriptors, the attention
and the global descriptor of the sampled batches, each the largest
absolute gap to the plain reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts
from benchmark.drivers import common
from benchmark.harness import stamp, sub_seed
from benchmark.reference import model as ref
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights

OUTPUTS = ("local_desc", "attention", "global_desc")


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        from dh3d_tpu_torch.train import make_eval_step

        t = cell["traffic"]
        self.limits = cell["limits"]
        self.cfg = common.port_cfg(cell["cfg"])
        self.device = device
        self.B, self.N = t["batch"], self.cfg.num_points
        self.profile_units = t["profile_units"]
        gen = common.generator(device, seed, "scans")
        self.pool = scans(t["pool"], self.N, gen, t["scan_extent"])
        stamp("scans made")
        w = make_weights(self.cfg, sub_seed(seed, "weights"), device)
        self.weights = calibrate(self.cfg, w, self.pool[:t["calibrate"]])
        stamp("weights made and calibrated")
        self.step = make_eval_step(self.cfg, common.port_model(
            self.cfg, self.weights, device))
        self.schedule = torch.argsort(torch.rand(
            t["schedule"], t["pool"], generator=gen, device=device),
            dim=1)[:, :self.B]
        rng = np.random.RandomState(sub_seed(seed, "check") % 2 ** 32)
        self.keep = set(rng.choice(t["sample_from"], t["check_batches"],
                                   replace=False).tolist())
        self.kept = {}
        for i in range(2):  # warm-up: every shape of the window
            self.batch(i)
        common.sync(device)
        stamp("warmed up")

    def batch(self, i: int):
        return self.step({"points": self.pool[
            self.schedule[i % len(self.schedule)]]})

    def window(self, seconds: float) -> dict:
        def one(i):
            outs = self.batch(i)
            if i in self.keep:
                self.kept[i] = {k: outs[k] for k in OUTPUTS}

        n, s = common.window_loop(seconds, one, self.device)
        return {"attempted": n * self.B, "failed": 0, "units": n,
                "seconds": s, "values": {"clouds_per_s": n * self.B / s}}

    def unit(self):
        self.batch(0)

    def counts(self) -> dict:
        return {"flops_per_unit": counts.model_flops(self.cfg, self.B,
                                                     self.N),
                "bound_s_per_unit": counts.forward_bound_s(self.cfg, self.B,
                                                           self.N)}

    def spans(self) -> dict:
        return {}

    def release(self):
        del self.step
        common.free(self.device)

    def reference_side(self, positions) -> dict:
        """{i: the plain reference's outputs of batch i}."""
        out = {}
        for i in positions:
            pts = self.pool[self.schedule[i % len(self.schedule)]]
            with torch.no_grad():
                r, _ = ref.forward(self.cfg, self.weights, pts)
            out[i] = {k: r[k] for k in OUTPUTS}
        return out

    def compare(self, prog: dict) -> list:
        """The largest gap of each output over the batches of `prog` ({i:
        outputs}) to the reference's."""
        gaps = {k: 0.0 if prog else float("inf") for k in OUTPUTS}
        for i, r in self.reference_side(sorted(prog)).items():
            for k in OUTPUTS:
                gaps[k] = common.worst(gaps[k], common.max_gap(prog[i][k],
                                                               r[k]))
        return [(f"{k}_gap", gaps[k], self.limits[f"{k}_gap"]["limit"])
                for k in OUTPUTS]

    def check(self) -> list:
        return self.compare(self.kept)

    def control(self) -> list:
        """The reference in TF32 in the program's place."""
        with common.tf32():
            ctrl = self.reference_side(sorted(self.keep))
        return self.compare(ctrl)
