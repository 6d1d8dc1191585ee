"""Local-descriptor extraction from raw scans on disk, through the
extraction CLI's library path, closed loop (users who extract keypoints
and descriptors from their own scans).

Traffic parameters: scans (raw scans written in set-up), raw_points
(points a raw scan), scan_extent, points (the CLI's N), nms ({radius,
min_ratio, max_kp}: the CLI's defaults), calibrate, check_clouds and
sample_from (the written clouds the reference checks, drawn from the seed
among the first sample_from files), profile_units (clouds in the traced
window).

Set-up writes the scans as flat float32 `.bin` files, the layout
`evaluate/localdesc_extract.py` reads, into a directory of its own under
$TMPDIR, removed at the end.  The window runs `eval.extract.extract_local`
at batch 1 with NMS over `data.LocalTestDataset` (voxel grid, outlier
removal, N points nearest the centroid), pass after pass over the files,
until the window's time is up; keypoint rows go to the same directory.
The benchmark's span `load` times each cloud's load and normalisation on
the host.

Checked against the plain reference, which normalises the sampled files
again (replaying the loader's random draws over the files before them),
runs its forward and NMS: the normalised cloud (largest gap), the share of
written rows whose point differs, and the largest gaps of the descriptor
and attention columns of the rows both wrote.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.harness import stamp, sub_seed
from benchmark.reference import eval as ref_eval
from benchmark.reference import model as ref
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        t = self.t = cell["traffic"]
        self.limits = cell["limits"]
        cfg = common.port_cfg(cell["cfg"])
        cfg.num_points = t["points"]  # the CLI's settings
        cfg.sampled_kpnum = -1
        cfg.input_R = False
        cfg.morton_presorted = False  # eval clouds come unsorted
        self.cfg = cfg
        self.device = device
        self.profile_units = t["profile_units"]
        self.spans_ = {"load": []}
        gen = common.generator(device, seed, "scans")
        raw = scans(t["scans"], t["raw_points"], gen, t["scan_extent"])
        self.dir = tempfile.mkdtemp(prefix="dh3d_raw_",
                                    dir=os.environ.get("TMPDIR"))
        self.scan_dir = os.path.join(self.dir, "scans")
        self.out_dir = os.path.join(self.dir, "rows")
        os.makedirs(self.scan_dir)
        host = raw.cpu().numpy()
        self.names = [f"{i:05d}.bin" for i in range(len(host))]
        for name, cloud in zip(self.names, host):
            cloud.tofile(os.path.join(self.scan_dir, name))
        stamp("raw scans written")
        w = make_weights(cfg, sub_seed(seed, "weights"), device)
        calib = torch.stack([torch.from_numpy(ref_eval.normalise(
            c, t["points"], np.random.RandomState(0))[0])
            for c in host[:t["calibrate"]]]).to(device)
        self.weights = calibrate(cfg, w, calib)
        stamp("weights made and calibrated")
        self.model = common.port_model(cfg, self.weights, device)
        rng = np.random.RandomState(sub_seed(seed, "check") % 2 ** 32)
        self.keep = sorted(rng.choice(min(t["sample_from"], len(self.names)),
                                      t["check_clouds"], replace=False)
                           .tolist())
        self.kept_clouds = {}
        self.extract(float("inf"), limit=1)  # warm-up: one cloud, every shape
        common.sync(device)
        self.spans_["load"].clear()
        stamp("warmed up")

    def dataset(self, deadline: float, limit=None):
        """The CLI's dataset over the files, one pass, its items timed
        (span `load`) and kept for the check; stops yielding at
        `deadline` (host clock) or after `limit` items."""
        from dh3d_tpu_torch.data import LocalTestDataset

        ds = LocalTestDataset(self.scan_dir, numpts=self.t["points"],
                              knn_require=0, dim=3)
        it = iter(ds)
        for j in range(len(self.names)):
            if time.perf_counter() >= deadline or j == limit:
                return
            t0 = time.perf_counter()
            with torch.profiler.record_function("span:load"):
                item = next(it)
            self.spans_["load"].append((time.perf_counter() - t0) * 1e3)
            if j in self.keep and j not in self.kept_clouds:
                self.kept_clouds[j] = np.array(item[0])
            yield item

    def extract(self, deadline: float, limit=None) -> int:
        from dh3d_tpu_torch.eval.extract import extract_local

        n = self.t["nms"]
        return extract_local(
            self.cfg, self.model, self.dataset(deadline, limit),
            self.out_dir, batch_size=1, perform_nms=True,
            nms_rad=n["radius"], nms_min_ratio=n["min_ratio"],
            nms_max_kp=n["max_kp"])

    def window(self, seconds: float) -> dict:
        common.sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while time.perf_counter() < deadline:
            n += self.extract(deadline)
        common.sync(self.device)
        s = time.perf_counter() - t0
        return {"attempted": n, "failed": 0, "units": n, "seconds": s,
                "values": {"clouds_per_s": n / s}}

    def unit(self):
        self.extract(time.perf_counter() + 3600, limit=1)

    def counts(self) -> dict:
        return {}

    def spans(self) -> dict:
        return dict(self.spans_)

    def release(self):
        del self.model
        common.free(self.device)

    def rows(self, j: int) -> np.ndarray:
        """The keypoint rows the program wrote for file j."""
        stem = os.path.splitext(self.names[j])[0]
        return np.fromfile(os.path.join(self.out_dir, f"{stem}_nms_res.bin"),
                           np.float32).reshape(-1, 3 + 128 + 1)

    def reference_side(self, positions, acc=np.float64) -> dict:
        """{j: {"cloud", "rows"}} of the plain reference for files j: the
        loader's random draws replayed over the files before them; `acc`
        the voxel grid's accumulator."""
        t, n = self.t, self.t["nms"]
        rng = np.random.RandomState(0)  # the loader's seed
        out, done = {}, 0
        for j in sorted(positions):
            while done <= j:
                raw = np.fromfile(os.path.join(self.scan_dir,
                                               self.names[done]),
                                  np.float32).reshape(-1, 3)
                cloud, num = ref_eval.normalise(raw, t["points"], rng, acc)
                done += 1
            pts = torch.from_numpy(cloud).to(self.device)
            with torch.no_grad():
                r, _ = ref.forward(self.cfg, self.weights, pts[None])
            kp = ref_eval.nms(pts[:num], 1 - r["attention"][0, :num, 0],
                              n["radius"], n["min_ratio"], n["max_kp"])
            rows = torch.cat([r["xyz"], r["local_desc"], r["attention"]],
                             -1)[0, :num][kp].cpu().numpy()
            out[j] = {"cloud": cloud, "rows": rows}
            del r
        return out

    def compare(self, prog: dict) -> list:
        lim = {k: v["limit"] for k, v in self.limits.items()}
        cloud_gap = 0.0 if prog else float("inf")
        row_d = desc_gap = att_gap = 0.0
        for j, r in self.reference_side(sorted(prog)).items():
            p = prog[j]
            cloud_gap = common.worst(cloud_gap, float(np.max(np.abs(
                p["cloud"] - r["cloud"]))))
            at_ref = {tuple(x): i for i, x in enumerate(r["rows"][:, :3])}
            both = [(i, at_ref[tuple(x)])
                    for i, x in enumerate(p["rows"][:, :3])
                    if tuple(x) in at_ref]
            row_d = common.worst(row_d, 1 - len(both) / max(
                len(p["rows"]), len(r["rows"]), 1))
            if both:
                pi, ri = map(list, zip(*both))
                desc_gap = common.worst(desc_gap, float(np.max(np.abs(
                    p["rows"][pi, 3:-1] - r["rows"][ri, 3:-1]))))
                att_gap = common.worst(att_gap, float(np.max(np.abs(
                    p["rows"][pi, -1] - r["rows"][ri, -1]))))
        return [("cloud_gap", cloud_gap, lim["cloud_gap"]),
                ("rows_differ", row_d, lim["rows_differ"]),
                ("desc_gap", desc_gap, lim["desc_gap"]),
                ("attention_gap", att_gap, lim["attention_gap"])]

    def check(self) -> list:
        try:
            return self.compare({j: {"cloud": c, "rows": self.rows(j)}
                                 for j, c in self.kept_clouds.items()})
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def control(self) -> list:
        """The reference one precision below the configuration's in the
        program's place: the voxel grid summed in float32 (float64 in the
        loader), the forward in TF32."""
        try:
            with common.tf32():
                ctrl = self.reference_side(self.keep, acc=np.float32)
            return self.compare(ctrl)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
