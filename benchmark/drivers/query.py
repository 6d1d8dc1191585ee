"""Relocalisation queries: one client, one query at a time, closed loop
(one vehicle relocalising scan after scan against a map).

Traffic parameters: map (submaps), places (map places the queries
re-observe), map_batch (clouds a batch while the map is built),
scan_extent, jitter_m, yaw_deg and shift_m (a query's sensor noise on its
place's points, its largest yaw and shift against the place), nms ({radius, min_ratio, max_kp}), ransac_iters,
inlier_m, calibrate, check_queries and sample_from (how many of the
window's queries the reference checks, drawn from the seed among the
first sample_from), profile_units (queries in the traced window).

Set-up builds the map with the program: a batched forward of every
submap, its global descriptor and its NMS keypoints with their local
descriptors, kept on the card (the global descriptors also on the host,
where retrieval runs).  A query is a map place measured again: its points
with fresh sensor noise, turned by a yaw and shifted.  (A new draw of the
place's points would leave the weights drawn from the seed, which are not
trained, no matches to register: most queries would find no pose.)  It runs, as the relocalisation CLI does:
the batch-1 forward, NMS on the inverted attention, top-1 retrieval by
global descriptor (`eval.retrieval.retrieve`), mutual matching against
the retrieved submap's keypoints and RANSAC (`eval.registration`); its
latency runs from the hand-off of the cloud to the pose on the host.

Checked against the plain reference, which builds the map again itself:
the query forward's outputs (largest gaps), the share of sampled queries
retrieving another submap, the worst share of keypoints and of matches
that differ, and the worst gap of the poses (degrees, metres).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import timing
from benchmark.drivers import common
from benchmark.harness import stamp, sub_seed
from benchmark.reference import eval as ref_eval
from benchmark.reference import model as ref
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights

OUTPUTS = ("local_desc", "attention", "global_desc")


def _turn(clouds, yaw, shift):
    """Rotate clouds [Q, N, 3] about z by yaw [Q] (radians) and add
    shift [Q, 3]."""
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    x, y, z = clouds.unbind(-1)
    return torch.stack([c * x - s * y, s * x + c * y, z], -1) \
        + shift[:, None, :]


def share_differ(a, b) -> float:
    """1 - |a & b| / max(|a|, |b|) of two sets (0 for two empty ones)."""
    a, b = set(a), set(b)
    n = max(len(a), len(b))
    return 0.0 if n == 0 else 1.0 - len(a & b) / n


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        from dh3d_tpu_torch.eval.extract import make_forward

        t = self.t = cell["traffic"]
        self.limits = cell["limits"]
        self.cfg = common.port_cfg(cell["cfg"])
        self.device = device
        self.N = self.cfg.num_points
        self.profile_units = t["profile_units"]
        self.spans_ = timing.Spans(on=trace)
        gen = common.generator(device, seed, "scans")
        self.map = scans(t["map"], self.N, gen, t["scan_extent"])
        place = torch.randperm(t["map"], generator=gen,
                               device=device)[:t["places"]]
        again = self.map[place] + t["jitter_m"] * torch.randn(
            t["places"], self.N, 3, generator=gen, device=device)
        yaw = (torch.rand(t["places"], generator=gen, device=device) * 2 - 1) \
            * np.radians(t["yaw_deg"])
        shift = (torch.rand(t["places"], 3, generator=gen, device=device)
                 * 2 - 1) * t["shift_m"]
        shift[:, 2] = 0
        self.queries = _turn(again, yaw, shift)
        stamp("map and queries made")
        w = make_weights(self.cfg, sub_seed(seed, "weights"), device)
        self.weights = calibrate(self.cfg, w, self.map[:t["calibrate"]])
        self.fwd = make_forward(self.cfg, common.port_model(
            self.cfg, self.weights, device))
        rng = np.random.RandomState(sub_seed(seed, "queries") % 2 ** 32)
        self.order = np.concatenate([rng.permutation(t["places"])
                                     for _ in range(64)])
        self.ransac_seeds = rng.randint(0, 2 ** 31, len(self.order))
        self.keep = set(rng.choice(t["sample_from"], t["check_queries"],
                                   replace=False).tolist())
        stamp("weights made and calibrated")
        self.build_map()
        stamp("map built")
        self.kept, self.answers = {}, []
        for i in range(2):  # warm-up: every shape and library of a query
            self.query(i)
        common.sync(device)
        self.answers.clear()
        self.kept.clear()
        stamp("warmed up")

    def keypoints(self, xyz, outs, b):
        """(indices, keypoint xyz, descriptors) of cloud b of a forward:
        NMS on the inverted attention, as the relocalisation CLI runs it."""
        from dh3d_tpu_torch.eval.nms import nms_keypoint_indices

        n = self.t["nms"]
        att = 1 - outs["attention"][b, :, 0]
        idx = nms_keypoint_indices(
            xyz, att, nms_radius=n["radius"],
            min_response_ratio=n["min_ratio"], max_keypoints=n["max_kp"],
            device=self.device)
        ids = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        return idx, xyz[ids], outs["local_desc"][b][ids]

    def build_map(self):
        gd, self.map_idx, self.map_kp, self.map_desc = [], [], [], []
        mb = self.t["map_batch"]
        for s in range(0, len(self.map), mb):
            outs = self.fwd(self.map[s:s + mb])
            gd.append(outs["global_desc"])
            for b in range(outs["global_desc"].shape[0]):
                idx, kp, desc = self.keypoints(self.map[s + b], outs, b)
                self.map_idx.append(np.asarray(idx, np.int64))
                self.map_kp.append(kp)
                self.map_desc.append(desc)
        self.map_gd = torch.cat(gd).cpu().numpy()

    def query(self, i: int) -> float:
        """Run query i; returns its latency in ms."""
        from dh3d_tpu_torch.eval.registration import (match_descriptors_mutual,
                                                      ransac_rigid)
        from dh3d_tpu_torch.eval.retrieval import retrieve

        q = int(self.order[i % len(self.order)])
        cloud = self.queries[q]
        sp = self.spans_
        t0 = time.perf_counter()
        with sp.span("forward"):
            outs = self.fwd(cloud[None])
        with sp.span("nms"):
            idx, kp, desc = self.keypoints(cloud, outs, 0)
        with sp.span("register"):
            gd = outs["global_desc"].cpu().numpy()
            top1 = int(retrieve(self.map_gd, gd, 1)[0, 0])
            m = match_descriptors_mutual(self.map_desc[top1], desc,
                                         device=self.device)
            res = None
            if len(m) >= 3:
                res = ransac_rigid(self.map_kp[top1][m[:, 0]], kp[m[:, 1]],
                                   inlier_thresh=self.t["inlier_m"],
                                   iters=self.t["ransac_iters"],
                                   seed=int(self.ransac_seeds[i]),
                                   device=self.device)
            pose = None if res is None else (res.R, res.t)
        ms = (time.perf_counter() - t0) * 1e3
        self.answers.append({"q": q, "top1": top1, "pose": pose})
        if i in self.keep:  # matches as pairs of point ids (map, query)
            m = m.cpu().numpy()
            pairs = np.stack([self.map_idx[top1][m[:, 0]],
                              np.asarray(idx, np.int64)[m[:, 1]]], 1)
            self.kept[i] = {"outs": {k: outs[k] for k in OUTPUTS},
                            "kp": list(idx), "top1": top1,
                            "map_kp": self.map_idx[top1].tolist(),
                            "matches": pairs, "pose": pose}
        return ms

    def window(self, seconds: float) -> dict:
        self.ms = []
        n, s = common.window_loop(
            seconds, lambda i: self.ms.append(self.query(i)), self.device)
        failed = sum(a["pose"] is None for a in self.answers)
        return {"attempted": n, "failed": failed, "units": n, "seconds": s,
                "values": {"ms_p95": timing.percentile(self.ms, 95)}}

    def unit(self):
        self.query(len(self.answers))

    def counts(self) -> dict:
        return {}

    def spans(self) -> dict:
        return self.spans_.ms()

    def release(self):
        del self.fwd
        common.free(self.device)

    def map_descriptors(self) -> np.ndarray:
        """The plain reference's global descriptors of the map [M, 256]."""
        gd, mb = [], self.t["map_batch"]
        with torch.no_grad():
            for s in range(0, len(self.map), mb):
                r, _ = ref.forward(self.cfg, self.weights,
                                   self.map[s:s + mb])
                gd.append(r["global_desc"].cpu().numpy())
                del r
        return np.concatenate(gd)

    def keypoints_ref(self, cloud):
        """(the reference's forward outputs of one cloud, its NMS
        keypoints)."""
        n = self.t["nms"]
        with torch.no_grad():
            r, _ = ref.forward(self.cfg, self.weights, cloud[None])
        kp = ref_eval.nms(cloud, 1 - r["attention"][0, :, 0], n["radius"],
                          n["min_ratio"], n["max_kp"])
        return r, kp

    def low_answers(self, positions) -> tuple:
        """The control: the plain pipeline one precision below the
        configuration's in the program's place (the forwards in TF32,
        matching and RANSAC in float32 instead of float64).  Returns (its
        answers {i: answer}, its map descriptors)."""
        t = self.t
        with common.tf32():
            map_gd = self.map_descriptors()
            out = {}
            for i in positions:
                cloud = self.queries[int(self.order[i % len(self.order)])]
                r, kq = self.keypoints_ref(cloud)
                top1 = ref_eval.retrieve_top1(
                    map_gd, r["global_desc"][0].cpu().numpy(), np.float32)
                rm, km = self.keypoints_ref(self.map[top1])
                mm = ref_eval.mutual_matches(
                    rm["local_desc"][0][km].cpu().numpy(),
                    r["local_desc"][0][kq].cpu().numpy(), np.float32)
                pairs = np.asarray([(km[x], kq[y]) for x, y in mm.tolist()],
                                   np.int64).reshape(-1, 2)
                out[i] = {"outs": {k: r[k] for k in OUTPUTS}, "kp": kq,
                          "top1": top1, "map_kp": km, "matches": pairs,
                          "pose": self.ransac(i, top1, pairs, np.float32)}
                del r, rm
        return out, map_gd

    def ransac(self, i, top1, pairs, dtype=np.float64):
        """The reference's RANSAC over matched point ids (map, query) with
        query i's draws."""
        if len(pairs) < 3:
            return None
        cloud = self.queries[int(self.order[i % len(self.order)])]
        p_m = self.map[top1].cpu().numpy()[pairs[:, 0]]
        p_q = cloud.cpu().numpy()[pairs[:, 1]]
        return ref_eval.ransac(p_m, p_q, self.t["inlier_m"],
                               self.t["ransac_iters"],
                               int(self.ransac_seeds[i]), dtype=dtype)

    def compare(self, prog: dict, prog_map_gd: np.ndarray) -> list:
        """Each stage of the answers `prog` ({i: answer}) against the plain
        reference's stage on the same input: the forward on the query;
        the map's global descriptors; retrieval, as the gap between the
        distance to the submap `prog` retrieved and the reference's
        nearest; NMS (the keypoints of the query and of the retrieved
        submap); matching, the reference's mutual matching of its own
        descriptors at `prog`'s keypoints; RANSAC, the reference's on
        `prog`'s matches with the same draws (float64)."""
        lim = {k: v["limit"] for k, v in self.limits.items()}
        gaps = {k: 0.0 if prog else float("inf") for k in OUTPUTS}
        map_gd = self.map_descriptors()
        nums = dict.fromkeys(("retrieval_gap", "keypoints_differ",
                              "matches_differ", "pose_rotation_gap",
                              "pose_translation_gap_m"), 0.0)
        nums["map_global_gap"] = float(np.max(np.abs(
            prog_map_gd.astype(np.float64) - map_gd)))
        worst = common.worst
        for i, p in sorted(prog.items()):
            cloud = self.queries[int(self.order[i % len(self.order)])]
            r, kq = self.keypoints_ref(cloud)
            for k in OUTPUTS:
                gaps[k] = worst(gaps[k], common.max_gap(p["outs"][k], r[k]))
            q_p = p["outs"]["global_desc"][0].cpu().numpy().astype(np.float64)
            q_r = r["global_desc"][0].cpu().numpy().astype(np.float64)
            d_p = np.linalg.norm(prog_map_gd[p["top1"]].astype(np.float64)
                                 - q_p)
            d_r = np.min(np.linalg.norm(map_gd - q_r, axis=1))
            nums["retrieval_gap"] = worst(nums["retrieval_gap"],
                                          float(abs(d_p - d_r)))
            rm, km = self.keypoints_ref(self.map[p["top1"]])
            nums["keypoints_differ"] = worst(nums["keypoints_differ"], max(
                share_differ(p["kp"], kq), share_differ(p["map_kp"], km)))
            mm = ref_eval.mutual_matches(
                rm["local_desc"][0][p["map_kp"]].cpu().numpy(),
                r["local_desc"][0][p["kp"]].cpu().numpy())
            ref_pairs = [(p["map_kp"][x], p["kp"][y]) for x, y in mm.tolist()]
            nums["matches_differ"] = worst(nums["matches_differ"], share_differ(
                map(tuple, np.asarray(p["matches"]).tolist()), ref_pairs))
            pose = self.ransac(i, p["top1"], np.asarray(p["matches"]))
            if (pose is None) != (p["pose"] is None):
                nums["pose_rotation_gap"] = nums["pose_translation_gap_m"] \
                    = float("inf")
            elif pose is not None:
                R, t = (np.asarray(x, np.float64) for x in p["pose"])
                nums["pose_rotation_gap"] = worst(
                    nums["pose_rotation_gap"],
                    float(np.linalg.norm(R - pose[0])))
                nums["pose_translation_gap_m"] = worst(
                    nums["pose_translation_gap_m"],
                    float(np.linalg.norm(t - pose[1])))
            del r, rm
        checks = [(f"{k}_gap", gaps[k], lim[f"{k}_gap"]) for k in OUTPUTS]
        return checks + [(k, v, lim[k]) for k, v in nums.items()]

    def check(self) -> list:
        return self.compare(self.kept, self.map_gd)

    def control(self) -> list:
        return self.compare(*self.low_answers(sorted(self.keep)))
