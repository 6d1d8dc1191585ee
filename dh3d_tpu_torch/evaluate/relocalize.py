"""6DoF relocalisation CLI of the port: the counterpart of the repository's
`evaluate/relocalize.py` (BASELINE.json config 5).  For each query cloud:
(1) retrieve the nearest database cloud by global descriptor; (2) extract
NMS keypoints and local descriptors of both; (3) mutual-NN matching and a
RANSAC rigid fit.

    python -m dh3d_tpu_torch.evaluate.relocalize \
        --local_model models/demo_stage2 --global_model models/demo_stage3 \
        --db_gt DB.pickle --query_gt QUERY.pickle --pcdpath DIR \
        [--num_points 4096] [--max_queries 10] [--nms_max_kp 256] \
        [--nms_backend device|host] [--ransac_iters 500] [--device cuda]

Both models stay on the device; the clouds come from `GlobalTestDataset`
at --num_points, one at a time; retrieval is scored against the GT
pickles' positions (a top-1 within 25 m), registration by its inliers
(>= 10).  --device defaults to cuda and exits with an error when there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from dh3d_tpu_torch import trace
from dh3d_tpu_torch.data import GlobalTestDataset
from dh3d_tpu_torch.data.io import get_sets_dict
from dh3d_tpu_torch.eval.extract import make_forward
from dh3d_tpu_torch.eval.nms import nms_keypoint_indices
from dh3d_tpu_torch.eval.registration import (
    match_descriptors_mutual,
    ransac_rigid,
)
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.train import resolve_model

RETRIEVED_M = 25.0  # a top-1 within 25 m of the query is retrieved
REGISTERED_INLIERS = 10
NMS_RADIUS, NMS_MIN_RATIO = 0.5, 0.01
TIMING_KEYS = ("models", "load", "global_forward", "local_forward", "nms",
               "matching", "ransac")
QUERY_KEYS = TIMING_KEYS[3:]  # the stages a query runs


def build_forward(model_path, extract_global, num_points, device):
    cfg, model = resolve_model(model_path)
    cfg.num_points = num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = extract_global
    return cfg, make_forward(cfg, model.to(device))


def positions(gt_file):
    """{cloud file name: (northing, easting)} of a GT pickle."""
    gt = get_sets_dict(gt_file)
    return {item["query"] + ".bin": (item["northing"], item["easting"])
            for seq in gt for item in gt[seq]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.relocalize")
    p.add_argument("--local_model", required=True)
    p.add_argument("--global_model", required=True)
    p.add_argument("--db_gt", required=True)
    p.add_argument("--query_gt", required=True)
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--max_queries", type=int, default=10)
    p.add_argument("--nms_max_kp", type=int, default=256)
    p.add_argument("--nms_backend", default="device",
                   choices=["device", "host"])
    p.add_argument("--ransac_iters", type=int, default=500)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI.  Returns {"queries": [{"query", "top1", "retrieval_m",
    "retrieved", "inliers", "matches", "registered", "kp_query", "kp_db",
    "ms"}], "retrieved": n, "registered": n, "n": queries run, "database":
    n, "seconds": total, "timings": host seconds by stage (TIMING_KEYS:
    model loads; cloud loads and normalisation; global forwards; local
    forwards; NMS; matching; RANSAC)}.  `inliers` and `matches` are None
    where the registration failed; `kp_*` are the NMS keypoint indices;
    `ms` the query's host ms by stage (QUERY_KEYS)."""
    args = parse_args(argv)
    device = eval_device(args.device)
    timings = dict.fromkeys(TIMING_KEYS, 0.0)
    t_start = time.perf_counter()
    with trace.enabled():
        return run(args, device, timings, t_start)


def run(args, device, timings, t_start) -> dict:
    """`main`'s work, recording (`trace.enabled`): each stage a span
    `relocalize.<key>`, ended once the device has finished the stage's
    work; the spans' host seconds go to `timings` as the store drains."""

    @contextlib.contextmanager
    def stage(key):
        with trace.span(f"relocalize.{key}"):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def drain() -> dict:
        """{key: host ms} of the stages recorded since the last drain,
        added to `timings`."""
        ms = dict.fromkeys(TIMING_KEYS, 0.0)
        for r in trace.records(clear=True):
            if r["name"].startswith("relocalize."):
                ms[r["name"][len("relocalize."):]] += r["host_ms"]
        for k, v in ms.items():
            timings[k] += v / 1e3
        return ms

    # ---- stage A: global descriptors of the database and the queries
    with stage("models"):
        _, gfwd = build_forward(args.global_model, True, args.num_points,
                                device)
        _, lfwd = build_forward(args.local_model, False, args.num_points,
                                device)

    def descriptors(gt_file):
        it = iter(GlobalTestDataset(args.pcdpath, gt_file,
                                    numpts=args.num_points))
        names, descs, clouds = [], [], []
        while True:
            with stage("load"):
                item = next(it, None)
            if item is None:
                drain()
                return names, np.stack(descs), clouds
            cloud, name = item
            with stage("global_forward"):
                descs.append(gfwd(cloud[None])["global_desc"][0]
                             .cpu().numpy())
            names.append(name)
            clouds.append(cloud)
            drain()

    db_names, db_desc, db_clouds = descriptors(args.db_gt)
    q_names, q_desc, q_clouds = descriptors(args.query_gt)
    print(f"database: {len(db_names)} clouds; queries: {len(q_names)}")
    db_pos, q_pos = positions(args.db_gt), positions(args.query_gt)

    # ---- stage B: local keypoints and descriptors, matching, RANSAC
    def keypoints(cloud):
        """(keypoints [k, 3], descriptors [k, 128], indices [k]) on the
        device: the forward, the inverted attention, NMS."""
        with stage("local_forward"):
            pts = torch.as_tensor(cloud, device=device)
            o = lfwd(pts[None])
            desc = o["local_desc"][0]
            if "attention" in o:
                att = 1 - o["attention"][0, :, 0]  # the reference inversion
            else:
                att = torch.ones(len(cloud), device=device)
        with stage("nms"):
            if args.nms_backend == "host":
                xyz, att = cloud.astype(np.float64), att.cpu().numpy()
            else:
                xyz = pts
            idx = nms_keypoint_indices(
                xyz, att, nms_radius=NMS_RADIUS,
                min_response_ratio=NMS_MIN_RATIO,
                max_keypoints=args.nms_max_kp, backend=args.nms_backend,
                device=device)
            ids = torch.as_tensor(idx, dtype=torch.long, device=device)
        return pts[ids], desc[ids], idx

    results, n_retrieved, n_registered = [], 0, 0
    n = min(args.max_queries, len(q_names))
    for qi in range(n):
        order = np.argsort(np.linalg.norm(db_desc - q_desc[qi], axis=1))
        top1 = int(order[0])
        dq, dd = q_pos[q_names[qi]], db_pos[db_names[top1]]
        retr_dist = float(np.hypot(dq[0] - dd[0], dq[1] - dd[1]))
        retrieved = retr_dist < RETRIEVED_M
        n_retrieved += int(retrieved)

        kp_q, desc_q, idx_q = keypoints(q_clouds[qi])
        kp_db, desc_db, idx_db = keypoints(db_clouds[top1])
        # register_clouds(kp_db, desc_db, kp_q, desc_q, seed=qi), timed
        # by stage
        with stage("matching"):
            matches = match_descriptors_mutual(desc_db, desc_q,
                                               device=device)
        res = None
        with stage("ransac"):
            if len(matches) >= 3:
                res = ransac_rigid(kp_db[matches[:, 0]],
                                   kp_q[matches[:, 1]],
                                   iters=args.ransac_iters, seed=qi,
                                   device=device)
        ms = drain()
        inl = f"{res.num_inliers}/{res.num_matches}" if res else "n/a"
        reg_ok = res is not None and res.num_inliers >= REGISTERED_INLIERS
        n_registered += int(reg_ok and retrieved)
        print(f"query {q_names[qi]}: top1 {db_names[top1]} "
              f"({retr_dist:.1f} m, {'OK' if retrieved else 'MISS'}), "
              f"inliers {inl}")
        results.append({
            "query": q_names[qi], "top1": db_names[top1],
            "retrieval_m": retr_dist, "retrieved": bool(retrieved),
            "inliers": res.num_inliers if res else None,
            "matches": res.num_matches if res else None,
            "registered": bool(reg_ok), "kp_query": idx_q, "kp_db": idx_db,
            "ms": {k: ms[k] for k in QUERY_KEYS}})

    print(f"\nretrieval@1 (<25m): {n_retrieved}/{n}; "
          f"registered (>=10 inliers): {n_registered}/{n}")
    return {"queries": results, "retrieved": n_retrieved,
            "registered": n_registered, "n": n, "database": len(db_names),
            "seconds": time.perf_counter() - t_start, "timings": timings}


if __name__ == "__main__":
    main()
