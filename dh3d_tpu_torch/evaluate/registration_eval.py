"""6DoF registration evaluation CLI of the port: the counterpart of the
repository's `evaluate/registration_eval.py` (the reference's MATLAB
`eval_align.m` / `local_align_demo.m`): mutual-NN matching of extracted
keypoint descriptors and a RANSAC rigid fit (inlier 1.0 m) on the device,
success iff RTE <= 2 m and RRE <= 5 deg.

    python -m dh3d_tpu_torch.evaluate.registration_eval \
        (--pairs FILE | --self_test F) [--iters 1000] [--device cuda]

Inputs are `<name>_nms_res.bin` files of `localdesc_extract`
([xyz | 128-D descriptor | attention] rows).
  --pairs FILE   lines `fileA fileB [T_gt.txt]`; T_gt is a 4x4 text matrix
                 mapping cloud B into cloud A's frame.  Without T_gt the
                 estimated transform is printed but not scored.
  --self_test F  apply a seeded rigid transform to F's keypoints and
                 recover it.
--device defaults to cuda and exits with an error when there is no CUDA
device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dh3d_tpu_torch.data.io import load_descriptor_bin
from dh3d_tpu_torch.eval import (
    match_descriptors_mutual,
    ransac_rigid,
    register_clouds,
    registration_success,
)
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.utils.transforms import to_homogeneous


def load_kp_file(path, desc_dim=128):
    rows = load_descriptor_bin(path, dim=3 + desc_dim + 1)
    return rows[:, :3], rows[:, 3:3 + desc_dim]


def run_pair(fa, fb, T_gt=None, iters=1000, seed=0, device="cuda"):
    """(RansacResult or None, (success, rte, rre) or None) of one pair."""
    kp1, d1 = load_kp_file(fa)
    kp2, d2 = load_kp_file(fb)
    res = register_clouds(kp1, d1, kp2, d2, iters=iters, seed=seed,
                          device=device)
    if res is None:
        return None, None
    if T_gt is None:
        return res, None
    return res, registration_success(res.R, res.t, T_gt[:3, :3], T_gt[:3, 3])


def self_test(path, iters, device):
    """Register F's keypoints against a copy moved by a seeded z-rotation
    and translation; the estimate must be that motion."""
    kp, desc = load_kp_file(path)
    rng = np.random.RandomState(0)
    ang = rng.uniform(-np.pi, np.pi)
    c, s = np.cos(ang), np.sin(ang)
    R_gt = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t_gt = rng.uniform(-5, 5, 3)
    # kp = kp2 @ R_gt.T + t_gt, so the fit must recover (R_gt, t_gt)
    kp2 = (kp - t_gt) @ R_gt
    matches = match_descriptors_mutual(desc, desc, device=device)
    matches = matches.cpu().numpy()
    res = ransac_rigid(kp[matches[:, 0]], kp2[matches[:, 1]], iters=iters,
                       device=device)
    ok, rte, rre = registration_success(res.R, res.t, R_gt, t_gt)
    print(f"self-test: success={ok} RTE={rte:.4f}m RRE={rre:.4f}deg "
          f"inliers={res.num_inliers}/{res.num_matches}")
    return {"success": ok, "rte": rte, "rre": rre,
            "inliers": res.num_inliers, "matches": res.num_matches}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.registration_eval")
    p.add_argument("--pairs", help="file with lines: fileA fileB [gt_T.txt]")
    p.add_argument("--self_test", help="single _nms_res.bin for a sanity run")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI.  --self_test returns {"success", "rte", "rre",
    "inliers", "matches"}; --pairs returns {"pairs", "scored", "success"
    (count), "mean_rte", "mean_rre" (None when nothing was scored),
    "per_pair": [{"a", "b", "inliers", "matches", "success", "rte", "rre"}]}
    (the last five None where the pair failed or had no T_gt)."""
    args = parse_args(argv)
    device = eval_device(args.device)
    if args.self_test:
        return self_test(args.self_test, args.iters, device)

    if not args.pairs:
        raise SystemExit("need --pairs or --self_test")
    n_ok = n_scored = n_total = 0
    rtes, rres, per_pair = [], [], []
    with open(args.pairs) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            n_total += 1
            T_gt = np.loadtxt(parts[2]) if len(parts) > 2 else None
            res, score = run_pair(parts[0], parts[1], T_gt,
                                  iters=args.iters, device=device)
            entry = {"a": parts[0], "b": parts[1], "inliers": None,
                     "matches": None, "success": None, "rte": None,
                     "rre": None}
            per_pair.append(entry)
            if res is None:
                print(f"{parts[0]} {parts[1]}: FAILED (too few matches)")
                continue
            entry.update(inliers=res.num_inliers, matches=res.num_matches)
            name_a, name_b = (os.path.basename(x) for x in parts[:2])
            if score is not None:
                ok, rte, rre = score
                n_scored += 1
                n_ok += int(ok)
                rtes.append(rte)
                rres.append(rre)
                entry.update(success=ok, rte=rte, rre=rre)
                print(f"{name_a} vs {name_b}: success={ok} "
                      f"RTE={rte:.3f} RRE={rre:.3f} "
                      f"inliers={res.num_inliers}/{res.num_matches}")
            else:
                print(f"{name_a} vs {name_b}: "
                      f"T=\n{to_homogeneous(res.R, res.t)}")
    if n_scored:
        print(f"\nsuccess rate: {n_ok}/{n_scored} = {n_ok / n_scored:.4f}; "
              f"mean RTE {np.mean(rtes):.3f} m; mean RRE "
              f"{np.mean(rres):.3f} deg")
    return {"pairs": n_total, "scored": n_scored, "success": n_ok,
            "mean_rte": float(np.mean(rtes)) if rtes else None,
            "mean_rre": float(np.mean(rres)) if rres else None,
            "per_pair": per_pair}


if __name__ == "__main__":
    main()
