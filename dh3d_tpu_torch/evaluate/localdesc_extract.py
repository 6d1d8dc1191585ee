"""Local descriptor and keypoint extraction CLI of the port: the
counterpart of the repository's `evaluate/localdesc_extract.py`
(`evaluate/local_eval/localdesc_extract.py` of the reference).

    python -m dh3d_tpu_torch.evaluate.localdesc_extract \
        --ModelPath models/demo_stage2 --pcdpath DIR [--perform_nms] \
        [--save_all] [--dataset oxford_lidar|oxford_dso] [--device cuda]

Loads the model with its train-time config (a logdir of the port's
trainer, or a packaged Flax `<stem>.npz` with its `<stem>.config.json`),
sets num_points per dataset (16384 oxford_lidar, 9000 oxford_dso,
`localdesc_extract.py:146-149`), runs the forward over every .bin cloud of
--pcdpath and writes dense rows (--save_all) or NMS keypoint rows
([xyz | desc | att]) into --save_dir.  --host_knn gives the forward
neighbour ids from a host kNN.  --device defaults to cuda and exits with
an error when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

from dh3d_tpu_torch.data import LocalTestDataset
from dh3d_tpu_torch.eval import extract_local
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.train import resolve_model

NUM_POINTS = {"oxford_lidar": 16384, "oxford_dso": 9000}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.localdesc_extract")
    p.add_argument("--ModelPath", required=True,
                   help="logdir with config.json + ckpt/step_*.pt, or a "
                        "Flax <stem>[.npz] with <stem>.config.json")
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--save_dir", default="./localdesc_out")
    p.add_argument("--dataset", default="oxford_lidar",
                   choices=sorted(NUM_POINTS))
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--perform_nms", action="store_true")
    p.add_argument("--save_all", action="store_true")
    p.add_argument("--host_knn", action="store_true")
    p.add_argument("--dim", type=int, default=6,
                   help="floats per point record in the .bin files "
                        "(reference local eval data is 6; demo data is 3)")
    p.add_argument("--nms_rad", type=float, default=0.5)
    p.add_argument("--nms_min_ratio", type=float, default=0.01)
    p.add_argument("--nms_max_kp", type=int, default=512)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"clouds": n, "seconds": total wall seconds,
    "timings": extract_local's split}."""
    args = parse_args(argv)
    device = eval_device(args.device)
    cfg, model = resolve_model(args.ModelPath)
    cfg.num_points = NUM_POINTS[args.dataset]
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    model = model.to(device)

    ds = LocalTestDataset(
        args.pcdpath, numpts=cfg.num_points, dim=args.dim,
        knn_require=cfg.knn_num if args.host_knn else 0,
    )
    timings = {}
    t0 = time.perf_counter()
    n = extract_local(
        cfg, model, ds, args.save_dir, batch_size=args.batch_size,
        perform_nms=args.perform_nms, save_all=args.save_all,
        nms_rad=args.nms_rad, nms_min_ratio=args.nms_min_ratio,
        nms_max_kp=args.nms_max_kp, timings=timings,
    )
    summary = {"clouds": n, "seconds": time.perf_counter() - t0,
               "timings": timings}
    print(f"extracted {n} clouds -> {args.save_dir} on {device}: "
          f"{json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
