"""Global descriptor extraction and retrieval recall CLI of the port: the
counterpart of the repository's `evaluate/globaldesc_extract.py`
(`evaluate/global_eval/globaldesc_extract.py` of the reference).

    python -m dh3d_tpu_torch.evaluate.globaldesc_extract \
        --ModelPath models/demo_stage3 --pcdpath DIR \
        --ref_gt_file REF.pickle --query_gt_file QUERY.pickle \
        [--eval_recall] [--device cuda]

Writes one 256-f32 descriptor .bin per cloud of the union of both GT
files' sequences (each cloud once), then with --eval_recall the
cross-sequence recall@N and recall@1%.  --device defaults to cuda and
exits with an error when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import os

from dh3d_tpu_torch.data import GlobalTestDataset
from dh3d_tpu_torch.eval import (
    average_recalls,
    evaluate_sequences,
    extract_global,
    load_sets_from_dir,
)
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.train import resolve_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.globaldesc_extract")
    p.add_argument("--ModelPath", required=True)
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--ref_gt_file", required=True)
    p.add_argument("--query_gt_file", required=True)
    p.add_argument("--save_dir", default="./globaldesc_out")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_points", type=int, default=8192)
    p.add_argument("--eval_recall", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {"clouds": n} plus, with --eval_recall,
    "recall@N" (list) and "one_percent"."""
    args = parse_args(argv)
    device = eval_device(args.device)
    cfg, model = resolve_model(args.ModelPath)
    cfg.num_points = args.num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = True
    model = model.to(device)

    # extract for the union of ref + query sequences, each cloud once
    done, total = set(), 0
    for gt_file in dict.fromkeys([args.ref_gt_file, args.query_gt_file]):
        ds = GlobalTestDataset(args.pcdpath, gt_file, numpts=cfg.num_points)
        ds.files = [f for f in ds.files if f not in done]
        done.update(ds.files)
        n = extract_global(cfg, model, ds, args.save_dir,
                           batch_size=args.batch_size)
        total += n
        print(f"extracted {n} clouds from {os.path.basename(gt_file)} "
              f"on {device}")
    summary = {"clouds": total}

    if args.eval_recall:
        ref_sets = load_sets_from_dir(args.ref_gt_file, args.save_dir)
        query_sets = load_sets_from_dir(args.query_gt_file, args.save_dir)
        avg, one_percent = average_recalls(
            evaluate_sequences(ref_sets, query_sets))
        print("Avg_recall@N:")
        for i, r in enumerate(avg):
            print(f"{i + 1}: {r:.4f}")
        print(f"Avg_one_percent_retrieved: {one_percent:.4f}")
        summary.update({"recall@N": [float(r) for r in avg],
                        "one_percent": one_percent})
    return summary


if __name__ == "__main__":
    main()
