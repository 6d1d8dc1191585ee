"""The Morton modes' error budget, the port's counterpart of the
repository's `evaluate/error_budget.py` (whose TPU account is
`docs/ERROR_BUDGET.md`):

    python -m dh3d_tpu_torch.evaluate.error_budget \
        --local_model models/demo_stage2 --global_model models/demo_stage3 \
        --pcdpath DIR [--num_points 8192] [--max_clouds 0] [--rep_clouds 20] \
        [--json OUT.json] [--md OUT.md] [--device cuda|cpu]

DIR holds the clouds as `<sequence>/<name>.bin` and the GT pickles
`global_ref_demo.pickle` and `global_query_demo.pickle` ({sequence:
[{"query": "<sequence>/<name>", "northing", "easting"}]}).  On the same
weights, each mode against the exact-semantics path:

  parity  morton_order=False: exact kNN, the cloud in its own order;
  morton  morton_order=True, morton_exact=True (the default): exact kNN
          in Z-order;
  approx  morton_order=True, morton_exact=False: the legacy mode, kNN and
          3-NN in Morton bands (`ops.knn_window`, kernel H on the card).

Four stages, one JSON section each (the JAX script's keys):
  A_knn            the band's neighbour agreement with the exact k=8 kNN
                   (W = 512) on each Z-sorted cloud, and the relative
                   error of the kNN radius.  The port's band is unpacked
                   (exact d2, the (d2, index) order); the JAX script's
                   stage A ran `knn_banded`'s packed default, whose
                   truncated distances may pick other ids on near ties;
  B_local          per-point local-descriptor cosine, attention rank
                   correlation and top-512 keypoint overlap, each mode
                   against parity and approx against morton, on the same
                   Z-presorted input (`local_model`);
  BC_global        per-cloud global-descriptor cosine and cross-sequence
                   retrieval recall@1/@25 with a paired-bootstrap 95% CI
                   of each mode's difference to parity (`global_model`);
  C_repeatability  partial-overlap keypoint repeatability@512 per mode.
Every stage runs in this process (the JAX script ran each in its own, a
workaround for its TPU backend).  --device defaults to cuda and exits
with an error when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import tempfile

import numpy as np
import torch

from dh3d_tpu_torch.data import GlobalTestDataset
from dh3d_tpu_torch.data.io import load_single_pcfile, morton_sort_np
from dh3d_tpu_torch.eval.extract import extract_global, make_forward
from dh3d_tpu_torch.eval.repeatability import (
    make_partial_overlap_pairs,
    repeatability_curve_pairs,
)
from dh3d_tpu_torch.eval.retrieval import (
    compute_tp_fp,
    is_gt_match_2d,
    load_sets_from_dir,
)
from dh3d_tpu_torch.evaluate import eval_device
from dh3d_tpu_torch.nn.model import DH3D
from dh3d_tpu_torch.ops import knn, knn_window
from dh3d_tpu_torch.train import resolve_model

# (mode name, morton_order, morton_exact)
MODES = (("parity", False, True), ("morton", True, True),
         ("approx", True, False))
REF_GT, QUERY_GT = "global_ref_demo.pickle", "global_query_demo.pickle"


def mode_model(cfg, model, mode, extract_global, num_points, device):
    """(cfg, DH3D) of `mode` on the trained weights of `model`."""
    c = copy.deepcopy(cfg)
    c.num_points = num_points
    c.sampled_kpnum = -1
    c.input_R = False
    c.extract_global = extract_global
    _, c.morton_order, c.morton_exact = next(m for m in MODES
                                             if m[0] == mode)
    c.morton_presorted = False
    m = DH3D(c)
    own = m.state_dict()  # every array of m must come from `model`
    m.load_state_dict({k: v for k, v in model.state_dict().items()
                       if k in own})
    return c, m.to(device).eval()


def forward_modes(cfg, model, extract_global, num_points, device):
    """{mode: eval forward} over the same weights, one per MODES entry."""
    return {mode: make_forward(*mode_model(cfg, model, mode, extract_global,
                                           num_points, device))
            for mode, _, _ in MODES}


def load_clouds(pcdpath, num_points, rng):
    """The `*/*.bin` clouds under pcdpath, each `num_points` points drawn
    by `rng` (without replacement when it has enough)."""
    clouds = []
    for f in sorted(glob.glob(os.path.join(pcdpath, "*", "*.bin"))):
        pts = load_single_pcfile(f)
        sel = rng.choice(len(pts), num_points,
                         replace=len(pts) < num_points)
        clouds.append(pts[sel].astype(np.float32))
    return clouds


def knn_agreement(clouds, device, k=8, window=512):
    """A: the band's kNN against the exact kNN on each Z-sorted cloud (the
    in-model setting)."""
    agree, dist_relerr = [], []
    for pts in clouds:
        z = morton_sort_np(pts)
        zt = torch.from_numpy(z[None]).to(device)
        ex_i = knn(zt, zt, k)[0][0].cpu().numpy()
        bd_i = knn_window(zt, zt, k, window)[0][0].cpu().numpy()
        match = np.array([len(set(a).intersection(b))
                          for a, b in zip(ex_i, bd_i)]) / float(k)
        agree.append(match.mean())
        # the chosen neighbours' radius against the true kNN radius
        d_ex = np.linalg.norm(z[ex_i] - z[:, None], axis=-1)
        d_bd = np.linalg.norm(z[bd_i] - z[:, None], axis=-1)
        denom = np.maximum(d_ex.max(axis=1), 1e-9)
        dist_relerr.append(
            np.maximum(d_bd.max(axis=1) - d_ex.max(axis=1), 0.0) / denom)
    dist_relerr = np.concatenate(dist_relerr)
    return {
        "neighbor_agreement_mean": float(np.mean(agree)),
        "neighbor_agreement_min_cloud": float(np.min(agree)),
        "knn_radius_relerr_p50": float(np.percentile(dist_relerr, 50)),
        "knn_radius_relerr_p99": float(np.percentile(dist_relerr, 99)),
        "knn_radius_relerr_max": float(dist_relerr.max()),
    }


def local_drift(cfg, model, clouds, device, topk=512):
    """B (local model): per-point descriptor cosine and attention
    agreement of each Morton mode against parity, and of approx against
    morton.  Every mode sees the same Z-presorted cloud: FPS depends on
    the input order, so this keeps the modes' keypoint subsets the same
    and measures the neighbour sets alone."""
    fwds = forward_modes(cfg, model, False, clouds[0].shape[0], device)
    acc = {m: {"cos": [], "rank": [], "kp": []} for m, mo, _ in MODES if mo}
    acc["approx_vs_morton"] = {"cos": [], "rank": [], "kp": []}
    for pts in clouds:
        batch = morton_sort_np(pts)[None]
        outs = {m: {k: v.cpu().numpy() for k, v in fwds[m](batch).items()}
                for m, _, _ in MODES}
        for mode, a in acc.items():
            if mode == "approx_vs_morton":
                op, om = outs["morton"], outs["approx"]
            else:
                op, om = outs["parity"], outs[mode]
            dp, dm = op["local_desc"][0], om["local_desc"][0]
            a["cos"].append(np.sum(dp * dm, axis=-1))  # l2-normalised
            if "attention" in op:
                ap = op["attention"][0].ravel()
                am = om["attention"][0].ravel()
                rp = np.argsort(np.argsort(ap))
                rm = np.argsort(np.argsort(am))
                a["rank"].append(float(np.corrcoef(rp, rm)[0, 1]))
                tp = set(np.argsort(-ap)[:topk])
                tm = set(np.argsort(-am)[:topk])
                a["kp"].append(len(tp & tm) / float(topk))

    out = {}
    for mode, a in acc.items():
        cos_all = np.concatenate(a["cos"])
        out[mode] = {
            "local_desc_cos_p50": float(np.percentile(cos_all, 50)),
            "local_desc_cos_p01": float(np.percentile(cos_all, 1)),
            "local_desc_cos_min": float(cos_all.min()),
            "local_desc_cos_frac_below_0.99": float(np.mean(cos_all < 0.99)),
            # the JAX key: entries the TPU's out-of-band plan dropped; the
            # port has no plan and drops none
            "oob_plan_overflow_total": 0,
        }
        if a["rank"]:
            out[mode].update({
                "attention_spearman_mean": float(np.mean(a["rank"])),
                "attention_spearman_min": float(np.min(a["rank"])),
                f"keypoint_overlap@{topk}_mean": float(np.mean(a["kp"])),
                f"keypoint_overlap@{topk}_min": float(np.min(a["kp"])),
            })
    return out


def global_drift_and_retrieval(cfg, model, pcdpath, num_points, device,
                               n_boot=5000, seed=0):
    """B (global descriptor drift) and C (retrieval against parity with a
    paired bootstrap over the queries)."""
    ref_gt = os.path.join(pcdpath, REF_GT)
    query_gt = os.path.join(pcdpath, QUERY_GT)
    with tempfile.TemporaryDirectory() as work:
        dirs = {}
        for mode, _, _ in MODES:
            c, m = mode_model(cfg, model, mode, True, num_points, device)
            dirs[mode] = os.path.join(work, mode)
            done = set()
            for gt_file in (ref_gt, query_gt):
                ds = GlobalTestDataset(pcdpath, gt_file, numpts=num_points)
                ds.files = [f for f in ds.files if f not in done]
                done.update(ds.files)
                extract_global(c, m, ds, dirs[mode], batch_size=4)

        # per-cloud global-descriptor cosine, each Morton mode vs parity
        cos = {m: [] for m in dirs if m != "parity"}
        for f in sorted(glob.glob(os.path.join(dirs["parity"], "**",
                                               "*.bin"), recursive=True)):
            rel = os.path.relpath(f, dirs["parity"])
            a = np.fromfile(f, np.float32)
            for mode in cos:
                b = np.fromfile(os.path.join(dirs[mode], rel), np.float32)
                cos[mode].append(float(np.dot(a, b) / max(
                    np.linalg.norm(a) * np.linalg.norm(b), 1e-12)))
        cos = {m: np.asarray(v) for m, v in cos.items()}

        # per-query hits for the paired bootstrap (the cross-sequence
        # protocol, `evaluation_retrieval.py:129-158`)
        hits = {}
        for mode in dirs:
            ref_sets = load_sets_from_dir(ref_gt, dirs[mode])
            query_sets = load_sets_from_dir(query_gt, dirs[mode])
            h1, h25 = [], []
            for refseq in sorted(ref_sets):
                for queryseq in sorted(query_sets):
                    if refseq == queryseq:
                        continue
                    ref, query = ref_sets[refseq], query_sets[queryseq]
                    gt = is_gt_match_2d(query["pos"], ref["pos"])
                    tp_cum, valid, _ = compute_tp_fp(ref["desc"],
                                                     query["desc"], gt)
                    h1.append(tp_cum[valid, 0] > 0)
                    h25.append(tp_cum[valid, -1] > 0)
            hits[mode] = (np.concatenate(h1).astype(float),
                          np.concatenate(h25).astype(float))

    def ci(v):
        return [float(np.percentile(v, 2.5)), float(np.percentile(v, 97.5))]

    rng = np.random.default_rng(seed)
    nq = len(hits["parity"][0])
    out = {"n_queries": int(nq),
           "recall@1_parity": float(hits["parity"][0].mean()),
           "recall@25_parity": float(hits["parity"][1].mean())}
    for mode in cos:
        boots = {"r1": [], "r25": []}
        for _ in range(n_boot):
            idx = rng.integers(0, nq, nq)
            boots["r1"].append(hits[mode][0][idx].mean()
                               - hits["parity"][0][idx].mean())
            boots["r25"].append(hits[mode][1][idx].mean()
                                - hits["parity"][1][idx].mean())
        out[mode] = {
            "global_desc_cos_p50": float(np.percentile(cos[mode], 50)),
            "global_desc_cos_min": float(cos[mode].min()),
            "n_clouds": int(len(cos[mode])),
            "recall@1": float(hits[mode][0].mean()),
            "recall@25": float(hits[mode][1].mean()),
            "recall@1_diff_vs_parity_ci95": ci(boots["r1"]),
            "recall@25_diff_vs_parity_ci95": ci(boots["r25"]),
        }
    return out


def repeatability_parity(cfg, model, clouds, num_points, device, seed=0):
    """C: partial-overlap repeatability@512 in every mode."""
    fwds = forward_modes(cfg, model, False, num_points, device)

    def extractor(fwd):
        def fn(pts):
            outs = fwd(pts[None].astype(np.float32))
            return pts, outs["attention"][0].reshape(-1)
        return fn

    pairs = make_partial_overlap_pairs(clouds, numpts=num_points, seed=seed)
    return {f"repeatability@512_{mode}": float(repeatability_curve_pairs(
        extractor(fwd), pairs, ks=(512,), device=device)[512])
        for mode, fwd in fwds.items()}


def write_markdown(report, path):
    """A markdown summary of the report."""
    a = report["A_knn"]
    bl = report["B_local"]
    g = report["BC_global"]
    rep = report["C_repeatability"]

    def pct(x):
        return f"{100 * x:.1f}%"

    lines = [
        "# Morton-mode error budget of the PyTorch port",
        "",
        "Produced by `python -m dh3d_tpu_torch.evaluate.error_budget` over",
        f"{report['n_clouds']} clouds at {report['num_points']} points",
        f"(device: {report['device_name']}).",
        "",
        "Modes against the exact-semantics parity path (`morton_order="
        "False`):",
        "",
        "- **morton** (`morton_exact=True`, the default): exact kNN in "
        "Z-order;",
        "- **approx** (`morton_exact=False`, legacy): kNN and 3-NN in "
        "Morton bands.",
        "",
        "## A. Band kNN agreement (the approx mode's index error)",
        "",
        f"- neighbour agreement: mean {a['neighbor_agreement_mean']:.4f},"
        f" worst cloud {a['neighbor_agreement_min_cloud']:.4f}",
        f"- kNN radius rel. error: p50 {a['knn_radius_relerr_p50']:.2e},"
        f" p99 {a['knn_radius_relerr_p99']:.3f},"
        f" max {a['knn_radius_relerr_max']:.3f}",
        "",
        "## B. Model drift (same weights)",
        "",
        "| metric | morton vs parity | approx vs parity "
        "| approx vs morton |",
        "|---|---|---|---|",
    ]
    rows = [
        ("local desc cosine p50", "local_desc_cos_p50", "{:.6f}"),
        ("local desc cosine p01", "local_desc_cos_p01", "{:.6f}"),
        ("local desc cosine min", "local_desc_cos_min", "{:.6f}"),
        ("frac cos < 0.99", "local_desc_cos_frac_below_0.99", "{:.5f}"),
        ("attention spearman mean", "attention_spearman_mean", "{:.5f}"),
        ("keypoint overlap@512 mean", "keypoint_overlap@512_mean",
         "{:.4f}"),
    ]
    for label, key, fmt in rows:
        if key in bl["morton"]:
            lines.append(
                f"| {label} | {fmt.format(bl['morton'][key])} "
                f"| {fmt.format(bl['approx'][key])} "
                f"| {fmt.format(bl['approx_vs_morton'][key])} |")
    lines += [
        "",
        "## B/C. Global descriptor and retrieval "
        f"({g['n_queries']} cross-sequence queries)",
        "",
        "| metric | parity | morton | approx |",
        "|---|---|---|---|",
        f"| global desc cosine p50 | 1 (def) "
        f"| {g['morton']['global_desc_cos_p50']:.6f} "
        f"| {g['approx']['global_desc_cos_p50']:.6f} |",
        f"| global desc cosine min | 1 (def) "
        f"| {g['morton']['global_desc_cos_min']:.6f} "
        f"| {g['approx']['global_desc_cos_min']:.6f} |",
        f"| recall@1 | {pct(g['recall@1_parity'])} "
        f"| {pct(g['morton']['recall@1'])} "
        f"| {pct(g['approx']['recall@1'])} |",
        f"| recall@25 | {pct(g['recall@25_parity'])} "
        f"| {pct(g['morton']['recall@25'])} "
        f"| {pct(g['approx']['recall@25'])} |",
        "",
        "Paired-bootstrap 95% CI of (mode - parity), per query:",
        "",
        f"- morton: recall@1 {g['morton']['recall@1_diff_vs_parity_ci95']},"
        f" recall@25 {g['morton']['recall@25_diff_vs_parity_ci95']}",
        f"- approx: recall@1 {g['approx']['recall@1_diff_vs_parity_ci95']},"
        f" recall@25 {g['approx']['recall@25_diff_vs_parity_ci95']}",
        "",
        "## C. Keypoint repeatability@512 (partial-overlap protocol)",
        "",
        "| parity | morton | approx |",
        "|---|---|---|",
        f"| {rep['repeatability@512_parity']:.4f} "
        f"| {rep['repeatability@512_morton']:.4f} "
        f"| {rep['repeatability@512_approx']:.4f} |",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m dh3d_tpu_torch.evaluate.error_budget")
    p.add_argument("--local_model", required=True,
                   help="detection model: logdir, or Flax <stem>[.npz]")
    p.add_argument("--global_model", required=True)
    p.add_argument("--pcdpath", required=True,
                   help="<sequence>/*.bin clouds and the two GT pickles")
    p.add_argument("--num_points", type=int, default=8192)
    p.add_argument("--max_clouds", type=int, default=0,
                   help="0 = all clouds")
    p.add_argument("--rep_clouds", type=int, default=20,
                   help="clouds for the repeatability protocol")
    p.add_argument("--json", default="", help="write the report here")
    p.add_argument("--md", default="",
                   help="also write a markdown summary here")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the four stages; returns the report (and writes --json, --md)."""
    args = parse_args(argv)
    device = eval_device(args.device)
    rng = np.random.default_rng(0)
    clouds = load_clouds(args.pcdpath, args.num_points, rng)
    if args.max_clouds:
        clouds = clouds[:args.max_clouds]
    if not clouds:
        raise SystemExit(f"no <sequence>/*.bin clouds under {args.pcdpath}")
    print(f"{len(clouds)} clouds @ {args.num_points} pts on {device}",
          flush=True)
    report = {"num_points": args.num_points, "n_clouds": len(clouds),
              "backend": device.type,
              "device_name": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}

    report["A_knn"] = knn_agreement(clouds, device)
    print("A (kNN):", json.dumps(report["A_knn"], indent=1), flush=True)
    lcfg, lmodel = resolve_model(args.local_model)
    report["B_local"] = local_drift(lcfg, lmodel, clouds, device)
    print("B (local):", json.dumps(report["B_local"], indent=1), flush=True)
    gcfg, gmodel = resolve_model(args.global_model)
    report["BC_global"] = global_drift_and_retrieval(
        gcfg, gmodel, args.pcdpath, args.num_points, device)
    print("B+C (global/retrieval):",
          json.dumps(report["BC_global"], indent=1), flush=True)
    report["C_repeatability"] = repeatability_parity(
        lcfg, lmodel, clouds[:args.rep_clouds], args.num_points, device)
    print("C (repeatability):",
          json.dumps(report["C_repeatability"], indent=1), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json}")
    if args.md:
        write_markdown(report, args.md)
    return report


if __name__ == "__main__":
    main()
