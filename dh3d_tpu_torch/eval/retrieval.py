"""Global-descriptor retrieval evaluation (recall@N / recall@1%): a copy of
`dh3d_tpu/eval/retrieval.py` (numpy only).

Port of `evaluate/global_eval/evaluation_retrieval.py`: GT match iff 2-D
UTM distance < 25 m (`:29-34`); top-25 nearest descriptors (`:37-40`);
recall@N as cumulative TP over query ranks; recall@1% uses the top
ceil(len(ref)/100) (`:43-58`); cross-sequence evaluation skipping
(ref == query) pairs (`:138-140`).
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Dict, List, Optional, Sequence

import numpy as np

from dh3d_tpu_torch.data.io import get_sets_dict, load_descriptor_bin

RetrievalResult = namedtuple(
    "RetrievalResult", ["refseq", "queryseq", "recalls", "one_percent"]
)


def is_gt_match_2d(query_pos, ref_pos, distance_thresh=25.0):
    """[Q, R] bool: 2-D UTM distance under threshold
    (`evaluation_retrieval.py:29-34`)."""
    q = np.stack([query_pos["northing"], query_pos["easting"]], axis=1)
    r = np.stack([ref_pos["northing"], ref_pos["easting"]], axis=1)
    d = np.linalg.norm(q[:, None, :] - r[None, :, :], axis=-1)
    return d < distance_thresh


def retrieve(ref_desc, query_desc, max_num_nn):
    """Top-k nearest reference descriptors per query (brute force; the
    reference uses a cKDTree, `evaluation_retrieval.py:37-40`)."""
    d = np.linalg.norm(
        query_desc[:, None, :] - ref_desc[None, :, :], axis=-1
    )
    return np.argsort(d, axis=1, kind="stable")[:, :max_num_nn]


def compute_tp_fp(ref_desc, query_desc, gt_matches, max_num_nn=25):
    """`evaluation_retrieval.py:43-54`."""
    threshold = max(int(round(len(ref_desc) / 100.0)), 1)
    indices = retrieve(ref_desc, query_desc, max_num_nn)
    tp = gt_matches[np.arange(len(indices))[:, None], indices]
    tp_cum = np.cumsum(tp, axis=1)
    valid = np.any(gt_matches, axis=1)
    one_percent = np.any(tp[:, :threshold], axis=1)
    return tp_cum, valid, one_percent


def evaluate_sequences(ref_sets: Dict[str, dict], query_sets: Dict[str, dict],
                       max_num_nn=25) -> List[RetrievalResult]:
    """Cross-sequence retrieval: every (ref seq, query seq) pair with
    ref != query (`evaluation_retrieval.py:129-158`).

    Each entry of ref_sets/query_sets:
      {'pos': {'northing': [...], 'easting': [...]}, 'desc': [N, D]}.
    """
    results = []
    for refseq in sorted(ref_sets):
        for queryseq in sorted(query_sets):
            if refseq == queryseq:
                continue
            ref = ref_sets[refseq]
            query = query_sets[queryseq]
            gt = is_gt_match_2d(query["pos"], ref["pos"])
            tp_cum, valid, one_percent = compute_tp_fp(
                ref["desc"], query["desc"], gt, max_num_nn
            )
            recalls = np.mean(tp_cum[valid] > 0, axis=0)
            results.append(RetrievalResult(
                refseq, queryseq, recalls, float(np.mean(one_percent[valid]))
            ))
    return results


def average_recalls(results: Sequence[RetrievalResult]):
    recalls = np.vstack([r.recalls for r in results])
    one_percent = np.array([r.one_percent for r in results])
    return recalls.mean(axis=0), float(one_percent.mean())


def load_sets_from_dir(gt_file, desc_dir, dim=256,
                       sequences: Optional[Sequence[str]] = None):
    """Build eval sets from a GT pickle + per-cloud descriptor .bin files
    (the extract CLI's output format, `globaldesc_extract.py:93-100`)."""
    sets = {}
    gt = get_sets_dict(gt_file)
    for seq in sorted(sequences if sequences is not None else gt.keys()):
        pos = {"northing": [], "easting": []}
        descs = []
        for pcd in gt[seq]:
            pos["northing"].append(pcd["northing"])
            pos["easting"].append(pcd["easting"])
            descs.append(load_descriptor_bin(
                os.path.join(desc_dir, pcd["query"] + ".bin"), dim))
        sets[seq] = {
            "pos": {k: np.asarray(v) for k, v in pos.items()},
            "desc": np.vstack(descs),
        }
    return sets
