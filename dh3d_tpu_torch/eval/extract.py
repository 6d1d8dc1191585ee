"""Descriptor extraction (counterpart of `dh3d_tpu/eval/extract.py`).

`make_forward` is the eval forward.  `extract_local` and `extract_global`
drive it over eval clouds as the reference CLIs do
(`evaluate/local_eval/localdesc_extract.py`,
`evaluate/global_eval/globaldesc_extract.py`): batch to a fixed size
(padding the last batch with zero clouds), run the forward, crop each cloud
to its `ori_num` real points, and write dense rows, NMS keypoint rows
([xyz | 128-D descriptor | attention]) or one 256-f32 global descriptor per
cloud.  The reference quirk is kept: eval attention is inverted,
att = 1 - res[:, -1] (`localdesc_extract.py:94`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable

import numpy as np
import torch

from dh3d_tpu_torch import trace
from dh3d_tpu_torch.data.io import write_to_bin
from dh3d_tpu_torch.eval.nms import nms_keypoint_indices
from dh3d_tpu_torch.nn.model import DH3D


def make_forward(cfg, model: DH3D):
    """Eval forward: points [B, N, 3] (tensor or array) -> outs dict.

    Eval clouds are never presorted, so `cfg.morton_presorted` is forced
    off (the model reads `cfg` at every call), as the JAX extraction
    forward does for checkpoints trained on presorted clouds."""
    if cfg.morton_presorted:
        cfg.morton_presorted = False
    model.eval()
    device = next(model.parameters()).device

    def fwd(points, knn_inds=None):
        points = torch.as_tensor(points, dtype=torch.float32, device=device)
        if knn_inds is not None:
            knn_inds = torch.as_tensor(knn_inds, device=device).long()
        with torch.no_grad():
            return model(points.contiguous(), knn_inds=knn_inds)

    return fwd


def local_result_rows(outs, with_attention):
    """[B, N, 3+128(+1)] float32 rows on the host: xyz | l2-normed
    descriptor (| attention), the 'xyz_feat(_att)' outputs
    (`core/model.py:181,188`)."""
    key = "xyz_feat_att" if with_attention else "xyz_feat"
    return outs[key].cpu().numpy()


def _pad(batch, batch_size, dtype):
    pad = batch_size - batch.shape[0]
    if pad <= 0:
        return batch
    return np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], dtype)])


# the spans whose host seconds `extract_local` adds to `timings`
TIMED_SPANS = {"load": "load", "extract.forward": "forward",
               "extract.nms": "nms", "extract.write": "write"}


def extract_local(cfg, model: DH3D, dataset: Iterable, save_dir,
                  batch_size=1, perform_nms=False, save_all=False,
                  nms_rad=0.5, nms_min_ratio=0.01, nms_max_kp=512,
                  nms_backend="device", nms_parity_check=False,
                  timings=None):
    """Per-cloud local descriptors (`localdesc_extract.py:106-138`).

    dataset yields [cloud [N, 3], name, ori_num(, knn_ind [N, k])].
    Writes `<name>_res.bin` (dense) or `<name>_nms_res.bin` (keypoints,
    NMS on the model's device).  Spans (`trace`): `extract.forward` (the
    forward and the copy of the rows to the host), `extract.nms`,
    `extract.write`.  `timings`, when given, turns recording on and
    accumulates host seconds under 'load' (the dataset's `load` spans),
    'forward', 'nms' and 'write', draining the trace's store after each
    batch.  Returns the number of clouds."""
    os.makedirs(save_dir, exist_ok=True)
    fwd = make_forward(cfg, model)
    device = next(model.parameters()).device
    with_att = bool(cfg.detection)
    buf, names, orinums, knns = [], [], [], []

    def write(rows, path):
        with trace.span("extract.write"):
            write_to_bin(np.float32(rows), path)

    def flush():
        if not buf:
            return 0
        with trace.span("extract.forward", device):
            batch = _pad(np.stack(buf), batch_size, np.float32)
            knn = None
            if knns[0] is not None:
                knn = _pad(np.stack(knns), batch_size, np.int32)
            rows = local_result_rows(fwd(batch, knn), with_att)
        for b, (name, num) in enumerate(zip(names, orinums)):
            res = rows[b][:num]
            stem = os.path.join(save_dir, os.path.splitext(name)[0])
            if save_all or not with_att or not perform_nms:
                write(res, f"{stem}_res.bin")
                continue
            with trace.span("extract.nms", device):
                xyz = res[:, 0:3]
                attention = 1 - res[:, -1]  # reference inversion
                max_idx = nms_keypoint_indices(
                    xyz, attention, nms_radius=nms_rad,
                    min_response_ratio=nms_min_ratio,
                    max_keypoints=nms_max_kp, backend=nms_backend,
                    parity_check=nms_parity_check, device=device)
            write(res[max_idx, :], f"{stem}_nms_res.bin")
        n = len(names)
        buf.clear(); names.clear(); orinums.clear(); knns.clear()
        if timings is not None:
            for r in trace.records(clear=True):
                key = TIMED_SPANS.get(r["name"])
                if key:
                    timings[key] = timings.get(key, 0.0) + r["host_ms"] / 1e3
        return n

    total = 0
    with (trace.enabled() if timings is not None
          else contextlib.nullcontext()):
        for item in dataset:
            buf.append(np.asarray(item[0], np.float32))
            names.append(item[1])
            orinums.append(int(item[2]))
            knns.append(item[3] if len(item) > 3 else None)
            if len(buf) == batch_size:
                total += flush()
        return total + flush()


def extract_global(cfg, model: DH3D, dataset: Iterable, save_dir,
                   batch_size=4):
    """Per-cloud 256-f32 global descriptors
    (`globaldesc_extract.py:81-100`).  dataset yields [cloud, name]; each
    descriptor goes to `<save_dir>/<name without .bin>.bin`.  Returns the
    number of clouds."""
    os.makedirs(save_dir, exist_ok=True)
    fwd = make_forward(cfg, model)

    buf, names = [], []

    def flush():
        if not buf:
            return 0
        batch = _pad(np.stack(buf), batch_size, np.float32)
        gd = fwd(batch)["global_desc"].cpu().numpy()
        for b, name in enumerate(names):
            out = os.path.join(save_dir, os.path.splitext(name)[0] + ".bin")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            write_to_bin(np.float32(gd[b]), out)
        n = len(names)
        buf.clear(); names.clear()
        return n

    total = 0
    for cloud, name in dataset:
        buf.append(np.asarray(cloud, np.float32))
        names.append(name)
        if len(buf) == batch_size:
            total += flush()
    total += flush()
    return total
