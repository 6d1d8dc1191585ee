"""The main-path forward, counterpart of `__graft_entry__.entry()`, and
the multi-process dry run, counterpart of `dryrun_multichip`.

`global_config` with the detection block, eval mode, Morton order, exact
neighbour sets, 8192-point clouds: local descriptors, keypoint attention
and the global descriptor in one forward.  Weights are the committed demo
checkpoints: `models/demo_stage3.npz` (local backbone and global head) plus
the `detection_block/*` arrays of `models/demo_stage2.npz`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch.eval.extract import make_forward
from dh3d_tpu_torch.nn.convert import load_flax, load_npz
from dh3d_tpu_torch.nn.model import DH3D

MODELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models")
NUM_POINTS = 8192


def entry_config() -> cfglib.dotdict:
    cfg = cfglib.get_config("global_config")
    cfg.num_points = NUM_POINTS
    cfg.detection = True
    cfg.detection_block = "detection_block"
    return cfg


def entry_weights() -> dict:
    """{flax_path: array}: demo_stage3 plus stage 2's detection block."""
    flat = load_npz(os.path.join(MODELS_DIR, "demo_stage3.npz"))
    stage2 = load_npz(os.path.join(MODELS_DIR, "demo_stage2.npz"))
    flat.update({k: v for k, v in stage2.items()
                 if k.split("/")[1:2] == ["detection_block"]})
    return flat


def entry_model(device):
    """(cfg, DH3D on `device` with the entry weights loaded)."""
    cfg = entry_config()
    model = DH3D(cfg).to(device)
    load_flax(model, entry_weights())
    return cfg, model


def entry_points(batch: int = 2, num_points: int = NUM_POINTS,
                 seed: int = 0) -> np.ndarray:
    """Synthetic clouds as `bench.py` makes them: randn * 30, float32."""
    rng = np.random.RandomState(seed)
    return rng.randn(batch, num_points, 3).astype(np.float32) * 30.0


def entry(device="cuda", batch: int = 2, seed: int = 0):
    """Returns (fn, (points,)): fn(points) -> outs dict, the eval forward of
    the main-path model on `device`, and `batch` synthetic clouds there."""
    device = torch.device(device)
    cfg, model = entry_model(device)
    points = torch.from_numpy(entry_points(batch, seed=seed)).to(device)
    return make_forward(cfg, model), (points,)


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel step of each kind on `n_devices` gloo processes on
    the CPU, at `__graft_entry__.dryrun_multichip`'s sizes (N=64, 8
    keypoints, one pair or tuple a rank), each checked
    (`parallel.jobs.dryrun_job`): a basic_config step; a Morton-presorted
    detection_config step with `device_pairgen`; the point-sharded kNN
    equal to `knn_bruteforce`; the mined loss of a global_config step with
    `cross_device_mining` equal to one process's on the whole batch; and,
    with n_devices >= 4 and even, the basic step on a 2-axis ("dcn",
    "data") mesh equal to the 1-D mesh's.  Prints the line the JAX
    function prints; raises when a check fails."""
    from dh3d_tpu_torch.parallel import jobs
    from dh3d_tpu_torch.parallel.launch import spawn

    facts = spawn(jobs.dryrun_job, n_devices, device="cpu")
    for f in facts[1:]:
        if f != facts[0]:
            raise AssertionError(f"ranks disagree: {f} against {facts[0]}")
    f = facts[0]
    dcn = f["dcn"]
    print(f"dryrun_multichip({n_devices}): one DP train step OK "
          f"(total_cost={f['total_cost']:.4f}); morton_presorted+"
          f"device_pairgen DP step OK ({f['morton']:.4f}); point-sharded "
          f"knn OK; cross-device batch-hard mining OK (mined loss "
          f"{f['mined']:.4f} == single-device)"
          + (f"; 2-axis dcn x data mesh step OK ({dcn:.4f})"
             if dcn is not None else ""))
