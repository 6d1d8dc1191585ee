"""The work of one rank, run by `parallel.launch.spawn(job, n, args)` as
`job(mesh, *args)`: module-level functions, so that a spawned process
imports them by name (and with them torch and the port only).

  step_job      one data-parallel train step from given weights and a
                whole batch with its draws: metrics, reduced gradients,
                the state after it, Adam's moments, kernel launches
  steps_job     data-parallel steps on whole batches in turn: each
                step's metrics and collective counts, the first reduced
                gradients, the state after the last
  graph_job     the same steps on a graphed state and on one kept eager
  units_job     sync BatchNorm, the mined loss over the group and the
                collectives' gradients on given inputs
  knn_job       `knn_sharded` on given clouds
  dryrun_job    the five checks of `entry.dryrun_multichip`
  train_job     a rank of `python -m dh3d_tpu_torch.train --num_devices`
  calls_job     several of these in one launch

Every input comes in on the CPU and goes to the rank's device; every
tensor of a result comes back on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dh3d_tpu_torch import kernels
from dh3d_tpu_torch.config import dotdict


def to(x, device):
    """`x` (tensors in dicts, lists and tuples) with every tensor on
    `device`."""
    if isinstance(x, dict):
        return {k: to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to(v, device) for v in x)
    return x.to(device) if torch.is_tensor(x) else x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_result(state, metrics) -> dict:
    """A step's outcome on the CPU: metrics, the gradient of every
    trainable parameter, the model's state (parameters and BN statistics),
    Adam's moments."""
    model, opt = state.model, state.optimizer
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().cpu() for n, p in trainable},
        "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "adam": {n: {k: opt.state[p][k].detach().cpu()
                     for k in ("exp_avg", "exp_avg_sq")}
                 for n, p in trainable},
        "step": state.step,
    }


def _dp_state(mesh, cfg, weights):
    """A train state of `cfg` from the model state dict `weights`, rank
    0's on every rank of the mesh."""
    from dh3d_tpu_torch.parallel.mesh import replicate
    from dh3d_tpu_torch.train import trainer

    state = trainer.init_state(cfg, 0, mesh.device)
    state.model.load_state_dict(weights)
    replicate(state, mesh)
    return state


def step_job(mesh, cfg: dict, weights: dict, batch: dict,
             timed_steps: int = 0, slices: int = 1) -> dict:
    """One data-parallel step of `cfg` from the model state dict `weights`
    (the same on every rank; rank 0's is replicated anyway) on the whole
    `batch` with its draws (`pairgen_draws`, `aug_draws`), over the mesh,
    or with `slices` > 1 over a `multihost_mesh(slices, n // slices)`.
    Returns `step_result` with the kernel launches of that step and, after
    `timed_steps` more steps on the same batch, their times on CUDA
    events (`step_ms`; None on the CPU)."""
    from dh3d_tpu_torch.parallel.mesh import multihost_mesh
    from dh3d_tpu_torch.train import trainer

    if slices > 1:
        mesh = multihost_mesh(slices, mesh.size // slices, device=mesh.device)
    cfg = dotdict(cfg)
    state = _dp_state(mesh, cfg, weights)
    step = trainer.make_train_step(cfg, mesh)
    batch = to(batch, mesh.device)
    _sync(mesh.device)
    kernels.reset_counts()
    metrics = step(state, batch)
    _sync(mesh.device)
    out = step_result(state, metrics)
    out["launches"] = kernels.counts()
    out["step_ms"] = None
    if timed_steps and mesh.device.type == "cuda":
        out["step_ms"] = []
        for _ in range(timed_steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(state, batch)
            ev[1].record()
            ev[1].synchronize()
            out["step_ms"].append(ev[0].elapsed_time(ev[1]))
    return out


def _steps(state, step, batches, device) -> list:
    """[{"metrics", "launches", "collectives"}] of `step(state, batch)` on
    each of `batches` in turn: its metrics, kernel launches and the
    trace's `collective.*` counts it added (a replay adds what its capture
    recorded)."""
    from dh3d_tpu_torch import trace

    out = []
    for batch in batches:
        before, launched = trace.tally(), kernels.counts()
        metrics = step(state, to(batch, device))
        _sync(device)
        now = trace.tally()
        out.append({
            "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
            "launches": {k: n - launched[k]
                         for k, n in kernels.counts().items()},
            "collectives": {k: n - before.get(k, 0) for k, n in now.items()
                            if k.startswith("collective.")
                            and n != before.get(k, 0)}})
    return out


def steps_job(mesh, cfg: dict, weights: dict, batches: list) -> dict:
    """Data-parallel steps of `cfg` from the model state dict `weights`
    on each whole batch of `batches` (with its draws) in turn: `steps`
    (`_steps`: per step its metrics, launches and collective counts), the
    reduced gradient of every trainable parameter after the first step
    (`grads`) and the model's state after the last (`state`)."""
    from dh3d_tpu_torch.train import trainer

    cfg = dotdict(cfg)
    state = _dp_state(mesh, cfg, weights)
    step = trainer.make_train_step(cfg, mesh)
    out = {"steps": _steps(state, step, batches[:1], mesh.device)}
    out["grads"] = {n: p.grad.detach().cpu()
                    for n, p in state.model.named_parameters()
                    if p.requires_grad}
    out["steps"] += _steps(state, step, batches[1:], mesh.device)
    out["state"] = {k: v.detach().cpu()
                    for k, v in state.model.state_dict().items()}
    return out


def graph_job(mesh, cfg: dict, weights: dict, batches: list) -> dict:
    """`steps_job`'s steps on two states from `weights`: "graphed", whose
    step is graphed where it may be (the first step eager, the second
    captured, the later ones replayed), and "eager", kept eager by a no-op
    forward hook.  For each: `steps` (`_steps`), the trace's `train.*`
    counts the steps added, and the state and Adam's moments and steps
    after them (`step_result`)."""
    from dh3d_tpu_torch import trace
    from dh3d_tpu_torch.train import trainer

    cfg = dotdict(cfg)
    out = {}
    for name in ("graphed", "eager"):
        state = _dp_state(mesh, cfg, weights)
        if name == "eager":
            state.model.register_forward_hook(lambda *a: None)
        before = trace.tally()
        steps = _steps(state, trainer.make_train_step(cfg, mesh), batches,
                       mesh.device)
        res = step_result(state, steps[-1]["metrics"])
        res["steps"] = steps
        res["counters"] = {k: n - before.get(k, 0)
                           for k, n in trace.tally().items()
                           if k.startswith("train.")
                           and n != before.get(k, 0)}
        res["adam_step"] = {n: float(state.optimizer.state[p]["step"])
                            for n, p in state.model.named_parameters()
                            if p.requires_grad}
        out[name] = res
    return out


def units_job(mesh, data: dict) -> dict:
    """On this rank's block of each input (the inputs hold every rank's):
      bn         BatchNorm in train mode with the mesh as its group: y,
                 the gradients of sum(y * dy) and the running statistics;
      mined      `batch_hard_quadruplet_loss` of one tuple a rank with the
                 mesh as `axis_name`, and the gradient of the rank's loss;
      reduce,    `all_reduce` and `all_gather` (along dims 0 and 1) of a
      gather0/1  rank's x, with the gradient of sum(out * c_rank);
      modules    the jax, flax, sklearn and `dh3d_tpu` modules this
                 process has loaded (none)."""
    from dh3d_tpu_torch.losses import batch_hard_quadruplet_loss
    from dh3d_tpu_torch.nn.layers import BatchNorm
    from dh3d_tpu_torch.parallel.collectives import all_gather, all_reduce

    dev, r, n = mesh.device, mesh.position, mesh.size
    out = {}

    bn = data["bn"]
    rows = bn["x"].shape[0] // n
    block = slice(r * rows, (r + 1) * rows)
    layer = BatchNorm(bn["x"].shape[-1], momentum=bn["momentum"]).to(dev)
    with torch.no_grad():
        for name in ("scale", "bias", "mean", "var"):
            getattr(layer, name).copy_(bn[name])
    layer.group = mesh
    layer.train()
    x = bn["x"][block].to(dev).requires_grad_()
    y = layer(x)
    y.backward(bn["dy"][block].to(dev))
    out["bn"] = {"y": y.detach().cpu(), "dx": x.grad.cpu(),
                 "dscale": layer.scale.grad.cpu(),
                 "dbias": layer.bias.grad.cpu(),
                 "mean": layer.mean.cpu(), "var": layer.var.cpu()}

    m = data["mined"]
    t = m["tuples"][r].to(dev).requires_grad_()
    loss, aux = batch_hard_quadruplet_loss(
        t, batch_size=1, num_pos=m["num_pos"], num_neg=m["num_neg"],
        global_triplet_margin=0.5, global_quadruplet_margin=0.2,
        axis_name=mesh)
    loss.backward()
    out["mined"] = {"loss": float(loss), "grad": t.grad.cpu(),
                    **{k: float(v) for k, v in aux.items()}}

    c = data["collectives"]
    for key, fn in (("reduce", lambda v: all_reduce(v, mesh)),
                    ("gather0", lambda v: all_gather(v, mesh, dim=0)),
                    ("gather1", lambda v: all_gather(v, mesh, dim=1))):
        v = c["x"][r].to(dev).requires_grad_()
        y = fn(v)
        (y * c[key][r].to(dev)).sum().backward()
        out[key] = {"out": y.detach().cpu(), "grad": v.grad.cpu()}
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "flax", "sklearn", "dh3d_tpu"))
    return out


def knn_job(mesh, cases) -> list:
    """`knn_sharded` of each (positions [B, N, 3], k) of `cases`, on this
    rank's block of rows: [(idx, dist, launches)]."""
    from dh3d_tpu_torch.parallel.sharded_knn import knn_sharded, point_block

    out = []
    for positions, k in cases:
        block = point_block(positions.to(mesh.device), mesh)
        _sync(mesh.device)
        kernels.reset_counts()
        idx, dist = knn_sharded(block, k, mesh)
        _sync(mesh.device)
        out.append((idx.cpu(), dist.cpu(), kernels.counts()))
    return out


def calls_job(mesh, calls) -> list:
    """[job(mesh, *args) for (job, args) in calls], in one launch."""
    return [job(mesh, *args) for job, args in calls]


def train_job(mesh, args):
    """A rank of `python -m dh3d_tpu_torch.train --num_devices`: the
    training loop on this rank's device and the mesh."""
    from dh3d_tpu_torch.train.__main__ import run

    return run(args, mesh.device, mesh)


def _close(a: float, b: float, what: str) -> None:
    if not (np.isfinite(a) and abs(a - b) < 1e-3 * max(1.0, abs(b))):
        raise AssertionError(f"{what}: {a} against {b}")


def dryrun_job(mesh) -> dict:
    """`__graft_entry__.dryrun_multichip`'s checks at its sizes (N=64,
    8 keypoints, one pair or tuple a rank), each asserted:
      total_cost  a basic_config DP step, finite;
      morton      a detection_config DP step on Morton-presorted {pc1, pc2}
                  clouds with `device_pairgen` (pairs built on each rank),
                  finite;
      knn         `knn_sharded` [2, 16 n] k=4 equal to `knn_bruteforce`;
      mined       a global_config DP step with `cross_device_mining`, its
                  loss within 1e-3 of one process's on the whole batch;
      dcn         with n >= 4 and n even, the basic step on a
                  `multihost_mesh(2, n // 2)`, within 1e-3 of the 1-D
                  mesh's (None otherwise)."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch import ops
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.parallel.mesh import multihost_mesh, replicate
    from dh3d_tpu_torch.parallel.sharded_knn import knn_sharded, point_block
    from dh3d_tpu_torch.train import trainer

    n, dev = mesh.size, mesh.device
    N, KP = 64, 8
    rng = np.random.RandomState(0)

    def dp_step(cfg, batch, seed, group, pairgen=None):
        state = trainer.init_state(cfg, seed, dev)
        if group is not None:
            replicate(state, group)
        m = trainer.make_train_step(cfg, group)(state, to(batch, dev),
                                                pairgen)
        return float(m["total_cost"])

    cfg = cfglib.get_config("basic_config")
    cfg.num_points, cfg.sampled_kpnum, cfg.batch_size = N, KP, n
    pc1 = rng.randn(n, N, 3).astype(np.float32) * 5
    ang = rng.uniform(-np.pi, np.pi, n)
    R = np.stack([np.array([[np.cos(a), np.sin(a), 0],
                            [-np.sin(a), np.cos(a), 0], [0, 0, 1]],
                           np.float32) for a in ang])
    pc2 = np.einsum("bnd,bde->bne", pc1, R).astype(np.float32)
    anc = np.stack([rng.choice(N, KP, replace=False) for _ in range(n)])
    batch = {"points": torch.from_numpy(np.concatenate([pc1, pc2])),
             "sample_inds": torch.from_numpy(np.concatenate([anc, anc])),
             "R": torch.from_numpy(R)}
    loss = dp_step(cfg, batch, 0, mesh)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    mcfg = cfglib.get_config("detection_config")
    mcfg.num_points, mcfg.sampled_kpnum, mcfg.batch_size = N, KP, n
    mcfg.morton_order = mcfg.morton_presorted = mcfg.device_pairgen = True
    mbatch = {"pc1": torch.from_numpy(morton_sort_np(pc1)),
              "pc2": torch.from_numpy(morton_sort_np(pc1 + 0.01))}
    pairgen = torch.Generator(device=dev).manual_seed(7)
    morton = dp_step(mcfg, mbatch, 2, mesh, pairgen)
    if not np.isfinite(morton):
        raise AssertionError(f"non-finite morton loss {morton}")

    pts = torch.from_numpy(
        rng.randn(2, 16 * n, 3).astype(np.float32)).to(dev)
    idx_s, _ = knn_sharded(point_block(pts, mesh), 4, mesh)
    idx_1, _ = ops.knn_bruteforce(pts, 4)
    knn_equal = torch.equal(idx_s, point_block(idx_1, mesh))
    if not knn_equal:
        raise AssertionError("sharded knn mismatch")

    gcfg = cfglib.get_config("global_config")
    gcfg.num_points, gcfg.batch_size = N, n
    gcfg.num_pos, gcfg.num_neg, gcfg.sampled_kpnum = 1, 1, -1
    gcfg.input_R, gcfg.cross_device_mining = False, True
    total = gcfg.batch_size * (1 + gcfg.num_pos + gcfg.num_neg + 1)
    gbatch = {"points": torch.from_numpy(
        rng.randn(total, N, 3).astype(np.float32) * 5)}
    mined_single = dp_step(gcfg, gbatch, 1, None)
    mined = dp_step(gcfg, gbatch, 1, mesh)
    _close(mined, mined_single, "mined loss over the mesh")

    dcn = None
    if n >= 4 and n % 2 == 0:
        dcn = dp_step(cfg, batch, 0, multihost_mesh(2, n // 2, device=dev))
        _close(dcn, loss, "2-axis dcn x data mesh step")
    return {"total_cost": loss, "morton": morton, "knn": knn_equal,
            "mined": mined, "mined_single": mined_single, "dcn": dcn}
