"""Training entry point of the port: the counterpart of the repository's
`train.py` (`train.py:110-236`).

    python -m dh3d_tpu_torch.train --cfg detection_config \
        (--data_basedir DIR | --synthetic) [--device_pairgen] \
        [--steps N] [--logdir DIR] [--load FLAX.npz|CKPT.pt|LOGDIR] \
        [--resume CKPT.pt] [--profile] \
        [--seed S] [--set key=value ...] [--num_points N] [--batch_size B] \
        [--num_devices N] [--device cuda|cpu]

Batches come from `.bin` clouds and a GT pickle under `--data_basedir`
(`train.data.real_batches`, in a prefetch thread when `cfg.prefetch` > 0)
or, with `--synthetic`, from generated self pairs.  Each step gets two
generators on the device, seeded from (1000 + seed, step) for the pair
generation and (2000 + seed, step) for the augmentation: the counterpart
of `jax.random.fold_in(key, step)` (`train.py:202-212`), so a resumed run
draws what an unbroken run draws at that step.

`--load` warm-starts the model from the previous stage of the curriculum:
a Flax `<stem>.npz` (the shipped `models/`), a checkpoint `step_*.pt` of
this trainer, or its training logdir (the newest checkpoint there).  Every
tensor whose name and shape the model has loads, parameters and BN
statistics both; the optimizer and the step start afresh, as `train.py
--load` does.  `--resume` is the exact resume of one run.

Writes `config.json` and `metrics.jsonl` into the logdir, prints the
metrics every 50 steps and at the last step, and saves a checkpoint every
`savemodel_every_k_steps` steps and at the end (`<logdir>/ckpt/`).
`--profile` traces steps 10-15 of the run with `torch.profiler` (CPU
activity, and CUDA activity on a CUDA device) into a Chrome trace under
`<logdir>/profile/`, as `train.py --profile` traces them with
`jax.profiler`: the trace starts before step start + 10 and stops after
step start + 15 once the device has finished, so a run of fewer than 16
steps writes none.

`--num_devices N` trains data parallel on N processes, one a device
(`parallel.launch.spawn`; the step is `trainer.make_train_step(cfg,
mesh)`): NCCL and `cuda:r` for rank r by default, which raises before
starting any process when there are fewer than N cards; gloo with
`--device cpu`.  The kernels are built once, before the ranks start.
Every rank loads the whole batch of each step from the same seed, as a
one-process run does (the samplers draw each cloud's subsampling and
augmentation in sequence from one generator, so a rank cannot load its
own clouds alone), and keeps its block.  Rank 0 alone writes the config,
the metrics and the checkpoints, whose format is the one-process run's:
either kind resumes the other.  A rank that fails stops the others, and
the run raises.

The run records the port's spans (`trace.enable`), so `--profile`'s
trace shows them (`dh3d:<span>`) on the device's timeline.  `main`
returns a summary (rank 0's under `--num_devices`): the tensors a warm
start restored, the steps, the host-clock seconds of the loop, each
step's wait in `next(batches)` (`wait_s`, span `step.wait`), its device
time (`step_ms`, span `step`'s CUDA events; None off CUDA) and its
kernel launches (the trace's counters), the step's own counters over the
run (`counters`: eager steps, graph captures and replays, and the
collectives' calls and bytes), `spans`
(`span_summary`), the last metrics, and the trace file (`profile`, None
without one).
`--device` defaults to cuda and raises when there is no CUDA device; the
CPU (the kernels' plain versions) runs only when asked for.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import time

import torch

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch import kernels, trace
from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher
from dh3d_tpu_torch.nn.convert import warm_start
from dh3d_tpu_torch.parallel import jobs
from dh3d_tpu_torch.parallel.launch import spawn
from dh3d_tpu_torch.parallel.mesh import placement, replicate
from dh3d_tpu_torch.train import trainer
from dh3d_tpu_torch.train.data import real_batches
from dh3d_tpu_torch.train.synthetic import synthetic_batches


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m dh3d_tpu_torch.train")
    p.add_argument("--cfg", required=True,
                   help="basic_config | detection_config | global_config")
    p.add_argument("--logdir", default=None)
    p.add_argument("--load", default=None,
                   help="warm start from FLAX.npz, a CKPT.pt of this "
                        "trainer or its LOGDIR (newest ckpt/step_*.pt): "
                        "partial load by name and shape; fresh optimizer, "
                        "step 0")
    p.add_argument("--resume", default=None,
                   help="checkpoint .pt of this trainer for exact resume")
    p.add_argument("--profile", action="store_true",
                   help="trace steps 10-15 with torch.profiler into "
                        "<logdir>/profile (a Chrome trace)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the model init, the data sampler and the "
                        "pair-generation and augmentation generators")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data_basedir", default=None,
                   help=".bin clouds and oxford_train_{local,global}_gt"
                        ".pickle")
    p.add_argument("--device_pairgen", action="store_true",
                   help="build the self pairs (rotation, FPS anchors, 1-NN "
                        "positives) in the train step")
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_devices", type=int, default=None,
                   help="train data parallel on this many processes, one "
                        "a device (NCCL on CUDA, gloo with --device cpu)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any config key (JSON-parsed value)")
    return p.parse_args(argv)


def build_config(args, log=print):
    cfg = cfglib.get_config(args.cfg)
    for key in ("data_basedir", "num_points", "batch_size"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    if args.device_pairgen:
        cfg.device_pairgen = True
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            cfg[key] = json.loads(value)
        except json.JSONDecodeError:
            cfg[key] = value
        log(f"config override: {key} = {cfg[key]!r}")
    return cfg


def step_generator(base: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded from (base, step): the counterpart
    of `jax.random.fold_in(jax.random.PRNGKey(base), step)`."""
    g = torch.Generator(device=device)
    g.manual_seed((base << 32) | step)
    return g


def profiler(device) -> torch.profiler.profile:
    """`torch.profiler` of the CPU, and of CUDA on a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def write_trace(prof, logdir: str, first: int, last: int) -> str:
    """`prof`'s Chrome trace of steps `first`-`last` in
    `<logdir>/profile/`; returns its path."""
    out = os.path.join(logdir, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_steps_{first}-{last}.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    args = parse_args(argv)
    device = trainer.require_device(args.device)
    args.logdir = args.logdir or os.path.join(
        "train_log", f"{args.cfg}_{time.strftime('%m%d-%H%M%S')}")
    if args.num_devices is None:
        return run(args, device)
    trainer.check_config(build_config(args, log=lambda *a: None))
    placement(args.num_devices, device)  # fewer cards than ranks: raise
    if device.type == "cuda":
        kernels.build()
    return spawn(jobs.train_job, args.num_devices, (args,),
                 device=device.type)[0]


def run(args, device, mesh=None):
    """The training loop of `args` on `device`: one process, or this
    rank of `mesh`, which then writes nothing unless it is rank 0."""
    first = mesh is None or mesh.position == 0
    log = print if first else (lambda *a, **k: None)
    cfg = build_config(args, log)
    trainer.check_config(cfg)
    if not args.synthetic and not cfg.data_basedir:
        raise ValueError("no training data: give --data_basedir DIR (.bin "
                         "clouds and the GT pickle) or --synthetic")

    logdir = args.logdir
    if first:
        os.makedirs(logdir, exist_ok=True)
        cfglib.save_config(cfg, os.path.join(logdir, "config.json"))

    if args.synthetic:
        batches = synthetic_batches(cfg, args.seed)
    else:
        batches = real_batches(cfg, args.seed)
        if (cfg.prefetch or 0) > 0:
            batches = ThreadedPrefetcher(batches, depth=cfg.prefetch,
                                         device=device)

    state = trainer.init_state(cfg, args.seed, device)
    restored = None
    if args.resume:
        trainer.restore_state(args.resume, state)
        log(f"resumed at step {state.step} from {args.resume}")
    elif args.load:
        restored = warm_start(state.model, args.load)
        log(f"warm start: restored {restored} tensors from {args.load}")
    if mesh is not None:
        replicate(state, mesh)
        log(f"mesh: {mesh.size} ranks {mesh.shape}")
    log(f"device: {device}; logdir: {logdir}")

    step_fn = trainer.make_train_step(cfg, mesh)
    every = int(cfg.savemodel_every_k_steps or 0)
    summary = {"restored": restored, "steps": args.steps, "launches": [],
               "profile": None}
    spans = {}  # name: [(start_ns, end_ns, host ms, device ms)]

    def drain(wait):
        for r in trace.records(clear=True, wait=wait):
            spans.setdefault(r["name"], []).append(
                (r["start_ns"], r["end_ns"], r["host_ms"], r["device_ms"]))

    t0 = time.time()
    start = state.step
    counted = step_counters()
    profiling = first and args.profile and args.steps >= 16
    tracing = contextlib.ExitStack()  # stops the profiler, also on a raise
    metrics_log = (open(os.path.join(logdir, "metrics.jsonl"), "a") if first
                   else contextlib.nullcontext())
    with metrics_log as metrics_file, tracing, trace.enabled():
        for i in range(start, start + args.steps):
            with trace.span("step.wait"):
                raw = next(batches)
            before = launches()
            if profiling and i == start + 10:
                prof = tracing.enter_context(profiler(device))
            batch = trainer.to_device(raw, device)
            pairgen = (step_generator(1000 + args.seed, i, device)
                       if "pc1" in batch else None)
            augment = (step_generator(2000 + args.seed, i, device)
                       if cfg.augment_on_device else None)
            metrics = step_fn(state, batch, pairgen, augment)
            after = launches()
            summary["launches"].append(
                {k: after[k] - before[k] for k in after})
            drain(wait=False)
            if profiling and i == start + 15:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                tracing.close()
                summary["profile"] = write_trace(prof, logdir, i - 5, i)
                log(f"profile: {summary['profile']}", flush=True)
            last = i == start + args.steps - 1
            if first and (i % 50 == 0 or last):
                m = {k: round(float(v), 5) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = round(time.time() - t0, 1)
                log(f"step {i}: {json.dumps(m)}", flush=True)
                metrics_file.write(json.dumps(m) + "\n")
                metrics_file.flush()
            if first and ((every and (i + 1) % every == 0) or last):
                path = trainer.save_checkpoint(
                    os.path.join(logdir, "ckpt"), state, i + 1)
                log(f"saved {path}", flush=True)
    drain(wait=True)
    summary["seconds"] = time.time() - t0
    summary["wait_s"] = [h / 1e3 for _, _, h, _ in
                         sorted(spans.get("step.wait", []))]
    steps = sorted(spans.get("step", []))
    summary["step_ms"] = ([d for _, _, _, d in steps]
                          if device.type == "cuda" else None)
    summary["spans"] = span_summary(spans, steps)
    summary["counters"] = {k: n - counted.get(k, 0)
                           for k, n in step_counters().items()}
    summary["metrics"] = ({k: float(v) for k, v in metrics.items()}
                          if args.steps else {})
    return summary


def launches() -> dict:
    """{kernel: launches so far}, from the trace's counters."""
    return {k[len("launches."):]: n for k, n in trace.counters().items()
            if k.startswith("launches.")}


def step_counters() -> dict:
    """{counter: count so far} of the train step's own counters
    (`train.eager_steps`, `train.graph_captures`, `train.graph_replays`)
    and, under `--num_devices`, its collectives' (`collective.calls.<op>`,
    `collective.bytes.<op>`)."""
    return {k: n for k, n in trace.counters().items()
            if k.startswith(("train.", "collective."))}


def span_summary(spans: dict, steps: list) -> dict:
    """{span name: {"count", "in_step", "host_ms", "device_ms"}}: the
    instances recorded, those inside a `step` span (host-time
    containment), and the median ms of an instance on each clock (device
    None off CUDA)."""
    starts = [s for s, _, _, _ in steps]
    out = {}
    for name, recs in spans.items():
        inside = 0
        for s, e, _, _ in recs:
            j = bisect.bisect_right(starts, s) - 1
            inside += j >= 0 and e <= steps[j][1]
        dev = [d for _, _, _, d in recs if d is not None]
        out[name] = {"count": len(recs), "in_step": inside,
                     "host_ms": statistics.median(h for _, _, h, _ in recs),
                     "device_ms": statistics.median(dev) if dev else None}
    return out


if __name__ == "__main__":
    main()
