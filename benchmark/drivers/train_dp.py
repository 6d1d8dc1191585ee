"""Data-parallel training steps: the stage-2 step over ranks, one card a
rank, closed loop.

Traffic parameters: as the `train` driver's (pool, scan_extent,
calibrate, schedule, ref_steps, profile_units).  The configuration's
`num_devices` is the number of ranks, its `batch_size` the pairs of a
step over all of them (each rank's block: batch_size / num_devices).

Rank 0 runs in this process on `device`, so that the run's profiler,
spans and peak memory see it; ranks 1 .. n - 1 are started here (spawn),
rank r on `cuda:r` under NCCL, or under gloo when `device` is the CPU.
Rank 0 makes the pool (as the `train` driver: two jittered copies of
each scan, Z-order sorted by the program's loader function), the
schedule and the weights, and hands them to the others (a broadcast);
each rank draws every step's pair-generation draws from a generator
seeded alike.  Every rank passes the whole batch of the step with its
draws to the program's data-parallel step (`trainer.make_train_step(cfg,
mesh)` over `parallel.data_parallel_mesh`), which keeps the rank's block,
as the train CLI's ranks do.  A gloo group on the host carries rank 0's
commands (a step, a barrier, the end).  The window opens and closes on a
barrier once every rank's device is idle; it reads the clouds of all
ranks over rank 0's window, and the trace's counters (rank 0's) that the
window's steps added (`counters`).

Compared, as the `train` driver compares, against
`benchmark/reference/train_dp.py` on the ranks' blocks (the one-process
step on the global batch): the first step's loss, the first gradient,
the change after the reference's steps, the BatchNorm statistics; and
`rank_gap`, the largest difference between ranks of any parameter or
statistic after those steps (every rank must hold one state).

Faults planted in the program's ranks (`Run(..., fault=name)`): `bn`,
every rank normalises by its own block's statistics (sync BatchNorm
off); `sum`, the gradients summed over the ranks and not averaged;
`swap`, ranks 1 and 2 each take the other's block of the step's clouds
with their own draws.  `benchmark.control` takes `fault_bn()` and, as
the `train` driver's, `fault_half()`: the reference in the program's
place on the first half of each rank's block.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from benchmark import counts, dp_counts
from benchmark.drivers import common
from benchmark.drivers import train as train_driver
from benchmark.harness import log, stamp, sub_seed
from benchmark.reference import train_dp as ref_dp
from benchmark.scans import scans
from benchmark.weights import calibrate, make_weights

STEP, SYNC, STOP = 0, 1, 2
B1 = train_driver.B1


def plant(fault: str | None):
    """Plant `fault` ("bn", "sum"; module docstring) in the program in
    this process; returns a function that takes it out again."""
    if fault not in ("bn", "sum"):
        return lambda: None
    from dh3d_tpu_torch.train import trainer

    name = {"bn": "sync_batchnorm", "sum": "reduce_gradients"}[fault]
    real = getattr(trainer, name)
    if fault == "bn":
        def unsynced(module, group):
            real(module, None)
        setattr(trainer, name, unsynced)
    else:
        from dh3d_tpu_torch.parallel.collectives import reduce_

        def summed(params, group):
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            reduce_(flat, group)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        setattr(trainer, name, summed)
    return lambda: setattr(trainer, name, real)


def trace_counters() -> dict:
    """The program's counters (`trace.counters()`), or none where the
    program has no such function."""
    try:
        from dh3d_tpu_torch import trace

        return trace.counters()
    except (ImportError, AttributeError):
        return {}


def pool(cell, seed: int, device) -> tuple:
    """Rank 0's inputs: (two jittered copies of each scan of the pool [2,
    pool, N, 3], the same Z-order sorted, the schedule [schedule,
    batch_size] of pool indices, the calibrated weights)."""
    from dh3d_tpu_torch.data.io import morton_sort_np

    t, cfg = cell["traffic"], cell["cfg"]
    N = cfg["num_points"]
    gen = common.generator(device, seed, "scans")
    clouds = scans(t["pool"], N, gen, t["scan_extent"])
    noise = torch.randn(2, *clouds.shape, generator=gen, device=device)
    raw = clouds[None] + torch.clamp(0.05 * noise, -0.1, 0.1)
    srt = torch.from_numpy(morton_sort_np(raw.reshape(-1, N, 3).cpu().numpy(
    ))).to(device).reshape(raw.shape)
    schedule = torch.argsort(torch.rand(
        t["schedule"], t["pool"], generator=gen, device=device),
        dim=1)[:, :cfg["batch_size"]].contiguous()
    w = make_weights(cfg, sub_seed(seed, "weights"), device)
    return raw, srt, schedule, calibrate(cfg, w, srt[0, :t["calibrate"]])


def draws(gen: torch.Generator, cfg) -> tuple:
    """A step's pair-generation draws for batch_size pairs: (angles,
    subsets), as the `train` driver makes them."""
    B, N, dev = cfg["batch_size"], cfg["num_points"], gen.device
    angles = (torch.rand(B, generator=gen, device=dev) * 2 - 1) \
        * cfg["rot_maxv"]
    subsets = torch.argsort(torch.rand(B, N, generator=gen, device=dev),
                            dim=1)[:, :N // 2]
    return angles, subsets


def blocks(B: int, n: int) -> list:
    """Each rank's slice of a step's B pairs, in rank order."""
    return [slice(r * (B // n), (r + 1) * (B // n)) for r in range(n)]


def reference_steps(raw, schedule, angles_subsets: list, n: int) -> list:
    """The reference's steps: for each step (its schedule row and draws)
    the ranks' blocks of raw clouds and draws."""
    out = []
    for idx, (angles, subsets) in zip(schedule, angles_subsets):
        out.append([{"pc1": raw[0, idx[b]], "pc2": raw[1, idx[b]],
                     "angles": angles[b], "subsets": subsets[b]}
                    for b in blocks(len(idx), n)])
    return out


class Rank:
    """One rank's share of the cell, rank 0's included: its mesh, the
    inputs, the program's state and step, the reference's steps."""

    def __init__(self, cell, seed: int, rank: int, n: int, device: str,
                 store: str, fault: str | None):
        from dh3d_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                                  replicate)
        from dh3d_tpu_torch.train import (TrainState, make_optimizer,
                                          make_train_step)

        t = cell["traffic"]
        self.cfg = cfg = common.port_cfg(cell["cfg"])
        self.rank, self.n, self.fault = rank, n, fault
        self.B, self.N = cfg.batch_size, cfg.num_points
        if self.B % n:
            raise ValueError(f"{self.B} pairs do not divide over {n} ranks")
        self.mesh = data_parallel_mesh(n, rank=rank, store=store,
                                       device=device)
        self.ctl = dist.new_group(backend="gloo")
        self.device = dev = self.mesh.device
        if rank == 0:
            self.raw, self.sorted, self.schedule, w = pool(cell, seed, dev)
            stamp("scans made and sorted, weights made and calibrated")
        else:  # rank 0's, by the broadcast below and `replicate`
            self.raw = torch.empty(2, t["pool"], self.N, 3, device=dev)
            self.sorted = torch.empty_like(self.raw)
            self.schedule = torch.empty(t["schedule"], self.B,
                                        dtype=torch.int64, device=dev)
            w = make_weights(cfg, sub_seed(seed, "weights"), dev)
        for x in (self.raw, self.sorted, self.schedule):
            dist.broadcast(x, 0)
        self.weights = w
        self.undo = plant(fault)
        model = common.port_model(cfg, w, dev)
        self.state = TrainState(model, make_optimizer(cfg, model))
        replicate(self.state, self.mesh)  # rank 0's weights everywhere
        self.step_fn = make_train_step(cfg, self.mesh)
        self.draws = common.generator(dev, seed, "draws")

        # the first steps, which the reference follows (and which warm up
        # the step: the first eager, the second captured where it may be)
        taken, losses = [], []
        names = [nm for nm, _ in model.named_parameters()]
        for s in range(t["ref_steps"]):
            batch = self.batch(s)
            taken.append(batch["pairgen_draws"])
            losses.append(self.step_fn(self.state, batch)["total_cost"])
            if s == 0:
                opt, params = self.state.optimizer, dict(
                    model.named_parameters())
                self.grad0 = {
                    nm: opt.state[params[nm]].get(
                        "exp_avg", torch.zeros_like(params[nm])) / (1 - B1)
                    for nm in names}
        self.ref_inputs = reference_steps(self.raw, self.schedule, taken, n)
        self.losses = [float(v) for v in losses]
        self.after = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        flat = torch.cat([v.detach().double().reshape(-1)
                          for v in self.after.values()])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, dist.ReduceOp.MAX)
        dist.all_reduce(lo, dist.ReduceOp.MIN)
        self.rank_gap = float((hi - lo).max())
        common.sync(dev)

    def batch(self, i: int) -> dict:
        """Step i's whole batch with its draws (`train` driver's form)."""
        idx = self.schedule[i % len(self.schedule)]
        if self.fault == "swap" and self.rank in (1, 2):
            b = blocks(self.B, self.n)
            idx = idx.clone()
            idx[b[1]], idx[b[2]] = idx[b[2]].clone(), idx[b[1]].clone()
        return {"pc1": self.sorted[0, idx], "pc2": self.sorted[1, idx],
                "pairgen_draws": draws(self.draws, self.cfg)}

    def step(self, i: int):
        self.step_fn(self.state, self.batch(i))

    def barrier(self):
        """Wait for this rank's device, then for every rank."""
        common.sync(self.device)
        dist.barrier(group=self.ctl)

    def serve(self):
        """Ranks 1 .. n - 1: run rank 0's commands until the end."""
        cmd = torch.zeros(2, dtype=torch.int64)
        while True:
            dist.broadcast(cmd, 0, group=self.ctl)
            op, i = cmd.tolist()
            if op == STEP:
                self.step(i)
            elif op == SYNC:
                self.barrier()
            else:
                break
        self.close()

    def command(self, op: int, i: int = 0):
        """Rank 0: send a command to the other ranks."""
        dist.broadcast(torch.tensor([op, i]), 0, group=self.ctl)

    def close(self):
        del self.state, self.step_fn
        self.undo()
        common.sync(self.device)
        dist.destroy_process_group()


def _rank_main(cell, seed, rank, n, device, store, fault):
    """A started rank's process."""
    if device == "cpu":
        torch.set_num_threads(1)
    Rank(cell, seed, rank, n, device, store, fault).serve()


class Run(train_driver.Run):
    """The cell on rank 0 (module docstring); the comparison is the
    `train` driver's (`compare`), with the reference on the ranks'
    blocks."""

    def __init__(self, cell, seed: int, device, trace: bool = False,
                 fault: str | None = None):
        self.cell, self.seed = cell, seed
        self.limits = cell["limits"]
        self.cfg = cfg = common.port_cfg(cell["cfg"])
        self.device = torch.device(device)
        self.n = n = int(cfg.num_devices)
        self.B, self.N = cfg.batch_size, cfg.num_points
        self.profile_units = cell["traffic"]["profile_units"]
        self.work = tempfile.mkdtemp(prefix="dh3d_dp_")
        store = os.path.join(self.work, "store")
        kind = self.device.type
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            cell, seed, r, n, kind, store, fault)) for r in range(1, n)]
        for p in self.procs:
            p.start()
        self.released = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()
        self.me = Rank(cell, seed, 0, n, kind, store, fault)
        self.device = self.me.device
        self.weights, self.ref_inputs = self.me.weights, self.me.ref_inputs
        self.losses, self.grad0 = self.me.losses, self.me.grad0
        self.after, self.rank_gap = self.me.after, self.me.rank_gap
        self.i = len(self.ref_inputs)
        stamp(f"{n} ranks set up, the reference's steps run (warmed up)")

    def _watch(self):
        """Stop this process when a started rank dies before the end: the
        others would wait in a collective for it."""
        while not self.released.wait(0.5):
            for p in self.procs:
                if p.exitcode not in (None, 0):
                    log(f"train_dp: rank process {p.name} exited with "
                        f"{p.exitcode}; stopping")
                    os._exit(1)

    def unit(self):
        self.me.command(STEP, self.i)
        self.me.step(self.i)
        self.i += 1

    def sync_all(self):
        self.me.command(SYNC)
        self.me.barrier()

    def window(self, seconds: float) -> dict:
        self.sync_all()
        before = trace_counters()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.unit()
            n += 1
        self.sync_all()
        s = time.perf_counter() - t0
        after = trace_counters()
        clouds = n * 2 * self.B
        return {"attempted": clouds, "failed": 0, "units": n, "seconds": s,
                "values": {"clouds_per_s": clouds / s},
                "counters": {k: v - before.get(k, 0)
                             for k, v in after.items()}}

    def counts(self) -> dict:
        """A card's share of a step's model FLOPs (the global batch's,
        each counted once, over the ranks) and its collectives' bus bytes
        a rank; the kernel bound of a rank's block."""
        return {"flops_per_unit": counts.train_flops(self.cfg, self.B,
                                                     self.N) / self.n,
                "bound_s_per_unit": counts.train_bound_s(
                    self.cfg, self.B // self.n, self.N),
                "bus_bytes_per_unit": dp_counts.stage2_step_bus_bytes(
                    self.cfg, self.B, self.N, self.n)}

    def release(self):
        if self.released.is_set():
            return
        self.me.command(STOP)
        self.released.set()
        self.me.close()
        del self.me
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():  # done with the work, stuck in its teardown
                log(f"train_dp: rank process {p.name} did not exit; "
                    f"stopping it")
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self.work, ignore_errors=True)
        bad = [p.exitcode for p in self.procs if (p.exitcode or 0) > 0]
        if bad:
            raise RuntimeError(f"rank processes exited with {bad}")
        common.free(self.device)

    def reference_side(self, half: bool = False) -> dict:
        """The plain reference's steps on the ranks' blocks (`half`: on
        the first half of each), as the `train` driver's."""
        steps = self.ref_inputs
        if half:
            steps = [[{k: v[:len(v) // 2] for k, v in blk.items()}
                      for blk in blocks] for blocks in steps]
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        r = ref_dp.train(self.cfg, self.weights, steps)
        if cuda:
            log(f"train_dp: reference {time.perf_counter() - t0:.1f} s, "
                f"peak {torch.cuda.max_memory_allocated(self.device)} B")
        return {"losses": r["losses"], "grad0": r["grad0"],
                "after": {**r["params"], **r["stats"]}}

    def check(self) -> list:
        return super().check() + [
            ("rank_gap", self.rank_gap, self.limits["rank_gap"]["limit"])]

    def fault_bn(self) -> list:
        """A planted fault: the program's ref steps again, on new ranks,
        with sync BatchNorm off."""
        run = Run(self.cell, self.seed, self.device.type, fault="bn")
        run.release()
        return run.check()
