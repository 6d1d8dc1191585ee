"""One process a rank: `spawn(fn, n, args)` runs `fn(mesh, *args)` on n
new processes joined into a `data_parallel_mesh` and returns their results.

The processes start with the `spawn` method (a fresh interpreter that
imports `fn`'s module, never jax), share a file store in a temporary
directory, and hand their results back as `torch.save` files there.  If a
rank raises, the others are stopped and `spawn` raises with its
traceback.  CPU ranks use one thread each, so that n ranks (times the test
workers) do not oversubscribe the cores.  `fn` must be a module-level
function (it is pickled by name); `parallel.jobs` holds the port's.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dh3d_tpu_torch.parallel.mesh import data_parallel_mesh, placement


def _rank(rank, n, work, fn, args, device, backend):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = data_parallel_mesh(n, rank=rank, store=os.path.join(work, "store"),
                              device=device, backend=backend)
    try:
        out = fn(mesh, *args)
        path = os.path.join(work, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, args=(), *, device="cpu",
          backend: str | None = None) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank n - 1], each run in its own
    process on `device`'s type (`mesh.placement`: NCCL and `cuda:r` on
    CUDA unless `backend` says gloo; raises before starting any process
    when there are fewer cards than NCCL ranks).  Results hold tensors on
    the CPU and Python values."""
    placement(n, device, backend)
    with tempfile.TemporaryDirectory(prefix="dh3d_ranks_") as work:
        mp.start_processes(_rank, args=(n, work, fn, tuple(args),
                                        str(device), backend),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=True) for r in range(n)]
