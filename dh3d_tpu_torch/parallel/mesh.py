"""Process meshes for data-parallel training: the counterpart of
`dh3d_tpu/parallel/mesh.py:30-113`.

The JAX package runs one global-view program over a mesh of devices.  Here
every device is a process of its own, joined by `torch.distributed`: rank
r of n holds the r-th contiguous block of the batch, runs the step on it,
and the collectives of `parallel.collectives` (all built from
`all_reduce`) join the ranks where the global view needs the whole batch.

  data_parallel_mesh(n)      a 1-D `data` mesh over the n processes
  multihost_mesh(s, p)       a 2-axis ("dcn", "data") mesh: s groups of p
                             ranks; reductions run inside `data` first,
                             then across `dcn` (hierarchical)
  shard_batch(batch, mesh)   this rank's block of the batch
  replicate(state, mesh)     rank 0's parameters, buffers and Adam state on
                             every rank

A mesh's process group is made from a file store (`store`, a path that
does not exist yet; no TCP port, so concurrent runs cannot collide).  The
backend is NCCL for CUDA and gloo for the CPU.  On CUDA under NCCL rank r
sits on `cuda:r`, and asking for more ranks than there are cards raises
(as the JAX mesh raises for more devices than it has).  gloo also runs on
CUDA tensors: `backend="gloo"` places rank r on `cuda:(r % cards)`, which
lets ranks share one card, a placement for checking the collectives on a
machine with one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import warnings

import torch
import torch.distributed as dist

from dh3d_tpu_torch.parallel.collectives import position, reduce_, size

# how long a rank waits in a collective for the others before it fails
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: the axis names and sizes (outermost
    first, as JAX's), its process group along each axis (innermost
    first: the order `parallel.collectives` reduces in) and its device.
    Pass it as the `group` of the collectives, `BatchNorm`, the losses,
    `knn_sharded` and `make_train_step`."""

    axis_names: tuple
    shape: dict
    groups: tuple
    device: torch.device

    @property
    def size(self) -> int:
        return size(self)

    @property
    def position(self) -> int:
        """This rank's block of the batch."""
        return position(self)


def placement(n: int, device="cuda", backend: str | None = None):
    """(backend, [the device of each of n ranks]) for ranks on `device`'s
    type: NCCL and `cuda:r` by default on CUDA, raising ValueError when
    n exceeds the cards; gloo on the CPU (and, when asked for, on CUDA,
    rank r on `cuda:(r % cards)`)."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: use gloo")
        return backend, [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"no process mesh on {kind}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("device cuda, but torch.cuda.device_count() is 0")
    if backend == "nccl" and n > cards:
        raise ValueError(f"requested {n} devices, have {cards}")
    return backend, [torch.device("cuda", r % cards) for r in range(n)]


def _join(n: int, rank, store, device, backend) -> torch.device:
    """Join (or check) the default process group of n ranks; returns this
    rank's device."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a mesh of {n} ranks in a process group of "
                             f"{dist.get_world_size()}")
        backend = backend or dist.get_backend()
        rank = dist.get_rank()
    elif rank is None or store is None:
        raise ValueError("no process group yet: give rank and store")
    backend, devices = placement(n, device, backend)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n, timeout=TIMEOUT)
    return dev


def data_parallel_mesh(n_devices: int, *, rank: int | None = None,
                       store: str | None = None, device="cuda",
                       backend: str | None = None) -> Mesh:
    """A 1-D `data` mesh over all n_devices processes.  The first call of
    a process (with its `rank` and the shared `store` path) makes the
    process group; later calls reuse it."""
    dev = _join(n_devices, rank, store, device, backend)
    return Mesh(("data",), {"data": n_devices}, (dist.group.WORLD,), dev)


def multihost_mesh(n_slices: int, per_slice: int, *, rank: int | None = None,
                   store: str | None = None, device="cuda",
                   backend: str | None = None) -> Mesh:
    """A 2-axis ("dcn", "data") mesh: n_slices groups of per_slice ranks,
    rank r in slice r // per_slice.  The batch shards over the product of
    both axes (rank order); every reduction runs inside the slice (`data`)
    first, then across slices (`dcn`).  Every rank makes every subgroup,
    in the same order, as `torch.distributed.new_group` needs."""
    n = n_slices * per_slice
    dev = _join(n, rank, store, device, backend)
    me = dist.get_rank()
    data = dcn = None
    for s in range(n_slices):
        g = dist.new_group([s * per_slice + d for d in range(per_slice)])
        if me // per_slice == s:
            data = g
    for d in range(per_slice):
        g = dist.new_group([s * per_slice + d for s in range(n_slices)])
        if me % per_slice == d:
            dcn = g
    return Mesh(("dcn", "data"), {"dcn": n_slices, "data": per_slice},
                (data, dcn), dev)


def shard_batch(batch, mesh, pairs: int | None = None):
    """This rank's block of `batch` (a dict, or nested lists and tuples, of
    tensors), on the mesh's device: the contiguous block of every tensor
    whose leading axis divides the mesh (JAX's rule); any other tensor
    stays whole, with a warning when no tensor divides (the whole batch is
    then worked on by every rank).

    `pairs`: a local batch's pair count B.  Its tensors of 2B rows hold the
    B first copies, then the B second copies (points [pc1; pc2], their
    sample_inds, the augmentation draws of both): those shard by pairs,
    each rank keeping both copies of its pairs in the same layout ([its
    pc1; its pc2]), so that a pair's two clouds stay on one rank."""
    n, r = mesh.size, mesh.position

    def divisible(x):
        return torch.is_tensor(x) and x.dim() > 0 and x.shape[0] % n == 0

    def leaves(x):
        if isinstance(x, dict):
            return [v for item in x.values() for v in leaves(item)]
        if isinstance(x, (list, tuple)):
            return [v for item in x for v in leaves(item)]
        return [x] if torch.is_tensor(x) else []

    if n > 1 and not any(map(divisible, leaves(batch))):
        shapes = [tuple(x.shape) for x in leaves(batch)]
        warnings.warn(
            f"shard_batch: no tensor in the batch has a leading axis "
            f"divisible by the {n}-rank mesh (shapes {shapes}); the whole "
            f"batch is REPLICATED and every rank does the full-batch work. "
            f"Choose batch_size*tuple_size divisible by {n}.", stacklevel=2)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if not torch.is_tensor(x):
            return x
        if pairs and x.dim() > 0 and x.shape[0] == 2 * pairs \
                and pairs % n == 0:
            b = pairs // n
            x = x.reshape(2, pairs, *x.shape[1:])[:, r * b:(r + 1) * b]
            x = x.reshape(2 * b, *x.shape[2:])
        elif divisible(x):
            rows = x.shape[0] // n
            x = x[r * rows:(r + 1) * rows]
        return x.to(mesh.device).contiguous()

    return take(batch)


def replicate(state, mesh) -> None:
    """Rank 0's model (parameters and buffers), Adam state and step count
    on every rank of `mesh`, in place (`state`: a `train.TrainState`).
    A broadcast built from `all_reduce`: every other rank adds zeros."""
    model, opt = state.model, state.optimizer
    tensors = [*model.parameters(), *model.buffers()]
    for p in model.parameters():
        tensors += [v for v in opt.state.get(p, {}).values()
                    if torch.is_tensor(v)]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    first = mesh.position == 0
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1).to(mesh.device)
                              for t in ts])
            if not first:
                flat.zero_()
            reduce_(flat, mesh)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))
    step = torch.tensor([state.step if first else 0], dtype=torch.int64,
                        device=mesh.device)
    state.step = int(reduce_(step, mesh).item())
