"""Collectives with autograd, built from `all_reduce` alone.

A `group` here is None (one process: every function returns its input
as it is), a `torch.distributed` process group, or an object with a
`groups` attribute (`parallel.mesh.Mesh`): a tuple of process groups
reduced in turn, innermost axis first, which is the hierarchical reduction
of a 2-axis mesh (inside `data`, then across `dcn`).  The ranks of a group
are ordered as the batch shards over them: `position(group)` of
`size(group)`.  In a group of one the collectives still run and return
their input's values.

  all_reduce  the sum over the group; its backward all-reduces the
              gradient (the adjoint of a sum to every rank).
  all_gather  the ranks' blocks concatenated along `dim` in rank order:
              each rank writes its block into a zeroed buffer, which is
              then all-reduced (adding zeros is exact).  Its backward sums
              the gradient over the ranks and keeps the rank's own block.

Both need no collective but `all_reduce`, so they run the same on gloo
CPU tensors, gloo CUDA tensors and NCCL.  Each all-reduce issued counts
in the trace's counters `collective.calls.<op>` and
`collective.bytes.<op>` (the bytes handed to the backend), `<op>` the
collective it serves.  With these adjoints, a backward
that every rank runs from its own copy of one loss differentiates the sum
of the ranks' losses: n times the loss when every rank computes the same
one (`train.trainer` divides the reduced gradients by n).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dh3d_tpu_torch import trace


def groups_of(group) -> tuple:
    """The process groups `group` reduces over, in order (() for None)."""
    if group is None:
        return ()
    if isinstance(group, str):  # a JAX axis name, bound to nothing here
        raise NameError(f"unbound axis name: {group!r}; pass the process "
                        "group (or parallel.Mesh) it stands for")
    return tuple(getattr(group, "groups", (group,)))


def size(group) -> int:
    """The number of ranks of `group` (1 for None)."""
    n = 1
    for g in groups_of(group):
        n *= dist.get_world_size(g)
    return n


def position(group) -> int:
    """This rank's place in `group`'s batch order (0 for None): the
    innermost axis varies fastest."""
    pos, stride = 0, 1
    for g in groups_of(group):
        pos += dist.get_rank(g) * stride
        stride *= dist.get_world_size(g)
    return pos


def backends(group) -> tuple:
    """The backend of each of `group`'s process groups (`groups_of`):
    "nccl", "gloo", ..., or None for an object that is no process group
    of torch.distributed."""
    out = []
    for g in groups_of(group):
        try:
            out.append(str(dist.get_backend(g)))
        except ValueError:  # not in the world's map of groups
            out.append(None)
    return tuple(out)


def reduce_(t: torch.Tensor, group, op: str = "all_reduce") -> torch.Tensor:
    """Sum the contiguous tensor `t` over `group` in place, without
    autograd; returns it.  Span `collective.<op>`: the collective it
    serves; counters `collective.calls.<op>` and `collective.bytes.<op>`
    a process group reduced over."""
    with trace.span(f"collective.{op}", t):
        for g in groups_of(group):
            dist.all_reduce(t, group=g)
            trace.count(f"collective.calls.{op}")
            trace.count(f"collective.bytes.{op}",
                        t.numel() * t.element_size())
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return reduce_(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rows, at = x.shape[0], position(group) * x.shape[0]
        ctx.group, ctx.block = group, slice(at, at + rows)
        out = x.new_zeros((size(group) * rows, *x.shape[1:]))
        out[ctx.block] = x
        return reduce_(out, group, "all_gather")

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return reduce_(grad, ctx.group, "all_gather")[ctx.block], None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over `group`, differentiable."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (all of one shape) concatenated along `dim` in rank
    order, differentiable."""
    if group is None:
        return x
    return _AllGather.apply(x.movedim(dim, 0), group).movedim(0, dim)
