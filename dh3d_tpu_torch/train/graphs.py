"""A train step's device work as CUDA graphs, captured once and replayed.

Run op by op, a step costs the host more than the device (Python,
autograd and Adam's dispatch), and the device waits for it.  A captured
step is launched as a few graphs instead.

`make_train_step` graphs a step when `eager_reason` finds nothing against
it: the batch on CUDA, no process group or NCCL's alone (gloo runs its
collectives on the host, where a graph cannot hold them), no `remat`
(checkpointing reads the RNG state, which a capture cannot), no Morton
sort in the step (`ops.morton_codes` copies a host scalar), an optimizer
built capturable (`make_optimizer` on CUDA parameters), no module hooks
(Python a replay would skip) and the batch's keys, shapes and dtypes
those of the first batch the step function graphed (`signature`).  A
state's first such step runs eagerly, the warm-up; its second is
captured and then replayed like every later one.  The step's other
batches run eagerly.  Under NCCL every rank captures and replays the
same collectives in the same order; the eager warm-up has made the
communicators the capture needs.

`Recording.capture(fn)` runs `fn` under capture on a side stream, into a
pool that the step's recordings share, and ends one graph and begins the
next wherever `fn` opens or closes a span (`trace.cutting`).  `replay()`
launches the graphs in order between the same spans, so every span times
the same stretch of device work as in an eager step, and adds to the
kernels' launch counts what each graph's capture launched (the capture
itself runs nothing and counts nothing), and to the trace's counters what
each counted (`collective.*`).  Collectives that a captured backward
issues from autograd's thread stay inside the backward's graph: their
spans do not open on replay, their counts do.

A `StepGraph` holds one state's recordings: `prepare` (the batch's
preparation) and `body` (forward, losses, the CSR inverses that the
backward reads, backward, and the update, whose learning rate is a device
tensor filled before each replay), the static buffers each batch is
copied into, and the static outputs (the metrics, returned as clones).
It lives on the `TrainState` and holds while the state's tensors are
updated in place; `trainer.restore_state` drops it.
"""

from __future__ import annotations

import warnings

import torch
from torch.nn.modules import module as _module
from torch.utils import _pytree as pytree

from dh3d_tpu_torch import kernels, trace
from dh3d_tpu_torch.parallel.collectives import backends

HOOKS = "module hooks"


def signature(batch: dict) -> tuple:
    """What a batch's graphs depend on: its structure (dict keys, list
    and tuple lengths, other values as they are) and each tensor's shape,
    dtype and device."""
    leaves, spec = pytree.tree_flatten(batch)
    return spec, tuple((tuple(x.shape), x.dtype, x.device)
                       if torch.is_tensor(x) else x for x in leaves)


def hooked(model: torch.nn.Module) -> bool:
    """True when a forward or backward hook would run in `model`'s call:
    one of its modules' own, or a global one."""
    if (_module._global_forward_hooks or _module._global_forward_pre_hooks
            or _module._global_backward_hooks
            or _module._global_backward_pre_hooks):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in model.modules())


def eager_reason(state, cfg, group, batch: dict, sig, first) -> str | None:
    """Why the step on `batch` (with its draws; `sig` its signature) runs
    eagerly, or None when its CUDA graphs may run it.  `first`: the
    signature the step function graphs (None before it has one).
    `HOOKS` alone lets the step count as the warm-up.  A group whose
    collectives a graph can hold is NCCL's; another backend is named
    ("gloo collectives"), and an object that is no process group keeps
    the step eager as "data parallel"."""
    if group is not None:
        names = backends(group)
        if None in names:
            return "data parallel"
        other = [b for b in names if "nccl" not in b]
        if other:
            return f"{other[0]} collectives"
    if cfg.remat:
        return "remat"
    model_cfg = getattr(state.model, "cfg", cfg)  # what the forward reads
    if model_cfg.morton_order and not model_cfg.morton_presorted:
        return "Morton sort in the step"
    if first is not None and sig != first:
        return "another batch signature"
    ts = [x for x in pytree.tree_leaves(batch) if torch.is_tensor(x)]
    if not ts or not all(t.is_cuda for t in ts):
        return "not on CUDA"
    if not all(g.get("capturable") and torch.is_tensor(g["lr"])
               for g in state.optimizer.param_groups):
        return "optimizer not capturable"
    if hooked(state.model):
        return HOOKS
    return None


def _added(now: dict, before: dict) -> dict:
    """{name: now - before} of the counts that moved."""
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


class Recording:
    """Device work captured as CUDA graphs cut at its spans (module
    docstring).  `items`: ("graph", graph, launches, counted), ("open",
    span name, device) and ("close",), in order; `counted` the trace's
    counters the graph's capture added; graph None where the capture was
    empty but counted something."""

    def __init__(self, pool, stream: torch.cuda.Stream):
        self.pool, self.stream = pool, stream
        self.items = []
        self.empty = []  # kept: the pool lives while a graph captured in it
        self._graph = self._before = None

    def capture(self, fn):
        """fn()'s result, every tensor of it static: written by each
        replay."""
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream), trace.cutting(self._cut):
            self._begin()
            try:
                out = fn()
            finally:
                self._end()
        torch.cuda.current_stream().wait_stream(self.stream)
        return out

    def _cut(self, name, device):
        self._end()
        self.items.append(("open", name, device) if name else ("close",))
        self._begin()

    def _begin(self):
        self._before = kernels.counts(), trace.tally()
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _end(self):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self._graph.capture_end()
        launched = _added(kernels.counts(), self._before[0])
        counted = _added(trace.tally(), self._before[1])
        kernels.add_counts({k: -n for k, n in launched.items()})
        trace.add({k: -n for k, n in counted.items()})
        graph = self._graph
        if any("empty" in str(w.message) for w in caught):
            # a collective over one rank launches nothing: keep its counts
            self.empty.append(graph)
            graph = None
        if graph is not None or launched or counted:
            self.items.append(("graph", graph, launched, counted))
        self._graph = None

    def replay(self):
        opened = []
        for item in self.items:
            if item[0] == "graph":
                if item[1] is not None:
                    item[1].replay()
                if item[2]:
                    kernels.add_counts(item[2])
                if item[3]:
                    trace.add(item[3])
            elif item[0] == "open":
                opened.append(trace.span(item[1], item[2]))
                opened[-1].__enter__()
            else:
                opened.pop().__exit__(None, None, None)


class StepGraph:
    """One state's train step as CUDA graphs (module docstring).  `owner`
    is the step function that made it; `built` lists by position, among
    the `NeighborInverse` holders a step makes (`holders` of them), those
    whose inverse the eager backward built (None until the warm-up)."""

    def __init__(self, owner):
        self.owner = owner
        self.built = self.holders = None
        self.prepare = self.body = None

    def capture(self, batch: dict, prepare, body, params: list) -> None:
        """Capture prepare(batch) -> the model's batch, then body(that
        batch) -> metrics, on static copies of `batch`'s tensors; nothing
        runs.  `params`' gradients, made by the capture, stay theirs."""
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream()
        leaves, spec = pytree.tree_flatten(batch)
        self.inputs = [x.clone() if torch.is_tensor(x) else x
                       for x in leaves]
        static = pytree.tree_unflatten(self.inputs, spec)
        self.prepare, self.body = Recording(pool, stream), Recording(pool,
                                                                     stream)
        self.prepared = self.prepare.capture(lambda: prepare(static))
        metrics = self.body.capture(lambda: body(self.prepared))
        # detached: a graph kept alive by the outputs would keep its
        # AccumulateGrad nodes, on the capture's stream, for eager steps
        self.metrics = {k: v.detach() if torch.is_tensor(v) else v
                        for k, v in metrics.items()}
        self.grads = [(p, p.grad) for p in params]

    def replay_prepare(self, batch: dict) -> None:
        for s, x in zip(self.inputs, pytree.tree_leaves(batch)):
            if torch.is_tensor(x):
                s.copy_(x)
        self.prepare.replay()

    def replay_body(self) -> dict:
        """The metrics of a replay of `body`, cloned."""
        for p, g in self.grads:
            if p.grad is not g:  # an eager step of another batch since
                p.grad = g
        self.body.replay()
        return {k: v.clone() if torch.is_tensor(v) else torch.as_tensor(v)
                for k, v in self.metrics.items()}
