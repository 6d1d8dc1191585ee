"""A data-parallel stage-2 training step, stated as what it must equal:
one process's step (`train.train`) on the global batch.

n ranks each take a block of a step's pairs (rank r the r-th block, every
rank's block of one size).  The semantics the ranks must keep together:
  - the batch is the ranks' blocks in rank order: the pairs' first
    clouds of all ranks, then their second clouds (`train.pairs` stacks
    [pc1; rotated pc2] of the global batch), the draws of each pair with
    it;
  - BatchNorm normalises by the global batch's statistics, and the
    running statistics move by them;
  - the loss is the loss of the global batch, and the update follows its
    gradient (the mean over ranks of each rank's gradient of the same
    loss, which is that gradient).
So the step is `train.train` on the blocks put together (`global_batch`).

Departures, for memory alone, at 128 pairs of 8192 points (256 clouds)
on one 80 GB card; neither changes a bit of the result:
  - `geometry.knn` keeps every chunk's whole sorted distances and ids
    alive (the first k of each are views) until it joins them: 0.8 GB a
    cloud for a self search at 8192 points, 200 GB for the batch.  So
    every neighbour search runs one cloud at a time (`knn_by_cloud`); a
    row's search reads its own cloud alone, so each row comes out the
    same.
  - The tensors autograd keeps for the backward take ~69 GB.  So the
    network runs with its blocks checkpointed (`CheckpointedNet`: each
    backbone level, flex conv, squeeze-excite and 1x1 block), their inner
    tensors recomputed in the backward from their inputs
    (`torch.utils.checkpoint`, non-reentrant).  The forward writes nothing
    it reads (it returns the moved statistics), its operations are
    deterministic and the neighbour searches lie outside the blocks, so
    the recomputed tensors equal the first ones bit for bit.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry
from benchmark.reference import model as M
from benchmark.reference import train as ref_train


def global_batch(blocks: list) -> dict:
    """The ranks' blocks of one step ([{pc1, pc2, angles, subsets}], rank
    order) as one process's batch: each key's blocks concatenated."""
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def knn_by_cloud(query, keys, k: int):
    """`geometry.knn` of each cloud of the batch on its own, joined."""
    parts = [geometry.knn(query[b:b + 1], keys[b:b + 1], k)
             for b in range(query.shape[0])]
    return tuple(torch.cat(t) for t in zip(*parts))


def _recomputed(method):
    def run(self, *args, **kwargs):
        return checkpoint(method, self, *args, use_reentrant=False,
                          **kwargs)
    return run


class CheckpointedNet(M.Net):
    """`model.Net` with every backbone level, flex conv, squeeze-excite
    and 1x1 block recomputed in the backward (module docstring)."""

    stage = _recomputed(M.Net.stage)
    flexconv = _recomputed(M.Net.flexconv)
    se = _recomputed(M.Net.se)
    conv1x1 = _recomputed(M.Net.conv1x1)


@contextlib.contextmanager
def in_blocks():
    """While entered, the reference's forward builds a `CheckpointedNet`
    and its model and losses search neighbours by cloud."""
    swaps = [(M, "Net", CheckpointedNet), (M, "knn", knn_by_cloud),
             (ref_train, "knn", knn_by_cloud)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, new in swaps:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in kept:
            setattr(mod, name, old)


def train(cfg, weights: dict, steps: list) -> dict:
    """Run `steps` (for each step the ranks' blocks, [[{pc1, pc2, angles,
    subsets}]], clouds unsorted) from `weights` as the one-process steps
    on their global batches.  Returns what `train.train` returns: losses,
    grad0, params and stats after the last step."""
    with in_blocks():
        return ref_train.train(cfg, weights,
                               [global_batch(blocks) for blocks in steps])
