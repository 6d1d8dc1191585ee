"""What a data-parallel stage-2 step's collectives must move, counted from
the configuration's shapes: the bytes a rank sends over NVLink for the
collectives the step's semantics need, whatever implements them.

With n ranks, a collective over S bytes (the whole tensor) sends from each
rank (ring algorithms, the least for these collectives):
  all-reduce      2 (n - 1) / n * S
  all-gather      (n - 1) / n * S   (S the gathered tensor)
  reduce-scatter  (n - 1) / n * S   (the all-gather's adjoint)
A step needs (`dh3d_tpu_torch/train/trainer.py`'s data-parallel step):
  - each train-mode BatchNorm's sums, forward and backward: all-reduces
    of 2C + 1 float64 (sum, sum of squares or their gradients' sums, and
    the count), the card's BatchNorm kernel's form;
  - the outputs the losses read, all-gathered into the global batch, and
    the gradients of those that carry one reduce-scattered back (the
    keypoints' descriptors and attention: the detection loss reads the
    raw features only to rank candidates, so no gradient flows there);
  - the gradient of every trainable parameter, all-reduced (float32;
    every parameter of the stage-2 configuration trains).
"""

from __future__ import annotations

import math

from benchmark.reference.model import is_statistic, param_shapes

NVLINK_BYTES_S = 450e9  # H100 SXM: 18 NVLink-4 links, a direction
F32, F64, I64 = 4, 8, 8


def all_reduce(nbytes: float, n: int) -> float:
    return 2 * (n - 1) / n * nbytes


def all_gather(nbytes: float, n: int) -> float:
    return (n - 1) / n * nbytes


def batchnorm_widths(cfg) -> list:
    """The channels of every BatchNorm over points (the stage-2 model's:
    all of them)."""
    return [shape[0] for name, shape in param_shapes(cfg).items()
            if name.endswith(".norm.scale")]


def loss_inputs(cfg, pairs: int, N: int) -> list:
    """[(bytes of the gathered tensor, whether a gradient flows back)] of
    the outputs the stage-2 losses read, over `pairs` pairs (2 * pairs
    clouds of N points): xyz, feat, the keypoint ids, their xyz, feat and
    attention, and R."""
    c, kp, d = 2 * pairs, cfg["sampled_kpnum"], cfg["featdim"]
    return [(c * N * 3 * F32, False), (c * N * d * F32, False),
            (c * kp * I64, False), (c * kp * 3 * F32, False),
            (c * kp * d * F32, True), (c * kp * F32, True),
            (pairs * 9 * F32, False)]


def stage2_step_bus_bytes(cfg, pairs: int, N: int, n: int) -> float:
    """A rank's bytes on the bus for one step of `pairs` pairs over all
    `n` ranks (module docstring)."""
    total = sum(2 * all_reduce((2 * C + 1) * F64, n)
                for C in batchnorm_widths(cfg))
    for nbytes, grad in loss_inputs(cfg, pairs, N):
        total += all_gather(nbytes, n) * (2 if grad else 1)
    params = sum(math.prod(s) for name, s in param_shapes(cfg).items()
                 if not is_statistic(name))
    return total + all_reduce(params * F32, n)
