"""The model's weights, made from the seed on the device in two draws.

Both sides get the same tensors: the program loads them into its model
(`load_state_dict`, strict, which also checks that the two agree on the
layer tree) and the reference reads them as they are.  The distributions
follow the model's initialisers (glorot-uniform flex and pointset thetas,
he-normal Dense kernels, normal NetVLAD matrices); biases and BatchNorm
leaves get small random values instead of zeros and ones, so that every
term of every layer is exercised and eval-mode BatchNorm is not the
identity.  `calibrate` then sets every running statistic to what the
layer sees on a batch of scans, as training would leave it, so that eval-mode
activations keep the scale of a trained model and the attention is not
saturated.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import CLUSTERS, Net, forward, param_shapes


def init_draw(name: str, shape) -> tuple:
    """("u", lo, hi) for a uniform draw, ("n", mean, std) for a normal."""
    if name.endswith("theta") or name.endswith("position_bias"):
        fi = 3 * shape[-2] if len(shape) == 3 else shape[0]
        lim = math.sqrt(6.0 / (fi + shape[-1]))
        return ("u", -lim, lim)
    if name.endswith(".scale"):
        return ("u", 0.8, 1.2)
    if name.endswith(".var"):
        return ("u", 0.8, 1.25)
    if name.endswith(".mean") or name.endswith(".bias"):
        centre = 0.125 if name == "detection_block.detec_conv_fc.bias" else 0
        return ("n", centre, 0.05)
    if name.endswith("hidden1_weights"):
        return ("n", 0.0, 1.0 / math.sqrt(CLUSTERS))
    if "global_assemble" in name:  # cluster and gating matrices
        return ("n", 0.0, 1.0 / math.sqrt(shape[-2]))
    return ("n", 0.0, math.sqrt(2.0 / shape[-1]))  # Dense kernels


def make_weights(cfg, seed: int, device) -> dict:
    """{name: f32 tensor on `device`} for every leaf of `param_shapes(cfg)`:
    one normal and one uniform draw of the whole model from a generator on
    the device, sliced and scaled leaf by leaf."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind, a, b = init_draw(name, shape)
        if kind == "u":
            t = uniform[at:at + n] * (b - a) + a
        else:
            t = normal[at:at + n].clamp(-2, 2) * b + a
        out[name] = t.reshape(shape).clone()
        at += n
    return out


def calibrate(cfg, weights: dict, clouds: torch.Tensor) -> dict:
    """`weights` with the mean and var of every BatchNorm over points
    replaced by its batch statistics in a train-mode reference forward of
    `clouds` [B, N, 3].  NetVLAD's BatchNorms over one row a cloud keep
    their drawn statistics: a batch of a few clouds is no estimate."""
    net = Net(weights, train=True)
    with torch.no_grad():
        forward(cfg, weights, clouds, train=True, net=net)
    return {**weights, **net.batch}
