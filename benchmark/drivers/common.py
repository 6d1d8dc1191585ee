"""Set-up shared by the drivers: the program's model on the benchmark's
weights, seeded generators, and the comparison helpers."""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from benchmark.harness import sub_seed


def generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def port_model(cfg, weights: dict, device):
    """The program's DH3D for `cfg` with `weights` loaded (strict: the
    benchmark's layer tree and the program's must agree), built without
    drawing weights of its own."""
    from dh3d_tpu_torch.nn.model import DH3D

    with torch.device("meta"):
        model = DH3D(cfg)
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def port_cfg(cfg: dict):
    from dh3d_tpu_torch.config import dotdict

    return dotdict(dict(cfg))


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; inf when the shapes differ, NaN when either is NaN."""
    if a.shape != b.shape:
        return float("inf")
    return float(torch.max(torch.abs(a.double() - b.double())))


def worst(a: float, b: float) -> float:
    """The larger of two gaps, a NaN winning."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


@contextlib.contextmanager
def tf32():
    """Matrix products and convolutions in TF32 while entered: the
    control, the reference one precision below the configuration's f32."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


def sync(device):
    """Wait for `device`'s work (nothing to wait for on the CPU, where only
    the tests run the drivers)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def window_loop(seconds: float, step, device) -> tuple:
    """Call `step(i)` for i = 0, 1, ... until `seconds` have passed on the
    host clock, then synchronise: (units, seconds from the first call to
    the end of the last unit's device work)."""
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        step(i)
        i += 1
    sync(device)
    return i, time.perf_counter() - t0
