"""Kernel B's (FPS) launch plan and the rule that decides its output, on
the CPU.

The CUDA kernel runs only on the card (`tests/test_torch_cuda.py` holds
it against its plain version; PERF.md §6 times it); here:
  - `fps_plan`, a pure function of the shapes and the SM count, at the
    path's shapes and in its range;
  - kernel B's candidate order: the packed key (distance bits << 32 |
    ~index) and the two-step redux (the largest bits, then the lowest index
    among them) against numpy's first-occurrence argmax.
Kernel G's plan and search are tested in `tests/test_torch_knn_topk.py`.
Inputs come from numpy seeds; every comparison is exact.
"""

import importlib

import numpy as np
import pytest

# the module (`ops.sampling` also holds the function names)
sampling = importlib.import_module("dh3d_tpu_torch.ops.sampling")

H100_SMS = 132


def _packed(v, i):
    """Kernel B's packed key: the f32 bits of v >= +0 above ~index."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (~np.asarray(i, np.uint32)).astype(
        np.uint64)


ARGMAX_CASES = {
    "ties": np.array([1.0, 3.0, 2.0, 3.0, 3.0, 0.5]),
    "zeros": np.array([0.0, 0.0, 0.0, 0.0]),
    "zero after positive": np.array([0.0, 1e-45, 0.0, 1e-45]),
    "large": np.array([3.0e38, 1.0, 3.4028235e38, 3.4028235e38, 2.0]),
    "inf": np.array([5.0, np.inf, 7.0, np.inf, np.inf]),
    "random": np.random.RandomState(4).rand(1000) * 100,
}


@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_packed_argmax_key_gives_the_first_occurrence(case):
    """The largest packed key and the two-step redux both give argmax's
    first occurrence of the largest distance."""
    v = ARGMAX_CASES[case].astype(np.float32)
    i = np.arange(len(v))
    key = _packed(v, i).max()
    assert (~np.uint32(key & np.uint64(0xffffffff))) == np.argmax(v)
    assert np.uint32(key >> np.uint64(32)).view(np.float32) == v.max()
    bits = v.view(np.uint32)
    top = bits.max()
    assert i[bits == top].min() == np.argmax(v)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("B,N", [(20, 8192), (1, 16384), (1, 9000),
                                 (1, 40000), (20, 1024), (1, 140000),
                                 (2, 3000), (60, 8192), (100, 16384)])
def test_fps_plan_is_one_kernel_b_takes(B, N, sms):
    """C in [1, 8]; T = 128 in a cluster, whose C * T / 32 warps fit the
    kernel's 32 candidate slots, 256 for one block; a larger cloud never
    takes fewer blocks, more clouds never more."""
    c, t = sampling.fps_plan(B, N, sms)
    assert 1 <= c <= 8
    assert t == (128 if c > 1 else 256) and (c == 1 or c * t // 32 <= 32)
    assert sampling.fps_plan(B, 2 * N, sms)[0] >= c
    assert sampling.fps_plan(2 * B, N, sms)[0] <= c


def test_fps_plan_at_the_paths_shapes():
    """The sweep's choices: 4 blocks of 128 threads a cloud at B = 20 (5
    clusters of 8 would not all fit the 8 GPCs at once), 8 at B = 1."""
    assert sampling.fps_plan(20, 8192, H100_SMS) == (4, 128)
    for n in (16384, 9000, 40000):
        assert sampling.fps_plan(1, n, H100_SMS) == (8, 128)
