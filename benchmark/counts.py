"""The work the model needs, counted from the configuration's shapes.

Two counts, both of the model and not of the program's launches:
  - `model_flops`: the multiply-adds of the network's matrix products
    (Dense layers, the flex-conv moments and their products with the
    weights, the pointset conv, NetVLAD), 2 FLOPs each, the count that
    `torch.utils.flop_counter` gives for the plain reference's forward.
    A train step counts the forward three times: the backward of every
    product is two products of the same size (every weight trains in the
    stage-2 configuration).  Interpolation, pools, norms and the losses
    are left out.
  - `kernel_bound_s`: the least time an H100 needs for the neighbourhood
    operations the hand-written kernels serve (kNN, FPS, the weighted
    sums, the max-pools, their backwards): PERF.md's roofline bound, each
    operation's inputs read once and outputs written once at 3.35 TB/s,
    or its f32 operations at 67 TFLOP/s, the larger; indices as int32
    (enough below 2**31 points), a max-pool's argmax slot one byte, a kNN
    8 operations a returned pair, FPS 8 a point an iteration.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
F32, IDX, SLOT = 4, 4, 1
K = 8  # neighbours of every flex conv, pool and SE (knn8)


def _bound(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS)


# ------------------------------ FLOPs --------------------------------------

def _dense(rows, din, dout):
    return 2 * rows * din * dout


def _flex(rows, din, dout):
    return 2 * rows * K * 4 * din + 2 * rows * 4 * din * dout


def local_flops(B: int, N: int, dilate: int = 8) -> int:
    """The local backbone's products at B clouds of N points."""
    M = N // dilate
    f = 2 * B * N * 3 * 32  # pointset conv
    f += _flex(B * N, 32, 64) + _flex(B * N, 64, 64)
    f += _dense(B * N, 64, 16) + _dense(B * N, 16, 64)  # SE
    f += _dense(B * N, 64, 64)  # before_stage2_conv1d
    f += _flex(B * M, 64, 128) + _flex(B * M, 128, 128)
    f += _dense(B * M, 128, 32) + _dense(B * M, 32, 128)  # SE
    f += _dense(B * N, 192, 128) + _dense(B * N, 64, 128)  # concat, shortcut
    return f


def detection_flops(B: int, N: int) -> int:
    return (_dense(B * N, 128, 128) + _dense(B * N, 128, 256)
            + _dense(B * N, 256, 1024) + _dense(B * N, 1024, 1))


def global_flops(B: int, N: int, D: int = 256, dilate: int = 8) -> int:
    M = N // dilate
    f = _flex(B * M, 128, D)
    f += _dense(B * N, D, 1024) + _dense(B * N, 1024, 1)  # attention
    f += 2 * B * N * D * 64 * 2  # soft assignment, aggregation
    f += _dense(B, D * 64, 256) + _dense(B, 256, 256)  # FC, gating
    return f


def model_flops(cfg: dict, B: int, N: int) -> int:
    """The forward's products at B clouds of N points under `cfg`."""
    d = cfg.get("dilate") or 8
    f = local_flops(B, N, d)
    if cfg.get("detection"):
        f += detection_flops(B, N)
    if cfg.get("extract_global"):
        f += global_flops(B, N, cfg["gl_dims"][-1], d)
    return f


def train_flops(cfg: dict, pairs: int, N: int) -> int:
    """A train step on `pairs` pairs (2 * pairs clouds): forward and a
    backward of twice its products."""
    return 3 * model_flops(cfg, 2 * pairs, N)


# ---------------------------- kernel bounds --------------------------------

def knn_bound(B, Nq, Nk, k, self_query=False):
    inputs = B * (Nq if self_query else Nq + Nk) * 3 * F32
    return _bound(inputs + B * Nq * k * (IDX + F32), 8 * B * Nq * k)


def fps_bound(B, N, m):
    return _bound(B * N * 3 * F32 + B * m * IDX, 8 * B * N * m)


def wsum_bound(B, Nout, Nin, k, C, P=1, positions=False):
    """A weighted sum over neighbourhoods (P weights a neighbour): the
    features [B, Nin, C], the ids [B, Nout, k] and the weights (or the
    positions they are built from) read; [B, Nout, P * C] written."""
    w = B * Nin * 3 * F32 if positions else B * Nout * k * P * F32
    nbytes = B * Nin * C * F32 + B * Nout * k * IDX + w + B * Nout * P * C * F32
    return _bound(nbytes, 2 * B * Nout * k * P * C)


def pool_bound(B, N, C, k=K):
    return _bound(B * N * C * F32 * 2 + B * N * k * IDX, B * N * k * C)


def pool_bwd_bound(B, N, C, k=K):
    return _bound(B * N * C * (2 * F32 + SLOT) + B * N * k * IDX, B * N * C)


def local_bound(B, N, dilate=8, train=False):
    """The local backbone's neighbourhood operations; with `train`, their
    backwards too (the pointset conv's input, the points, takes none)."""
    M = N // dilate
    fwd = [knn_bound(B, N, N, K, True),
           wsum_bound(B, N, N, K, 3),  # pointset conv
           pool_bound(B, N, 32),
           wsum_bound(B, N, N, K, 32, 4, True),
           wsum_bound(B, N, N, K, 64, 4, True),
           pool_bound(B, N, 64),
           fps_bound(B, N, M),
           knn_bound(B, M, M, K, True),
           wsum_bound(B, M, M, K, 64, 4, True),
           wsum_bound(B, M, M, K, 128, 4, True),
           pool_bound(B, M, 128),
           knn_bound(B, N, M, 3),
           wsum_bound(B, N, M, 3, 128)]  # interpolation
    if not train:
        return sum(fwd)
    # a weighted sum's backward reads what its forward writes and writes
    # what it reads: the same bound
    bwd = [pool_bwd_bound(B, N, 32),
           wsum_bound(B, N, N, K, 32, 4, True),
           wsum_bound(B, N, N, K, 64, 4, True),
           pool_bwd_bound(B, N, 64),
           wsum_bound(B, M, M, K, 64, 4, True),
           wsum_bound(B, M, M, K, 128, 4, True),
           pool_bwd_bound(B, M, 128),
           wsum_bound(B, N, M, 3, 128)]
    return sum(fwd) + sum(bwd)


def forward_bound_s(cfg: dict, B: int, N: int) -> float:
    d = cfg.get("dilate") or 8
    s = local_bound(B, N, d)
    if cfg.get("extract_global"):
        M, D = N // d, cfg["gl_dims"][-1]
        s += wsum_bound(B, M, M, K, 128, 4, True) + wsum_bound(B, N, M, 3, D)
    return s


def train_bound_s(cfg: dict, pairs: int, N: int) -> float:
    """A stage-2 step: the pairs built on the device (FPS of the anchors
    over half of each cloud, their 1-NN in the positive), the backbone
    forward and backward at 2 * pairs clouds, and the detection loss's
    two kNNs of the anchors' correspondents (det_k neighbours)."""
    d, kp = cfg.get("dilate") or 8, cfg["sampled_kpnum"]
    s = fps_bound(pairs, N // 2, kp) + knn_bound(pairs, kp, N, 1)
    s += local_bound(2 * pairs, N, d, train=True)
    s += 2 * knn_bound(pairs, kp, N, cfg["det_k"])
    return s
