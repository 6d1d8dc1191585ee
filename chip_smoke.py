"""The per-kernel table of PERF.md §6: each hand-written kernel of the
PyTorch port on one NVIDIA GPU, at every shape the port's paths give it,
timed against its bound, its plain version and its library route.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases; any failure raises, so the script exits non-zero and prints no
result line:
  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build the kernels from `dh3d_tpu_torch/csrc` (one nvcc per source, in
     parallel; timed).
  3. each kernel A-G against its plain PyTorch version on the card, at the
     shapes the forward, the train step, the extraction and the pair
     generation give it.  Each case is timed as device time
     (`device_ms`: calls queued back to back behind a sleep kernel, between
     two CUDA events, so the host's launch work is hidden).  Beside each:
     its bound (`bound`: the bytes of its inputs and outputs over the
     memory rate or its f32 operations over the f32 rate, whichever is
     larger) and, where PyTorch has one, the library route for the same
     function (`library_ms`).  Each kernel's first case is at the
     relocalisation's shapes (batch 1, N=4096, its FPS to 512, and its
     NMS's 50-NN).  Kernels C and D run at every shape of the forward
     (`forward_cases`: the moments through `flex_moments`, which must give
     the bits of `weighted_sum` on the weight tensor; D with and without
     its ids and its slot, and once on features with NaNs), with the time
     of the weight build that left the path and of every forced launch
     plan (`row_plans`), each of which must give the path's bits.  Kernels
     E and F run at every shape of the train step (`backward_cases`), with
     the CSR inverse handed in (as on the path: `ms`, bounded by the
     inverse's bytes) and built in the call (`ms_fresh_inverse`, bounded by
     nbh's), and must give the same bits both ways and on a second run; E
     at P = 4 both on the weight tensor and on the positions (the same
     bits); the inverse's build is timed alone.  Kernels A, G and B run at
     every shape of the paths (`knn_fps_cases`: the forward's, the train
     step's and the extraction's; A the 3-NN, G every k >= 8, and keypoint
     NMS's self k=50 on the loader-order and the Morton-sorted lidar cloud,
     on an undersized scan the loader pads with 1e5 sentinels (also at
     k=8), at the dso size, across clouds and at k=33 and 128; A the pair
     generation's 1-NN [10,512]x[10,8192], beside its library route
     `torch.cdist(...).argmin(-1)`; B its FPS [10,4096]->512), each with the
     plan it took.  A kNN's bound counts its bytes and the d2 of the pairs
     it returns.  Beside A's bound its instruction floor (the 7
     instructions every pair issues in its full scan's x-y test, over 128
     lanes of every SM at the SM clock `nvidia-smi` reads under load),
     beside G's the same for all its pairs (`scan_floor_ms`: a full scan's
     best, which G's pruning takes it under; not a bound), G's pre-pass
     alone (`prepass_ms`) and, at each A shape, G forced to its plan
     (`g_ms`); beside B's its chain floor (the fastest time an iteration of
     any plan at [20,1024]->1024, times m - 1).
  4. kernel H (`knn_window`, the legacy Morton-band mode) against its plain
     version, ids and d2 bit for bit, at the legacy path's shapes (the
     self kNN k=8 W=512 at [20, 8192] and [1, 16384]; a windowed level's
     self kNN at [1, 4096] and its 3-NN W=256 from [1, 32768];
     `window_cases`), each at its plan (`window_plan`: lanes a query) with
     its device time, bound, A's instruction floor over its pairs and one
     launch a call.
  5. the bf16 cases of kernels C and E (`flex_moments_bf16`,
     `flex_moments_backward_bf16`) against their plain versions at the
     forward's and the step's shapes ([20, 8192] with C = 32 and 64, [20,
     1024] with C = 64 and 128), each with its device time, bound (bf16
     features at 2 bytes), library route and the f32 case's time on the
     same values.  bf16 products accumulate in f32
     (`allow_bf16_reduced_precision_reduction` off).
  6. the loader's radius count, kernel I (`ops.radius_count`, the outlier
     removal of `data.io.get_fixednum_pcd` on a card), against its plain
     version and `cKDTree` bit for bit at the raw extraction's M (~27,800,
     a 30,000-point scan through the voxel grid), at M = 16384 and on the
     boundary cloud, with its device time, FP64 bound, plain time,
     `cKDTree`'s host time and every key split at the first two M.
  7. train-mode BatchNorm + relu, kernel J (`ops.batch_norm_train`), at the
     train steps' shapes: its device time forward and forward + backward
     beside its byte bound (3 passes forward, 5 backward), the plain
     version's and `F.batch_norm` + relu's (`library_ms`); the same bits
     twice, close to the plain version.
The last three lines: the card; the kernels JSON, a row a kernel (its
letter, its first case's shape, times and bound, its largest difference
from the plain version, and every case: shape, plan, ms, bound, plain and
library ms); the ok JSON.

    python3 chip_smoke.py --sweep [--out OUT]

times every plan kernels G and B take at each shape of `knn_fps_cases`
(A, and both plans of G, at A's shapes), each output checked equal to the
plain version, kernel H at each shape of `window_cases` at every plan
(1-32 lanes a query), each output checked equal to the plain version, and
kernels C and D at each shape of `forward_cases` at 8, 16 and 32 lanes a
row, each output checked equal to the path's, into OUT/sweep.json: the
measurements `topk_plan`, the line `knn` draws between A and G
(`ops.knn.MAX_K`), `fps_plan`, `window_plan` and `row_plan` were chosen
from.

The paths' on-card checks (the forward, the train step, the CLIs and the
parallel path, each against the CPU where it can be) are card tests:
`python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_paths.py
-m cuda -q --noconftest`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np

from dh3d_tpu_torch.data.synthetic import lidar_like_scan

# Weighted sums and their backward against their plain versions: summation
# order only (FMA accumulation in the kernels, other matmul blocking), held
# to 1e-5 of the largest magnitude; the max backward adds the same terms in
# the same order.
WSUM_REL = 1e-5
# The bf16 cases of C and E against their plain versions: a value rounded
# to bf16 (C's m0, E's output) within one bf16 step (up to 2^-7 of a
# value) plus WSUM_REL of the tensor's largest (the f32 sums before the
# rounding differ in order, so a value near a rounding boundary lands one
# step apart), C's f32 moments within WSUM_REL.
BF16_STEP = 2.0 ** -7
# the kernels' letters (PERF.md §6), by the name of each case's row
KERNELS = {"knn": "A", "fps": "B", "weighted_sum": "C", "flex_moments": "C",
           "flex_moments_bf16": "C", "neighbor_max": "D",
           "weighted_sum_backward": "E", "flex_moments_backward": "E",
           "flex_moments_backward_bf16": "E", "neighbor_max_backward": "F",
           "knn_topk": "G", "knn_window": "H", "radius_count": "I",
           "batch_norm_train": "J"}
# The card's rates for the bounds (H100 SXM datasheet: HBM3, and f32
# outside the tensor cores)
MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SLEEP_CYCLES = 20_000_000  # ~10 ms of device time ahead of queued calls
# Kernel A's instruction floor: what every query-key pair issues in the x-y
# test that most pairs end at (csrc/knn.cu, no FMA): its lane of the key's
# LDS.128, 2 FADD (dx, dy), 2 FMUL, 1 FADD and 1 FSETP.  The step's loop
# control, and the z terms and insertions of the pairs that pass the test,
# come on top, so the floor is a lower bound.
KNN_FLOOR_INSTRUCTIONS_PER_PAIR = 7
# Kernel B's plans timed at [20,1024]->1024 for its chain floor
CHAIN_FLOOR_PLANS = ((1, 128), (1, 256), (1, 1024), (2, 128), (4, 128),
                     (8, 128))
# the relocalisation forward's size, batch 1
RELOC_POINTS = 4096
# Kernel I's bound, its float64 instructions (3 subtractions, 3 products,
# 2 sums a pair) at 64 a clock an SM: the H100 SXM's 34 TFLOP/s of FP64 on
# the CUDA cores counts an FMA as 2, so 17e12 such instructions a second.
# The key splits timed at the raw scan's M.
FP64_INSTRUCTIONS_PER_S = 17e12
RADIUS_FP64_PER_PAIR = 8
RADIUS_PLANS = (1, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps=5) -> float:
    """Device time of fn() in ms: up to 20 calls (~10 ms of them) queued
    behind a sleep kernel, so that the device runs them back to back
    whatever the host's launch work, between two CUDA events, over the
    count; median of `reps`.  A call that waits for the host (a sync, a
    host loop longer than the sleep) counts that wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(1, min(20, int(0.01 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(nbytes, ops):
    """(ms, what sets it): the least time the card could take for work that
    moves `nbytes` and does `ops` f32 operations."""
    by_bytes = nbytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sparse_rows(torch, nbh, w, m):
    """The weighted sum as a sparse matrix: rows (b, n, p), columns (b, j),
    w[b, n, k, p] at column (b, nbh[b, n, k]); CSR [B*N*P, B*M]."""
    B, N, K, P = w.shape
    cols = nbh + m * torch.arange(B, device=nbh.device)[:, None, None]
    cols = cols[:, :, None, :].expand(B, N, P, K).reshape(-1)
    crow = torch.arange(0, B * N * P * K + 1, K, device=nbh.device)
    return torch.sparse_csr_tensor(crow, cols, w.transpose(2, 3).reshape(-1),
                                   size=(B * N * P, B * m))


def train_geometry(torch, T, device):
    """The train step's neighbourhoods on the seeded clouds of `entry`:
    Morton-sorted points [20, 8192], their FPS subsample [20, 1024] (ids
    sorted), the self kNN k=8 at both levels, and the 3-NN map (d2, idx)
    from the points to the subsample."""
    from dh3d_tpu_torch.entry import entry_points

    B, N, M, K = 20, 8192, 1024, 8
    raw = torch.from_numpy(entry_points(B, N)).to(device)
    perm, _ = T.morton_perm(raw)
    pts = torch.gather(raw, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    sub_idx = torch.sort(T.farthest_point_sample(pts, M), dim=-1).values
    sub = T.gather_point(pts, sub_idx).contiguous()
    return (pts, sub, T.knn(pts, pts, K)[0], T.knn(sub, sub, K)[0],
            T.three_nn(pts, sub))


def reloc_geometry(torch, T, device):
    """The relocalisation forward's neighbourhoods (the relocalisation
    CLI's defaults, batch 1): a database scan through
    `GlobalTestDataset`'s normalisation [1, 4096] in loader order (NMS's
    input), Morton-sorted, its FPS subsample [1, 512] (ids sorted), the
    self kNN k=8 at both levels, and the 3-NN map (d2, idx) from the
    points to the subsample."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd

    N, M, K = RELOC_POINTS, RELOC_POINTS // 8, 8
    cloud, _ = get_fixednum_pcd(lidar_like_scan(300, extent=15.0), N,
                                randsample=True, sortby_dis=True,
                                rng=np.random.RandomState(0))
    raw = torch.from_numpy(cloud[None]).to(device)
    perm, _ = T.morton_perm(raw)
    pts = torch.gather(raw, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    sub_idx = torch.sort(T.farthest_point_sample(pts, M), dim=-1).values
    sub = T.gather_point(pts, sub_idx).contiguous()
    return (raw, pts, sub, T.knn(pts, pts, K)[0], T.knn(sub, sub, K)[0],
            T.three_nn(pts, sub))


def backward_cases(torch, T, device):
    """Kernels E and F at every shape of the `detection_config` train step
    ([20, 8192], 512 keypoints), and E once on random ids, on seeded
    inputs.  One dict a case: `name` (the kernel) and `label`;
    `call(*inverse)`, the op, which builds its own CSR inverse when given
    none; `nbh` and `keys`, its neighbourhood and key count; `reads`, the
    other tensors it reads; `ops`, its f32 operations; `plain`, its plain
    version, which is the library route (einsum + `index_add_`, gather +
    `scatter_add_`); `library_call`, that route's last call alone on
    prepared operands."""
    pts, sub, nbh, nbh1, (d2_3, idx3) = train_geometry(torch, T, device)
    B, N, K = nbh.shape
    M = sub.shape[1]
    g = torch.Generator(device="cpu").manual_seed(1)
    w4, w4s = T.flex_weights(pts, nbh), T.flex_weights(sub, nbh1)
    w3 = T.inverse_distance_weights(d2_3)[..., None].contiguous()
    rnd = torch.randint(0, N, (B, N, K), generator=g).to(device)
    cases = []
    for label, C, idx, w, keys, pos in (  # first: E on weights on the path
            (f"P=1 C=128 K=3 [{B},{N}]->[{B},{M}]", 128, idx3, w3, M, None),
            (f"P=4 C=64 K=8 [{B},{N}]", 64, nbh, w4, N, pts),
            (f"P=4 C=32 K=8 [{B},{N}]", 32, nbh, w4, N, pts),
            (f"P=4 C=64 K=8 [{B},{M}]", 64, nbh1, w4s, M, sub),
            (f"P=4 C=128 K=8 [{B},{M}]", 128, nbh1, w4s, M, sub),
            (f"P=4 C=64 K=8 [{B},{N}] random idx", 64, rnd, None, N, pts)):
        if w is None:  # the weights the random ids give
            w = T.flex_weights(pos, idx)
        P = w.shape[-1]
        dm = torch.randn(B, idx.shape[1], P * C, generator=g).to(device)
        contrib = torch.einsum("bnkp,bnpc->bnkc", w,
                               dm.view(B, -1, P, C)).reshape(-1, C)
        rows = (idx + keys * torch.arange(B, device=device)[:, None, None]
                ).reshape(-1)
        cases.append(dict(
            name="weighted_sum_backward", label=label, nbh=idx, keys=keys,
            call=partial(T.weighted_sum_backward, dm, idx, w, keys),
            reads=(dm, w), ops=2 * w.numel() * C,
            plain=partial(T.weighted_sum_backward_plain, dm, idx, w, keys),
            library_call=partial(dm.new_zeros(B * keys, C).index_add_, 0,
                                 rows, contrib)))
        if pos is not None:
            cases.append(dict(
                cases[-1], name="flex_moments_backward", reads=(dm, pos, idx),
                call=partial(T.flex_moments_backward, dm, pos, idx)))
    for label, C, idx, keys in ((f"C=32 K=8 [{B},{N}]", 32, nbh, N),
                                (f"C=64 K=8 [{B},{N}]", 64, nbh, N),
                                (f"C=128 K=8 [{B},{M}]", 128, nbh1, M)):
        feat = torch.randn(B, keys, C, generator=g).to(device)
        slot = T.neighbor_max_with_slot(feat, idx)[2]
        dval = torch.randn(B, idx.shape[1], C, generator=g).to(device)
        ids = torch.gather(idx, 2, slot.long())
        cases.append(dict(
            name="neighbor_max_backward", label=label, nbh=idx, keys=keys,
            call=partial(T.neighbor_max_backward, dval, idx, slot, keys),
            reads=(dval, slot), ops=2 * idx.numel() * C,
            plain=partial(T.neighbor_max_backward_plain, dval, idx, slot,
                          keys),
            library_call=partial(dval.new_zeros(B, keys, C).scatter_add_, 1,
                                 ids, dval)))
    return cases


def row_plans(T, C, K):
    """The plans kernels C and D are forced to at C channels: `row_plan`'s
    at each vector width the alignment may leave, and four channels a
    thread at 8, 16 and 32 lanes a row."""
    plans = {T.row_plan(C, K, v) for v in (4, 2, 1)}
    if C % 4 == 0:
        plans |= {(4, lanes, -(-C // (4 * lanes))) for lanes in (8, 16, 32)}
    return sorted(plans)


def forward_cases(torch, T, device):
    """Kernels C and D at every shape of the relocalisation forward (first,
    D as that path calls it) and of the forward (and D as the train
    step calls it), and C once on random ids, on seeded inputs.  One dict
    a case: `name` (the kernel), `label`; `call`, the op as the path calls
    it, returning a tuple of tensors; `plain`, the same tuple from the
    plain version; `inputs` (for the bound) and `ops`, f32 operations;
    `forced(plan)`, the op with a given launch plan, and `C`, `K` for the
    plans; C: `sparse`, the operands (idx, w, f) of the library route; the
    moments: `explicit`, the same sum on the weight tensor, and `weights`,
    the build of that tensor; D: `nan`, whether the features hold NaNs."""
    pts, sub, nbh, nbh1, (d2_3, idx3) = train_geometry(torch, T, device)
    B, N, K = nbh.shape
    M = sub.shape[1]
    g = torch.Generator(device="cpu").manual_seed(2)
    feats = {(n, c): torch.randn(B, n, c, generator=g).to(device)
             for n, c in ((N, 32), (N, 64), (M, 64), (M, 128), (M, 256))}
    rnd = torch.randint(0, N, (B, N, K), generator=g).to(device)
    w1 = torch.ones(B, N, K, 1, device=device)
    w1[:, :, 0] = 1 - K
    w3 = T.inverse_distance_weights(d2_3)[..., None].contiguous()
    # the relocalisation forward's, batch 1 (listed first)
    _, rpts, rsub, rnbh, rnbh1, (rd2_3, ridx3) = reloc_geometry(torch, T,
                                                                 device)
    rN, rM = rpts.shape[1], rsub.shape[1]
    rfeats = {(n, c): torch.randn(1, n, c, generator=g).to(device)
              for n, c in ((rN, 32), (rN, 64), (rM, 64), (rM, 128),
                           (rM, 256))}
    rw1 = torch.ones(1, rN, K, 1, device=device)
    rw1[:, :, 0] = 1 - K
    rw3 = T.inverse_distance_weights(rd2_3)[..., None].contiguous()
    R = " (relocalisation)"
    cases = []

    def tensors(out):
        out = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(t for t in out if t is not None)

    for label, f, pos, idx in (
            (f"P=4 C=64 K=8 [1,{rN}]{R}", rfeats[rN, 64], rpts, rnbh),
            (f"P=4 C=32 K=8 [1,{rN}]{R}", rfeats[rN, 32], rpts, rnbh),
            (f"P=4 C=64 K=8 [1,{rM}]{R}", rfeats[rM, 64], rsub, rnbh1),
            (f"P=4 C=128 K=8 [1,{rM}]{R}", rfeats[rM, 128], rsub, rnbh1),
            (f"P=4 C=64 K=8 [{B},{N}]", feats[N, 64], pts, nbh),
            (f"P=4 C=32 K=8 [{B},{N}]", feats[N, 32], pts, nbh),
            (f"P=4 C=64 K=8 [{B},{M}]", feats[M, 64], sub, nbh1),
            (f"P=4 C=128 K=8 [{B},{M}]", feats[M, 128], sub, nbh1),
            (f"P=4 C=64 K=8 [{B},{N}] random idx", feats[N, 64], pts, rnd)):
        w = T.flex_weights(pos, idx)
        call = partial(T.flex_moments, f, pos, idx)
        cases.append(dict(
            name="flex_moments", label=label, inputs=(f, idx, pos),
            C=f.shape[-1], K=K, ops=2 * w.numel() * f.shape[-1],
            call=lambda call=call: tensors(call()),
            plain=lambda f=f, idx=idx, w=w: tensors(
                T.weighted_sum_plain(f, idx, w)),
            forced=lambda plan, f=f, pos=pos, idx=idx: tensors(
                T.flex_moments(f, pos, idx, plan=plan)),
            explicit=lambda f=f, idx=idx, w=w: tensors(
                T.weighted_sum(f, idx, w)),
            weights=partial(T.flex_weights, pos, idx), sparse=(idx, w, f)))
    for label, f, idx, w in (
            (f"P=1 C=256 K=3 [1,{rN}]<-[1,{rM}]{R}", rfeats[rM, 256], ridx3,
             rw3),
            (f"P=1 C=128 K=3 [1,{rN}]<-[1,{rM}]{R}", rfeats[rM, 128], ridx3,
             rw3),
            (f"P=1 C=3 K=8 [1,{rN}] (raw xyz){R}", rpts, rnbh, rw1),
            (f"P=1 C=256 K=3 [{B},{N}]<-[{B},{M}]", feats[M, 256], idx3, w3),
            (f"P=1 C=128 K=3 [{B},{N}]<-[{B},{M}]", feats[M, 128], idx3, w3),
            (f"P=1 C=3 K=8 [{B},{N}] (raw xyz)", pts, nbh, w1)):
        cases.append(dict(
            name="weighted_sum", label=label, inputs=(f, idx, w),
            C=f.shape[-1], K=idx.shape[-1], ops=2 * w.numel() * f.shape[-1],
            call=lambda f=f, idx=idx, w=w: tensors(T.weighted_sum(f, idx, w)),
            plain=lambda f=f, idx=idx, w=w: tensors(
                T.weighted_sum_plain(f, idx, w)),
            forced=lambda plan, f=f, idx=idx, w=w: tensors(
                T.weighted_sum(f, idx, w, plan=plan)),
            sparse=(idx, w, f)))

    # D: as the forward calls it (value only), as the train step does
    # (value and slot), and with the ids; once on features with NaNs
    noisy = feats[N, 64].clone()
    noisy[torch.rand(B, N, 64, generator=g).to(device) < 0.01] = float("nan")
    for label, f, idx, nan in (
            (f"C=64 K=8 [1,{rN}]{R}", rfeats[rN, 64], rnbh, None),
            (f"C=32 K=8 [1,{rN}]{R}", rfeats[rN, 32], rnbh, None),
            (f"C=128 K=8 [1,{rM}]{R}", rfeats[rM, 128], rnbh1, None),
            (f"C=64 K=8 [{B},{N}]", feats[N, 64], nbh, False),
            (f"C=32 K=8 [{B},{N}]", feats[N, 32], nbh, False),
            (f"C=128 K=8 [{B},{M}]", feats[M, 128], nbh1, False),
            (f"C=64 K=8 [{B},{N}] 1% NaN", noisy, nbh, True)):
        for ids, slot in ((False, False), (False, True), (True, False),
                          (True, True)):
            # the NaN case with ids and slot; the eval path's value only
            if (nan and (ids, slot) != (True, True)) or (
                    nan is None and (ids or slot)):
                continue
            fn = T.neighbor_max_with_slot if slot else T.neighbor_max
            keep = [0] + [1] * ids + [2] * slot

            def call(fn=fn, f=f, idx=idx, ids=ids, **more):
                return tensors(fn(f, idx, with_arg=ids, **more))

            cases.append(dict(
                name="neighbor_max", nan=bool(nan), inputs=(f, idx),
                C=f.shape[-1], K=K, ops=idx.numel() * f.shape[-1],
                label=label + " +id" * ids + " +slot" * slot, call=call,
                plain=lambda f=f, idx=idx, keep=keep: tuple(
                    T.neighbor_max_plain(f, idx)[i] for i in keep),
                forced=lambda plan, call=call: call(plan=plan)))
    return cases


def plan_of(T, name, *shape):
    """The path's own plan for a case: G's `topk_plan(k)` (its merge), B's
    `fps_plan` (blocks a cloud, threads a block); None for A."""
    from dh3d_tpu_torch import kernels

    if name == "knn_topk":
        return T.topk_plan(shape[-1])
    if name == "fps":
        return list(T.fps_plan(*shape, kernels.sm_count(0)))
    return None


def knn_fps_cases(torch, T, device):
    """Kernels A, G and B at every shape of the paths (the relocalisation's
    first), on seeded inputs.  One dict a case: `name` (the kernel the
    path takes: A up to k = 7, G from k = 8), `label`; `call`, the op as
    the path calls it (its own plan, `plan`: G's merge, B's (blocks a
    cloud, threads a block)); `plain`; `forced(plan)`, the op with a given
    plan and `plans`, every plan to sweep (G and B); `inputs` (for the
    bound); `ops`, f32 operations (kNN: the 8 of the d2 of each pair it
    returns, which any exact search computes; B: 9 a point an
    iteration); A and G: `pairs` (all query-key pairs, for a full scan's
    instruction floor); G: `prepass()`, its pre-pass alone; A:
    `g_forced(plan)` and `g_plan`, G at A's shape; B: `m`.  B at
    [20,1024]->1024 is almost all barrier and reduction: the fastest of its
    plans gives the chain floor (`chain_plans`)."""
    pts, sub, _, _, _ = train_geometry(torch, T, device)
    B, N = pts.shape[:2]
    M = sub.shape[1]
    lidar = torch.from_numpy(eval_cloud(0, 16384)[None]).to(device)
    perm, _ = T.morton_perm(lidar)  # the extraction forward's order
    lidar_m = torch.gather(lidar, 1, perm[..., None].expand(-1, -1, 3))
    lidar_m = lidar_m.contiguous()
    lidar_sub = T.gather_point(lidar_m, torch.sort(
        T.farthest_point_sample(lidar_m, 2048), dim=-1).values).contiguous()
    padded = torch.from_numpy(padded_eval_cloud(0, 16384)[None]).to(device)
    dso = torch.from_numpy(eval_cloud(7, 9000)[None]).to(device)
    big = torch.from_numpy(lidar_like_scan(8, n_points=40000)[None]).to(device)
    keys4 = torch.from_numpy(np.stack(
        [eval_cloud(s, 16384) for s in (1, 2, 3, 4)])).to(device)
    q4 = (keys4[:, ::8] + 0.05).contiguous()
    small = torch.from_numpy(np.stack(
        [eval_cloud(s, 3000) for s in (5, 6)])).to(device)
    P2, KP = B // 2, 512
    kp = pts[:P2, :KP].contiguous() + 0.25  # the detection loss's keypoints
    # the pair generation's: anchors spread over pc1 (every 16th point of
    # the Morton order) searched in another jittered draw of the cloud, and
    # FPS over a random half of each cloud
    g = torch.Generator(device="cpu").manual_seed(3)
    anchors = (pts[:P2, ::N // KP] + 0.05 * torch.randn(
        P2, KP, 3, generator=g).to(device)).contiguous()
    half = T.gather_point(pts[:P2], torch.stack(
        [torch.randperm(N, generator=g)[:N // 2] for _ in range(P2)]
    ).to(device)).contiguous()
    # the relocalisation forward's and its NMS's, batch 1 (listed first)
    rraw, rpts, rsub = reloc_geometry(torch, T, device)[:3]
    rN, rM, R = rpts.shape[1], rsub.shape[1], " (relocalisation)"
    cases = []
    for name, label, q, keys, k in (
            # A: the 3-NN of the relocalisation, the forward and the
            # extraction forward, the pair generation's 1-NN
            ("knn", f"cross k=3 [1,{rN}]->[1,{rM}]{R}", rpts, rsub, 3),
            ("knn", f"cross k=3 [{B},{N}]->[{B},{M}]", pts, sub, 3),
            ("knn", "cross k=3 [1,16384]->[1,2048] (extraction)", lidar_m,
             lidar_sub, 3),
            ("knn", f"cross k=1 [{P2},{KP}]x[{P2},{N}] (pairgen)", anchors,
             pts[:P2].contiguous(), 1),
            # G: the self kNN k=8 at both levels of the relocalisation and
            # its NMS's 50-NN (loader order); the self kNN k=8 of the
            # forward, the train step and the extraction forward, the
            # detection loss's k=16; keypoint NMS's
            # 50-NN of a normalised lidar eval cloud in loader order (its
            # call), the same cloud in Morton order, an undersized scan the
            # loader pads with 1e5 sentinels (at NMS's k and at the
            # forward's), the dso size, cross queries, G's k above 64
            ("knn_topk", f"self k=8 [1,{rN}]{R}", rpts, rpts, 8),
            ("knn_topk", f"self k=8 [1,{rM}]{R}", rsub, rsub, 8),
            ("knn_topk", f"self k=50 [1,{rN}] (relocalisation NMS)", rraw,
             rraw, 50),
            ("knn_topk", f"self k=8 [{B},{N}]", pts, pts, 8),
            ("knn_topk", f"self k=8 [{B},{M}]", sub, sub, 8),
            ("knn_topk", f"cross k=16 [{P2},{KP}]->[{P2},{N}]", kp,
             pts[:P2].contiguous(), 16),
            ("knn_topk", "self k=8 [1,16384] (extraction)", lidar_m,
             lidar_m, 8),
            ("knn_topk", "self k=8 [1,16384] padded 49%", padded, padded, 8),
            ("knn_topk", "self k=50 [1,16384] (NMS, loader order)", lidar,
             lidar, 50),
            ("knn_topk", "self k=50 [1,16384] Morton order", lidar_m,
             lidar_m, 50),
            ("knn_topk", "self k=50 [1,16384] padded 49% (NMS)", padded,
             padded, 50),
            ("knn_topk", "self k=50 [1,9000] (dso)", dso, dso, 50),
            ("knn_topk", "cross k=50 [4,2048]x[4,16384]", q4, keys4, 50),
            ("knn_topk", "self k=33 [2,3000]", small, small, 33),
            ("knn_topk", "self k=128 [2,3000]", small, small, 128)):
        b, nq, nk = q.shape[0], q.shape[1], keys.shape[1]
        c = dict(name=name, label=label, inputs=(q, keys), pairs=b * nq * nk,
                 ops=8 * b * nq * k, call=partial(T.knn, q, keys, k),
                 plain=partial(T.knn_plain, q, keys, k),
                 plan=plan_of(T, name, b, nq, nk, k))
        if k == 1:  # one library call: exact, the first index on a tie
            c["library"] = lambda q=q, keys=keys: torch.cdist(
                q, keys, compute_mode="donot_use_mm_for_euclid_dist"
            ).argmin(-1)
        if name == "knn":
            c.update(g_plan=T.topk_plan(k),
                     g_forced=lambda p, q=q, keys=keys, k=k: T.knn(
                         q, keys, k, plan=p))
        else:
            c.update(forced=lambda p, q=q, keys=keys, k=k: T.knn(
                q, keys, k, plan=p), plans=(0, 1),
                prepass=partial(T.topk_prepass, q, keys))
        cases.append(c)
    for label, p, m in ((f"[1,{rN}]->{rM}{R}", rpts, rM),
                        (f"[{B},{N}]->{M}", pts, M),
                        (f"[{P2},{N // 2}]->{KP} (pairgen)", half, KP),
                        (f"[{B},{M}]->{M} (chain floor)", sub, M),
                        ("[1,16384]->2048", lidar, 2048),
                        ("[1,9000]->1125", dso, 1125),
                        ("[1,40000]->5000", big, 5000)):
        b, n = p.shape[:2]
        cases.append(dict(
            name="fps", label=label, inputs=(p,), m=m, ops=9 * b * n * m,
            call=partial(T.farthest_point_sample, p, m),
            plain=partial(T.fps_plain, p, m), plan=plan_of(T, "fps", b, n),
            forced=lambda plan, p=p, m=m: T.farthest_point_sample(
                p, m, plan=plan),
            plans=[(c, t) for c in (1, 2, 3, 4, 6, 8)
                   for t in (128, 256, 512, 1024)],
            chain_plans=CHAIN_FLOOR_PLANS if "chain" in label else ()))
    return cases


def sm_clock_mhz(torch, fn, ms) -> float:
    """The SM clock `nvidia-smi` reports while calls of `fn` (`ms` device
    ms each) keep the card busy for about half a second."""
    for _ in range(max(1, min(5000, int(500 / max(ms, 1e-3))))):
        fn()
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    return float(r.stdout.strip().splitlines()[0])


def measure_case(torch, cases, name, shape, kernel_fn, plain_fn, compare,
                 inputs, ops, library_fn=None, info=None,
                 library_compare=None, **extra):
    """Compare, time and bound one kernel case; the row goes to
    cases[name].  `inputs`: the tensors the function reads (its outputs
    are counted from the kernel's); `ops`: its f32 operations;
    `library_fn`: one PyTorch call or library route for the same function,
    checked like the plain version or by `library_compare(its output,
    plain output)`; `info`: more keys of the row (a plan); `extra`: more
    timed routes, name -> fn."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = compare(out, ref)
    row = {"shape": shape, "max_abs_err": err,
           "ms": device_ms(torch, kernel_fn),
           "plain_ms": device_ms(torch, plain_fn), **(info or {})}
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(*inputs, *flat_outputs(out)), ops)
    row["library_ms"] = None
    if library_fn is not None:
        (library_compare or compare)(library_fn(), ref)
        row["library_ms"] = device_ms(torch, library_fn)
    for key, fn in extra.items():
        row[key] = device_ms(torch, fn)
    cases[name].append(row)
    lib = row["library_ms"]
    log(f"  {name:13s} {shape:42s} kernel {row['ms']:8.3f} ms  plain "
        f"{row['plain_ms']:9.3f}  bound {row['bound_ms']:6.3f} "
        f"({row['bound_by']})  library "
        f"{'-' if lib is None else f'{lib:.3f}'}  max_abs_err {err:.3g}"
        + "".join(f"  {k} {v:.3f}" for k, v in row.items() if k in extra)
        + "".join(f"  {k} {v}" for k, v in (info or {}).items()))
    return row


def same_knn(out, ref):
    """A kNN's (ids, d2) equal to the plain version's, bit for bit."""
    import torch

    assert torch.equal(out[0], ref[0]), "kNN indices differ"
    assert torch.equal(out[1], ref[1]), "kNN d2 differ"
    return 0.0


def flat_outputs(out):
    out = out if isinstance(out, (tuple, list)) else [out]
    return [t for t in out if t is not None]


def kernel_phase(torch, T, device, cases):
    """Phase 3: kernels A-G against their plain versions at the paths'
    shapes, each case's row into cases[name], the relocalisation's first."""
    case = partial(measure_case, torch, cases)

    def same(out, ref):
        assert torch.equal(out, ref), "indices differ"
        return 0.0

    def nearest(q, keys):
        """The library's 1-NN against the plain version's: its pick at the
        least d2 (built as the kernels build it), up to cdist's own
        rounding; the picks that differ (ties, near-ties) are counted."""
        def check(idx, ref):
            picked = torch.gather(keys, 1, idx[..., None].expand(-1, -1, 3))
            d = q - picked
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            least = ref[1][..., 0]
            assert (d2 <= least * (1 + 1e-5) + 1e-12).all(), \
                "the library's 1-NN is not a nearest key"
            differ = int((idx != ref[0][..., 0]).sum())
            log(f"  knn k=1 library route: {differ} of {idx.numel()} picks "
                f"differ from the plain version's, each at its least d2")
        return check

    def wsum_close(out, ref):
        err = (out - ref).abs().max().item()
        assert err <= WSUM_REL * ref.abs().max().item(), err
        return err

    # A, G and B at every shape of the path, with the plan each took; A's
    # instruction floor (the instructions every pair issues in its full
    # scan, over 128 lanes of every SM at the SM clock read just after)
    # and G's `scan_floor_ms`, the same for all its pairs: what a full scan
    # could take at best, which G's pruning takes it under (a yardstick,
    # not a bound: G's bound is its bytes); G's pre-pass alone, G beside A
    # at A's shapes (`g_ms`, forced to its own plan at that k), B's chain
    # floor (the fastest time an iteration of any plan at [20,1024]->1024,
    # times m - 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for c in knn_fps_cases(torch, T, device):
        extra, call = {}, c["call"]
        if "g_forced" in c:  # G at A's shape, beside A
            g_call = partial(c["g_forced"], c["g_plan"])
            same_knn(g_call(), c["plain"]())
            extra["g_ms"] = g_call
        if "prepass" in c:
            extra["prepass_ms"] = c["prepass"]
        rows.append((c, case(c["name"], c["label"], call, c["plain"],
                             same if c["name"] == "fps" else same_knn,
                             c["inputs"], c["ops"], info={"plan": c["plan"]},
                             library_fn=c.get("library"),
                             library_compare=(nearest(*c["inputs"])
                                              if "library" in c else None),
                             **extra)))
        if "g_plan" in c:
            rows[-1][1]["g_plan"] = c["g_plan"]
    chain = next((c, r) for c, r in rows if c.get("chain_plans"))
    chain[1]["plans_ms"] = {}
    for plan in chain[0]["chain_plans"]:
        fn = partial(chain[0]["forced"], plan)
        assert torch.equal(fn(), chain[0]["plain"]()), plan
        chain[1]["plans_ms"][str(list(plan))] = device_ms(torch, fn)
    best = min(chain[1]["plans_ms"], key=chain[1]["plans_ms"].get)
    chain_us = chain[1]["plans_ms"][best] * 1e3 / (chain[0]["m"] - 1)
    log(f"  fps {chain[0]['label']:42s} by plan {chain[1]['plans_ms']}: the "
        f"chain floor is {best}'s {chain_us:.3f} us an iteration")
    for c, row in rows:
        if c["name"] != "fps":
            row["sm_clock_mhz"] = mhz = sm_clock_mhz(torch, c["call"],
                                                     row["ms"])
            key = ("instruction_floor_ms" if c["name"] == "knn"
                   else "scan_floor_ms")
            row[key] = (KNN_FLOOR_INSTRUCTIONS_PER_PAIR * c["pairs"]
                        / (sms * 128) / (mhz * 1e6) * 1e3)
            log(f"  {c['name']} {c['label']:42s} {key} {row[key]:.3f} ms "
                f"at {mhz:.0f} MHz")
        else:
            row["us_per_iteration"] = row["ms"] * 1e3 / max(1, c["m"] - 1)
            row["chain_floor_ms"] = chain_us * (c["m"] - 1) / 1e3
            row["chain_floor_plan"] = best
            log(f"  fps {c['label']:42s} chain floor "
                f"{row['chain_floor_ms']:.3f} ms ({chain_us:.3f} us an "
                f"iteration); {row['us_per_iteration']:.3f} us an iteration")

    # C and D at every shape of the forward (`forward_cases`): the path's
    # own plan against the plain version and, for C, one sparse product;
    # then every forced plan, which must give the path's bits, timed.  The
    # moments also against the same sum on the weight tensor `flex_weights`
    # builds (same bits; `explicit_weights_ms`, `weights_build_ms`: what
    # left the path).
    def same_bits(out, ref):
        assert len(out) == len(ref)
        for a, r in zip(out, ref):
            nan = r.isnan() if r.is_floating_point() else None
            if nan is not None and nan.any():
                assert torch.equal(a.isnan(), nan), "NaN positions differ"
                a, r = a[~nan], r[~nan]
            assert torch.equal(a, r), "max values, ids or slots differ"
        return 0.0

    for c in forward_cases(torch, T, device):
        is_max = c["name"] == "neighbor_max"
        extra, library = {}, None
        if not is_max:
            idx, w, f = c["sparse"]
            S = sparse_rows(torch, idx, w, f.shape[1])  # not timed
            f2 = f.reshape(-1, f.shape[-1])
            library = lambda S=S, f2=f2, idx=idx: (torch.sparse.mm(
                S, f2).reshape(idx.shape[0], idx.shape[1], -1),)
        if "explicit" in c:
            same_bits(c["call"](), c["explicit"]())
            extra.update(explicit_weights_ms=c["explicit"],
                         weights_build_ms=c["weights"])
        row = case(c["name"], c["label"], c["call"], c["plain"],
                   same_bits if is_max else
                   (lambda out, ref: wsum_close(out[0], ref[0])),
                   c["inputs"], c["ops"], library_fn=library,
                   info={"plan": list(T.row_plan(c["C"], c["K"]))}, **extra)
        out = c["call"]()
        same_bits(c["call"](), out)  # two runs
        row["plans_ms"] = {}
        for plan in row_plans(T, c["C"], c["K"]):
            same_bits(c["forced"](plan), out)
            row["plans_ms"][str(list(plan))] = device_ms(
                torch, partial(c["forced"], plan), reps=3)
        log(f"    by plan {row['plans_ms']}")

    # E and F at every shape of the train step: the inverse handed in (as
    # on the path: `ms`, bounded by the bytes of the inverse it reads) and
    # built in the call (`ms_fresh_inverse`, bounded by those of nbh); both
    # give the same bits, as does a second run.  Library: the plain
    # version's route and its last call alone; the build alone.
    on_weights = {}  # E on the weight tensor, by label
    for c in backward_cases(torch, T, device):
        inv = T.NeighborInverse(c["nbh"], c["keys"])
        csr = inv.get()
        path, fresh = partial(c["call"], inv), c["call"]
        out = path()
        assert torch.equal(out, path()), f"{c['label']}: two runs differ"
        assert torch.equal(out, fresh()), \
            f"{c['label']}: shared and fresh inverse differ"
        if c["name"] == "weighted_sum_backward":
            on_weights[c["label"]] = out
        elif c["name"] == "flex_moments_backward":
            assert torch.equal(out, on_weights[c["label"]]), \
                f"{c['label']}: E on positions and on weights differ"
        case(c["name"], c["label"], path, c["plain"], wsum_close,
             (*c["reads"], *csr), c["ops"], library_fn=c["plain"],
             ms_fresh_inverse=fresh,
             inverse_build_ms=partial(T.inverse_neighbors, c["nbh"],
                                      c["keys"]),
             library_call_ms=c["library_call"])
        cases[c["name"]][-1]["fresh_bound_ms"] = bound(
            nbytes(*c["reads"], c["nbh"], out), c["ops"])[0]


def eval_cloud(seed, numpts):
    """A synthetic lidar-like scan through the local eval loader's
    normalisation: [numpts, 3] float32."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd

    cloud, ori_num = get_fixednum_pcd(
        lidar_like_scan(seed), numpts, randsample=False,
        need_downsample=True, rng=np.random.RandomState(seed))
    assert ori_num == numpts, (seed, ori_num)
    return cloud


def padded_eval_cloud(seed, numpts):
    """An undersized scan (9,000 points over +-16 m) through the local eval
    loader: ~8,300 real points, then ~8,100 rows of 1e5 sentinels to
    `numpts` (`get_fixednum_pcd` with randsample=False, as the eval loader
    calls it).  [numpts, 3] float32."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd

    cloud, real = get_fixednum_pcd(
        lidar_like_scan(seed, n_points=9000, extent=16.0), numpts,
        randsample=False, need_downsample=True,
        rng=np.random.RandomState(seed))
    assert real < numpts and (cloud[real:] == 1e5).all(), real
    return cloud


# ------------------ phase 4: the legacy Morton-band mode ------------------

def morton_sorted(torch, T, points):
    perm, _ = T.morton_perm(points)
    return torch.gather(points, 1,
                        perm[..., None].expand(-1, -1, 3)).contiguous()


def window_cases(torch, T, device):
    """Kernel H's shapes on the legacy path, (label, query, keys, k,
    window): the legacy forward's and extraction's self kNN, and a level
    that windows (a 32768-point scan's 4096 points: its kNN and 3-NN)."""
    from dh3d_tpu_torch.entry import entry_points

    fwd = morton_sorted(torch, T, torch.from_numpy(
        entry_points(20, 8192)).to(device))
    lidar = morton_sorted(torch, T, torch.from_numpy(
        eval_cloud(0, 16384)[None]).to(device))
    big = morton_sorted(torch, T, torch.from_numpy(
        lidar_like_scan(9, n_points=32768)[None] / np.float32(30.0)
    ).to(device))
    big_sub = T.gather_point(big, torch.sort(
        T.farthest_point_sample(big, 4096), dim=-1).values).contiguous()
    return [("self k=8 W=512 [20,8192] (legacy forward)", fwd, fwd, 8, 512),
            ("self k=8 W=512 [1,16384] (legacy extraction)", lidar, lidar,
             8, 512),
            ("self k=8 W=512 [1,4096] (a windowed level)", big_sub, big_sub,
             8, 512),
            ("cross k=3 W=256 [1,32768]->[1,4096] (its 3-NN)", big, big_sub,
             3, 256)]


def window_phase(torch, T, kernels, device, cases):
    """Phase 4: kernel H against its plain version, bit for bit, at the
    legacy path's shapes (`window_cases`) with its plan (lanes a query),
    each with its device time, bound (8 f32 operations for the d2 of every
    pair of each band: H computes them all), A's instruction floor over
    those pairs and its launches a call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, q, keys, k, w in window_cases(torch, T, device):
        pairs = q.shape[0] * q.shape[1] * w
        call = partial(T.knn_window, q, keys, k, w)
        row = measure_case(torch, cases, "knn_window", label, call,
                           partial(T.knn_window_plain, q, keys, k, w),
                           same_knn, (q, keys), 8 * pairs,
                           info={"k": k, "window": w, "pairs": pairs,
                                 "plan": T.window_plan(k, w, q.shape[0]
                                                       * q.shape[1])})
        before = kernels.KNN_WINDOW.launches
        call()
        torch.cuda.synchronize()
        row["launches_a_call"] = kernels.KNN_WINDOW.launches - before
        assert row["launches_a_call"] == 1
        row["sm_clock_mhz"] = mhz = sm_clock_mhz(torch, call, row["ms"])
        row["instruction_floor_ms"] = (KNN_FLOOR_INSTRUCTIONS_PER_PAIR * pairs
                                       / (sms * 128) / (mhz * 1e6) * 1e3)
        log(f"  knn_window {label:42s} instruction floor "
            f"{row['instruction_floor_ms']:.4f} ms at {mhz:.0f} MHz")


# ----------------------- phase 5: bf16 compute_dtype -----------------------

def bf16_close(out, ref):
    """Within one bf16 step of each value plus WSUM_REL of the largest;
    returns the largest difference."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert (err <= BF16_STEP * ref.abs()
            + WSUM_REL * ref.abs().max()).all(), err.max().item()
    return err.max().item()


def bf16_kernel_phase(torch, T, device, cases):
    """Phase 5: the bf16 cases of C and E at row 7's and row 10's
    shapes against their plain versions, each with its device time, bound
    (bf16 features and feature gradients count 2 bytes), library route and
    the f32 case's time on the same values (`f32_ms`)."""
    pts, sub, nbh, nbh1, _ = train_geometry(torch, T, device)
    B, N, K = nbh.shape
    M = sub.shape[1]
    g = torch.Generator(device="cpu").manual_seed(16)
    case = partial(measure_case, torch, cases)
    for C, pos, idx, keys in ((64, pts, nbh, N), (32, pts, nbh, N),
                              (64, sub, nbh1, M), (128, sub, nbh1, M)):
        label = f"P=4 C={C} K=8 [{B},{idx.shape[1]}] bf16"
        f = torch.randn(B, keys, C, generator=g).to(device).bfloat16()
        f32 = f.float()
        w = T.flex_weights(pos, idx)
        # the library route: one f32 sparse product on the bf16 deltas (its
        # m0 unrounded: within half a bf16 step)
        S = sparse_rows(torch, idx, torch.cat(
            [w[..., :1], w[..., 1:].bfloat16().float()], -1), keys)
        f2 = f32.reshape(-1, C)

        def moments_close(out, ref, C=C):
            o, r = out.view(*out.shape[:2], 4, C), ref.view(*ref.shape[:2],
                                                            4, C)
            err = bf16_close(o[:, :, 0], r[:, :, 0])
            rest = (o[:, :, 1:] - r[:, :, 1:]).abs().max().item()
            assert rest <= WSUM_REL * r[:, :, 1:].abs().max().item(), rest
            return max(err, rest)

        case("flex_moments_bf16", label,
             partial(T.flex_moments, f, pos, idx),
             partial(T.flex_moments_plain, f, pos, idx), moments_close,
             (f, idx, pos), 2 * w.numel() * C,
             library_fn=lambda S=S, f2=f2, idx=idx: torch.sparse.mm(
                 S, f2).reshape(idx.shape[0], idx.shape[1], -1),
             info={"plan": list(T.row_plan(C, K))},
             f32_ms=partial(T.flex_moments, f32, pos, idx))
        dm = torch.randn(B, idx.shape[1], 4 * C, generator=g).to(device)
        inv = T.NeighborInverse(idx, keys)
        csr = inv.get()
        plain = partial(T.flex_moments_backward_plain, dm, pos, idx, keys,
                        torch.bfloat16)
        case("flex_moments_backward_bf16", label.replace("P=4", "dM P=4"),
             partial(T.flex_moments_backward, dm, pos, idx, inv,
                     torch.bfloat16),
             plain, bf16_close, (dm, pos, idx, *csr), 2 * w.numel() * C,
             library_fn=plain,
             f32_ms=partial(T.flex_moments_backward, dm, pos, idx, inv))


# --------------- phase 6: kernel I, the loader's radius count ---------------

def host_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def radius_phase(torch, T, kernels, device, cases):
    """Phase 6: kernel I against its plain version and `cKDTree`, bit for
    bit, one launch a call: the raw extraction's count input (a
    30,000-point scan through the voxel grid, M ~ 27,800), an eval cloud
    (M = 16384) and the boundary cloud (`radius_boundary_cloud`); device
    ms, plain ms, the FP64 bound, `cKDTree`'s host ms; at the first two
    every split of RADIUS_PLANS, each equal."""
    from scipy.spatial import cKDTree

    from dh3d_tpu_torch.data.io import voxel_downsample
    from dh3d_tpu_torch.data.synthetic import radius_boundary_cloud

    def host_counts(cloud):
        return cKDTree(cloud).query_ball_point(cloud, r=1.0,
                                               return_length=True)

    for name, cloud in (("raw scan", voxel_downsample(lidar_like_scan(40))),
                        ("eval cloud", eval_cloud(41, 16384)),
                        ("boundary", radius_boundary_cloud(0))):
        pts = torch.from_numpy(cloud).to(device)
        m = len(cloud)
        before = kernels.RADIUS_COUNT.launches
        got = T.radius_count(pts, 1.0)
        torch.cuda.synchronize()
        assert kernels.RADIUS_COUNT.launches == before + 1
        plain = T.radius_count_plain(pts, 1.0)
        assert torch.equal(got, plain), name
        assert np.array_equal(got.cpu().numpy(), host_counts(cloud)), name
        row = {"shape": f"r=1 M={m} ({name})", "max_abs_err": 0.0,
               "plan": T.radius_plan(m, kernels.sm_count(device.index or 0)),
               "ms": device_ms(torch, partial(T.radius_count, pts, 1.0)),
               "plain_ms": device_ms(torch, partial(T.radius_count_plain,
                                                    pts, 1.0), reps=3),
               "bound_ms": 1e3 * m * m * RADIUS_FP64_PER_PAIR
               / FP64_INSTRUCTIONS_PER_S, "bound_by": "FP64 operations",
               "library_ms": None,
               "ckdtree_host_ms": host_ms(partial(host_counts, cloud), 3)}
        if name != "boundary":
            row["plans_ms"] = {}
            for plan in RADIUS_PLANS:
                fn = partial(T.radius_count, pts, 1.0, plan=plan)
                assert torch.equal(fn(), plain), plan
                row["plans_ms"][plan] = device_ms(torch, fn)
        log(f"  radius_count {name} M={m} plan {row['plan']}: kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f}, bound "
            f"{row['bound_ms']:.3f} (FP64), cKDTree (host) "
            f"{row['ckdtree_host_ms']:.1f}"
            + (f"; splits {row['plans_ms']}" if "plans_ms" in row else ""))
        cases["radius_count"].append(row)


# ------------ phase 7: kernel J, train-mode BatchNorm + relu ------------

# kernel J at the main path's train-mode BatchNorm shapes (the card tests'
# BN_SHAPES): stage 2's nine widths over 163840 points and two over 20480,
# stage 3's head over 196608 points and its 24 descriptors
BATCHNORM_SHAPES = ((163840, 32), (163840, 64), (163840, 128), (163840, 256),
                    (163840, 1024), (20480, 128), (196608, 1024),
                    (196608, 64), (24, 256))
BATCHNORM_PASSES = {"forward": 3, "backward": 5}  # [rows, C] f32 passes
BATCHNORM_KERNELS = ("batch_norm_stats", "batch_norm_forward",
                     "batch_norm_grad_sums", "batch_norm_grad_dx")


def batchnorm_phase(torch, T, kernels, device, cases):
    """Phase 7: kernel J, train-mode BatchNorm + relu.

    At each of BATCHNORM_SHAPES, with the relu (as every caller on the
    path but NetVLAD's three asks): J's forward (`fwd_ms`) and forward +
    backward (`ms`) as device time, each entry point launched once a call;
    the byte bound (3 passes of [rows, C] f32 forward, 5 backward, at 3.35
    TB/s); the plain version (`ops.batch_norm_plain` with autograd's
    backward) and, as `library_ms`, `F.batch_norm(training=True)` + relu
    (cuDNN; the port never calls it), both forward + backward.  J must give
    the same bits twice, and its output and gradients must be within 1e-5
    (output) and 1e-4 (gradients) of the plain version's largest value, on
    inputs with no normalised value within 1e-3 of 0 (where rounding could
    flip the relu's gradient between the two)."""
    import torch.nn.functional as F

    for rows, C in BATCHNORM_SHAPES:
        g = torch.Generator(device=device).manual_seed(rows + C)
        x = torch.randn(rows, C, device=device, generator=g) * 2 + 1
        dy = torch.randn(rows, C, device=device, generator=g)
        scale = torch.rand(C, device=device, generator=g) + 0.5
        bias = torch.randn(C, device=device, generator=g)
        # x whose normalised value lies within 1e-3 of 0 moved 2e-3 / mul
        # away, so that rounding flips no relu gradient between versions
        xd = x.double()
        mean = xd.mean(0)
        mul = torch.rsqrt((xd * xd).mean(0) - mean * mean + 1e-5) * scale
        y = (xd - mean) * mul + bias
        x = torch.where(y.abs() < 1e-3,
                        xd + torch.where(y >= 0, 2e-3, -2e-3) / mul,
                        xd).float()
        del xd, y
        xg, sg, bg = (t.clone().requires_grad_() for t in (x, scale, bias))

        def call(fn, backward=True):
            """y and, with `backward`, the gradients of x, scale and bias
            (returned, not accumulated: no pass over x.grad)."""
            stats = (torch.zeros(C, device=device),
                     torch.ones(C, device=device))
            y = fn(xg, sg, bg, *stats)
            if backward:
                return [y, *torch.autograd.grad(y, (xg, sg, bg), dy)]
            return [y]

        ours = partial(T.batch_norm_train, momentum=0.9, eps=1e-5, relu=True)
        plain = partial(T.batch_norm_plain, momentum=0.9, eps=1e-5,
                        relu=True)

        def library(x_, s_, b_, *_):
            return torch.relu(F.batch_norm(x_, None, None, s_, b_,
                                           training=True, eps=1e-5))

        outs = []
        for fn in (ours, ours, plain):
            before = kernels.counts()
            outs.append([t.detach() for t in call(fn)])
            torch.cuda.synchronize()
            launched = {k: kernels.counts()[k] - before[k]
                        for k in BATCHNORM_KERNELS}
            assert set(launched.values()) == ({1} if fn is ours else {0}), \
                launched
        for a, b in zip(outs[0], outs[1]):
            assert torch.equal(a, b), (rows, C)
        errs = [(a - p).abs().max().item() for a, p in zip(outs[0], outs[2])]
        rel = [e / p.abs().max().item() for e, p in zip(errs, outs[2])]
        assert rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4, (rows, C, rel)
        nbytes_pass = rows * C * 4
        with torch.no_grad():
            fwd_ms = device_ms(torch, partial(call, ours, False))
        row = {"shape": f"[{rows}, {C}]",
               "plan": list(T.bn_plan(rows, C,
                                      kernels.sm_count(device.index or 0))),
               "fwd_ms": fwd_ms,
               "ms": device_ms(torch, partial(call, ours)),
               "fwd_bound_ms": BATCHNORM_PASSES["forward"] * nbytes_pass
               / MEMORY_BYTES_PER_S * 1e3,
               "bound_ms": sum(BATCHNORM_PASSES.values()) * nbytes_pass
               / MEMORY_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "plain_ms": device_ms(torch, partial(call, plain), reps=3),
               "library_ms": device_ms(torch, partial(call, library),
                                       reps=3),
               "max_abs_err": max(errs), "rel_err_vs_plain": rel}
        log(f"  batch_norm [{rows}, {C}] plan {row['plan']}: J "
            f"{row['ms']:.3f} ms (forward {row['fwd_ms']:.3f}), bound "
            f"{row['bound_ms']:.3f} (forward {row['fwd_bound_ms']:.3f}), "
            f"plain {row['plain_ms']:.3f}, library {row['library_ms']:.3f};"
            f" relative gaps to plain {rel}")
        cases["batch_norm_train"].append(row)
        del x, dy, xg, outs
        torch.cuda.empty_cache()


def main():
    import argparse

    ap = argparse.ArgumentParser(
        description="the per-kernel table of PERF.md §6 (module docstring)")
    ap.add_argument("--sweep", action="store_true",
                    help="time every plan of kernels G, B, H, C and D into "
                    "chiprun_out/sweep.json beside this script")
    sweep = ap.parse_args().sweep
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 and round once, as the JAX function's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)

    from dh3d_tpu_torch import kernels
    from dh3d_tpu_torch import ops as T

    log("phase 2: build")
    path, build_s = kernels.build()
    kernels.library()
    log(f"  built {path} in {build_s:.1f} s")
    if sweep:
        sweep_run(torch, T, device, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "chiprun_out"))
        log(card_line())
        return

    cases = {name: [] for name in KERNELS}
    log("phase 3: kernels A-G against their plain versions")
    kernel_phase(torch, T, device, cases)
    log("phase 4: kernel H, the legacy Morton-band mode")
    window_phase(torch, T, kernels, device, cases)
    log("phase 5: the bf16 cases of kernels C and E")
    bf16_kernel_phase(torch, T, device, cases)
    log("phase 6: the loader's radius count (kernel I)")
    radius_phase(torch, T, kernels, device, cases)
    log("phase 7: train-mode BatchNorm + relu (kernel J)")
    batchnorm_phase(torch, T, kernels, device, cases)

    kernel_rows = [{
        "name": name, "kernel": KERNELS[name], "shape": rows[0]["shape"],
        **{k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in rows), "cases": rows}
        for name, rows in cases.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def sweep_run(torch, T, device, out_dir):
    """Every plan kernels G and B take at each shape of `knn_fps_cases`
    (A and G's plans at A's shapes; output checked equal to the plain
    version), kernel H at each of `window_cases` and kernels C and D at
    each shape of `forward_cases` (equal to the path's), device time;
    written to `out_dir`/sweep.json."""
    report = {"card": card_line(), "cases": []}
    for c in knn_fps_cases(torch, T, device):
        ref = c["plain"]()
        row = {"name": c["name"], "label": c["label"], "plan": c["plan"],
               "ms": {}}
        # A's shapes: A, then every plan of G (where `knn` draws the line)
        routes = [("", c["forced"], c["plans"])] if "forced" in c else [
            ("", lambda plan: c["call"](), ["own"])]
        if "g_forced" in c:
            row["g_plan"], row["g_ms"] = c["g_plan"], {}
            routes.append(("g_", c["g_forced"], (0, 1)))
        for prefix, forced, plans in routes:
            for plan in plans:
                fn = partial(forced, plan)
                try:
                    out = fn()
                except ValueError:  # a plan whose blocks cannot hold it
                    continue
                for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                                  for o in (out, ref))):
                    assert torch.equal(a, b), (c["label"], plan)
                key = str(plan if isinstance(plan, (int, str))
                          else list(plan))
                row[prefix + "ms"][key] = ms = device_ms(torch, fn)
                log(f"  {c['name']} {c['label']:42s} {prefix}plan {key} "
                    f"{ms:.4f} ms")
        best = min(row["ms"], key=row["ms"].get)
        log(f"  {c['name']} {c['label']:42s} best {best} "
            f"{row['ms'][best]:.4f} ms; the plan's {c['plan']} "
            f"{row['ms'].get(str(c['plan']))}")
        if row.get("g_ms"):
            g_best = min(row["g_ms"], key=row["g_ms"].get)
            log(f"  {c['name']} {c['label']:42s} G's best {g_best} "
                f"{row['g_ms'][g_best]:.4f} ms; G's plan {c['g_plan']} "
                f"{row['g_ms'].get(str(c['g_plan']))}")
        report["cases"].append(row)
    from dh3d_tpu_torch.ops.knn import WINDOW_LANES

    for label, q, keys, k, w in window_cases(torch, T, device):
        ref = T.knn_window_plain(q, keys, k, w)
        own = T.window_plan(k, w, q.shape[0] * q.shape[1])
        row = {"name": "knn_window", "label": label, "plan": own, "ms": {}}
        for lanes in WINDOW_LANES:
            fn = partial(T.knn_window, q, keys, k, w, plan=lanes)
            same_knn(fn(), ref)
            row["ms"][str(lanes)] = device_ms(torch, fn)
        best = min(row["ms"], key=row["ms"].get)
        log(f"  knn_window {label:42s} best {best} {row['ms'][best]:.4f} "
            f"ms; the plan's {own} {row['ms'][str(own)]:.4f}; {row['ms']}")
        report["cases"].append(row)
    for c in forward_cases(torch, T, device):
        if c.get("nan") or ("+" in c["label"] and "+id +slot" not in
                            c["label"]):
            continue  # D: the path's call and the one with every output
        ref = c["call"]()
        own = list(T.row_plan(c["C"], c["K"]))
        row = {"name": c["name"], "label": c["label"], "plan": own, "ms": {}}
        for plan in row_plans(T, c["C"], c["K"]):
            fn = partial(c["forced"], plan)
            for a, b in zip(fn(), ref):
                assert torch.equal(a, b), (c["label"], plan)
            row["ms"][str(list(plan))] = device_ms(torch, fn, reps=3)
        best = min(row["ms"], key=row["ms"].get)
        log(f"  {c['name']} {c['label']:42s} best {best} "
            f"{row['ms'][best]:.4f} ms; the plan's {own} "
            f"{row['ms'][str(own)]:.4f}; {row['ms']}")
        report["cases"].append(row)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sweep.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
