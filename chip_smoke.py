"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases; any failure raises, so the script exits non-zero and prints no
result line:
  1. the card (`nvidia-smi` name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build the kernels from `dh3d_tpu_torch/csrc` (one nvcc per source, in
     parallel; timed).
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the forward, the train step, the extraction and the pair
     generation give it.  Each case is timed as device time
     (`device_ms`: calls queued back to back behind a sleep kernel, between
     two CUDA events, so the host's launch work is hidden).  Beside each:
     its bound (`bound`: the bytes of its inputs and outputs over the
     memory rate or its f32 operations over the f32 rate, whichever is
     larger) and, where PyTorch has one, the library route for the same
     function (`library_ms`).  Each kernel's first case is at the
     relocalisation's shapes (phase 12: batch 1, N=4096, its FPS to 512,
     and its NMS's 50-NN), whose numbers the kernels line reports for the
     kernels that path runs.  Kernels C and D run at
     every shape of the forward (`forward_cases`: the moments through
     `flex_moments`, which must give the bits of `weighted_sum` on the
     weight tensor; D with and without its ids and its slot, and once on
     features with NaNs), with the time of the weight build that left the
     path and of every forced launch plan (`row_plans`), each of which
     must give the path's bits.  Kernels E and F run at
     every shape of the train step (`backward_cases`), with the CSR inverse
     handed in (as on the path: `ms`, bounded by the inverse's bytes) and
     built in the call (`ms_fresh_inverse`, bounded by nbh's), and must
     give the same bits both ways and on a second run; E at P = 4 both on
     the weight tensor and on the positions (the same bits); the inverse's
     build is timed alone.  Kernels A, G and B run at every shape of the
     path (`knn_fps_cases`: the forward's, the train step's and the
     extraction's; A the 3-NN, G every k >= 8, and keypoint NMS's self
     k=50 on the loader-order and the Morton-sorted lidar cloud, on an
     undersized scan the loader pads with 1e5 sentinels (also at k=8), at
     the dso size, across clouds and at k=33 and 128; A the pair
     generation's 1-NN [10,512]x[10,8192], beside its library route
     `torch.cdist(...).argmin(-1)`; B its FPS [10,4096]->512), each with
     the plan it took.  A kNN's bound counts its bytes and the d2 of the pairs it
     returns.  Beside A's bound its instruction floor (the 7 instructions
     every pair issues in its full scan's x-y test, over 128 lanes of every
     SM at the SM clock `nvidia-smi` reads under load), beside G's the same
     for all its pairs (`scan_floor_ms`: a full scan's best, which G's
     pruning takes it under; not a bound), G's pre-pass alone
     (`prepass_ms`) and, at each A shape, G forced to its plan (`g_ms`);
     beside B's its chain floor (the fastest time an iteration of any plan
     at [20,1024]->1024, times m - 1).
  4. the main-path forward (`dh3d_tpu_torch.entry.entry`) at [20, 8192]:
     every forward kernel's launch count over that one forward must be > 0;
     the outputs must be finite, of the model's shapes, with unit-norm
     descriptors; clouds/s and a `torch.profiler` split.
  5. the same forward at [2, 8192] on the card and on the CPU (plain
     versions), same weights and clouds: indices equal, descriptors within
     the tolerances below.
  6. the training slice's main path: `detection_config` train steps at full
     width ([20, 8192], 512 keypoints; the sizes of
     `models/demo_stage2.config.json`), weights from `models/demo_stage2.npz`
     through the port's warm-start loader, seeded synthetic batches.  Over
     one step every kernel A-F is launched; loss and metrics are finite;
     every trainable gradient is finite and nonzero (but the biases that
     feed a BatchNorm, whose exact gradient is 0); the BN running
     statistics move; each neighbourhood's CSR inverse is built once.  Step
     time (CUDA events), clouds/s, peak memory, the forward / backward /
     optimizer split and a `torch.profiler` split, with the device time of
     kernels E and F and of the inverse builds.
  7. one train step at [2, 8192] on the card and on the CPU, same weights
     and batch: Morton order, kNN, FPS, 3-NN and the detection loss's kNN
     equal; losses and gradients within the tolerances below.
  8. local descriptor extraction at the reference's eval sizes through the
     port's CLI code (`dh3d_tpu_torch.evaluate.localdesc_extract.main`),
     `models/demo_stage2`, on 8 seeded synthetic lidar-like scans of
     30,000 points written as .bin files: keypoint NMS at N=16384 (k=50,
     radius 0.5, ratio 0.01, 512 keypoints); one dense `--save_all` cloud;
     one `oxford_dso` cloud at N=9000.  Kernels A, B, C, D and G must each
     be launched by the NMS extraction; every keypoint file holds <= 512
     finite rows of 132 floats with unit-norm descriptors.  Clouds/s end
     to end, split into load + normalise, forward, NMS and write; peak
     memory.  Then `globaldesc_extract.main` with `models/demo_stage3` on
     the same scans at [4, 8192], with recall.
  9. one N=16384 scan through the extraction forward on the card and on
     the CPU: Morton order, kNN, FPS and 3-NN equal, descriptors and
     attention within the phase-5 tolerances; the 50-NN (ids and d2) and
     the NMS keypoints of the card's xyz and attention equal on both; the keypoints that
     differ between card-forward + card-NMS and CPU-forward + CPU-NMS are
     counted (reported, not checked).
 10. training from disk through the port's CLI
     (`dh3d_tpu_torch.train.__main__.main`, in this process) on 36 seeded
     lidar-like scans of 30,000 points written as .bin files with the two
     GT pickles `train.py` reads (places of 3 scans): (a) `detection_config`
     with `models/demo_stage2.config.json`'s values ([20, 8192], 512
     keypoints, `device_pairgen` and `morton_presorted`, prefetch 2),
     warm-started from `models/demo_stage2.npz`, 4 steps: one step launches
     B and A each exactly once more than phase 6's step (the pairs' FPS and
     1-NN) and every other kernel as often (but I, the prefetch thread's:
     each run counts at least one launch of I a cloud it trained on); the pairs of its first batch,
     rebuilt on the card, hold (anchors unique, ids in range, pc2 back
     from R, positives the plain 1-NN); (b) the host pair path, 2 steps;
     (c) `global_config` with `models/demo_stage3.config.json`'s values
     ([24, 8192], presorted) and `augment_on_device`, from
     `models/demo_stage3.npz`, 2 steps; (d) the curriculum's warm start
     from the port's own checkpoints: one `basic_config` step, then one
     `detection_config` step with `--load` its logdir, which must restore
     every tensor stage 1 saved.  Each: metrics finite; the step on
     CUDA events, clouds/s on the host clock, the wait in `next(batches)`
     and its share of the step, the loader's ms a cloud alone, peak memory.
 11. the pair generation at [2, 8192], 64 anchors, on the card and on the
     CPU from the same draws: anchors and positives equal, points within
     1e-6 of their scale.
 12. 6DoF relocalisation through the port's CLI
     (`dh3d_tpu_torch.evaluate.relocalize.main`, in this process) with its
     defaults (N=4096, batch 1, 256 NMS keypoints, 500 RANSAC hypotheses),
     `models/demo_stage2` (local) and `models/demo_stage3` (global), on 12
     seeded lidar-like database scans of 30,000 points and 4 queries made
     from them by a rigid motion and jitter, with their GT pickles.
     Kernels A, B, C, D and G must each be launched over the run; every
     global and local descriptor finite and of unit norm; >= 3 mutual
     matches a query.  Clouds/s, ms a cloud (load + normalise, global
     forward), ms a query (local forwards, NMS, matching, RANSAC), launches
     a query, peak memory.  Then `registration_eval --self_test` on a
     keypoint file of phase 8 (success, RTE < 1e-6 m, RRE < 1e-4 deg);
     `registration_eval --pairs` on the extractions of a scan and a
     rigidly moved copy with its T_gt (reported: the demo weights never
     saw these scans); `repeatability_eval --protocol both` on 4 scans.
 13. (a) mutual matching and RANSAC of phase 12's pair on the card and on
     the CPU: the same matches and inlier sets, R and t within 1e-9, and
     the same as the JAX package's host loop (`ransac_host_loop`), whose
     time is given beside the batched RANSAC's; (b) the relocalisation CLI
     on 2 queries and 4 database clouds on the card and with `--device
     cpu`: the same top-1 and NMS keypoints; the queries whose matches or
     inliers differ are counted (reported, not checked).
 14. the legacy Morton-band mode (`morton_exact=False`): (a) kernel H
     (`knn_window`) against its plain version, ids and d2 bit for bit, at
     the legacy path's shapes (the self kNN k=8 W=512 at [20, 8192] and
     [1, 16384]; a windowed level's self kNN at [1, 4096] and its 3-NN W=256
     from [1, 32768]; `window_cases`), each at its plan (`window_plan`:
     lanes a query) with its device time, bound, A's instruction floor
     over its pairs and one launch a call; every tile's band start of
     `WINDOW_START_SHAPES` read back from H against the formula; (b) the
     main-path model with morton_exact=False at [20, 8192]: over one
     forward H once, G one time fewer than phase 4's, A-D as often, the
     outputs checked as phase 4's, clouds/s beside the exact forward's in
     turns; (c) that forward at [2, 8192] on the card and on the CPU, as
     phase 5; (d) one legacy `detection_config` step and one phase-6 step
     with `remat` at [20, 8192]: finite losses, launches, step time and
     peak memory beside phase 6's; (e) `flex_avg` and `flex_deconv` on the
     card against their plain versions; (f) the port's error-budget CLI
     (`dh3d_tpu_torch.evaluate.error_budget`) with the demo weights on two
     sequences of 4 normalised lidar-like scans at N=8192: all four
     stages, every number finite, 0 < agreement <= 1 (the values are
     reported, not checked: the demo weights never saw such scans).
 15. the port's top-level entry points at full width: (a) the bench
     (`dh3d_tpu_torch.bench.collect`, all seven workloads in this process,
     its JSON line printed): every value finite and > 0; over one call,
     `fwd_fast` launches what phase 4's forward launches, `train_fast`
     A-G, `knn_ms` G alone, `flex_ms` C alone (its moments), and
     `fwd_parity`, `train_pre` and `train_cps` A-D and G (their counts
     logged); each workload's peak memory; `fwd_fast` beside phase 4's
     clouds/s (reported: the weights differ); (b) the three-stage
     curriculum script (`dh3d_tpu_torch.scripts.train_demo_curriculum`)
     on phase 10's pool, one step a stage at the presets' widths: stage 2
     restores every tensor stage 1 saved, stage 3 exactly stage 2's
     `local_backbone.*` tensors, which stage 3 keeps bit for bit (frozen);
     a second call with the same `--out` runs no stage; (c) the exporter
     (`dh3d_tpu_torch.scripts.package_checkpoint`) on stage 3's logdir:
     the keys and shapes of `models/demo_stage3.npz`; the export and the
     logdir give the same forward bits at [4, 8192] on the card through
     `train.resolve_model`; stage 2's export holds the same
     `local_backbone` arrays; (d) `python -m dh3d_tpu_torch.train
     --profile` over 16 synthetic `detection_config` steps at [20, 8192]:
     the Chrome trace under `<logdir>/profile/` names the CUDA kernels of
     A-G.
 16. the bf16 compute_dtype: (a) the bf16 cases of kernels C and E
     (`flex_moments_bf16`, `flex_moments_backward_bf16`) against their
     plain versions at the forward's and the step's shapes ([20, 8192]
     with C = 32 and 64, [20, 1024] with C = 64 and 128), each with its
     device time, bound (bf16 features at 2 bytes), library route and the
     f32 case's time on the same values; (b) `entry()`'s model with
     compute_dtype="bfloat16" and the demo weights at [20, 8192]: over one
     forward the bf16 case of C 5 times, the f32 case never, every other
     kernel as often as phase 4's; outputs checked as phase 4's; clouds/s
     and peak memory in turns with the f32 forward, and a profiler split;
     (c) that forward at [2, 8192] on the card and on the CPU: indices
     equal, outputs f32 and within the bf16 limits below, and closer to
     the CPU's bf16 forward than its f32 forward is; (d) the phase-6 step
     in bf16: launches (E's bf16 case as often as phase 6's f32 case),
     gradients, BN statistics, split and peak memory beside phase 6's; (e)
     bf16 against f32 on 4 normalised lidar-like clouds, demo weights: the
     cosines of the local and global descriptors and the NMS keypoint
     overlap (reported, not checked); (f) the training CLI with `--set
     compute_dtype='"bfloat16"'` (3 synthetic steps at [20, 8192]), the
     exporter on its logdir (the config keeps the key), the local
     extraction CLI from the export (NMS, 2 scans) and the global one from
     demo_stage3's arrays under a bf16 config.  bf16 products accumulate
     in f32 (`allow_bf16_reduced_precision_reduction` off).
 17. the parallel path (`dh3d_tpu_torch.parallel`).  The machine has one
     card and NCCL refuses two ranks on one device, so two ranks share
     `cuda:0` through gloo (`backend="gloo"` of the mesh helper), in one
     launch (`parallel.launch.spawn`) for (a), (b) and (d): (a) a
     `global_config` step with `cross_device_mining` at
     `models/demo_stage3.config.json`'s values (2 tuples of 1 + 2 + 8 + 1
     clouds: 24 clouds of 8192 points, 12 a rank; no warmup, whose
     learning rate is 0 at step 0), the local backbone of
     `models/demo_stage3.npz`, the head from seed 0, unit-scale clouds
     presorted; (b) a `detection_config` step at
     `models/demo_stage2.config.json`'s values (10 pairs of 8192 points,
     512 keypoints, `device_pairgen` on presorted clouds: B and the
     pairgen's A on each rank), `models/demo_stage2.npz`, the pairs' draws
     made once on the card; each against the one-process step on the
     card from the same weights and draws: metrics, reduced gradients,
     BN statistics, the updated parameters and Adam's moments at the CPU
     tests' tolerances (`DP_*`), the state equal on both ranks, and every
     kernel the one-process step launches launched by each rank's step;
     (c) `python -m dh3d_tpu_torch.train --num_devices 1` on NCCL
     (`detection_config`, synthetic, 3 steps at demo_stage2's values,
     warm-started): finite metrics, one checkpoint; `--num_devices 2`
     raises on a machine with one card; (d) `knn_sharded` on the two
     ranks at [20, 8192] and [1, 16384], k=8: ids and distances equal to
     `knn_bruteforce` bit for bit, G launched on each rank; (e)
     `dryrun_multichip(2)` on CPU processes.  Step times on CUDA events
     (median of 3 further steps) of both ranks, of the one-process step
     and of the NCCL run, beside the card and its power limit: correctness
     runs (two ranks share one card), no measure of scaling.
 18. the loader's radius count, kernel I (`ops.radius_count`, the outlier
     removal of `data.io.get_fixednum_pcd` on a card): against its plain
     version and `cKDTree` bit for bit at the raw extraction's M (~27,800,
     a 30,000-point scan through the voxel grid), at M = 16384 and on the
     boundary cloud, with its device time, FP64 bound, plain time,
     `cKDTree`'s host time and every key split at the first two M;
     `remove_radius_outlier` on the card and on the host; the eval loader
     over 6 scans yielding the clouds of the `cKDTree` path with one
     launch a cloud, and its load a cloud both ways; the loader in the
     prefetch thread not waiting for a sleep kernel on the default stream.
 19. train-mode BatchNorm + relu, kernel J (`ops.batch_norm_train`), at
     the train steps' shapes: its device time forward and forward +
     backward beside its byte bound (3 passes forward, 5 backward), the
     plain version's and `F.batch_norm` + relu's (`library_ms`); the same
     bits twice, close to the plain version.
The last three lines: the card, the kernels JSON, the ok JSON.

    python3 chip_smoke.py --parallel

runs phases 1, 2 and 17 alone (no kernels line), and

    python3 chip_smoke.py --loader

phases 1, 2 and 18.

To compare two trees of the port on one card (run them in turns: parent,
change, change, parent, in one call):

    python3 chip_smoke.py --ab-root DIR --label NAME [--out OUT]
    python3 chip_smoke.py --ab-compare OUT/ab_*.json

The first imports `dh3d_tpu_torch` from DIR (a checkout, or a tree unpacked
there with `git archive`; it needs `ops.inverse_neighbors` and the kernel
launch counts) and writes OUT/ab_NAME.json (OUT defaults to `chiprun_out`
beside this script): for every case of `knn_fps_cases` (A, G and B with
the tree's own plans), of `forward_cases` (C and D as the tree's path
calls them: a tree from before `flex_moments` builds the weight tensor
first, and that build is also timed alone), of `window_cases` (H at the
tree's own plan) and of `backward_cases`, the output's sha256 and its
device time (E and F called without an inverse: the tree's own route,
which builds the inverse in the call, as the parent of the shared inverse
did on its path; and the build alone); one full-width forward and one
batch-1 extraction forward at N=16384 (`models/demo_stage2`, as phase 9 runs it): output
hashes, median of 10 with CUDA events, and the profiler's device time of
one call by kernel class, so the device's idle share; over one full-width
train step, the inverses built, the launches of E and F, the profiler's
device time of E, F and the builds, the step time (median of 7) and the
peak memory.  The second checks that every case's hash and both forwards'
agree across the files (but a case with NaN inputs, and a case only some
trees have) and prints the times side by side.

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
"""

from __future__ import annotations

import gc
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

# Phase 5 tolerances, card vs CPU.  Every index (Morton order, kNN, FPS,
# 3-NN) is computed from the coordinates alone with the same rounded
# operations on both sides, so it must be equal.  Features differ only in
# summation order (FMA accumulation in the kernels, other matmul blocking):
# ~1e-6 relative, held here to 1e-4 absolute on the unit-scale outputs and
# 1e-5 of the largest magnitude on the unnormalised `feat`.
CARD_VS_CPU_ATOL = 1e-4
CARD_VS_CPU_FEAT_REL = 1e-5
# Phase 3: weighted sums and their backward against their plain versions,
# same reason; the max backward adds the same terms in the same order.
WSUM_REL = 1e-5
# Phase 7 tolerances, card vs CPU train step.  Indices as in phase 5.
# Losses: f32 summation order through ~30 layers and a BatchNorm on batch
# statistics at each, ~1e-6 relative; held to 1e-4.  Gradients: the same
# rounding, amplified by the BatchNorm backward (a difference of large
# means); each held to 1e-3 of its tensor's largest magnitude.  The
# gradients of biases that feed a BatchNorm are 0 exactly (rounding noise
# on both sides) and are held to 1e-3 of the model's largest gradient.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
# Phase 17, the data-parallel step against the one-process step on the
# card.  The two differ only in the order of f32 sums (the gradient
# all-reduce, a GEMM's weight gradient over a rank's rows; kernel J's
# BatchNorm sums are exact to f64 rounding, so its statistics do not
# depend on how the rows are split).  At full width that order alone can
# move some gradients by more than phase 7's limits: with PyTorch's f32
# BatchNorm sums, the one-process step on the same batch with its tuples
# (pairs) in reverse order, the same function, moved the attention block's
# BN bias gradient by 2.0e-3 of its scale (global_config) and a backbone
# BN bias's by 1.2e-3 (detection_config), and the mined loss by 1.7e-5 of
# itself.
# So each kind of difference is held to the larger of its limit below and
# twice that order noise, measured in the same run (`step_errors` of the
# reversed batch): metrics TRAIN_LOSS_REL of the total, gradients
# TRAIN_GRAD_REL of their scale (the biases that feed a BatchNorm: of a
# tenth of the largest gradient), BN statistics TRAIN_LOSS_REL of their
# scale plus 1e-6 (a mean of about 0 is rounding noise), Adam's moments
# 0.1 g and 0.001 g^2 at twice the gradients' limit; parameters: Adam's
# first step moves each by about lr * sign(g), so they agree to 1e-6 where
# |g| is above 1e-2 of its tensor's scale and within 2 lr elsewhere.
# `tests/test_torch_parallel.py` holds the step to 1e-5 and 1e-4 against
# JAX at the CPU tests' sizes, where that noise is smaller.
DP_METRIC_REL = TRAIN_LOSS_REL
DP_GRAD_REL = TRAIN_GRAD_REL
DP_BN_REL = TRAIN_LOSS_REL
# Phase 16, bf16 (PERF.md §2's bf16 limits).  One bf16 step is up to 2^-7
# of a value.  (a) the bf16 cases of C and E against their plain versions:
# a value rounded to bf16 (C's m0, E's output) within one step plus
# WSUM_REL of the tensor's largest (the f32 sums before the rounding
# differ in order, so a value near a rounding boundary lands one step
# apart), C's f32 moments within WSUM_REL.  (c) card against CPU: such
# flips spread through the layers, so unit-scale outputs are held by their
# largest difference and their root mean square, `feat` by shares of its
# largest magnitude; and each descriptor's rms difference must be under
# half the CPU's bf16-f32 one, which a forward that ran f32 would not be.
BF16_STEP = 2.0 ** -7
BF16_CARD_VS_CPU = {"local_desc": (0.2, 1e-3), "attention": (4e-2, 3e-3),
                    "global_desc": (2e-4, 5e-5),
                    "xyz_feat_att": (0.2, 1e-3)}
BF16_FEAT_REL = (1e-2, 5e-5)
BF16_CLOSER = 2.0

BANDED = "dh3d_tpu/ops/pallas/banded_pallas.py"
REPLACES = {
    # A: the banded 3-NN; G: the slab kNN, and the packed and exact
    # kernels' shapes from k = 8 up (A keeps them below)
    "knn": ("dh3d_tpu/ops/pallas/knn_pallas.py:149", []),
    # H: the same kernel's band of W < M key rows (the legacy mode)
    "knn_window": ("dh3d_tpu/ops/pallas/knn_pallas.py:149", []),
    "knn_topk": ("dh3d_tpu/ops/pallas/knn_pallas.py:259",
                 ["dh3d_tpu/ops/pallas/knn_pallas.py:34",
                  "dh3d_tpu/ops/pallas/knn_pallas.py:112"]),
    "fps": ("dh3d_tpu/ops/pallas/fps_pallas.py:31", []),
    "weighted_sum": (f"{BANDED}:77", [f"{BANDED}:1294"]),
    "flex_moments": (f"{BANDED}:432", [f"{BANDED}:1294"]),
    # C's bf16 case: the kernel's bf16 feature window (`:565`)
    "flex_moments_bf16": (f"{BANDED}:432", [f"{BANDED}:1294"]),
    "neighbor_max": (f"{BANDED}:896", []),
    "weighted_sum_backward": (f"{BANDED}:147", [f"{BANDED}:105",
                                                f"{BANDED}:1294"]),
    "flex_moments_backward": (f"{BANDED}:479", [f"{BANDED}:1294"]),
    # E's bf16 case: the kernel's single bf16 plane (`:534-537`)
    "flex_moments_backward_bf16": (f"{BANDED}:479", [f"{BANDED}:1294"]),
    "neighbor_max_backward": (f"{BANDED}:187", [f"{BANDED}:1294"]),
}
SOURCES = {
    "knn": "dh3d_tpu_torch/csrc/knn.cu",
    "knn_topk": "dh3d_tpu_torch/csrc/knn_topk.cu",
    "knn_window": "dh3d_tpu_torch/csrc/knn_window.cu",
    "fps": "dh3d_tpu_torch/csrc/fps.cu",
    **{name: "dh3d_tpu_torch/csrc/neighborhood.cu"
       for name in ("weighted_sum", "flex_moments", "flex_moments_bf16",
                    "neighbor_max", "weighted_sum_backward",
                    "flex_moments_backward", "flex_moments_backward_bf16",
                    "neighbor_max_backward")},
}
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
# the forward (phase 4) runs A-D and G (A the 3-NN, G the self kNN k=8;
# C through both its entry points: on weights and,
# for the flex-conv moments, on positions); the train step (phase 6) A-G
# (E likewise) and J's four passes (train-mode BatchNorm, which an eval
# forward never launches); the local extraction with NMS (phase 8) A-D and G
FORWARD_KERNELS = ("knn", "knn_topk", "fps", "weighted_sum", "flex_moments",
                   "neighbor_max")
EXTRACT_KERNELS = FORWARD_KERNELS
BATCHNORM_KERNELS = ("batch_norm_stats", "batch_norm_forward",
                     "batch_norm_grad_sums", "batch_norm_grad_dx")
TRAIN_KERNELS = FORWARD_KERNELS + ("weighted_sum_backward",
                                   "flex_moments_backward",
                                   "neighbor_max_backward") + BATCHNORM_KERNELS
# the bf16 compute_dtype (phase 16) takes the bf16 cases of C and E on the
# positions instead of the f32 ones
BF16_CASES = {"flex_moments": "flex_moments_bf16",
              "flex_moments_backward": "flex_moments_backward_bf16"}
BF16_TRAIN_KERNELS = tuple(BF16_CASES.get(k, k) for k in TRAIN_KERNELS)
NMS = {"k": 50, "radius": 0.5, "ratio": 0.01, "max_kp": 512}  # CLI defaults
# Phase 12: the relocalisation CLI's defaults, its database and queries
RELOC = {"num_points": 4096, "nms_max_kp": 256, "ransac_iters": 500,
         "db": 12, "queries": 4, "source_every": 3}
# the moved copies: a query from its database scan, the pairs file's copy
QUERY_MOTION = (0.2, (1.5, -1.0, 0.0))  # z-rotation (rad), translation (m)
PAIR_MOTION = (0.5, (3.0, -2.0, 0.5))
# Phase 14: kernel H's band starts read back at these (queries, keys,
# window): a self query wider than the int32 product of the JAX kernel
# allows, the windowed level's 3-NN and kNN, the forward's and the
# extraction's self kNN, and cross shapes whose tiles share bands
WINDOW_START_SHAPES = ((33024, 33024, 512), (32768, 32768, 512),
                       (32768, 4096, 256), (32768, 4096, 512),
                       (16384, 16384, 512), (8192, 8192, 512),
                       (8192, 1024, 256), (5120, 2560, 256),
                       (2048, 256, 128))
# Phase 14 (f): the error budget's pool: two sequences of 4 scans
BUDGET = {"num_points": 8192, "per_sequence": 4}
# Phase 18: kernel I's bound, its float64 instructions (3 subtractions, 3
# products, 2 sums a pair) at 64 a clock an SM: the H100 SXM's 34 TFLOP/s
# of FP64 on the CUDA cores counts an FMA as 2, so 17e12 such
# instructions a second.  The key splits timed at the raw scan's M.
FP64_INSTRUCTIONS_PER_S = 17e12
RADIUS_FP64_PER_PAIR = 8
RADIUS_PLANS = (1, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32)
RADIUS_LOADER_FILES = 6


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup=3, reps=10) -> float:
    """Median time of one fn() in ms, CUDA events around each call (the
    host's launch work included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """The relocalisation forward's neighbourhoods (phase 12's path, batch
    1): a database scan through `GlobalTestDataset`'s normalisation
    [1, 4096] in loader order (NMS's input), Morton-sorted, its FPS
    subsample [1, 512] (ids sorted), the self kNN k=8 at both levels, and
    the 3-NN map (d2, idx) from the points to the subsample."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd

    N, M, K = RELOC["num_points"], RELOC["num_points"] // 8, 8
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
    ([20, 8192], 512 keypoints), and E once on random ids, on seeded inputs
    that are the same on every tree of the port.  One dict a case: `name`
    (the kernel) and `label`; `call(*inverse)`, the op, which builds its
    own CSR inverse when given none; `nbh` and `keys`, its neighbourhood
    and key count; `reads`, the other tensors it reads; `ops`, its f32
    operations; `plain`, its plain version, which is the library route
    (einsum + `index_add_`, gather + `scatter_add_`); `library_call`, that
    route's last call alone on prepared operands."""
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
        if pos is not None and hasattr(T, "flex_moments_backward"):
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
    step calls it), and C once on random ids, on seeded inputs that are the
    same on every tree of the port.  One dict a case: `name` (the kernel),
    `label`; `call`, the op as the tree's path calls it, returning a tuple
    of tensors (a tree from before `flex_moments` builds the weights with
    `flex_weights` and sums them; a tree from before `with_arg` writes
    the ids and returns them); `plain`, the same tuple from the plain
    version; `inputs` (for the bound and the hash) and `ops`, f32
    operations; `forced(plan)`, the op with a given launch plan (a
    tree with `row_plan`), and `C`, `K` for the plans; C: `sparse`, the
    operands (idx, w, f) of the library route; the moments: `explicit`,
    the same sum on the weight tensor, and `weights`, the build of that
    tensor; D: `nan`, whether the features hold NaNs (a tree from before
    the NaN rule differs there)."""
    import inspect

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
    # the relocalisation forward's, batch 1 (phase 12's path, listed first)
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
    has_moments = hasattr(T, "flex_moments")
    has_arg = "with_arg" in inspect.signature(T.neighbor_max).parameters
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
        if has_moments:
            call = partial(T.flex_moments, f, pos, idx)
        else:
            def call(f=f, pos=pos, idx=idx):
                return T.weighted_sum(f, idx, T.flex_weights(pos, idx))
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
            kw = {"with_arg": ids} if has_arg else {}
            keep = [0] + [1] * ids + [2] * slot

            def call(fn=fn, f=f, idx=idx, kw=kw, keep=keep, **more):
                out = fn(f, idx, **kw, **more)
                if has_arg:
                    return tensors(out)
                return tuple(out[i] for i in keep)  # the ids written, unread

            cases.append(dict(
                name="neighbor_max", nan=bool(nan), inputs=(f, idx),
                C=f.shape[-1], K=K, ops=idx.numel() * f.shape[-1],
                label=label + " +id" * ids + " +slot" * slot, call=call,
                plain=lambda f=f, idx=idx, keep=keep: tuple(
                    T.neighbor_max_plain(f, idx)[i] for i in keep),
                forced=lambda plan, call=call: call(plan=plan)))
    return cases


def plan_of(T, name, *shape):
    """The tree's own plan for a case: G's `topk_plan(k)` (its merge), A's
    `knn_plan` (its key slabs, on a tree from before A lost them), B's
    `fps_plan`; None where the tree has no such plan."""
    fn = getattr(T, {"knn": "knn_plan", "knn_topk": "topk_plan"}.get(
        name, "fps_plan"), None)
    if fn is None:
        return None
    from dh3d_tpu_torch import kernels

    if name == "knn_topk":
        return fn(shape[-1])
    plan = fn(*shape, kernels.sm_count(0))
    return list(plan) if isinstance(plan, tuple) else plan


def knn_fps_cases(torch, T, device):
    """Kernels A, G and B at every shape of the paths (the relocalisation's
    first), on seeded inputs that are the same on every tree of the port.  One dict a case: `name` (the
    kernel the path takes: A up to k = 7, G from k = 8; a tree from before
    G took k = 8-32 runs A there, which is how `--ab-root` times G against
    A), `label`; `call`, the op as the path calls it (the tree's own plan,
    `plan`: G's merge, B's (blocks a cloud, threads a block)); `plain`;
    `forced(plan)`, the op with a given plan and `plans`, every plan to
    sweep (G and B on a tree with plans); `inputs` (for the bound and the
    hash); `ops`, f32 operations (kNN: the 8 of the d2 of each pair it
    returns, which any exact search computes; B: 9 a point an
    iteration); A and G: `pairs` (all query-key pairs, for a full scan's
    instruction floor); G: `prepass()`, its pre-pass alone (a tree with
    it); A: `g_forced(plan)` and `g_plan`, G at A's shape; B: `m`.  B at
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
    has_g = hasattr(T, "topk_prepass")
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
        if has_g and name == "knn":
            c.update(g_plan=T.topk_plan(k),
                     g_forced=lambda p, q=q, keys=keys, k=k: T.knn(
                         q, keys, k, plan=p))
        elif has_g:
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


def kernel_phase(torch, T, device):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns {kernel name: [case dict, ...]}, the main-path case first."""
    pts, sub, nbh, _, (d2_3, idx3) = train_geometry(torch, T, device)
    B, N, K = nbh.shape
    M = sub.shape[1]
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = {name: [] for name in REPLACES}

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

    # C and D at every shape of the forward (`forward_cases`): the tree's
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

    return cases


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


def lidar_like_scan(seed, n_points=30000, extent=30.0):
    from dh3d_tpu_torch.data.synthetic import lidar_like_scan as scan

    return scan(seed, n_points=n_points, extent=extent)


def check_outputs(torch, outs, points, B, N):
    want = {"xyz": (B, N, 3), "knn_indices": (B, N, 8), "feat": (B, N, 128),
            "local_desc": (B, N, 128), "xyz_feat": (B, N, 131),
            "attention": (B, N, 1), "xyz_feat_att": (B, N, 132),
            "global_desc": (B, 256)}
    assert set(outs) == set(want), sorted(outs)
    for key, shape in want.items():
        assert tuple(outs[key].shape) == shape, (key, outs[key].shape)
        assert torch.isfinite(outs[key].float()).all(), key
    assert outs["knn_indices"].dtype == torch.int64
    assert torch.equal(outs["xyz"], points), "unpermuted xyz != input"
    self_slot = torch.arange(N, device=points.device).expand(B, N)
    assert torch.equal(outs["knn_indices"][..., 0], self_slot)
    for key in ("local_desc", "global_desc"):
        norm = outs[key].norm(dim=-1)
        assert (norm - 1).abs().max().item() < 1e-4, key
    att = outs["attention"]
    assert ((att >= 0) & (att <= 1)).all()


def stage2_config():
    """`detection_config` with the values of models/demo_stage2.config.json
    (batch_size 10 pairs = 20 clouds of 8192 points, 512 keypoints,
    det_k 16).  That run generated its pairs on the device from presorted
    clouds; phases 6 and 7 feed host-side synthetic pairs, neither
    presorted nor generated on the device, so those two keys go off here
    (phase 10 trains with them on, from disk)."""
    from dh3d_tpu_torch import config as cfglib

    cfg = cfglib.load_config("models/demo_stage2.config.json")
    cfg.device_pairgen = False
    cfg.morton_presorted = False
    return cfg


def stage2_state(cfg, device):
    """A fresh train state on `device` warm-started from demo_stage2."""
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.train import init_state

    state = init_state(cfg, 0, device)
    n = smart_init(state.model, load_npz("models/demo_stage2.npz"))
    assert n == 80, f"demo_stage2 warm start loaded {n} of 80 arrays"
    return state


def check_gradients(torch, state, cfg):
    """Every trainable gradient finite; nonzero but where it is 0 exactly
    (a bias that feeds a BatchNorm)."""
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import param_labels

    zero = bn_fed_biases(state.model)
    labels = param_labels(cfg, state.model)
    n = 0
    for name, p in state.model.named_parameters():
        if labels[name] != "trainable":
            continue
        assert p.grad is not None, f"{name}: no gradient"
        assert torch.isfinite(p.grad).all(), f"{name}: gradient not finite"
        if name not in zero:
            assert p.grad.abs().max().item() > 0, f"{name}: zero gradient"
        n += 1
    return n


class InverseBuilds:
    """Counts the CSR inverses built while it is entered (the
    neighbourhood tensor of each) and marks each build as a
    `torch.profiler` range `csr_inverse`, by wrapping
    `ops.neighborhood.inverse_neighbors`, which every build goes through."""

    def __enter__(self):
        import torch
        from dh3d_tpu_torch.ops import neighborhood

        self.module, self.real, self.nbh = (
            neighborhood, neighborhood.inverse_neighbors, [])

        def counted(nbh, m):
            self.nbh.append(nbh)
            with torch.profiler.record_function("csr_inverse"):
                return self.real(nbh, m)

        neighborhood.inverse_neighbors = counted
        return self

    def __exit__(self, *exc):
        self.module.inverse_neighbors = self.real

    def distinct(self) -> int:
        return len({id(t) for t in self.nbh})


def profile_step(torch, step):
    """Device time of one step by kernel class, from torch.profiler; and of
    kernels E and F and the CSR inverse builds (`csr_inverse` ranges)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            InverseBuilds():
        step()
        torch.cuda.synchronize()
    classes = (
        ("kernel G", ("topk_",)),
        ("port kernels A-F", ("knn_kernel", "knn_merge", "fps_kernel",
                              "weighted_sum", "neighbor_max")),
        ("GEMMs", ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "cublas")),
        ("optimizer", ("adam", "multi_tensor", "foreach")),
        ("sort, scan, gather, scatter", ("sort", "radix", "scan", "index",
                                         "gather", "scatter", "search",
                                         "cub::")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    )
    split = {}
    backward = {"E weighted_sum_bwd": 0.0, "F neighbor_max_bwd": 0.0,
                "csr_inverse builds": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name == "csr_inverse":
                backward["csr_inverse builds"] += e.device_time_total / 1e3
            continue
        name = e.name.lower()
        ms = e.time_range.elapsed_us() / 1e3
        cls = next((c for c, keys in classes
                    if any(k in name for k in keys)), "other")
        split[cls] = split.get(cls, 0.0) + ms
        for key in ("E weighted_sum_bwd", "F neighbor_max_bwd"):
            if key.split()[1] in name:
                backward[key] += ms
    backward["total"] = sum(backward.values())
    split["E + F + inverse builds"] = backward
    return split


def train_phase(torch, kernels, device, overrides=None,
                must_launch=TRAIN_KERNELS):
    """Phase 6 (and 16 (d), with `overrides` of the config and the kernels
    its step must launch).  Returns (launches over one counted step,
    report)."""
    from dh3d_tpu_torch.train import (forward_loss, make_train_step,
                                      synthetic_local_batches, to_device)

    cfg = stage2_config()
    cfg.update(overrides or {})
    B2, N = 2 * cfg.batch_size, cfg.num_points
    state = stage2_state(cfg, device)
    batches = synthetic_local_batches(cfg, seed=0)
    batch = to_device(next(batches), device)
    step_fn = make_train_step(cfg)
    for _ in range(2):  # warm-up
        step_fn(state, batch)
    bn_before = {k: v.clone() for k, v in state.model.named_buffers()}
    batch = to_device(next(batches), device)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with InverseBuilds() as builds:
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    launches = kernels.counts()
    log(f"  launches in one train step: {launches}; CSR inverses built: "
        f"{len(builds.nbh)}")
    for name in must_launch:
        assert launches[name] > 0, \
            f"kernel {name} was not launched by the train step"
    assert builds.nbh and len(builds.nbh) == builds.distinct(), \
        "a neighbourhood's CSR inverse was built more than once"
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(map(math.isfinite, metrics.values())), metrics
    n_grads = check_gradients(torch, state, cfg)
    moved = [k for k, v in state.model.named_buffers()
             if not torch.equal(v, bn_before[k])]
    assert len(moved) == len(bn_before), \
        f"BN statistics that did not move: {set(bn_before) - set(moved)}"
    log(f"  {n_grads} trainable gradients finite and nonzero; "
        f"{len(moved)} BN statistics moved")

    # timed steps: CUDA events around the forward+loss, the backward and
    # the optimizer update of each
    model, opt = state.model, state.optimizer
    from dh3d_tpu_torch.train import apply_gradients

    def step_parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        model.train()
        total, m, _ = forward_loss(model, cfg, batch)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[2].record()
        apply_gradients(state, cfg)
        ev[3].record()
        return ev, m

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(7):
        ev, m = step_parts()
        ev[3].synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(sum(t) for t in times)
    parts = {k: statistics.median(t[i] for t in times)
             for i, k in enumerate(("forward_loss", "backward",
                                    "optimizer"))}
    try:
        split = profile_step(torch, step_parts)
    except Exception as e:  # the split is a report, not a check
        split = {"not measured": repr(e)}
    last = {k: torch.as_tensor(v).item() for k, v in m.items()}
    assert all(map(math.isfinite, last.values())), last
    report = {"shape": [B2, N, 3], "keypoints": cfg.sampled_kpnum,
              "step_ms": step_ms, "clouds_per_s": B2 / (step_ms / 1e3),
              "parts_ms": parts, "peak_mem_gb": peak_gb,
              "profile_ms": split, "last_metrics": last,
              "launches": launches, "inverse_builds": len(builds.nbh)}
    log(f"  train step: {step_ms:.2f} ms median of 7 (CUDA events), "
        f"{B2 / (step_ms / 1e3):.1f} clouds/s; {parts}; peak {peak_gb:.2f} GB")
    log(f"  profile of one step (device ms): {split}")
    log(f"  last metrics: {last}")
    return launches, report


def card_vs_cpu_train(torch, device):
    """Phase 7: one [2, 8192] step on the card and on the CPU."""
    from dh3d_tpu_torch.losses import detection_ranks
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.train import (forward_loss, synthetic_local_batches,
                                      to_device)

    cfg = stage2_config()
    cfg.batch_size = 1
    batch = next(synthetic_local_batches(cfg, seed=1))
    runs = {}
    for dev in ("cpu", device):
        state = stage2_state(cfg, dev)
        state.model.train()
        caches = []
        hook = state.model.local_backbone.register_forward_hook(
            lambda mod, inp, out: caches.append(out[2]))
        t0 = time.perf_counter()
        total, metrics, outs = forward_loss(state.model, cfg,
                                            to_device(batch, dev))
        total.backward()
        seconds = time.perf_counter() - t0
        hook.remove()
        det = {k: v.detach() for k, v in outs.items()}
        ar, cand = detection_ranks(det, cfg.det_k, cfg.ar_nn_k, cfg.pos_r)
        runs[str(dev)] = {
            "metrics": {k: torch.as_tensor(v).item()
                        for k, v in metrics.items()},
            "grads": {n: p.grad.cpu()
                      for n, p in state.model.named_parameters()},
            "idx": {"morton xyz": outs["xyz"].detach().cpu(),
                    "knn k=8 [8192]": outs["knn_indices"].cpu(),
                    "fps": caches[0]["kp_idx"].cpu(),
                    "knn k=8 [1024]": caches[0]["knn"].nbh.cpu(),
                    "3-nn": caches[0]["interp"][1].nbh.cpu(),
                    "det-loss knn k=16": cand[..., :cfg.det_k].cpu()},
            "hardest": cand[..., cfg.det_k:].cpu(), "ar": ar.cpu(),
            "s": seconds}
        zero = bn_fed_biases(state.model)
    cpu, gpu = runs["cpu"], runs[str(device)]
    for key, ref in cpu["idx"].items():
        assert torch.equal(gpu["idx"][key], ref), f"{key} differs"
    flips = int((gpu["ar"] != cpu["ar"]).sum())
    neg = int((gpu["hardest"] != cpu["hardest"]).any(-1).sum())
    log(f"  indices equal ({', '.join(cpu['idx'])}); detection ranks "
        f"flipped: {flips} of {cpu['ar'].numel()}; hardest-negative "
        f"neighbourhoods that differ: {neg}")
    errs = {}
    for k, v in cpu["metrics"].items():
        errs[k] = abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
        assert errs[k] <= TRAIN_LOSS_REL, (k, v, gpu["metrics"][k])
    top = max(g.abs().max().item() for g in cpu["grads"].values())
    worst = (0.0, "")
    for name, g in cpu["grads"].items():
        scale = top if name in zero else g.abs().max().item()
        err = (gpu["grads"][name] - g).abs().max().item() / scale
        worst = max(worst, (err, name))
        assert err <= TRAIN_GRAD_REL, (name, err)
    log(f"  worst loss rel err {max(errs.values()):.3g}; worst gradient "
        f"err {worst[0]:.3g} of its scale ({worst[1]}); CPU step "
        f"{cpu['s']:.1f} s, card step {gpu['s']:.2f} s")


def check_rows(path, max_rows):
    """A descriptor file of 132-float rows: at least one and at most
    `max_rows` rows, finite, unit-norm descriptors.  Returns the rows."""
    size = os.path.getsize(path)
    assert size > 0 and size % (132 * 4) == 0, (path, size)
    rows = np.fromfile(path, np.float32).reshape(-1, 132)
    assert len(rows) <= max_rows, (path, len(rows))
    assert np.isfinite(rows).all(), path
    norm = np.linalg.norm(rows[:, 3:131], axis=1)
    assert np.abs(norm - 1).max() < 1e-4, (path, np.abs(norm - 1).max())
    return rows


def local_cli(pcd, out, *flags):
    """The port's local extraction CLI, in this process (its kernel counts
    are this process's), with demo_stage2 on the card."""
    from dh3d_tpu_torch.evaluate import localdesc_extract

    return localdesc_extract.main([
        "--ModelPath", "models/demo_stage2", "--pcdpath", pcd, "--dim", "3",
        "--device", "cuda", "--batch_size", "1", "--save_dir", out,
        "--nms_rad", str(NMS["radius"]), "--nms_min_ratio", str(NMS["ratio"]),
        "--nms_max_kp", str(NMS["max_kp"]), *flags])


def extraction_phase(torch, kernels, work):
    """Phase 8.  Returns (launches over the NMS extraction, report)."""
    from dh3d_tpu_torch.data.io import write_to_bin
    from dh3d_tpu_torch.evaluate import globaldesc_extract

    scans, one = os.path.join(work, "scans"), os.path.join(work, "one")
    os.makedirs(scans)
    os.makedirs(one)
    names = [f"scan{s}" for s in range(8)]
    for s, name in enumerate(names):
        write_to_bin(lidar_like_scan(s), os.path.join(scans, name + ".bin"))
    shutil.copy(os.path.join(scans, "scan0.bin"), one)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    summary = local_cli(scans, os.path.join(work, "nms"), "--perform_nms")
    torch.cuda.synchronize()
    launches = kernels.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches over the NMS extraction of 8 clouds: {launches}")
    for name in EXTRACT_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched by the NMS extraction"
    assert summary["clouds"] == 8, summary
    kps = [len(check_rows(os.path.join(work, "nms", f"{n}_nms_res.bin"),
                          NMS["max_kp"])) for n in names]
    n, secs, parts = summary["clouds"], summary["seconds"], summary["timings"]
    report = {"shape": [1, 16384, 3], "clouds": n, "seconds": secs,
              "clouds_per_s": n / secs,
              "ms_per_cloud": {k: 1e3 * v / n for k, v in parts.items()},
              "keypoints": kps, "peak_mem_gb": peak_gb, "launches": launches}
    log(f"  NMS extraction, 8 clouds at N=16384: {n / secs:.2f} clouds/s "
        f"(host clock, load to write); ms a cloud "
        f"{ {k: round(v, 2) for k, v in report['ms_per_cloud'].items()} }; "
        f"keypoints {kps}; peak {peak_gb:.2f} GB")

    report["nms_split"] = nms_split(torch)
    log(f"  NMS of one cloud [16384], k=50: {report['nms_split']}")

    dense = local_cli(one, os.path.join(work, "dense"), "--save_all")
    rows = check_rows(os.path.join(work, "dense", "scan0_res.bin"), 16384)
    assert len(rows) == 16384 and dense["clouds"] == 1
    dso = local_cli(one, os.path.join(work, "dso"), "--perform_nms",
                    "--dataset", "oxford_dso")
    dso_kp = len(check_rows(os.path.join(work, "dso", "scan0_nms_res.bin"),
                            NMS["max_kp"]))
    report["dense_s"] = dense["seconds"]
    report["dso_9000"] = {"seconds": dso["seconds"], "keypoints": dso_kp,
                          "ms": {k: 1e3 * v for k, v in
                                 dso["timings"].items()}}
    log(f"  dense --save_all cloud [16384, 132] in {dense['seconds']:.3f} s;"
        f" oxford_dso N=9000 with NMS in {dso['seconds']:.3f} s, "
        f"{dso_kp} keypoints")

    gt = os.path.join(work, "gt.pickle")
    with open(gt, "wb") as f:  # two sequences of 4, twins 3 m apart
        pickle.dump({f"seq{q}": [{"query": names[4 * q + i],
                                  "northing": 10.0 * i + 3.0 * q,
                                  "easting": 0.0} for i in range(4)]
                     for q in range(2)}, f)
    t0 = time.perf_counter()
    gsum = globaldesc_extract.main([
        "--ModelPath", "models/demo_stage3", "--pcdpath", scans,
        "--ref_gt_file", gt, "--query_gt_file", gt, "--batch_size", "4",
        "--num_points", "8192", "--eval_recall", "--device", "cuda",
        "--save_dir", os.path.join(work, "global")])
    glob_s = time.perf_counter() - t0
    assert gsum["clouds"] == 8, gsum
    for name in names:
        d = np.fromfile(os.path.join(work, "global", name + ".bin"),
                        np.float32)
        assert d.shape == (256,) and np.isfinite(d).all(), name
        assert abs(np.linalg.norm(d) - 1) < 1e-4, name
    assert all(map(math.isfinite, gsum["recall@N"]))
    report["global"] = {"shape": [4, 8192, 3], "clouds": 8,
                        "seconds": glob_s, "recall@1": gsum["recall@N"][0],
                        "one_percent": gsum["one_percent"]}
    log(f"  global descriptors, 8 clouds at [4, 8192]: {glob_s:.3f} s "
        f"(host clock, with model load and recall); recall@1 "
        f"{gsum['recall@N'][0]:.3f}")
    return launches, report


def nms_split(torch):
    """`device_nms` of one normalised N=16384 cloud (k=50, the CLI's
    defaults), as the extraction calls it: host-clock ms (median of 10,
    from the host arrays to the keypoint indices on the host) and the
    profiler's device ms of one call by kernel class (kernel G, its
    pre-pass and search, against the NMS's PyTorch ops)."""
    from dh3d_tpu_torch.eval import device_nms

    xyz = eval_cloud(0, 16384)
    att = np.random.RandomState(0).rand(16384).astype(np.float32)
    args = (xyz, att, NMS["radius"], NMS["ratio"], NMS["max_kp"])
    call = partial(device_nms, *args, device="cuda")
    call()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    try:
        split = profile_step(torch, call)
        split.pop("E + F + inverse builds", None)
    except Exception as e:  # the split is a report, not a check
        split = {"not measured": repr(e)}
    return {"host_ms": statistics.median(times), "device_ms": split}


def card_vs_cpu_extraction(torch, T, device):
    """Phase 9: one N=16384 scan through the forward and NMS on both."""
    from dh3d_tpu_torch.eval import device_nms, local_result_rows, make_forward
    from dh3d_tpu_torch.train import resolve_model

    cloud = eval_cloud(0, 16384)[None]
    runs = {}
    for dev in ("cpu", device):
        cfg, model = resolve_model("models/demo_stage2")
        cfg.num_points, cfg.sampled_kpnum, cfg.input_R = 16384, -1, False
        model = model.to(dev)
        seen = []
        hook = model.local_backbone.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0], out[2])))
        t0 = time.perf_counter()
        outs = make_forward(cfg, model)(cloud)
        rows = local_result_rows(outs, True)[0]
        seconds = time.perf_counter() - t0
        hook.remove()
        sorted_xyz, cache = seen[0]
        runs[str(dev)] = {
            "idx": {"morton-sorted xyz": sorted_xyz.cpu(),
                    "knn k=8 [16384]": outs["knn_indices"].cpu(),
                    "fps 16384->2048": cache["kp_idx"].cpu(),
                    "knn k=8 [2048]": cache["knn"].nbh.cpu(),
                    "3-nn": cache["interp"][1].nbh.cpu()},
            "out": {k: outs[k].cpu() for k in ("local_desc", "attention",
                                               "xyz_feat_att", "feat")},
            "rows": rows, "s": seconds}
    cpu, gpu = runs["cpu"], runs[str(device)]
    for key, ref in cpu["idx"].items():
        assert torch.equal(gpu["idx"][key], ref), f"{key} differs"
    errs = {}
    for key in ("local_desc", "attention", "xyz_feat_att"):
        errs[key] = (gpu["out"][key] - cpu["out"][key]).abs().max().item()
        assert errs[key] <= CARD_VS_CPU_ATOL, (key, errs[key])
    feat_err = (gpu["out"]["feat"] - cpu["out"]["feat"]).abs().max().item()
    feat_scale = cpu["out"]["feat"].abs().max().item()
    assert feat_err <= CARD_VS_CPU_FEAT_REL * feat_scale, feat_err
    log(f"  forward: indices equal ({', '.join(cpu['idx'])}); max abs err "
        f"{errs}; feat {feat_err:.3g} of {feat_scale:.3g}; CPU forward "
        f"{cpu['s']:.1f} s, card {gpu['s']:.3f} s")

    # NMS from the same inputs: the card's xyz and (inverted) attention
    xyz = np.ascontiguousarray(gpu["rows"][:, :3])
    att = 1 - gpu["rows"][:, -1]
    assert np.array_equal(xyz, cpu["rows"][:, :3])  # the input coordinates
    nn = {}
    for dev in ("cpu", device):
        pts = torch.from_numpy(xyz)[None].to(dev)
        idx, d2 = T.knn(pts, pts, NMS["k"])
        nn[str(dev)] = (idx.cpu(), d2.cpu(), torch.sqrt(d2).cpu())
    assert torch.equal(nn["cpu"][0], nn[str(device)][0]), "50-NN ids differ"
    assert torch.equal(nn["cpu"][1], nn[str(device)][1]), "50-NN d2 differ"
    # the NMS compares Euclidean distances: torch.sqrt of equal d2 on the
    # card and on the CPU (counted, not checked)
    sqrt_differ = int((nn["cpu"][2] != nn[str(device)][2]).sum())
    args = (NMS["radius"], NMS["ratio"], NMS["max_kp"])
    t0 = time.perf_counter()
    n_cpu, kp_cpu = device_nms(xyz, att, *args, device="cpu")
    cpu_nms_s = time.perf_counter() - t0
    n_gpu, kp_gpu = device_nms(xyz, att, *args, device=device)
    assert n_cpu == n_gpu and np.array_equal(kp_cpu, kp_gpu), \
        "NMS of the same inputs differs between the card and the CPU"

    # each whole pipeline: card forward + card NMS vs CPU forward + CPU NMS
    att_cpu = 1 - cpu["rows"][:, -1]
    n_ref, kp_ref = device_nms(xyz, att_cpu, *args, device="cpu")
    a, b = list(kp_gpu[:n_gpu]), list(kp_ref[:n_ref])
    differ = sorted(set(a) ^ set(b))
    reordered = (int(sum(x != y for x, y in zip(a, b))) if not differ
                 else None)
    gap = float(np.abs(att - att_cpu).max())
    # the closest call each differing keypoint's decision hung on: its
    # attention against that of any neighbour within the radius, and
    # against the last keypoint kept
    ids, dist = nn["cpu"][0][0].numpy(), nn["cpu"][2][0].numpy()
    margins = []
    for p in differ:
        q = ids[p][(dist[p] <= NMS["radius"]) & (ids[p] != p)]
        cands = np.abs(att_cpu[p] - att_cpu[q]).tolist()
        if b:
            cands.append(abs(float(att_cpu[p] - att_cpu[b[-1]])))
        margins.append(min(cands) if cands else float("inf"))
    report = {"keypoints_card": n_gpu, "keypoints_cpu": n_ref,
              "differing": len(differ), "reordered": reordered,
              "max_att_gap": gap, "sqrt_d2_differ": sqrt_differ,
              "largest_margin_of_a_difference": max(margins, default=None),
              "forward_max_abs_err": errs, "cpu_forward_s": cpu["s"],
              "cpu_nms_s": cpu_nms_s}
    log(f"  NMS of the card's xyz and attention: 50-NN ids and d2 and "
        f"{n_gpu} keypoints equal on card and CPU (CPU NMS "
        f"{cpu_nms_s:.1f} s); sqrt(d2) differs in {sqrt_differ} of "
        f"{nn['cpu'][2].numel()}")
    log(f"  card forward + NMS vs CPU forward + NMS: {len(differ)} keypoints"
        f" differ ({n_gpu} vs {n_ref}), largest attention gap card-CPU "
        f"{gap:.3g}, largest margin among the differences "
        f"{report['largest_margin_of_a_difference']}")
    return report


def write_train_pool(work, places=12, per_place=3):
    """`places` * `per_place` seeded lidar-like scans of 30,000 points as
    .bin files in `work`, with the two GT pickles `train.py` reads under
    `--data_basedir`: local {i: {"query"}} over every scan, global {i:
    {"query", "positives", "nonnegtives"}} with the other scans of a
    place as its positives and the place as its non-negatives (each query:
    2 positives, 33 possible negatives, and other negatives outside any
    8 negatives' places)."""
    from dh3d_tpu_torch.data.io import write_to_bin

    names = [f"scan{i}" for i in range(places * per_place)]
    for i, name in enumerate(names):
        write_to_bin(lidar_like_scan(100 + i), os.path.join(work,
                                                          name + ".bin"))
    with open(os.path.join(work, "oxford_train_local_gt.pickle"), "wb") as f:
        pickle.dump({i: {"query": n} for i, n in enumerate(names)}, f)
    gt = {}
    for p in range(places):
        place = list(range(per_place * p, per_place * (p + 1)))
        for i in place:
            gt[i] = {"query": names[i],
                     "positives": [j for j in place if j != i],
                     "nonnegtives": place}
    with open(os.path.join(work, "oxford_train_global_gt.pickle"), "wb") as f:
        pickle.dump(gt, f)


def disk_run(torch, label, argv, clouds):
    """One `python -m dh3d_tpu_torch.train` run in this process (its
    kernel counts are this process's): the CLI's summary with, beside it,
    the step time on CUDA events (median of the steps after the first),
    clouds/s on the host clock over the whole run, each step's wait in
    `next(batches)` (median after the first) and the share of the run's
    host-clock time spent waiting there, and peak memory."""
    from dh3d_tpu_torch.train.__main__ import main as train_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = train_main(argv)
    s["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    assert all(map(math.isfinite, s["metrics"].values())), s["metrics"]
    later = slice(1, None) if s["steps"] > 1 else slice(None)
    s.update(
        clouds=clouds, step_ms_median=statistics.median(s["step_ms"][later]),
        clouds_per_s=clouds * s["steps"] / s["seconds"],
        wait_ms_median=1e3 * statistics.median(s["wait_s"][later]),
        wait_share=sum(s["wait_s"]) / s["seconds"])
    log(f"  {label}: {s['steps']} steps of {clouds} clouds in "
        f"{s['seconds']:.2f} s (host clock), {s['clouds_per_s']:.2f} "
        f"clouds/s; step {s['step_ms_median']:.2f} ms (CUDA events, median "
        f"after the first; all {[round(t, 2) for t in s['step_ms']]}); wait "
        f"in next(batches) {s['wait_ms_median']:.1f} ms a step, "
        f"{100 * s['wait_share']:.1f}% of the run's host clock; peak "
        f"{s['peak_mem_gb']:.2f} GB")
    return s


def loader_ms_per_cloud(cfg, clouds):
    """Host ms a cloud of the second batch of a fresh `real_batches` stream
    of `cfg` (no prefetch; the first warms it up): load, normalise (the
    radius outlier removal on the card, kernel I), augment, presort.  Returns it
    with the stream's first batch, the run's first."""
    from dh3d_tpu_torch.train.data import real_batches

    stream = real_batches(cfg, seed=0)
    first = next(stream)
    t0 = time.perf_counter()
    next(stream)
    return 1e3 * (time.perf_counter() - t0) / clouds, first


def loader_split(path, numpts):
    """Host ms of the loader's parts on one scan file (median of 3): the
    read, the radius outlier removal alone (on the card), the whole
    normalisation `get_fixednum_pcd` (the outlier removal, a random
    choice of `numpts`), the Jitter augmentation and the Morton presort of
    one normalised copy."""
    from dh3d_tpu_torch.data.augment import Jitter
    from dh3d_tpu_torch.data.io import (get_fixednum_pcd, load_single_pcfile,
                                        morton_sort_np,
                                        remove_radius_outlier)

    rng = np.random.RandomState(0)
    cloud = load_single_pcfile(path)
    copy = get_fixednum_pcd(cloud, numpts, sortby_dis=False, rng=rng)[0]
    parts = {
        "read": partial(load_single_pcfile, path),
        "outlier_removal": partial(remove_radius_outlier, cloud),
        "normalise": partial(get_fixednum_pcd, cloud, numpts,
                             sortby_dis=False, rng=rng),
        "jitter": partial(Jitter().apply, copy, rng),
        "presort": partial(morton_sort_np, copy),
    }
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    return out


def check_pairs(torch, T, batch, pairs, B, N, M):
    """A pair batch built on the card: anchors unique a cloud and every id
    in range; points[B:] rotated back by R gives pc2 within 1e-5 of its
    scale; the positives are the 1-NN of the anchors in the unrotated pc2
    by `ops.knn_plain`.  Returns the median anchor-positive distance and
    pc2's median point spacing (its 1-NN distance)."""
    from dh3d_tpu_torch.data.augment import matmul3

    pc1, pc2 = batch["pc1"], batch["pc2"]
    ids, R = pairs["sample_inds"], pairs["R"]
    assert pairs["points"].shape == (2 * B, N, 3) and ids.shape == (2 * B, M)
    assert int(ids.min()) >= 0 and int(ids.max()) < N, "ids out of range"
    anc, pos = ids[:B], ids[B:]
    assert all(len(set(a.tolist())) == M for a in anc), "anchors repeat"
    assert torch.equal(pairs["points"][:B], pc1)
    back = matmul3(pairs["points"][B:], R.transpose(1, 2))
    err = (back - pc2).abs().max().item()
    assert err <= 1e-5 * pc2.abs().max().item(), err
    anc_xyz = T.gather_point(pc1, anc).contiguous()
    want, d2 = T.knn_plain(anc_xyz, pc2, 1)
    assert torch.equal(pos, want[..., 0]), "positives are not the 1-NN"
    spacing = T.knn_plain(pc2[:1].contiguous(), pc2[:1].contiguous(), 2)[1]
    return (math.sqrt(d2.median().item()),
            math.sqrt(spacing[..., 1].median().item()))


def disk_phase(torch, T, work, train_launches, device):
    """Phase 10: `python -m dh3d_tpu_torch.train --data_basedir` at full
    width, warm-started from the shipped checkpoints, on a pool of seeded
    scans: (a) stage 2 as demo_stage2 trained (device pairs from presorted
    clouds), (b) the host pair path, (c) stage 3 with on-device
    augmentation, (d) a stage-1 step and a stage-2 step warm-started from
    its logdir (`warm_start_runs`).  Returns (launches over one counted
    step of (a), the card's pairs of (a)'s first batch for phase 11,
    report)."""
    from dh3d_tpu_torch import kernels
    from dh3d_tpu_torch.train import (add_draws, make_train_step,
                                      prepare_batch, to_device)
    from dh3d_tpu_torch.train.__main__ import (build_config, parse_args,
                                               step_generator)

    pool = os.path.join(work, "pool")
    os.makedirs(pool)
    t0 = time.perf_counter()
    write_train_pool(pool)
    log(f"  wrote 36 scans and the GT pickles in "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--data_basedir", pool, "--device", "cuda"]
    stage2 = ["--cfg", "detection_config", *common, "--load",
              "models/demo_stage2.npz"]
    runs = {  # label: (argv, clouds a step)
        "a stage 2, device pairs": (
            stage2 + ["--device_pairgen", "--set", "morton_presorted=true",
                      "--steps", "4"], 20),
        "b stage 2, host pairs": (stage2 + ["--steps", "2"], 20),
        "c stage 3, augment on device": (
            ["--cfg", "global_config", *common, "--load",
             "models/demo_stage3.npz", "--set", "morton_presorted=true",
             "--set", "warmup_steps=300", "--set", "augment_on_device=true",
             "--steps", "2"], 24),
    }
    # the loaders alone first: no run's prefetch thread is alive yet
    argvs, cfgs, loaders, firsts = {}, {}, {}, {}
    for label, (argv, clouds) in runs.items():
        argvs[label] = argv + ["--logdir",
                               os.path.join(work, f"run_{label[0]}")]
        cfgs[label] = build_config(parse_args(argvs[label]))
        loaders[label], firsts[label] = loader_ms_per_cloud(cfgs[label],
                                                            clouds)
        log(f"  {label}: the loader alone {loaders[label]:.1f} ms a cloud "
            f"(host clock, its second batch, no prefetch)")
    split = loader_split(os.path.join(pool, "scan0.bin"), 8192)
    log(f"  one copy of a cloud, host ms: "
        f"{ {k: round(v, 1) for k, v in split.items()} } (the normalisation "
        f"includes the outlier removal)")
    report = {"loader_split_ms": split}
    for label, (_, clouds) in runs.items():
        cfg, first = cfgs[label], firsts[label]
        counted = kernels.RADIUS_COUNT.launches
        report[label] = s = disk_run(torch, label, argvs[label], clouds)
        s["loader_ms_per_cloud"] = loaders[label]
        # the prefetch thread's loader counts each copy's neighbours on
        # the card (kernel I), as many times as the run loaded copies
        s["loader_radius_counts"] = kernels.RADIUS_COUNT.launches - counted
        assert s["loader_radius_counts"] >= clouds * s["steps"], s
        if label[0] == "a":
            launches = s["launches"][-1]
            log(f"  launches in one step from disk: {launches}")
            for name, n in train_launches.items():
                if name == "radius_count":  # the loader's, not the step's
                    continue
                more = 1 if name in ("fps", "knn") else 0
                assert launches[name] == n + more, \
                    (name, launches[name], n, more)
            # the first batch's pairs, rebuilt on the card
            batch = to_device(first, "cuda")
            pairs = prepare_batch(add_draws(
                batch, cfg, step_generator(1000, 0, "cuda")), cfg)
            B, N, M = cfg.batch_size, cfg.num_points, cfg.sampled_kpnum
            dist, spacing = check_pairs(torch, T, batch, pairs, B, N, M)
            s["anchor_positive_median_m"] = dist
            s["pc2_spacing_median_m"] = spacing
            log(f"  pairs of the first batch rebuilt on the card: anchors "
                f"unique, ids in range, pc2 back from R within 1e-5, "
                f"positives the plain 1-NN; median anchor-positive "
                f"{dist:.3f} m, pc2's median spacing {spacing:.3f} m")
            held = {"pc1": batch["pc1"][:2].contiguous(),
                    "pc2": batch["pc2"][:2].contiguous()}
            # the pairs' device time alone, and a profile of one step
            gen = partial(step_generator, 1000, 0, "cuda")
            s["pairgen_ms"] = device_ms(torch, lambda: prepare_batch(
                add_draws(batch, cfg, gen()), cfg))
            state, step_fn = stage2_state(cfg, device), make_train_step(cfg)
            step_fn(state, batch, gen())
            try:
                s["profile_ms"] = profile_step(
                    torch, lambda: step_fn(state, batch, gen()))
            except Exception as e:  # the split is a report, not a check
                s["profile_ms"] = {"not measured": repr(e)}
            del state, step_fn
            log(f"  the pair generation alone: {s['pairgen_ms']:.3f} ms of "
                f"device time; profile of one step from disk (device ms): "
                f"{s['profile_ms']}")
    report["d warm start"] = warm_start_runs(torch, work, common)
    return launches, held, report


def warm_start_runs(torch, work, common):
    """Phase 10 (d): the curriculum's warm start from the port's own
    checkpoints: one stage-1 step (`basic_config`) from disk, then one
    stage-2 step (`detection_config`) with `--load` the stage-1 logdir,
    which must restore every tensor stage 1 saved (stage 1's model is
    stage 2's without the detection block)."""
    from dh3d_tpu_torch.nn.convert import warm_start_state_dict

    flags = ["--device_pairgen", "--set", "morton_presorted=true",
             "--steps", "1"]
    stage1 = os.path.join(work, "run_d1")
    s1 = disk_run(torch, "d stage 1", ["--cfg", "basic_config", *common,
                                       *flags, "--logdir", stage1], 20)
    s2 = disk_run(torch, "d stage 2 from the stage-1 logdir", [
        "--cfg", "detection_config", *common, *flags, "--load", stage1,
        "--logdir", os.path.join(work, "run_d2")], 20)
    saved = len(warm_start_state_dict(stage1))
    assert s2["restored"] == saved > 0, (s2["restored"], saved)
    log(f"  stage 2 warm-started from the stage-1 logdir: restored "
        f"{s2['restored']} of the {saved} tensors stage 1 saved")
    return {"restored": s2["restored"], "saved": saved,
            "stage1_step_ms": s1["step_ms"], "stage2_step_ms": s2["step_ms"]}


def card_vs_cpu_pairgen(torch, device, held):
    """Phase 11: the pair generation at [2, 8192], 64 anchors, on the card
    and on the CPU from draws made once on the CPU generator."""
    from dh3d_tpu_torch.data.pairgen import draw_local_pairs, local_pairs

    B, N, M = 2, held["pc1"].shape[1], 64
    draws = draw_local_pairs(B, N, math.pi,
                             torch.Generator(device="cpu").manual_seed(4))
    out = {}
    for dev in ("cpu", device):
        out[str(dev)] = {k: v.cpu() for k, v in local_pairs(
            held["pc1"].to(dev), held["pc2"].to(dev), M,
            *(d.to(dev) for d in draws)).items()}
    cpu, gpu = out["cpu"], out[str(device)]
    assert torch.equal(cpu["sample_inds"], gpu["sample_inds"]), \
        "anchors or positives differ between the card and the CPU"
    err = (cpu["points"] - gpu["points"]).abs().max().item()
    scale = cpu["points"].abs().max().item()
    assert err <= 1e-6 * scale, (err, scale)
    r_err = (cpu["R"] - gpu["R"]).abs().max().item()
    log(f"  anchors and positives equal; points max abs err {err:.3g} of "
        f"{scale:.3g}; R {r_err:.3g}")
    return {"points_max_abs_err": err, "scale": scale, "R_max_abs_err": r_err}


def moved(cloud, motion, seed, jitter=0.02):
    """cloud @ R.T + t (+ jitter) for the z-rotation and translation of
    `motion`; returns (moved cloud, R, t)."""
    ang, t = motion
    c, s = math.cos(ang), math.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t = np.asarray(t, np.float64)
    noise = np.random.RandomState(seed).randn(*cloud.shape) * jitter
    return (cloud @ R.T + t + noise).astype(np.float32), R, t


def write_reloc_pool(work):
    """The relocalisation data in `work`: `RELOC["db"]` seeded lidar-like
    scans of 30,000 points over 30 m x 30 m (`extent` 15: on the open
    ground of wider scans the demo detector's attention saturates and NMS
    keeps few keypoints) at places 10 m apart, and `RELOC["queries"]`
    queries, query j database scan 3j moved by QUERY_MOTION with 0.02 m
    jitter, 2 m from it; GT pickles ({seq: [{query, northing, easting}]})
    db.pickle and query.pickle over all of them, and db4.pickle /
    query2.pickle over the first 4 and 2 (phase 13).  Returns the .bin
    directory."""
    from dh3d_tpu_torch.data.io import write_to_bin

    pcd = os.path.join(work, "pcd")
    os.makedirs(pcd)
    scans = [lidar_like_scan(300 + i, extent=15.0)
             for i in range(RELOC["db"])]
    for i, scan in enumerate(scans):
        write_to_bin(scan, os.path.join(pcd, f"db{i}.bin"))
    for j in range(RELOC["queries"]):
        src = RELOC["source_every"] * j
        write_to_bin(moved(scans[src], QUERY_MOTION, j)[0],
                     os.path.join(pcd, f"query{j}.bin"))

    def gt(name, seq, items):
        with open(os.path.join(work, name), "wb") as f:
            pickle.dump({seq: [{"query": q, "northing": n, "easting": 0.0}
                               for q, n in items]}, f)

    db = [(f"db{i}", 10.0 * i) for i in range(RELOC["db"])]
    query = [(f"query{j}", 10.0 * RELOC["source_every"] * j + 2.0)
             for j in range(RELOC["queries"])]
    gt("db.pickle", "database", db)
    gt("query.pickle", "query", query)
    gt("db4.pickle", "database", db[:4])
    gt("query2.pickle", "query", query[:2])
    return pcd


def reloc_cli(work, db_gt, query_gt, device):
    """The port's relocalisation CLI, in this process, with the CLI's
    defaults (N=4096, 256 keypoints, 500 RANSAC iterations)."""
    from dh3d_tpu_torch.evaluate import relocalize

    return relocalize.main([
        "--local_model", "models/demo_stage2",
        "--global_model", "models/demo_stage3",
        "--db_gt", os.path.join(work, db_gt),
        "--query_gt", os.path.join(work, query_gt),
        "--pcdpath", os.path.join(work, "pcd"),
        "--num_points", str(RELOC["num_points"]),
        "--nms_max_kp", str(RELOC["nms_max_kp"]),
        "--ransac_iters", str(RELOC["ransac_iters"]),
        "--device", str(device)])


class Descriptors:
    """Keeps the descriptors of every forward the relocalisation CLI makes
    while it is entered (references, no copy, no synchronisation), by
    wrapping the `make_forward` it calls."""

    def __enter__(self):
        from dh3d_tpu_torch.evaluate import relocalize

        self.module, self.real = relocalize, relocalize.make_forward
        self.kept = {"global_desc": [], "local_desc": []}

        def wrapped(cfg, model):
            fwd = self.real(cfg, model)

            def call(*args, **kwargs):
                outs = fwd(*args, **kwargs)
                key = "global_desc" if cfg.extract_global else "local_desc"
                self.kept[key].append(outs[key])
                return outs

            return call

        relocalize.make_forward = wrapped
        return self

    def __exit__(self, *exc):
        self.module.make_forward = self.real


def reloc_phase(torch, kernels, work, nms_file):
    """Phase 12.  Returns (launches over the relocalisation run, report,
    the keypoint files of the pair for phase 13)."""
    from dh3d_tpu_torch.data.io import write_to_bin
    from dh3d_tpu_torch.evaluate import (registration_eval, relocalize,
                                         repeatability_eval)

    pcd = write_reloc_pool(work)
    n_db, n_q = RELOC["db"], RELOC["queries"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    with Descriptors() as kept:
        s = reloc_cli(work, "db.pickle", "query.pickle", "cuda")
    torch.cuda.synchronize()
    launches = kernels.counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches over the relocalisation of {n_q} queries against "
        f"{n_db} clouds: {launches}")
    for name in FORWARD_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched by the relocalisation"
    assert s["n"] == n_q and s["database"] == n_db, s
    assert len(kept.kept["global_desc"]) == n_db + n_q
    assert len(kept.kept["local_desc"]) == 2 * n_q
    for key, outs in kept.kept.items():
        for d in outs:
            assert torch.isfinite(d).all(), key
            err = (d.norm(dim=-1) - 1).abs().max().item()
            assert err < 1e-4, (key, err)
    for q in s["queries"]:
        assert q["matches"] is not None and q["matches"] >= 3, q
    t = s["timings"]
    stages = s["seconds"] - t["models"]
    report = {
        "shape": [1, RELOC["num_points"], 3], "database": n_db,
        "queries": n_q, "seconds": s["seconds"],
        "clouds_per_s": (n_db + n_q) / stages,
        "ms_per_cloud": {k: 1e3 * t[k] / (n_db + n_q)
                         for k in ("load", "global_forward")},
        "ms_per_query": {k: 1e3 * t[k] / n_q for k in relocalize.QUERY_KEYS},
        # the first query's calls carry one-time set-ups (cuSOLVER's)
        "ms_by_query": [q["ms"] for q in s["queries"]],
        "models_s": t["models"], "retrieved": s["retrieved"],
        "registered": s["registered"],
        "per_query": [{k: q[k] for k in ("query", "top1", "retrieval_m",
                                         "inliers", "matches")}
                      | {"keypoints": [len(q["kp_query"]), len(q["kp_db"])]}
                      for q in s["queries"]],
        "launches": launches,
        "launches_per_query": {k: v / n_q for k, v in launches.items()},
        "peak_mem_gb": peak_gb}
    by_query = [{k: round(v, 2) for k, v in q.items()}
                for q in report["ms_by_query"]]
    log(f"  relocalisation at N={RELOC['num_points']}: "
        f"{report['clouds_per_s']:.2f} clouds/s (host clock, model loads "
        f"excluded); ms a cloud "
        f"{ {k: round(v, 2) for k, v in report['ms_per_cloud'].items()} }, "
        f"ms a query "
        f"{ {k: round(v, 2) for k, v in report['ms_per_query'].items()} } "
        f"(by query: {by_query}); "
        f"retrieved {s['retrieved']}/{n_q}, registered {s['registered']}/"
        f"{n_q}; peak {peak_gb:.2f} GB")

    st = registration_eval.main(["--self_test", nms_file, "--device", "cuda"])
    assert st["success"] and st["rte"] < 1e-6 and st["rre"] < 1e-4, st
    report["self_test"] = st

    # a scan and a rigidly moved copy, extracted as phase 8 extracts
    pair_dir = os.path.join(work, "pair")
    os.makedirs(pair_dir)
    scan = lidar_like_scan(300, extent=15.0)
    copy, R, tr = moved(scan, PAIR_MOTION, 7)
    write_to_bin(scan, os.path.join(pair_dir, "a.bin"))
    write_to_bin(copy, os.path.join(pair_dir, "b.bin"))
    local_cli(pair_dir, os.path.join(work, "pair_nms"), "--perform_nms")
    files = [os.path.join(work, "pair_nms", f"{n}_nms_res.bin")
             for n in ("a", "b")]
    T_gt = np.eye(4)  # maps b into a's frame: a = b @ R.T - R.T t
    T_gt[:3, :3], T_gt[:3, 3] = R.T, -R.T @ tr
    np.savetxt(os.path.join(work, "T_gt.txt"), T_gt)
    with open(os.path.join(work, "pairs.txt"), "w") as f:
        f.write(f"{files[0]} {files[1]} {os.path.join(work, 'T_gt.txt')}\n")
    pr = registration_eval.main(["--pairs", os.path.join(work, "pairs.txt"),
                                 "--device", "cuda"])
    assert pr["pairs"] == 1, pr
    report["pairs"] = pr["per_pair"][0]

    t0 = time.perf_counter()
    rep = repeatability_eval.main([
        "--model", "models/demo_stage2", "--pcdpath", pcd, "--max_clouds",
        "4", "--protocol", "both", "--device", "cuda"])
    report["repeatability"] = {"seconds": time.perf_counter() - t0,
                               **{k: rep[k] for k in ("self-pair",
                                                      "partial-overlap")}}
    for curve in (rep["self-pair"], rep["partial-overlap"]):
        assert all(0 <= v <= 1 for v in curve.values()), curve
    log(f"  registration: self-test RTE {st['rte']:.3g} m RRE "
        f"{st['rre']:.3g} deg, {st['inliers']}/{st['matches']}; scan vs "
        f"moved copy {report['pairs']}; repeatability {report['repeatability']}")
    return launches, report, files


def ransac_host_loop(xyz1, xyz2, iters, seed, thresh=1.0):
    """The JAX package's RANSAC loop (`dh3d_tpu/eval/registration.py:
    47-79`) on the port's numpy `rigid_transform_3d`: a fit and a residual
    pass a hypothesis, on the host.  Returns (R, t, inliers)."""
    from dh3d_tpu_torch.utils.transforms import rigid_transform_3d

    rng = np.random.RandomState(seed)
    best, best_count = None, -1
    for _ in range(iters):
        sel = rng.choice(len(xyz1), 3, replace=False)
        try:
            R, t = rigid_transform_3d(xyz1[sel], xyz2[sel])
        except np.linalg.LinAlgError:
            continue
        inl = np.linalg.norm(xyz2 @ R.T + t - xyz1, axis=1) < thresh
        if inl.sum() > best_count:
            best, best_count = inl, int(inl.sum())
    R, t = rigid_transform_3d(xyz1[best], xyz2[best])
    return R, t, np.linalg.norm(xyz2 @ R.T + t - xyz1, axis=1) < thresh


def host_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_vs_cpu_reloc(torch, device, work, files):
    """Phase 13: (a) matching and RANSAC of the card's keypoints and
    descriptors (phase 12's pair) on the card and on the CPU, and the
    batched RANSAC's time against the JAX algorithm's host loop; (b) the
    relocalisation CLI on 2 queries and 4 database clouds, card against
    CPU."""
    from dh3d_tpu_torch.eval import match_descriptors_mutual, ransac_rigid
    from dh3d_tpu_torch.eval.registration import ransac_draws
    from dh3d_tpu_torch.evaluate.registration_eval import load_kp_file

    (kp1, d1), (kp2, d2) = (load_kp_file(f) for f in files)
    m_gpu = match_descriptors_mutual(d1, d2, device=device).cpu()
    m_cpu = match_descriptors_mutual(d1, d2, device="cpu")
    assert torch.equal(m_gpu, m_cpu), "mutual matches differ card / CPU"
    m = m_cpu.numpy()
    xyz1, xyz2 = kp1[m[:, 0]].astype(np.float64), kp2[m[:, 1]].astype(
        np.float64)
    iters, seed = RELOC["ransac_iters"], 0
    gpu = ransac_rigid(xyz1, xyz2, iters=iters, seed=seed, device=device)
    cpu = ransac_rigid(xyz1, xyz2, iters=iters, seed=seed, device="cpu")
    R, t, inl = ransac_host_loop(xyz1, xyz2, iters, seed)
    assert gpu is not None and cpu is not None, len(m)
    assert np.array_equal(gpu.inliers, cpu.inliers)
    assert np.array_equal(gpu.inliers, inl)
    for a, b in ((gpu.R, cpu.R), (gpu.t, cpu.t), (gpu.R, R), (gpu.t, t)):
        assert np.abs(a - b).max() < 1e-9
    timing = {
        "matches": len(m), "keypoints": [len(kp1), len(kp2)],
        "inliers": gpu.num_inliers, "iters": iters,
        "card_ms": host_ms(lambda: ransac_rigid(
            xyz1, xyz2, iters=iters, seed=seed, device=device), 5),
        "draws_ms": host_ms(lambda: ransac_draws(len(m), iters, seed), 5),
        "host_loop_ms": host_ms(lambda: ransac_host_loop(
            xyz1, xyz2, iters, seed), 3),
        "match_card_ms": host_ms(lambda: match_descriptors_mutual(
            d1, d2, device=device).cpu(), 5)}
    log(f"  matching and RANSAC of the card's pair on card and CPU: "
        f"{len(m)} matches, {gpu.num_inliers} inliers equal, R and t "
        f"within 1e-9; RANSAC {iters} hypotheses: batched on the card "
        f"{timing['card_ms']:.2f} ms (draws {timing['draws_ms']:.2f} ms), "
        f"host loop {timing['host_loop_ms']:.2f} ms")

    runs = {}
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        runs[str(dev)] = reloc_cli(work, "db4.pickle", "query2.pickle", dev)
        runs[str(dev)]["wall_s"] = time.perf_counter() - t0
    cpu_run, gpu_run = runs["cpu"], runs[str(device)]
    differ = {"matches": 0, "inliers": 0}
    for a, b in zip(gpu_run["queries"], cpu_run["queries"]):
        assert a["top1"] == b["top1"], (a["query"], a["top1"], b["top1"])
        assert a["kp_query"] == b["kp_query"], a["query"]
        assert a["kp_db"] == b["kp_db"], a["query"]
        for k in differ:
            differ[k] += int(a[k] != b[k])
    log(f"  relocalisation of 2 queries against 4 clouds on card and CPU: "
        f"top-1 and NMS keypoints equal; queries whose matches / inliers "
        f"differ: {differ}; CPU run {cpu_run['wall_s']:.1f} s, card "
        f"{gpu_run['wall_s']:.2f} s")
    return {"ransac": timing, "cli_differ": differ,
            "cpu_s": cpu_run["wall_s"], "card_s": gpu_run["wall_s"]}


# ------------------- phase 14: the legacy Morton-band mode -------------------

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
    """Phase 14 (a): kernel H against its plain version, bit for bit, at
    the legacy path's shapes (`window_cases`) with its plan (lanes a
    query), each with its device time, bound (8 f32 operations for the d2
    of every pair of each band: H computes them all), A's instruction
    floor over those pairs and its launches a call; then every tile's band
    start read back from H against the formula."""
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

    # every tile's band start: keys on a line, x = their index, and every
    # query at x = -1000, so that each query's nearest key in its band is
    # the band's first
    checked = 0
    for nq, nk, w in WINDOW_START_SHAPES:
        keys = torch.zeros(1, nk, 3, device=device)
        keys[0, :, 0] = torch.arange(nk, device=device, dtype=torch.float32)
        query = torch.zeros(1, nq, 3, device=device)
        query[0, :, 0] = -1000.0
        first = T.knn_window(query, keys, 1, w)[0][0, :, 0].view(-1, 256)
        assert (first == first[:, :1]).all()
        want = [min(max(((2 * i + 1) * 256 * nk) // (2 * nq) - w // 2, 0),
                    nk - w) // 128 * 128 for i in range(nq // 256)]
        got = first[:, 0].tolist()
        assert got == want, (nq, nk, w)
        checked += len(want)
    log(f"  band starts of {checked} tiles at {len(WINDOW_START_SHAPES)} "
        "shapes equal the formula")
    return checked


def entry_forward_fn(device, batch, points=None, **overrides):
    """(fn, points): the main-path model with the config `overrides` on
    `device`, the entry weights, `batch` clouds of `entry`'s seed (or
    `points`)."""
    import torch

    from dh3d_tpu_torch.entry import entry_config, entry_points, entry_weights
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.nn import DH3D, load_flax

    cfg = entry_config()
    cfg.update(overrides)
    model = DH3D(cfg).to(device)
    load_flax(model, entry_weights())
    if points is None:
        points = entry_points(batch)
    return make_forward(cfg, model), torch.as_tensor(points).to(device)


def legacy_forward_phase(torch, kernels, device, fwd_launches):
    """Phase 14 (b): the legacy forward at [20, 8192]: over one forward H
    once, G one time fewer than the exact forward (phase 4), A-D as often;
    outputs checked as phase 4's; both forwards timed in turns."""
    from dh3d_tpu_torch.entry import entry

    B, N = 20, 8192
    fn, points = entry_forward_fn(device, B, morton_exact=False)
    exact_fn, (exact_points,) = entry(device, batch=B)
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs = fn(points)
    torch.cuda.synchronize()
    launches = kernels.counts()
    log(f"  launches in one legacy forward: {launches}")
    assert launches["knn_window"] == 1, launches
    assert launches["knn_topk"] == fwd_launches["knn_topk"] - 1, launches
    for name in ("knn", "fps", "weighted_sum", "flex_moments",
                 "neighbor_max"):
        assert launches[name] == fwd_launches[name], (name, launches)
    check_outputs(torch, outs, points, B, N)
    del outs
    ms = {"exact": [], "legacy": []}
    for mode in ("exact", "legacy", "legacy", "exact"):
        f, p = (exact_fn, exact_points) if mode == "exact" else (fn, points)
        ms[mode].append(cuda_ms(torch, lambda: f(p), warmup=2, reps=10))
    report = {"shape": [B, N, 3], "launches": launches,
              **{f"{m}_ms": v for m, v in ms.items()},
              **{f"{m}_clouds_per_s": B / (statistics.median(v) / 1e3)
                 for m, v in ms.items()}}
    log(f"  forward, in turns (exact, legacy, legacy, exact): exact "
        f"{ms['exact']} ms, legacy {ms['legacy']} ms (CUDA events, median "
        f"of 10 each); {report['exact_clouds_per_s']:.1f} against "
        f"{report['legacy_clouds_per_s']:.1f} clouds/s")
    return launches, report


def card_vs_cpu_legacy(torch, device):
    """Phase 14 (c): the legacy forward at [2, 8192] on the card and on
    the CPU: indices equal, descriptors within phase 5's tolerances."""
    fn_gpu, p_gpu = entry_forward_fn(device, 2, morton_exact=False)
    fn_cpu, p_cpu = entry_forward_fn("cpu", 2, morton_exact=False)
    o_cpu = fn_cpu(p_cpu)
    o_gpu = {k: v.cpu() for k, v in fn_gpu(p_gpu).items()}
    for key in ("xyz", "knn_indices"):
        assert torch.equal(o_gpu[key], o_cpu[key]), key
    errs = {}
    for key in ("local_desc", "attention", "global_desc", "xyz_feat_att"):
        errs[key] = (o_gpu[key] - o_cpu[key]).abs().max().item()
        assert errs[key] <= CARD_VS_CPU_ATOL, (key, errs[key])
    feat_err = (o_gpu["feat"] - o_cpu["feat"]).abs().max().item()
    feat_scale = o_cpu["feat"].abs().max().item()
    assert feat_err <= CARD_VS_CPU_FEAT_REL * feat_scale, (feat_err,
                                                           feat_scale)
    log(f"  indices equal; max abs err {errs}; feat {feat_err:.3g} of "
        f"{feat_scale:.3g}")
    return {**errs, "feat": feat_err, "feat_scale": feat_scale}


def timed_steps(torch, step, reps=5):
    """Median ms of `reps` calls of step() on CUDA events, and the peak
    memory over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 1e9


def legacy_train_phase(torch, kernels, device, train_report):
    """Phase 14 (d): one legacy detection_config step at [20, 8192] (H
    takes the full-resolution kNN) and the phase-6 step with remat=True
    (the local backbone recomputed in the backward), each with finite
    losses, its launches, step time and peak memory; beside phase 6's."""
    from dh3d_tpu_torch.train import make_train_step, synthetic_local_batches
    from dh3d_tpu_torch.train import to_device

    report = {}
    for label, over in (("legacy", {"morton_exact": False}),
                        ("remat", {"remat": True})):
        cfg = stage2_config()
        cfg.update(over)
        state = stage2_state(cfg, device)
        batch = to_device(next(synthetic_local_batches(cfg, seed=0)), device)
        step_fn = make_train_step(cfg)
        step_fn(state, batch)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_counts()
        with InverseBuilds() as builds:
            metrics = step_fn(state, batch)
            torch.cuda.synchronize()
        launches = kernels.counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        assert all(map(math.isfinite, metrics.values())), (label, metrics)
        step_ms, peak_gb = timed_steps(torch,
                                       lambda: step_fn(state, batch))
        report[label] = {"step_ms": step_ms, "peak_mem_gb": peak_gb,
                         "launches": launches,
                         "inverse_builds": len(builds.nbh),
                         "total_cost": metrics["total_cost"]}
        log(f"  {label} step: {step_ms:.2f} ms median of 5 (CUDA events), "
            f"peak {peak_gb:.2f} GB, launches {launches}, CSR inverses "
            f"built {len(builds.nbh)}; total_cost "
            f"{metrics['total_cost']:.4f}")
        del state
    assert report["legacy"]["launches"]["knn_window"] >= 1
    report["phase_6"] = {k: train_report[k] for k in
                         ("step_ms", "peak_mem_gb", "launches",
                          "inverse_builds")}
    log(f"  phase 6's step: {train_report['step_ms']:.2f} ms, peak "
        f"{train_report['peak_mem_gb']:.2f} GB, launches "
        f"{train_report['launches']}")
    return report


def deconv_avg_phase(torch, T, device):
    """Phase 14 (e): `flex_avg` (kernel C on weights of 1) and
    `flex_deconv` (a product, then kernel E on positions) on the card at
    the forward's full-resolution level against their plain versions,
    within WSUM_REL of the largest magnitude."""
    pts, _, nbh, _, _ = train_geometry(torch, T, device)
    B, N, K = nbh.shape
    g = torch.Generator(device="cpu").manual_seed(14)
    feat = torch.randn(B, N, 64, generator=g).to(device)
    theta = (0.1 * torch.randn(3, 64, 64, generator=g)).to(device)
    bias = (0.1 * torch.randn(64, 64, generator=g)).to(device)

    def avg_plain():
        ones = torch.ones(B, N, K, 1, device=device)
        return T.weighted_sum_plain(feat, nbh, ones)

    def deconv_plain():
        f_self = T.gather_neighbors(feat, nbh[:, :, :1])[:, :, 0]
        w = torch.cat([bias[None], theta], 0).permute(1, 0, 2)
        gm = f_self @ w.reshape(64, -1)
        return T.weighted_sum_backward_plain(gm, nbh, T.flex_weights(pts, nbh),
                                             N)

    report = {}
    for name, call, plain in (
            ("flex_avg", partial(T.flex_avg, feat, nbh), avg_plain),
            ("flex_deconv", partial(T.flex_deconv, feat, pts, nbh, theta,
                                    bias), deconv_plain)):
        out, ref = call(), plain()
        err = (out - ref).abs().max().item()
        assert err <= WSUM_REL * ref.abs().max().item(), (name, err)
        report[name] = {"shape": f"C=64 K={K} [{B},{N}]", "max_abs_err": err,
                        "ms": device_ms(torch, call),
                        "plain_ms": device_ms(torch, plain)}
        log(f"  {name} {report[name]}")
    return report


def write_budget_pool(work):
    """The error budget's pool in `work`: two sequences of
    BUDGET["per_sequence"] normalised lidar-like scans of
    BUDGET["num_points"] points (`eval_cloud`'s loader), `seq0/s{i}` at
    northing 10 i and `seq1/s{i}` the same place's scan moved by
    QUERY_MOTION, 3 m further; both GT pickles over both sequences."""
    from dh3d_tpu_torch.data.io import get_fixednum_pcd, write_to_bin

    n, per = BUDGET["num_points"], BUDGET["per_sequence"]
    gts = {"seq0": [], "seq1": []}
    for i in range(per):
        scan = lidar_like_scan(400 + i)
        for seq, cloud, north in (("seq0", scan, 10.0 * i),
                                  ("seq1", moved(scan, QUERY_MOTION, i)[0],
                                   10.0 * i + 3.0)):
            pts, real = get_fixednum_pcd(cloud, n, randsample=False,
                                         need_downsample=True,
                                         rng=np.random.RandomState(i))
            assert real == n, (seq, i, real)
            os.makedirs(os.path.join(work, seq), exist_ok=True)
            write_to_bin(pts, os.path.join(work, seq, f"s{i}.bin"))
            gts[seq].append({"query": f"{seq}/s{i}", "northing": north,
                             "easting": 0.0})
    for name in ("global_ref_demo.pickle", "global_query_demo.pickle"):
        with open(os.path.join(work, name), "wb") as f:
            pickle.dump(gts, f)
    return 2 * per


def budget_phase(work):
    """Phase 14 (f): the port's error-budget CLI on the card, demo weights,
    all four stages; every number finite and 0 < agreement <= 1."""
    from dh3d_tpu_torch.evaluate import error_budget

    clouds = write_budget_pool(work)
    t0 = time.perf_counter()
    report = error_budget.main([
        "--local_model", "models/demo_stage2",
        "--global_model", "models/demo_stage3", "--pcdpath", work,
        "--num_points", str(BUDGET["num_points"]), "--device", "cuda",
        "--json", os.path.join(work, "budget.json")])
    seconds = time.perf_counter() - t0

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) else []

    assert report["n_clouds"] == clouds, report["n_clouds"]
    assert all(map(math.isfinite, numbers(report))), "a non-finite number"
    a = report["A_knn"]["neighbor_agreement_mean"]
    assert 0 < a <= 1, a
    g, rep = report["BC_global"], report["C_repeatability"]
    summary = {
        "seconds": seconds, "clouds": clouds,
        "neighbor_agreement": [a, report["A_knn"][
            "neighbor_agreement_min_cloud"]],
        "local_desc_cos_p50_p01": {
            m: [v["local_desc_cos_p50"], v["local_desc_cos_p01"]]
            for m, v in report["B_local"].items()},
        "global_desc_cos_p50": {m: g[m]["global_desc_cos_p50"]
                                for m in ("morton", "approx")},
        "recall@1": {"parity": g["recall@1_parity"],
                     **{m: [g[m]["recall@1"],
                            g[m]["recall@1_diff_vs_parity_ci95"]]
                        for m in ("morton", "approx")}},
        "recall@25": {"parity": g["recall@25_parity"],
                      **{m: [g[m]["recall@25"],
                             g[m]["recall@25_diff_vs_parity_ci95"]]
                         for m in ("morton", "approx")}},
        "repeatability@512": rep}
    log(f"  error budget, {clouds} clouds at N={BUDGET['num_points']} in "
        f"{seconds:.1f} s: {json.dumps(summary)}")
    return summary


# ------------------- phase 15: the port's entry points -------------------

# the CUDA functions of each kernel, as a profiler trace names them
TRACE_KERNELS = {
    "A knn": ("knn_kernel",),
    "B fps": ("fps_kernel",),
    "C weighted_sum / flex_moments": ("weighted_sum_loop_kernel",
                                      "weighted_sum_unrolled_kernel"),
    "D neighbor_max": ("neighbor_max_loop_kernel",
                       "neighbor_max_unrolled_kernel"),
    "E weighted_sum_backward / flex_moments_backward":
        ("weighted_sum_bwd_kernel",),
    "F neighbor_max_backward": ("neighbor_max_bwd_kernel",),
    "G knn_topk": ("topk_search",),
}


def bench_phase(torch, kernels, device, fwd_launches, fwd_ms):
    """Phase 15 (a): `dh3d_tpu_torch.bench`'s seven workloads in this
    process.  Returns (launches over the whole bench, report)."""
    from dh3d_tpu_torch import bench

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.reset_counts()
    vals, reports = bench.collect(device)
    torch.cuda.synchronize()
    launches = kernels.counts()
    seconds = time.perf_counter() - t0
    line = bench.summary(vals, reports["fwd_fast"]["input_class"],
                         bench.device_line(device))
    log(json.dumps(line))
    for name, v in vals.items():
        assert math.isfinite(v) and v > 0, (name, v)
    one = {name: r["launches"] for name, r in reports.items()}
    assert one["fwd_fast"] == fwd_launches, (one["fwd_fast"], fwd_launches)
    only = {"train_fast": TRAIN_KERNELS, "knn_ms": ("knn_topk",),
            "flex_ms": ("flex_moments",)}
    for name, launched in only.items():
        for k, n in one[name].items():
            assert (n > 0) == (k in launched), (name, k, n)
    for name in ("fwd_parity", "train_pre", "train_cps"):
        for k in FORWARD_KERNELS:
            assert one[name][k] > 0, (name, k, one[name])
    for name, r in reports.items():
        assert math.isfinite(r["window"]) and r["window"] > 0, (name, r)
        log(f"  {name}: {vals[name]:.3f} (median call), {r['window']:.3f} "
            f"(window); one call launches "
            f"{ {k: n for k, n in r['launches'].items() if n} }; median of "
            f"{len(r['ms'])} calls {statistics.median(r['ms']):.3f} ms "
            f"(spread {min(r['ms']):.3f}-{max(r['ms']):.3f}); peak "
            f"{r['peak_mem_gb']:.2f} GB")
    log(f"  fwd_fast {vals['fwd_fast']:.1f} clouds/s (random weights) "
        f"beside phase 4's {20 / (fwd_ms / 1e3):.1f} (demo weights); the "
        f"bench took {seconds:.1f} s")
    split = morton_split(torch, device)
    return launches, {"line": line, "seconds": seconds, "workloads": {
        name: {"value": vals[name], **r} for name, r in reports.items()},
        "morton_split": split}


def kernel_group(name) -> str:
    """The group of a CUDA kernel, by the name a profiler trace gives it:
    A-G, the sort, gathers and scatters, GEMMs, or other."""
    for group, keys in TRACE_KERNELS.items():
        if any(key in name for key in keys):
            return group.split()[0]
    low = name.lower()
    for group, keys in (("sort", ("sort",)),
                        ("gather/scatter", ("index", "gather", "scatter")),
                        ("gemm", ("gemm", "xmma", "cutlass"))):
        if any(key in low for key in keys):
            return group
    return "other"


def device_ms_by_kernel(torch, call, work) -> dict:
    """{kernel name: device ms} of one call of `call()`, from a profiler
    Chrome trace (the same route as `train --profile`)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    return by_name


def morton_split(torch, device) -> dict:
    """Where the Morton order's time goes, by device time of each kernel
    group in one profiled call of the bench's `fwd_fast` against
    `fwd_parity` and of `train_fast` against `train_pre` (the same step
    on clouds sorted on the host), and the sort's own pieces timed alone
    at the forward's shapes: `morton_perm` with the gather of the
    points, and the un-permute of the eval outputs."""
    from dh3d_tpu_torch import bench
    from dh3d_tpu_torch.nn.model import DH3D, _take_rows
    from dh3d_tpu_torch.ops.morton import morton_perm
    from dh3d_tpu_torch.train import (init_state, make_eval_step,
                                      make_train_step, to_device)

    pts, _ = bench.bench_clouds(20, 8192)
    points = torch.from_numpy(pts).to(device)
    out = {"pairs": {}, "alone_ms": {}}
    with tempfile.TemporaryDirectory() as work:
        for fast, plain in (("fwd_fast", "fwd_parity"),
                            ("train_fast", "train_pre")):
            groups = {}
            for name in (fast, plain):
                if name.startswith("fwd"):
                    cfg = bench.forward_config(8192, name == "fwd_fast")
                    torch.manual_seed(0)
                    model = DH3D(cfg).to(device)
                    step = make_eval_step(cfg, model)
                    call = (lambda step=step: step({"points": points}))
                    outs = call()
                else:
                    pre = name == "train_pre"
                    cfg = bench.train_config(10, 8192, 512, True, pre)
                    state = init_state(cfg, 0, device)
                    batch = to_device(bench.train_batch(10, 8192, 512, pre),
                                      device)
                    step = make_train_step(cfg)
                    call = (lambda step=step, state=state, batch=batch:
                            step(state, batch))
                ms = device_ms_by_kernel(torch, call, work)
                g = groups[name] = {"total": sum(ms.values())}
                for k, v in ms.items():
                    g[kernel_group(k)] = g.get(kernel_group(k), 0.0) + v
                del call, step
                gc.collect()
                torch.cuda.empty_cache()
            keys = sorted(set(groups[fast]) | set(groups[plain]))
            out["pairs"][f"{fast} - {plain}"] = {
                k: groups[fast].get(k, 0.0) - groups[plain].get(k, 0.0)
                for k in keys}
            out["pairs"][f"{fast} - {plain}"]["groups"] = groups
    perm, inv = morton_perm(points)
    dense = [v for v in outs.values() if v.is_floating_point()
             and v.shape[:2] == points.shape[:2]]
    out["alone_ms"] = {
        "morton_perm + gather of the points": device_ms(
            torch, lambda: _take_rows(points, morton_perm(points)[0])),
        f"un-permute of {len(dense)} eval outputs": device_ms(
            torch, lambda: [_take_rows(v, inv) for v in dense])}
    for pair, d in out["pairs"].items():
        log(f"  {pair}, device ms by kernel group in one call: "
            f"{ {k: round(v, 3) for k, v in d.items() if k != 'groups'} }")
    log(f"  the sort's pieces alone at [20, 8192]: "
        f"{ {k: round(v, 3) for k, v in out['alone_ms'].items()} }")
    return out


def curriculum_phase(torch, kernels, pool, work):
    """Phase 15 (b): the curriculum script, one step a stage at the
    presets' widths.  Returns (launches over the three stages, report,
    (stage 2's logdir, stage 3's))."""
    from dh3d_tpu_torch.nn.convert import warm_start_state_dict
    from dh3d_tpu_torch.scripts.train_demo_curriculum import main as run

    argv = ["--pool", pool, "--out", os.path.join(work, "curriculum"),
            "--steps", "1", "1", "1"]
    t0 = time.perf_counter()
    kernels.reset_counts()
    summaries = run(argv)
    torch.cuda.synchronize()
    launches = kernels.counts()
    seconds = time.perf_counter() - t0
    logdirs = [os.path.join(work, "curriculum", "seed0", f"stage{n}")
               for n in (1, 2, 3)]
    s1, s2, s3 = (summaries[f"seed0/stage{n}"] for n in (1, 2, 3))
    for n, s in enumerate((s1, s2, s3), start=1):
        assert all(map(math.isfinite, s["metrics"].values())), s["metrics"]
        log(f"  stage {n}: restored {s['restored']}; step "
            f"{s['step_ms'][0]:.2f} ms (CUDA events); wait in "
            f"next(batches) {1e3 * s['wait_s'][0]:.1f} ms; launches "
            f"{ {k: v for k, v in s['launches'][0].items() if v} }")
    saved1, saved2, saved3 = map(warm_start_state_dict, logdirs)
    assert s2["restored"] == len(saved1) > 0, (s2["restored"], len(saved1))
    local = {k for k in saved2 if k.startswith("local_backbone.")}
    common = {k for k, t in saved2.items()
              if k in saved3 and saved3[k].shape == t.shape}
    assert s3["restored"] == len(local) and common == local, \
        (s3["restored"], len(local), sorted(common ^ local))
    for k in local:
        assert torch.equal(saved3[k], saved2[k]), k
    again = run(argv)
    assert all(v is None for v in again.values()), again
    log(f"  stage 2 restored all {len(saved1)} tensors stage 1 saved; "
        f"stage 3 the {len(local)} local_backbone tensors of stage 2, "
        f"which it kept bit for bit; a second call ran no stage; "
        f"{seconds:.1f} s")
    report = {"seconds": seconds, "restored": [s2["restored"],
                                               s3["restored"]],
              "step_ms": [s["step_ms"][0] for s in (s1, s2, s3)],
              "wait_ms": [1e3 * s["wait_s"][0] for s in (s1, s2, s3)]}
    return launches, report, logdirs[1:]


def export_phase(torch, device, work, stage2, stage3):
    """Phase 15 (c): the exporter on the curriculum's stages 2 and 3."""
    from dh3d_tpu_torch.entry import entry_points
    from dh3d_tpu_torch.eval.extract import make_forward
    from dh3d_tpu_torch.nn.convert import load_npz
    from dh3d_tpu_torch.scripts.package_checkpoint import main as export
    from dh3d_tpu_torch.train import resolve_model

    stem3 = os.path.join(work, "export", "stage3")
    flat3 = export(["--ckpt", stage3, "--out", stem3])
    ref = load_npz("models/demo_stage3.npz")
    assert set(flat3) == set(ref), sorted(set(flat3) ^ set(ref))
    for k, v in ref.items():
        assert flat3[k].shape == v.shape and flat3[k].dtype == v.dtype, k
    assert os.path.isfile(stem3 + ".config.json")
    points = torch.from_numpy(entry_points(4, 8192, seed=3)).to(device)
    outs = []
    for src in (stage3, stem3):
        cfg, model = resolve_model(src)
        outs.append(make_forward(cfg, model.to(device))(points))
    a, b = outs
    assert set(a) == set(b)
    for k in a:
        assert torch.isfinite(a[k].float()).all(), k
        assert torch.equal(a[k], b[k]), k
    flat2 = export(["--ckpt", stage2, "--out", os.path.join(
        work, "export", "stage2")])
    local3 = {k for k in flat3 if k.split("/")[1:2] == ["local_backbone"]}
    local2 = {k for k in flat2 if k.split("/")[1:2] == ["local_backbone"]}
    assert local2 == local3, sorted(local2 ^ local3)
    for k in local3:
        assert np.array_equal(flat2[k], flat3[k]), k
    log(f"  stage 3 exported: {len(flat3)} arrays, the keys and shapes of "
        f"models/demo_stage3.npz; export and logdir give the same forward "
        f"bits at [4, 8192]; stage 2's export holds the same "
        f"{len(local3)} local_backbone arrays")
    return {"arrays": len(flat3), "local_backbone_arrays": len(local3)}


def profile_phase(work):
    """Phase 15 (d): `train --profile` over 16 synthetic steps; the trace
    names every kernel of the step."""
    from dh3d_tpu_torch.train.__main__ import main as train_main

    logdir = os.path.join(work, "profiled")
    s = train_main(["--cfg", "detection_config", "--synthetic", "--steps",
                    "16", "--profile", "--logdir", logdir])
    path = s["profile"]
    assert path and os.path.dirname(path) == os.path.join(logdir, "profile")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [k for k, keys in TRACE_KERNELS.items()
               if not any(key in n for n in names for key in keys)]
    assert not missing, (missing, sorted(names)[:50])
    size_mb = os.path.getsize(path) / 1e6
    step_ms = statistics.median(s["step_ms"][1:])
    log(f"  {os.path.relpath(path, logdir)}: {size_mb:.1f} MB, "
        f"{len(names)} distinct CUDA kernels, A-G among them; step "
        f"{step_ms:.2f} ms (median of steps 1-15, profiled ones included)")
    return {"trace_mb": size_mb, "cuda_kernels": len(names),
            "step_ms_median": step_ms}


# ------------------------- phase 16: bf16 compute_dtype -------------------------

def bf16_close(out, ref):
    """Within one bf16 step of each value plus WSUM_REL of the largest
    (phase 16's limits); returns the largest difference."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert (err <= BF16_STEP * ref.abs()
            + WSUM_REL * ref.abs().max()).all(), err.max().item()
    return err.max().item()


def bf16_kernel_phase(torch, T, device, cases):
    """Phase 16 (a): the bf16 cases of C and E at row 7's and row 10's
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


def bf16_forward_phase(torch, kernels, device, fwd_launches):
    """Phase 16 (b): the bf16 forward at [20, 8192]: over one forward the
    bf16 case of C as often as phase 4's forward launches the f32 case
    (5), which it does not launch, every other kernel as often; outputs
    checked as phase 4's; clouds/s and peak memory in turns with the f32
    forward."""
    B, N = 20, 8192
    fns = {d: entry_forward_fn(device, B, compute_dtype=d)
           for d in ("float32", "bfloat16")}
    fn, points = fns["bfloat16"]
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs = fn(points)
    torch.cuda.synchronize()
    launches = kernels.counts()
    log(f"  launches in one bf16 forward: {launches}")
    want = dict(fwd_launches)
    for f32_case, bf16_case in BF16_CASES.items():
        want[bf16_case], want[f32_case] = want[f32_case], 0
    assert launches == want, (launches, want)
    assert launches["flex_moments_bf16"] == 5, launches
    check_outputs(torch, outs, points, B, N)
    del outs
    ms = {"float32": [], "bfloat16": []}
    peak = {}
    for d in ("float32", "bfloat16", "bfloat16", "float32"):
        f, p = fns[d]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f(p)
        torch.cuda.synchronize()
        peak[d] = torch.cuda.max_memory_allocated() / 1e9
        ms[d].append(cuda_ms(torch, lambda: f(p), warmup=2, reps=10))
    report = {"shape": [B, N, 3], "launches": launches,
              "ms": ms, "peak_mem_gb": peak,
              "clouds_per_s": {d: B / (statistics.median(v) / 1e3)
                               for d, v in ms.items()}}
    try:
        report["profile_ms"] = profile_step(torch, lambda: fn(points))
        report["profile_ms"].pop("E + F + inverse builds", None)
    except Exception as e:  # the split is a report, not a check
        report["profile_ms"] = {"not measured": repr(e)}
    log(f"  forward, in turns (f32, bf16, bf16, f32): f32 {ms['float32']} "
        f"ms, bf16 {ms['bfloat16']} ms (CUDA events, median of 10 each); "
        f"{report['clouds_per_s']['float32']:.1f} against "
        f"{report['clouds_per_s']['bfloat16']:.1f} clouds/s; peak {peak} GB;"
        f" profile of one bf16 forward (device ms) {report['profile_ms']}")
    return launches, report


def _rms(t) -> float:
    return t.double().pow(2).mean().sqrt().item()


def card_vs_cpu_bf16(torch, device):
    """Phase 16 (c): the bf16 forward at [2, 8192] on the card and on the
    CPU: indices equal, outputs f32 and within `BF16_CARD_VS_CPU`, and the
    descriptors closer to the CPU's bf16 forward than its f32 forward is
    (`BF16_CLOSER`)."""
    fn_gpu, p_gpu = entry_forward_fn(device, 2, compute_dtype="bfloat16")
    fn_cpu, p_cpu = entry_forward_fn("cpu", 2, compute_dtype="bfloat16")
    fn_f32, _ = entry_forward_fn("cpu", 2)
    o_cpu, o_f32 = fn_cpu(p_cpu), fn_f32(p_cpu)
    o_gpu = {k: v.cpu() for k, v in fn_gpu(p_gpu).items()}
    for key in ("xyz", "knn_indices"):
        assert torch.equal(o_gpu[key], o_cpu[key]), key
    report = {}
    for key, (top, rms) in {**BF16_CARD_VS_CPU, "feat": BF16_FEAT_REL}.items():
        assert o_gpu[key].dtype == torch.float32, key
        err = o_gpu[key] - o_cpu[key]
        scale = o_cpu[key].abs().max().item() if key == "feat" else 1.0
        report[key] = {"max": err.abs().max().item(), "rms": _rms(err),
                       "scale": scale}
        assert report[key]["max"] <= top * scale, (key, report[key])
        assert report[key]["rms"] <= rms * scale, (key, report[key])
    for key in ("local_desc", "global_desc"):
        f32_rms = _rms(o_f32[key] - o_cpu[key])
        report[key]["cpu_f32_rms"] = f32_rms
        assert BF16_CLOSER * report[key]["rms"] <= f32_rms, (key, report)
    log(f"  indices equal; card - CPU, bf16: {report}")
    return report


def bf16_agreement(torch, device):
    """Phase 16 (e), reported: the bf16 forward against the f32 forward on
    4 normalised lidar-like clouds at N=8192, demo weights: the cosine of
    each point's local descriptor and each cloud's global descriptor, and
    the share of the f32 forward's NMS keypoints (the CLI's defaults) that
    the bf16 forward's attention also selects."""
    from dh3d_tpu_torch.eval.nms import device_nms

    clouds = np.stack([eval_cloud(100 + s, 8192) for s in range(4)])
    outs = {}
    for d in ("float32", "bfloat16"):
        fn, points = entry_forward_fn(device, 4, clouds, compute_dtype=d)
        outs[d] = fn(points)
    a, b = outs["float32"], outs["bfloat16"]
    local = (a["local_desc"] * b["local_desc"]).sum(-1)
    glob = (a["global_desc"] * b["global_desc"]).sum(-1)
    overlap = []
    for i in range(len(clouds)):
        kps = [set(device_nms(o["xyz"][i], o["attention"][i], NMS["radius"],
                              NMS["ratio"], NMS["max_kp"],
                              device=device)[1].tolist()) - {-1}
               for o in (a, b)]
        overlap.append(len(kps[0] & kps[1]) / max(1, len(kps[0])))
    report = {"local_cos_min": local.min().item(),
              "local_cos_mean": local.mean().item(),
              "local_cos_p01": local.flatten().quantile(0.01).item(),
              "global_cos": glob.tolist(), "nms_overlap": overlap,
              "attention_max_diff": (a["attention"] - b["attention"]).abs()
              .max().item()}
    log(f"  bf16 against f32, demo weights, 4 clouds [8192]: {report}")
    return report


def bf16_cli_phase(torch, kernels, work, device="cuda"):
    """Phase 16 (f): `python -m dh3d_tpu_torch.train --set
    compute_dtype='"bfloat16"'` (3 synthetic detection_config steps at
    [20, 8192], in this process), the exporter on its logdir (the config
    keeps the key), the local extraction CLI with NMS from the export on 2
    scans (the bf16 case of C launched, f32 keypoint files), and the global
    extraction CLI from demo_stage3's arrays under a bf16 config."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import write_to_bin
    from dh3d_tpu_torch.evaluate import globaldesc_extract, localdesc_extract
    from dh3d_tpu_torch.scripts.package_checkpoint import main as export
    from dh3d_tpu_torch.train.__main__ import main as train_main

    logdir = os.path.join(work, "train_bf16")
    kernels.reset_counts()
    s = train_main(["--cfg", "detection_config", "--synthetic", "--steps",
                    "3", "--set", 'compute_dtype="bfloat16"', "--logdir",
                    logdir, "--device", str(device)])
    torch.cuda.synchronize()
    train_launches = kernels.counts()
    assert all(map(math.isfinite, s["metrics"].values())), s["metrics"]
    for name in BF16_TRAIN_KERNELS:
        assert train_launches[name] > 0, (name, train_launches)
    for name in BF16_CASES:
        assert train_launches[name] == 0, (name, train_launches)
    stem = os.path.join(work, "export", "stage2_bf16")
    export(["--ckpt", logdir, "--out", stem])
    cfg = cfglib.load_config(stem + ".config.json")
    assert cfg.compute_dtype == "bfloat16", cfg.compute_dtype
    scans = os.path.join(work, "scans")
    os.makedirs(scans)
    for i in range(2):
        write_to_bin(lidar_like_scan(200 + i), os.path.join(scans,
                                                            f"s{i}.bin"))
    kernels.reset_counts()
    out = os.path.join(work, "nms")
    summary = localdesc_extract.main([
        "--ModelPath", stem, "--pcdpath", scans, "--dim", "3", "--device",
        str(device), "--batch_size", "1", "--save_dir", out,
        "--perform_nms"])
    torch.cuda.synchronize()
    extract_launches = kernels.counts()
    assert extract_launches["flex_moments_bf16"] > 0, extract_launches
    assert extract_launches["flex_moments"] == 0, extract_launches
    kps = [len(check_rows(os.path.join(out, f"s{i}_nms_res.bin"),
                          NMS["max_kp"])) for i in range(2)]
    g_stem = os.path.join(work, "stage3_bf16")
    shutil.copy("models/demo_stage3.npz", g_stem + ".npz")
    g_cfg = cfglib.load_config("models/demo_stage3.config.json")
    g_cfg.compute_dtype = "bfloat16"
    cfglib.save_config(g_cfg, g_stem + ".config.json")
    gt = os.path.join(work, "gt.pickle")
    with open(gt, "wb") as f:
        pickle.dump({"seq0": [{"query": f"s{i}", "northing": 10.0 * i,
                               "easting": 0.0} for i in range(2)]}, f)
    kernels.reset_counts()
    gsum = globaldesc_extract.main([
        "--ModelPath", g_stem, "--pcdpath", scans, "--ref_gt_file", gt,
        "--query_gt_file", gt, "--batch_size", "2", "--num_points", "8192",
        "--device", str(device), "--save_dir", os.path.join(work, "global")])
    torch.cuda.synchronize()
    assert kernels.counts()["flex_moments_bf16"] > 0
    for i in range(2):
        d = np.fromfile(os.path.join(work, "global", f"s{i}.bin"), np.float32)
        assert d.shape == (256,) and np.isfinite(d).all(), i
        assert abs(np.linalg.norm(d) - 1) < 1e-4, i
    report = {"train_metrics": s["metrics"],
              "train_step_ms": s["step_ms"], "keypoints": kps,
              "local_seconds": summary["seconds"],
              "global_clouds": gsum["clouds"]}
    log(f"  train CLI bf16, 3 steps: {s['metrics']['total_cost']:.4f} "
        f"total_cost, steps {s['step_ms']} ms (CUDA events); "
        f"export keeps compute_dtype; local extraction from the export: "
        f"{kps} keypoints; global extraction (bf16 config): 2 descriptors")
    return train_launches, report


def dp_global_case(torch):
    """Phase 17 (a): (cfg, weights, whole batch) on the CPU."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.nn.convert import load_npz, smart_init
    from dh3d_tpu_torch.train import init_state

    cfg = cfglib.load_config("models/demo_stage3.config.json")
    cfg.cross_device_mining = True
    cfg.warmup_steps = 0
    state = init_state(cfg, 0, "cpu")
    flat = {k: v for k, v in load_npz("models/demo_stage3.npz").items()
            if k.split("/")[1:2] == ["local_backbone"]}
    assert smart_init(state.model, flat) == len(flat)
    clouds = cfg.batch_size * (1 + cfg.num_pos + cfg.num_neg + 1)
    pts = np.random.RandomState(17).randn(clouds, cfg.num_points, 3)
    pts = morton_sort_np(pts.astype(np.float32))
    return cfg, state.model.state_dict(), {"points": torch.from_numpy(pts)}


def dp_detection_case(torch, device):
    """Phase 17 (b): (cfg, weights, whole batch with its pair draws, made
    on the card) on the CPU."""
    from dh3d_tpu_torch import config as cfglib
    from dh3d_tpu_torch.data.io import morton_sort_np
    from dh3d_tpu_torch.parallel.jobs import to
    from dh3d_tpu_torch.train import add_draws, to_device

    cfg = cfglib.load_config("models/demo_stage2.config.json")
    assert cfg.device_pairgen and cfg.morton_presorted
    state = stage2_state(cfg, "cpu")
    rng = np.random.RandomState(18)
    B, N = cfg.batch_size, cfg.num_points
    pc1 = (rng.randn(B, N, 3) * 20).astype(np.float32)
    pc2 = np.stack([p[rng.permutation(N)] for p in pc1]) \
        + (rng.randn(B, N, 3) * 0.02).astype(np.float32)
    batch = to_device({"pc1": morton_sort_np(pc1),
                       "pc2": morton_sort_np(pc2)}, device)
    pairgen = torch.Generator(device=device).manual_seed(18)
    batch = add_draws(batch, cfg, pairgen)
    return cfg, state.model.state_dict(), to(batch, "cpu")


def step_errors(one, other, bn_fed, lr) -> dict:
    """The largest difference of each kind between two steps'
    `step_result`s, each as a share of its `DP_*` limit."""
    worst = {}

    def share(kind, err, limit):
        worst[kind] = max(worst.get(kind, 0.0), err / limit)

    total = abs(one["metrics"]["total_cost"])
    for k, v in one["metrics"].items():
        share("metrics", abs(other["metrics"][k] - v),
              DP_METRIC_REL * max(total, abs(v)))
    top = max(g.abs().max().item() for g in one["grads"].values())
    for name, g in one["grads"].items():
        scale = top * 1e-1 if name in bn_fed else g.abs().max().item()
        share("grads", (other["grads"][name] - g).abs().max().item(),
              DP_GRAD_REL * scale)
        for key, factor in (("exp_avg", 0.1), ("exp_avg_sq", 1e-3 * scale)):
            err = (other["adam"][name][key] - one["adam"][name][key]).abs()
            share("adam", err.max().item(), 2 * DP_GRAD_REL * factor * scale)
        diff = (other["state"][name] - one["state"][name]).abs()
        sure = g.abs() > 1e-2 * scale
        share("params_sure", diff[sure].max().item() if sure.any() else 0.0,
              1e-6)
        share("params", diff.max().item(), 2 * lr + 1e-6)
    for name, v in one["state"].items():
        if name not in one["grads"]:  # BN statistics, frozen parameters
            share("bn", (other["state"][name] - v).abs().max().item(),
                  DP_BN_REL * v.abs().max().item() + 1e-6)
    return worst


def reversed_tuples(torch, cfg, batch):
    """`batch` (a phase-17 case's, with its draws) with its tuples, or
    pairs, in reverse order: the same step in exact arithmetic."""
    out = dict(batch)
    if "pc1" in batch:
        out["pc1"], out["pc2"] = batch["pc1"].flip(0), batch["pc2"].flip(0)
        out["pairgen_draws"] = tuple(d.flip(0) for d in batch["pairgen_draws"])
        return out
    B = cfg.batch_size
    parts = batch["points"].split([B, cfg.num_pos * B, cfg.num_neg * B, B])
    out["points"] = torch.cat([p.reshape(B, -1, *p.shape[1:]).flip(0)
                               .reshape(p.shape) for p in parts])
    return out


def one_process_step(torch, kernels, device, cfg, weights, batch):
    """The one-process step of a phase-17 case on the card: its
    `step_result`, launches, `bn_fed_biases` and the median of 3 more
    steps on CUDA events."""
    from dh3d_tpu_torch.nn.layers import bn_fed_biases
    from dh3d_tpu_torch.parallel.jobs import step_result, to
    from dh3d_tpu_torch.train import init_state, make_train_step

    state = init_state(cfg, 0, device)
    state.model.load_state_dict(weights)
    step = make_train_step(cfg)
    batch = to(batch, device)
    torch.cuda.synchronize()
    kernels.reset_counts()
    m = step(state, batch)
    torch.cuda.synchronize()
    out = step_result(state, m)
    out["launches"] = kernels.counts()
    out["bn_fed"] = bn_fed_biases(state.model)
    out["step_ms"] = cuda_ms(torch, lambda: step(state, batch), warmup=0,
                             reps=3)
    return out


def raises(exc, fn):
    """Whether fn() raises `exc` (another exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def parallel_phase(torch, kernels, device):
    """Phase 17.  Returns ({path: launches of rank 0}, report)."""
    from dh3d_tpu_torch import ops as T
    from dh3d_tpu_torch.entry import dryrun_multichip
    from dh3d_tpu_torch.parallel import jobs
    from dh3d_tpu_torch.parallel.launch import spawn
    from dh3d_tpu_torch.train.__main__ import main as train_main

    cases = {"global": dp_global_case(torch),
             "detection": dp_detection_case(torch, device)}
    g = torch.Generator().manual_seed(19)
    knn_cases = [((torch.randn(B, N, 3, generator=g) * 30), 8)
                 for B, N in ((20, 8192), (1, 16384))]
    one = {name: one_process_step(torch, kernels, device, *case)
           for name, case in cases.items()}
    noise = {}
    for name, (cfg, weights, batch) in cases.items():
        rev = one_process_step(torch, kernels, device, cfg, weights,
                               reversed_tuples(torch, cfg, batch))
        noise[name] = step_errors(one[name], rev, one[name]["bn_fed"],
                                  cfg.start_lr)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(jobs.calls_job, 2, (
        [(jobs.step_job, (dict(cfg), weights, batch, 3))
         for cfg, weights, batch in cases.values()]
        + [(jobs.knn_job, (knn_cases,))],), device="cuda", backend="gloo")
    spawn_s = time.perf_counter() - t0
    report, launches = {"spawn_s": spawn_s}, {}
    for i, (name, (cfg, _, batch)) in enumerate(cases.items()):
        o = one[name]
        for r, rank in enumerate(ranks):
            res = rank[i]
            for key in ("grads", "state"):
                for k, v in res[key].items():
                    assert torch.equal(v, ranks[0][i][key][k]), (name, k)
            worst = step_errors(o, res, o["bn_fed"], cfg.start_lr)
            for kind, err in worst.items():
                assert err <= max(1.0, 2 * noise[name][kind]), \
                    (name, kind, err, noise[name][kind])
            for k, n in o["launches"].items():
                assert n == 0 or res["launches"][k] > 0, (name, r, k)
        clouds = next(iter(batch.values())).shape[0] * (
            2 if "pc1" in batch else 1)
        report[name] = {
            "clouds": clouds, "clouds_a_rank": clouds // 2,
            "one_process_ms": o["step_ms"],
            "rank_ms": [statistics.median(r[i]["step_ms"]) for r in ranks],
            "errors_of_limit": worst, "order_noise_of_limit": noise[name],
            "metrics": ranks[0][i]["metrics"],
            "launches_a_rank": ranks[0][i]["launches"],
            "launches_one_process": o["launches"]}
        launches[f"parallel_{name}"] = ranks[0][i]["launches"]
        log(f"  ({'a' if name == 'global' else 'b'}) {name}: 2 ranks on "
            f"cuda:0 (gloo) match one process; errors {worst} of their "
            f"limits, the order noise {noise[name]}; "
            f"step {report[name]['rank_ms']} "
            f"ms a rank, one process {o['step_ms']:.2f} ms; launches a rank "
            f"{ranks[0][i]['launches']}")
    for r, rank in enumerate(ranks):
        for (pts, k), (idx, dist, counts) in zip(knn_cases, rank[-1]):
            assert counts["knn_topk"] > 0, counts
            want_idx, want_dist = T.knn_bruteforce(pts.to(device), k)
            block = slice(r * pts.shape[1] // 2, (r + 1) * pts.shape[1] // 2)
            assert torch.equal(idx, want_idx[:, block].cpu())
            assert torch.equal(dist, want_dist[:, block].cpu())
    launches["parallel_knn"] = ranks[0][-1][0][2]
    log("  (d) knn_sharded on 2 ranks, [20, 8192] and [1, 16384] k=8: equal "
        "to knn_bruteforce bit for bit")

    with tempfile.TemporaryDirectory() as work:
        argv = ["--cfg", "detection_config", "--synthetic", "--steps", "3",
                "--load", "models/demo_stage2.npz", "--logdir", work]
        t0 = time.perf_counter()
        s = train_main(argv + ["--num_devices", "1"])
        cli_s = time.perf_counter() - t0
        assert all(map(math.isfinite, s["metrics"].values())), s["metrics"]
        assert os.listdir(os.path.join(work, "ckpt")) == [
            "step_00000003.pt"]
        for name in TRAIN_KERNELS:
            assert s["launches"][-1][name] > 0, (name, s["launches"][-1])
        if torch.cuda.device_count() < 2:
            assert raises(ValueError, lambda: train_main(
                argv + ["--num_devices", "2"])), "--num_devices 2 ran"
    launches["parallel_cli_nccl"] = s["launches"][-1]
    report["nccl_cli"] = {"seconds": cli_s, "step_ms": s["step_ms"],
                          "metrics": s["metrics"]}
    log(f"  (c) train --num_devices 1 on NCCL: {cli_s:.1f} s, steps "
        f"{s['step_ms']} ms; --num_devices 2 raised on "
        f"{torch.cuda.device_count()} card(s)")

    t0 = time.perf_counter()
    dryrun_multichip(2)
    report["dryrun_s"] = time.perf_counter() - t0
    log(f"  (e) dryrun_multichip(2): {report['dryrun_s']:.1f} s")
    log(f"  correctness runs, two ranks sharing one card: {card_line()}")
    return launches, report


def loader_counts_on_host(torch, fn):
    """fn() with CUDA hidden from the loader: its outlier removal counts
    with `cKDTree` on the host, as on a machine without a card."""
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        return fn()
    finally:
        torch.cuda.is_available = real


def radius_phase(torch, T, kernels, device):
    """Phase 18: kernel I, the loader's radius count.  Returns its report.

    (a) against its plain version and `cKDTree`, bit for bit, one launch a
    call: the raw extraction's count input (a 30,000-point scan through the
    voxel grid, M ~ 27,800), an eval cloud (M = 16384) and the boundary
    cloud (`radius_boundary_cloud`); device ms, plain ms, the FP64 bound,
    `cKDTree`'s host ms; at the first two every split of RADIUS_PLANS, each
    equal.  (b) `remove_radius_outlier` on the raw scan, host ms on the
    card and with `cKDTree`, the same indices.  (c) `LocalTestDataset` at
    N=16384 over RADIUS_LOADER_FILES scans: the same clouds on the card
    and with `cKDTree`, one launch a cloud (`launches.radius_count`), and
    the load's host ms a cloud both ways.  (d) the loader in
    `ThreadedPrefetcher`'s thread hands over its clouds while a ~2 s sleep
    kernel queued on the default stream still runs."""
    from scipy.spatial import cKDTree

    from dh3d_tpu_torch import trace
    from dh3d_tpu_torch.data import LocalTestDataset
    from dh3d_tpu_torch.data import io
    from dh3d_tpu_torch.data.prefetch import ThreadedPrefetcher
    from dh3d_tpu_torch.data.synthetic import radius_boundary_cloud

    def host_counts(cloud):
        return cKDTree(cloud).query_ball_point(cloud, r=1.0,
                                               return_length=True)

    raw = io.voxel_downsample(lidar_like_scan(40))
    report = {"cases": []}
    for name, cloud in (("raw scan", raw), ("eval cloud", eval_cloud(41, 16384)),
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
        row = {"case": name, "m": m,
               "plan": T.radius_plan(m, kernels.sm_count(device.index or 0)),
               "ms": device_ms(torch, partial(T.radius_count, pts, 1.0)),
               "plain_ms": device_ms(torch, partial(T.radius_count_plain,
                                                    pts, 1.0), reps=3),
               "bound_ms": 1e3 * m * m * RADIUS_FP64_PER_PAIR
               / FP64_INSTRUCTIONS_PER_S,
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
        report["cases"].append(row)

    keep = io.remove_radius_outlier(raw)
    assert np.array_equal(keep, loader_counts_on_host(
        torch, partial(io.remove_radius_outlier, raw)))
    report["outlier_removal_host_ms"] = {
        "card": host_ms(partial(io.remove_radius_outlier, raw), 5),
        "ckdtree": loader_counts_on_host(torch, partial(
            host_ms, partial(io.remove_radius_outlier, raw), 5))}
    log(f"  remove_radius_outlier on the raw scan (host ms): "
        f"{report['outlier_removal_host_ms']}")

    with tempfile.TemporaryDirectory() as work:
        for i in range(RADIUS_LOADER_FILES):
            io.write_to_bin(lidar_like_scan(60 + i),
                            os.path.join(work, f"{i:03d}.bin"))

        def load():
            ds = LocalTestDataset(work, numpts=16384, knn_require=0, dim=3)
            out, ms, t0 = [], [], time.perf_counter()
            for item in ds:
                ms.append(1e3 * (time.perf_counter() - t0))
                out.append(item)
                t0 = time.perf_counter()
            return out, statistics.median(ms)

        load()  # warm
        before = trace.counters()["launches.radius_count"]
        card, card_ms = load()
        assert (trace.counters()["launches.radius_count"]
                == before + RADIUS_LOADER_FILES)
        host, host_ms_ = loader_counts_on_host(torch, load)
        for a, b in zip(card, host):
            assert a[1:] == b[1:] and np.array_equal(a[0], b[0]), a[1]
        report["load_ms_a_cloud"] = {"card": card_ms, "ckdtree": host_ms_}
        log(f"  LocalTestDataset N=16384, {RADIUS_LOADER_FILES} scans: the "
            f"same clouds, one launch a cloud; load ms a cloud (median) "
            f"{report['load_ms_a_cloud']}")

        torch.cuda.synchronize()
        busy = torch.cuda.Event()
        torch.cuda._sleep(4_000_000_000)
        busy.record()
        t0 = time.perf_counter()
        ds = LocalTestDataset(work, numpts=16384, knn_require=0, dim=3)
        items = list(ThreadedPrefetcher(iter(ds), depth=1))
        seconds = time.perf_counter() - t0
        still_busy = not busy.query()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        report["prefetch"] = {"loader_s": seconds,
                              "sleep_left_s": time.perf_counter() - t1,
                              "overlapped": still_busy}
        log(f"  the prefetch thread's loader beside a sleep kernel on the "
            f"default stream: {report['prefetch']}")
        assert len(items) == RADIUS_LOADER_FILES and still_busy, \
            report["prefetch"]
    return report


# Phase 19: kernel J at the main path's train-mode BatchNorm shapes (the
# card tests' BN_SHAPES): stage 2's nine widths over 163840 points and two
# over 20480, stage 3's head over 196608 points and its 24 descriptors
BATCHNORM_SHAPES = ((163840, 32), (163840, 64), (163840, 128), (163840, 256),
                    (163840, 1024), (20480, 128), (196608, 1024),
                    (196608, 64), (24, 256))
BATCHNORM_PASSES = {"forward": 3, "backward": 5}  # [rows, C] f32 passes


def batchnorm_phase(torch, T, kernels, device):
    """Phase 19: kernel J, train-mode BatchNorm + relu.  Returns its report.

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

    report = {"cases": []}
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
        errs = [((a - p).abs().max() / p.abs().max()).item()
                for a, p in zip(outs[0], outs[2])]
        assert errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4, (rows, C, errs)
        nbytes_pass = rows * C * 4
        with torch.no_grad():
            fwd_ms = device_ms(torch, partial(call, ours, False))
        row = {"rows": rows, "C": C,
               "plan": list(T.bn_plan(rows, C,
                                      kernels.sm_count(device.index or 0))),
               "fwd_ms": fwd_ms,
               "ms": device_ms(torch, partial(call, ours)),
               "fwd_bound_ms": BATCHNORM_PASSES["forward"] * nbytes_pass
               / MEMORY_BYTES_PER_S * 1e3,
               "bound_ms": sum(BATCHNORM_PASSES.values()) * nbytes_pass
               / MEMORY_BYTES_PER_S * 1e3,
               "plain_ms": device_ms(torch, partial(call, plain), reps=3),
               "library_ms": device_ms(torch, partial(call, library),
                                       reps=3),
               "rel_err_vs_plain": errs}
        log(f"  batch_norm [{rows}, {C}] plan {row['plan']}: J "
            f"{row['ms']:.3f} ms (forward {row['fwd_ms']:.3f}), bound "
            f"{row['bound_ms']:.3f} (forward {row['fwd_bound_ms']:.3f}), "
            f"plain {row['plain_ms']:.3f}, library {row['library_ms']:.3f};"
            f" relative gaps to plain {errs}")
        report["cases"].append(row)
        del x, dy, xg, outs
        torch.cuda.empty_cache()
    return report


def main(only_parallel=False, only_loader=False):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
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
    from dh3d_tpu_torch.entry import entry

    log("phase 2: build")
    path, build_s = kernels.build()
    kernels.library()
    log(f"  built {path} in {build_s:.1f} s")

    if only_parallel:
        log("phase 17: the parallel path")
        _, report = parallel_phase(torch, kernels, device)
        log(json.dumps({"parallel": report}))
        log(card_line())
        return
    if only_loader:
        log("phase 18: the loader's radius count (kernel I)")
        log(json.dumps({"radius": radius_phase(torch, T, kernels, device)}))
        log(card_line())
        return

    log("phase 3: kernels vs plain versions")
    cases = kernel_phase(torch, T, device)

    log("phase 4: main-path forward [20, 8192]")
    B, N = 20, 8192
    fn, (points,) = entry(device, batch=B)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # phase 3's tensors and plain versions
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    outs = fn(points)
    torch.cuda.synchronize()
    fwd_launches = kernels.counts()
    log(f"  launches in one forward: {fwd_launches}")
    for name in FORWARD_KERNELS:
        assert fwd_launches[name] > 0, \
            f"kernel {name} was not launched by the forward"
    for name in BATCHNORM_KERNELS:
        assert fwd_launches[name] == 0, (name, fwd_launches)
    check_outputs(torch, outs, points, B, N)
    fwd_ms = cuda_ms(torch, lambda: fn(points), warmup=2, reps=10)
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(points)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / iters
    log(f"  forward: {fwd_ms:.2f} ms median (CUDA events), "
        f"{B / (fwd_ms / 1e3):.1f} clouds/s; host clock {B / host_s:.1f} "
        f"clouds/s over {iters} forwards")
    try:
        fwd_split = profile_step(torch, lambda: fn(points))
    except Exception as e:  # the split is a report, not a check
        fwd_split = {"not measured": repr(e)}
    fwd_split.pop("E + F + inverse builds", None)
    log(f"  profile of one forward (device ms): {fwd_split}")
    log(json.dumps({"forward": {
        "shape": [B, N, 3], "ms": fwd_ms, "clouds_per_s": B / (fwd_ms / 1e3),
        "host_clouds_per_s": B / host_s, "peak_mem_gb":
            torch.cuda.max_memory_allocated() / 1e9,
        "profile_ms": fwd_split}}))
    del outs

    log("phase 5: card vs CPU forward [2, 8192]")
    fn_gpu, (p_gpu,) = entry(device, batch=2)
    fn_cpu, (p_cpu,) = entry("cpu", batch=2)
    t0 = time.perf_counter()
    o_cpu = fn_cpu(p_cpu)
    cpu_s = time.perf_counter() - t0
    o_gpu = {k: v.cpu() for k, v in fn_gpu(p_gpu).items()}
    for key in ("xyz", "knn_indices"):
        assert torch.equal(o_gpu[key], o_cpu[key]), key
    errs = {}
    for key in ("local_desc", "attention", "global_desc", "xyz_feat_att"):
        errs[key] = (o_gpu[key] - o_cpu[key]).abs().max().item()
        assert errs[key] <= CARD_VS_CPU_ATOL, (key, errs[key])
    feat_err = (o_gpu["feat"] - o_cpu["feat"]).abs().max().item()
    feat_scale = o_cpu["feat"].abs().max().item()
    assert feat_err <= CARD_VS_CPU_FEAT_REL * feat_scale, (feat_err,
                                                           feat_scale)
    log(f"  indices equal; max abs err {errs}; feat {feat_err:.3g} of "
        f"{feat_scale:.3g}; CPU forward {cpu_s:.1f} s")

    log("phase 6: train step, detection_config [20, 8192]")
    train_launches, train_report = train_phase(torch, kernels, device)

    log("phase 7: card vs CPU train step [2, 8192]")
    card_vs_cpu_train(torch, device)

    scratch = tempfile.TemporaryDirectory()  # phases 8 and 12
    log("phase 8: local extraction with NMS [1, 16384] and global [4, 8192]")
    extract = os.path.join(scratch.name, "extract")
    extract_launches, extract_report = extraction_phase(torch, kernels,
                                                        extract)

    log("phase 9: card vs CPU extraction [1, 16384]")
    extract_report["card_vs_cpu"] = card_vs_cpu_extraction(torch, T, device)

    log("phase 10: training from disk, stage 2 [20, 8192] and stage 3 "
        "[24, 8192]; a stage 1 -> 2 warm start")
    train_work = tempfile.TemporaryDirectory()  # its pool serves phase 15
    disk_launches, held, disk_report = disk_phase(
        torch, T, train_work.name, train_launches, device)

    log("phase 11: card vs CPU pair generation [2, 8192], 64 anchors")
    disk_report["card_vs_cpu_pairgen"] = card_vs_cpu_pairgen(torch, device,
                                                             held)

    log("phase 12: relocalisation [1, 4096]: 4 queries against 12 clouds; "
        "registration and repeatability CLIs")
    reloc = os.path.join(scratch.name, "reloc")
    reloc_launches, reloc_report, pair_files = reloc_phase(
        torch, kernels, reloc,
        os.path.join(extract, "nms", "scan0_nms_res.bin"))

    log("phase 13: card vs CPU matching, RANSAC and relocalisation")
    reloc_report["card_vs_cpu"] = card_vs_cpu_reloc(torch, device, reloc,
                                                    pair_files)
    scratch.cleanup()

    log("phase 14: the legacy Morton-band mode (morton_exact=False)")
    log(" (a) kernel H against its plain version")
    window_phase(torch, T, kernels, device, cases)
    log(" (b) legacy forward [20, 8192]")
    legacy_launches, legacy_report = legacy_forward_phase(
        torch, kernels, device, fwd_launches)
    log(" (c) card vs CPU legacy forward [2, 8192]")
    legacy_report["card_vs_cpu"] = card_vs_cpu_legacy(torch, device)
    log(" (d) legacy and remat train steps [20, 8192]")
    legacy_report["train"] = legacy_train_phase(torch, kernels, device,
                                                train_report)
    log(" (e) flex_avg and flex_deconv on the card")
    legacy_report["deconv_avg"] = deconv_avg_phase(torch, T, device)
    log(" (f) the error-budget CLI, demo weights, N=8192")
    with tempfile.TemporaryDirectory() as work:
        legacy_report["error_budget"] = budget_phase(work)

    log("phase 15: the entry points: bench, curriculum, exporter, "
        "--profile")
    t15 = time.perf_counter()
    log(" (a) the bench, seven workloads")
    bench_launches, bench_report = bench_phase(torch, kernels, device,
                                               fwd_launches, fwd_ms)
    with tempfile.TemporaryDirectory() as work:
        log(" (b) the curriculum, one step a stage, on phase 10's pool")
        curriculum_launches, curriculum_report, stages = curriculum_phase(
            torch, kernels, os.path.join(train_work.name, "pool"), work)
        log(" (c) the exporter")
        curriculum_report["export"] = export_phase(torch, device, work,
                                                   *stages)
        log(" (d) train --profile, 16 steps [20, 8192]")
        curriculum_report["profile"] = profile_phase(work)
    train_work.cleanup()
    entry_seconds = time.perf_counter() - t15
    log(f"  phase 15: {entry_seconds:.1f} s")

    log("phase 16: the bf16 compute_dtype")
    t16 = time.perf_counter()
    log(" (a) kernels C and E, bf16 cases, against their plain versions")
    bf16_kernel_phase(torch, T, device, cases)
    log(" (b) bf16 forward [20, 8192]")
    bf16_launches, bf16_report = bf16_forward_phase(torch, kernels, device,
                                                    fwd_launches)
    log(" (c) card vs CPU bf16 forward [2, 8192]")
    bf16_report["card_vs_cpu"] = card_vs_cpu_bf16(torch, device)
    log(" (d) bf16 train step, detection_config [20, 8192]")
    bf16_train_launches, bf16_report["train"] = train_phase(
        torch, kernels, device, {"compute_dtype": "bfloat16"},
        BF16_TRAIN_KERNELS)
    for f32_case, bf16_case in BF16_CASES.items():
        assert bf16_train_launches[f32_case] == 0, bf16_train_launches
        assert (bf16_train_launches[bf16_case]
                == train_launches[f32_case]), bf16_train_launches
    bf16_report["train"]["phase_6"] = {
        k: train_report[k] for k in ("step_ms", "parts_ms", "peak_mem_gb")}
    log(f"  phase 6's step: {train_report['step_ms']:.2f} ms, "
        f"{train_report['parts_ms']}, peak {train_report['peak_mem_gb']:.2f}"
        f" GB")
    log(" (e) bf16 against f32, demo weights")
    bf16_report["agreement"] = bf16_agreement(torch, device)
    log(" (f) train CLI in bf16, the exporter, extraction from the export")
    with tempfile.TemporaryDirectory() as work:
        bf16_cli_launches, bf16_report["cli"] = bf16_cli_phase(
            torch, kernels, work, device)
    bf16_seconds = time.perf_counter() - t16
    log(f"  phase 16: {bf16_seconds:.1f} s")

    log("phase 17: the parallel path: two ranks on cuda:0 through gloo, "
        "NCCL at world 1, the sharded kNN, the dry run")
    t17 = time.perf_counter()
    parallel_launches, parallel_report = parallel_phase(torch, kernels,
                                                        device)
    parallel_report["seconds"] = time.perf_counter() - t17
    log(f"  phase 17: {parallel_report['seconds']:.1f} s")

    log("phase 18: the loader's radius count (kernel I)")
    radius_report = radius_phase(torch, T, kernels, device)

    log("phase 19: train-mode BatchNorm + relu (kernel J)")
    batchnorm_report = batchnorm_phase(torch, T, kernels, device)

    # `launches`: the count from this slice's path (phase 17 (b): one rank
    # of the data-parallel detection step) for A-G, from the bf16 forward
    # and step for the bf16 cases, from the legacy forward for H
    kernel_rows = []
    for name, rows in cases.items():
        main_case = rows[0]
        replaces, also = REPLACES[name]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "also_replaces": also,
            "launches": (bf16_launches if name == "flex_moments_bf16"
                         else bf16_train_launches
                         if name == "flex_moments_backward_bf16"
                         else legacy_launches if name == "knn_window"
                         else parallel_launches["parallel_detection"]
                         )[name],
            "launches_by_path": {"forward": fwd_launches[name],
                                 "train_step": train_launches[name],
                                 "extract_local": extract_launches[name],
                                 "train_from_disk": disk_launches[name],
                                 "relocalize": reloc_launches[name],
                                 "legacy_forward": legacy_launches[name],
                                 "bench": bench_launches[name],
                                 "curriculum": curriculum_launches[name],
                                 "bf16_forward": bf16_launches[name],
                                 "bf16_train_step": bf16_train_launches[name],
                                 "bf16_train_cli": bf16_cli_launches[name],
                                 **{path: counts[name] for path, counts
                                    in parallel_launches.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "shape": main_case["shape"], "cases": rows})
    log(json.dumps({"train_step": train_report}))
    log(json.dumps({"extract_local": extract_report}))
    log(json.dumps({"train_from_disk": disk_report}))
    log(json.dumps({"relocalize": reloc_report}))
    log(json.dumps({"legacy": legacy_report}))
    log(json.dumps({"entry_points": {"seconds": entry_seconds,
                                     "bench": bench_report,
                                     "curriculum": curriculum_report}}))
    log(json.dumps({"bf16": {"seconds": bf16_seconds, **bf16_report}}))
    log(json.dumps({"parallel": parallel_report}))
    log(json.dumps({"radius": radius_report}))
    log(json.dumps({"batchnorm": batchnorm_report}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def ab_run(root, label, out_dir):
    """One tree's side of a comparison (see the module docstring)."""
    import hashlib

    out_dir = os.path.abspath(out_dir)
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)  # the train step reads models/demo_stage2.*
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dh3d_tpu_torch import kernels
    from dh3d_tpu_torch import ops as T
    from dh3d_tpu_torch.train import (make_train_step,
                                      synthetic_local_batches, to_device)

    assert kernels.__file__.startswith(os.getcwd()), kernels.__file__
    device = torch.device("cuda", 0)
    kernels.library()

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    report = {"label": label, "root": root, "card": card_line(), "cases": {}}
    for c in knn_fps_cases(torch, T, device):
        out = c["call"]()
        again = c["call"]()
        for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (out, again))):
            assert torch.equal(a, b), f"{c['label']}: two runs differ"
        outs = out if isinstance(out, tuple) else (out,)
        report["cases"][f"{c['name']} {c['label']}"] = r = {
            "input_sha256": sha(torch.cat([t.flatten() for t in c["inputs"]])),
            "sha256": "/".join(sha(t) for t in outs),
            "call_ms": device_ms(torch, c["call"]), "plan": c["plan"]}
        log(f"  {c['name']} {c['label']:42s} {r}")
    if hasattr(T, "knn_window"):  # kernel H, as the tree's path calls it
        for case, q, keys, k, w in window_cases(torch, T, device):
            call = partial(T.knn_window, q, keys, k, w)
            out = call()
            again = call()
            assert all(map(torch.equal, out, again)), f"{case}: runs differ"
            plan = (T.window_plan(k, w, q.shape[0] * q.shape[1])
                    if hasattr(T, "window_plan") else None)
            report["cases"][f"knn_window {case}"] = r = {
                "input_sha256": sha(torch.cat([q.flatten(),
                                               keys.flatten()])),
                "sha256": "/".join(sha(t) for t in out),
                "call_ms": device_ms(torch, call), "plan": plan}
            log(f"  knn_window {case:42s} {r}")
    for c in forward_cases(torch, T, device):
        out = c["call"]()
        for a, b in zip(out, c["call"]()):
            assert torch.equal(a, b) or c.get("nan"), \
                f"{c['label']}: two runs differ"
        key = f"{c['name']} {c['label']}"
        report["cases"][key] = r = {
            "input_sha256": sha(torch.cat([t.flatten().float()
                                           for t in c["inputs"]])),
            "sha256": "/".join(sha(t) for t in out),
            "nan": c.get("nan", False),
            "call_ms": device_ms(torch, c["call"])}
        if "weights" in c:  # the four ops of flex_weights, alone
            r["weights_build_ms"] = device_ms(torch, c["weights"])
        log(f"  {key:60s} {r}")
    on_weights = {}
    for c in backward_cases(torch, T, device):
        out = c["call"]()
        assert torch.equal(out, c["call"]()), f"{c['label']}: two runs differ"
        report["cases"][f"{c['name']} {c['label']}"] = r = {
            "nbh_sha256": sha(c["nbh"]), "sha256": sha(out),
            "call_ms": device_ms(torch, c["call"]),
            "build_ms": device_ms(torch, partial(T.inverse_neighbors,
                                                 c["nbh"], c["keys"]))}
        if c["name"] == "weighted_sum_backward":
            on_weights[c["label"]] = r["sha256"]
        elif c["name"] == "flex_moments_backward":
            assert r["sha256"] == on_weights[c["label"]], c["label"]
        log(f"  {c['name']} {c['label']:36s} {r}")

    # one full-width forward (phase 4's) and one batch-1 extraction forward
    # (phase 9's): output hashes, median of 10, device time by class
    from dh3d_tpu_torch.entry import entry
    from dh3d_tpu_torch.eval import make_forward
    from dh3d_tpu_torch.train import resolve_model

    fn, (points,) = entry(device, batch=20)
    report["forward"] = forward_report(torch, fn, points, sha, 20)
    del fn, points
    cfg, model = resolve_model("models/demo_stage2")
    cfg.num_points, cfg.sampled_kpnum, cfg.input_R = 16384, -1, False
    cloud = torch.from_numpy(eval_cloud(0, 16384)[None]).to(device)
    report["extract_forward"] = forward_report(
        torch, make_forward(cfg, model.to(device)), cloud, sha, 1)
    del cfg, model, cloud
    for key, name in (("forward", "forward [20, 8192]"),
                      ("extract_forward", "extraction forward [1, 16384]")):
        r = report[key]
        log(f"  {name}: {r['ms']:.3f} ms median of 10, "
            f"{r['clouds_per_s']:.1f} clouds/s; device {r['device_ms']:.3f} "
            f"ms, idle share {r['idle_share']:.3f}")

    cfg = stage2_config()
    state = stage2_state(cfg, device)
    batch = to_device(next(synthetic_local_batches(cfg, seed=0)), device)
    step_fn = make_train_step(cfg)
    for _ in range(2):
        step_fn(state, batch)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with InverseBuilds() as builds:
        step_fn(state, batch)
        torch.cuda.synchronize()
    launches = kernels.counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: step_fn(state, batch), warmup=0, reps=7)
    report["train_step"] = {
        "inverse_builds": len(builds.nbh),
        "distinct_neighbourhoods": builds.distinct(),
        "E_launches": launches["weighted_sum_backward"]
        + launches.get("flex_moments_backward", 0),
        "F_launches": launches["neighbor_max_backward"],
        "step_ms": step_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "profile_ms": profile_step(torch, lambda: step_fn(state, batch))}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"ab_{label}.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps(report["train_step"]))
    return 0


def forward_report(torch, fn, points, sha, clouds):
    """A forward's output hashes, its time (median of 10, CUDA events: what
    the host's launches leave the device waiting included), the
    profiler's device time of one call by kernel class and the share of
    the median the device is idle."""
    outs = fn(points)
    r = {"sha256": {k: sha(v) for k, v in sorted(outs.items())},
         "ms": cuda_ms(torch, lambda: fn(points), warmup=2, reps=10)}
    del outs
    r["clouds_per_s"] = clouds / (r["ms"] / 1e3)
    split = profile_step(torch, lambda: fn(points))
    split.pop("E + F + inverse builds", None)
    r["profile_ms"] = split
    r["device_ms"] = sum(split.values())
    r["idle_share"] = max(0.0, 1 - r["device_ms"] / r["ms"])
    return r


def sweep_run(out_dir):
    """Every plan kernels G and B take at each shape of `knn_fps_cases`
    (A and G's plans at A's shapes; output checked equal to the plain
    version), kernel H at each of `window_cases` and kernels C and D at
    each shape of `forward_cases` (equal to the path's), device time;
    written to OUT/sweep.json."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    from dh3d_tpu_torch import kernels
    from dh3d_tpu_torch import ops as T

    device = torch.device("cuda", 0)
    kernels.library()
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
    log(card_line())
    return 0


def ab_compare(paths):
    """0 if every case's output hash, and both forwards', is the same in
    every file."""
    runs = [json.load(open(p)) for p in paths]
    ok = True
    for key in dict.fromkeys(k for r in runs for k in r["cases"]):
        have = [r["label"] for r in runs if key in r["cases"]]
        if len(have) < len(runs):  # an op only some trees have
            log(f"  {key:60s} only in {have}  ms " + " / ".join(
                f"{r['cases'][key]['call_ms']:.4f}" for r in runs
                if key in r["cases"]))
            continue
        if runs[0]["cases"][key].get("nan"):  # the NaN rule may differ
            log(f"  {key:60s} not compared  ms " + " / ".join(
                f"{r['cases'][key]['call_ms']:.4f}" for r in runs))
            continue
        hashes = {(r["cases"][key].get("nbh_sha256"),
                   r["cases"][key].get("input_sha256"),
                   r["cases"][key]["sha256"]) for r in runs}
        ok &= len(hashes) == 1
        log(f"  {key:60s} {'equal' if len(hashes) == 1 else 'DIFFER'}"
            f"  ms " + " / ".join(f"{r['cases'][key]['call_ms']:.4f}"
                                  for r in runs)
            + ("; flex_weights alone " + " / ".join(
                f"{r['cases'][key]['weights_build_ms']:.4f}" for r in runs)
               if "weights_build_ms" in runs[0]["cases"][key] else ""))
    for fwd in ("forward", "extract_forward"):
        for out in runs[0][fwd]["sha256"]:
            same = len({r[fwd]["sha256"][out] for r in runs}) == 1
            ok &= same
            log(f"  {fwd} {out:44s} {'equal' if same else 'DIFFER'}")
        log(f"  {fwd} ms " + " / ".join(f"{r[fwd]['ms']:.3f}" for r in runs)
            + "; device ms " + " / ".join(f"{r[fwd]['device_ms']:.3f}"
                                          for r in runs)
            + "; idle share " + " / ".join(f"{r[fwd]['idle_share']:.3f}"
                                           for r in runs))
    log("  train step ms " + " / ".join(f"{r['train_step']['step_ms']:.3f}"
                                        for r in runs))
    log(json.dumps({"outputs_bit_identical": ok,
                    "runs": [r["label"] for r in runs]}))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 1:
        main()
    elif sys.argv[1:] == ["--parallel"]:
        main(only_parallel=True)
    elif sys.argv[1:] == ["--loader"]:
        main(only_loader=True)
    else:
        import argparse

        ap = argparse.ArgumentParser(
            description="compare two trees of the port (module docstring)")
        ap.add_argument("--ab-root")
        ap.add_argument("--label")
        ap.add_argument("--out", default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "chiprun_out"))
        ap.add_argument("--ab-compare", nargs="+")
        ap.add_argument("--sweep", action="store_true")
        args = ap.parse_args()
        if args.ab_compare:
            sys.exit(ab_compare(args.ab_compare))
        if args.sweep:
            sys.exit(sweep_run(args.out))
        if not (args.ab_root and args.label):
            ap.error("--ab-root and --label, or --ab-compare")
        sys.exit(ab_run(args.ab_root, args.label, args.out))
