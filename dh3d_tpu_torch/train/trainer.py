"""Training: the train step, curriculum freezing, the optimizer, and
checkpoints.

Counterpart of `dh3d_tpu/train/trainer.py:51-435`.  The reference trains
with Adam and a staircase exponential learning-rate decay, weight decay as
an L2 loss term over the Dense kernels only, and curriculum freezing of
whole module groups (`core/model.py:239-255`, `core/tf_utils.py:144-153`).
Semantics kept from the JAX trainer, which uses optax:
  - the schedule is read at the update count before the increment (step 0
    uses lr(0)); with warmup, the decay sees `step - warmup`
    (`optax.join_schedules`);
  - Adam (b1 0.9, b2 0.999, eps 1e-8) and the optional global-norm clip
    act on the trainable parameters only; frozen groups are outside the
    optimizer (`optax.multi_transform` with `set_to_zero`), so their Adam
    state does not advance and they are not in the clip norm.  Here they
    do not require grad at all;
  - a trainable parameter the loss does not reach gets a zero gradient and
    an Adam step (optax updates every leaf);
  - the clip is optax's: g unchanged when |g| < max, else g / |g| * max.
The step runs on whatever device the model lives on; on CUDA every
neighbourhood op and its backward is a hand-written kernel
(`ops/neighborhood.py`), and a step whose shapes repeat is captured once
and then replayed as CUDA graphs (`train/graphs.py`); other steps run
eagerly.  Before the forward it augments a batch on the
device (`augment_on_device`) and builds the self pairs of a {pc1, pc2}
batch (`device_pairgen`: FPS on kernel B, the 1-NN on kernel A), from
draws made by two generators the caller passes (`add_draws`,
`prepare_batch`).

Data parallel (`make_train_step(cfg, group)`, over a `parallel.Mesh`):
the counterpart of the JAX step jitted over a mesh, whose global view
makes it the one-device step on the whole batch.  Every rank gets the
whole batch, draws the whole batch's draws from the same generators,
keeps its own block of clouds (`parallel.shard_batch`; a local batch by
pairs), runs the forward on it with sync BatchNorm, all-gathers with
gradient the outputs the losses read back into the one-process order and
runs the losses on them unchanged.  Every rank so computes the whole loss,
and its backward, through the collectives' adjoints, the gradient of n
times it: the step zero-fills the unreached trainable gradients,
all-reduces the gradients and divides them by n, then clips and takes the
Adam step, the same on every rank.  Frozen groups get no gradient and no
collective.  Under NCCL the step's device work, collectives included, is
captured and replayed as CUDA graphs like the one-process step's; under
gloo it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import torch
from torch import nn

from dh3d_tpu_torch import config as cfglib
from dh3d_tpu_torch import trace
from dh3d_tpu_torch.config import dotdict
from dh3d_tpu_torch.data.augment import draw_augment, torch_augment
from dh3d_tpu_torch.data.pairgen import draw_local_pairs, local_pairs
from dh3d_tpu_torch.losses import compute_total_loss, loss_inputs
from dh3d_tpu_torch.nn.convert import (load_flax, load_npz,
                                       warm_start_state_dict)
from dh3d_tpu_torch.nn.layers import sync_batchnorm
from dh3d_tpu_torch.nn.model import DH3D, compute_dtype, frozen_groups
from dh3d_tpu_torch.ops.neighborhood import collect_inverses
from dh3d_tpu_torch.parallel.collectives import (all_gather, reduce_,
                                                 size)
from dh3d_tpu_torch.parallel.mesh import shard_batch
from dh3d_tpu_torch.train import graphs


def check_config(cfg) -> None:
    """Raise NotImplementedError for a config that asks for a part of the
    JAX trainer the port does not have: a compute_dtype other than
    float32 and bfloat16, and `bn_axis_name`.  The JAX trainer refuses the
    latter too (an unbound axis name, whether or not the step runs over a
    mesh): a named axis binds only inside a shard_map, and the global-view
    step already syncs BatchNorm over the whole batch, as the port's data-
    parallel step does (`make_train_step(cfg, group)`)."""
    if cfg.get("bn_axis_name"):
        raise NotImplementedError(
            f"bn_axis_name={cfg.get('bn_axis_name')!r}: a named axis binds "
            "only inside a shard_map, which neither trainer has (the JAX "
            "trainer raises an unbound axis name); the data-parallel step "
            "syncs BatchNorm over the whole batch without it")
    compute_dtype(cfg)  # float32 or bfloat16; parameters and Adam stay f32


def lr_schedule(cfg) -> Callable[[int], float]:
    """step -> learning rate: start_lr * decay_rate ** floor(step /
    decay_step) (`optax.exponential_decay(staircase=True)`), after an
    optional linear warmup from 0 over `warmup_steps`."""
    start, steps, rate = cfg.start_lr, cfg.decay_step, cfg.decay_rate
    warmup = int(cfg.get("warmup_steps") or 0)

    def lr(step: int) -> float:
        if step < warmup:
            return (0.0 - start) * (1.0 - step / warmup) + start
        return start * rate ** ((step - warmup) // steps)

    return lr


def param_labels(cfg, model: nn.Module) -> dict:
    """{parameter name: "frozen" | "trainable"} by top-level module group
    (`trainer.py:79-92`)."""
    frozen = frozen_groups(cfg)
    return {name: "frozen" if name.split(".")[0] in frozen else "trainable"
            for name, _ in model.named_parameters()}


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Adam:
    """Adam over the trainable parameters; the frozen ones stop requiring
    grad.  The learning rate is set before every step from `lr_schedule`
    (`set_lr`).  On CUDA parameters Adam is capturable, its learning rate
    a device tensor: a CUDA graph of the step reads it there, and eager
    steps do the same arithmetic."""
    labels = param_labels(cfg, model)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
    params = [p for p in model.parameters() if p.requires_grad]
    cuda = bool(params) and params[0].is_cuda
    lr = (torch.tensor(float(cfg.start_lr), device=params[0].device) if cuda
          else cfg.start_lr)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=cuda)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to `lr`: a device tensor filled in
    place (stream-ordered, as a captured update reads it), else the
    number."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def kernel_l2(model: nn.Module) -> torch.Tensor:
    """Sum of squares of the Dense kernels (every nn.Linear weight,
    frozen ones included), the reference's '.*/W' regulariser; flex and
    pointset thetas, NetVLAD matrices and BN parameters are excluded
    (`trainer.py:113-122`)."""
    total = 0.0
    for m in model.modules():
        if isinstance(m, nn.Linear):
            total = total + torch.sum(m.weight * m.weight)
    return total


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the
    number of updates taken, the step's CUDA graphs over these tensors
    (`graphs.StepGraph`; None until a step makes them), and the step
    function that last set the model's train mode and BatchNorm group
    (`ready`)."""

    model: DH3D
    optimizer: torch.optim.Adam
    step: int = 0
    graph: graphs.StepGraph | None = dataclasses.field(
        default=None, repr=False, compare=False)
    ready: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises RuntimeError when it is a CUDA
    device and there is none.  The port's entry points default to the
    card and run on the CPU only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}, but torch.cuda.is_available()"
                           " is False (ask for the CPU: --device cpu or "
                           "device='cpu')")
    return device


def init_state(cfg, seed: int = 0, device="cuda") -> TrainState:
    """A fresh model (Flax initialisers, drawn from `seed`) on `device`
    and its optimizer.  `device` defaults to the card and raises when
    there is none (`require_device`)."""
    check_config(cfg)
    device = require_device(device)
    torch.manual_seed(seed)
    model = DH3D(cfg).to(device)
    return TrainState(model, make_optimizer(cfg, model))


def to_device(batch: dict, device) -> dict:
    """A numpy batch (`train.synthetic`, `train.data`) as tensors on
    `device`: points, pc1, pc2 and R f32, sample_inds int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.long() if k == "sample_inds" else t.float()
        out[k] = t.to(device).contiguous()
    return out


def add_draws(batch: dict, cfg, pairgen: torch.Generator | None = None,
              augment: torch.Generator | None = None) -> dict:
    """The batch with the draws its preparation on the device needs, from
    generators on the batch's device (`trainer.py:147-191` splits its
    `pairgen_key` and `aug_key` likewise):
      - a {pc1, pc2} batch: `pairgen_draws` (`data.pairgen.draw_local_pairs`)
        from `pairgen`, which it then needs;
      - with `cfg.augment_on_device` and an `augment` generator,
        `aug_draws` (`data.augment.draw_augment` of `cfg.data_aug`) for
        every cloud of a {pc1, pc2} batch (both copies) or of a global
        `points` batch.  A host-paired local batch gets none: its
        correspondences were built from clouds already augmented
        (`train.py:205-212`).
    Draws the batch already holds are kept (a test hands in JAX's)."""
    out = dict(batch)
    local = "pc1" in batch
    if local and "pairgen_draws" not in out:
        if pairgen is None:
            raise ValueError("a {pc1, pc2} batch needs a pair-generation "
                             "generator (or its pairgen_draws)")
        B, N, _ = batch["pc1"].shape
        rot_maxv = cfg.rot_maxv if cfg.rot_maxv is not None else math.pi
        out["pairgen_draws"] = draw_local_pairs(B, N, rot_maxv, pairgen)
    if (cfg.augment_on_device and augment is not None
            and "aug_draws" not in out
            and (local or not cfg.training_local)):
        pts = batch["pc1"] if local else batch["points"]
        shape = (2 * pts.shape[0], *pts.shape[1:]) if local else pts.shape
        out["aug_draws"] = draw_augment(tuple(cfg.data_aug), shape, augment)
    return out


def prepare_batch(batch: dict, cfg) -> dict:
    """Apply a batch's draws (`add_draws`): augment the clouds, then, for a
    {pc1, pc2} batch, build the self pairs on the device
    (`trainer.py:147-191`).  Returns the model's batch: points,
    sample_inds and R for local training, points for global."""
    out = dict(batch)
    aug = out.pop("aug_draws", None)
    if "pc1" in out:
        pc1, pc2 = out.pop("pc1"), out.pop("pc2")
        if aug is not None:  # each copy its own draws, before the pairs
            both = torch_augment(torch.cat([pc1, pc2]), aug)
            pc1, pc2 = both[:pc1.shape[0]], both[pc1.shape[0]:]
        angles, subsets = out.pop("pairgen_draws")
        out.update(local_pairs(pc1, pc2, cfg.sampled_kpnum, angles, subsets))
    elif aug is not None:
        out["points"] = torch_augment(out["points"], aug)
    return out


def gather_outputs(outs: dict, cfg, group) -> dict:
    """The outputs the losses read (`loss_inputs`, and R), all-gathered
    over `group` with gradient into the one-process order: a local batch's
    rank blocks [its pc1; its pc2] back into [pc1 of all; pc2 of all], R
    and a global batch's clouds in rank order."""
    n = size(group)
    out = {}
    for key in loss_inputs(cfg) + (("R",) if "R" in outs else ()):
        x = all_gather(outs[key], group)
        if cfg.training_local and key != "R":
            x = x.reshape(n, 2, -1, *x.shape[1:]).transpose(0, 1)
            x = x.reshape(-1, *x.shape[3:])
        out[key] = x
    return out


def forward_loss(model: DH3D, cfg, batch: dict, group=None):
    """The forward and the losses of one batch in the model's current mode
    (`trainer.py:147-211`).  With a `group`, `batch` is this rank's block
    and the losses run on the whole batch's outputs (`gather_outputs`).
    Returns (total loss, metrics, outs); outs are this rank's."""
    points = batch["points"]
    with trace.span("step.forward", points):
        outs = model(points, sample_inds=batch.get("sample_inds"))
    if "R" in batch:
        outs["R"] = batch["R"]
    with trace.span("step.loss", points):
        whole = outs if group is None else gather_outputs(outs, cfg, group)
        total, metrics = compute_total_loss(whole, cfg, kernel_l2(model))
    return total, metrics, outs


def reduce_gradients(params: list, group) -> None:
    """Every parameter's gradient summed over `group` and divided by its
    size, in place: the mean over the ranks (one all-reduce)."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    reduce_(flat, group).div_(size(group))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def apply_gradients(state: TrainState, cfg, group=None) -> None:
    """Reduce the gradients over `group` (`reduce_gradients`), clip
    (optax form), set the learning rate for this update count, take one
    Adam step, count it."""
    set_lr(state.optimizer, lr_schedule(cfg)(state.step))
    _update(state.optimizer, cfg, group)
    state.step += 1


def _update(optimizer: torch.optim.Adam, cfg, group=None) -> None:
    """`apply_gradients` at the learning rate the optimizer holds: device
    work alone, which a CUDA graph can hold."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:  # unreached: a zero gradient, as optax sees it
            p.grad = torch.zeros_like(p)
    if group is not None:
        reduce_gradients(params, group)
    max_norm = cfg.get("grad_clip_norm")
    if max_norm:
        max_norm = float(max_norm)
        norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
        for p in params:
            p.grad.copy_(torch.where(norm < max_norm, p.grad,
                                     p.grad / norm * max_norm))
    optimizer.step()


def shard_step_batch(batch: dict, cfg, group) -> dict:
    """This rank's block of a whole batch with its draws (`add_draws`): a
    local batch by pairs, a global one by clouds (`parallel.shard_batch`).
    Raises ValueError unless the pairs (local) or the clouds (global)
    divide over the group."""
    n = size(group)
    if "pc1" in batch:
        count = batch["pc1"].shape[0]
    elif cfg.training_local:
        count = batch["R"].shape[0]
    else:
        count = batch["points"].shape[0]
    if count % n:
        what = "pairs" if cfg.training_local else "clouds"
        raise ValueError(f"{count} {what} do not divide over {n} ranks: "
                         f"choose batch_size (times the tuple size) "
                         f"divisible by {n}")
    return shard_batch(batch, group,
                       pairs=count if cfg.training_local else None)


def _learn(state: TrainState, cfg, batch: dict, group, update,
           built=()) -> tuple:
    """The forward and the losses of a prepared batch, its backward and
    `update()`, under the step's spans.  The backward first builds the
    CSR inverses of the holders at the positions `built` among those the
    forward makes (`collect_inverses`): a captured step builds there the
    ones an eager backward builds as it goes.  Returns (metrics, the
    holders made)."""
    where = batch["points"]
    with collect_inverses() as made:
        total, metrics, _ = forward_loss(state.model, cfg, batch, group)
    with trace.span("step.backward", where):
        for i in built:
            made[i].get()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    with trace.span("step.optimizer", where):
        update()
    return metrics, made


def make_train_step(cfg, group=None):
    """train_step(state, batch, pairgen=None, augment=None) -> metrics: the
    batch's preparation on the device (`add_draws` from the two generators,
    `prepare_batch`), one forward in train mode, the losses, the backward
    and one optimizer update, in place on `state`.  The metrics are
    detached scalar tensors (reading them syncs).  Spans (`trace`): `step`,
    and in it `step.prepare`, `step.forward` (the model's spans inside:
    `model.forward`, `model.morton`, `model.backbone`, `model.global`;
    `DH3D.forward`), `step.loss`, `step.backward` (`csr_inverse` where it
    builds a CSR inverse: on autograd's thread, or before the replayed
    backward) and `step.optimizer`.

    The draws are made eagerly.  Then, where `graphs.eager_reason` finds
    nothing against it, the step replays its CUDA graphs on `state`
    (`state.graph`): one signature of batch a step function, the state's
    first such step run eagerly, its second captured (`graphs`).
    Counters (`trace.count`): `train.eager_steps`, `train.graph_captures`
    and `train.graph_replays`.  The step puts the model in train mode and
    sets its BatchNorms' group when a state first meets it (`state.ready`)
    and again after the model was put in eval mode, not every step.

    With `group` (a `parallel.Mesh` or a process group) the step is data
    parallel (module docstring): every rank passes the whole batch and
    generators seeded alike; metrics, parameters, BN statistics and Adam
    state come out the same on every rank.  Under NCCL the step is
    graphed as above, its collectives in the graphs; the rank's block
    (`shard_step_batch`) is taken eagerly, like the draws."""
    check_config(cfg)
    cfg = dotdict(dict(cfg))
    first = None  # the signature of the batches this step function graphs

    def ready(state: TrainState):
        if state.ready is not train_step or not state.model.training:
            state.model.train()
            sync_batchnorm(state.model, group)
            state.ready = train_step

    def capture(graph: graphs.StepGraph, state: TrainState, batch: dict):
        def body(prepared):
            metrics, made = _learn(
                state, cfg, prepared, group,
                lambda: _update(state.optimizer, cfg, group), graph.built)
            if len(made) != graph.holders:
                raise RuntimeError(
                    f"the captured step made {len(made)} inverse holders, "
                    f"its eager warm-up {graph.holders}")
            return metrics

        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        graph.capture(batch, lambda b: prepare_batch(b, cfg), body, params)

    def train_step(state: TrainState, batch: dict,
                   pairgen: torch.Generator | None = None,
                   augment: torch.Generator | None = None) -> dict:
        nonlocal first
        where = batch["pc1"] if "pc1" in batch else batch["points"]
        ready(state)
        with trace.span("step", where):
            with trace.span("step.prepare", where):
                batch = add_draws(batch, cfg, pairgen, augment)
                sig = graphs.signature(batch)
                why = graphs.eager_reason(state, cfg, group, batch, sig,
                                          first)
                # a state's first step of the signature (hooks or not) runs
                # eagerly and warms its graphs up; the next one captures
                graph, warm = None, False
                if why in (None, graphs.HOOKS):
                    first = first or sig
                    mine = state.graph
                    if mine is None or mine.owner is not train_step \
                            or mine.built is None:
                        state.graph = graphs.StepGraph(train_step)
                        warm = True
                    elif why is None:
                        graph = mine
                if group is not None:
                    batch = shard_step_batch(batch, cfg, group)
                if graph is None:
                    trace.count("train.eager_steps")
                    batch = prepare_batch(batch, cfg)
                else:
                    if graph.body is None:
                        capture(graph, state, batch)
                        trace.count("train.graph_captures")
                    else:
                        trace.count("train.graph_replays")
                    graph.replay_prepare(batch)
            if graph is not None:
                set_lr(state.optimizer, lr_schedule(cfg)(state.step))
                metrics = graph.replay_body()
                state.step += 1
                return metrics
            metrics, made = _learn(
                state, cfg, batch, group,
                lambda: apply_gradients(state, cfg, group))
            if warm:
                state.graph.holders = len(made)
                state.graph.built = [i for i, h in enumerate(made)
                                     if h.built]
            return {k: torch.as_tensor(v).detach()
                    for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg, model: DH3D):
    """eval_step(batch) -> outs: the forward of `batch["points"]` with the
    batch's optional `sample_inds`, in eval mode, without gradients
    (`trainer.py:265-278`).  The JAX step takes the variables as an
    argument; this one runs `model`, on whatever device it lives."""

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.no_grad():
            return model(batch["points"],
                         sample_inds=batch.get("sample_inds"))

    return eval_step


# ------------------------------ checkpoints ------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: int | None = None) -> str:
    """Model (parameters and BN statistics), optimizer state and step, for
    exact resume, as `<ckpt_dir>/step_<step>.pt`."""
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, state: TrainState) -> TrainState:
    """Load a `save_checkpoint` file into `state` (same config), in place:
    parameters, BN statistics, optimizer state and step."""
    device = next(state.model.parameters()).device
    ck = torch.load(path, map_location=device, weights_only=True)
    state.graph = None  # its graphs read the tensors replaced below
    state.model.load_state_dict(ck["model"])
    kept = [(g["lr"], g.get("capturable", False))
            for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(ck["optimizer"])
    for g, (lr, capturable) in zip(state.optimizer.param_groups, kept):
        # this device's choice (`make_optimizer`), not the checkpoint's
        g["capturable"] = capturable
        g["lr"] = lr
        if capturable:
            for p in g["params"]:
                st = state.optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(p.device, torch.float32)
    state.step = int(ck["step"])
    return state


def resolve_model(path: str):
    """A trained model from either surface: a training logdir of this port
    (config.json + ckpt/step_*.pt) or a packaged Flax `<stem>.npz` with its
    `<stem>.config.json` (`trainer.py:339-363`).  Returns (cfg, DH3D on the
    CPU, in eval mode)."""
    if path.endswith(".npz") or os.path.isfile(path + ".npz"):
        stem = path[:-4] if path.endswith(".npz") else path
        cfg = cfglib.load_config(stem + ".config.json")
        model = DH3D(cfg)
        load_flax(model, load_npz(stem + ".npz"))
    else:
        cfg = cfglib.load_config(os.path.join(path, "config.json"))
        model = DH3D(cfg)
        model.load_state_dict(warm_start_state_dict(path))
    return cfg, model.eval()

