"""Optical-flow (RAFTGMA) training (JAX ``training/flow.py``; ref:
GMA/train.py:41-75,141,166-171):

  * the gamma-decayed L1 sequence loss over the prediction stack, ground
    truth above ``max_flow`` excluded, and the EPE, 1px, 3px and 5px
    metrics (GMA/train.py:41-65);
  * the learning-rate schedules ``onecycle`` (torch ``OneCycleLR``'s
    linear shape, GMA/train.py:68-75) and ``warmcos`` (optax's
    ``warmup_cosine_decay_schedule``, the JAX trainer's default);
  * a global-norm gradient clip as optax's ``clip_by_global_norm`` takes
    it (g / norm * clip when norm >= clip, no epsilon), then AdamW
    (eps 1e-8, weight decay on every parameter, as ``optax.adamw``);
  * one train step: the flow net in train mode, the loss, its backward
    (through K1's and K2's backward passes on the GPU), the clip and the
    optimiser step, batch statistics moving in the forward; the whole
    step with TF32 off, so that a float32 step computes its weight
    gradients in float32;
  * checkpoints of the whole training state (weights, batch statistics,
    optimiser, schedule, step) under ``step_NNNNNNNN`` directories, from
    which a run resumes exactly (the reference saves weights only).

Data parallel (``mesh=``, JAX ``make_train_step(mesh=...)``): each "data"
rank takes its slice of the batch. The loss divides by the valid pixels
of the whole batch, so each rank's loss is its share of the global loss
and the gradients are *summed* over the ranks; the metrics are global
sums too, batch norm (the context encoder's) sees the whole batch, and
the clip reads the reduced gradient. The step equals the single-process
step on the whole batch.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from atdn_vslam_torch.models.blocks import global_batch
from atdn_vslam_torch.models.factory import init_params
from atdn_vslam_torch.models.flow.network import RAFTGMA
from atdn_vslam_torch.parallel.distributed import all_reduce
from atdn_vslam_torch.utils.helpers import full_float32

MAX_FLOW = 400.0

#: the file of a checkpoint inside its ``step_NNNNNNNN`` directory
STATE_FILE = "train_state.pt"


@dataclasses.dataclass
class FlowTrainState:
    """The flow net in training with its optimiser, its learning-rate
    schedule, the clip norm and the number of steps taken."""

    model: RAFTGMA
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip: float = 1.0
    step: int = 0


def sequence_loss(
    preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
    group=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """gamma-decayed L1 over the prediction stack (ref: GMA/train.py:41-65).

    :param preds: (iters, B, H, W, 2) upsampled predictions.
    :param flow_gt: (B, H, W, 2); valid: (B, H, W) in {0, 1}.
    :param group: the inputs are this rank's slice of a batch split over
        the group's ranks: the loss is this slice's share of the whole
        batch's (their sum over the ranks), the metrics the whole batch's.
    :return: the loss and the last prediction's EPE, 1px, 3px and 5px
        over the valid pixels, as device scalars (the metrics detached).
    """
    n = preds.shape[0]
    mag = torch.linalg.vector_norm(flow_gt, dim=-1)
    vw = ((valid >= 0.5) & (mag < max_flow)).float()
    epe_map = torch.linalg.vector_norm(preds[-1].detach() - flow_gt, dim=-1)
    sums = torch.stack([
        vw.sum(), (epe_map * vw).sum(), ((epe_map < 1) * vw).sum(), ((epe_map < 3) * vw).sum(),
        ((epe_map < 5) * vw).sum(),
    ])
    (sums,) = all_reduce([sums], group)
    denom = sums[0] + 1e-8
    weights = gamma ** torch.arange(n - 1, -1, -1, device=preds.device, dtype=torch.float32)
    abs_err = (preds - flow_gt[None]).abs()
    per_iter = (abs_err.sum(dim=-1) * vw[None]).sum(dim=(1, 2, 3)) / denom
    loss = (weights * per_iter).sum()
    metrics = {name: sums[i] / denom for i, name in enumerate(("epe", "1px", "3px", "5px"), 1)}
    return loss, metrics


def onecycle_schedule(lr: float, steps_total: int, pct_start: float = 0.05):
    """torch ``OneCycleLR``'s piecewise-linear shape (anneal_strategy
    'linear', div_factor 25, final_div_factor 1e4, the reference's
    arguments, GMA/train.py:68-75): step -> learning rate."""
    initial = lr / 25.0
    min_lr = initial / 1e4
    m1 = max(pct_start * steps_total - 1.0, 1.0)
    m2 = max(float(steps_total - 1), m1 + 1.0)

    def sched(step: int) -> float:
        s = float(step)
        if s <= m1:
            value = initial + (s / m1) * (lr - initial)
        else:
            value = lr + ((s - m1) / (m2 - m1)) * (min_lr - lr)
        return min(max(value, min_lr), lr)

    return sched


def warmcos_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
):
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from step 0), constant
    after: step -> learning rate."""
    cos_steps = decay_steps - warmup_steps

    def sched(step: int) -> float:
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        t = min(max(step - warmup_steps, 0), cos_steps) / cos_steps
        return end_value + (peak_value - end_value) * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


def make_schedule(
    lr: float = 1.25e-4, steps_total: int = 100_000, pct_start: float = 0.05, schedule: str = "warmcos"
):
    """The JAX trainer's schedules (``make_optimizer``): ``onecycle``, or
    ``warmcos``, warm-up from lr/25 over ``pct_start`` of the run, then a
    cosine to lr/1e4."""
    if schedule == "onecycle":
        return onecycle_schedule(lr, steps_total, pct_start)
    if schedule == "warmcos":
        warmup = max(1, int(pct_start * steps_total))
        return warmcos_schedule(lr / 25.0, lr, warmup, max(steps_total, warmup + 1), lr / 1e4)
    raise ValueError(f"unknown schedule {schedule!r}")


def make_optimizer(
    model: torch.nn.Module,
    lr: float = 1.25e-4,
    steps_total: int = 100_000,
    wd: float = 1e-5,
    pct_start: float = 0.05,
    schedule: str = "warmcos",
):
    """(AdamW on every parameter, its schedule): the step ``t`` update
    uses the schedule's value at ``t``, as optax counts; call
    ``scheduler.step()`` after each optimiser step. The clip is
    :func:`clip_by_global_norm`, applied by :func:`train_step`."""
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd
    )
    sched = make_schedule(lr, steps_total, pct_start, schedule)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda t: sched(t) / lr)
    return optimizer, scheduler


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, a device scalar."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place and on the device: each
    gradient becomes (g / norm) * max_norm when norm >= max_norm and
    stays as it is otherwise (torch's ``clip_grad_norm_`` adds 1e-6 to
    the norm). Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def init_state(
    model: RAFTGMA,
    lr: float = 1.25e-4,
    steps_total: int = 100_000,
    wd: float = 1e-5,
    clip: float = 1.0,
    schedule: str = "warmcos",
    seed: int | None = 0,
) -> FlowTrainState:
    """Seeded initial weights (``init_params``; ``seed=None`` keeps the
    model's) and a fresh optimiser and schedule."""
    if seed is not None:
        init_params(model, seed)
    optimizer, scheduler = make_optimizer(model, lr, steps_total, wd, schedule=schedule)
    return FlowTrainState(model, optimizer, scheduler, clip)


def train_step(
    state: FlowTrainState,
    im1: torch.Tensor,
    im2: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    mesh=None,
) -> tuple[FlowTrainState, dict[str, torch.Tensor]]:
    """One optimiser step on a batch: images (B, H, W, 3) in [0, 255],
    ``flow_gt`` (B, H, W, 2), ``valid`` (B, H, W). Returns the state
    (updated in place) and the metrics ``loss``, ``epe``, ``1px``,
    ``3px``, ``5px`` and ``grad_norm`` (before the clip) as device
    scalars; the clipped gradients stay in ``.grad`` until the next step.

    :param mesh: the inputs are this rank's slice of the global batch;
        loss, metrics, gradients and batch statistics are the global
        batch's.
    """
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    group = None if mesh is None else mesh.data_group
    with full_float32():  # the backward too: autograd runs after forward() returns
        with global_batch(group):
            preds = model(im1, im2, test_mode=False)
        loss, metrics = sequence_loss(preds.float(), flow_gt, valid, gamma, group=group)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        if group is not None:  # each rank's loss is its share: the sums are the global batch's
            *summed, loss = all_reduce([p.grad for p in params] + [loss.detach()[None]], group)
            for p, g in zip(params, summed):
                p.grad = g
            loss = loss[0]
        grads = [p.grad for p in params]
        grad_norm = clip_by_global_norm(grads, state.clip)
        state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, {"loss": loss.detach(), **metrics, "grad_norm": grad_norm}


# ----------------------------------------------------------------------
# Checkpoints: the whole training state, one directory per step
# ----------------------------------------------------------------------


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def save_checkpoint(path: str, state: FlowTrainState) -> str:
    """Write the state to ``path/train_state.pt`` atomically (a ``.tmp``
    file, then ``os.replace``); returns the path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save(
        {
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "clip": state.clip,
            "step": state.step,
        },
        target + ".tmp",
    )
    os.replace(target + ".tmp", target)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The newest complete ``step_NNNNNNNN`` checkpoint under
    ``directory`` (None if there is none or no such directory)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        name for name in os.listdir(directory)
        if name.startswith("step_") and os.path.isfile(os.path.join(directory, name, STATE_FILE))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def load_checkpoint(path: str, state: FlowTrainState) -> FlowTrainState:
    """Restore a checkpoint of :func:`save_checkpoint` into ``state`` (in
    place; returned): a run continues from it exactly."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.clip = float(ckpt["clip"])
    state.step = int(ckpt["step"])
    return state
