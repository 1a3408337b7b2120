"""ATDNVO odometry training (JAX ``training/odometry.py``; ref:
train_odometry.py:21-150).

  * one train step is one batched call of the model over flow windows
    (B, T, H, W, 2), the LSTM carry reset to zero for every window (the
    reference's ``reset_lstm()`` per batch, train_odometry.py:48), batch
    statistics moving in train mode, the CLVO loss, float32 with TF32
    off;
  * AdamW with a per-step cosine from ``lr`` to ``eta_min``
    (train_odometry.py:99-105), weight decay on every parameter, as
    ``optax.adamw``;
  * checkpoints hold the whole training state (model, optimiser,
    schedule, step, stage) in one torch file per stage, written
    atomically (the reference saves weights only,
    train_odometry.py:140);
  * the stage curriculum: stage N > 1 starts from stage N - 1's weights
    and batch statistics with a fresh optimiser
    (train_odometry.py:94-97).

Random draws come from explicit generators: the seeded initial weights
(``models.factory.init_params``) and the dropout masks (a
``torch.Generator`` on the model's device, both seeded from
``TrainConfig.seed``).

Data parallel (``mesh=``, JAX ``make_train_step(mesh=...)``): each rank of
the "data" axis takes its slice of the global batch
(``parallel.shard_batch``); batch norm and dropout see the global batch
(``models.blocks.global_batch``) and the gradients are averaged over the
ranks before ``grad_norm`` and the step, so the step equals the
single-process step on the global batch and the weights stay the same
on every rank. No ``DistributedDataParallel``: its ``module.`` prefix
would rename the ``state_dict`` keys.

Tensor parallel (``init_state(..., mesh=, sharding=)``, JAX
``make_train_step(state_sharding=...)``): the parameters that
``parallel.mesh.model_parallel_sharding`` picks split over the mesh's
"model" ranks (``parallel.tensor_parallel.shard_model``), and AdamW's
moments of a split parameter hold the rank's rows only. The step
averages the gradients over "data" as before, and the replicated ones
also over "model"; ``grad_norm`` sums the split gradients' squares over
"model". Checkpoints hold the whole state,
gathered, and load onto split or unsplit ranks alike.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable, Iterable

import numpy as np
import torch

from atdn_vslam_torch.config import Config, LossConfig, TrainConfig
from atdn_vslam_torch.models.blocks import Dropout, global_batch
from atdn_vslam_torch.models.factory import init_params
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.parallel import tensor_parallel
from atdn_vslam_torch.parallel.distributed import all_reduce
from atdn_vslam_torch.parallel.mesh import shard_batch
from atdn_vslam_torch.training.losses import clvo_loss
from atdn_vslam_torch.training.mapping import cosine_lr
from atdn_vslam_torch.utils.helpers import full_float32


@dataclasses.dataclass
class OdometryTrainState:
    """The model in training with its optimiser, its learning-rate
    schedule and the number of steps taken."""

    model: ATDNVO
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def make_optimizer(model: torch.nn.Module, train_cfg: TrainConfig, steps_total: int):
    """(AdamW on every parameter, its per-step cosine schedule to
    ``eta_min``): call ``scheduler.step()`` after each optimiser step."""
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=train_cfg.lr, betas=(0.9, 0.999), eps=train_cfg.epsilon,
        weight_decay=train_cfg.wd,
    )
    lr = cosine_lr(train_cfg, steps_total)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda t: lr(t) / train_cfg.lr)
    return optimizer, scheduler


def init_state(
    model: ATDNVO, train_cfg: TrainConfig, steps_total: int, seed: int | None = None, mesh=None, sharding=None
) -> OdometryTrainState:
    """Seeded initial weights, a dropout generator on the model's device
    and a fresh optimiser.

    :param sharding: with ``mesh``, the split of
        ``parallel.mesh.model_parallel_sharding(mesh, model)``: the whole
        seeded model is cut to this rank's rows before the optimiser is
        built over it (JAX ``state_sharding``).
    """
    seed = train_cfg.seed if seed is None else seed
    init_params(model, seed)
    if sharding is not None:
        tensor_parallel.shard_model(model, mesh, sharding)
    device = next(model.parameters()).device
    generator = torch.Generator(device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    optimizer, scheduler = make_optimizer(model, train_cfg, steps_total)
    return OdometryTrainState(model, optimizer, scheduler)


def train_step(
    state: OdometryTrainState,
    flows: torch.Tensor,
    true_rot: torch.Tensor,
    true_tr: torch.Tensor,
    loss_cfg: LossConfig,
    mesh=None,
) -> dict[str, torch.Tensor | int]:
    """One optimiser step on flow windows (B, T, H, W, 2) and their
    (B, T, 3) targets. Returns ``loss`` and ``grad_norm`` (the global
    norm of the gradients, before the step) as device scalars and
    ``step``, the step's index; the gradients stay in the parameters'
    ``.grad`` until the next step.

    :param mesh: the inputs are this rank's slice of the global batch;
        loss, gradients and batch statistics are the global batch's.
    """
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    group = None if mesh is None else mesh.data_group
    with full_float32(), global_batch(group):
        (rot, tr), _ = model(flows, model.init_carry(flows.shape[0]))
        loss = clvo_loss(
            rot, tr, true_rot, true_tr, alpha=loss_cfg.alpha, w=loss_cfg.w,
            delta=loss_cfg.delta, khi=loss_cfg.khi,
        )
        loss.backward()
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    if group is not None:  # the mean of the slices' means: the global batch's loss and gradients
        *reduced, loss = all_reduce([p.grad for _, p in named] + [loss.detach()[None]], group, mean=True)
        for (_, p), g in zip(named, reduced):
            p.grad = g
        loss = loss[0]
    split = tensor_parallel.model_splits(model)
    if split:
        if mesh is None:
            raise ValueError('a model split over "model" needs its mesh')
        # Each model rank computes the replicated gradients itself, and on
        # the card cuDNN may round them otherwise on each (its algorithms
        # and atomics): their mean keeps the replicated parameters equal.
        whole = [p for n, p in named if n not in split]
        for p, g in zip(whole, all_reduce([p.grad for p in whole], mesh.model_group, mean=True)):
            p.grad = g
    grad_norm = _grad_norm(named, split, mesh)
    state.optimizer.step()
    state.scheduler.step()
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}
    state.step += 1
    return metrics


def _grad_norm(named, split, mesh) -> torch.Tensor:
    """The global norm of the whole gradients: a split gradient's squares
    summed over the model ranks, a replicated one's counted once."""
    if not split:
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for _, p in named]))

    def squares(is_split: bool) -> torch.Tensor:
        return torch.stack([p.grad.square().sum() for n, p in named if (n in split) == is_split]).sum()

    (split_squares,) = all_reduce([squares(True)[None]], mesh.model_group)
    return torch.sqrt(squares(False) + split_squares[0])


def train_epoch(
    state: OdometryTrainState,
    batches: Iterable[tuple[np.ndarray, np.ndarray, np.ndarray]],
    loss_cfg: LossConfig,
    log_every: int = 50,
    log_fn: Callable[[int, dict], None] | None = None,
    mesh=None,
) -> list[float]:
    """One epoch over host batches (flows, rot, tr), each moved to the
    model's device (with ``mesh``, this rank's slice of each); returns the
    losses."""
    device = next(state.model.parameters()).device
    losses = []
    for i, batch in enumerate(batches):
        if mesh is not None:
            batch = shard_batch(mesh, tuple(batch))
        flows, rot, tr = (torch.from_numpy(np.asarray(x, np.float32)).to(device) for x in batch)
        metrics = train_step(state, flows, rot, tr, loss_cfg, mesh)
        losses.append(float(metrics["loss"]))
        if log_fn is not None and i % log_every == 0:
            log_fn(i, metrics)
    return losses


# ----------------------------------------------------------------------
# Checkpoints: the whole training state in one torch file per stage
# ----------------------------------------------------------------------


def checkpoint_path(config: Config, stage: int) -> str:
    return os.path.join(os.path.abspath(config.checkpoint_dir), f"odometry_stage{stage}.pt")


def save_checkpoint(config: Config, stage: int, state: OdometryTrainState) -> str:
    """Write model, optimiser, schedule, step and stage to
    :func:`checkpoint_path` atomically (a ``.tmp`` file, then
    ``os.replace``); returns the path. A model split over "model" is
    gathered whole, its moments too, so that one process can load the
    file: every model rank calls this and the first one writes."""
    path = checkpoint_path(config, stage)
    model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    if tensor_parallel.model_splits(state.model):
        model = tensor_parallel.gathered_state_dict(state.model)
        optimizer = tensor_parallel.gathered_optimizer_state(state.optimizer, state.model)
        if torch.distributed.get_rank(tensor_parallel.model_group(state.model)) != 0:
            return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(
        {
            "model": {k: v.detach().cpu() for k, v in model.items()},
            "optimizer": optimizer,
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
            "stage": stage,
        },
        tmp,
    )
    os.replace(tmp, path)
    return path


def read_checkpoint(config: Config, stage: int) -> dict:
    """A stage's checkpoint on the CPU (tensors and plain values only);
    ``["model"]`` is the ATDNVO ``state_dict``."""
    path = checkpoint_path(config, stage)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no odometry checkpoint for stage {stage}: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(config: Config, stage: int, state: OdometryTrainState) -> OdometryTrainState:
    """Restore a stage's checkpoint into ``state`` (in place; returned);
    a split model takes its rows of the whole state."""
    ckpt = read_checkpoint(config, stage)
    tensor_parallel.load_state_dict(state.model, ckpt["model"])
    state.optimizer.load_state_dict(tensor_parallel.shard_optimizer_state(ckpt["optimizer"], state.model))
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return state


def warm_start(config: Config, state: OdometryTrainState) -> OdometryTrainState:
    """The stage curriculum: at ``config.train.stage`` > 1, load the
    previous stage's weights and batch statistics and keep the fresh
    optimiser (ref: train_odometry.py:94-97 loads the weights only)."""
    stage = config.train.stage
    if stage > 1:
        tensor_parallel.load_state_dict(state.model, read_checkpoint(config, stage - 1)["model"])
    return state
