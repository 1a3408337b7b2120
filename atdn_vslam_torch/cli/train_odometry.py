"""ATDNVO odometry training, the counterpart of the JAX package's
``cli/train_odometry.py`` (ref: train_odometry.py:21-150).

Trains on cached flow windows of a KITTI tree (``data/kitti.py``) and
writes one checkpoint per stage (``training/odometry.py``) after every
epoch, plus the per-step losses as text. Stage N > 1 starts from stage
N - 1's checkpoint (ref: train_odometry.py:94-97).

Data parallel over processes, one per device: start one process per
rank with ``ATDN_COORDINATOR_ADDRESS`` (rank 0's ``host:port``),
``ATDN_NUM_PROCESSES`` and ``ATDN_PROCESS_ID`` set; each takes its slice
of every batch over the config's ``mesh`` (``parallel/mesh.py``), with
global batch statistics and averaged gradients, and rank 0 writes the
checkpoints and logs. ``--backend`` picks the collectives (default
``nccl`` on CUDA, ``gloo`` on the CPU); ``--no-mesh`` trains each
process alone on whole batches.

Usage:
  python -m atdn_vslam_torch.cli.train_odometry --data-path data --stage 1 \\
      [--config configs/kitti.yaml --epochs 2 --batch-size 24 --sequence-length 6 --device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from atdn_vslam_torch.config import load_config
from atdn_vslam_torch.data import BatchLoader, FlowWindowDataset
from atdn_vslam_torch.models.factory import build_odometry_model
from atdn_vslam_torch.parallel import distributed, make_mesh
from atdn_vslam_torch.training.odometry import init_state, save_checkpoint, train_epoch, warm_start
from atdn_vslam_torch.utils.helpers import log, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ATDNVO odometry training")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--stage", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--sequence-length", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sequences", type=str, nargs="+", default=None,
                   help="training sequences (default: the config's train_sequences, "
                        "the reference's 00-10 without 05 and 07)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="collectives of a multi-process run (default: nccl on CUDA, gloo on the CPU)")
    p.add_argument("--no-mesh", action="store_true", help="no data parallelism: each process trains alone")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run
    distributed.initialize(backend=args.backend, device=device)
    device = distributed.local_device(device)
    config = load_config(args.config)
    train_over = {
        k: v
        for k, v in {
            "stage": args.stage, "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
            "sequence_length": args.sequence_length,
            "train_sequences": tuple(args.sequences) if args.sequences else None,
        }.items()
        if v is not None
    }
    if train_over:
        config = dataclasses.replace(config, train=dataclasses.replace(config.train, **train_over))
    paths = {"data_path": args.data_path, "checkpoint_dir": args.checkpoint_dir, "log_dir": args.log_dir}
    config = dataclasses.replace(config, **{k: v for k, v in paths.items() if v})
    tc = config.train

    log("Odometry training, stage", tc.stage)
    seed = tc.seed % (2**32)
    dataset = FlowWindowDataset(
        config.data_path, list(tc.train_sequences), augment=tc.augment_flow,
        sequence_length=tc.sequence_length, seed=seed,
    )
    loader = BatchLoader(dataset, tc.batch_size, shuffle=True, seed=seed)
    log("Windows:", len(dataset), "batches/epoch:", len(loader))

    mesh = None if args.no_mesh else make_mesh(config.mesh)
    if mesh is not None:
        log("Mesh:", mesh.shape)
    main_rank = distributed.rank() == 0

    sample_flows, _, _ = dataset[0]
    model = build_odometry_model(config, device, image_hw=sample_flows.shape[1:3])
    state = init_state(model, tc, tc.epochs * len(loader))
    log("Trainable parameters:", sum(p.numel() for p in model.parameters()))
    warm_start(config, state)

    writer = _maybe_tensorboard(config.log_dir, "odometry")
    all_losses: list[float] = []
    t_start = time.time()
    for epoch in range(tc.epochs):
        def log_fn(i, metrics, _e=epoch):
            loss = float(metrics["loss"])
            print(f"epoch {_e + 1}/{tc.epochs} batch {i}: loss {loss:.5f}")
            if writer is not None:
                writer.add_scalar("Loss", loss, i + _e * len(loader))

        losses = train_epoch(state, loader, config.loss, log_fn=log_fn if main_rank else None, mesh=mesh)
        all_losses.extend(losses)
        if main_rank:
            path = save_checkpoint(config, tc.stage, state)
            log(f"Epoch {epoch + 1} done, mean loss {np.mean(losses):.5f} -> {path}")

    if main_rank:
        os.makedirs(config.log_dir, exist_ok=True)
        np.savetxt(os.path.join(config.log_dir, f"odometry_stage{tc.stage}_loss.txt"), np.asarray(all_losses))
    if writer is not None:
        writer.close()
    log("Training finished in", round(time.time() - t_start, 1), "s")
    return 0


def _maybe_tensorboard(log_dir: str, name: str):
    """A tensorboardX writer where the package is installed, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(log_dir, name))


if __name__ == "__main__":
    raise SystemExit(main())
