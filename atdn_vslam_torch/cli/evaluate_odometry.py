"""Odometry evaluation, the counterpart of the JAX package's
``cli/evaluate_odometry.py`` (ref: evaluate_odometry.py:21-143).

Runs ATDNVO from a stage's checkpoint over the cached flows of KITTI
sequences, forward and/or backward, with the LSTM carry threaded over
the whole sequence; chains the relative poses on the host in float64;
writes KITTI trajectory text, optionally plots (matplotlib), and reports
the ATE when ground truth is present. One process evaluates every
sequence it is given; in a multi-process run (the ``ATDN_*`` variables,
``parallel/distributed.py``) each process evaluates its round-robin
share of them (``host_shard``).

Usage:
  python -m atdn_vslam_torch.cli.evaluate_odometry --data-path data \\
      --checkpoint-dir checkpoints --stage 1 --sequence 00 --direction both \\
      --exp results/exp1 [--plot --device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from atdn_vslam_torch.config import Config, load_config
from atdn_vslam_torch.data import FlowWindowDataset
from atdn_vslam_torch.data.kitti import load_poses
from atdn_vslam_torch.eval import ape_statistics, save_kitti_trajectory
from atdn_vslam_torch.geometry.se3 import accumulate_poses_host
from atdn_vslam_torch.models.factory import build_odometry_model
from atdn_vslam_torch.models.odometry import ATDNVO
from atdn_vslam_torch.parallel import distributed
from atdn_vslam_torch.training.odometry import read_checkpoint
from atdn_vslam_torch.utils.helpers import log, resolve_device


@torch.inference_mode()
def run_inference(
    model: ATDNVO, dataset: FlowWindowDataset, forward: bool = True, chunk: int = 32
) -> tuple[np.ndarray, np.ndarray, float]:
    """Whole-sequence inference with the LSTM carry held across the
    whole sequence (ref: evaluate_odometry.py:60-75, a loop of batch-1
    calls): time chunks of ``chunk`` flows, the encoder batched over each
    chunk, the carry threaded between chunks. Returns (rot, tr, seconds
    of inference, host copies included)."""
    device = next(model.parameters()).device
    carry = model.init_carry(1)
    n = len(dataset)
    indices = list(range(n)) if forward else list(range(n - 1, -1, -1))
    rots, trs = [], []
    infer_time = 0.0
    for start in range(0, n, chunk):
        flows = np.stack([dataset[i][0][0] for i in indices[start : start + chunk]])
        x = torch.from_numpy(flows).to(device)[None]  # (1, T, H, W, 2)
        t0 = time.perf_counter()
        (rot, tr), carry = model(x, carry)
        rots.append(rot[0].cpu().numpy())
        trs.append(tr[0].cpu().numpy())
        infer_time += time.perf_counter() - t0
    return np.concatenate(rots), np.concatenate(trs), infer_time


def evaluate_direction(
    model: ATDNVO, config: Config, sequence: str, forward: bool, out_dir: str, plot: bool
) -> str:
    # the augment value picks the traversal direction
    # (ref: evaluate_odometry.py:27-29,50-58 with FlowKittiDataset2)
    dataset = FlowWindowDataset(
        config.data_path, [sequence], augment=1.0 if forward else -1.0, sequence_length=1
    )
    rot, tr, seconds = run_inference(model, dataset, forward)
    traj = accumulate_poses_host(rot, tr)
    suffix = "f" if forward else "b"
    path = save_kitti_trajectory(os.path.join(out_dir, f"{sequence}_{suffix}.txt"), traj)
    fps = len(dataset) / seconds if seconds > 0 else float("inf")
    log(f"{sequence} {suffix}: {len(dataset)} frames, {seconds:.2f}s inference ({fps:.1f} fps) -> {path}")

    try:
        gt = load_poses(config.data_path, sequence)
    except FileNotFoundError:
        gt = None
    if gt is not None and forward and len(gt) == len(traj):
        stats = ape_statistics(traj, gt, align=True, correct_scale=True)
        log(f"ATE (aligned+scale) rmse {stats['rmse']:.2f} m, mean {stats['mean']:.2f} m, "
            f"max {stats['max']:.2f} m")
    if plot:
        from atdn_vslam_torch.eval.visualizer import plot_trajectories_xz

        plots = {"prediction": traj}
        if gt is not None:
            plots["GT"] = gt
        plot_trajectories_xz(plots, os.path.join(out_dir, f"{sequence}_{suffix}.png"))
    return path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Odometry evaluation")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--stage", type=int, required=True)
    p.add_argument("--sequence", type=str, nargs="+", default=["00"])
    p.add_argument("--direction", choices=["forward", "backward", "both"], default="forward")
    p.add_argument("--exp", type=str, default="eval_results")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run
    distributed.initialize(device=device)
    device = distributed.local_device(device)

    config = load_config(args.config)
    paths = {"data_path": args.data_path, "checkpoint_dir": args.checkpoint_dir}
    config = dataclasses.replace(config, **{k: v for k, v in paths.items() if v})
    config = dataclasses.replace(config, train=dataclasses.replace(config.train, stage=args.stage))

    # ATDNVO for the cached flows' size
    sample = FlowWindowDataset(config.data_path, args.sequence[:1], sequence_length=1)[0][0]
    model = build_odometry_model(config, device, image_hw=sample.shape[1:3])
    model.load_state_dict(read_checkpoint(config, args.stage)["model"])
    os.makedirs(args.exp, exist_ok=True)
    for sequence in distributed.host_shard(args.sequence):
        for forward, name in ((True, "forward"), (False, "backward")):
            if args.direction in (name, "both"):
                evaluate_direction(model, config, sequence, forward, args.exp, args.plot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
