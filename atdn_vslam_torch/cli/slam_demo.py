"""The whole SLAM life cycle on one sequence, the counterpart of the JAX
package's ``cli/slam_demo.py`` (ref: test_slam.py:24-148): odometry over
every frame (with its frame rate), keyframe registration, the map
(``end_odometry``) and a relocalisation query, with the trajectory as
KITTI text and, unless ``--no-plot``, an XZ plot.

Frames come from a KITTI tree (``image_2/*.png``, read with OpenCV) or,
where OpenCV is not installed, from ``--frames``, an (N, H, W, 3) uint8
``.npy`` stack. The flow net loads a reference GMA ``.pth``
(``--flow-checkpoint``), ATDNVO a stage checkpoint of
``train_odometry`` (``--odometry-checkpoint-dir``, ``--stage``); without
them the demo warns and uses seeded random weights.

Usage:
  python -m atdn_vslam_torch.cli.slam_demo --data-path data --sequence 00 \\
      --flow-checkpoint gma-kitti.pth --odometry-checkpoint-dir checkpoints --stage 1 \\
      [--max-frames 200 --query-frame 195 --frames frames.npy --no-plot --device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from atdn_vslam_torch.checkpoint import load_reference_checkpoint
from atdn_vslam_torch.config import load_config
from atdn_vslam_torch.eval import save_kitti_trajectory
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model, init_params
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.training.odometry import read_checkpoint
from atdn_vslam_torch.utils.helpers import log, resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Full SLAM life-cycle demo")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--sequence", type=str, default="00")
    p.add_argument("--frames", type=str, default=None,
                   help="an (N, H, W, 3) uint8 .npy frame stack instead of the sequence's PNGs")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--query-frame", type=int, default=195,
                   help="frame index of the relocalisation query (the reference's test_slam.py uses 195)")
    p.add_argument("--odometry-checkpoint-dir", type=str, default=None)
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--flow-checkpoint", type=str, default=None,
                   help="a reference GMA .pth or the weights train_flow writes (--output)")
    p.add_argument("--out-dir", type=str, default="slam_demo_results")
    p.add_argument("--no-plot", action="store_true", help="skip the XZ plot (needs matplotlib)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: no GPU, no run

    config = load_config(args.config)
    if args.data_path:
        config = dataclasses.replace(config, data_path=args.data_path)
    os.makedirs(args.out_dir, exist_ok=True)
    config = dataclasses.replace(config, keyframes_path=os.path.join(args.out_dir, "keyframes"))

    if args.flow_checkpoint:
        flow_sd = load_reference_checkpoint(args.flow_checkpoint)
    else:
        flow_sd = init_params(build_flow_model(config, "cpu"), 0).state_dict()
        log("WARNING: random-init flow net")
    if args.odometry_checkpoint_dir:
        cfg2 = dataclasses.replace(config, checkpoint_dir=args.odometry_checkpoint_dir)
        odo_sd = read_checkpoint(cfg2, args.stage)["model"]
    else:
        odo_sd = init_params(build_odometry_model(config, "cpu"), 1).state_dict()
        log("WARNING: random-init odometry net")
    slam = SlamRuntime(config, flow_sd, odo_sd, device=device)

    if args.frames:
        frames = np.load(args.frames, mmap_mode="r")
        read = frames.__getitem__
        n = len(frames)
    else:
        from atdn_vslam_torch.data.kitti import KittiSequence

        seq = KittiSequence(config.data_path, args.sequence, need_flows=False)
        read = seq.read_image
        n = len(seq.image_files)
    if args.max_frames:
        n = min(n, args.max_frames)
    log(f"Sequence {args.sequence}: {n} frames")

    # odometry (ref test_slam.py:24-81)
    slam.start_odometry()
    t0 = time.time()
    poses = slam.run_odometry_sequence(np.stack([read(i) for i in range(n)]))
    elapsed = time.time() - t0
    log(f"Odometry: {n} frames in {elapsed:.1f}s ({n / elapsed:.2f} fps incl. IO), keyframes: {len(slam)}")
    traj_path = save_kitti_trajectory(os.path.join(args.out_dir, f"{args.sequence}_slam.txt"), poses)
    if not args.no_plot:
        from atdn_vslam_torch.eval.visualizer import plot_trajectories_xz

        plot_trajectories_xz({"SLAM": poses}, os.path.join(args.out_dir, f"{args.sequence}_slam_xz.png"))
    log("Trajectory ->", traj_path)

    # mapping (ref test_slam.py:84-99)
    t0 = time.time()
    slam.end_odometry()
    log(f"Mapping trained in {time.time() - t0:.1f}s; mode: {slam.mode()}")

    # relocalisation (ref test_slam.py:101-148)
    qi = min(args.query_frame, n - 1)
    initial, refined, distances = slam(np.asarray(read(qi)))
    log(f"Relocalization of frame {qi}: nearest keyframe {int(np.argmin(distances))} of {len(distances)}")
    err_initial = np.linalg.norm(initial[:3, 3] - poses[qi][:3, 3])
    err_refined = np.linalg.norm(refined[:3, 3] - poses[qi][:3, 3])
    log(f"position error: initial {err_initial:.2f} m, refined {err_refined:.2f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
