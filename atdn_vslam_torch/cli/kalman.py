"""Kalman forward/backward fusion CLI (ref: atdn_vslam/eval/
kalman.py:129-142).

Determines per-axis error stds on a calibration sequence (default 00),
then fuses the forward and backward runs of the target sequence and
exports ``<seq>_k.txt``.

Usage:
  python -m atdn_vslam_torch.cli.kalman --results eval_results \
      --sequence 00 --gt-dir data/dataset/poses
"""

from __future__ import annotations

import argparse
import os

from atdn_vslam_torch.eval import (
    ape_statistics,
    error_stds,
    fuse_trajectories,
    load_kitti_trajectory,
    rebase_backward_trajectory,
    save_kitti_trajectory,
)
from atdn_vslam_torch.utils.helpers import log


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Forward/backward Kalman fusion")
    p.add_argument("--results", type=str, required=True,
                   help="dir with <seq>_f.txt / <seq>_b.txt")
    p.add_argument("--sequence", type=str, default="00")
    p.add_argument("--calibration-sequence", type=str, default="00",
                   help="sequence used to estimate error stds "
                        "(ref: kalman.py:93 uses 00)")
    p.add_argument("--gt-dir", type=str, required=True,
                   help="dir with KITTI ground-truth <seq>.txt files")
    args = p.parse_args(argv)

    def paths(seq):
        return (
            os.path.join(args.results, f"{seq}_f.txt"),
            os.path.join(args.results, f"{seq}_b.txt"),
            os.path.join(args.gt_dir, f"{seq}.txt"),
        )

    cal_f, cal_b, cal_gt = paths(args.calibration_sequence)
    stds = error_stds(
        load_kitti_trajectory(cal_f),
        rebase_backward_trajectory(load_kitti_trajectory(cal_b)),
        load_kitti_trajectory(cal_gt),
    )
    log("error stds (rot_f, rot_b, tr_f, tr_b):")
    for s in stds:
        print(" ", s)

    f_path, b_path, gt_path = paths(args.sequence)
    fused = fuse_trajectories(
        load_kitti_trajectory(f_path), load_kitti_trajectory(b_path), stds
    )
    out = save_kitti_trajectory(
        os.path.join(args.results, f"{args.sequence}_k.txt"), fused
    )
    log("Fused trajectory ->", out)

    if os.path.exists(gt_path):
        gt = load_kitti_trajectory(gt_path)
        if len(gt) == len(fused):
            stats = ape_statistics(fused, gt)
            log(f"Fused ATE rmse {stats['rmse']:.2f} m "
                f"(mean {stats['mean']:.2f}, max {stats['max']:.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
