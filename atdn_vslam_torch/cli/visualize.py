"""Trajectory visualization + metrics CLI (ref: atdn_vslam/eval/
visualizer.py:20-132).

Usage:
  python -m atdn_vslam_torch.cli.visualize --pred pred.txt --gt gt.txt \
      --out-dir plots
"""

from __future__ import annotations

import argparse
import os

from atdn_vslam_torch.eval import ape_statistics, load_kitti_trajectory, rpe_statistics
from atdn_vslam_torch.eval.visualizer import (
    plot_error_colormap,
    plot_trajectories_xz,
    plot_xyz,
)
from atdn_vslam_torch.utils.helpers import log


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Trajectory plots + APE/RPE")
    p.add_argument("--pred", type=str, required=True)
    p.add_argument("--gt", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="plots")
    p.add_argument("--no-align", action="store_true")
    p.add_argument("--no-scale", action="store_true")
    args = p.parse_args(argv)

    pred = load_kitti_trajectory(args.pred)
    os.makedirs(args.out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.pred))[0]

    trajs = {"prediction": pred}
    if args.gt:
        gt = load_kitti_trajectory(args.gt)
        trajs["GT"] = gt
        stats = ape_statistics(
            pred, gt,
            align=not args.no_align, correct_scale=not args.no_scale,
        )
        log("APE (translation part):")
        for k, v in stats.items():
            print(f"  {k:>8}: {v:.4f}")
        rpe = rpe_statistics(pred, gt)
        log("RPE (delta=1):")
        for k, v in rpe.items():
            print(f"  {k:>14}: {v:.4f}")
        plot_error_colormap(
            pred, gt, os.path.join(args.out_dir, f"{name}_ape.png"),
            align=not args.no_align, correct_scale=not args.no_scale,
        )

    plot_trajectories_xz(trajs, os.path.join(args.out_dir, f"{name}_xz.png"))
    plot_xyz(trajs, os.path.join(args.out_dir, f"{name}_xyz.png"))
    log("Plots written to", args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
