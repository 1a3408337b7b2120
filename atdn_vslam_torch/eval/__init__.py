"""Trajectory evaluation: ATE/RPE with Umeyama alignment, KITTI
trajectory IO and plots (numpy copies of the JAX package's ``eval``
modules)."""

from atdn_vslam_torch.eval.ate import ape_statistics, ate_rmse, rpe_statistics, umeyama_alignment
from atdn_vslam_torch.eval.kitti_io import load_kitti_trajectory, save_kitti_trajectory

__all__ = [
    "umeyama_alignment",
    "ate_rmse",
    "ape_statistics",
    "rpe_statistics",
    "load_kitti_trajectory",
    "save_kitti_trajectory",
]
