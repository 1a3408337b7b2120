"""Trajectory evaluation: ATE/RPE with Umeyama alignment, KITTI
trajectory IO, forward/backward Kalman fusion and plots (numpy copies of
the JAX package's ``eval`` modules)."""

from atdn_vslam_torch.eval.ate import ape_statistics, ate_rmse, rpe_statistics, umeyama_alignment
from atdn_vslam_torch.eval.kalman import (
    error_stds,
    fuse_trajectories,
    inverse_variance_fusion,
    rebase_backward_trajectory,
)
from atdn_vslam_torch.eval.kitti_io import load_kitti_trajectory, save_kitti_trajectory

__all__ = [
    "umeyama_alignment",
    "ate_rmse",
    "ape_statistics",
    "rpe_statistics",
    "load_kitti_trajectory",
    "save_kitti_trajectory",
    "fuse_trajectories",
    "inverse_variance_fusion",
    "rebase_backward_trajectory",
    "error_stds",
]
