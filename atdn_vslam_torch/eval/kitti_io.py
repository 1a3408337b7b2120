"""KITTI trajectory text IO (the port's copy of
``atdn_vslam_tpu/eval/kitti_io.py``) (12 values per line, row-major [R|t]),
matching the reference's export format (ref: evaluate_odometry.py:84-99,
eval/kalman.py:83)."""

from __future__ import annotations

import os

import numpy as np


def load_kitti_trajectory(path: str) -> np.ndarray:
    """-> (N, 12) float64 pose lines."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    if data.shape[1] != 12:
        raise ValueError(f"{path}: expected 12 columns, got {data.shape[1]}")
    return data


def save_kitti_trajectory(path: str, traj: np.ndarray) -> str:
    """Accepts (N, 12) lines or (N, 4, 4)/(N, 3, 4) matrices."""
    traj = np.asarray(traj, np.float64)
    if traj.ndim == 3:
        traj = traj[:, :3, :].reshape(len(traj), 12)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, traj)
    return path
