"""Forward/backward trajectory fusion via per-axis inverse-variance
("Kalman") combination (the port's numpy copy of
``atdn_vslam_tpu/eval/kalman.py``; ref: atdn_vslam/eval/kalman.py:9-142),
vectorized on host float64:

  1. the backward run is re-based so its last pose is the origin and
     its frame order matches forward time (ref kalman.py:67-73);
  2. per-frame relative (euler, translation) steps are extracted from
     both runs (ref preprocess_poses_euler, kalman.py:9-28);
  3. per-axis error stds vs ground truth on a calibration sequence
     give the variances (ref determine_std, kalman.py:91-126);
  4. steps fuse as x = (x1*s2^2 + x2*s1^2) / (s1^2 + s2^2)
     (ref kalman.py:45-50) and re-chain into an absolute trajectory.
"""

from __future__ import annotations

import numpy as np

from atdn_vslam_torch.data.kitti import relative_poses_np


def _to_mats(traj: np.ndarray) -> np.ndarray:
    traj = np.asarray(traj, np.float64)
    if traj.ndim == 2 and traj.shape[1] == 12:
        n = traj.shape[0]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :] = traj.reshape(n, 3, 4)
        return out
    return traj


def _to_lines(mats: np.ndarray) -> np.ndarray:
    return mats[:, :3, :].reshape(len(mats), 12)


def rebase_backward_trajectory(backward: np.ndarray) -> np.ndarray:
    """Map a backward-run trajectory into forward time: left-multiply by
    the inverse of its last pose and flip the order
    (ref: kalman.py:67-73). Returns (N, 12) lines."""
    mats = _to_mats(backward)
    rebased = np.linalg.inv(mats[-1]) @ mats
    return _to_lines(rebased[::-1])


def relative_steps(traj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,12)/(N,4,4) absolute -> ((N-1,3) euler yxz, (N-1,3) tr)
    (ref preprocess_poses_euler, kalman.py:9-28)."""
    lines = _to_lines(_to_mats(traj))
    return relative_poses_np(lines)


def error_stds(
    forward: np.ndarray, backward_rebased: np.ndarray, gt: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis std of relative-step errors vs GT for both runs
    (ref determine_std, kalman.py:91-126).
    Returns (std_rot_f, std_rot_b, std_tr_f, std_tr_b), each (3,)."""
    rot_f, tr_f = relative_steps(forward)
    rot_b, tr_b = relative_steps(backward_rebased)
    rot_g, tr_g = relative_steps(gt)
    return (
        (rot_f - rot_g).std(axis=0),
        (rot_b - rot_g).std(axis=0),
        (tr_f - tr_g).std(axis=0),
        (tr_b - tr_g).std(axis=0),
    )


def inverse_variance_fusion(
    x1: np.ndarray, x2: np.ndarray, s1: np.ndarray, s2: np.ndarray
) -> np.ndarray:
    """x = (x1*s2^2 + x2*s1^2) / (s1^2 + s2^2) (ref kalman.py:45-50)."""
    var1, var2 = s1**2, s2**2
    return (x1 * var2 + x2 * var1) / (var1 + var2)


def fuse_trajectories(
    forward: np.ndarray,
    backward: np.ndarray,
    stds: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
) -> np.ndarray:
    """Fuse a forward and a (raw) backward run into one trajectory
    (ref process_kalman, kalman.py:53-86). Returns (N, 12) lines."""
    std_rot_f, std_rot_b, std_tr_f, std_tr_b = stds
    backward_rb = rebase_backward_trajectory(backward)
    rot_f, tr_f = relative_steps(forward)
    rot_b, tr_b = relative_steps(backward_rb)

    rot = inverse_variance_fusion(rot_f, rot_b, std_rot_f, std_rot_b)
    tr = inverse_variance_fusion(tr_f, tr_b, std_tr_f, std_tr_b)

    # re-chain on host in float64 (precision over the full sequence)
    n = rot.shape[0]
    c1, c2, c3 = np.cos(rot[:, 0]), np.cos(rot[:, 1]), np.cos(rot[:, 2])
    s1, s2, s3 = np.sin(rot[:, 0]), np.sin(rot[:, 1]), np.sin(rot[:, 2])
    R = np.empty((n, 3, 3))
    R[:, 0, 0] = c1 * c3 + s1 * s2 * s3
    R[:, 0, 1] = c3 * s1 * s2 - c1 * s3
    R[:, 0, 2] = c2 * s1
    R[:, 1, 0] = c2 * s3
    R[:, 1, 1] = c2 * c3
    R[:, 1, 2] = -s2
    R[:, 2, 0] = c1 * s2 * s3 - c3 * s1
    R[:, 2, 1] = c1 * c3 * s2 + s1 * s3
    R[:, 2, 2] = c1 * c2
    steps = np.tile(np.eye(4), (n, 1, 1))
    steps[:, :3, :3] = R
    steps[:, :3, 3] = tr

    out = np.empty((n + 1, 4, 4))
    out[0] = np.eye(4)
    for i in range(n):
        out[i + 1] = out[i] @ steps[i]
    return _to_lines(out)
