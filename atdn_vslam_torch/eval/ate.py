"""Trajectory metrics: Umeyama alignment, APE/ATE, RPE (the port's copy
of ``atdn_vslam_tpu/eval/ate.py``, numpy float64 on the host).

The reference delegates metrics to the external ``evo`` package with
APE on the translation part, ``align=True, correct_scale=True``
(ref: atdn_vslam/eval/visualizer.py:85-91). This module implements the
same recipe natively (host numpy, float64):

  * ``umeyama_alignment`` — least-squares similarity transform
    (Umeyama 1991), with and without scale;
  * ``ape_statistics`` — absolute position error stats after optional
    alignment (rmse/mean/median/std/min/max), evo-compatible;
  * ``rpe_statistics`` — relative pose error over a fixed frame delta.

BASELINE.md pins the reference numbers these must reproduce: ATE RMSE
23.37 m (aligned+scale) / 24.06 m (aligned) on the shipped seq-00
trajectory pair.
"""

from __future__ import annotations

import numpy as np


def _positions(traj: np.ndarray) -> np.ndarray:
    """(N, 12) KITTI lines or (N, 4, 4)/(N, 3, 4) matrices -> (N, 3)."""
    traj = np.asarray(traj, np.float64)
    if traj.ndim == 2 and traj.shape[1] == 12:
        return traj.reshape(-1, 3, 4)[:, :, 3]
    if traj.ndim == 3:
        return traj[:, :3, 3]
    raise ValueError(f"Unrecognized trajectory shape {traj.shape}")


def umeyama_alignment(
    source: np.ndarray, target: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning source -> target.

    :param source: (N, 3) points to align.
    :param target: (N, 3) reference points.
    :return: (R (3,3), t (3,), s) with target ~= s * R @ source + t.
    """
    src = np.asarray(source, np.float64)
    dst = np.asarray(target, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ape_statistics(
    pred: np.ndarray,
    gt: np.ndarray,
    align: bool = True,
    correct_scale: bool = True,
) -> dict[str, float]:
    """Absolute position error statistics (translation part), matching
    evo's APE with -a/-as (ref recipe: eval/visualizer.py:85-91)."""
    p = _positions(pred)
    g = _positions(gt)
    if len(p) != len(g):
        raise ValueError(f"Trajectory lengths differ: {len(p)} vs {len(g)}")
    if align:
        R, t, s = umeyama_alignment(p, g, with_scale=correct_scale)
        p = (s * (R @ p.T)).T + t
    err = np.linalg.norm(p - g, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "sse": float(np.sum(err**2)),
    }


def ate_rmse(
    pred: np.ndarray,
    gt: np.ndarray,
    align: bool = True,
    correct_scale: bool = True,
) -> float:
    return ape_statistics(pred, gt, align, correct_scale)["rmse"]


def _to_mats(traj: np.ndarray) -> np.ndarray:
    traj = np.asarray(traj, np.float64)
    if traj.ndim == 2 and traj.shape[1] == 12:
        n = traj.shape[0]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :] = traj.reshape(n, 3, 4)
        return out
    if traj.shape[-2:] == (3, 4):
        n = traj.shape[0]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :] = traj
        return out
    return traj


def rpe_statistics(
    pred: np.ndarray, gt: np.ndarray, delta: int = 1
) -> dict[str, float]:
    """Relative pose error over a frame delta: translation norm and
    rotation angle of inv(dGT) @ dPred."""
    P = _to_mats(pred)
    G = _to_mats(gt)
    dP = np.linalg.inv(P[:-delta]) @ P[delta:]
    dG = np.linalg.inv(G[:-delta]) @ G[delta:]
    E = np.linalg.inv(dG) @ dP
    t_err = np.linalg.norm(E[:, :3, 3], axis=1)
    cos = np.clip((np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    r_err = np.degrees(np.arccos(cos))
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_err**2))),
        "trans_mean": float(t_err.mean()),
        "rot_rmse_deg": float(np.sqrt(np.mean(r_err**2))),
        "rot_mean_deg": float(r_err.mean()),
    }
