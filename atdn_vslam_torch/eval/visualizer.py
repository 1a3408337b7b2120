"""Trajectory visualization (the port's copy of
``atdn_vslam_tpu/eval/visualizer.py``; matplotlib is imported only when
a plot is drawn; the reference uses the external
``evo`` package + matplotlib — ref: atdn_vslam/eval/visualizer.py:20-132).

Produces the same artifact set: XZ-plane trajectory plot (KITTI's
plot_mode=xz, ref eval/README.md:13), error-colormapped comparison, and
per-axis xyz curves.
"""

from __future__ import annotations

import numpy as np

from atdn_vslam_torch.eval.ate import _positions, umeyama_alignment


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories_xz(
    trajectories: dict[str, np.ndarray],
    out_path: str,
    title: str = "Trajectory (XZ)",
) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    for name, traj in trajectories.items():
        p = _positions(traj)
        ax.plot(p[:, 0], p[:, 2], label=name, linewidth=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_error_colormap(
    pred: np.ndarray,
    gt: np.ndarray,
    out_path: str,
    align: bool = True,
    correct_scale: bool = True,
) -> str:
    """GT in grey, prediction colored by positional error
    (ref visualizer.py:96-115)."""
    plt = _plt()
    p = _positions(pred)
    g = _positions(gt)
    if align:
        R, t, s = umeyama_alignment(p, g, with_scale=correct_scale)
        p = (s * (R @ p.T)).T + t
    err = np.linalg.norm(p - g, axis=1)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(g[:, 0], g[:, 2], color="0.6", linewidth=1.0, label="GT")
    sc = ax.scatter(p[:, 0], p[:, 2], c=err, cmap="jet", s=2)
    fig.colorbar(sc, ax=ax, label="APE [m]")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_xyz(
    trajectories: dict[str, np.ndarray], out_path: str
) -> str:
    """Per-axis position curves (ref visualizer.py:117-132)."""
    plt = _plt()
    fig, axs = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    for name, traj in trajectories.items():
        p = _positions(traj)
        for i, axis_name in enumerate("xyz"):
            axs[i].plot(p[:, i], label=name, linewidth=1.0)
            axs[i].set_ylabel(axis_name + " [m]")
    axs[0].legend()
    axs[-1].set_xlabel("frame")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
