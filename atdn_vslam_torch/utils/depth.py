"""KITTI calibration and depth back-projection, the port's counterpart
of ``atdn_vslam_tpu/utils/depth.py`` (ref: atdn_vslam/utils/depth.py:5-45):
a calib-file reader and depth map -> 3-D points through the inverse
intrinsics, in torch on the depth map's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def read_calib(data_path: str, sequence: str) -> np.ndarray:
    """The P2 (left colour camera) 3x4 projection matrix of a KITTI
    ``calib.txt`` (ref: depth.py:5-20)."""
    path = os.path.join(data_path, "dataset", "sequences", sequence, "calib.txt")
    with open(path) as f:
        for line in f:
            if line.startswith("P2:"):
                vals = np.array(line.split(":", 1)[1].split(), dtype=np.float64)
                return vals.reshape(3, 4)
    raise ValueError(f"No P2 entry in {path}")


def project_depth(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map to camera-frame 3-D points
    (ref: depth.py:23-45).

    :param depth: (H, W) metric depth.
    :param intrinsics: (3, 3) camera matrix K (e.g. P2[:, :3]).
    :return: (H, W, 3) xyz points in depth's type.
    """
    h, w = depth.shape
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :].expand(h, w)
    pix = torch.stack([xs, ys, torch.ones_like(depth)], dim=-1)  # (H, W, 3) homogeneous
    k_inv = torch.linalg.inv(torch.as_tensor(intrinsics, device=depth.device).float()).to(depth.dtype)
    return (pix @ k_inv.T) * depth[..., None]
