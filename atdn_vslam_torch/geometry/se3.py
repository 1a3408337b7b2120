"""SE(3) pose math on tensors, batched over leading axes.

Counterpart of ``atdn_vslam_tpu/geometry/se3.py`` for the streaming
step: euler (yxz, yxy, xyx) to matrix, matrix to euler (yxz, yxy) and
``pose_to_matrix``. Trajectory chaining stays on the host in numpy
float64 (``slam/runtime.py``), as in the reference.
"""

from __future__ import annotations

import torch

_CONVENTIONS = ("yxz", "yxy", "xyx")


def euler_to_matrix(euler: torch.Tensor, convention: str = "yxz") -> torch.Tensor:
    """(..., 3) euler angles -> (..., 3, 3) rotation matrices
    (intrinsic compositions, e.g. yxz = Ry(a) Rx(b) Rz(g))."""
    if convention not in _CONVENTIONS:
        raise ValueError(f"Unsupported euler convention: {convention!r}")
    c1, c2, c3 = (torch.cos(euler[..., i]) for i in range(3))
    s1, s2, s3 = (torch.sin(euler[..., i]) for i in range(3))
    if convention == "yxz":
        rows = [
            [c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3, c2 * s1],
            [c2 * s3, c2 * c3, -s2],
            [c1 * s2 * s3 - c3 * s1, c1 * c3 * s2 + s1 * s3, c1 * c2],
        ]
    elif convention == "xyx":
        rows = [
            [c2, s2 * s3, c3 * s2],
            [s1 * s2, c1 * c3 - c2 * s1 * s3, -c1 * s3 - c2 * c3 * s1],
            [-c1 * s2, c3 * s1 + c1 * c2 * s3, c1 * c2 * c3 - s1 * s3],
        ]
    else:  # yxy
        rows = [
            [c1 * c3 - c2 * s1 * s3, s2 * s1, c2 * s1 * c3 + c1 * s3],
            [s2 * s3, c2, -s2 * c3],
            [-c3 * s1 - c2 * c1 * s3, s2 * c1, c2 * c1 * c3 - s1 * s3],
        ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_euler(R: torch.Tensor, convention: str = "yxz") -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) euler angles."""
    if convention == "yxz":
        alpha = torch.atan2(R[..., 0, 2], R[..., 2, 2])
        beta = torch.atan2(
            -R[..., 1, 2], torch.sqrt(torch.clamp(1.0 - R[..., 1, 2] ** 2, min=0.0))
        )
        gamma = torch.atan2(R[..., 1, 0], R[..., 1, 1])
    elif convention == "yxy":
        alpha = torch.atan2(R[..., 0, 1], R[..., 2, 1])
        beta = torch.atan2(
            torch.sqrt(torch.clamp(1.0 - R[..., 1, 1] ** 2, min=0.0)), R[..., 1, 1]
        )
        gamma = torch.atan2(R[..., 1, 0], -R[..., 1, 2])
    else:
        raise ValueError(f"Unsupported euler convention: {convention!r}")
    return torch.stack([alpha, beta, gamma], dim=-1)


def pose_to_matrix(
    rot: torch.Tensor, tr: torch.Tensor, convention: str = "yxz"
) -> torch.Tensor:
    """(..., 3) euler rotation and (..., 3) translation -> (..., 4, 4)
    homogeneous pose (ref: transforms.py:97-119)."""
    R = euler_to_matrix(rot, convention)
    top = torch.cat([R, tr[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
