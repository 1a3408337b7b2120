"""SE(3) pose math on tensors, batched over leading axes.

Counterpart of ``atdn_vslam_tpu/geometry/se3.py``: euler (yxz, yxy,
xyx) to matrix and back (yxz, yxy), pose matrices and KITTI lines,
the analytic SE(3) inverse, relative poses, and trajectory chaining,
both on tensors (a log-depth prefix product) and on the host in numpy
float64 for evaluation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
    return homogeneous(torch.cat([R, tr[..., :, None]], dim=-1))


def homogeneous(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) [R | t] -> (..., 4, 4) with the row (0, 0, 0, 1)
    (written without in-place ops, so ``torch.func`` transforms pass)."""
    corner = torch.zeros(4, 4, dtype=top.dtype, device=top.device)
    corner[3, 3] = 1.0
    return F.pad(top, (0, 0, 0, 1)) + corner


def line_to_matrix(line: torch.Tensor) -> torch.Tensor:
    """(..., 12) row-major KITTI pose lines -> (..., 4, 4)
    (ref: transforms.py:4-22)."""
    return homogeneous(line.reshape(*line.shape[:-1], 3, 4))


def matrix_to_line(mat: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 12) KITTI pose lines."""
    return mat[..., :3, :].reshape(*mat.shape[:-2], 12)


def matrix_to_pose(mat: torch.Tensor, convention: str = "yxz") -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 4, 4) -> ((..., 3) euler rotation, (..., 3) translation)."""
    return matrix_to_euler(mat[..., :3, :3], convention), mat[..., :3, 3]


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of (..., 4, 4) poses: (R, t) -> (R^T, -R^T t)."""
    rt = mat[..., :3, :3].transpose(-1, -2)
    return homogeneous(torch.cat([rt, -rt @ mat[..., :3, 3:]], dim=-1))


def relative_pose(
    pose1: torch.Tensor, pose2: torch.Tensor, convention: str = "yxz"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute pose pair -> relative (euler rotation, translation)
    (ref: transforms.py:122-144). Takes (..., 12) lines or (..., 4, 4)."""
    if pose1.shape[-1] == 12:
        pose1, pose2 = line_to_matrix(pose1), line_to_matrix(pose2)
    delta = se3_inverse(pose1) @ pose2
    return matrix_to_euler(delta[..., :3, :3], convention), delta[..., :3, 3]


def absolute_to_relative(
    poses: torch.Tensor, convention: str = "yxz"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 12) lines or (N, 4, 4) poses -> the N - 1 relative steps."""
    if poses.shape[-1] == 12:
        poses = line_to_matrix(poses)
    return relative_pose(poses[:-1], poses[1:], convention)


def prefix_products(mats: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix products of 4x4 matrices along ``dim``:
    out[k] = mats[0] @ ... @ mats[k], in log depth, pairing the products
    as ``lax.associative_scan`` does (so float32 rounding follows the JAX
    package's)."""
    n = mats.shape[dim]
    if n < 2:
        return mats
    even = mats.narrow(dim, 0, n - 1)[(slice(None),) * dim + (slice(None, None, 2),)]
    odd_in = mats[(slice(None),) * dim + (slice(1, None, 2),)]
    odd = prefix_products(even @ odd_in, dim)
    rest = mats[(slice(None),) * dim + (slice(2, None, 2),)]
    head = odd.narrow(dim, 0, odd.shape[dim] - 1) if n % 2 == 0 else odd
    even = torch.cat([mats.narrow(dim, 0, 1), head @ rest], dim=dim)
    out = torch.stack([even.narrow(dim, 0, odd.shape[dim]), odd], dim=dim + 1)
    out = out.flatten(dim, dim + 1)
    if n % 2:
        out = torch.cat([out, even.narrow(dim, even.shape[dim] - 1, 1)], dim=dim)
    return out


def accumulate_poses(
    rotations: torch.Tensor,
    translations: torch.Tensor,
    convention: str = "yxz",
    base: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chain (N, 3) relative euler steps and (N, 3) translations into
    (N + 1, 4, 4) absolute poses: out[0] = I (or ``base``),
    out[i + 1] = out[i] @ T_i (ref: transforms.py:147-170)."""
    steps = pose_to_matrix(rotations, translations, convention)
    chained = prefix_products(steps)
    first = torch.eye(4, dtype=steps.dtype, device=steps.device)[None]
    if base is not None:
        first = base.to(steps.dtype)[None]
        chained = first @ chained
    return torch.cat([first, chained], dim=0)


def accumulate_poses_host(rotations, translations, convention: str = "yxz", base=None) -> np.ndarray:
    """The same chain on the host in numpy float64, for evaluation: over
    a KITTI sequence of thousands of steps float32 drifts, and the
    reference chains in CPU doubles (ref: evaluate_odometry.py:131).
    Returns (N + 1, 4, 4) float64."""
    eul = np.asarray(rotations, np.float64)
    n = len(eul)
    steps = np.tile(np.eye(4), (n, 1, 1))
    steps[:, :3, :3] = euler_to_matrix(torch.from_numpy(eul), convention).numpy()
    steps[:, :3, 3] = np.asarray(translations, np.float64)
    out = np.empty((n + 1, 4, 4))
    out[0] = np.eye(4) if base is None else np.asarray(base, np.float64)
    for i in range(n):
        out[i + 1] = out[i] @ steps[i]
    return out
