"""Losses (JAX ``training/losses.py``): the CLVO pose loss of the
odometry network and the map network's losses. Images are NHWC, as
``MappingVAE`` returns them: the channel axis is -1.

The CLVO loss (ref: atdn_vslam/odometry/loss.py:7-118) is a weighted
relative-pose MSE plus a windowed composed-pose term. The reference
composes the windows with nested loops of 4x4 products; here every
window product comes from prefix products, inv(P_j) P_(j+w), and the
euler extraction is differentiable.
"""

from __future__ import annotations

import torch

from atdn_vslam_torch.geometry.se3 import matrix_to_euler, pose_to_matrix, prefix_products, se3_inverse

# CLVO loss weights (ref: odometry/loss.py:20-22)
DELTA = 1.0
KHI = 100.0


def transform_loss(
    pred_rot: torch.Tensor, pred_tr: torch.Tensor, true_rot: torch.Tensor, true_tr: torch.Tensor,
    delta: float = DELTA, khi: float = KHI,
) -> torch.Tensor:
    """delta * ||dtr||^2 + khi * ||drot||^2 over the last axis
    (ref: loss.py:104-118)."""
    rot_term = torch.sum((pred_rot - true_rot) ** 2, dim=-1)
    tr_term = torch.sum((pred_tr - true_tr) ** 2, dim=-1)
    return delta * tr_term + khi * rot_term


def _window_compositions(rot: torch.Tensor, tr: torch.Tensor, w: int) -> torch.Tensor:
    """(B, T, 3) euler steps and translations -> (B, T - w + 1, 4, 4), the
    product of every length-``w`` window: with prefix products P_k
    (P_0 = I), window j is inv(P_j) @ P_(j + w)."""
    mats = pose_to_matrix(rot, tr)
    prefix = prefix_products(mats, dim=1)
    eye = torch.eye(4, dtype=mats.dtype, device=mats.device).expand(mats.shape[0], 1, 4, 4)
    prefix = torch.cat([eye, prefix], dim=1)
    t = rot.shape[1]
    return se3_inverse(prefix[:, : t - w + 1]) @ prefix[:, w:]


def composed_pose_loss(
    pred_rot: torch.Tensor, pred_tr: torch.Tensor, true_rot: torch.Tensor, true_tr: torch.Tensor,
    w: int = 3, delta: float = DELTA, khi: float = KHI,
) -> torch.Tensor:
    """The windowed composed-pose loss summed over windows -> (B,)
    (ref: loss.py:60-101)."""
    pred_c = _window_compositions(pred_rot, pred_tr, w)
    true_c = _window_compositions(true_rot, true_tr, w)
    loss = transform_loss(
        matrix_to_euler(pred_c[..., :3, :3]), pred_c[..., :3, 3],
        matrix_to_euler(true_c[..., :3, :3]), true_c[..., :3, 3], delta, khi,
    )
    return torch.sum(loss, dim=-1)


def clvo_loss(
    pred_rot: torch.Tensor, pred_tr: torch.Tensor, true_rot: torch.Tensor, true_tr: torch.Tensor,
    alpha: float = 1.0, w: int = 3, delta: float = DELTA, khi: float = KHI,
) -> torch.Tensor:
    """The CLVO pose loss (ref: loss.py:25-57) on (B, T, 3) inputs:
    mean over B of alpha * sum_T L_rel + (1 - alpha) * sum_windows L_com.
    At alpha == 1 the composed term is not computed (the reference
    computes it and multiplies it by zero)."""
    l_rel = torch.sum(transform_loss(pred_rot, pred_tr, true_rot, true_tr, delta, khi), dim=-1)
    if alpha == 1.0:
        return torch.mean(l_rel)
    l_com = composed_pose_loss(pred_rot, pred_tr, true_rot, true_tr, w, delta, khi)
    return torch.mean(alpha * l_rel + (1.0 - alpha) * l_com)


def vae_loss(
    pred: torch.Tensor, target: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor, beta: float = 1.0
) -> torch.Tensor:
    """MSE + beta * KL(N(mu, sigma) || N(0, 1))
    (ref: localization/losses.py:5-16)."""
    mse = torch.mean((pred - target) ** 2)
    kld = -0.5 * torch.mean(1.0 + logvar - mu**2 - torch.exp(logvar))
    return mse + beta * kld


def embedding_distance_loss(embeddings: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Keeps the pairwise distance *ratios* of a point triplet in
    embedding space (ref: localization/edl.py:7-27).

    :param embeddings: (3, D) triplet of flattened codes.
    :param points: (3, P) triplet of reference points (e.g. positions).
    """
    e1, e2, e3 = embeddings[0], embeddings[1], embeddings[2]
    p1, p2, p3 = points[0], points[1], points[2]

    def ratio(a, b):
        return torch.linalg.norm(a) / (torch.linalg.norm(b) + 1e-8)

    return (
        (ratio(p1 - p2, p1 - p3) - ratio(e1 - e2, e1 - e3)) ** 2
        + (ratio(p1 - p2, p2 - p3) - ratio(e1 - e2, e2 - e3)) ** 2
        + (ratio(p1 - p3, p2 - p3) - ratio(e1 - e3, e2 - e3)) ** 2
    )


def mapping_reconstruction_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE + the L1 distance of the saturations (per-pixel
    max - min over the channels), the loss the runtime's map training
    uses (ref: neural_slam.py:336-340). NHWC inputs."""
    mse = torch.mean((pred - target) ** 2)
    sat_true = target.amax(dim=-1) - target.amin(dim=-1)
    sat_pred = pred.amax(dim=-1) - pred.amin(dim=-1)
    return mse + torch.mean(torch.abs(sat_true - sat_pred))
