"""Losses of the map network (JAX ``training/losses.py:127-189``). Images
are NHWC, as ``MappingVAE`` returns them: the channel axis is -1."""

from __future__ import annotations

import torch


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
