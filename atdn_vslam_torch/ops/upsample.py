"""Learned convex upsampling of a low-resolution flow
(ref: GMA/core/network.py:59-70)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(
    flow: torch.Tensor, mask: torch.Tensor, factor: int = 8
) -> torch.Tensor:
    """Upsample (B, H, W, 2) flow to (B, 8H, 8W, 2) with a learned
    9-way convex combination per output pixel.

    :param mask: (B, H, W, 9*factor*factor) logits, channel layout
        (9, factor, factor) outermost-first, as the reference's
        ``view(N, 1, 9, 8, 8, H, W)``.

    Computes in float32 on float32 inputs, also inside a
    ``torch.autocast`` region (which would run the einsum in bf16).
    """
    with torch.autocast(flow.device.type, enabled=False):
        return _convex_upsample(flow, mask, factor)


def _convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, factor * factor), dim=3)
    padded = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    # 3x3 neighbourhoods, neighbour index (dy+1)*3 + (dx+1): torch unfold order
    patches = torch.stack(
        [padded[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)],
        dim=3,
    )
    up = torch.einsum("bhwkm,bhwkc->bhwmc", mask, patches)
    up = up.reshape(b, h, w, factor, factor, 2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * factor, w * factor, 2)
