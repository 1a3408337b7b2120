"""Pixel-coordinate grids, zero-padded bilinear sampling and the
forward warp of a flow field (ref: GMA/core/utils/utils.py:28-79)."""

from __future__ import annotations

import torch


def coords_grid(
    h: int, w: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(H, W, 2) pixel-coordinate grid, channel order (x, y)."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1).to(dtype)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at fractional pixel coordinates; taps outside the
    image read 0 (grid_sample(zeros, align_corners=True) semantics).

    :param img: (..., H, W, C) source.
    :param coords: (..., P, 2) pixel coords (x, y); the leading axes of
        ``img`` and ``coords`` match.
    :return: (..., P, C).
    """
    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    img2 = img.reshape(-1, h * w, c)
    pts = coords.reshape(img2.shape[0], -1, 2)
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0

    def tap(yi, xi, weight):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(img2, 1, flat[..., None].expand(-1, -1, c))
        return vals * (weight * inb.to(img.dtype))[..., None]

    out = (
        tap(y0, x0, (1 - fy) * (1 - fx))
        + tap(y0, x0 + 1, (1 - fy) * fx)
        + tap(y0 + 1, x0, fy * (1 - fx))
        + tap(y0 + 1, x0 + 1, fy * fx)
    )
    return out.reshape(*lead, coords.shape[-2], c)


def forward_warp_flow(flow: torch.Tensor) -> torch.Tensor:
    """Forward-warp a flow field to frame t+1's pixel grid, the warm
    start of the next pair's GMA iterations.

    Each vector is splatted to its rounded target with ``index_add_``;
    colliding vectors are averaged, and pixels no vector lands on get
    zero flow (the cold start for those pixels).

    :param flow: (B, H, W, 2) flow, channel order (x, y).
    :return: (B, H, W, 2) warped flow, same dtype.
    """
    b, h, w, _ = flow.shape
    f = flow.float()
    target = coords_grid(h, w, device=flow.device)[None] + f
    # round half to even, like jnp.round
    tx = torch.round(target[..., 0]).long()
    ty = torch.round(target[..., 1]).long()
    valid = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    idx = ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)
    # one flat index space over the batch: image i owns [i*hw, (i+1)*hw)
    idx = (idx + torch.arange(b, device=flow.device)[:, None, None] * (h * w)).reshape(-1)
    vmask = valid.reshape(-1, 1).float()
    summed = torch.zeros(b * h * w, 2, device=flow.device)
    count = torch.zeros(b * h * w, 1, device=flow.device)
    summed.index_add_(0, idx, f.reshape(-1, 2) * vmask)
    count.index_add_(0, idx, vmask)
    out = summed / count.clamp(min=1.0)
    return out.reshape(b, h, w, 2).to(flow.dtype)
