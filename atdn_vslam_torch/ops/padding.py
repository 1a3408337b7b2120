"""Replicate padding of NHWC images to /8-divisible sizes
(ref: GMA/core/utils/utils.py:8-30).

'sintel' mode centers the padding on both axes; any other mode (the
RAFT 'kitti' convention) centers the width and puts all height padding
at the bottom.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (..., H, W, C) tensors so H and W are divisible by 8.

    :param shape: image shape; the last three axes are (H, W, C).
    :param mode: 'sintel' (centered) or 'kitti' (bottom height pad).
    """

    def __init__(self, shape, mode: str = "sintel"):
        h, w = shape[-3], shape[-2]
        pad_h = (((h // 8) + 1) * 8 - h) % 8
        pad_w = (((w // 8) + 1) * 8 - w) % 8
        if mode == "sintel":
            self._pad_h = (pad_h // 2, pad_h - pad_h // 2)
        else:
            self._pad_h = (0, pad_h)
        self._pad_w = (pad_w // 2, pad_w - pad_w // 2)

    @property
    def padded(self) -> bool:
        return any(self._pad_h) or any(self._pad_w)

    def pad(self, *images: torch.Tensor) -> list[torch.Tensor]:
        """Replicate-pad each (..., H, W, C) tensor; returns a list."""
        out = []
        for im in images:
            lead = im.shape[:-3]
            x = im.reshape(-1, *im.shape[-3:]).permute(0, 3, 1, 2)
            x = F.pad(x, (*self._pad_w, *self._pad_h), mode="replicate")
            out.append(x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[2:], x.shape[1]))
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Crop a padded (..., H, W, C) tensor back to the input size."""
        h0, h1 = self._pad_h
        w0, w1 = self._pad_w
        h = x.shape[-3] - h0 - h1
        w = x.shape[-2] - w0 - w1
        return x[..., h0 : h0 + h, w0 : w0 + w, :]
