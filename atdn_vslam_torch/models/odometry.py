"""ATDNVO, the conv + LSTM odometry regressor
(ref: atdn_vslam/odometry/network.py:11-162), compressor encoder.

Input is a batch of flow windows (B, T, H, W, 2), NHWC, normalised by
the KITTI flow std; the encoder runs once over the folded (B*T) batch
in NCHW; two LSTMCell(512) carry explicit state; MLP heads give the
euler rotation and the translation of each step. The carry keeps the
JAX package's layout ((c1, h1), (c2, h2)); ``nn.LSTMCell`` itself
takes and returns (h, c).

Encoder: per-channel 1x1 conv -> ConvBlock k7 s2 p3 (16) -> 4x
ResidualConvBlock s2 (16) -> ConvBlock k3 s3 p0 -> flatten (CHW, as the
reference) -> Linear. The Linear's input width follows the image size:
4 x 13 x 16 = 832 at 376x1232.

Computes in float32 with TF32 off (``utils.helpers.full_float32``).
"""

from __future__ import annotations

import torch
from torch import nn

from atdn_vslam_torch.models.blocks import ConvBlock, LinearBlock, ResidualConvBlock
from atdn_vslam_torch.utils.helpers import full_float32

#: implicit flow normalisation std (ref: utils/normalizations.py:10)
FLOW_STD = (58.1837, 17.7647)

Carry = tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def encoder_feature_shape(image_hw: tuple[int, int]) -> tuple[int, int, int]:
    """(C, H, W) of the encoder's last conv output for an image size."""
    dims = []
    for size in image_hw:
        size = _conv_out(size, 7, 2, 3)
        for _ in range(4):
            size = _conv_out(size, 3, 2, 1)
        dims.append(_conv_out(size, 3, 3, 0))
    return (16, *dims)


class ATDNVO(nn.Module):
    """Flow window -> per-step (euler rotation, translation).

    Usage: ``(rots, trs), carry = model(flows, carry)`` with flows
    (B, T, H, W, 2) and outputs (B, T, 3) each.
    """

    def __init__(
        self,
        image_hw: tuple[int, int] = (376, 1232),
        in_channels: int = 2,
        lstm_size: int = 512,
    ):
        super().__init__()
        c, h, w = encoder_feature_shape(image_hw)
        if h < 1 or w < 1:
            raise ValueError(f"image size {image_hw} is too small for the ATDNVO encoder")
        self.lstm_size = lstm_size
        self.encoder_CNN = nn.Sequential(
            nn.Conv2d(in_channels, in_channels, 1, groups=in_channels),
            ConvBlock(in_channels, 16, 7, 2, 3),
            *(ResidualConvBlock(16, 16, 2) for _ in range(4)),
            ConvBlock(16, 16, 3, 3, 0),
            nn.Flatten(),
            LinearBlock(c * h * w, 512),
        )
        self.lstm1 = nn.LSTMCell(512, lstm_size)
        self.lstm_linear = LinearBlock(lstm_size, 512)
        self.lstm2 = nn.LSTMCell(512, lstm_size)
        self.rotation_regressor = _head(lstm_size)
        self.translation_regressor = _head(lstm_size)
        self.register_buffer("flow_std", torch.tensor(FLOW_STD), persistent=False)

    def init_carry(self, batch_size: int) -> Carry:
        """Zero LSTM state (ref: network.py:149-153 ``reset_lstm``)."""
        z = self.flow_std.new_zeros((batch_size, self.lstm_size))
        return ((z, z), (z, z))

    def forward(self, flows: torch.Tensor, carry: Carry):
        b, t, h, w, ch = flows.shape
        x = (flows.float() / self.flow_std).reshape(b * t, h, w, ch).permute(0, 3, 1, 2)
        with full_float32():
            feats = self.encoder_CNN(x).reshape(b, t, -1)
            (c1, h1), (c2, h2) = carry
            rots, trs = [], []
            for j in range(t):
                h1, c1 = self.lstm1(feats[:, j], (h1, c1))
                mid = self.lstm_linear(h1)
                h2, c2 = self.lstm2(mid, (h2, c2))
                rots.append(self.rotation_regressor(h2))
                trs.append(self.translation_regressor(h2))
        return (torch.stack(rots, 1), torch.stack(trs, 1)), ((c1, h1), (c2, h2))


def _head(width: int) -> nn.Sequential:
    """width -> 128 -> 64 -> 3 regressor (ref: network.py:109-119)."""
    return nn.Sequential(
        LinearBlock(width, 128), LinearBlock(128, 64), nn.Linear(64, 3, bias=False)
    )
