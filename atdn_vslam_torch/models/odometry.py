"""ATDNVO, the conv + LSTM odometry regressor
(ref: atdn_vslam/odometry/network.py:11-162).

Input is a batch of flow windows (B, T, H, W, 2), NHWC, normalised by
the KITTI flow std; the encoder runs once over the folded (B*T) batch
in NCHW; two LSTMCell(512) carry explicit state; MLP heads give the
euler rotation and the translation of each step. The carry keeps the
JAX package's layout ((c1, h1), (c2, h2)); ``nn.LSTMCell`` itself
takes and returns (h, c).

Encoder, compressor variant (the default, ref network.py:63-73):
per-channel 1x1 conv -> ConvBlock k7 s2 p3 (16) -> 4x ResidualConvBlock
s2 (16) -> ConvBlock k3 s3 p0 -> flatten (CHW, as the reference) ->
Linear. The Linear's input width follows the image size: 4 x 13 x 16 =
832 at 376x1232. The non-compressor variant (ref network.py:75-86) is
six ResidualConvBlocks s2 to 4, 8, 16, 16, 16, 16 channels, then the
flatten and the Linear (16 x 6 x 20 = 1920 at 376x1232). With
``use_layernorm`` and ``use_dropout`` every LinearBlock of the encoder,
the LSTM link and the heads adds its layer norm and its dropout 0.2.

Computes in float32 with TF32 off (``utils.helpers.full_float32``).
"""

from __future__ import annotations

import torch
from torch import nn

from atdn_vslam_torch.models.blocks import ConvBlock, LinearBlock, ResidualConvBlock
from atdn_vslam_torch.utils.helpers import full_float32

#: implicit flow normalisation std (ref: utils/normalizations.py:10)
FLOW_STD = (58.1837, 17.7647)

#: the non-compressor encoder's residual stages (ref network.py:75-86)
NON_COMPRESSOR_CHANNELS = (4, 8, 16, 16, 16, 16)

Carry = tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def encoder_feature_shape(image_hw: tuple[int, int], compressor: bool = True) -> tuple[int, int, int]:
    """(C, H, W) of the encoder's last conv output for an image size."""
    dims = []
    for size in image_hw:
        if compressor:
            size = _conv_out(size, 7, 2, 3)
            for _ in range(4):
                size = _conv_out(size, 3, 2, 1)
            size = _conv_out(size, 3, 3, 0)
        else:
            for _ in NON_COMPRESSOR_CHANNELS:
                size = _conv_out(size, 3, 2, 1)
        dims.append(size)
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
        compressor: bool = True,
        use_dropout: bool = False,
        use_layernorm: bool = False,
    ):
        super().__init__()
        c, h, w = encoder_feature_shape(image_hw, compressor)
        if h < 1 or w < 1:
            raise ValueError(f"image size {image_hw} is too small for the ATDNVO encoder")
        self.lstm_size = lstm_size
        opts = {"norm": use_layernorm, "dropout": use_dropout}
        if compressor:
            convs = [
                nn.Conv2d(in_channels, in_channels, 1, groups=in_channels),
                ConvBlock(in_channels, 16, 7, 2, 3),
                *(ResidualConvBlock(16, 16, 2) for _ in range(4)),
                ConvBlock(16, 16, 3, 3, 0),
            ]
        else:
            widths = (in_channels, *NON_COMPRESSOR_CHANNELS)
            convs = [ResidualConvBlock(cin, cout, 2) for cin, cout in zip(widths[:-1], widths[1:])]
        self.encoder_CNN = nn.Sequential(*convs, nn.Flatten(), LinearBlock(c * h * w, 512, **opts))
        self.lstm1 = nn.LSTMCell(512, lstm_size)
        self.lstm_linear = LinearBlock(lstm_size, 512, **opts)
        self.lstm2 = nn.LSTMCell(512, lstm_size)
        self.rotation_regressor = _head(lstm_size, **opts)
        self.translation_regressor = _head(lstm_size, **opts)
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


def _head(width: int, **opts) -> nn.Sequential:
    """width -> 128 -> 64 -> 3 regressor (ref: network.py:109-119)."""
    return nn.Sequential(
        LinearBlock(width, 128, **opts), LinearBlock(128, 64, **opts), nn.Linear(64, 3, bias=False)
    )
