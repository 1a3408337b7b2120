"""MappingVAE, the convolutional autoencoder of the keyframe map
(JAX ``models/mapping.py``; ref: atdn_vslam/localization/network.py:9-87).

Images come in as NHWC RGB in [0, 255] and are normalised inside
(/255, then ImageNet mean and std). The encoder is a 7x7 ConvBlock with
3 outputs and six stride-2 ResidualConvBlocks (16, 16, 32, 64, 128,
128); a 1x1 conv ``mean_lin`` gives the latent code ``mu`` (and
``sigma_lin`` the log-variance on the variational path). The decoder is
six TransposedConvBlocks (128, 64, 32, 16, 16, 8), each growing a side
from n to 2n - 1, and a 3x3 ``out_conv``; the decoded image is smaller
than the input (321x1217 at 376x1232), and training resizes its target
to it.

Every public tensor is NHWC, as in the JAX package: the code of
``get_code`` is (B, h, w, C) float32 (6 x 20 x 128 = 15,360 floats per
KITTI keyframe) and flattens in that HWC order, so the embeddings equal
the JAX package's element for element. The layers compute in NCHW.
``dtype`` is the compute type (see ``models/blocks.py``); parameters,
batch-norm statistics and mu, logvar, latent and decoded stay float32.
float32 computes with TF32 off (``utils.helpers.full_float32``).
"""

from __future__ import annotations

import torch
from torch import nn

from atdn_vslam_torch.models.blocks import ConvBlock, ResidualConvBlock, TransposedConvBlock, cast_conv
from atdn_vslam_torch.utils.helpers import full_float32

#: ImageNet RGB statistics (ref: utils/normalizations.py:4-6)
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


def normalize_rgb(image: torch.Tensor) -> torch.Tensor:
    """[0, 255] RGB -> ImageNet-normalised values, channels last."""
    x = image / 255.0
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(RGB_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # contiguous: the CPU backward of this stack corrupts the heap when
    # the stem gets the channels-last view of the NHWC input (torch 2.13)
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MappingVAE(nn.Module):
    def __init__(
        self,
        variational: bool = False,
        channels: tuple[int, ...] = (16, 16, 32, 64, 128, 128),
        latent_channels: int = 128,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.variational = variational
        self.dtype = dtype
        self.stem = ConvBlock(3, 3, 7, 1, 3, dtype)
        self.down = nn.ModuleList(
            ResidualConvBlock(cin, cout, 2, dtype) for cin, cout in zip((3, *channels[:-1]), channels)
        )
        self.mean_lin = nn.Conv2d(channels[-1], latent_channels, 1)
        if variational:
            self.sigma_lin = nn.Conv2d(channels[-1], latent_channels, 1)
        up = (*reversed(channels[:-1]), 8)
        self.up = nn.ModuleList(
            TransposedConvBlock(cin, cout, dtype) for cin, cout in zip((latent_channels, *up[:-1]), up)
        )
        self.out_conv = nn.Conv2d(up[-1], 3, 3, padding=1)

    def _encode(self, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """NHWC [0, 255] -> (the pre-bottleneck map in ``dtype``, mu in
        float32), both NCHW."""
        with full_float32():
            x = self.stem(_nchw(normalize_rgb(image)).to(self.dtype))
            for block in self.down:
                x = block(x)
            return x, cast_conv(self.mean_lin, x, self.dtype).float()

    def _decode(self, latent: torch.Tensor) -> torch.Tensor:
        with full_float32():
            x = latent.to(self.dtype)
            for block in self.up:
                x = block(x)
            return cast_conv(self.out_conv, x, self.dtype).float()

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """RGB [0, 255] NHWC -> the pre-bottleneck feature map, NHWC."""
        return _nhwc(self._encode(image)[0])

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """NHWC latent -> decoded NHWC image (normalised RGB), float32."""
        return _nhwc(self._decode(_nchw(latent)))

    def forward(
        self,
        image: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
        """(mu, logvar, latent, decoded), NHWC float32, as the reference
        forward (network.py:57-77). On the variational path the latent is
        mu + exp(logvar / 2) * noise, with ``noise`` (NHWC, the code's
        shape) given or drawn from ``generator``; logvar is None off it."""
        encoded, mu = self._encode(image)
        logvar = None
        latent = mu
        if self.variational:
            with full_float32():
                logvar = cast_conv(self.sigma_lin, encoded, self.dtype).float()
            if noise is None:
                if generator is None:
                    raise ValueError("the variational path needs noise or a generator")
                noise = torch.randn(_nhwc(mu).shape, generator=generator, device=generator.device)
            latent = mu + torch.exp(0.5 * logvar) * _nchw(noise.to(mu.device, mu.dtype))
            logvar = _nhwc(logvar)
        decoded = self._decode(latent)
        return _nhwc(mu), logvar, _nhwc(latent), _nhwc(decoded)

    def get_code(self, image: torch.Tensor) -> torch.Tensor:
        """The latent code ``mu`` for the keyframe search, (B, h, w, C)
        float32 (ref network.py:80-84, without the reference's call of a
        missing ``self.norm``)."""
        return _nhwc(self._encode(image)[1])
