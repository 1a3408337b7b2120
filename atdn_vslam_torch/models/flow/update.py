"""GMA update block: motion encoder, separable ConvGRU, flow head and
upsample-mask head (ref: GMA/core/update.py:7-139). NCHW; attribute
names follow the reference ``state_dict``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from atdn_vslam_torch.models.flow.gma import Aggregate


class FlowHead(nn.Module):
    """conv3 -> relu -> conv3 -> delta flow (ref: update.py:7-15)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a 1x5 pass, then a 5x1 pass
    (ref: update.py:36-63)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 384):
        super().__init__()
        cin = hidden_dim + input_dim
        for d, (kernel, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for gate in "zrq":
                setattr(self, f"conv{gate}{d}", nn.Conv2d(cin, hidden_dim, kernel, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for convz, convr, convq in (
            (self.convz1, self.convr1, self.convq1),
            (self.convz2, self.convr2, self.convq2),
        ):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    """Correlation features + current flow -> 128-channel motion
    features (ref: update.py:66-84). ``convc1`` takes the window
    dx-major, as the reference lookup emits it."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class GMAUpdateBlock(nn.Module):
    """One recurrent update: motion features -> globally aggregated
    motion -> SepConvGRU -> (new hidden state, delta flow)
    (ref: update.py:112-139). The upsample mask is a separate call,
    made once after the last iteration."""

    def __init__(
        self,
        hidden_dim: int = 128,
        heads: int = 1,
        corr_levels: int = 4,
        corr_radius: int = 4,
        use_pallas: bool | None = None,
    ):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1)
        )
        self.aggregator = Aggregate(dim=128, heads=heads, dim_head=128, use_pallas=use_pallas)

    def forward(
        self,
        net: torch.Tensor,
        inp: torch.Tensor,
        corr: torch.Tensor,
        flow: torch.Tensor,
        attn: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:param attn: the materialised probabilities or the (q, k) pair,
        passed through to :class:`Aggregate`."""
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attn, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return net, self.flow_head(net)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        """Convex-upsampling logits (B, 576, H, W) from a hidden state."""
        return 0.25 * self.mask(net)
