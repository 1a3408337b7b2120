"""GMA update block: motion encoder, separable ConvGRU, flow head and
upsample-mask head (ref: GMA/core/update.py:7-139). NCHW; attribute
names follow the reference ``state_dict``.

:meth:`GMAUpdateBlock.forward_rows` is one update of a band of rows
[lo, hi) of the 1/8-resolution grid, for the row-split flow net
(``parallel/flow_sharding.py``). Its convolutions reach across the band
edge, so each stage runs on a window of rows wide enough for its reach
and keeps the rows it computes right; a window that meets the image edge
is cut there, where the zero padding is the whole image's. The reach of
one update, in rows (``ROW_REACH``): the motion encoder's correlation
branch 2 (``convc2`` 3x3, then ``conv`` 3x3), its flow branch 5
(``convf1`` 7x7, ``convf2`` 3x3, ``conv`` 3x3); the GRU 4 (the 5x1 pass:
q reads r h, and r is itself a 5x1 convolution; the 1x5 pass reaches no
row); the flow head 2 (two 3x3): the band's new flow needs the hidden
state and the GRU input on rows lo - 6 to hi + 6.
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


#: rows each stage of one update reaches beyond the rows it computes
ROW_REACH = {"corr": 2, "flow": 5, "gru": 4, "head": 2}


def row_window(lo: int, hi: int, reach: int, h: int) -> tuple[int, int]:
    """Rows [lo - reach, hi + reach), cut to the image's [0, h)."""
    return max(lo - reach, 0), min(hi + reach, h)


def _rows(x: torch.Tensor, window_lo: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of an NCHW tensor whose row 0 is image row ``window_lo``."""
    return x[:, :, lo - window_lo : hi - window_lo]


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
    ):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1)
        )
        self.aggregator = Aggregate(dim=128, heads=heads, dim_head=128)

    def forward(
        self,
        net: torch.Tensor,
        inp: torch.Tensor,
        corr: torch.Tensor,
        flow: torch.Tensor,
        attn,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:param attn: the frame pair's ``attn(v) -> out``
        (``ops/attention.py`` ``gma_attention``), passed to :class:`Aggregate`."""
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attn, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return net, self.flow_head(net)

    def forward_rows(
        self,
        net: torch.Tensor,
        inp: torch.Tensor,
        corr: torch.Tensor,
        flow: torch.Tensor,
        attn,
        band: tuple[int, int],
        gather,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One update of rows band = [lo, hi) of the H rows.

        :param net, inp, flow: the whole hidden state, context features
            and flow, (B, C, H, W).
        :param corr: the lookup of rows ``row_window(lo, hi, ROW_REACH["corr"], H)``.
        :param attn: the band's attention, ``gma_attention(..., band=band)``.
        :param gather: band (B, C, hi - lo, W) -> the whole (B, C, H, W),
            every rank's band in order (``parallel.distributed.gather_bands``).
        :return: the band's new hidden state and delta flow.
        """
        h = net.shape[2]
        lo, hi = band
        c_lo, c_hi = row_window(lo, hi, ROW_REACH["corr"], h)
        f_lo, f_hi = row_window(lo, hi, ROW_REACH["flow"], h)
        m_lo, m_hi = row_window(lo, hi, 1, h)  # the rows the last 3x3 (``conv``) reads
        enc = self.encoder
        cor = F.relu(enc.convc2(F.relu(enc.convc1(corr))))
        flo = F.relu(enc.convf2(F.relu(enc.convf1(flow[:, :, f_lo:f_hi]))))
        feats = torch.cat([_rows(cor, c_lo, m_lo, m_hi), _rows(flo, f_lo, m_lo, m_hi)], dim=1)
        out = _rows(F.relu(enc.conv(feats)), m_lo, lo, hi)
        motion = gather(torch.cat([out, flow[:, :, lo:hi]], dim=1))
        motion_global = gather(self.aggregator(attn, motion, band))
        g_lo, g_hi = row_window(lo, hi, ROW_REACH["gru"] + ROW_REACH["head"], h)
        x = torch.cat([inp, motion, motion_global], dim=1)[:, :, g_lo:g_hi]
        net = self.gru(net[:, :, g_lo:g_hi], x)
        return _rows(net, g_lo, lo, hi), _rows(self.flow_head(net), g_lo, lo, hi)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        """Convex-upsampling logits (B, 576, H, W) from a hidden state."""
        return 0.25 * self.mask(net)
