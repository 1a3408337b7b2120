"""ATDNVO (ATDN vSLAM, Periodica Polytechnica EECS 66(3), 2022;
MILAB-IIT-CV/ATDN_vSLAM ``odometry/network.py``), the compressor
encoder without dropout or layer norm, in plain PyTorch: the reference
of the benchmark's odometry net, with its CLVO loss at alpha 1 and the
pose matrices.

The flow window (B, T, H, W, 2) is divided by the KITTI flow std, run
through the encoder (a per-channel 1x1 conv, conv 7x7 s2, four residual
blocks s2, conv 3x3 s3, each conv -> Mish -> batch norm, then flatten
and a linear layer -> Mish), two LSTM cells of 512 (gates i, f, g, o)
with a linear -> Mish between them, and two heads 512 -> 128 -> 64 -> 3
(rotation as yxz euler angles, translation). The carry is
((c1, h1), (c2, h2)). Parameter names are those of the published
``state_dict``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.gma import BatchNorm
from perfbench.reference.precision import Precision

FLOW_STD = (58.1837, 17.7647)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=padding)
        self.bn = BatchNorm(cout, eps=1e-5)

    def forward(self, x, P: Precision, train: bool):
        return self.bn(F.mish(P.conv2d(x, self.conv)), train)


class ResidualConvBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = nn.Sequential(ConvBlock(cin, cin, 3, 1, 1), ConvBlock(cin, cout, 3, stride, 1))
        self.skip_layer = nn.Conv2d(cin, cout, 1, stride)
        self.out_block = nn.Sequential(nn.Mish(), BatchNorm(cout, eps=1e-5))

    def forward(self, x, P: Precision, train: bool):
        y = self.conv[1](self.conv[0](x, P, train), P, train) + P.conv2d(x, self.skip_layer)
        return self.out_block[1](F.mish(y), train)


class LinearBlock(nn.Module):
    def __init__(self, fin, fout):
        super().__init__()
        self.linear = nn.Linear(fin, fout)

    def forward(self, x, P: Precision):
        return F.mish(P.linear(x, self.linear.weight, self.linear.bias))


class LSTMCell(nn.Module):
    def __init__(self, fin, hidden):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, fin))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, x, h, c, P: Precision):
        gates = P.linear(x, self.weight_ih, self.bias_ih) + P.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


def _conv_out(size, kernel, stride, padding):
    return (size + 2 * padding - kernel) // stride + 1


class ATDNVO(nn.Module):
    def __init__(self, image_hw=(376, 1232), lstm_size: int = 512, precision: Precision | None = None):
        super().__init__()
        self.P = precision or Precision()
        dims = []
        for size in image_hw:
            size = _conv_out(size, 7, 2, 3)
            for _ in range(4):
                size = _conv_out(size, 3, 2, 1)
            dims.append(_conv_out(size, 3, 3, 0))
        self.encoder_CNN = nn.Sequential(
            nn.Conv2d(2, 2, 1, groups=2), ConvBlock(2, 16, 7, 2, 3),
            *(ResidualConvBlock(16, 16, 2) for _ in range(4)), ConvBlock(16, 16, 3, 3, 0),
            nn.Flatten(), LinearBlock(16 * dims[0] * dims[1], 512),
        )
        self.lstm1 = LSTMCell(512, lstm_size)
        self.lstm_linear = LinearBlock(lstm_size, 512)
        self.lstm2 = LSTMCell(512, lstm_size)
        self.rotation_regressor = _head(lstm_size)
        self.translation_regressor = _head(lstm_size)
        self.lstm_size = lstm_size

    def init_carry(self, batch: int, device):
        z = torch.zeros(batch, self.lstm_size, device=device)
        return (z, z), (z, z)

    def forward(self, flows, carry, train: bool = False):
        P = self.P
        b, t, h, w, ch = flows.shape
        std = torch.tensor(FLOW_STD, device=flows.device)
        x = (flows.float() / std).reshape(b * t, h, w, ch).permute(0, 3, 1, 2)
        enc = self.encoder_CNN
        x = P.conv2d(x, enc[0])
        for block in enc[1:7]:
            x = block(x, P, train)
        feats = enc[8](x.flatten(1), P).reshape(b, t, -1)
        (c1, h1), (c2, h2) = carry
        rots, trs = [], []
        for j in range(t):
            h1, c1 = self.lstm1(feats[:, j], h1, c1, P)
            h2, c2 = self.lstm2(self.lstm_linear(h1, P), h2, c2, P)
            rots.append(_run_head(self.rotation_regressor, h2, P))
            trs.append(_run_head(self.translation_regressor, h2, P))
        return (torch.stack(rots, 1), torch.stack(trs, 1)), ((c1, h1), (c2, h2))


def _head(width):
    return nn.Sequential(LinearBlock(width, 128), LinearBlock(128, 64), nn.Linear(64, 3, bias=False))


def _run_head(head, x, P: Precision):
    return P.linear(head[1](head[0](x, P), P), head[2].weight)


def clvo_loss(pred_rot, pred_tr, true_rot, true_tr, alpha: float = 1.0, delta: float = 1.0, khi: float = 100.0):
    """The CLVO loss at alpha 1: the mean over windows of the sum over
    steps of delta |dtr|^2 + khi |drot|^2 (the composed-pose term has
    weight 1 - alpha = 0)."""
    if alpha != 1.0:
        raise ValueError("the reference CLVO loss covers alpha 1 only")
    per_step = delta * ((pred_tr - true_tr) ** 2).sum(-1) + khi * ((pred_rot - true_rot) ** 2).sum(-1)
    return per_step.sum(-1).mean()


def pose_matrix(rot, tr) -> torch.Tensor:
    """(3,) yxz euler angles and (3,) translation -> 4x4 float64 pose,
    R = Ry(a) Rx(b) Rz(g)."""
    a, b, g = (float(v) for v in rot)

    def ry(t):
        return [[math.cos(t), 0, math.sin(t)], [0, 1, 0], [-math.sin(t), 0, math.cos(t)]]

    def rx(t):
        return [[1, 0, 0], [0, math.cos(t), -math.sin(t)], [0, math.sin(t), math.cos(t)]]

    def rz(t):
        return [[math.cos(t), -math.sin(t), 0], [math.sin(t), math.cos(t), 0], [0, 0, 1]]

    m = torch.eye(4, dtype=torch.float64)
    m[:3, :3] = torch.tensor(ry(a), dtype=torch.float64) @ torch.tensor(rx(b), dtype=torch.float64) \
        @ torch.tensor(rz(g), dtype=torch.float64)
    m[:3, 3] = torch.tensor([float(v) for v in tr], dtype=torch.float64)
    return m
