"""Conv and linear blocks of the odometry network
(ref: atdn_vslam/layers/conv.py:7-90, layers/linear.py:5-41).

Block order is conv -> activation -> batch norm, as in the reference
(``bn(act(conv(x)))``); the residual block's skip is a strided 1x1 conv
and the sum goes through activation and batch norm. Attribute names
follow the reference ``state_dict`` (``conv``/``bn``, ``skip_layer``,
``out_block``, ``linear``). Inference only: batch norm reads its
running statistics (eps 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation x * tanh(softplus(x))."""
    return F.mish(x)


class ConvBlock(nn.Module):
    """Conv -> Mish -> BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=padding)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(mish(self.conv(x)))


class ResidualConvBlock(nn.Module):
    """Two 3x3 ConvBlocks plus a strided 1x1 skip, then Mish and
    BatchNorm on the sum."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Sequential(
            ConvBlock(cin, cin, 3, 1, 1), ConvBlock(cin, cout, 3, stride, 1)
        )
        self.skip_layer = nn.Conv2d(cin, cout, 1, stride)
        self.out_block = nn.Sequential(nn.Mish(), nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_block(self.conv(x) + self.skip_layer(x))


class LinearBlock(nn.Module):
    """Linear -> Mish (the reference's optional layer norm and dropout
    are off in every shipped configuration)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.linear = nn.Linear(fin, fout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(self.linear(x))
