"""Feature and context encoders of the flow network
(ref: GMA/core/extractor.py:6-189).

conv7 s2 (64) -> norm -> relu -> 2x ResidualBlock(64) -> 2x
ResidualBlock(96, first s2) -> 2x ResidualBlock(128, first s2) -> 1x1
conv to ``output_dim``. The feature encoder uses instance norm, the
context encoder batch norm (flax's statistics in training, the running
ones in eval mode). NCHW, in the type of the module's convolution
weights (or the autocast type); instance and batch norm compute in
float32 and hand back the input's type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from atdn_vslam_torch.models import blocks
from atdn_vslam_torch.ops.norm import instance_norm


class InstanceNorm(nn.Module):
    """Non-affine instance norm (torch InstanceNorm2d defaults), its
    moments in float32, or in float64 for a float64 input; with
    ``relu=True`` the ReLU that follows it too.

    On a CUDA tensor of bf16 or float32 that autograd does not record,
    this is K6 (:func:`~atdn_vslam_torch.ops.norm.instance_norm`: one
    launch, the same arithmetic up to the order of the moments' sums).
    Elsewhere (the CPU, flow training, float64) it is ``F.instance_norm``
    on a float32 (float64) copy, cast back, then ``F.relu``."""

    def __init__(self, eps: float = 1e-5, relu: bool = False):
        super().__init__()
        self.eps = eps
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float32)
                and not (torch.is_grad_enabled() and x.requires_grad)):
            return instance_norm(x, self.relu, self.eps)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        y = F.instance_norm(x32, eps=self.eps).to(x.dtype)
        return F.relu(y) if self.relu else y


class BatchNorm(blocks.BatchNorm2d):
    """The context encoder's batch norm, float32 parameters and
    statistics. Training: flax's ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` (:class:`blocks.BatchNorm2d`), computed in float32,
    the output in the input's type. Eval: ``nn.BatchNorm2d``'s, which
    takes a bf16 input with float32 parameters as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nn.BatchNorm2d.forward(self, x)
        return super().forward(x).to(x.dtype)


def _norm(kind: str, planes: int, relu: bool = False) -> nn.Module:
    """The norm of ``kind``; an instance norm takes the ReLU after it
    when ``relu`` (:func:`_norm_relu` applies it after a batch norm)."""
    if kind == "instance":
        return InstanceNorm(relu=relu)
    if kind == "batch":
        return BatchNorm(planes, eps=1e-5)
    raise ValueError(f"unsupported norm {kind!r}")


def _norm_relu(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``relu(norm(x))``, the ReLU left to an instance norm that applies it."""
    y = norm(x)
    return y if isinstance(norm, InstanceNorm) and norm.relu else F.relu(y)


class ResidualBlock(nn.Module):
    """conv3-norm-relu twice plus a strided 1x1 downsample when the
    stride is not 1 (ref: extractor.py:6-55)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes, relu=True)
        self.norm2 = _norm(norm_fn, planes, relu=True)
        self.downsample = None
        if stride != 1:
            # the reference registers norm3 twice (as itself and inside
            # downsample), so its state_dict has both key sets
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _norm_relu(self.norm1, self.conv1(x))
        y = _norm_relu(self.norm2, self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """1/8-resolution encoder (ref: extractor.py:116-189)."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64, relu=True)
        layers = []
        cin = 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(cin, planes, norm_fn, stride),
                ResidualBlock(planes, planes, norm_fn, 1),
            ))
            cin = planes
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_relu(self.norm1, self.conv1(x))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
